"""Fused pre-embedding: normalize + project + tanh in one CUDA kernel.

Port of ``src/repro/kernels/fused_embed.py``. The reference fuses the
paper's SIMD vectorized pre-embedding (§5.1) into a Pallas TPU kernel;
here the kernel is hand-written CUDA C++ for Hopper
(``csrc/fused_embed.cu``, built by :mod:`repro_torch.kernels._build`).
Where D is 16, 32 or 64, ``w`` fits ``W_CAP`` bytes and x is 16-byte
aligned, persistent blocks stage ``w`` once and each warp walks tiles of
rows (:func:`_plan`); any other call takes the kernel's general path,
which stages ``w`` in slabs and takes any size.

The wrapper dispatches on where the input lies: a CPU tensor takes the
plain PyTorch version (:func:`repro_torch.kernels.ref.fused_embed_ref`),
a CUDA tensor launches the kernel on the current stream or raises. There
is no fallback between the two. ``fused_embed.launch_count`` counts kernel
launches (under a lock: the pipeline executor calls from several threads).
It is never differentiated: on the card the wrapper raises where autograd
records and an input requires grad.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_embed_ref

_INT_MAX = 2 ** 31 - 1
_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
             + [ctypes.c_float] * 2 + [ctypes.c_int] * 3)
_KERNELS = {dtype: _build.Kernel("fused_embed", symbol, _ARGTYPES)
            for dtype, symbol in ((torch.float32, "fused_embed_f32"),
                                  (torch.bfloat16, "fused_embed_bf16"))}
_RESIDENT = _build.Query("fused_embed", "fused_embed_resident",
                         [ctypes.c_int] * 4)
STAGED_D = (16, 32, 64)         # the staged instances' widths
W_CAP = 64 * 1024               # bytes of w a block stages whole
SLICE_SMEM = 40 * 1024          # bytes of x ring and output tiles a warp
BLOCK_SMEM = 160 * 1024         # shared memory a block may take
WARP_ROWS = (32, 16, 8, 4, 2, 1)   # rows of a warp's tile
MAX_WARPS = 8
MIN_BLOCKS = 16                 # blocks a call of enough tiles spreads over
TILES_PER_SM = 2                # a call with fewer tiles an SM than this
                                # takes the smallest tile
_PLANS: Dict[tuple, "Plan"] = {}


class Plan(NamedTuple):
    """How a call runs: ``rows == 0`` is the general path; else warp tiles
    of ``rows`` rows, ``warps`` warps a block, ``grid`` persistent blocks.
    Warp ``v`` of block ``b`` takes tiles ``b * warps + v``, then every
    ``grid * warps``-th; tile ``t`` is rows ``[t * rows, (t + 1) * rows)``,
    cut at N."""
    rows: int
    warps: int
    grid: int


def _slice_smem(d: int, k: int, rows: int, itemsize: int) -> int:
    """A warp's shared memory (``slice_bytes`` in the kernel): a two-stage
    ring of x tiles and two output tiles, in x's dtype."""
    return 2 * rows * (d + k) * itemsize


def _staged_smem(d: int, k: int, rows: int, itemsize: int,
                 warps: int) -> int:
    """A staged block's shared memory (``staged_smem`` in the kernel): w
    transposed in f32 and a slice for each warp."""
    return 4 * d * k + warps * _slice_smem(d, k, rows, itemsize)


def _plan(n: int, d: int, k: int, itemsize: int, sm_count: int,
          resident: Callable[[int, int], int], aligned: bool = True) -> Plan:
    """The launch of an [n, d] x [d, k] call. The staged path needs a
    staged width d, ``w`` within ``W_CAP``, aligned x and a warp tile whose
    ``rows * k`` outputs and ``rows * d`` inputs are whole 16-byte chunks
    and whose slice fits ``SLICE_SMEM``. It takes the largest such tile
    that still gives ``TILES_PER_SM`` tiles an SM, else the smallest (a
    short call spreads over the most warps); as many warps a block, up to
    ``MAX_WARPS``, as keep ``MIN_BLOCKS`` blocks busy and the block's
    shared memory allows (a block's warps share the staging of w); and at
    most ``sm_count * resident(warps, smem bytes)`` blocks, evened out over
    the tiles."""
    if not aligned or d not in STAGED_D or 4 * d * k > W_CAP:
        return Plan(0, 0, 0)
    fits = [r for r in WARP_ROWS
            if r * k * itemsize % 16 == 0 and r * d * itemsize % 16 == 0
            and _slice_smem(d, k, r, itemsize) <= SLICE_SMEM]
    if not fits:
        return Plan(0, 0, 0)
    many = [r for r in fits if -(-n // r) >= TILES_PER_SM * sm_count]
    rows = max(many) if many else min(fits)
    tiles = -(-n // rows)
    room = (BLOCK_SMEM - 4 * d * k) // _slice_smem(d, k, rows, itemsize)
    warps = max(1, min(MAX_WARPS, tiles // MIN_BLOCKS, room))
    smem = _staged_smem(d, k, rows, itemsize, warps)
    return Plan(rows, warps, _build.even_grid(
        -(-tiles // warps), sm_count * max(1, resident(warps, smem))))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel takes; the plain version is held to the same."""
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_embed: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [N, D] and [D, K]")
    if x.dtype not in _KERNELS:
        raise TypeError(f"fused_embed: x dtype {x.dtype} not in "
                        "(float32, bfloat16)")
    if w.dtype != torch.float32:
        raise TypeError(f"fused_embed: w dtype {w.dtype} is not float32")
    if _build.on_cpu("fused_embed", x, w):
        return
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("fused_embed: x and w must be contiguous")
    n, d = x.shape
    if max(n + 65536, d, w.shape[1] + 64) > _INT_MAX:
        raise ValueError(f"fused_embed: shape {tuple(x.shape)} x "
                         f"{tuple(w.shape)} exceeds the kernel's int range")


def fused_embed(x: torch.Tensor, w: torch.Tensor, *, mean: float = 0.0,
                scale: float = 1.0) -> torch.Tensor:
    """x: [N, D]; w: [D, K] -> tanh(((x-mean)*scale) @ w) [N, K] in x's
    dtype. Any N is accepted; N = 0 returns [0, K] without a launch."""
    _check(x, w)
    if x.device.type == "cpu":
        return fused_embed_ref(x, w, mean, scale)
    _build.refuse_grad("fused_embed", x, w)
    n, d = x.shape
    k = w.shape[1]
    out = torch.empty((n, k), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return out
    key = (n, d, k, x.dtype, x.data_ptr() % 16 == 0, x.device)
    plan = _PLANS.get(key)
    if plan is None:
        dev, x_bf16 = x.device, int(x.dtype == torch.bfloat16)
        plan = _plan(n, d, k, x.element_size(), _build.sm_count(dev),
                     lambda warps, smem: _RESIDENT(dev, x_bf16, d, warps,
                                                   smem),
                     aligned=key[4])
        if len(_PLANS) > 4096:          # shapes of a long-running session
            _PLANS.clear()
        _PLANS[key] = plan
    _KERNELS[x.dtype].launch(
        fused_embed, x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), n,
        d, k, float(mean), float(scale), *plan,
        what=lambda: f"x {tuple(x.shape)}, w {tuple(w.shape)}")
    return out


fused_embed.launch_count = 0
