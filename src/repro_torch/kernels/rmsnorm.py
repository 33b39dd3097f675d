"""Fused RMSNorm, ``x * rsqrt(mean(x^2) + eps) * (1 + w)``, in one CUDA
kernel.

Port of ``src/repro/kernels/rmsnorm.py``. The reference is a Pallas TPU
kernel over row blocks that needs ``N % block_rows == 0``; here the kernel
is hand-written CUDA C++ for Hopper (``csrc/rmsnorm.cu``, built by
:mod:`repro_torch.kernels._build`) and takes any N. Where D is one of the
register instances' widths (:func:`_norm_instance`: the registered
configs' d_model among them) and x and w are 16-byte aligned, a group of
warps holds a row in registers and a persistent grid walks the rows
(:func:`_norm_plan`); any other call takes the kernel's general path, one
block per row.

The wrapper dispatches on where the input lies: a CPU tensor takes the
plain PyTorch version (:func:`repro_torch.kernels.ref.rmsnorm_ref`), a
CUDA tensor launches the kernel on the current stream or raises. There is
no fallback between the two. ``rmsnorm.launch_count`` counts launches.

Gradients: where autograd records and x or w requires grad, a CUDA call
goes through :class:`RMSNormFunction`, whose forward is the kernel and
whose backward recomputes the plain version and differentiates it (the
reference's kernel has no backward either; it trains over plain jnp). A
CPU call is the plain version itself, which autograd differentiates.
"""
from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_INT_MAX = 2 ** 31 - 1
_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL = _build.Kernel("rmsnorm", "rmsnorm",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                        + [ctypes.c_float] + [ctypes.c_int] * 6)
_RESIDENT = _build.Query("rmsnorm", "rmsnorm_resident", [ctypes.c_int] * 3)
VECTOR_BYTES = 16
MAX_VECTORS = 10                # 16-byte vectors of a row a lane holds
WARPS_PER_ROW = (1, 2, 4, 8, 16)
# the kernel's register instances (vectors a lane, warps a row)
INSTANCES = frozenset([(4, 1), (7, 16), (8, 16)]
                      + [(nv, wpr) for nv in (7, 8, 10)
                         for wpr in WARPS_PER_ROW[:-1]])
MAX_GROUPS = 8                  # warps (rows at one warp a row) a block
GENERAL_GRID = 65536 * 16
_PLANS: Dict[tuple, "NormPlan"] = {}


class NormPlan(NamedTuple):
    """How a call runs: ``nv == 0`` is the general path on ``grid`` blocks;
    else the register instance (``nv`` vectors a lane, ``wpr`` warps a
    row) with ``groups`` row groups a block on ``grid`` blocks. Group ``g``
    of block ``b`` takes rows ``b * groups + g``, then every
    ``grid * groups``-th row after it."""
    nv: int
    wpr: int
    groups: int
    grid: int


def _norm_instance(d: int, itemsize: int) -> Optional[Tuple[int, int]]:
    """(nv, wpr) of the register instance for a row of ``d`` elements of
    ``itemsize`` bytes: the fewest warps a row that keep a lane at no more
    than ``MAX_VECTORS`` vectors, if the row fills them exactly and the
    kernel has that instance; else None."""
    vec = VECTOR_BYTES // itemsize
    if d <= 0 or d % vec:
        return None
    nvec = d // vec
    for wpr in WARPS_PER_ROW:
        if nvec <= MAX_VECTORS * 32 * wpr:
            nv, rest = divmod(nvec, 32 * wpr)
            return (nv, wpr) if not rest and (nv, wpr) in INSTANCES else None
    return None


def _norm_plan(n: int, d: int, itemsize: int, sm_count: int,
               resident: Callable[[int, int], int],
               aligned: bool = True) -> NormPlan:
    """The launch of an [n, d] call. The register path needs an instance
    for d and 16-byte aligned x and w; its grid is persistent: at most
    ``sm_count * resident(nv, wpr)`` blocks (the blocks an SM holds at
    full size), evened out over the row groups. Few rows are spread over
    the SMs with fewer groups a block."""
    inst = _norm_instance(d, itemsize) if aligned else None
    if inst is None:
        return NormPlan(0, 0, 0, min(n, GENERAL_GRID))
    nv, wpr = inst
    full = max(1, MAX_GROUPS // wpr)
    groups = max(1, min(full, -(-n // sm_count)))
    return NormPlan(nv, wpr, groups, _build.even_grid(
        -(-n // groups), sm_count * max(1, resident(nv, wpr))))


def _check(x: torch.Tensor, w: torch.Tensor) -> None:
    """What the kernel takes; the plain version is held to the same."""
    if x.dim() != 2 or w.dim() != 1 or x.shape[1] != w.shape[0]:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} and w "
                         f"{tuple(w.shape)} are not [N, D] and [D]")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm: x {x.dtype}, w {w.dtype}; each must be "
                        "float32 or bfloat16")
    if _build.on_cpu("rmsnorm", x, w):
        return
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("rmsnorm: x and w must be contiguous")
    if x.numel() > _INT_MAX:
        raise ValueError(f"rmsnorm: x {tuple(x.shape)} exceeds the kernel's "
                         "int range")


def rmsnorm(x: torch.Tensor, w: torch.Tensor, *,
            eps: float = 1e-6) -> torch.Tensor:
    """x: [N, D]; w: [D] -> [N, D] in x's dtype (math in float32). Any N;
    N = 0 returns [0, D] without a launch. Differentiable (see the module
    docstring)."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    if _build.records_grad(x, w):
        return RMSNormFunction.apply(x, w, eps)
    return _launch(x, w, eps)


class RMSNormFunction(torch.autograd.Function):
    """The kernel forward with a plain backward: ``backward`` recomputes
    :func:`rmsnorm_ref` on the saved x and w (saved as they are, no copy)
    and returns its gradients. On CPU tensors the forward is the plain
    version too (what the CPU tests drive)."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_ref(x, w, eps) if x.device.type == "cpu" \
            else _launch(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            xs = x.detach().requires_grad_(need[0])
            ws = w.detach().requires_grad_(need[1])
            y = rmsnorm_ref(xs, ws, ctx.eps)
            wrt = [t for t, n in zip((xs, ws), need) if n]
            got = iter(torch.autograd.grad(y, wrt, dy))
        return (*(next(got) if n else None for n in need), None)


def _launch(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """One kernel launch on checked CUDA inputs."""
    n, d = x.shape
    y = torch.empty_like(x)
    if n == 0 or d == 0:
        return y
    x_bf16 = int(x.dtype == torch.bfloat16)
    key = (n, d, x_bf16,
           (x.data_ptr() | w.data_ptr()) % VECTOR_BYTES == 0, x.device)
    plan = _PLANS.get(key)
    if plan is None:
        dev = x.device
        plan = _norm_plan(n, d, x.element_size(), _build.sm_count(dev),
                          lambda nv, wpr: _RESIDENT(dev, x_bf16, nv, wpr),
                          aligned=key[3])
        if len(_PLANS) > 4096:          # shapes of a long-running server
            _PLANS.clear()
        _PLANS[key] = plan
    _KERNEL.launch(rmsnorm, x.device, x.data_ptr(), w.data_ptr(),
                   y.data_ptr(), n, d, float(eps), x_bf16,
                   int(w.dtype == torch.bfloat16), *plan,
                   what=lambda: f"x {tuple(x.shape)} {x.dtype}")
    return y


rmsnorm.launch_count = 0
