"""Fused pre-embedding: normalize + project + tanh in one CUDA kernel.

Port of ``src/repro/kernels/fused_embed.py``. The reference fuses the
paper's SIMD vectorized pre-embedding (§5.1) into a Pallas TPU kernel;
here the kernel is hand-written CUDA C++ for Hopper
(``csrc/fused_embed.cu``, built by :mod:`repro_torch.kernels._build`).

The wrapper dispatches on where the input lies: a CPU tensor takes the
plain PyTorch version (:func:`repro_torch.kernels.ref.fused_embed_ref`),
a CUDA tensor launches the kernel on the current stream or raises. There
is no fallback between the two. ``fused_embed.launch_count`` counts kernel
launches (under a lock: the pipeline executor calls from several threads).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import fused_embed_ref

_INT_MAX = 2 ** 31 - 1
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
_KERNELS = {dtype: _build.Kernel("fused_embed", symbol, _ARGTYPES)
            for dtype, symbol in ((torch.float32, "fused_embed_f32"),
                                  (torch.bfloat16, "fused_embed_bf16"))}


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
    if max(n + 32, d, w.shape[1] + 64) > _INT_MAX:
        raise ValueError(f"fused_embed: shape {tuple(x.shape)} x "
                         f"{tuple(w.shape)} exceeds the kernel's int range")


def fused_embed(x: torch.Tensor, w: torch.Tensor, *, mean: float = 0.0,
                scale: float = 1.0) -> torch.Tensor:
    """x: [N, D]; w: [D, K] -> tanh(((x-mean)*scale) @ w) [N, K] in x's
    dtype. Any N is accepted; N = 0 returns [0, K] without a launch."""
    _check(x, w)
    if x.device.type == "cpu":
        return fused_embed_ref(x, w, mean, scale)
    n, d = x.shape
    k = w.shape[1]
    out = torch.empty((n, k), dtype=x.dtype, device=x.device)
    if n == 0 or k == 0:
        return out
    _KERNELS[x.dtype].launch(
        fused_embed, x.device, x.data_ptr(), w.data_ptr(), out.data_ptr(), n,
        d, k, float(mean), float(scale),
        what=lambda: f"x {tuple(x.shape)}, w {tuple(w.shape)}")
    return out


fused_embed.launch_count = 0
