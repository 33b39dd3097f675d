"""Fused RMSNorm, ``x * rsqrt(mean(x^2) + eps) * (1 + w)``, in one CUDA
kernel.

Port of ``src/repro/kernels/rmsnorm.py``. The reference is a Pallas TPU
kernel over row blocks that needs ``N % block_rows == 0``; here the kernel
is hand-written CUDA C++ for Hopper (``csrc/rmsnorm.cu``, built by
:mod:`repro_torch.kernels._build`), one block per row, and takes any N.

The wrapper dispatches on where the input lies: a CPU tensor takes the
plain PyTorch version (:func:`repro_torch.kernels.ref.rmsnorm_ref`), a
CUDA tensor launches the kernel on the current stream or raises. There is
no fallback between the two. ``rmsnorm.launch_count`` counts launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_INT_MAX = 2 ** 31 - 1
_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL = _build.Kernel("rmsnorm", "rmsnorm",
                        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                        + [ctypes.c_float] + [ctypes.c_int] * 2)


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
    N = 0 returns [0, D] without a launch."""
    _check(x, w)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, w, eps)
    n, d = x.shape
    y = torch.empty_like(x)
    if n == 0 or d == 0:
        return y
    _KERNEL.launch(rmsnorm, x.device, x.data_ptr(), w.data_ptr(),
                   y.data_ptr(), n, d, float(eps),
                   int(x.dtype == torch.bfloat16),
                   int(w.dtype == torch.bfloat16),
                   what=lambda: f"x {tuple(x.shape)} {x.dtype}")
    return y


rmsnorm.launch_count = 0
