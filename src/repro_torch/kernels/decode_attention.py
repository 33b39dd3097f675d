"""Flash-decode: one query token per row against a long KV cache, in one
CUDA kernel.

Port of ``src/repro/kernels/decode_attention.py``. The reference is a
Pallas TPU kernel with one program per batch row walking kv blocks in
order, and needs S to divide the block size; here the kernel is
hand-written CUDA C++ for Hopper (``csrc/decode_attention.cu``, built by
:mod:`repro_torch.kernels._build`): one block per (row, kv head), so a
GQA group shares each K/V tile, looping only up to ``length``.

The caches are read through their strides (last dim contiguous): the
model hands in its ``[B, W, Hkv, D]`` layer cache as a ``transpose(1, 2)``
view, so no step copies the cache.

The wrapper dispatches on where the input lies: CPU tensors take the plain
PyTorch version (:func:`repro_torch.kernels.ref.decode_attention_ref`),
CUDA tensors launch the kernel on the current stream or raise. There is no
fallback between the two. ``decode_attention.launch_count`` counts
launches.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import decode_attention_ref

MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 2048          # (Hq / Hkv) * D accumulators per block
_GRID_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
_KERNEL = _build.Kernel("decode_attention", "decode_attention",
                        [ctypes.c_void_p] * 5 + [ctypes.c_int]
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length) -> None:
    """What the kernel takes; the plain version is held to the same."""
    if q.dim() != 3 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, caches "
                         f"{tuple(k.shape)} / {tuple(v.shape)} are not "
                         "[B, Hq, D] and two [B, Hkv, S, D]")
    B, Hq, D = q.shape
    Hkv = k.shape[1]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and cache "
                         f"{tuple(k.shape)} disagree on B or D, or Hq is "
                         "not a multiple of Hkv")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"decode_attention: dtypes q {q.dtype}, k {k.dtype}"
                        f", v {v.dtype}; all must be float32 or all "
                        "bfloat16")
    if isinstance(length, torch.Tensor):
        if length.dtype.is_floating_point or length.dim() > 1 or (
                length.dim() == 1 and length.shape[0] != B):
            raise ValueError(f"decode_attention: length {length.dtype} "
                             f"{tuple(length.shape)} is not an int or [B] "
                             "integers")
    elif not isinstance(length, numbers.Integral):
        raise TypeError(f"decode_attention: length {type(length).__name__} "
                        "is not an int or a tensor")
    if _build.on_cpu("decode_attention", q, k, v):
        return
    if isinstance(length, torch.Tensor) and length.device != q.device:
        raise ValueError(f"decode_attention: length on {length.device}, q "
                         f"on {q.device}")
    if not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous")
    if D > 1 and (k.stride(-1) != 1 or v.stride(-1) != 1):
        raise ValueError("decode_attention: the last dim of the caches must "
                         "be contiguous")
    if D > MAX_HEAD_DIM or (Hq // Hkv) * D > MAX_GROUP_WIDTH:
        raise ValueError(f"decode_attention: D {D} and group {Hq // Hkv} "
                         f"exceed the kernel's D <= {MAX_HEAD_DIM}, "
                         f"G * D <= {MAX_GROUP_WIDTH}")
    if B > _GRID_MAX or Hkv > _GRID_MAX or k.shape[2] > 2 ** 31 - 128:
        raise ValueError(f"decode_attention: cache {tuple(k.shape)} exceeds "
                         "the kernel's grid")


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     length: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, Hkv, S, D]; attends to positions below
    ``length`` (an int for every row, or [B] integers) -> [B, Hq, D] in
    q's dtype. Scale ``D ** -0.5``."""
    _check(q, k_cache, v_cache, length)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k_cache, v_cache, length)
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    lengths, length_all = None, 0
    if isinstance(length, torch.Tensor):
        lengths = length.to(torch.int32).expand(B).contiguous()
    else:
        length_all = int(length)
    strides = (ctypes.c_longlong * 6)(
        *(t.stride(i) for t in (k_cache, v_cache) for i in (0, 1, 2)))
    _KERNEL.launch(decode_attention, q.device, q.data_ptr(),
                   k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
                   None if lengths is None else lengths.data_ptr(),
                   int(max(0, min(length_all, S))), strides, B, Hq, Hkv, S, D,
                   float(D ** -0.5), int(q.dtype == torch.bfloat16),
                   what=f"q {tuple(q.shape)}, cache {tuple(k_cache.shape)} "
                        f"{q.dtype}")
    return o


decode_attention.launch_count = 0
