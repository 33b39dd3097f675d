"""Flash-decode: one query token per row against a long KV cache, split
over blocks and combined, in hand-written CUDA.

Port of ``src/repro/kernels/decode_attention.py``. The reference is a
Pallas TPU kernel with one program per batch row walking kv blocks in
order, and needs S to divide the block size; here the kernel is
hand-written CUDA C++ for Hopper (``csrc/decode_attention.cu``, built by
:mod:`repro_torch.kernels._build`): the cache below ``length`` is cut into
chunks (:func:`_split_plan`), one block per (chunk, kv head, row) streams
its rows with 16-byte copies so a GQA group shares each row, and a combine
pass merges the chunks' partial softmax sums into the output. Both
launches are one wrapper call, counted once.

The kernel copies 16-byte chunks, so it needs D % 8 == 0 and cache
pointers and (batch, head, position) strides 16-byte aligned; the model's
caches always are, and anything else raises ``ValueError``.

The caches are read through their strides (last dim contiguous): the
model hands in its ``[B, W, Hkv, D]`` layer cache as a ``transpose(1, 2)``
view, so no step copies the cache.

The wrapper dispatches on where the input lies: CPU tensors take the plain
PyTorch version (:func:`repro_torch.kernels.ref.decode_attention_ref`),
CUDA tensors launch the kernel on the current stream or raise. There is no
fallback between the two. ``decode_attention.launch_count`` counts
launches. Decoding is never differentiated: on the card the wrapper raises
where autograd records and an input requires grad.

:func:`decode_attention_partial` runs the same kernel over one slice of a
cache (a rank's share of a cache split over ``cache_seq``) and also
returns each head's log softmax sum; :func:`combine_partials` merges the
slices' pairs. It counts in ``decode_attention.launch_count``: it launches
the one kernel.
"""
from __future__ import annotations

import ctypes
import numbers
from typing import Tuple, Union

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (combine_partials,
                                     decode_attention_partial_ref,
                                     decode_attention_ref)

__all__ = ["decode_attention", "decode_attention_partial",
           "combine_partials"]

MAX_HEAD_DIM = 256
MAX_GROUP_WIDTH = 4096          # (Hq / Hkv) * D accumulators per block
_GRID_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
SPLIT_QUANTUM = 64              # positions: a chunk is a multiple of this
BLOCKS_PER_SM = 2               # the grid the plan aims for, per SM
H100_SMS = 132
_KERNEL = _build.Kernel("decode_attention", "decode_attention",
                        [ctypes.c_void_p] * 7 + [ctypes.c_int]
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [ctypes.c_int] * 7
                        + [ctypes.c_float, ctypes.c_int, ctypes.c_int])


def _split_plan(batch: int, kv_heads: int, n: int,
                sms: int = H100_SMS) -> Tuple[int, int]:
    """(chunk, splits) for a cache read up to ``n`` positions: split ``s``
    covers ``[s * chunk, min((s + 1) * chunk, n))``. A (row, kv head) pair
    is cut into about ``BLOCKS_PER_SM * sms / (batch * kv_heads)`` splits,
    at least one, in chunks that are a multiple of ``SPLIT_QUANTUM``: one
    long row still fills the card, and a batch that fills it alone is not
    split, so it needs no combine pass."""
    n = max(int(n), 1)
    want = max(1, BLOCKS_PER_SM * sms // max(batch * kv_heads, 1))
    chunk = -(-n // want)
    chunk = max(SPLIT_QUANTUM, -(-chunk // SPLIT_QUANTUM) * SPLIT_QUANTUM)
    return chunk, -(-n // chunk)


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
    _build.check_aligned("decode_attention", D, q, k, v)
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
    return _launch(q, k_cache, v_cache, length, None)


def decode_attention_partial(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor,
                             length: Union[int, torch.Tensor]):
    """:func:`decode_attention` over one slice of a cache: (o [B, Hq, D]
    float32, normalised within the slice, lse [B, Hq] float32, the log of
    the slice's softmax sum). A row with no position below ``length``
    gives ``o = 0`` and ``lse = -inf``. The slices of a cache merge with
    :func:`combine_partials`; o stays in float32 so that the merge rounds
    once."""
    _check(q, k_cache, v_cache, length)
    if q.device.type == "cpu":
        return decode_attention_partial_ref(q, k_cache, v_cache, length)
    lse = torch.empty(q.shape[:2], dtype=torch.float32, device=q.device)
    return _launch(q, k_cache, v_cache, length, lse), lse


def _launch(q, k_cache, v_cache, length, lse):
    """One launch into a new output: q's dtype, or float32 with ``lse``
    (which it also fills)."""
    _build.refuse_grad("decode_attention", q, k_cache, v_cache)
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    o = torch.empty_like(q, dtype=torch.float32 if lse is not None
                         else q.dtype)
    if not B * Hq * D:
        return o
    lengths, length_all = None, 0
    if isinstance(length, torch.Tensor):
        lengths = length.to(torch.int32).expand(B).contiguous()
        reach = S           # a split past its row's length writes l = 0
    else:
        length_all = reach = max(0, min(int(length), S))
    index = q.device.index
    sms = torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count
    chunk, splits = _split_plan(B, Hkv, reach, sms)
    strides = (ctypes.c_longlong * 6)(
        *(t.stride(i) for t in (k_cache, v_cache) for i in (0, 1, 2)))
    part = (torch.empty((B, Hq, splits, D + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    _KERNEL.launch(decode_attention, q.device, q.data_ptr(),
                   k_cache.data_ptr(), v_cache.data_ptr(), o.data_ptr(),
                   None if part is None else part.data_ptr(),
                   None if lse is None else lse.data_ptr(),
                   None if lengths is None else lengths.data_ptr(),
                   length_all, strides, B, Hq, Hkv, S, D, chunk, splits,
                   float(D ** -0.5), int(q.dtype == torch.bfloat16),
                   int(lse is not None and q.dtype != torch.float32),
                   what=lambda: f"q {tuple(q.shape)}, cache "
                                f"{tuple(k_cache.shape)} {q.dtype}")
    return o


decode_attention.launch_count = 0
