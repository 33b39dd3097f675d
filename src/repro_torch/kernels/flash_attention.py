"""Flash attention (causal / sliding-window, GQA) in one CUDA kernel.

Port of ``src/repro/kernels/flash_attention.py``. The reference is a
Pallas TPU kernel whose grid walks kv blocks in order for each q block and
needs S to divide both block sizes; here the kernel is hand-written CUDA
C++ for Hopper (``csrc/flash_attention.cu``, built by
:mod:`repro_torch.kernels._build`): one block per (batch, q head, 64-row q
tile) loops over the kv tiles its rows can reach, and any S is taken.
bfloat16 runs on the tensor cores (``mma.sync`` with ``cp.async``-staged
K/V tiles); float32 runs on f32 FMA, which keeps full f32 precision. Any head dim up
to 256 (gemma-2b's and recurrentgemma-9b's) is taken.

The bfloat16 instance copies 16-byte chunks, so it needs D % 8 == 0 and
every pointer and (batch, head, position) stride 16-byte aligned; the
model's layouts always are, and anything else raises ``ValueError``.

The public signature keeps the reference's ``[B, H, S, D]`` layout. The
kernel reads every operand through its strides (last dim contiguous), so
the model hands in its ``[B, S, H, D]`` activations as ``transpose(1, 2)``
views and gets the output back in the same layout without a copy: the
output takes q's memory layout.

The wrapper dispatches on where the input lies: CPU tensors take the plain
PyTorch version (:func:`repro_torch.kernels.ref.flash_attention_ref`),
CUDA tensors launch the kernel on the current stream or raise. There is no
fallback between the two. ``flash_attention.launch_count`` counts launches.

Gradients: where autograd records and q, k or v requires grad, a call
goes through :class:`FlashAttentionFunction`, whose forward is the kernel
(the plain version on CPU tensors) and whose backward differentiates the
plain version (the reference's kernel has no backward; it trains over
plain jnp). The plain version holds [B, Hq, rows, Sk] float32 scores, so
the backward recomputes it in chunks of query rows
(:func:`_backward_rows`: about ``BACKWARD_SCORES`` scores a chunk, 1 GiB
in float32), each chunk against the keys its rows can reach (up to its
last row when causal), summing the chunks' k and v gradients. The whole
backward is the span ``flash_attention.backward``
(:mod:`repro_torch.tracing`), on the CPU as on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import flash_attention_ref
from repro_torch.tracing import span

MAX_HEAD_DIM = 256
_GRID_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
BACKWARD_SCORES = 1 << 28       # float32 scores a backward chunk recomputes
_KERNEL = _build.Kernel("flash_attention", "flash_attention",
                        [ctypes.c_void_p] * 4
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int])


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """What the kernel takes; the plain version is held to the same."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[B, Hq, Sq, D] and two [B, Hkv, Sk, D]")
    B, Hq, _, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or Hkv == 0 or Hq % Hkv:
        raise ValueError(f"flash_attention: q {tuple(q.shape)} and k "
                         f"{tuple(k.shape)} disagree on B or D, or Hq is "
                         "not a multiple of Hkv")
    if Sk == 0:
        raise ValueError("flash_attention: k and v hold no positions")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: dtypes q {q.dtype}, k {k.dtype}, "
                        f"v {v.dtype}; all must be float32 or all bfloat16")
    if _build.on_cpu("flash_attention", q, k, v):
        return
    if D > 1 and any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("flash_attention: the last dim of q, k and v must "
                         "be contiguous")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head dim {D} > {MAX_HEAD_DIM}")
    if B > _GRID_MAX or Hq > _GRID_MAX or max(q.shape[2], Sk) > 2 ** 31 - 128:
        raise ValueError(f"flash_attention: shape {tuple(q.shape)} exceeds "
                         "the kernel's grid")
    if q.dtype == torch.bfloat16:
        _build.check_aligned("flash_attention", D, q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D] in q's
    dtype and memory layout. Mask: ``kpos <= qpos`` if ``causal``,
    ``kpos > qpos - window`` if ``window``; scale ``D ** -0.5``.
    Differentiable (see the module docstring)."""
    _check(q, k, v, window)
    if _build.records_grad(q, k, v):
        return FlashAttentionFunction.apply(q, k, v, causal, window)
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, window=window)
    return _launch(q, k, v, causal, window)


def _backward_rows(batch: int, q_heads: int, keys: int) -> int:
    """Query rows a backward chunk takes: about ``BACKWARD_SCORES`` scores,
    a multiple of 64 rows, at least 64."""
    rows = BACKWARD_SCORES // max(batch * q_heads * keys, 1)
    return max(64, rows // 64 * 64)


class FlashAttentionFunction(torch.autograd.Function):
    """The kernel forward with a plain backward. q, k and v are saved as
    they come (the model's strided ``transpose(1, 2)`` views, no copy);
    ``backward`` recomputes :func:`flash_attention_ref` chunk by chunk of
    query rows and differentiates it, inside the span
    ``flash_attention.backward``. On CPU tensors the forward is the plain
    version too."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        with span("flash_attention.backward"):
            return FlashAttentionFunction._backward(ctx, do)

    @staticmethod
    def _backward(ctx, do):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        B, Hq, Sq, _ = q.shape
        Sk = k.shape[2]
        rows = _backward_rows(B, Hq, Sk)
        f32 = torch.float32
        dq = torch.empty_like(q) if need[0] else None
        dk = torch.zeros(k.shape, dtype=f32, device=k.device) if need[1] \
            else None
        dv = torch.zeros(v.shape, dtype=f32, device=v.device) if need[2] \
            else None
        with torch.enable_grad():
            # float32 leaves: the plain version computes in float32, so its
            # gradients are float32 and round once, at the end
            ks = k.detach().to(f32).requires_grad_(need[1])
            vs = v.detach().to(f32).requires_grad_(need[2])
            for lo in range(0, Sq, rows):
                hi = min(lo + rows, Sq)
                reach = min(hi, Sk) if ctx.causal else Sk
                qs = q[:, :, lo:hi].detach().to(f32).requires_grad_(need[0])
                o = flash_attention_ref(qs, ks[:, :, :reach], vs[:, :, :reach],
                                        causal=ctx.causal, window=ctx.window,
                                        q_offset=lo)
                wrt = [t for t, n in zip((qs, ks, vs), need) if n]
                got = iter(torch.autograd.grad(o, wrt,
                                               do[:, :, lo:hi].to(f32)))
                if need[0]:
                    dq[:, :, lo:hi] = next(got)
                if need[1]:
                    dk += next(got)
                if need[2]:
                    dv += next(got)
        if need[1]:
            dk = dk.to(k.dtype)
        if need[2]:
            dv = dv.to(v.dtype)
        return dq, dk, dv, None, None


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int]) -> torch.Tensor:
    """One kernel launch on checked CUDA inputs."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if q.numel() == 0:
        return o
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *o.stride()[:3])
    _KERNEL.launch(flash_attention, q.device, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), o.data_ptr(), strides, B, Hq, Hkv, Sq, Sk, D,
                   int(bool(causal)), int(window or 0), float(D ** -0.5),
                   int(q.dtype == torch.bfloat16),
                   what=lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)} "
                                f"{q.dtype}")
    return o


flash_attention.launch_count = 0
