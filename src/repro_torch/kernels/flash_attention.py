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

The values may be narrower than q and k (``Dv < D``, latent attention's
q·k over 128 + 64 rope columns against values 128 wide): the output then
has v's width. float32 takes any ``Dv <= D``; bfloat16 has an instance for
D 192 with Dv 128 (``V_WIDTHS``), forward and backward, whose value
products run at Dv rather than at D, and raises ``ValueError`` for any
other pair.

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
(the plain version on CPU tensors). The reference's kernel has no
backward (it trains over plain jnp); the port's has two, chosen by what
the inputs are:

- bfloat16 on the card: a hand-written FlashAttention-3-style backward
  on Hopper's warpgroup MMAs fed by TMA
  (``csrc/flash_attention_backward.cu``). The forward kernel then also
  writes each query row's log-sum-exp, from which the backward recomputes
  the probabilities tile by tile; no score matrix reaches device memory.
  ``flash_attention.backward_launch_count`` counts its launches (one a
  backward: delta, the main kernel and dq's conversion). Equal widths past
  128 (gemma's 256) do not fit that kernel and run the older ``mma.sync``
  one, which ``flash_attention.backward_fallback_count`` counts as well.
  dq is summed in float32 in L2 (bulk reduce-adds; atomics in the older
  kernel) in whatever order the blocks finish, so its last bits, and with
  them a bfloat16 training step, are not bit-reproducible from run to run
  for a given seed (the plain backward is); a deterministic dq would need
  a partial sum a key tile and an ordered reduction.
- float32 (which serves the correctness checks and needs exact f32
  parity) and CPU tensors: the kernel's closed form in plain float32, its
  twin :func:`repro_torch.kernels.ref.flash_attention_backward_ref`, in
  chunks of query rows (no autograd through a recompute). It holds
  [B, Hq, rows, Sk] float32 scores, so a chunk takes about
  ``BACKWARD_SCORES`` scores (:func:`_backward_rows`, 1 GiB in float32)
  and the keys its rows can reach (up to its last row when causal): the
  chunk's o and lse recomputed by the plain forward, then the twin, which
  gives the chunk's rows of dq and adds its share of dk and dv, summed in
  float32 and rounded once.

The whole backward is the span ``flash_attention.backward``
(:mod:`repro_torch.tracing`), on the CPU as on the card.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (flash_attention_backward_ref,
                                    flash_attention_ref)
from repro_torch.tracing import span

MAX_HEAD_DIM = 256
# (D, Dv) pairs with Dv < D that the bfloat16 kernels take
V_WIDTHS = frozenset({(192, 128)})
_GRID_MAX = 65535
_DTYPES = (torch.float32, torch.bfloat16)
BACKWARD_SCORES = 1 << 28       # float32 scores a backward chunk recomputes
_KERNEL = _build.Kernel("flash_attention", "flash_attention",
                        [ctypes.c_void_p] * 5
                        + [ctypes.POINTER(ctypes.c_longlong)]
                        + [ctypes.c_int] * 10 + [ctypes.c_float, ctypes.c_int])
_BACKWARD = _build.Kernel("flash_attention_backward",
                          "flash_attention_backward",
                          [ctypes.c_void_p] * 11
                          + [ctypes.POINTER(ctypes.c_longlong)]
                          + [ctypes.c_int] * 10 + [ctypes.c_float],
                          counter="backward_launch_count")
_SCRATCH_WIDTH = _build.Query("flash_attention_backward",
                               "flash_attention_backward_scratch_width",
                               [ctypes.c_int, ctypes.c_int])
# (D, Dv) -> the width of the backward's dq tiles; 0 where the mma.sync
# kernel runs (its scratch [B, Hq, Sq, D])
_WIDTHS = {}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: Optional[int]) -> None:
    """What the kernel takes; the plain version is held to the same."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4 \
            or v.shape[:3] != k.shape[:3] or not 0 < v.shape[3] <= k.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "[B, Hq, Sq, D], [B, Hkv, Sk, D] and "
                         "[B, Hkv, Sk, Dv], Dv <= D")
    B, Hq, _, D = q.shape
    Dv = v.shape[3]
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
        if Dv != D and (D, Dv) not in V_WIDTHS:
            raise ValueError(f"flash_attention: bfloat16 q.k width {D} with "
                             f"values {Dv} wide: the kernels take Dv = D or "
                             f"(D, Dv) in {sorted(V_WIDTHS)}")
        _build.check_aligned("flash_attention", D, q, k)
        _build.check_aligned("flash_attention", Dv, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v: [B, Hkv, Sk, Dv], Dv <= D
    -> [B, Hq, Sq, Dv] in q's dtype and memory layout. Mask: ``kpos <=
    qpos`` if ``causal``, ``kpos > qpos - window`` if ``window``; scale
    ``D ** -0.5``. Differentiable (see the module docstring)."""
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
    """The kernel forward; the backward kernel for bfloat16 on the card,
    else the plain backward (see the module docstring), inside the span
    ``flash_attention.backward``. q, k and v are saved as they come (the
    model's strided ``transpose(1, 2)`` views, no copy), with the output
    and its lse where the backward kernel follows. On CPU tensors the
    forward is the plain version too."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        ctx.causal, ctx.window = causal, window
        # the backward kernel takes bfloat16 on the card (the forward's
        # checks hold D % 8 == 0, D <= 256 and the alignment)
        ctx.kernel = q.dtype == torch.bfloat16 and q.device.type == "cuda"
        if ctx.kernel:
            o, lse = _launch(q, k, v, causal, window, with_lse=True)
            ctx.save_for_backward(q, k, v, o, lse)
            return o
        ctx.save_for_backward(q, k, v)
        if q.device.type == "cpu":
            return flash_attention_ref(q, k, v, causal=causal, window=window)
        return _launch(q, k, v, causal, window)

    @staticmethod
    def backward(ctx, do):
        with span("flash_attention.backward"):
            if ctx.kernel:
                return FlashAttentionFunction._kernel(ctx, do)
            return FlashAttentionFunction._plain(ctx, do)

    @staticmethod
    def _kernel(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1 or not _build.aligned(do):
            do = do.clone(memory_format=torch.contiguous_format)
        dq, dk, dv = _launch_backward(q, k, v, o, lse, do, ctx.causal,
                                      ctx.window)
        need = ctx.needs_input_grad
        return (dq if need[0] else None, dk if need[1] else None,
                dv if need[2] else None, None, None)

    @staticmethod
    def _plain(ctx, do):
        q, k, v = ctx.saved_tensors
        need = ctx.needs_input_grad[:3]
        B, Hq, Sq, _ = q.shape
        Sk = k.shape[2]
        rows = _backward_rows(B, Hq, Sk)
        f32 = torch.float32
        dq = torch.empty_like(q)
        dk = torch.zeros(k.shape, dtype=f32, device=k.device)
        dv = torch.zeros(v.shape, dtype=f32, device=v.device)
        # float32 inputs: the chunks' gradients are float32 and round once,
        # at the end
        kf, vf = k.detach().to(f32), v.detach().to(f32)
        for lo in range(0, Sq, rows):
            hi = min(lo + rows, Sq)
            reach = min(hi, Sk) if ctx.causal else Sk
            qs = q[:, :, lo:hi].detach().to(f32)
            ks, vs = kf[:, :, :reach], vf[:, :, :reach]
            o, lse = flash_attention_ref(qs, ks, vs, causal=ctx.causal,
                                         window=ctx.window, q_offset=lo,
                                         return_lse=True)
            gq, gk, gv = flash_attention_backward_ref(
                qs, ks, vs, o, lse, do[:, :, lo:hi].to(f32),
                causal=ctx.causal, window=ctx.window, q_offset=lo)
            dq[:, :, lo:hi] = gq
            dk[:, :, :reach] += gk
            dv[:, :, :reach] += gv
        return (dq if need[0] else None, dk.to(k.dtype) if need[1] else None,
                dv.to(v.dtype) if need[2] else None, None, None)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], with_lse: bool = False):
    """One kernel launch on checked CUDA inputs -> o, or (o, lse) with
    ``with_lse`` (bfloat16 only): lse float32 [B, Hq, Sq rounded up to 64],
    each query row's log of its softmax sum, the rows past Sq those of the
    zero-padded tile."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    # q's layout at v's width (a view of q is not dense where Dv < D, so
    # empty_like keeps the order of q's dims)
    o = torch.empty_like(q[..., :Dv])
    ldl = -(-Sq // 64) * 64
    lse = (torch.empty((B, Hq, ldl), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if q.numel():
        strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                           *v.stride()[:3], *o.stride()[:3])
        _KERNEL.launch(flash_attention, q.device, q.data_ptr(), k.data_ptr(),
                       v.data_ptr(), o.data_ptr(),
                       None if lse is None else lse.data_ptr(), strides, B,
                       Hq, Hkv, Sq, Sk, D, Dv, ldl, int(bool(causal)),
                       int(window or 0), float(D ** -0.5),
                       int(q.dtype == torch.bfloat16),
                       what=lambda: f"q {tuple(q.shape)}, k {tuple(k.shape)} "
                                    f"{q.dtype}")
    return o if lse is None else (o, lse)


def _launch_backward(q, k, v, o, lse, do, causal: bool,
                     window: Optional[int]):
    """The backward kernel on the forward's checked bfloat16 inputs, its
    output ``o`` and ``lse`` (:func:`_launch`), and an aligned ``do``
    -> (dq, dk, dv) in q's, k's and v's layouts."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    delta = torch.empty_like(lse)
    width = _WIDTHS.get((D, Dv))
    if width is None:
        width = _WIDTHS.setdefault((D, Dv), _SCRATCH_WIDTH(q.device, D, Dv))
    dq_acc = torch.empty(B * Hq * (lse.shape[-1] * width if width else Sq * D),
                         dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(
        *(st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]))
    _BACKWARD.launch(flash_attention, q.device, q.data_ptr(), k.data_ptr(),
                     v.data_ptr(), o.data_ptr(), do.data_ptr(),
                     lse.data_ptr(), delta.data_ptr(), dq_acc.data_ptr(),
                     dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), strides, B,
                     Hq, Hkv, Sq, Sk, D, Dv, lse.shape[-1],
                     int(bool(causal)),
                     int(window or 0), float(D ** -0.5),
                     what=lambda: f"backward q {tuple(q.shape)}, k "
                                  f"{tuple(k.shape)}")
    if not width:
        with _build._COUNT_LOCK:
            flash_attention.backward_fallback_count += 1
    return dq, dk, dv


flash_attention.launch_count = 0
flash_attention.backward_launch_count = 0
flash_attention.backward_fallback_count = 0
