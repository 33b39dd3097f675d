"""Plain PyTorch versions of the port's kernels (allclose targets).

Port of ``src/repro/kernels/ref.py``. Each hand-written kernel of the
port has its plain version here: the wrapper takes it for a tensor on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it. The
math is float32 whatever the inputs' dtype; the output takes the dtype of
``x`` (or ``q``).
"""
from __future__ import annotations

from typing import Optional, Union

import torch

NEG_INF = -2.0 ** 30


def _band(Sq: int, Sk: int, causal: bool, window: Optional[int],
          q_offset: int, device) -> torch.Tensor:
    """[Sq, Sk] bool: the (query, key) pairs flash attention attends."""
    qpos = torch.arange(Sq, device=device) + q_offset
    kpos = torch.arange(Sk, device=device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, return_lse: bool = False):
    """q: [B, Hq, Sq, D]; k: [B, Hkv, Sk, D]; v: [B, Hkv, Sk, Dv] ->
    [B, Hq, Sq, Dv]; the scale is ``D ** -0.5``. Key
    positions start at 0, query positions at ``q_offset`` (0 is the
    kernel's function; a chunk of query rows passes its first row's
    position); GQA maps q head h to kv head ``h // (Hq // Hkv)``. With
    ``return_lse``: (o, lse [B, Hq, Sq] float32), the log of each row's
    softmax sum over the masked, scaled scores (what the kernel's training
    forward writes)."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, Sq, D).to(torch.float32) * (D ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(torch.float32))
    s = torch.where(_band(Sq, Sk, causal, window, q_offset, q.device), s,
                    NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    o = o.reshape(B, Hq, Sq, v.shape[3]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)
    return o


def flash_attention_backward_ref(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, o: torch.Tensor,
                                 lse: torch.Tensor, do: torch.Tensor, *,
                                 causal: bool = True,
                                 window: Optional[int] = None,
                                 q_offset: int = 0):
    """The gradients (dq, dk, dv) of :func:`flash_attention_ref` in the form
    the backward kernel computes them: the probabilities recomputed from the
    forward's ``lse`` [B, Hq, Sq], ``P = exp(s - lse)`` in the band and 0
    outside, ``delta = rowsum(do o)``, ``dS = P (do v^T - delta)``, ``dv =
    P^T do``, ``dk = dS^T q D^-0.5``, ``dq = dS k D^-0.5``, the G q heads of
    a kv head summed into its dk and dv. v, o and do may be ``Dv`` wide
    where q and k are D. Query positions start at ``q_offset``, as in
    :func:`flash_attention_ref`: a chunk of query rows passes its first
    row's position, its own o, lse and do, and the keys it reaches, and
    gets its rows of dq and its share of dk and dv. Math in float32, two
    score-sized buffers worked in place; each gradient in its input's
    dtype."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // Hkv
    f32, scale = torch.float32, D ** -0.5
    qf = q.reshape(B, Hkv, G, Sq, D).to(f32)
    gf = do.reshape(B, Hkv, G, Sq, Dv).to(f32)
    kf, vf = k.to(f32), v.to(f32)
    p = torch.einsum("bkgqd,bksd->bkgqs", qf * scale, kf)
    p.sub_(lse.reshape(B, Hkv, G, Sq, 1)).exp_()
    p.masked_fill_(~_band(Sq, Sk, causal, window, q_offset, q.device), 0.0)
    delta = (gf * o.reshape(B, Hkv, G, Sq, Dv).to(f32)).sum(-1, keepdim=True)
    ds = torch.einsum("bkgqd,bksd->bkgqs", gf, vf).sub_(delta).mul_(p)
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, gf)
    del p
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, qf) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, kf) * scale
    return (dq.reshape(B, Hq, Sq, D).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor,
                         length: Union[int, torch.Tensor]) -> torch.Tensor:
    """q: [B, Hq, D]; caches: [B, Hkv, S, D]; attends to positions below
    ``length`` (an int, or [B] for one length per row)."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, D).to(torch.float32) * (D ** -0.5)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.to(torch.float32))
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    valid = torch.arange(S, device=q.device) < length
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, D).to(q.dtype)


def slice_softmax(s: torch.Tensor, valid: torch.Tensor):
    """Scores ``s`` [..., n] of one slice, masked where ``valid`` is
    false: (p = exp(s - lse) [..., n], lse [...] float32), the softmax's
    numerators normalised within the slice and the log of their sum. A
    row with no valid score gives p = 0 and lse = -inf."""
    s = torch.where(valid, s, float("-inf"))
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    return p, lse


def decode_attention_partial_ref(q: torch.Tensor, k_cache: torch.Tensor,
                                 v_cache: torch.Tensor,
                                 length: Union[int, torch.Tensor]):
    """:func:`decode_attention_ref` over one slice of a cache: (o [B, Hq,
    D] float32, normalised within the slice, lse [B, Hq] float32, the log
    of the slice's softmax sum ``m + log l``). A row with no position
    below ``length`` gives ``o = 0`` and ``lse = -inf``."""
    B, Hq, D = q.shape
    Hkv, S = k_cache.shape[1], k_cache.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, D).to(torch.float32) * (D ** -0.5)
    s = torch.einsum("bkgd,bksd->bkgs", qf, k_cache.to(torch.float32))
    length = torch.as_tensor(length, device=q.device).reshape(-1, 1, 1, 1)
    p, lse = slice_softmax(s, torch.arange(S, device=q.device) < length)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.to(torch.float32))
    return o.reshape(B, Hq, D), lse.reshape(B, Hq)


def combine_partials(os, lses, dtype=None):
    """Merge the slices' (o, lse) of one query a row into the attention
    over their union: os [n, ..., D] (or a list of n), lses [n, ...]
    float32 -> [..., D] in ``dtype`` (default: that of os). A slice with
    ``lse = -inf`` weighs nothing. Plain elementwise ops, so it also runs
    on DTensors whose dim 0 is whole."""
    if isinstance(os, (list, tuple)):
        os, lses = torch.stack(list(os)), torch.stack(list(lses))
    m = lses.amax(dim=0)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    w = torch.exp(lses - m)                                 # [n, ...]
    num = (w[..., None] * os.to(torch.float32)).sum(dim=0)
    den = torch.clamp(w.sum(dim=0), min=1e-30)
    return (num / den[..., None]).to(dtype or os.dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """x: [N, D]; w: [D] (1+w scaling)."""
    xf = x.to(torch.float32)
    ms = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)
            * (1.0 + w.to(torch.float32))).to(x.dtype)


def fused_embed_ref(x: torch.Tensor, w: torch.Tensor, mean: float = 0.0,
                    scale: float = 1.0) -> torch.Tensor:
    """Normalize+project+tanh: x [N, D], w [D, K] -> [N, K], math in f32,
    output in x's dtype."""
    z = (x.to(torch.float32) - mean) * scale
    return torch.tanh(z @ w.to(torch.float32)).to(x.dtype)
