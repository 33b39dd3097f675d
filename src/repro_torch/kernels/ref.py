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


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D] -> [B, Hq, Sq, D]. Key
    positions start at 0, query positions at ``q_offset`` (0 is the
    kernel's function; a chunk of query rows passes its first row's
    position); GQA maps q head h to kv head ``h // (Hq // Hkv)``."""
    B, Hq, Sq, D = q.shape
    Hkv, Sk = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, Hkv, G, Sq, D).to(torch.float32) * (D ** -0.5)
    s = torch.einsum("bkgqd,bksd->bkgqs", qf, k.to(torch.float32))
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.to(torch.float32))
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


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
