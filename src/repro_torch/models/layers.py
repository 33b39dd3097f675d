"""Common building blocks: norms, RoPE, gated MLPs, embeddings.

Port of ``src/repro/models/layers.py``. Functional style as in the
reference: params are plain nested dicts of tensors with the reference's
keys. The reference's ``lshard`` annotations are dropped: on one device
they are no-ops. RMSNorm runs through the port's ``rmsnorm`` kernel
(:mod:`repro_torch.kernels.rmsnorm`) unless ``use_kernels=False``, which
routes it to the kernel's plain version on any device (the plain route,
used to hold the kernel route against on the card). The projections stay
``torch.matmul``, as the reference leaves them to XLA. ``cross_entropy``
takes the gold logit with a ``gather`` where the reference contracts a
one-hot (which keeps a sharded vocab dim sharded; on one card it would be
a [B, S, V] tensor).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels.ref import rmsnorm_ref
from repro_torch.kernels.rmsnorm import rmsnorm as rmsnorm_kernel
from repro_torch.models.spec import DTYPES, P


def dtype_of(cfg) -> torch.dtype:
    return DTYPES[cfg.dtype]


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rmsnorm_spec(d: int) -> P:
    return P((d,), ("act_embed",), init="zeros")  # stored as delta from 1


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6,
            one_plus: bool = True, *, use_kernels: bool = True
            ) -> torch.Tensor:
    """x: [..., D] -> [..., D] in x's dtype, math in float32, scale
    ``(1 + w)``. The kernel computes only the ``(1 + w)`` scale, which is
    the one every config reaches (see :func:`norm_apply`)."""
    if not one_plus:
        raise NotImplementedError("rmsnorm with a plain w scale: the port's "
                                  "kernel computes (1 + w) only, as every "
                                  "config's norm does")
    x2 = x.reshape(-1, x.shape[-1])
    y = (rmsnorm_kernel(x2.contiguous(), w, eps=eps) if use_kernels
         else rmsnorm_ref(x2, w, eps))
    return y.reshape(x.shape)


def layernorm_spec(d: int) -> dict:
    return {"w": P((d,), ("act_embed",), init="zeros"),
            "b": P((d,), ("act_embed",), init="zeros")}


def layernorm(x: torch.Tensor, p: dict, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * (1.0 + p["w"].to(torch.float32))
            + p["b"].to(torch.float32)).to(dt)


def norm_apply(cfg, x: torch.Tensor, p, *,
               use_kernels: bool = True) -> torch.Tensor:
    if cfg.norm == "layernorm":
        return layernorm(x, p, cfg.norm_eps)
    # ``or True`` as in the reference (layers.py: norm_apply): every rmsnorm
    # config takes the (1 + w) scale whatever ``rmsnorm_one_plus`` says;
    # kept for parity.
    return rmsnorm(x, p, cfg.norm_eps, one_plus=cfg.rmsnorm_one_plus or True,
                   use_kernels=use_kernels)


def norm_spec(cfg, d: int):
    return layernorm_spec(d) if cfg.norm == "layernorm" else rmsnorm_spec(d)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, theta: float,
                     device=None) -> torch.Tensor:
    exponents = torch.arange(0, head_dim, 2, dtype=torch.float32,
                             device=device) / head_dim
    return 1.0 / (theta ** exponents)  # [head_dim/2]


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, D]; positions: broadcastable to [..., S]."""
    freqs = rope_frequencies(x.shape[-1], theta, device=x.device)
    angles = positions[..., None].to(torch.float32) * freqs  # [..., S, D/2]
    angles = angles[..., None, :]  # broadcast over heads: [..., S, 1, D/2]
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gated MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------

def mlp_specs(d: int, ff: int) -> dict:
    return {
        "wi": P((d, ff), ("embed", "mlp")),
        "wg": P((d, ff), ("embed", "mlp")),
        "wo": P((ff, d), ("mlp", "embed")),
    }


def mlp_apply(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    h = torch.matmul(x, p["wi"].to(dt))
    g = torch.matmul(x, p["wg"].to(dt))
    g = g.to(torch.float32)
    # jax.nn.gelu defaults to the tanh approximation
    a = (F.gelu(g, approximate="tanh") if cfg.activation == "geglu"
         else F.silu(g))
    return torch.matmul(a.to(dt) * h, p["wo"].to(dt))


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------

def embed_specs(cfg) -> dict:
    V = cfg.padded_vocab
    d = {"embedding": P((V, cfg.d_model), ("vocab", "embed"), init="embed")}
    if not cfg.tie_embeddings:
        d["unembed"] = P((cfg.d_model, V), ("embed", "vocab"), init="small")
    return d


def embed_tokens(cfg, p: dict, tokens: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    x = p["embedding"][tokens].to(dt)
    if cfg.embed_scale:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=dt)
    if cfg.embedding_multiplier != 1.0:  # x * 1 is x: one launch saved
        x = x * torch.tensor(cfg.embedding_multiplier, dtype=dt)
    return x


def logits_from_hidden(cfg, p: dict, x: torch.Tensor) -> torch.Tensor:
    dt = dtype_of(cfg)
    if cfg.tie_embeddings:
        logits = torch.matmul(x, p["embedding"].to(dt).t())
    else:
        logits = torch.matmul(x, p["unembed"].to(dt))
    if cfg.logits_scaling != 1.0:  # x / 1 is x: one launch saved
        logits = logits / torch.tensor(cfg.logits_scaling,
                                       dtype=logits.dtype)
    if cfg.attn_logit_softcap:  # (reused as final softcap when configured)
        c = cfg.attn_logit_softcap
        logits = torch.tanh(logits / c) * c
    if cfg.padded_vocab != cfg.vocab_size:  # mask vocab-padding slots
        pad = torch.arange(cfg.padded_vocab, device=x.device) >= cfg.vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean token NLL in float32: logits [..., V], integer labels [...];
    with ``mask`` (same shape as labels) the masked sum over
    ``max(mask.sum(), 1)``, as the reference."""
    logits = logits.to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long()).squeeze(-1)
    nll = lse - gold
    if mask is not None:
        mask = mask.to(torch.float32)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()
