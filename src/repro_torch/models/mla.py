"""Multi-head latent attention (DeepSeek-V2 / V3, Moonlight), training
forward, without a q LoRA.

A position's keys and values come up from one latent: ``[c, k_r] = h
W_kv_a`` (``kv_lora_rank`` + ``qk_rope_head_dim`` wide), ``c`` RMS-normed
with its own weight (the ``(1 + w)`` scale, as every norm of the port),
``[k_nope, v] = c W_kv_b`` per head. ``q = h W_q`` per head is
``qk_nope_head_dim`` plain columns then ``qk_rope_head_dim`` rotated ones;
the rotated key ``k_r`` is one for all heads. RoPE turns the two halves of
the rotated columns, as the port's :func:`apply_rope` does everywhere (the
published model de-interleaves pairs first, a fixed permutation of the
weights' columns). Then causal attention at the scale ``(nope + rope)
** -0.5`` over keys ``[k_nope, rope(k_r)]`` and values ``v_head_dim``
wide (``flash_attention`` with narrower values on the kernel route), and
``o W_o``.

Everything up to the attention call is the span ``mla.latent``
(:mod:`repro_torch.tracing`), in the forward and in remat's recompute.
Serving (a latent cache, absorbed decode) and the device mesh are not
built: :func:`mla_apply` raises on a mesh, and ``LM``'s ``prefill``,
``decode_step`` and ``init_cache`` raise for such a config.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import current_mesh
from repro_torch.models.attention import attend, head_proj, out_proj
from repro_torch.models.layers import apply_rope, dense, dtype_of, rmsnorm
from repro_torch.models.spec import P
from repro_torch.tracing import span

UNSUPPORTED = ("latent attention (MLA) has a training forward only: its "
               "latent cache, absorbed decode and device-mesh split are not "
               "built")


def mla_specs(cfg) -> dict:
    a, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    return {
        "wq": P((d, H, a.qk_head_dim), ("embed", "q_heads", "head_dim")),
        "wkv_a": P((d, a.kv_lora_rank + a.qk_rope_head_dim),
                   ("embed", None)),
        "kv_norm": P((a.kv_lora_rank,), (None,), init="zeros"),
        "wkv_b": P((a.kv_lora_rank, H, a.qk_nope_head_dim + a.v_head_dim),
                   (None, "q_heads", "head_dim")),
        "wo": P((H, a.v_head_dim, d), ("q_heads", "head_dim", "embed")),
    }


def mla_apply(cfg, p: dict, x: torch.Tensor, *, positions: torch.Tensor,
              window: Optional[int] = None, impl: str = "chunked",
              use_kernels: bool = True) -> torch.Tensor:
    """x [B, S, d] -> [B, S, d]: causal latent attention at ``positions``
    [B, S]."""
    if isinstance(x, DTensor) or current_mesh() is not None:
        raise NotImplementedError(UNSUPPORTED)
    a, H = cfg.mla, cfg.num_heads
    B, S, _ = x.shape
    nope, rope, r = a.qk_nope_head_dim, a.qk_rope_head_dim, a.kv_lora_rank
    with span("mla.latent"):
        q_nope, q_rope = head_proj(cfg, x, p["wq"]).split([nope, rope], -1)
        c, k_r = dense(x, p["wkv_a"].to(dtype_of(cfg))).split([r, rope], -1)
        c = rmsnorm(c, p["kv_norm"], cfg.norm_eps, use_kernels=use_kernels)
        k_nope, v = head_proj(cfg, c, p["wkv_b"]).split(
            [nope, a.v_head_dim], -1)
        q = torch.cat([q_nope, apply_rope(q_rope, positions, cfg.rope_theta)],
                      -1)
        k_r = apply_rope(k_r[:, :, None], positions, cfg.rope_theta)
        k = torch.cat([k_nope, k_r.expand(B, S, H, rope)], -1)
    o = attend(cfg, q, k, v, causal=True, window=window, impl=impl,
               use_kernels=use_kernels)
    return out_proj(cfg, p, o)
