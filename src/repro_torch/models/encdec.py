"""Encoder-decoder backbone (whisper-medium).

Port of ``src/repro/models/encdec.py``. The conv frontend is a stub, as in
the reference: the encoder takes precomputed frame embeddings
``batch["frames"]`` [B, S_enc, d_model]. Decoder layers are causal
self-attention, cross-attention over the encoder's output and a gated MLP.

As in :mod:`repro_torch.models.transformer`, the reference's ``lax.scan``
over the stacked ``[L, ...]`` params is a Python loop over the layers that
:func:`~repro_torch.models.transformer.unstack` cuts each stack into, once
a forward and outside the remat units (one ``stack`` a leaf in the
backward), each layer wrapped in
:func:`~repro_torch.models.transformer.remat` (a plain call unless
autograd records), and the param tree is the reference's, so
:func:`repro_torch.convert.lm_params_from_numpy` carries it across.

Attention runs through the port's kernels unless ``use_kernels=False``:
the encoder's self-attention is non-causal flash, the decoder's causal
flash, cross-attention non-causal flash with Sq != Sk (the reference's
``chunked_attention``; the flash kernel masks from position 0 for q and
kv alike, so its non-causal instance computes exactly this). Decode runs
``decode_attention`` for the self step and, with length S_enc, for the
cross step (the reference's ``index = S_enc - 1`` is the same mask).
Cross-attention has no RoPE.

:meth:`EncDecModel.decode_step` writes the new token's key and value into
the self KV cache in place, as ``LM.decode_step`` does; the cross caches
are read only. The state passed in must not be reused.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.spec import (P, abstract_params, axes_tree,
                                     init_params, stack_tree)
from repro_torch.models.transformer import remat, unstack


@dataclass
class EncDecState:
    """Decode cache: the decoder's stacked self KV cache
    [L_dec, B, S_dec, Hkv, hd], the cross-attention keys and values
    [L_dec, B, S_enc, Hkv, hd] and the next absolute position."""
    self_kv: attn.KVCache
    cross_k: torch.Tensor
    cross_v: torch.Tensor
    index: int


def _stack(parts: List[torch.Tensor], slots: int) -> torch.Tensor:
    """Per-layer [B, S, H, D] tensors -> one [n, B, slots, H, D] stack,
    zero past S; each layer's copy is dropped from ``parts`` as it lands.
    DTensor parts (a prefill on a mesh) are padded and stacked, which
    DTensor places, rather than written in place."""
    p0 = parts[0]
    if isinstance(p0, DTensor):
        def padded(t):
            if t.shape[1] == slots:
                return t
            pad = t.new_zeros((t.shape[0], slots - t.shape[1])
                              + tuple(t.shape[2:]))
            return torch.cat([t, pad], dim=1)
        return torch.stack([padded(t) for t in parts])
    out = torch.zeros((len(parts), p0.shape[0], slots) + tuple(p0.shape[2:]),
                      dtype=p0.dtype, device=p0.device)
    for i in range(len(parts)):
        out[i, :, :parts[i].shape[1]] = parts[i]
        parts[i] = None
    return out


class EncDecModel:
    def __init__(self, cfg, attn_impl: str = "chunked", *,
                 use_kernels: bool = True):
        if not cfg.is_encoder_decoder:
            raise ValueError(f"{cfg.arch_id} is not an encoder-decoder "
                             "config")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.use_kernels = use_kernels

    # ------------------------------------------------------------------
    def _enc_layer_specs(self) -> dict:
        cfg = self.cfg
        return {"norm1": L.norm_spec(cfg, cfg.d_model),
                "attn": attn.attn_specs(cfg),
                "norm2": L.norm_spec(cfg, cfg.d_model),
                "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}

    def _dec_layer_specs(self) -> dict:
        cfg = self.cfg
        return {"norm1": L.norm_spec(cfg, cfg.d_model),
                "self_attn": attn.attn_specs(cfg),
                "norm_x": L.norm_spec(cfg, cfg.d_model),
                "cross_attn": attn.attn_specs(cfg),
                "norm2": L.norm_spec(cfg, cfg.d_model),
                "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}

    def specs(self) -> dict:
        cfg = self.cfg
        return {
            "embed": L.embed_specs(cfg),
            "enc_proj": P((cfg.d_model, cfg.d_model), ("embed", "act_embed")),
            "enc_layers": stack_tree(self._enc_layer_specs(),
                                     cfg.num_encoder_layers),
            "enc_norm": L.norm_spec(cfg, cfg.d_model),
            "dec_layers": stack_tree(self._dec_layer_specs(), cfg.num_layers),
            "final_norm": L.norm_spec(cfg, cfg.d_model),
        }

    def init(self, gen: torch.Generator, device=None):
        """Random params from ``gen`` on ``device`` (default: the
        generator's device)."""
        return init_params(self.specs(), gen, self.cfg.param_dtype, device)

    def abstract(self):
        """``meta`` tensors of every param's shape and dtype."""
        return abstract_params(self.specs(), self.cfg.param_dtype)

    def param_axes(self):
        """The params' logical axes, tree for tree."""
        return axes_tree(self.specs())

    # ------------------------------------------------------------------
    def _norm(self, x, p):
        return L.norm_apply(self.cfg, x, p, use_kernels=self.use_kernels)

    def _enc_layer(self, p, x, positions):
        cfg = self.cfg
        h = self._norm(x, p["norm1"])
        o, _ = attn.attn_apply(cfg, p["attn"], h, positions=positions,
                               causal=False, impl=self.attn_impl,
                               use_kernels=self.use_kernels)
        x = x + o
        h2 = self._norm(x, p["norm2"])
        return x + L.mlp_apply(cfg, p["mlp"], h2)

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """frames [B, S_enc, d] -> encoder output [B, S_enc, d]."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        x = torch.matmul(frames.to(dt), params["enc_proj"].to(dt))
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        for p in unstack(params["enc_layers"], cfg.num_encoder_layers):
            layer = functools.partial(self._enc_layer, p)
            x = remat(cfg.remat_policy, layer, x, positions)
        return self._norm(x, params["enc_norm"])

    def _cross(self, p, xq, enc_out, *, collect: bool):
        cfg = self.cfg
        q = attn.head_proj(cfg, xq, p["wq"])
        k = attn.head_proj(cfg, enc_out, p["wk"])
        v = attn.head_proj(cfg, enc_out, p["wv"])
        o = attn.attend(cfg, q, k, v, causal=False, impl=self.attn_impl,
                        use_kernels=self.use_kernels)
        return attn.out_proj(cfg, p, o), ((k, v) if collect else None)

    def _dec_layer(self, p, x, enc_out, positions, collect: bool):
        cfg = self.cfg
        h = self._norm(x, p["norm1"])
        o, kv = attn.attn_apply(cfg, p["self_attn"], h, positions=positions,
                                causal=True, impl=self.attn_impl,
                                kv_for_cache=collect,
                                use_kernels=self.use_kernels)
        x = x + o
        hx = self._norm(x, p["norm_x"])
        o2, ckv = self._cross(p["cross_attn"], hx, enc_out, collect=collect)
        x = x + o2
        h2 = self._norm(x, p["norm2"])
        return x + L.mlp_apply(cfg, p["mlp"], h2), kv, ckv

    def _decode_trunk(self, params, tokens, enc_out, *, collect: bool):
        """-> (final-normed hidden [B, S, d], per-layer (self (k, v),
        cross (k, v)) when ``collect``)."""
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], tokens)
        B, S = tokens.shape
        positions = torch.arange(S, device=x.device)[None].expand(B, S)
        caches = []
        for p in unstack(params["dec_layers"], cfg.num_layers):
            layer = functools.partial(self._dec_layer, p)
            x, kv, ckv = remat(cfg.remat_policy, layer, x, enc_out,
                               positions, collect)
            caches.append((kv, ckv))
        return self._norm(x, params["final_norm"]), caches

    # ------------------------------------------------------------------
    def apply(self, params, batch: Dict[str, torch.Tensor]):
        enc_out = self.encode(params, batch["frames"])
        x, _ = self._decode_trunk(params, batch["tokens"], enc_out,
                                  collect=False)
        return (L.logits_from_hidden(self.cfg, params["embed"], x),
                torch.zeros((), dtype=torch.float32, device=x.device))

    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy of the decoder over
        ``batch["tokens"]`` (and an optional ``"mask"`` over the labels),
        the full-length trunk with the last position's logits dropped, as
        the reference. Returns (loss, {"ce"})."""
        enc_out = self.encode(params, batch["frames"])
        toks = batch["tokens"]
        x, _ = self._decode_trunk(params, toks, enc_out, collect=False)
        logits = L.logits_from_hidden(self.cfg, params["embed"], x)[:, :-1]
        ce = L.cross_entropy(logits, toks[:, 1:], batch.get("mask"))
        return ce, {"ce": ce}

    # ------------------------------------------------------------------
    def init_cache(self, batch: int, max_len: int,
                   device=None) -> EncDecState:
        """An empty state for a ``max_len`` context budget, split as the
        reference: S_dec = max_len // 2 self slots, S_enc = the rest."""
        cfg = self.cfg
        dt = L.dtype_of(cfg)
        S_dec = max_len // 2
        S_enc = max_len - S_dec
        kv = attn.init_kv_cache(cfg, cfg.num_layers, batch, S_dec, dtype=dt,
                                device=device)
        ck = torch.zeros((cfg.num_layers, batch, S_enc, cfg.num_kv_heads,
                          cfg.resolved_head_dim), dtype=dt, device=device)
        return EncDecState(kv, ck, torch.zeros_like(ck), 0)

    def cache_axes(self) -> EncDecState:
        """The state's logical axes (the reference's): the self and the
        cross caches both split their length over ``cache_seq``."""
        cax = ("layers", "batch", "cache_seq", "act_kv_heads", "head_dim")
        return EncDecState(attn.cache_axes(self.cfg), cax, cax, ())

    def prefill(self, params, batch: Dict[str, torch.Tensor],
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, EncDecState]:
        """Encode ``batch["frames"]`` and run the decoder over
        ``batch["tokens"]`` [B, S] -> (last-position logits [B, 1, V],
        state). The self cache is padded to ``max_len`` slots (``S`` when
        ``max_len`` is None or shorter), as the reference pads it; the
        cross caches hold the encoder's S_enc positions."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        toks = batch["tokens"]
        S = toks.shape[1]
        x, caches = self._decode_trunk(params, toks, enc_out, collect=True)
        logits = L.logits_from_hidden(cfg, params["embed"], x[:, -1:, :])
        del x, enc_out
        slots = max(max_len or S, S)
        k = _stack([c[0][0] for c in caches], slots)
        v = _stack([c[0][1] for c in caches], slots)
        ck = _stack([c[1][0] for c in caches], caches[0][1][0].shape[1])
        cv = _stack([c[1][1] for c in caches], ck.shape[2])
        return logits, EncDecState(attn.KVCache(k, v, S), ck, cv, S)

    def decode_step(self, params, state: EncDecState,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, EncDecState]:
        """tokens [B, 1] -> (logits [B, 1, V], new state); the self cache
        is written in place."""
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], tokens)
        index = state.index
        kv = state.self_kv
        S_enc = state.cross_k.shape[2]
        for i, p in enumerate(unstack(params["dec_layers"], cfg.num_layers)):
            h = self._norm(x, p["norm1"])
            x = x + attn.attn_decode_apply(cfg, p["self_attn"], h, kv.k[i],
                                           kv.v[i], index,
                                           use_kernels=self.use_kernels)
            hx = self._norm(x, p["norm_x"])
            pc = p["cross_attn"]
            q = attn.head_proj(cfg, hx, pc["wq"])
            o2 = attn.decode_attend(cfg, q, state.cross_k[i],
                                    state.cross_v[i], S_enc - 1,
                                    use_kernels=self.use_kernels)
            x = x + attn.out_proj(cfg, pc, o2)
            h2 = self._norm(x, p["norm2"])
            x = x + L.mlp_apply(cfg, p["mlp"], h2)
        x = self._norm(x, params["final_norm"])
        logits = L.logits_from_hidden(cfg, params["embed"], x)
        new_index = index + 1
        return logits, EncDecState(attn.KVCache(kv.k, kv.v, new_index),
                                   state.cross_k, state.cross_v, new_index)
