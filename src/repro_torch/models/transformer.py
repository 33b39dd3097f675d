"""Decoder-only LM, dense path.

Port of ``src/repro/models/transformer.py`` for the dense families (every
block attention + gated MLP: llama3, gemma, granite, h2o-danube,
chameleon). The reference's ``lax.scan`` over the stacked layer dim is a
Python loop that indexes the ``[L, ...]`` params; remat does not apply
(no training here). MoE, SSM and hybrid blocks raise ``NotImplementedError``
(ROADMAP Queue 1, item 2).

Decode updates the KV cache in place: :meth:`LM.decode_step` writes the new
token's key and value into ``state.kv`` and returns a state with the index
advanced, where the reference returns updated copies
(``dynamic_update_slice``). The state passed in must not be reused.

``use_kernels=False`` is the plain route: every kernel call goes to its
plain PyTorch version on any device, which ``chip_smoke.py`` holds the
kernel route against on the card.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch

from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models.spec import init_params, stack_tree

_NOT_PORTED = ("the port's LM runs the dense family only; MoE, SSM and "
               "hybrid blocks are still to port (ROADMAP Queue 1, "
               "item 2)")


@dataclass
class DecodeState:
    """Decode cache of the dense path: the stacked attention KV cache and
    the next absolute position. (The reference's ``conv`` / ``rec``
    recurrent states come with the SSM and hybrid families.)"""
    kv: attn.KVCache
    index: int


def layer_params(stacked: dict, i: int) -> dict:
    """Layer ``i``'s params (views) from a tree of stacked ``[L, ...]``
    tensors."""
    return {k: (layer_params(v, i) if isinstance(v, dict) else v[i])
            for k, v in stacked.items()}


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    return x if m == 1.0 else x * m   # x * 1 is x: one launch saved


class LM:
    """Decoder-only language model (dense path)."""

    def __init__(self, cfg, attn_impl: str = "chunked", *,
                 use_kernels: bool = True):
        if cfg.is_encoder_decoder:
            raise NotImplementedError(
                "encoder-decoder models are still to port (ROADMAP Queue 1, "
                "item 2)")
        if cfg.is_moe or cfg.block_pattern or cfg.family == "ssm":
            raise NotImplementedError(f"{cfg.arch_id}: {_NOT_PORTED}")
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.use_kernels = use_kernels
        self.kinds = cfg.layer_kinds()

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    def _block_specs(self) -> dict:
        cfg = self.cfg
        return {"norm1": L.norm_spec(cfg, cfg.d_model),
                "attn": attn.attn_specs(cfg),
                "norm2": L.norm_spec(cfg, cfg.d_model),
                "mlp": L.mlp_specs(cfg.d_model, cfg.d_ff)}

    def specs(self) -> dict:
        cfg = self.cfg
        return {"embed": L.embed_specs(cfg),
                "final_norm": L.norm_spec(cfg, cfg.d_model),
                "layers": stack_tree(self._block_specs(), cfg.num_layers)}

    def init(self, gen: torch.Generator, device=None):
        """Random params from ``gen`` on ``device`` (default: the
        generator's device)."""
        return init_params(self.specs(), gen, self.cfg.param_dtype, device)

    # ------------------------------------------------------------------
    # Forward (prefill trunk)
    # ------------------------------------------------------------------
    def _norm(self, x, p):
        return L.norm_apply(self.cfg, x, p, use_kernels=self.use_kernels)

    def _apply_block(self, p: dict, x, positions, collect_cache: bool):
        cfg = self.cfg
        h = self._norm(x, p["norm1"])
        o, kv = attn.attn_apply(cfg, p["attn"], h, positions=positions,
                                causal=True, window=self._attn_window(),
                                impl=self.attn_impl,
                                kv_for_cache=collect_cache,
                                use_kernels=self.use_kernels)
        x = x + _scaled(o, cfg.residual_multiplier)
        h2 = self._norm(x, p["norm2"])
        x = x + _scaled(L.mlp_apply(cfg, p["mlp"], h2),
                        cfg.residual_multiplier)
        return x, kv

    def hidden(self, params, tokens: torch.Tensor, *,
               collect_cache: bool = False):
        """tokens [B,S] -> hidden [B,S,D], aux, caches (per-layer (k, v)
        list under ``"layers"`` when ``collect_cache``)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed_tokens(cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        caches = []
        for i in range(cfg.num_layers):
            x, kv = self._apply_block(layer_params(params["layers"], i), x,
                                      positions, collect_cache)
            caches.append(kv)
        x = self._norm(x, params["final_norm"])
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return x, aux, ({"layers": caches} if collect_cache else {})

    def apply(self, params, tokens: torch.Tensor):
        x, aux, _ = self.hidden(params, tokens)
        return L.logits_from_hidden(self.cfg, params["embed"], x), aux

    # ------------------------------------------------------------------
    # Decode caches
    # ------------------------------------------------------------------
    def _attn_window(self) -> Optional[int]:
        return self.cfg.sliding_window

    def init_cache(self, batch: int, max_len: int, device=None) -> DecodeState:
        kv = attn.init_kv_cache(self.cfg, self.cfg.num_layers, batch,
                                max_len, window=self._attn_window(),
                                dtype=L.dtype_of(self.cfg), device=device)
        return DecodeState(kv, 0)

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
        """tokens [B,S] -> (last-position logits [B,1,V], state). The cache
        has W = the window slots for a windowed config (circular, slot =
        pos % W, whatever ``max_len`` is, as in the reference), else
        ``max(max_len, S)`` slots."""
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        x, _, caches = self.hidden(params, tokens, collect_cache=True)
        logits = L.logits_from_hidden(cfg, params["embed"], x[:, -1:, :])
        del x
        W = self._attn_window()
        slots = W if W is not None else max(max_len, S)
        layer_kv = caches["layers"]
        k0 = layer_kv[0][0]
        shape = (cfg.num_layers, B, slots) + tuple(k0.shape[2:])
        k = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
        v = torch.zeros_like(k)
        if W is not None and W < S:
            # positions S-W .. S-1 go to their circular slots pos % W
            idx = torch.arange(S - W, S, device=k0.device) % W
        for i in range(cfg.num_layers):
            kl, vl = layer_kv[i]
            layer_kv[i] = None          # free each layer's copy as it lands
            if W is not None and W < S:
                k[i].index_copy_(1, idx, kl[:, S - W:])
                v[i].index_copy_(1, idx, vl[:, S - W:])
            else:
                k[i, :, :S] = kl
                v[i, :, :S] = vl
        return logits, DecodeState(attn.KVCache(k, v, S), S)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def decode_step(self, params, state: DecodeState,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """tokens [B,1] -> (logits [B,1,V], new state); the cache is
        written in place."""
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], tokens)
        index = state.index
        kv = state.kv
        for i in range(cfg.num_layers):
            p = layer_params(params["layers"], i)
            h = self._norm(x, p["norm1"])
            o = attn.attn_decode_apply(cfg, p["attn"], h, kv.k[i], kv.v[i],
                                       index, window=self._attn_window(),
                                       use_kernels=self.use_kernels)
            x = x + _scaled(o, cfg.residual_multiplier)
            h2 = self._norm(x, p["norm2"])
            x = x + _scaled(L.mlp_apply(cfg, p["mlp"], h2),
                            cfg.residual_multiplier)
        x = self._norm(x, params["final_norm"])
        logits = L.logits_from_hidden(cfg, params["embed"], x)
        new_index = index + 1
        return logits, DecodeState(attn.KVCache(kv.k, kv.v, new_index),
                                   new_index)
