"""Decoder-only LM assembling the block zoo (attn / MoE / SSM / RG-LRU).

Port of ``src/repro/models/transformer.py``. One class serves the dense,
moe, ssm and hybrid families. The reference's ``lax.scan`` over the
stacked layer dim is a Python loop over the ``[L, ...]`` params, each
stack cut once into its layers by :func:`unstack` (one ``torch.unbind`` a
leaf, so a leaf's gradient is one ``stack``, not a whole-stack zero-fill
and add per layer as indexing gives); a hybrid walks its pattern
*cycles* (params ``cycles/slot{i}`` stacked ``[nc, ...]``) and then the
unrolled remainder (``rest{i}``), the reference's tree exactly, so
:func:`repro_torch.convert.lm_params_from_numpy` carries a reference
param tree across unchanged. Encoder-decoder models
are a class of their own (:mod:`repro_torch.models.encdec`).

Remat: where the reference wraps its scan body in ``jax.checkpoint``
(``cfg.remat_policy``), the port wraps the same unit (a layer, or a
hybrid's cycle) in ``torch.utils.checkpoint`` (:func:`remat`), but only
while autograd records: under ``no_grad`` / ``inference_mode`` (serving)
every unit is a plain call.

Decode updates the caches in place: :meth:`LM.decode_step` writes the new
token's key and value into ``state.kv`` and each recurrent layer's conv
window and state into ``state.conv`` / ``state.rec``, and returns a state
with the index advanced, where the reference returns updated copies. The
state passed in must not be reused. The recurrent stacks keep the
reference's flat layer order (cycle0.slot0, cycle0.slot1, cycle1.slot0,
..., then the remainder), so a test compares them element for element.

``use_kernels=False`` is the plain route: every kernel call goes to its
plain PyTorch version on any device, which ``chip_smoke.py`` holds the
kernel route against on the card.

A config with ``first_dense_layers`` (DeepSeek-V3, Moonlight) starts
with that many layers whose MLP is dense (``d_ff``), stacked apart under
``"dense_layers"``, before the ``"layers"`` stack of MoE blocks; each
layer is a remat unit, and the cache slots count them in that order. A
config with ``mla`` runs latent attention (:mod:`repro_torch.models.mla`)
in every attention layer; it trains but does not serve: ``prefill``,
``decode_step`` and ``init_cache`` raise.

On a device mesh the params are DTensors placed by :meth:`LM.param_axes`
(``repro_torch.distributed.sharding.shard_params``) and the forward runs
under ``axis_rules(rules, mesh=mesh)``: plain ops propagate the
placements, the residual stream is constrained to ``("batch",
"residual_seq", "act_embed")`` after every block as in the reference, the
kernels run on each rank's local shards, and MoE blocks run expert
parallel over the current mesh.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (carry_rules, current_mesh,
                                              current_rules, lshard)
from repro_torch.models import attention as attn
from repro_torch.models import layers as L
from repro_torch.models import mamba2, mla, moe, rglru
from repro_torch.models.spec import (abstract_params, axes_tree, init_params,
                                     stack_tree)

# the matrix products without batch dims (a [.., d] activation against a
# 2-D weight folds to one of these), which "dots" saves
_MATMULS = frozenset([torch.ops.aten.mm.default, torch.ops.aten.addmm.default])


def _save_matmuls(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(policy: str, fn: Callable, *args):
    """``fn(*args)`` under the reference's remat policy while autograd
    records: ``"none"`` is a plain call; ``"dots"`` saves the outputs of
    matrix products without batch dims and recomputes the rest
    (``dots_with_no_batch_dims_saveable``); any other policy (``"full"``)
    saves nothing and recomputes ``fn`` in the backward. Without autograd
    recording it is a plain call whatever the policy. The recompute runs
    under the sharding rules of the forward."""
    if policy == "none" or not torch.is_grad_enabled():
        return fn(*args)
    fn = carry_rules(fn)    # the recompute runs in autograd's thread
    if policy == "dots":
        return checkpoint(fn, *args, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts,
                              _save_matmuls))
    return checkpoint(fn, *args, use_reentrant=False)


@dataclass
class DecodeState:
    """Per-arch decode cache: the attention layers' stacked KV cache, the
    recurrent layers' stacked conv windows and states (SSM state or RG-LRU
    hidden), each ``None`` where the arch has no such layer, and the next
    absolute position."""
    kv: Optional[attn.KVCache]
    conv: Optional[torch.Tensor]
    rec: Optional[torch.Tensor]
    index: int


def unstack(stacked: dict, n: int) -> List[dict]:
    """The ``n`` layers' params (views) from a tree of stacked ``[L, ...]``
    tensors, cut once: one ``torch.unbind`` a leaf (DTensors too: their
    ``"layers"`` dim is never split). A leaf's gradient is then one
    ``stack`` of its layers' gradients. Indexing ``v[i]`` layer by layer
    instead makes each layer's gradient a zero-filled tensor the size of
    the whole stack (``select``'s backward), which autograd adds into the
    leaf's: ``n`` fills and ``n - 1`` adds of every stacked leaf."""
    def cut(t):
        return {k: cut(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in t.items()}

    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}

    pieces = cut(stacked)
    return [pick(pieces, i) for i in range(n)]


def copy_state(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)``; a DTensor ``dst`` (a recurrent state split over
    the mesh) takes ``src`` in its own placements, each rank writing its
    local shard."""
    if isinstance(dst, DTensor):
        src = src.redistribute(dst.device_mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
    else:
        dst.copy_(src)


def _scaled(x: torch.Tensor, m: float) -> torch.Tensor:
    return x if m == 1.0 else x * m   # x * 1 is x: one launch saved


def _residual(o: torch.Tensor) -> torch.Tensor:
    """A block's output placed as the residual stream it is added to. With
    a sequence-parallel residual (a ``"residual_seq"`` rule) that is the
    reduce-scatter of its partial sum; left to the add, DTensor hands its
    gradient back split on the sequence, and a matmul's backward flattens
    that to a strided shard whose cost DTensor cannot price on fake
    tensors. Without the rule, a no-op."""
    rules = current_rules()
    if not rules or rules.get("residual_seq") is None:
        return o
    return lshard(o, "batch", "residual_seq", "act_embed")


class LM:
    """Unified decoder-only language model."""

    def __init__(self, cfg, attn_impl: str = "chunked", *,
                 use_kernels: bool = True):
        self.cfg = cfg
        self.attn_impl = attn_impl
        self.use_kernels = use_kernels
        self.kinds = cfg.layer_kinds()

    # ------------------------------------------------------------------
    # Parameter specs
    # ------------------------------------------------------------------
    def _block_specs(self, kind: str, dense: bool = False) -> dict:
        """A block's specs; ``dense``: an attention block's MLP is dense
        whatever the config's MoE (a leading dense layer)."""
        cfg = self.cfg
        s: Dict[str, Any] = {"norm1": L.norm_spec(cfg, cfg.d_model)}
        if kind == "attn":
            s["attn"] = (mla.mla_specs(cfg) if cfg.mla
                         else attn.attn_specs(cfg))
            s["norm2"] = L.norm_spec(cfg, cfg.d_model)
            if cfg.is_moe and not dense:
                s["moe"] = moe.moe_specs(cfg)
            else:
                s["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
        elif kind == "ssm":
            s["ssm"] = mamba2.mamba_specs(cfg)
        elif kind == "rglru":
            s["rglru"] = rglru.rglru_specs(cfg)
            s["norm2"] = L.norm_spec(cfg, cfg.d_model)
            s["mlp"] = L.mlp_specs(cfg.d_model, cfg.d_ff)
        else:
            raise ValueError(kind)
        return s

    def specs(self) -> dict:
        cfg = self.cfg
        out: Dict[str, Any] = {"embed": L.embed_specs(cfg),
                               "final_norm": L.norm_spec(cfg, cfg.d_model)}
        if cfg.block_pattern:
            pat = cfg.block_pattern
            nc, rest = divmod(cfg.num_layers, len(pat))
            out["cycles"] = {f"slot{i}": stack_tree(self._block_specs(k), nc)
                             for i, k in enumerate(pat)}
            for i in range(rest):
                out[f"rest{i}"] = self._block_specs(pat[i])
        else:
            n = cfg.first_dense_layers
            if n:
                out["dense_layers"] = stack_tree(
                    self._block_specs(self.kinds[0], dense=True), n)
            out["layers"] = stack_tree(self._block_specs(self.kinds[0]),
                                       cfg.num_layers - n)
        return out

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

    def _layers(self, params) -> List[Tuple[str, dict]]:
        """(kind, params) of every layer in order: for a hybrid, cycle by
        cycle through the pattern's slots, then the remainder. Each stack
        is cut once (:func:`unstack`), here, outside the remat units, so a
        unit's recompute reads the same views."""
        cfg = self.cfg
        if not cfg.block_pattern:
            n = cfg.first_dense_layers
            stacks = ((unstack(params["dense_layers"], n) if n else [])
                      + unstack(params["layers"], cfg.num_layers - n))
            return [(self.kinds[0], p) for p in stacks]
        pat = cfg.block_pattern
        nc = cfg.num_layers // len(pat)
        slots = [unstack(params["cycles"][f"slot{i}"], nc)
                 for i in range(len(pat))]
        out = [(k, slots[i][c]) for c in range(nc) for i, k in enumerate(pat)]
        i = 0
        while f"rest{i}" in params:
            out.append((pat[i], params[f"rest{i}"]))
            i += 1
        return out

    def _cache_slots(self) -> List[int]:
        """For each layer in :meth:`_layers` order, its index in the state's
        KV stack (attention) or recurrent stacks (others), as the reference
        flattens them: attention slot-major over the cycles, recurrent
        layers cycle-major (layer order), the remainder appended."""
        cfg = self.cfg
        if not cfg.block_pattern:
            return list(range(cfg.num_layers))
        pat = cfg.block_pattern
        nc, rest = divmod(cfg.num_layers, len(pat))
        attn_slots = [i for i, k in enumerate(pat) if k == "attn"]
        rec_slots = [i for i, k in enumerate(pat) if k != "attn"]
        out = []
        for c in range(nc):
            for i, k in enumerate(pat):
                out.append(attn_slots.index(i) * nc + c if k == "attn"
                           else c * len(rec_slots) + rec_slots.index(i))
        n_attn, n_rec = nc * len(attn_slots), nc * len(rec_slots)
        for i in range(rest):
            if pat[i] == "attn":
                out.append(n_attn)
                n_attn += 1
            else:
                out.append(n_rec)
                n_rec += 1
        return out

    # ------------------------------------------------------------------
    # Blocks (full sequence)
    # ------------------------------------------------------------------
    def _norm(self, x, p):
        return L.norm_apply(self.cfg, x, p, use_kernels=self.use_kernels)

    def _apply_block(self, kind: str, p: dict, x, positions, aux,
                     collect_cache: bool):
        cfg = self.cfg
        cache = None
        h = self._norm(x, p["norm1"])
        if kind == "attn":
            if cfg.mla:
                o = mla.mla_apply(cfg, p["attn"], h, positions=positions,
                                  window=self._attn_window(),
                                  impl=self.attn_impl,
                                  use_kernels=self.use_kernels)
            else:
                o, cache = attn.attn_apply(
                    cfg, p["attn"], h, positions=positions, causal=True,
                    window=self._attn_window(), impl=self.attn_impl,
                    kv_for_cache=collect_cache, use_kernels=self.use_kernels)
            x = x + _residual(_scaled(o, cfg.residual_multiplier))
            h2 = self._norm(x, p["norm2"])
            if "moe" in p:
                o2, a = moe.moe_apply(cfg, p["moe"], h2, mesh=current_mesh())
                aux = aux + a
            else:
                o2 = L.mlp_apply(cfg, p["mlp"], h2)
            x = x + _residual(_scaled(o2, cfg.residual_multiplier))
        elif kind == "ssm":
            o, cache = mamba2.mamba_apply(cfg, p["ssm"], h,
                                          return_state=collect_cache)
            x = x + _residual(o)
        elif kind == "rglru":
            o, cache = rglru.rglru_apply(cfg, p["rglru"], h,
                                         return_state=collect_cache)
            x = x + _residual(o)
            h2 = self._norm(x, p["norm2"])
            x = x + _residual(L.mlp_apply(cfg, p["mlp"], h2))
        else:
            raise ValueError(kind)
        # sequence-parallel residual annotation (no-op unless the
        # 'residual_seq' rule maps to a mesh axis)
        x = lshard(x, "batch", "residual_seq", "act_embed")
        return x, aux, cache

    def _units(self, params) -> List[Tuple[List[Tuple[str, dict]], bool]]:
        """:meth:`_layers` grouped as the reference's remat wraps them
        (its scan body): (layers, wrapped) for each layer of a homogeneous
        stack and each cycle of a hybrid; a hybrid's remainder layers run
        one by one, unwrapped."""
        layers = self._layers(params)
        pat = self.cfg.block_pattern
        if not pat:
            return [([layer], True) for layer in layers]
        n = len(pat)
        nc = self.cfg.num_layers // n
        return ([(layers[c * n:(c + 1) * n], True) for c in range(nc)]
                + [([layer], False) for layer in layers[nc * n:]])

    def _run(self, unit, x, positions, aux, collect_cache: bool):
        caches = []
        for kind, p in unit:
            x, aux, c = self._apply_block(kind, p, x, positions, aux,
                                          collect_cache)
            caches.append((kind, c))
        return x, aux, caches

    def hidden(self, params, tokens: torch.Tensor, *,
               collect_cache: bool = False):
        """tokens [B,S] -> hidden [B,S,D], aux (the MoE load-balance losses
        summed over layers), caches (per-layer ``(kind, cache)`` list under
        ``"layers"`` when ``collect_cache``, in :meth:`_layers` order)."""
        cfg = self.cfg
        B, S = tokens.shape
        x = L.embed_tokens(cfg, params["embed"], tokens)
        positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        caches = []
        for unit, wrapped in self._units(params):
            run = functools.partial(self._run, unit)
            x, aux, cs = (remat(cfg.remat_policy, run, x, positions, aux,
                                collect_cache) if wrapped
                          else run(x, positions, aux, collect_cache))
            caches += cs
        x = self._norm(x, params["final_norm"])
        return x, aux, ({"layers": caches} if collect_cache else {})

    def apply(self, params, tokens: torch.Tensor):
        x, aux, _ = self.hidden(params, tokens)
        return L.logits_from_hidden(self.cfg, params["embed"], x), aux

    def loss(self, params, batch: Dict[str, torch.Tensor]):
        """Next-token cross entropy over ``batch["tokens"]`` [B, S] (and an
        optional ``"mask"``), plus the MoE load-balance term
        ``router_aux_coef * aux / MoE layers``. As the reference, the
        model runs the full sequence and the last position's logits are
        dropped. Returns (loss, {"ce", "aux"})."""
        cfg = self.cfg
        tokens = batch["tokens"]
        logits, aux = self.apply(params, tokens)
        mask = batch.get("mask")
        ce = L.cross_entropy(logits[:, :-1], tokens[:, 1:],
                             None if mask is None else mask[:, 1:])
        coef = cfg.moe.router_aux_coef if cfg.is_moe else 0.0
        nl = max(1, sum(1 for k in self.kinds if k == "attn")
                 - cfg.first_dense_layers)
        return ce + coef * aux / nl, {"ce": ce, "aux": aux / nl}

    # ------------------------------------------------------------------
    # Decode caches
    # ------------------------------------------------------------------
    def _attn_window(self) -> Optional[int]:
        cfg = self.cfg
        if cfg.family == "hybrid":
            return cfg.local_attn_window
        return cfg.sliding_window

    def _counts(self) -> Dict[str, int]:
        c: Dict[str, int] = {}
        for k in self.kinds:
            c[k] = c.get(k, 0) + 1
        return c

    def _serves(self) -> None:
        if self.cfg.mla:
            raise NotImplementedError(mla.UNSUPPORTED)

    def init_cache(self, batch: int, max_len: int, device=None) -> DecodeState:
        self._serves()
        cfg = self.cfg
        counts = self._counts()
        dt = L.dtype_of(cfg)
        kv = conv = rec = None
        if counts.get("attn"):
            kv = attn.init_kv_cache(cfg, counts["attn"], batch, max_len,
                                    window=self._attn_window(), dtype=dt,
                                    device=device)
        if counts.get("ssm"):
            s, _, nheads, cc = mamba2._dims(cfg)
            conv = torch.zeros((counts["ssm"], batch, s.conv_dim - 1, cc),
                               dtype=dt, device=device)
            rec = torch.zeros((counts["ssm"], batch, nheads, s.head_dim,
                               s.state_dim), dtype=torch.float32,
                              device=device)
        if counts.get("rglru"):
            w = cfg.rglru_width or cfg.d_model
            conv = torch.zeros((counts["rglru"], batch, 3, w), dtype=dt,
                               device=device)
            rec = torch.zeros((counts["rglru"], batch, w),
                              dtype=torch.float32, device=device)
        return DecodeState(kv, conv, rec, 0)

    def cache_axes(self) -> DecodeState:
        """The decode state's logical axes, field for field (the
        reference's ``LM.cache_axes``): place a state on a mesh with
        ``shard_params(state, mesh, model.cache_axes(), rules)``."""
        counts = self._counts()
        kv = attn.cache_axes(self.cfg) if counts.get("attn") else None
        conv = rec = None
        if counts.get("ssm"):
            conv, rec = mamba2.mamba_cache_axes()
        if counts.get("rglru"):
            conv, rec = rglru.rglru_cache_axes()
        return DecodeState(kv, conv, rec, ())

    # ------------------------------------------------------------------
    # Prefill
    # ------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor,
                max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, DecodeState]:
        """tokens [B,S] -> (last-position logits [B,1,V], state). The KV
        cache has W = the window slots for a windowed config (circular,
        slot = pos % W, whatever ``max_len`` is, as in the reference), else
        ``max(max_len, S)`` slots; the recurrent stacks hold each layer's
        last conv window and state."""
        self._serves()
        cfg = self.cfg
        B, S = tokens.shape
        max_len = max_len or S
        x, _, caches = self.hidden(params, tokens, collect_cache=True)
        logits = L.logits_from_hidden(cfg, params["embed"], x[:, -1:, :])
        del x
        layers = caches["layers"]
        slots = self._cache_slots()
        attn_at = {slots[i]: i for i, (k, _) in enumerate(layers)
                   if k == "attn"}
        rec_at = {slots[i]: i for i, (k, _) in enumerate(layers)
                  if k != "attn"}
        kv = conv = rec = None
        if attn_at:
            kv = self._pack_kv([layers[attn_at[j]][1]
                                for j in range(len(attn_at))], S, max_len)
        if rec_at:
            order = [layers[rec_at[j]][1] for j in range(len(rec_at))]
            conv = torch.stack([c[0] for c in order])
            rec = torch.stack([c[1] for c in order])
        return logits, DecodeState(kv, conv, rec, S)

    def _pack_kv(self, layer_kv: list, S: int, max_len: int) -> attn.KVCache:
        """Per-layer (k, v) [B,S,Hkv,D] -> the stacked [n, B, slots, Hkv, D]
        cache, positions S-W..S-1 at their circular slots pos % W when the
        window is shorter than the prompt."""
        W = self._attn_window()
        slots = W if W is not None else max(max_len, S)
        k0 = layer_kv[0][0]
        if isinstance(k0, DTensor):
            return self._pack_kv_sharded(layer_kv, S, slots)
        B = k0.shape[0]
        shape = (len(layer_kv), B, slots) + tuple(k0.shape[2:])
        k = torch.zeros(shape, dtype=k0.dtype, device=k0.device)
        v = torch.zeros_like(k)
        wrap = W is not None and W < S
        if wrap:
            idx = torch.arange(S - W, S, device=k0.device) % W
        for i in range(len(layer_kv)):
            kl, vl = layer_kv[i]
            layer_kv[i] = None          # free each layer's copy as it lands
            if wrap:
                k[i].index_copy_(1, idx, kl[:, S - W:])
                v[i].index_copy_(1, idx, vl[:, S - W:])
            else:
                k[i, :, :S] = kl
                v[i, :, :S] = vl
        return attn.KVCache(k, v, S)

    @staticmethod
    def _pack_kv_sharded(layer_kv: list, S: int, slots: int) -> attn.KVCache:
        """:meth:`_pack_kv` for DTensor layers (a prefill on a mesh):
        each layer's slots built by slicing and concatenation, which
        DTensor places, rather than written in place; the positions past
        a window's last ``slots`` land at their circular slots as a
        rotation."""
        def slotted(t):
            if slots < S:               # positions S-slots.. at pos % slots
                tail = t[:, S - slots:]
                shift = (S - slots) % slots
                return torch.cat([tail[:, slots - shift:],
                                  tail[:, :slots - shift]], dim=1)
            if slots == S:
                return t
            pad = t.new_zeros((t.shape[0], slots - S) + tuple(t.shape[2:]))
            return torch.cat([t, pad], dim=1)

        k = torch.stack([slotted(kl) for kl, _ in layer_kv])
        v = torch.stack([slotted(vl) for _, vl in layer_kv])
        return attn.KVCache(k, v, S)

    # ------------------------------------------------------------------
    # Decode
    # ------------------------------------------------------------------
    def decode_step(self, params, state: DecodeState,
                    tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """tokens [B,1] -> (logits [B,1,V], new state); the caches are
        written in place. On a mesh the params and the state are DTensors
        (the state placed by :meth:`cache_axes`): attention runs on each
        rank's slice of the cache, the recurrent layers on its batch
        rows."""
        self._serves()
        cfg = self.cfg
        x = L.embed_tokens(cfg, params["embed"], tokens)
        index = state.index
        kv, conv, rec = state.kv, state.conv, state.rec
        layers = self._layers(params)
        if cfg.block_pattern:
            nc = cfg.num_layers // len(cfg.block_pattern)
            if any(k == "attn" for k, _ in layers[nc * len(cfg.block_pattern):]):
                raise NotImplementedError("attn remainder layers")
        for (kind, p), j in zip(layers, self._cache_slots()):
            h = self._norm(x, p["norm1"])
            if kind == "attn":
                o = attn.attn_decode_apply(cfg, p["attn"], h, kv.k[j],
                                           kv.v[j], index,
                                           window=self._attn_window(),
                                           use_kernels=self.use_kernels)
                x = x + _scaled(o, cfg.residual_multiplier)
                h2 = self._norm(x, p["norm2"])
                if "moe" in p:
                    o2, _ = moe.moe_apply(cfg, p["moe"], h2,
                                          mesh=current_mesh())
                else:
                    o2 = L.mlp_apply(cfg, p["mlp"], h2)
                x = x + _scaled(o2, cfg.residual_multiplier)
            elif kind == "ssm":
                o, (cv, st) = mamba2.mamba_decode_step(cfg, p["ssm"], h,
                                                       conv[j], rec[j])
                copy_state(conv[j], cv)
                copy_state(rec[j], st)
                x = x + o
            else:
                o, (cv, st) = rglru.rglru_decode_step(cfg, p["rglru"], h,
                                                      conv[j], rec[j])
                copy_state(conv[j], cv)
                copy_state(rec[j], st)
                x = x + o
                h2 = self._norm(x, p["norm2"])
                x = x + L.mlp_apply(cfg, p["mlp"], h2)
        x = self._norm(x, params["final_norm"])
        logits = L.logits_from_hidden(cfg, params["embed"], x)
        new_index = index + 1
        if kv is not None:
            kv = attn.KVCache(kv.k, kv.v, new_index)
        return logits, DecodeState(kv, conv, rec, new_index)
