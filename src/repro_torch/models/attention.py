"""Attention: GQA projections, prefill attention and single-token decode
attention over (full / windowed) KV caches.

Port of ``src/repro/models/attention.py``. ``naive_attention`` and
``chunked_attention`` are the reference's two XLA implementations in plain
torch: the tests' oracles, the plain route (``use_kernels=False``) and the
path of a softcap config on the CPU. Otherwise :func:`attn_apply` runs the
port's ``flash_attention`` kernel for both ``impl="naive"`` and
``impl="chunked"``, since both compute the function the reference's
Pallas kernel computes (the same causal / window mask at ``q_offset = 0``
with ``Sq == Sk``), and :func:`attn_decode_apply` runs the port's
``decode_attention`` kernel with ``length = min(index + 1, W)``, which is
the reference's slot mask exactly: before a circular cache wraps the valid
slots are ``0..index``, after it wraps all ``W`` are, and softmax does not
depend on slot order. On a CPU tensor each kernel wrapper runs its plain
version. A softcap config raises on the card: the kernels take no softcap
(no registered config sets one).

Layouts are the reference's: activations ``[B, S, H, D]``, caches
``[L, B, W, Hkv, D]``. The kernels read them through ``transpose(1, 2)``
views (strides), so neither a per-layer transpose nor a per-step cache
copy is made. :func:`attn_decode_apply` writes the new key and value into
the cache in place where the reference returns an updated copy
(``dynamic_update_slice``).

Decode on a device mesh (the reference's dry-run rules) takes caches
split over ``cache_seq``: the rank that holds the new token's slot
writes it into its local slice (:func:`write_slot`), every rank attends
to its slice (``decode_attention_partial`` on the kernel route, one
launch a rank, or :func:`decode_attention_slice`), and the slices' (o,
lse) pairs are merged after a gather over the cache's mesh dims
(``combine_partials``), where the reference leaves the split to XLA's
partitioner. :func:`cache_axes` and :func:`set_decode_f32_upcast` are
the reference's.

On a device mesh q, k and v are DTensors placed by the reference's
``lshard`` annotations: batch split over the data axes, q heads over
``"model"`` (``act_heads``), k / v heads replicated (``act_kv_heads``).
:func:`attend` then runs on each rank's local heads (``shard_map``), the
kernel route and the plain route alike, and hands each rank's q heads
exactly the kv heads they read (:func:`kv_head_slice`): with GQA the
kernel's head map (q head h reads kv head h // (Hq / Hkv)) holds for the
local heads only once k and v are cut to that slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.distributed.sharding import lshard, shard_map
from repro_torch.kernels.decode_attention import (combine_partials,
                                                  decode_attention_partial)
from repro_torch.kernels.decode_attention import \
    decode_attention as decode_attention_kernel
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.ref import slice_softmax
from repro_torch.models.layers import apply_rope, dense, dtype_of, gather_fsdp
from repro_torch.models.spec import P

NEG_INF = -2.0 ** 30


def _largest_divisor(n: int, cap: int) -> int:
    for d in range(cap, 0, -1):
        if n % d == 0:
            return d
    return 1


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------

def attn_specs(cfg) -> dict:
    d, hd = cfg.d_model, cfg.resolved_head_dim
    s = {
        "wq": P((d, cfg.num_heads, hd), ("embed", "q_heads", "head_dim")),
        "wk": P((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, cfg.num_kv_heads, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((cfg.num_heads, hd, d), ("q_heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = P((hd,), ("head_dim",), init="zeros")
        s["k_norm"] = P((hd,), ("head_dim",), init="zeros")
    return s


def _qk_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    x = x.to(torch.float32)
    y = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (y * (1.0 + w.to(torch.float32))).to(dt)


# ---------------------------------------------------------------------------
# Core softmax-attention (plain torch)
# ---------------------------------------------------------------------------

def _softcap(s: torch.Tensor, softcap: Optional[float]) -> torch.Tensor:
    return torch.tanh(s / softcap) * softcap if softcap else s


def naive_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """Reference attention; q: [B,Sq,Hq,D], k: [B,Sk,Hkv,D], v:
    [B,Sk,Hkv,Dv] (Dv may be less than D: latent attention)."""
    B, Sq, Hq, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    G = Hq // K
    q = q.reshape(B, Sq, K, G, D) * (D ** -0.5)
    s = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                     k.to(torch.float32))
    s = _softcap(s, softcap)
    qpos = torch.arange(Sq, device=q.device) + q_offset
    kpos = torch.arange(Sk, device=q.device)
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, :] <= qpos[:, None]
    if window is not None:
        mask &= kpos[None, :] > qpos[:, None] - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.to(torch.float32))
    return out.reshape(B, Sq, Hq, v.shape[-1]).to(q.dtype)


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                      softcap: Optional[float] = None,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Flash-style online-softmax attention, FLOP-exact for causal/windowed.

    Python loop over Q chunks; each runs a loop over exactly the KV chunks
    it can see. Memory per step: [B, K, G, q_chunk, kv_chunk]. v may be
    narrower than q and k (Dv, the output's width).
    """
    B, S, Hq, D = q.shape
    Sk, K, Dv = k.shape[1], k.shape[2], v.shape[3]
    G = Hq // K
    if S % q_chunk:  # adapt chunks to ragged lengths
        q_chunk = _largest_divisor(S, q_chunk)
    if Sk % kv_chunk:
        kv_chunk = _largest_divisor(Sk, kv_chunk)
    if causal and S != Sk:
        raise ValueError("causal chunked attention needs Sq == Sk")
    if S <= q_chunk or q_chunk < 64 or kv_chunk < 64:
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=softcap)
    nq, nk = S // q_chunk, Sk // kv_chunk
    scale = D ** -0.5
    # heads first and the GQA group folded into the query rows: each
    # block's two products are single bmm calls over the B·K (batch, kv
    # head) pairs, K / V are cast and laid out once (not once a block),
    # and the running max and sum keep a trailing dim of 1
    BK, rows = B * K, G * q_chunk
    qc = q.reshape(B, nq, q_chunk, K, G, D)
    kt = k.to(torch.float32).permute(0, 2, 3, 1).reshape(BK, D, Sk)
    vt = v.to(torch.float32).permute(0, 2, 1, 3).reshape(BK, Sk, Dv)

    outs = []
    for i in range(nq):
        q_i = (qc[:, i].to(torch.float32) * scale).permute(
            0, 2, 3, 1, 4).reshape(BK, rows, D)               # [BK,G·Cq,D]
        q_lo, q_hi = i * q_chunk, (i + 1) * q_chunk - 1
        j_hi = (q_hi // kv_chunk) if causal else (nk - 1)
        j_lo = 0
        if window is not None:
            j_lo = max(0, (q_lo - window + 1) // kv_chunk)
        m = torch.full((BK, rows, 1), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((BK, rows, 1), dtype=torch.float32, device=q.device)
        acc = torch.zeros((BK, rows, Dv), dtype=torch.float32,
                          device=q.device)
        qpos = q_lo + torch.arange(q_chunk, device=q.device)
        for j in range(j_lo, j_hi + 1):
            k_lo, k_hi = j * kv_chunk, (j + 1) * kv_chunk
            s = _softcap(torch.bmm(q_i, kt[:, :, k_lo:k_hi]), softcap)
            # a block wholly inside the causal band and the window keeps
            # every score: no mask to build
            if ((causal and k_hi - 1 > q_lo)
                    or (window is not None and k_lo <= q_hi - window)):
                kpos = k_lo + torch.arange(kv_chunk, device=q.device)
                msk = torch.ones((q_chunk, kv_chunk), dtype=torch.bool,
                                 device=q.device)
                if causal:
                    msk &= kpos[None, :] <= qpos[:, None]
                if window is not None:
                    msk &= kpos[None, :] > qpos[:, None] - window
                s = torch.where(msk.repeat(G, 1), s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            p = torch.exp(s - m_new)
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, keepdim=True)
            acc = acc * corr + torch.bmm(p, vt[:, k_lo:k_hi])
            m = m_new
        out_i = acc / torch.clamp(l, min=1e-30)
        outs.append(out_i.reshape(B, K, G, q_chunk, Dv).permute(
            0, 3, 1, 2, 4))                                   # [B,Cq,K,G,Dv]
    out = torch.cat(outs, dim=1).reshape(B, S, Hq, Dv)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# KV caches
# ---------------------------------------------------------------------------

@dataclass
class KVCache:
    """Full or windowed (circular) KV cache for one attention layer-stack.

    k/v: [L, B, W, Hkv, D]; index: next absolute position (a host int).
    W == max_len for full caches, == window for circular caches. Decode
    writes into k/v in place.
    """
    k: torch.Tensor
    v: torch.Tensor
    index: int


def init_kv_cache(cfg, layers: int, batch: int, max_len: int,
                  window: Optional[int] = None, dtype=torch.bfloat16,
                  device=None) -> KVCache:
    W = min(window, max_len) if window else max_len
    shape = (layers, batch, W, cfg.num_kv_heads, cfg.resolved_head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), 0)


def cache_axes(_cfg) -> KVCache:
    """The KV cache's logical axes (the reference's layout)."""
    ax = ("layers", "batch", "cache_seq", "act_kv_heads", "head_dim")
    return KVCache(ax, ax, ())


# The dry-run's 'baseline' variant: the plain decode keeps the scaled q and
# the probabilities in f32 (the reference's naive decode, which upcasts the
# whole cache). Set only by set_decode_f32_upcast.
_DECODE_F32_UPCAST = False


def set_decode_f32_upcast(flag: bool) -> None:
    """Make the plain decode route (:func:`decode_attention`, and its
    slice on a mesh) keep q and the probabilities in f32 rather than round
    them to the cache's dtype. The kernel route always keeps them in
    f32."""
    global _DECODE_F32_UPCAST
    _DECODE_F32_UPCAST = bool(flag)


def _decode_scores(q, k_cache, index: int, slots: int, first: int,
                   window: Optional[int], softcap: Optional[float]):
    """Scaled scores [B, K, G, n] of q [B, 1, Hq, D] against the cache
    slots ``first .. first + n`` of a ``slots``-slot cache, and the mask
    of the valid ones (the reference's slot mask)."""
    B, _, Hq, D = q.shape
    K = k_cache.shape[2]
    qf = q.reshape(B, K, Hq // K, D)
    if _DECODE_F32_UPCAST:
        qf = qf.to(torch.float32) * (D ** -0.5)
    else:
        qf = (qf * (D ** -0.5)).to(k_cache.dtype).to(torch.float32)
    s = torch.einsum("bkgd,bskd->bkgs", qf, k_cache.to(torch.float32))
    s = _softcap(s, softcap)
    slot = first + torch.arange(k_cache.shape[1], device=q.device)
    if window is None:
        valid = slot <= index
    else:
        pos_of_slot = index - torch.remainder(index - slot, slots)
        valid = ((pos_of_slot >= 0) & (pos_of_slot > index - slots)
                 & (pos_of_slot <= index))
    return s, valid


def _probs_times_v(p, v_cache):
    if not _DECODE_F32_UPCAST:
        p = p.to(v_cache.dtype).to(torch.float32)
    return torch.einsum("bkgs,bskd->bkgd", p, v_cache.to(torch.float32))


def decode_attention(q, k_cache, v_cache, index: int, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None) -> torch.Tensor:
    """One-token attention in plain torch, as the reference computes it.
    q: [B,1,Hq,D]; caches: [B,W,Hkv,D].

    ``index`` is the absolute position of the new token; cache slot layout
    is circular when ``window`` is set (slot = pos % W), linear otherwise.
    The scaled q and the probabilities are rounded to the cache's dtype
    before the products, as the reference does (unless
    :func:`set_decode_f32_upcast`); products sum in f32.
    """
    B, _, Hq, D = q.shape
    s, valid = _decode_scores(q, k_cache, index, k_cache.shape[1], 0,
                              window, softcap)
    p = torch.softmax(torch.where(valid, s, NEG_INF), dim=-1)
    out = _probs_times_v(p, v_cache)
    return out.reshape(B, 1, Hq, D).to(q.dtype)


def decode_attention_slice(q, k_cache, v_cache, index: int, slots: int,
                           first: int, *, window: Optional[int] = None,
                           softcap: Optional[float] = None):
    """:func:`decode_attention` over the cache slots ``first ..`` of a
    ``slots``-slot cache (one rank's share): (o [B, Hq, D] float32,
    normalised within the slice, lse [B, Hq] float32). A slice with no
    valid slot gives o = 0 and lse = -inf. Slices merge with
    :func:`combine_partials`."""
    B, _, Hq, D = q.shape
    s, valid = _decode_scores(q, k_cache, index, slots, first, window,
                              softcap)
    p, lse = slice_softmax(s, valid)
    out = _probs_times_v(p, v_cache)
    return out.reshape(B, Hq, D), lse.reshape(B, Hq)


# ---------------------------------------------------------------------------
# Full attention block (projections + rope + attention)
# ---------------------------------------------------------------------------

def head_proj(cfg, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] @ w [d, H, hd] -> [B, S, H, hd] in cfg.dtype."""
    B, S, _ = x.shape
    # FSDP: the embed rows gathered, the heads' split kept (8 kv heads
    # split over a 16-wide axis would not view as heads)
    w2 = gather_fsdp(w.to(dtype_of(cfg)).reshape(w.shape[0], -1))
    return dense(x, w2).reshape(B, S, w.shape[1], w.shape[2])


def _project(cfg, p: dict, x: torch.Tensor):
    """x [B, S, d] -> q [B,S,Hq,hd], k / v [B,S,Hkv,hd] in cfg.dtype."""
    q, k, v = (head_proj(cfg, x, p[n]) for n in ("wq", "wk", "wv"))
    if cfg.qk_norm:
        q = _qk_norm(q, p["q_norm"], cfg.norm_eps)
        k = _qk_norm(k, p["k_norm"], cfg.norm_eps)
    return q, k, v


def _merge_heads(o: torch.Tensor) -> torch.Tensor:
    """o [B, S, H, hd] -> [B, S, H·hd]. On a mesh the gradient is placed
    as the merged o was before it is viewed back to heads: DTensor may
    hand it back split over "model" along the merged dim at a point
    inside a head (gemma's 8 heads, whole over a 16-wide axis), which no
    view can undo."""
    m = o.reshape(*o.shape[:2], -1)
    if isinstance(m, DTensor) and m.requires_grad:
        mesh, pl = m.device_mesh, tuple(m.placements)
        m.register_hook(lambda g: g if tuple(g.placements) == pl
                        else g.redistribute(mesh, pl))
    return m


def out_proj(cfg, p: dict, o: torch.Tensor) -> torch.Tensor:
    wo = p["wo"].to(dtype_of(cfg))
    return dense(_merge_heads(o), wo.reshape(-1, wo.shape[-1]))


def _kernel_route(cfg, x: torch.Tensor, use_kernels: bool) -> bool:
    """Whether attention runs through the port's kernels (their wrappers
    take the plain version for a CPU tensor)."""
    if not use_kernels:
        return False
    if cfg.attn_logit_softcap:
        if x.is_cuda:
            raise NotImplementedError(
                "attention logit softcap on the card: the port's attention "
                "kernels take no softcap (ROADMAP Queue 3); no registered "
                "config sets one")
        return False
    return True


def kv_head_slice(q_heads: int, kv_heads: int, shards: int,
                  index: int) -> slice:
    """The kv heads that shard ``index`` of ``shards`` equal splits of
    ``q_heads`` query heads reads under GQA (q head h reads kv head
    h // (q_heads / kv_heads)). Each shard's q heads must read an equal
    run of kv heads: the group is a multiple of the shard's heads (one kv
    head a shard) or the shard's heads a multiple of the group."""
    if q_heads % kv_heads or q_heads % shards or not 0 <= index < shards:
        raise ValueError(f"{q_heads} q heads, {kv_heads} kv heads: no even "
                         f"split into {shards} shards at {index}")
    group, local = q_heads // kv_heads, q_heads // shards
    if group % local and local % group:
        raise ValueError(f"{local} q heads a shard straddle the GQA groups "
                         f"of {group}")
    lo = index * local // group
    return slice(lo, lo + max(1, local // group))


def _attend_sharded(cfg, q: DTensor, k, v, *, causal: bool,
                    window: Optional[int], impl: str,
                    use_kernels: bool) -> DTensor:
    """:func:`attend` on each rank's local heads and rows. A mesh dim that
    splits q's batch splits k's and v's too; one that splits q's heads
    leaves k and v whole on the way in, and each rank cuts them to its
    q heads' kv heads (their gradients are then partial sums over it);
    any other split is gathered first."""
    mesh = q.device_mesh
    qp, kp, kg = [], [], []
    for p in q.placements:
        if isinstance(p, Shard) and p.dim in (0, 2):
            qp.append(p)
            kp.append(p if p.dim == 0 else Replicate())
            kg.append(p if p.dim == 0 else Partial())
        else:
            qp.append(Replicate())
            kp.append(Replicate())
            kg.append(Replicate())
    head_dims = [i for i, p in enumerate(qp) if p == Shard(2)]
    shards, index = 1, 0
    coord = mesh.get_coordinate()
    for i in head_dims:                 # mesh order: major first
        shards, index = shards * mesh.size(i), index * mesh.size(i) + coord[i]
    kv = kv_head_slice(q.shape[2], k.shape[2], shards, index)

    def local(ql, kl, vl):
        return attend(cfg, ql, kl[:, :, kv], vl[:, :, kv], causal=causal,
                      window=window, impl=impl, use_kernels=use_kernels)

    qp, kp, kg = tuple(qp), tuple(kp), tuple(kg)
    return shard_map(local, mesh=mesh, in_specs=(qp, kp, kp), out_specs=qp,
                     in_grad_specs=(None, kg, kg))(q, k, v)


def attend(cfg, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool, window: Optional[int] = None, impl: str = "chunked",
           use_kernels: bool = True) -> torch.Tensor:
    """Softmax attention, q [B, Sq, Hq, D] against k / v [B, Sk, Hkv, D],
    positions from 0 for both (Sq may differ from Sk when not causal): the
    flash kernel on the kernel route, else ``impl``'s plain version. A
    DTensor q runs on each rank's local shards (:func:`_attend_sharded`)."""
    if isinstance(q, DTensor):
        return _attend_sharded(cfg, q, k, v, causal=causal, window=window,
                               impl=impl, use_kernels=use_kernels)
    if _kernel_route(cfg, q, use_kernels):
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2), causal=causal,
                               window=window).transpose(1, 2)
    if impl == "naive":
        return naive_attention(q, k, v, causal=causal, window=window,
                               softcap=cfg.attn_logit_softcap)
    return chunked_attention(q, k, v, causal=causal, window=window,
                             softcap=cfg.attn_logit_softcap)


def decode_attend(cfg, q: torch.Tensor, k_cache: torch.Tensor,
                  v_cache: torch.Tensor, index: int, *,
                  window: Optional[int] = None,
                  use_kernels: bool = True) -> torch.Tensor:
    """One query token a row, q [B, 1, Hq, D], against caches
    [B, W, Hkv, D] at absolute position ``index``: the decode kernel with
    ``length = min(index + 1, W)`` on the kernel route, else the plain
    slot mask. DTensor caches split over ``cache_seq`` run on each rank's
    slice (:func:`_decode_attend_sharded`)."""
    if isinstance(k_cache, DTensor):
        return _decode_attend_sharded(cfg, q, k_cache, v_cache, index,
                                      window=window, use_kernels=use_kernels)
    if _kernel_route(cfg, q, use_kernels):
        B, _, Hq, D = q.shape
        return decode_attention_kernel(
            q.reshape(B, Hq, D), k_cache.transpose(1, 2),
            v_cache.transpose(1, 2),
            min(index + 1, k_cache.shape[1])).reshape(B, 1, Hq, D)
    return decode_attention(q, k_cache, v_cache, index, window=window,
                            softcap=cfg.attn_logit_softcap)


def _seq_slice(cache: DTensor):
    """(first slot, slots) of this rank's slice of a DTensor cache
    [B, W, Hkv, D] whose dim 1 splits evenly over one or more mesh dims
    (major first, in mesh order)."""
    mesh = cache.device_mesh
    coord = mesh.get_coordinate()
    shards, index = 1, 0
    for i, p in enumerate(cache.placements):
        if p == Shard(1):
            shards, index = shards * mesh.size(i), index * mesh.size(i) + coord[i]
    W = cache.shape[1]
    if W % shards:
        raise ValueError(f"a {W}-slot cache does not split evenly into "
                         f"{shards} slices")
    return index * (W // shards), W // shards


def _batch_rows_of(cache: DTensor):
    """The placements that keep only ``cache``'s batch split (dim 0)."""
    return tuple(p if p == Shard(0) else Replicate() for p in cache.placements)


def write_slot(cache: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``cache[:, slot] = new`` in place, cache [B, W, Hkv, D], new
    [B, Hkv, D]. On a DTensor cache the rank whose slice holds ``slot``
    writes it into its local shard (a DTensor write on a split dim would
    move the cache); the others leave theirs as it is."""
    if not isinstance(cache, DTensor):
        cache[:, slot] = new.to(cache.dtype)
        return
    first, n = _seq_slice(cache)
    new = new.redistribute(cache.device_mesh, _batch_rows_of(cache))
    if first <= slot < first + n:
        cache.to_local()[:, slot - first] = new.to_local().to(cache.dtype)


def _decode_attend_sharded(cfg, q, k_cache: DTensor, v_cache: DTensor,
                           index: int, *, window: Optional[int],
                           use_kernels: bool) -> DTensor:
    """:func:`decode_attend` on caches split over ``cache_seq`` (and
    their batch over the data axes): each rank attends its rows' q to its
    slice (the kernel with ``length - first`` clamped to the slice, or the
    plain slot mask), and the slices' (o, lse) pairs, gathered over the
    mesh dims that split the cache, merge by :func:`combine_partials`."""
    mesh = k_cache.device_mesh
    B, _, Hq, D = q.shape
    W = k_cache.shape[1]
    first, n = _seq_slice(k_cache)
    cp = tuple(k_cache.placements)
    rows = _batch_rows_of(k_cache)
    # each rank's pair: a leading dim over the slices, then the batch
    parts = tuple(Shard(0) if p == Shard(1) else
                  Shard(1) if p == Shard(0) else Replicate() for p in cp)
    kernel = _kernel_route(cfg, q, use_kernels)
    length = max(0, min(min(index + 1, W) - first, n))

    def local(ql, kl, vl):
        if kernel:
            o, lse = decode_attention_partial(
                ql.reshape(ql.shape[0], Hq, D), kl.transpose(1, 2),
                vl.transpose(1, 2), length)
        else:
            o, lse = decode_attention_slice(
                ql, kl, vl, index, W, first, window=window,
                softcap=cfg.attn_logit_softcap)
        return o[None], lse[None]

    o, lse = shard_map(local, mesh=mesh, in_specs=(rows, cp, cp),
                       out_specs=(parts, parts))(q, k_cache, v_cache)
    whole = tuple(Shard(1) if p == Shard(0) else Replicate() for p in cp)
    o = combine_partials(o.redistribute(mesh, whole),
                         lse.redistribute(mesh, whole), q.dtype)
    return o.reshape(B, 1, Hq, D)


def attn_apply(cfg, p: dict, x: torch.Tensor, *,
               positions: Optional[torch.Tensor], causal: bool = True,
               window: Optional[int] = None, impl: str = "chunked",
               kv_for_cache: bool = False, use_kernels: bool = True):
    """Multi-head GQA attention over a full sequence.

    Returns (out, (k, v)) — roped k and raw v for cache seeding when
    ``kv_for_cache``. ``impl`` picks the plain implementation when the
    plain route runs; the kernel route computes the same function.
    """
    q, k, v = _project(cfg, p, x)
    if positions is not None:  # rope; None for non-positional (cross-attn)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    q = lshard(q, "batch", "seq", "act_heads", None)
    k = lshard(k, "batch", "seq", "act_kv_heads", None)
    v = lshard(v, "batch", "seq", "act_kv_heads", None)
    o = attend(cfg, q, k, v, causal=causal, window=window, impl=impl,
               use_kernels=use_kernels)
    o = lshard(o, "batch", "seq", "act_heads", None)
    out = lshard(out_proj(cfg, p, o), "batch", "seq", "act_embed")
    if kv_for_cache:
        return out, (k, v)
    return out, None


def attn_decode_apply(cfg, p: dict, x: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, index: int, *,
                      window: Optional[int] = None,
                      use_kernels: bool = True) -> torch.Tensor:
    """One-token attention step. x: [B,1,D]; caches [B,W,Hkv,D], updated
    in place at the new token's slot. Returns out [B,1,D]."""
    q, k, v = _project(cfg, p, x)
    pos = torch.full((x.shape[0], 1), index, dtype=torch.int32,
                     device=x.device)
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    W = k_cache.shape[1]
    if window is not None:
        slot = index % W
    elif index < W:
        slot = index
    else:
        raise ValueError(f"decode position {index} is past the full cache's "
                         f"{W} slots (prefill with a larger max_len)")
    write_slot(k_cache, k[:, 0], slot)
    write_slot(v_cache, v[:, 0], slot)
    o = decode_attend(cfg, q, k_cache, v_cache, index, window=window,
                      use_kernels=use_kernels)
    return out_proj(cfg, p, o)
