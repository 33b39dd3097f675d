"""Mixture-of-Experts layer: top-k routing with three implementations.

Port of ``src/repro/models/moe.py`` on one device:

``dense``   — every expert computes every token, gated combine: the oracle.
``ragged``  — token copies sorted by expert, one grouped product per
              expert over its contiguous run of copies (the reference's
              ``jax.lax.ragged_dot``), a global capacity bound.
``batched`` — a fixed per-expert capacity ``cap_e``: each of the
              ``E * cap_e`` expert slots gathers its token row, and each
              expert runs one batched product. Copies past ``cap_e`` drop,
              as in the reference (olmoe runs this one).

All return ``(y, aux)`` where aux is the switch-style load-balance loss
``E * sum_e(frac_tokens_e * mean_prob_e)``. The grouped and batched
products are plain ``torch.matmul``: the reference leaves them to XLA
outside any Pallas kernel. The sort is stable (``torch.argsort(...,
stable=True)``, as ``jnp.argsort`` is), so capacity drops the same copies.

Not ported: the expert-parallel ``shard_map`` / ``psum`` and FSDP branches
(``moe_apply`` with a mesh raises) and the ``bf16_grad`` custom VJP; they
come with the distributed and training slices (ROADMAP Queue 1).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import dtype_of
from repro_torch.models.spec import P


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    return {
        "router": P((d, m.num_experts), ("embed", None), init="small"),
        "wi": P((m.num_experts, d, f),
                ("experts", "expert_embed", "expert_mlp"), fan_in=d),
        "wg": P((m.num_experts, d, f),
                ("experts", "expert_embed", "expert_mlp"), fan_in=d),
        "wo": P((m.num_experts, f, d),
                ("experts", "expert_mlp", "expert_embed"), fan_in=f),
    }


def _act(cfg, g: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return (F.gelu(g, approximate="tanh") if cfg.activation == "geglu"
            else F.silu(g))


def _route(cfg, router_w: torch.Tensor, x2d: torch.Tensor):
    """x2d: [T, D] -> (probs [T,E] f32, gate [T,k], idx [T,k], aux)."""
    m = cfg.moe
    logits = torch.matmul(x2d.to(torch.float32), router_w.to(torch.float32))
    probs = torch.softmax(logits, dim=-1)
    gate, idx = torch.topk(probs, m.top_k, dim=-1)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    E = m.num_experts
    hard = torch.zeros((x2d.shape[0], E), dtype=torch.float32,
                       device=x2d.device)
    hard.scatter_(1, idx, 1.0)
    frac = hard.mean(0) / m.top_k
    pbar = probs.mean(0)
    aux = E * torch.sum(frac * pbar)
    return probs, gate, idx, aux


def moe_dense(cfg, p: dict, x: torch.Tensor):
    """Reference: [.., D] -> all-experts dense compute, gated combine."""
    m = cfg.moe
    dt = dtype_of(cfg)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    _, gate, idx, aux = _route(cfg, p["router"], x2)
    h = torch.einsum("td,edf->etf", x2, p["wi"].to(dt))
    g = torch.einsum("td,edf->etf", x2, p["wg"].to(dt))
    h = _act(cfg, g.to(torch.float32)).to(dt) * h
    y_e = torch.einsum("etf,efd->etd", h, p["wo"].to(dt))     # [E,T,D]
    T = x2.shape[0]
    comb = torch.zeros((T, m.num_experts), dtype=dt, device=x.device)
    comb.scatter_add_(1, idx, gate.to(dt))
    y = torch.einsum("etd,te->td", y_e, comb)
    return y.reshape(shape), aux


def _capacity(tokens_times_k: int, shards: int, cf: float) -> int:
    cap = int(math.ceil(tokens_times_k / shards * cf))
    return max(8, -(-cap // 8) * 8)  # round up to multiple of 8


def moe_ragged_local(cfg, p: dict, x: torch.Tensor):
    """Sort + grouped-product MoE with a global capacity bound."""
    m = cfg.moe
    dt = dtype_of(cfg)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    T = x2.shape[0]
    k = m.top_k
    E = p["wi"].shape[0]
    _, gate, idx, aux = _route(cfg, p["router"], x2)

    flat_id = idx.reshape(-1)                                   # [T*k]
    flat_gate = gate.reshape(-1)
    order = torch.argsort(flat_id, stable=True)
    cap = min(_capacity(T * k, 1, m.capacity_factor), T * k)
    sel = order[:cap]                                           # kept copies
    tok = sel // k
    xs = x2[tok]                                                # [cap, D]
    counts = torch.bincount(flat_id, minlength=E)[:E]
    cum_cl = torch.clamp(torch.cumsum(counts, 0), max=cap)
    starts = torch.cat([cum_cl.new_zeros(1), cum_cl[:-1]])

    wi, wg, wo = p["wi"].to(dt), p["wg"].to(dt), p["wo"].to(dt)
    y_cp = torch.zeros((cap, shape[-1]), dtype=dt, device=x.device)
    # one product per expert over its run of sorted copies (ragged_dot);
    # the run bounds come to the host once
    for e, (lo, hi) in enumerate(zip(starts.tolist(), cum_cl.tolist())):
        if hi > lo:
            xe = xs[lo:hi]
            h = torch.matmul(xe, wi[e])
            g = torch.matmul(xe, wg[e])
            h = _act(cfg, g.to(torch.float32)).to(dt) * h
            y_cp[lo:hi] = torch.matmul(h, wo[e])
    keep = torch.arange(cap, device=x.device) < cum_cl[-1]     # drop overflow
    w_cp = flat_gate[sel] * keep
    y = torch.zeros((T, shape[-1]), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok, y_cp.to(torch.float32) * w_cp[:, None])
    return y.to(dt).reshape(shape), aux


def moe_batched_local(cfg, p: dict, x: torch.Tensor):
    """Fixed per-expert capacity MoE via a slot-level gather and one batched
    product per expert (``[E, cap_e, D]``); copies past ``cap_e`` drop."""
    m = cfg.moe
    dt = dtype_of(cfg)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    T, D = x2.shape
    k = m.top_k
    E = p["wi"].shape[0]
    _, gate, idx, aux = _route(cfg, p["router"], x2)

    cap_e = _capacity(T * k, E, m.capacity_factor)
    flat_id = idx.reshape(-1)                                   # [T*k]
    flat_gate = gate.reshape(-1)
    order = torch.argsort(flat_id, stable=True)
    counts = torch.bincount(flat_id, minlength=E)[:E]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])[:-1]
    n_slots = E * cap_e
    slot = torch.arange(n_slots, device=x.device)
    e_idx, pos = slot // cap_e, slot % cap_e
    valid = pos < counts[e_idx]
    src = torch.where(valid, starts[e_idx] + pos, torch.zeros_like(pos))
    copy_idx = order[src]                                       # [slots]
    tok_slot = torch.where(valid, copy_idx // k, torch.full_like(pos, T))
    gate_slot = torch.where(valid, flat_gate[copy_idx],
                            torch.zeros((), dtype=flat_gate.dtype,
                                        device=x.device))

    x2p = torch.cat([x2.to(dt), x2.new_zeros((1, D), dtype=dt)], dim=0)
    xs = x2p[tok_slot].reshape(E, cap_e, D)
    h = torch.bmm(xs, p["wi"].to(dt))
    g = torch.bmm(xs, p["wg"].to(dt))
    h = _act(cfg, g.to(torch.float32)).to(dt) * h
    y_e = torch.bmm(h, p["wo"].to(dt))                          # [E,cap,D]

    y = torch.zeros((T + 1, D), dtype=torch.float32, device=x.device)
    y.index_add_(0, tok_slot, y_e.reshape(-1, D).to(torch.float32)
                 * gate_slot[:, None].to(torch.float32))
    return y[:T].to(dt).reshape(shape), aux


_LOCAL_IMPLS = {"ragged": moe_ragged_local, "batched": moe_batched_local}


def moe_apply(cfg, p: dict, x: torch.Tensor, *, mesh: Optional[object] = None):
    """Dispatch on impl. x: [B, S, D]. One device only: a mesh raises."""
    if mesh is not None:
        raise NotImplementedError(
            "expert-parallel MoE over a mesh is still to port (ROADMAP "
            "Queue 1, the sharded-LM item)")
    if cfg.moe.impl == "dense":
        return moe_dense(cfg, p, x)
    return _LOCAL_IMPLS.get(cfg.moe.impl, moe_ragged_local)(cfg, p, x)
