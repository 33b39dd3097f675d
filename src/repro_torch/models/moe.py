"""Mixture-of-Experts layer: top-k routing with three implementations.

Port of ``src/repro/models/moe.py``:

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

Expert parallelism: on a device mesh with a ``"model"`` axis,
:func:`moe_apply` runs ``ragged`` / ``batched`` as the reference's
``shard_map`` does. Each model rank owns ``E / ep`` experts (``wi`` /
``wg`` split ``(model, fsdp, None)``, ``wo`` ``(model, None, fsdp)``),
all-gathers their FSDP shards (autograd-aware, so the backward is a
reduce-scatter), offsets the expert ids by its rank, takes the capacity
over ``ep`` shards (``ep * E_local`` for ``batched``), and computes only
the copies routed to its experts; the combine is a sum over ``"model"``.
Routing runs on the DTensors before that: its means over the tokens are
global means, which is what the reference's ``pmean`` of ``frac`` and
``pbar`` over the data axes gives. Its capacity is the reference's EP
capacity, so its token drops can differ from the single-device call.
``set_moe_bf16_collectives(True)`` rounds the combine and the expert
weights' gradients (:func:`bf16_grad`) through bfloat16.

DeepSeek-V3-style routing (Moonlight) is set by ``MoEConfig``: sigmoid
scores (``scoring``), a fixed ``selection_bias`` added for the choice of
the top-k only, the chosen unbiased scores renormalised and scaled by
``routed_scaling``; ``num_shared_experts`` SwiGLU experts of
``d_ff_expert`` each run on every token as one SwiGLU (``"shared"``) added
to the routed result. A chip's share of an expert-parallel layer without
a mesh: ``expert_shards`` chips divide the layer's experts, the router
scores all ``num_experts * expert_shards`` of them, this one holds the
first ``num_experts`` and computes their copies only, under the capacity
of the whole layer (``_ragged`` / ``_batched`` at ``ep = expert_shards``,
rank 0); what the other chips would add is not computed here.

Spans (:mod:`repro_torch.tracing`): ``moe.route`` (scores, choice,
gates), ``moe.experts`` (the held experts' gather, products and combine)
and ``moe.shared``; while a profiler records, ``_batched`` counts the
copies routed to the held experts (``moe.routed``) and those its capacity
dropped (``moe.dropped``).
"""
from __future__ import annotations

import functools
import math
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.sharding import (PartitionSpec, axis_size,
                                              shard_map, spec_placements)
from repro_torch.models.layers import dtype_of, mlp_apply, mlp_specs
from repro_torch.models.spec import P
from repro_torch.tracing import count, recording, span


def moe_specs(cfg) -> dict:
    m = cfg.moe
    d, f = cfg.d_model, m.d_ff_expert
    s = {
        "router": P((d, m.routed_experts), ("embed", None), init="small"),
        "wi": P((m.num_experts, d, f),
                ("experts", "expert_embed", "expert_mlp"), fan_in=d),
        "wg": P((m.num_experts, d, f),
                ("experts", "expert_embed", "expert_mlp"), fan_in=d),
        "wo": P((m.num_experts, f, d),
                ("experts", "expert_mlp", "expert_embed"), fan_in=f),
    }
    if m.num_shared_experts:
        s["shared"] = mlp_specs(d, m.num_shared_experts * f)
    return s


def _act(cfg, g: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return (F.gelu(g, approximate="tanh") if cfg.activation == "geglu"
            else F.silu(g))


class _BF16Grad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(torch.bfloat16).to(g.dtype)


def bf16_grad(x: torch.Tensor) -> torch.Tensor:
    """Identity with a bf16 cotangent: halves the FSDP reduce-scatter of
    expert-weight gradients."""
    return _BF16Grad.apply(x)


# bf16 collectives for the MoE block (EP combine and FSDP grad
# reduce-scatter), as the reference's knob
_BF16_COLLECTIVES = False


def set_moe_bf16_collectives(flag: bool) -> None:
    global _BF16_COLLECTIVES
    _BF16_COLLECTIVES = flag


# the selection bias as a tensor, by (values, device)
_BIAS: dict = {}


def _bias(m, device) -> torch.Tensor:
    key = (m.selection_bias, str(device))
    if key not in _BIAS:
        _BIAS[key] = torch.tensor(m.selection_bias, dtype=torch.float32,
                                  device=device)
    return _BIAS[key]


def _route(cfg, router_w: torch.Tensor, x2d: torch.Tensor):
    """x2d: [T, D] -> (probs [T,E] f32, gate [T,k], idx [T,k], aux) over
    the ``routed_experts`` the router scores. The choice is the top-k of
    the scores plus the selection bias; the gates are the chosen scores
    renormalised, times ``routed_scaling``. On DTensors the token means
    are over every rank's tokens."""
    m = cfg.moe
    with span("moe.route"):
        logits = torch.matmul(x2d.to(torch.float32),
                              router_w.to(torch.float32))
        probs = (torch.sigmoid(logits) if m.scoring == "sigmoid"
                 else torch.softmax(logits, dim=-1))
        if m.selection_bias:
            _, idx = torch.topk(probs + _bias(m, probs.device), m.top_k,
                                dim=-1)
            gate = probs.gather(1, idx)
        else:
            gate, idx = torch.topk(probs, m.top_k, dim=-1)
        gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
        if m.routed_scaling != 1.0:
            gate = gate * m.routed_scaling
        E = m.routed_experts
        hard = torch.zeros_like(probs).scatter(1, idx, 1.0)
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


def _own(idx: torch.Tensor, gate: torch.Tensor, E_local: int, rank: int):
    """Flat expert ids local to the rank owning ``E_local`` experts from
    ``rank * E_local`` on (``E_local`` for a copy routed elsewhere) and the
    gates with those copies zeroed."""
    local_id = idx - rank * E_local
    own = (local_id >= 0) & (local_id < E_local)
    flat_id = torch.where(own, local_id, torch.full_like(local_id, E_local))
    flat_gate = torch.where(own, gate, torch.zeros_like(gate))
    return flat_id.reshape(-1), flat_gate.reshape(-1)


def _expert_counts(flat_id: torch.Tensor, E: int) -> torch.Tensor:
    """Copies routed to each of the E experts (ids of E, the copies this
    rank does not own, are dropped): ``bincount`` with a size fixed by E,
    so a trace on fake tensors (the dry-run) knows it."""
    ones = torch.ones_like(flat_id)
    return torch.zeros(E + 1, dtype=flat_id.dtype,
                       device=flat_id.device).scatter_add_(0, flat_id,
                                                           ones)[:E]


def _ragged(cfg, x2, gate, idx, wi, wg, wo, ep: int = 1, rank: int = 0):
    """Sort + grouped products over the copies routed to this rank's
    experts, a capacity over ``ep`` shards: y [T, D] float32 (this rank's
    share of the combine)."""
    m = cfg.moe
    dt = dtype_of(cfg)
    T, D = x2.shape
    k = m.top_k
    E = wi.shape[0]
    flat_id, flat_gate = _own(idx, gate, E, rank)              # [T*k]
    order = torch.argsort(flat_id, stable=True)
    cap = min(_capacity(T * k, ep, m.capacity_factor), T * k)
    sel = order[:cap]                                           # kept copies
    tok = sel // k
    xs = x2[tok]                                                # [cap, D]
    counts = _expert_counts(flat_id, E)
    cum_cl = torch.clamp(torch.cumsum(counts, 0), max=cap)
    starts = torch.cat([cum_cl.new_zeros(1), cum_cl[:-1]])

    wi, wg, wo = wi.to(dt), wg.to(dt), wo.to(dt)
    y_cp = torch.zeros((cap, D), dtype=dt, device=x2.device)
    # one product per expert over its run of sorted copies (ragged_dot);
    # the run bounds come to the host once
    for e, (lo, hi) in enumerate(zip(starts.tolist(), cum_cl.tolist())):
        if hi > lo:
            xe = xs[lo:hi]
            h = torch.matmul(xe, wi[e])
            g = torch.matmul(xe, wg[e])
            h = _act(cfg, g.to(torch.float32)).to(dt) * h
            y_cp[lo:hi] = torch.matmul(h, wo[e])
    keep = torch.arange(cap, device=x2.device) < cum_cl[-1]    # drop overflow
    w_cp = flat_gate[sel] * keep
    y = torch.zeros((T, D), dtype=torch.float32, device=x2.device)
    return y.index_add(0, tok, y_cp.to(torch.float32) * w_cp[:, None])


def _batched(cfg, x2, gate, idx, wi, wg, wo, ep: int = 1, rank: int = 0):
    """Slot-level gather and one batched product per expert of this rank,
    ``cap_e`` slots an expert over ``ep * E_local`` shards: y [T, D]
    float32 (this rank's share of the combine)."""
    m = cfg.moe
    dt = dtype_of(cfg)
    T, D = x2.shape
    k = m.top_k
    E = wi.shape[0]
    cap_e = _capacity(T * k, ep * E, m.capacity_factor)
    flat_id, flat_gate = _own(idx, gate, E, rank)              # [T*k]
    order = torch.argsort(flat_id, stable=True)
    counts = _expert_counts(flat_id, E)
    if recording():
        routed = counts.sum()
        count("moe.routed", routed)
        count("moe.dropped", routed - counts.clamp(max=cap_e).sum())
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])[:-1]
    n_slots = E * cap_e
    slot = torch.arange(n_slots, device=x2.device)
    e_idx, pos = slot // cap_e, slot % cap_e
    valid = pos < counts[e_idx]
    src = torch.where(valid, starts[e_idx] + pos, torch.zeros_like(pos))
    copy_idx = order[src]                                       # [slots]
    # an empty slot reads (as zeros) and adds (zeros) at a row of its own,
    # slot % T: sent to one shared row, the empty slots' atomic adds in the
    # combine and in the gather's backward all land on that row in turn
    tok_slot = torch.where(valid, copy_idx // k, slot % T)
    gate_slot = torch.where(valid, flat_gate[copy_idx],
                            torch.zeros((), dtype=flat_gate.dtype,
                                        device=x2.device))

    xs = torch.where(valid[:, None], x2.to(dt)[tok_slot],
                     torch.zeros((), dtype=dt, device=x2.device))
    xs = xs.reshape(E, cap_e, D)
    h = torch.bmm(xs, wi.to(dt))
    g = torch.bmm(xs, wg.to(dt))
    h = _act(cfg, g.to(torch.float32)).to(dt) * h
    y_e = torch.bmm(h, wo.to(dt))                               # [E,cap,D]

    y = torch.zeros((T, D), dtype=torch.float32, device=x2.device)
    return y.index_add(0, tok_slot, y_e.reshape(-1, D).to(torch.float32)
                       * gate_slot[:, None].to(torch.float32))


def _single_device(cfg, p: dict, x: torch.Tensor, combine):
    """One device's share of the layer: all of it, or with
    ``expert_shards`` its held experts' part."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    _, gate, idx, aux = _route(cfg, p["router"], x2)
    with span("moe.experts"):
        y = combine(cfg, x2, gate, idx, p["wi"], p["wg"], p["wo"],
                    ep=cfg.moe.expert_shards)
        y = y.to(dtype_of(cfg)).reshape(shape)
    return y, aux


def moe_ragged_local(cfg, p: dict, x: torch.Tensor):
    """Sort + grouped-product MoE with a global capacity bound, on one
    device."""
    return _single_device(cfg, p, x, _ragged)


def moe_batched_local(cfg, p: dict, x: torch.Tensor):
    """Fixed per-expert capacity MoE via a slot-level gather and one batched
    product per expert (``[E, cap_e, D]``); copies past ``cap_e`` drop. One
    device."""
    return _single_device(cfg, p, x, _batched)


_LOCAL_IMPLS = {"ragged": moe_ragged_local, "batched": moe_batched_local}

_COMBINES = {"ragged": _ragged, "batched": _batched}


def _ep_body(cfg, combine, mesh, ep_axis: str, fsdp: tuple,
             x2, gate, idx, wi, wg, wo):
    """One rank's share of the EP block on its local shards: FSDP gathers,
    its experts' copies, its share of y (a partial sum over ``ep_axis``)."""
    import torch.distributed._functional_collectives as fc
    # the autograd-aware gather (its backward a reduce-scatter); older
    # torch names it all_gather_tensor_autograd
    all_gather = getattr(fc, "all_gather_single_autograd", None) or \
        fc.all_gather_tensor_autograd
    names = tuple(mesh.mesh_dim_names)
    for a in reversed(fsdp):            # minor axis first: major-first order
        g = (mesh, names.index(a))
        wi, wg = all_gather(wi, 1, g), all_gather(wg, 1, g)
        wo = all_gather(wo, 2, g)
    if _BF16_COLLECTIVES:
        # bf16 cotangents: the grad reduce-scatter (the transpose of these
        # gathers) moves half the bytes
        wi, wg, wo = bf16_grad(wi), bf16_grad(wg), bf16_grad(wo)
    y = combine(cfg, x2, gate, idx, wi, wg, wo, ep=axis_size(ep_axis, mesh),
                rank=mesh.get_local_rank(names.index(ep_axis)))
    # EP combine in bf16: half the bytes
    return y.to(dtype_of(cfg)) if _BF16_COLLECTIVES else y


def _on_mesh(t: torch.Tensor, mesh, placements) -> torch.Tensor:
    """``t`` as a DTensor; a plain tensor is taken as the same whole value
    on every rank (a jax array's meaning)."""
    if isinstance(t, DTensor):
        return t
    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def _moe_ep(cfg, p: dict, x: torch.Tensor, mesh, ep_axis: str, fsdp_axes):
    """The reference's EP ``shard_map`` branch of :func:`moe_apply`."""
    PS = PartitionSpec
    names = tuple(mesh.mesh_dim_names)
    dp = tuple(a for a in ("pod", "data") if a in names)
    fsdp = dp if fsdp_axes is None else tuple(fsdp_axes)
    # x (its rows split over the data axes, whole over "model") and the
    # expert weights as the reference's in_specs place them
    rows = spec_placements(mesh, PS(dp, None))
    w_specs = {k: spec_placements(mesh, s) for k, s in (
        ("router", PS(None, None)), ("wi", PS(ep_axis, fsdp, None)),
        ("wg", PS(ep_axis, fsdp, None)), ("wo", PS(ep_axis, None, fsdp)))}
    x = _on_mesh(x, mesh, rows)
    p = {k: _on_mesh(p[k], mesh, w_specs[k]) for k in w_specs}
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    _, gate, idx, aux = _route(cfg, p["router"], x2)
    # a model rank's share of y covers its own experts' copies, and so does
    # its gradient for x and the gates: partial sums over ep_axis
    partial = spec_placements(mesh, PS(dp, None), partial=(ep_axis,))
    body = functools.partial(_ep_body, cfg, _COMBINES[cfg.moe.impl], mesh,
                             ep_axis, fsdp)
    y = shard_map(body, mesh=mesh,
                  in_specs=(rows, rows, rows, w_specs["wi"], w_specs["wg"],
                            w_specs["wo"]),
                  out_specs=partial,
                  in_grad_specs=(partial, partial, None, None, None,
                                 None))(x2, gate, idx, p["wi"], p["wg"],
                                        p["wo"])
    y = y.redistribute(mesh, rows)                          # psum combine
    return y.to(dtype_of(cfg)).reshape(shape), aux


def moe_apply(cfg, p: dict, x: torch.Tensor, *, mesh=None,
              ep_axis: str = "model", fsdp_axes=None):
    """Dispatch on impl and mesh. x: [B, S, D]. With a mesh that has
    ``ep_axis`` (a ``DeviceMesh``), ``ragged`` and ``batched`` run expert
    parallel (see the module docstring); ``dense`` runs on DTensors as
    they are placed. The shared experts, where the config has them, are
    added after."""
    y, aux = _routed(cfg, p, x, mesh, ep_axis, fsdp_axes)
    if "shared" in p:
        with span("moe.shared"):
            y = y + mlp_apply(cfg, p["shared"], x)
    return y, aux


def _routed(cfg, p: dict, x: torch.Tensor, mesh, ep_axis: str, fsdp_axes):
    local = _LOCAL_IMPLS.get(cfg.moe.impl, moe_ragged_local)
    names = None if mesh is None else getattr(mesh, "mesh_dim_names", None)
    if mesh is not None and names is None:
        raise TypeError(f"moe_apply: {type(mesh).__name__} is not a device "
                        "mesh (no mesh_dim_names)")
    if cfg.moe.impl == "dense" or mesh is None or ep_axis not in names:
        if cfg.moe.impl == "dense":
            return moe_dense(cfg, p, x)
        return local(cfg, p, x)
    return _moe_ep(cfg, p, x, mesh, ep_axis, fsdp_axes)
