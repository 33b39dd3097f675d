"""AdamW and its learning-rate schedule, from scratch.

Port of ``src/repro/training/optimizer.py``. The state is a tree parallel
to the params (moments in float32, or ``opt_dtype``) with a step counter,
all on the params' device. Params and state are nested dicts of tensors;
:func:`tree_map` and :func:`tree_leaves` walk them in sorted key order, as
``jax.tree`` walks a dict.

:func:`apply_updates` runs under ``torch.no_grad()``. It returns new
param tensors (a caller may keep the old ones, as the benchmark keeps the
first step's to measure the change) and a new state whose moments are the
old state's tensors updated in place, where the reference returns new
ones: an update that made new moments beside the old ones and the float32
gradients held about 24 bytes a parameter at once, which a model of
billions of parameters on one card cannot spare. Each leaf is updated in
slices along its first dim (``UPDATE_ELEMENTS`` at most a slice, where its
rows allow), so its float32 temporaries are a slice's. Its arithmetic is
the reference's ``upd`` in the same order, in float32; the schedule and
the bias corrections are float32 tensors on the device, as in the
reference. DTensor leaves (a device mesh) are updated whole into new
tensors, as the reference does.

On a device mesh the params are DTensors and so is the state: each moment
takes its param's placements (:func:`init_state`, :func:`state_axes`), so
FSDP-sharded params have FSDP-sharded moments, as in the reference; the
step counter stays a plain tensor, the same on every rank.
:func:`abstract_state` gives the state as ``meta`` tensors.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, List, NamedTuple, Tuple, Union

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.spec import DTYPES

# elements of a leaf that one slice of the AdamW update takes (at least one
# row along the first dim): 256 MiB of each float32 temporary
UPDATE_ELEMENTS = 1 << 26


@dataclass(frozen=True)
class OptimizerConfig:
    learning_rate: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    # bfloat16 moments halve the optimizer's memory
    opt_dtype: str = "float32"


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the params' device
    m: Any
    v: Any


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of the same structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[torch.Tensor]:
    """The leaves of nested dicts, in sorted key order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def init_state(params, opt_dtype: str = "float32") -> AdamWState:
    """Zero moments in ``opt_dtype``, each like its param (placements
    included), and a zero step."""
    dt = DTYPES[opt_dtype]
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return AdamWState(
        torch.zeros((), dtype=torch.int32, device=device),
        tree_map(lambda p: torch.zeros_like(p, dtype=dt), params),
        tree_map(lambda p: torch.zeros_like(p, dtype=dt), params))


def abstract_state(abstract_params, opt_dtype: str = "float32"
                   ) -> AdamWState:
    """The state as ``meta`` tensors (no allocation)."""
    dt = DTYPES[opt_dtype]
    z = tree_map(lambda p: torch.empty(p.shape, dtype=dt, device="meta"),
                 abstract_params)
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"), z, z)


def state_axes(param_axes) -> AdamWState:
    """The state's logical axes: each moment's are its param's."""
    return AdamWState((), param_axes, param_axes)


def lr_schedule(cfg: OptimizerConfig,
                step: Union[int, torch.Tensor]) -> torch.Tensor:
    """Linear warm-up to ``learning_rate``, then a cosine decay to
    ``min_lr_ratio`` of it at ``total_steps``; a float32 scalar."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.learning_rate * step / max(cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return torch.where(step < cfg.warmup_steps, warm, cfg.learning_rate * cos)


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together; a DTensor leaf's square
    sum is reduced over the ranks (a plain scalar after)."""
    def sq(leaf):
        s = torch.sum(torch.square(leaf.to(torch.float32)))
        return s.full_tensor() if isinstance(s, DTensor) else s

    return torch.sqrt(sum(sq(leaf) for leaf in tree_leaves(tree)))


def _clip_scale(grads, max_norm: float) -> Tuple[torch.Tensor, torch.Tensor]:
    g = global_norm(grads)
    return torch.clamp(max_norm / torch.clamp(g, min=1e-9), max=1.0), g


def clip_by_global_norm(grads, max_norm: float) -> Tuple[Any, torch.Tensor]:
    """Grads scaled to a global norm of at most ``max_norm`` (float32), and
    the norm before."""
    scale, g = _clip_scale(grads, max_norm)
    return tree_map(lambda x: x.to(torch.float32) * scale, grads), g


@torch.no_grad()
def apply_updates(cfg: OptimizerConfig, params, grads,
                  state: AdamWState) -> Tuple[Any, AdamWState, dict]:
    """One AdamW step: clip, bias-corrected moments, decoupled weight decay
    on params with ``ndim >= 2`` only. Returns (new params in each param's
    dtype, the state with its moments updated in place and its step
    advanced, {"grad_norm", "lr"}). Each leaf's gradient is clipped as it
    is updated (no clipped copy of the whole tree)."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    odt = DTYPES[cfg.opt_dtype]

    def upd(p, g, m, v):
        """A DTensor leaf: new param, m and v, as the reference."""
        g = g.to(torch.float32) * scale
        m32 = b1 * m.to(torch.float32) + (1 - b1) * g
        v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
        mh = m32 / bc1
        vh = v32 / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if p.ndim >= 2:     # decay matrices only (norms / scales exempt)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p = p.to(torch.float32) - lr * delta
        return new_p.to(p.dtype), m32.to(odt), v32.to(odt)

    def upd_slice(p, g, m, v, new, decay: bool):
        """``upd`` on a slice, m and v in place, the new param into
        ``new``: the same operations in the same order."""
        g = g.to(torch.float32) * scale
        if m.dtype == torch.float32:
            m32 = m.mul_(b1).add_(g * (1 - b1))
            v32 = v.mul_(b2).add_(torch.square(g) * (1 - b2))
        else:               # stored rounded; the update takes the f32 ones
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g
            v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g)
            m.copy_(m32)
            v.copy_(v32)
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if decay:
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        torch.sub(p.to(torch.float32), lr * delta, out=new)

    def leaf(p, g, m, v):
        if isinstance(p, DTensor):
            return upd(p, g, m, v)
        new = torch.empty_like(p)
        if p.ndim == 0:
            upd_slice(p, g, m, v, new, False)
            return new, m, v
        rows = max(1, UPDATE_ELEMENTS // max(p[0].numel(), 1))
        for lo in range(0, p.shape[0], rows):
            sl = slice(lo, lo + rows)
            upd_slice(p[sl], g[sl], m[sl], v[sl], new[sl], p.ndim >= 2)
        return new, m, v

    out = tree_map(leaf, params, grads, state.m, state.v)

    def part(i):    # the i-th of each leaf's (p, m, v)
        return tree_map(lambda t: t[i], out)

    return part(0), AdamWState(step, part(1), part(2)), {
        "grad_norm": gnorm, "lr": lr}
