"""AdamW and its learning-rate schedule, from scratch.

Port of ``src/repro/training/optimizer.py``. The state is a tree parallel
to the params (moments in float32, or ``opt_dtype``) with a step counter,
all on the params' device. Params and state are nested dicts of tensors;
:func:`tree_map` and :func:`tree_leaves` walk them in sorted key order, as
``jax.tree`` walks a dict.

:func:`apply_updates` runs under ``torch.no_grad()`` and returns new
params and a new state, as the reference does (nothing is updated in
place). Its per-leaf arithmetic is the reference's ``upd`` in the same
order, in float32; the schedule and the bias corrections are float32
tensors on the device, as in the reference.

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
    dtype, new state, {"grad_norm", "lr"}). Each leaf's gradient is
    clipped as it is updated (no clipped copy of the whole tree)."""
    scale, gnorm = _clip_scale(grads, cfg.grad_clip)
    step = state.step + 1
    lr = lr_schedule(cfg, step)
    b1, b2 = cfg.beta1, cfg.beta2
    stepf = step.to(torch.float32)
    bc1 = 1 - torch.pow(b1, stepf)
    bc2 = 1 - torch.pow(b2, stepf)
    odt = DTYPES[cfg.opt_dtype]

    def upd(p, g, m, v):
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

    out = tree_map(upd, params, grads, state.m, state.v)

    def part(i):    # the i-th of each leaf's (p, m, v)
        return tree_map(lambda t: t[i], out)

    return part(0), AdamWState(step, part(1), part(2)), {
        "grad_norm": gnorm, "lr": lr}
