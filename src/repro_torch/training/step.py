"""Train / eval / prefill / serve step functions.

Port of ``src/repro/training/step.py``. There is no ``jit``: the steps run
eagerly. The train step differentiates ``model.loss`` with
``torch.autograd.grad`` over the params' leaves (detached views that
share their storage and require grad) where the reference takes
``jax.value_and_grad``, and raises if any of them gets no gradient: a
param cut off from the loss, or a kernel route that autograd cannot see,
would otherwise train silently wrong.

On a device mesh (params DTensors, the step run under ``axis_rules``)
each gradient comes back in whatever placements autograd left it (a
partial sum, for a weight whose rows the batch split), so it is
redistributed to its param's placements (a reduce-scatter) before the
norm, the clip and the update: what the reference's ``out_shardings``
does. A micro-batch of a DTensor batch takes the reference's global rows
and is split over the data axes as the batch is.

The train step's phases are spans (:mod:`repro_torch.tracing`), which
cost a flag read unless a ``torch.profiler`` is recording:
``train.forward`` (the tracked leaves and ``model.loss``) and
``train.backward`` (``torch.autograd.grad``, so the remat recompute and
every backward, the missing-grad check and the redistribute) of each
micro-batch, ``train.accumulate`` (its share of the float32 gradient sum,
with the final divide in the last one) and ``train.update``
(:func:`apply_updates`: global norm, clip, AdamW). To see them, profile a
step (``with torch.profiler.profile(activities=[CPU, CUDA]) as prof:
step(...)``), then ``prof.export_chrome_trace(path)``: the phases are the
``repro_torch/train.*`` ops on the host timeline, above the kernels they
launched; ``repro_torch.tracing.spans()`` gives each with its device time.
"""
from __future__ import annotations

import itertools
from typing import Callable, Dict, List, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

from repro_torch.distributed.sharding import (current_mesh, current_rules,
                                              lshard, to_placements)
from repro_torch.tracing import span

from repro_torch.training.optimizer import (AdamWState, OptimizerConfig,
                                            apply_updates, tree_leaves,
                                            tree_map)


def _paths(tree, prefix: str = "") -> List[str]:
    """Leaf paths (``"a/b"``) in sorted key order, as ``tree_map`` visits."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                        f"{prefix}{k}/")]
    return [prefix.rstrip("/")]


def _loss_and_grads(model, params, batch, step: int = 0, micro: int = 0
                    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], list]:
    """(loss, metrics), both detached, and the grads of the params' leaves
    in ``tree_leaves`` order. Raises ``RuntimeError`` naming every leaf
    that got no gradient. ``step`` and ``micro`` label its spans."""
    with span("train.forward", step, micro):
        tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
        leaves = tree_leaves(tracked)
        loss, metrics = model.loss(tracked, batch)
    with span("train.backward", step, micro):
        grads = list(torch.autograd.grad(loss, leaves, allow_unused=True))
        missing = [path for path, g in zip(_paths(params), grads)
                   if g is None]
        if missing:
            raise RuntimeError(f"no gradient reached {len(missing)} params "
                               f"({', '.join(missing[:8])}): they are cut "
                               "off from the loss")
        grads = [g.redistribute(p.device_mesh, p.placements)
                 if isinstance(p, DTensor) else g
                 for p, g in zip(leaves, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            grads)


def _micro_batches(batch: Dict[str, torch.Tensor], n: int) -> list:
    """``batch`` cut along dim 0 into ``n`` equal micro-batches."""
    rows = {v.shape[0] for v in batch.values()}
    if len(rows) != 1 or next(iter(rows)) % n:
        raise ValueError(f"batch rows {sorted(rows)} do not split into "
                         f"{n} equal micro-batches")
    size = next(iter(rows)) // n
    whole = {k: _gathered(v) for k, v in batch.items()}

    def cut(k, i):
        mb = whole[k][i * size:(i + 1) * size]
        v = batch[k]
        if isinstance(v, DTensor):      # the rows, split as the batch is
            mb = mb.redistribute(v.device_mesh, v.placements)
        return mb

    return [{k: cut(k, i) for k in batch} for i in range(n)]


def _gathered(v):
    """A DTensor made whole on every rank (still a DTensor); else ``v``."""
    if not isinstance(v, DTensor):
        return v
    return v.redistribute(v.device_mesh,
                          (Replicate(),) * v.device_mesh.ndim)


def make_train_step(model, opt_cfg: OptimizerConfig,
                    accum_steps: int = 1) -> Callable:
    """fwd + bwd + AdamW: ``(params, opt_state, batch) -> (new params, new
    state, {"loss", model metrics, "grad_norm", "lr"})``. With
    ``accum_steps > 1`` the batch is split into micro-batches run one after
    another (gradient accumulation): their float32 grads are summed and
    divided, the loss is their mean, the metrics are the last one's.
    Its spans count steps by the function's own calls."""
    calls = itertools.count()

    def train_step(params, opt_state: AdamWState, batch):
        n = next(calls)
        if accum_steps <= 1:
            loss, metrics, grads = _loss_and_grads(model, params, batch, n)
        else:
            gsum = lsum = None
            for i, mb in enumerate(_micro_batches(batch, accum_steps)):
                loss, metrics, g = _loss_and_grads(model, params, mb, n, i)
                with span("train.accumulate", n, i):
                    if gsum is None:    # 0 + g: the first sum is g itself
                        gsum = [x.to(torch.float32) for x in g]
                        lsum = loss.to(torch.float32)
                    else:
                        for a, b in zip(gsum, g):
                            a.add_(b.to(torch.float32))
                        lsum = lsum + loss
                    del g
                    if i == accum_steps - 1:
                        grads = [a.div_(accum_steps) for a in gsum]
                        loss = lsum / accum_steps
        with span("train.update", n):
            it = iter(grads)
            grad_tree = tree_map(lambda p: next(it), params)
            new_params, new_state, om = apply_updates(opt_cfg, params,
                                                      grad_tree, opt_state)
        return new_params, new_state, {"loss": loss, **metrics, **om}

    return train_step


def make_eval_step(model) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            loss, metrics = model.loss(params, batch)
        return {"loss": loss, **metrics}

    return eval_step


def make_prefill_step(model) -> Callable:
    def prefill_step(params, batch):
        if model.cfg.is_encoder_decoder:
            return model.prefill(params, batch)
        return model.prefill(params, batch["tokens"])

    return prefill_step


def make_serve_step(model, greedy: bool = True) -> Callable:
    """One decode step: (params, state, tokens[B,1]) -> (next[B,1], state).
    The state's cache is updated in place (see ``LM.decode_step``). Under
    ``axis_rules`` with a device mesh (params DTensors, the state placed
    by ``model.cache_axes()``) whole tokens take the placements of
    ``("batch", None)`` first, and the state comes out in its own
    placements, as the reference's dry-run jits the step."""

    def serve_step(params, state, tokens):
        mesh, rules = current_mesh(), current_rules()
        if (rules is not None and isinstance(mesh, DeviceMesh)
                and not isinstance(tokens, DTensor)):
            tokens = distribute_tensor(
                tokens, mesh, to_placements(("batch", None), rules,
                                            mesh.mesh_dim_names),
                src_data_rank=None)
        logits, state = model.decode_step(params, state, tokens)
        # the vocab whole on each rank (a no-op off a mesh): each rank
        # takes its own rows' argmax
        nxt = lshard(logits[:, -1:, :], "batch", None, None).argmax(dim=-1)
        return nxt, state

    return serve_step
