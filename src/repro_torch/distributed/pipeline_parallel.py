"""GPipe-style pipeline parallelism over a ``torch.distributed`` group:
rank s of S owns stage s's layers; microbatches ripple through a ring for
M + S - 1 ticks.

Each tick, every rank runs its stage on its input, then the ring shift
sends the output to rank s + 1 and receives rank s - 1's. Stage 0 takes
microbatch t at tick t; the last stage emits microbatch t - (S - 1). Its
outputs are replicated to every rank by a sum over the group.

Differentiable end to end, as the reference's ``ppermute`` ring is under
``jax.grad``: the shift is an ``autograd.Function`` whose backward shifts
the gradient the other way, and ``loss.backward()`` on every rank (each
computing the same loss from the replicated outputs) leaves each rank its
own stage's gradients. Every rank builds the same graph (stage 0's input
and the last stage's outputs are picked with ``torch.where``, never a
Python branch on the rank), so the backward's sends and receives pair up
tick for tick.

The final sum is an ``autograd.Function`` whose backward passes the
gradient through unchanged (the cotangent of a replicated value is the
same on every rank), where ``torch.distributed.nn.functional.all_reduce``
would sum the S ranks' cotangents and give S times the gradient.

Port of ``src/repro/distributed/pipeline_parallel.py``.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist


def _shift(x: torch.Tensor, group, step: int) -> torch.Tensor:
    """Send ``x`` to rank + step and return what rank - step sent."""
    S = dist.get_world_size(group)
    if S == 1:                       # a ring of one is the identity
        return x.clone()
    r = dist.get_rank(group)
    to, frm = (r + step) % S, (r - step) % S
    if group is not None:            # P2POp takes global ranks
        to = dist.get_global_rank(group, to)
        frm = dist.get_global_rank(group, frm)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, to, group),
           dist.P2POp(dist.irecv, out, frm, group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    """Forward: to rank + 1, from rank - 1. Backward: the reverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _shift(x, group, 1)

    @staticmethod
    def backward(ctx, g):
        return _shift(g, ctx.group, -1), None


class _ReplicatedSum(torch.autograd.Function):
    """Forward: sum over the group. Backward: the gradient unchanged."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gpipe_apply(stage_fn: Callable, stage_params, microbatches: torch.Tensor,
                group=None) -> torch.Tensor:
    """``stage_fn(params, x) -> y`` applies this rank's stage.
    microbatches: [M, mb, ...], the same on every rank. Returns the last
    stage's [M, mb, ...] outputs on every rank."""
    S = dist.get_world_size(group)
    sid = dist.get_rank(group)
    M = microbatches.shape[0]
    first = torch.tensor(sid == 0, device=microbatches.device)
    last = torch.tensor(sid == S - 1, device=microbatches.device)
    buf_in = torch.zeros_like(microbatches[0])
    outputs = []
    for t in range(M + S - 1):
        # stage 0 injects microbatch t (clamped past the end)
        x = torch.where(first, microbatches[min(t, M - 1)], buf_in)
        y = stage_fn(stage_params, x)
        buf_in = _RingShift.apply(y, group)
        if t >= S - 1:               # the last stage emits t - (S - 1)
            outputs.append(torch.where(last, y, torch.zeros_like(y)))
    return _ReplicatedSum.apply(torch.stack(outputs), group)


def make_pipelined_fn(stage_fn: Callable, group=None) -> Callable:
    """``f(stage_params, microbatches)``: the pipelined forward over
    ``group``, where ``stage_params`` are this rank's stage's (the
    reference's leading stage dim, already split across the ranks)."""

    def fn(stage_params, microbatches):
        return gpipe_apply(stage_fn, stage_params, microbatches, group=group)

    return fn


def pipeline_bubble_fraction(num_micro: int, num_stages: int) -> float:
    """GPipe bubble overhead: (S-1)/(M+S-1)."""
    return (num_stages - 1) / (num_micro + num_stages - 1)
