"""Exact matmul-FLOP counting of a traced step.

Port of ``src/repro/analysis/jaxpr_flops.py``. The reference walks the
jaxpr: scans count their body times their length, ``ragged_dot`` counts
2·m·k·n and ``shard_map`` bodies count once per shard (times the mesh
size). The port runs the callable eagerly (on real, meta or fake tensors)
under :class:`FlopCounter`, a dispatch mode that counts the ops
``torch.utils.flop_counter`` knows (``mm``, ``addmm``, ``bmm``,
``baddbmm``, the convolutions and fused attentions), so:

- a Python loop over layers counts each iteration, which is the
  reference's scan times its length;
- the recompute that remat (``torch.utils.checkpoint``) runs in the
  backward is counted, as it is in the reference's jaxpr;
- a grouped (MoE) product, one matmul per expert over its run of rows,
  sums to 2·m·k·n over the m rows;
- a DTensor op is seen once, at its global shapes (the mode returns
  ``NotImplemented`` so DTensor runs it; its local pieces are not counted
  again); an op in the body of the port's ``shard_map`` (DTensor's
  ``local_map``) runs on local shapes, so it counts times the body's
  distinct shards (the mesh size, less the dims along which every input
  is replicated and every rank repeats the same work), in the forward
  and, through the autograd nodes the body made, in the backward
  (``repro_torch.distributed.sharding.track_shard_bodies``).

DTensor works out an op's output shapes by running the op once more on
stand-ins of the global shapes (its sharding propagator's tensor-meta
step, on a cache miss); under ``FakeTensorMode`` those runs come through
the modes as plain ops, so the counter ignores what runs inside that
step.

Returns GLOBAL flops; divide by the rank count for the ideal-parallel
per-device figure, as the reference does. Elementwise ops are excluded,
as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.distributed.sharding import (in_replayed_forward,
                                              shard_body_size,
                                              track_shard_bodies)


def op_flops(func, args, kwargs, out=None) -> float:
    """The FLOPs of one aten op at its arguments' shapes (0 for an op
    that is not a matmul, convolution or fused attention)."""
    fn = flop_registry.get(func._overloadpacket)
    return 0.0 if fn is None else float(fn(*args, **kwargs, out_val=out))


_META = threading.local()
_META_STEPS = ("_propagate_tensor_meta_non_cached", "_propagate_tensor_meta")


def meta_propagation_method() -> str:
    """The name of DTensor's tensor-meta step on this torch."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in _META_STEPS:
        if callable(getattr(ShardingPropagator, name, None)):
            return name
    raise RuntimeError(
        "DTensor's ShardingPropagator has none of "
        f"{_META_STEPS}: its global-shape stand-in runs cannot be told "
        "from the rank's own ops, and every count would include them")


# A strided shard (a split dim flattened into another) finds its local
# size and offsets from an index tensor that DTensor makes with
# torch.arange and reads with .tolist(), when it prices a candidate
# placement and when it redistributes; on a fake tensor .tolist() fails
_STRIDED_OFFSETS = "local_shard_size_and_offset"


@contextlib.contextmanager
def _skip_meta_propagation():
    """While active, :func:`in_meta_propagation` is true inside DTensor's
    tensor-meta step and inside a strided shard's offset arithmetic (the
    methods are wrapped for the block), and the offset arithmetic runs
    with the fake mode unset: its index tensor is a real (host) one.
    Raises if this torch has no tensor-meta step: the stand-in runs would
    then be counted as the rank's own work."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    from torch.distributed.tensor.placement_types import _StridedShard

    def marked(orig, unfake: bool):
        @functools.wraps(orig)
        def wrapped(*args, **kwargs):
            prev = getattr(_META, "depth", 0)
            _META.depth = prev + 1
            try:
                with (unset_fake_temporarily() if unfake
                      else contextlib.nullcontext()):
                    return orig(*args, **kwargs)
            finally:
                _META.depth = prev
        return wrapped

    wraps = [(ShardingPropagator, meta_propagation_method(), False)]
    if _STRIDED_OFFSETS in _StridedShard.__dict__:
        wraps.append((_StridedShard, _STRIDED_OFFSETS, True))
    origs = [(cls, n, cls.__dict__[n]) for cls, n, _ in wraps]
    for (cls, n, unfake), (_, _, orig) in zip(wraps, origs):
        setattr(cls, n, marked(getattr(cls, n), unfake))
    try:
        yield
    finally:
        for cls, n, orig in origs:
            setattr(cls, n, orig)


def in_meta_propagation() -> bool:
    return getattr(_META, "depth", 0) > 0


def _shards_of_current_op() -> int:
    """The distinct shards of the shard_map body this op belongs to: the
    forward body running now, or the body that made the autograd node the
    backward is running (0: neither). A remat unit's replay in the
    backward is forward work: only a body it runs counts."""
    size = shard_body_size()
    if size or in_replayed_forward():
        return size
    node = torch._C._current_autograd_node()
    if node is not None:
        return int(node.metadata.get("shards", 0))
    return 0


class FlopCounter(TorchDispatchMode):
    """Counts global matmul FLOPs of what runs inside it (``.flops``)."""

    def __init__(self):
        super().__init__()
        self.dtensor_flops = 0.0    # DTensor ops, global shapes
        self.body_flops = 0.0       # shard_map bodies, times their shards
        self.plain_flops = 0.0      # plain tensors outside any body
        self.saw_dtensor = False
        self._track = None

    @property
    def flops(self) -> float:
        """Global FLOPs. On a mesh a plain op outside a shard_map body is a
        local piece of a DTensor op, already counted at its global
        shapes; off a mesh every op is plain."""
        plain = 0.0 if self.saw_dtensor else self.plain_flops
        return self.dtensor_flops + self.body_flops + plain

    def __enter__(self):
        self._track = contextlib.ExitStack()
        self._track.enter_context(track_shard_bodies())
        self._track.enter_context(_skip_meta_propagation())
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            self._track.close()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            # counted here at global shapes; DTensor then runs its local
            # pieces, which come back to this mode as plain ops
            self.saw_dtensor = True
            self.dtensor_flops += op_flops(func, args, kwargs)
            self.on_dtensor_op(func, args, kwargs)
            return NotImplemented
        out = func(*args, **kwargs)
        if in_meta_propagation():
            return out
        n = op_flops(func, args, kwargs, out)
        shards = _shards_of_current_op()
        if shards:
            self.body_flops += n * shards
        else:
            self.plain_flops += n
        self.on_local_op(func, args, kwargs, out, n)
        return out

    def on_dtensor_op(self, func, args, kwargs) -> None:
        """Hook for a subclass: a DTensor-level op, before it runs."""

    def on_local_op(self, func, args, kwargs, out, flops: float) -> None:
        """Hook for a subclass: an op on plain (local) tensors, after it
        ran, with its FLOPs at local shapes."""


def count_flops(fn, *args, **kwargs) -> float:
    """Global matmul FLOPs of ``fn(*args, **kwargs)``, run eagerly."""
    with FlopCounter() as fc:
        fn(*args, **kwargs)
    return fc.flops


def flops_of(fn, *abstract_args) -> float:
    """:func:`count_flops` of ``fn`` on stand-ins (``meta`` tensors, as
    ``repro_torch.models.input_specs`` gives them, or real ones); meta
    tensors run through ``FakeTensorMode`` so no data is made."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        args = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
                for a in abstract_args]
        return count_flops(fn, *args)
