"""Per-device cost of a traced step: bytes, matmul FLOPs, collectives.

Port of ``src/repro/analysis/hlo_cost.py``. The reference parses XLA's
optimized, post-SPMD HLO text: bytes accessed by every top-level
instruction (fusion internals free), while-loop bodies times their trip
counts, collectives by kind. The port has no compiled module: it traces
the eager step under :class:`OpCostMode`, a dispatch mode that sees every
aten op as it runs (on fake tensors in the dry-run) and returns an
:class:`OpCost` with the reference's ``HloCost`` fields and ``to_dict()``
keys:

- ``bytes_accessed``: per device, the operand and result bytes of every
  op on local tensors (DTensor ops come back to the mode as their local
  pieces). Eager PyTorch fuses nothing, so every op's round trip counts:
  that is what the card runs, and where it departs from XLA's
  fusion-boundary model. View ops (no data moved) count nothing.
- ``dot_flops``: per device, the matmul FLOPs at local shapes.
- ``collective_counts`` / ``collective_operand_bytes`` /
  ``collective_result_bytes``: the ``c10d_functional`` collectives that
  DTensor and the model issue, and DTensor's own
  ``_dtensor.shard_dim_alltoall`` (a shard-to-shard move on a ``"cuda"``
  mesh; a ``"cpu"`` mesh does it as an all-gather and a chunk), keyed by
  the reference's names.
- ``collective_ops``: the same collectives by kind, operand shape and
  dtype (``[kind, shape, dtype, count, operand bytes]``, most bytes
  first), which names what each term is made of. Not a reference key.
- The XLA-only fields have no counterpart: ``bytes_cpu_dtype_artifacts``
  is 0 (no CPU dtype-promotion pass runs), ``collective_operand_bytes_raw``
  equals ``collective_operand_bytes`` (no f32-for-bf16 correction is
  needed: the payloads are the dtypes the card moves), and
  ``loop_trip_counts`` is ``[]`` (a Python loop is unrolled as it runs).

The mode also counts global FLOPs as :class:`~repro_torch.analysis.flops.
FlopCounter` does (it is one), so one trace gives both.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List

import torch

from repro_torch.analysis.flops import FlopCounter

# c10d_functional op name -> the reference's collective name
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # DTensor's Shard(i) -> Shard(j)
    "broadcast": "collective-permute",
    "permute_tensor": "collective-permute",
}
# ops that move no data
_FREE = {"empty", "empty_strided", "empty_like", "detach", "alias",
         "lift_fresh", "_unsafe_view", "wait_tensor", "new_empty",
         "new_empty_strided"}


def _tensors(tree) -> List[torch.Tensor]:
    out = []
    if isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for t in tree:
            out.extend(_tensors(t))
    elif isinstance(tree, dict):
        for t in tree.values():
            out.extend(_tensors(t))
    return out


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclass
class OpCost:
    """The reference's ``HloCost``, per device."""
    bytes_accessed: float = 0.0
    bytes_cpu_dtype_artifacts: float = 0.0
    dot_flops: float = 0.0
    collective_operand_bytes: Dict[str, float] = field(default_factory=dict)
    collective_result_bytes: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    collective_operand_bytes_raw: Dict[str, float] = field(
        default_factory=dict)
    loop_trip_counts: List[int] = field(default_factory=list)
    # (kind, operand shape, dtype) -> [count, operand bytes]
    collective_by_shape: Dict[tuple, List[float]] = field(
        default_factory=dict)
    ops: int = 0                # aten ops traced (local and DTensor-level)
    global_flops: float = 0.0   # FlopCounter's count of the same trace

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_operand_bytes.values())

    @property
    def collective_ops(self) -> List[list]:
        return [[k, list(shape), dtype, n, b] for (k, shape, dtype), (n, b)
                in sorted(self.collective_by_shape.items(),
                          key=lambda kv: -kv[1][1])]

    def to_dict(self) -> dict:
        return {
            "bytes_cpu_dtype_artifacts": self.bytes_cpu_dtype_artifacts,
            "bytes_accessed": self.bytes_accessed,
            "dot_flops": self.dot_flops,
            "collective_operand_bytes": self.collective_operand_bytes,
            "collective_operand_bytes_raw": self.collective_operand_bytes_raw,
            "collective_result_bytes": self.collective_result_bytes,
            "collective_counts": self.collective_counts,
            "total_collective_bytes": self.total_collective_bytes,
            "loop_trip_counts": self.loop_trip_counts[:64],
        }


class OpCostMode(FlopCounter):
    """Collects an :class:`OpCost` (``.cost()``) of what runs inside it."""

    def __init__(self):
        super().__init__()
        self._cost = OpCost()

    def on_dtensor_op(self, func, args, kwargs) -> None:
        self._cost.ops += 1

    def on_local_op(self, func, args, kwargs, out, flops: float) -> None:
        c = self._cost
        c.ops += 1
        c.dot_flops += flops
        name = func._overloadpacket.__name__
        kind = _COLLECTIVES.get(name)
        ins = _tensors((args, kwargs))
        outs = _tensors(out)
        if kind is not None:
            ob, rb = float(_nbytes(ins[:1])), float(_nbytes(outs))
            for d, v in ((c.collective_counts, 1.0),
                         (c.collective_operand_bytes, ob),
                         (c.collective_operand_bytes_raw, ob),
                         (c.collective_result_bytes, rb)):
                d[kind] = d.get(kind, 0.0) + v
            key = (kind, tuple(ins[0].shape) if ins else (),
                   str(ins[0].dtype).replace("torch.", "") if ins else "")
            n, b = c.collective_by_shape.get(key, (0.0, 0.0))
            c.collective_by_shape[key] = [n + 1.0, b + ob]
        if func.is_view or name in _FREE or not outs:
            return      # a view, an allocation, a query of metadata
        c.bytes_accessed += float(_nbytes(ins) + _nbytes(outs))

    def cost(self) -> OpCost:
        self._cost.global_flops = self.flops
        return self._cost
