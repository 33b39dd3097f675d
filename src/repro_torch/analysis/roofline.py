"""Roofline terms and model FLOPs of a dry-run cell.

Port of ``src/repro/analysis/hlo.py``. The reference parses collectives
out of XLA's HLO text (``parse_collectives``); the port counts them while
it traces (:mod:`repro_torch.analysis.op_cost`), so only the accounting
types and the arithmetic carry over: :class:`CollectiveStats` with the
reference's keys, ``_COLL_WEIGHT``, :func:`roofline_terms` and
:func:`model_flops`, unchanged.

Hardware model: NVIDIA H100 SXM5 80GB, data-sheet figures, not
measurements (the reference's are the TPU v5e's; none carries over):

- ``PEAK_FLOPS`` = 989e12: dense bf16 tensor-core FLOP/s per GPU (NVIDIA
  H100 data sheet, SXM5; 1979e12 is the figure with 2:4 sparsity).
- ``HBM_BW`` = 3.35e12: HBM3 bytes/s per GPU (same sheet).
- ``LINK_BW`` = 50e9: bytes/s per GPU across nodes, one 400 Gb/s NDR
  InfiniBand NIC per GPU (a DGX H100 / HGX node's eight ConnectX-7). The
  production mesh's 16-wide ``"model"`` axis spans two 8-GPU nodes, so
  its ring runs at the slowest link, as the reference's one ``ICI_BW``
  stands for its ring. Within a node NVLink 4 gives 450e9 bytes/s per
  direction per GPU (900 GB/s both ways), which the terms do not use.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per GPU (data sheet)
HBM_BW = 3.35e12             # bytes/s per GPU (data sheet)
LINK_BW = 50e9               # bytes/s per GPU, NDR InfiniBand (data sheet)


@dataclass
class CollectiveStats:
    op_counts: Dict[str, int] = field(default_factory=dict)
    operand_bytes: Dict[str, int] = field(default_factory=dict)
    result_bytes: Dict[str, int] = field(default_factory=dict)

    @property
    def total_operand_bytes(self) -> int:
        return sum(self.operand_bytes.values())

    @property
    def total_result_bytes(self) -> int:
        return sum(self.result_bytes.values())

    def to_dict(self) -> dict:
        return {"op_counts": self.op_counts,
                "operand_bytes": self.operand_bytes,
                "result_bytes": self.result_bytes,
                "total_operand_bytes": self.total_operand_bytes,
                "total_result_bytes": self.total_result_bytes}


# Effective link-cost weight per collective byte (ring schedules):
#   all-reduce moves ~2x the payload; others ~1x.
_COLL_WEIGHT = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
                "all-to-all": 1.0, "collective-permute": 1.0}


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   coll_operand_bytes: Dict[str, float]) -> dict:
    """Three roofline terms in seconds, all inputs per device: FLOPs from
    the counter (global / ranks), bytes and collective traffic from the
    traced ops of one rank."""
    compute_s = flops_per_device / PEAK_FLOPS
    memory_s = bytes_per_device / HBM_BW
    coll_bytes = sum(coll_operand_bytes.values())
    weighted = sum(_COLL_WEIGHT.get(k, 1.0) * v
                   for k, v in coll_operand_bytes.items())
    collective_s = weighted / LINK_BW
    dominant = max((("compute", compute_s), ("memory", memory_s),
                    ("collective", collective_s)), key=lambda kv: kv[1])[0]
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "collective_bytes": coll_bytes,
        "collective_bytes_weighted": weighted,
        "dominant": dominant,
    }


def model_flops(cfg, shape, *, per_device: bool = True,
                chips: int = 256) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); D = tokens.

    Enc-dec archs split the seq budget (enc, dec) = (S/2, S/2) and only the
    decoder runs at decode time, so N is apportioned per sub-stack.
    """
    n = cfg.active_param_count() if cfg.is_moe else cfg.param_count()
    mult = 6.0 if shape.kind == "train" else 2.0
    if cfg.is_encoder_decoder:
        # rough split: encoder layers vs decoder layers (+embed on decoder)
        n_layers = cfg.num_layers + cfg.num_encoder_layers
        n_enc = n * cfg.num_encoder_layers / n_layers
        n_dec = n - n_enc
        se = shape.seq_len - shape.seq_len // 2
        sd = shape.seq_len // 2
        if shape.kind == "decode":
            total = mult * n_dec * shape.global_batch
        else:
            total = mult * (n_enc * se + n_dec * sd) * shape.global_batch
    elif shape.kind == "decode":
        total = mult * n * shape.global_batch
    else:
        total = mult * n * shape.global_batch * shape.seq_len
    return total / chips if per_device else total
