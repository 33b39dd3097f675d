"""Dry-run analysis: FLOP counting, per-op cost, roofline terms, reports.

Port of ``src/repro/analysis/``. The reference reads XLA's IR (jaxprs and
optimized HLO text); the port traces the eager step under dispatch modes:
:mod:`~repro_torch.analysis.flops` (``jaxpr_flops.py``),
:mod:`~repro_torch.analysis.op_cost` (``hlo_cost.py``),
:mod:`~repro_torch.analysis.roofline` (``hlo.py``),
:mod:`~repro_torch.analysis.report` and
:mod:`~repro_torch.analysis.fill_experiments`.
"""
