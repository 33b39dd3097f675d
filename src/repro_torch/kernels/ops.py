"""Public wrappers over the port's hand-written kernels.

Port of ``src/repro/kernels/ops.py``. The reference picks Pallas interpret
mode off-TPU (``_default_interpret``); the port has no such switch: each
wrapper runs its plain PyTorch version for a tensor on the CPU and its
CUDA kernel for a tensor on the card. Only ``fused_embed`` is ported so
far; ``rmsnorm``, ``decode_attention`` and ``flash_attention`` follow in
later slices.
"""
from __future__ import annotations

from repro_torch.kernels.fused_embed import fused_embed

__all__ = ["fused_embed"]
