"""Public wrappers over the port's hand-written kernels.

Port of ``src/repro/kernels/ops.py``. The reference picks Pallas interpret
mode off-TPU (``_default_interpret``); the port has no such switch: each
wrapper runs its plain PyTorch version for a tensor on the CPU and its
CUDA kernel for a tensor on the card. All four kernels of the reference
are ported.
"""
from __future__ import annotations

from repro_torch.kernels.decode_attention import decode_attention
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_embed import fused_embed
from repro_torch.kernels.rmsnorm import rmsnorm

__all__ = ["decode_attention", "flash_attention", "fused_embed", "rmsnorm"]
