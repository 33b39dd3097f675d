"""Hand-written Hopper kernels of the port and their plain versions.

Port of ``src/repro/kernels/__init__.py``.
"""
from repro_torch.kernels.ops import (decode_attention, flash_attention,
                                     fused_embed, rmsnorm)

__all__ = ["decode_attention", "flash_attention", "fused_embed", "rmsnorm"]
