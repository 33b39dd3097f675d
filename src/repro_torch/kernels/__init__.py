"""Hand-written Hopper kernels of the port and their plain versions.

Port of ``src/repro/kernels/__init__.py``.
"""
from repro_torch.kernels.ops import fused_embed

__all__ = ["fused_embed"]
