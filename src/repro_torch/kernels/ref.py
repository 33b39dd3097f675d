"""Plain PyTorch versions of the port's kernels (allclose targets).

Port of ``src/repro/kernels/ref.py``. Each hand-written kernel of the
port has its plain version here: the wrapper takes it for a tensor on the
CPU, and the tests and ``chip_smoke.py`` hold the kernel against it. Only
``fused_embed`` is ported so far; the attention and normalisation oracles
come with their kernels.
"""
from __future__ import annotations

import torch


def fused_embed_ref(x: torch.Tensor, w: torch.Tensor, mean: float = 0.0,
                    scale: float = 1.0) -> torch.Tensor:
    """Normalize+project+tanh: x [N, D], w [D, K] -> [N, K], math in f32,
    output in x's dtype."""
    z = (x.to(torch.float32) - mean) * scale
    return torch.tanh(z @ w.to(torch.float32)).to(x.dtype)
