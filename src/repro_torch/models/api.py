"""Model construction and random batches.

Port of ``src/repro/models/api.py`` for the decoder-only LM (every family
but enc-dec). Tokens are
drawn by numpy from a seed (``jax.random`` has no counterpart), so a test
can hand the same batch to both packages.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import ENC_DEC_NOT_PORTED, LM


def build_model(cfg: ModelConfig, attn_impl: str = "chunked", *,
                use_kernels: bool = True) -> LM:
    """The decoder-only LM of every family but enc-dec (dense, moe, ssm,
    hybrid), which raises ``NotImplementedError``."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.arch_id}: {ENC_DEC_NOT_PORTED}")
    return LM(cfg, attn_impl=attn_impl, use_kernels=use_kernels)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               batch_override: int = 0,
               device: Optional[torch.device] = None
               ) -> Dict[str, torch.Tensor]:
    """Random token batch ``{"tokens": [B, S] int64}`` from
    ``numpy.random.default_rng(seed)``, on ``device`` (default CPU)."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"{cfg.arch_id}: {ENC_DEC_NOT_PORTED}")
    B = batch_override or shape.global_batch
    toks = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, shape.seq_len))
    return {"tokens": torch.from_numpy(toks).to(device or "cpu")}
