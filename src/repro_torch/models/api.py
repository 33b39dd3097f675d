"""Model construction and random batches.

Port of ``src/repro/models/api.py``. Batches are drawn by numpy from a
seed (``jax.random`` has no counterpart), so a test can hand the same
batch to both packages; the numbers differ from the reference's own
``make_batch``. ``input_specs`` gives the batch as ``meta`` tensors (the
reference's ``ShapeDtypeStruct`` stand-ins: shape and dtype, no storage).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Union

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.encdec import EncDecModel
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import LM


def build_model(cfg: ModelConfig, attn_impl: str = "chunked", *,
                use_kernels: bool = True) -> Union[LM, EncDecModel]:
    """``EncDecModel`` for an encoder-decoder config, else the decoder-only
    ``LM`` (dense, moe, ssm, hybrid)."""
    if cfg.is_encoder_decoder:
        return EncDecModel(cfg, attn_impl=attn_impl, use_kernels=use_kernels)
    return LM(cfg, attn_impl=attn_impl, use_kernels=use_kernels)


def make_batch(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0,
               batch_override: int = 0,
               device: Optional[torch.device] = None
               ) -> Dict[str, torch.Tensor]:
    """Random batch from ``numpy.random.default_rng(seed)`` on ``device``
    (default CPU): ``{"tokens": [B, S]}``, or for an encoder-decoder
    config ``{"frames": [B, S - S // 2, d_model]`` standard normal in
    cfg.dtype, ``"tokens": [B, S // 2]}``, as the reference lays it out."""
    B = batch_override or shape.global_batch
    S = shape.seq_len
    rng = np.random.default_rng(seed)
    dev = device or "cpu"
    if cfg.is_encoder_decoder:
        se, sd = S - S // 2, S // 2
        frames = rng.standard_normal((B, se, cfg.d_model)).astype(np.float32)
        toks = rng.integers(0, cfg.vocab_size, (B, sd))
        return {"frames": torch.from_numpy(frames).to(dev, dtype_of(cfg)),
                "tokens": torch.from_numpy(toks).to(dev)}
    toks = rng.integers(0, cfg.vocab_size, (B, S))
    return {"tokens": torch.from_numpy(toks).to(dev)}


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                batch_override: int = 0) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins of a batch (no allocation): ``{"tokens": [B, S]
    int32}``, or ``frames`` [B, S - S // 2, d_model] in cfg.dtype and
    ``tokens`` [B, S // 2] for an encoder-decoder config."""
    B = batch_override or shape.global_batch
    S = shape.seq_len

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    if cfg.is_encoder_decoder:
        se, sd = S - S // 2, S // 2
        return {"frames": meta((B, se, cfg.d_model), dtype_of(cfg)),
                "tokens": meta((B, sd), torch.int32)}
    return {"tokens": meta((B, S), torch.int32)}


def batch_axes(cfg: ModelConfig) -> Dict[str, Any]:
    """Logical axes for batch trees (tokens/frames sharded on batch)."""
    if cfg.is_encoder_decoder:
        return {"frames": ("batch", "seq", "act_embed"),
                "tokens": ("batch", "seq")}
    return {"tokens": ("batch", "seq")}
