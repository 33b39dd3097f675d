"""Whisper-medium — encoder-decoder backbone; conv frontend STUBBED [arXiv:2212.04356].

``input_specs()`` provides precomputed frame embeddings (batch, frames,
d_model) for the encoder; the decoder consumes token ids. The assigned
seq_len is the total context budget, split (enc, dec) = (seq/2, seq/2).

Port of ``src/repro/configs/whisper_medium.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("whisper-medium")
def whisper_medium() -> ModelConfig:
    return ModelConfig(
        arch_id="whisper-medium",
        family="audio",
        num_layers=24,            # decoder layers
        num_encoder_layers=24,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        d_ff=4096,
        vocab_size=51865,
        head_dim=64,
        activation="geglu",       # backbone uses gated MLP in our zoo
        norm="layernorm",
        is_encoder_decoder=True,
        frontend="audio_frames",
        rope_theta=10000.0,
        remat_policy="full",
        source="arXiv:2212.04356",
    )
