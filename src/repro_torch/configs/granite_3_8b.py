"""Granite-3 8B — dense GQA with muP-style scalars [hf:ibm-granite].

Port of ``src/repro/configs/granite_3_8b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("granite-3-8b")
def granite_3_8b() -> ModelConfig:
    return ModelConfig(
        arch_id="granite-3-8b",
        family="dense",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        d_ff=12800,
        vocab_size=49155,
        head_dim=128,
        activation="swiglu",
        rope_theta=10000.0,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        logits_scaling=16.0,
        tie_embeddings=True,
        remat_policy="full",
        source="hf:ibm-granite/granite-3.0-8b-base",
    )
