"""Gemma 2B — dense, GeGLU, MQA, head_dim 256, tied embeddings [arXiv:2403.08295].

Port of ``src/repro/configs/gemma_2b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("gemma-2b")
def gemma_2b() -> ModelConfig:
    return ModelConfig(
        arch_id="gemma-2b",
        family="dense",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,
        d_ff=16384,
        vocab_size=256000,
        head_dim=256,
        activation="geglu",
        rmsnorm_one_plus=True,
        embed_scale=True,
        tie_embeddings=True,
        rope_theta=10000.0,
        # 8 Q heads < model-axis 16: replicate attention heads under TP,
        # shard d_ff / vocab instead (see DESIGN.md §6).
        shard_attn_heads=False,
        remat_policy="full",
        source="arXiv:2403.08295; hf",
    )
