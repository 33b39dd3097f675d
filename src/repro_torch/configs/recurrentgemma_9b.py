"""RecurrentGemma 9B — Griffin: RG-LRU + local attention, pattern 2:1 [arXiv:2402.19427].

Port of ``src/repro/configs/recurrentgemma_9b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("recurrentgemma-9b")
def recurrentgemma_9b() -> ModelConfig:
    return ModelConfig(
        arch_id="recurrentgemma-9b",
        family="hybrid",
        num_layers=38,
        d_model=4096,
        num_heads=16,
        num_kv_heads=1,         # MQA on the local-attention blocks
        d_ff=12288,
        vocab_size=256000,
        head_dim=256,
        activation="geglu",
        rmsnorm_one_plus=True,
        embed_scale=True,
        tie_embeddings=True,
        block_pattern=("rglru", "rglru", "attn"),
        rglru_width=4096,
        local_attn_window=2048,
        remat_policy="full",
        seq_parallel=True,  # §Perf: SP residual cuts the memory term 27%
        source="arXiv:2402.19427",
    )
