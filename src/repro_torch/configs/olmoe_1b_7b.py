"""OLMoE 1B-7B — 64-expert top-8 MoE [arXiv:2409.02060].

Port of ``src/repro/configs/olmoe_1b_7b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("olmoe-1b-7b")
def olmoe_1b_7b() -> ModelConfig:
    return ModelConfig(
        arch_id="olmoe-1b-7b",
        family="moe",
        num_layers=16,
        d_model=2048,
        num_heads=16,
        num_kv_heads=16,
        d_ff=1024,                # per-expert ff (spec)
        vocab_size=50304,
        head_dim=128,
        activation="swiglu",
        qk_norm=True,             # OLMoE uses QK-norm
        moe=MoEConfig(num_experts=64, top_k=8, d_ff_expert=1024,
                      impl="batched"),
        remat_policy="full",
        source="arXiv:2409.02060; hf",
    )
