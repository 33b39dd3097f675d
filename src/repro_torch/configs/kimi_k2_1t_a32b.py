"""Kimi K2 — trillion-param MoE, 384 experts top-8 [arXiv:2501.kimi2, paper table].

Port of ``src/repro/configs/kimi_k2_1t_a32b.py``.
"""
from repro_torch.configs.base import ModelConfig, MoEConfig, register


@register("kimi-k2-1t-a32b")
def kimi_k2_1t_a32b() -> ModelConfig:
    return ModelConfig(
        arch_id="kimi-k2-1t-a32b",
        family="moe",
        num_layers=61,
        d_model=7168,
        num_heads=64,
        num_kv_heads=8,
        d_ff=2048,                # per-expert ff (spec)
        vocab_size=163840,
        head_dim=112,             # 7168 / 64 (spec-faithful; MXU pads to 128)
        activation="swiglu",
        moe=MoEConfig(num_experts=384, top_k=8, d_ff_expert=2048,
                      impl="batched"),
        remat_policy="full",
        grad_accum=4,   # §Perf: accum 8->4 cuts ZeRO-3 regather traffic 31%
        source="arXiv:2501.kimi2 (paper-table)",
    )
