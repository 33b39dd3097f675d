"""Llama-3 405B — dense GQA transformer [arXiv:2407.21783].

Port of ``src/repro/configs/llama3_405b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("llama3-405b")
def llama3_405b() -> ModelConfig:
    return ModelConfig(
        arch_id="llama3-405b",
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        d_ff=53248,
        vocab_size=128256,
        head_dim=128,
        activation="swiglu",
        rope_theta=500000.0,
        remat_policy="full",
        grad_accum=16,
        seq_parallel=True,  # §Perf: -20% memory term, temp 63->19 GB
        source="arXiv:2407.21783",
    )
