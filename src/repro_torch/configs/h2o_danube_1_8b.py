"""H2O-Danube 1.8B — llama/mistral mix with sliding-window attention [arXiv:2401.16818].

Port of ``src/repro/configs/h2o_danube_1_8b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("h2o-danube-1.8b")
def h2o_danube_1_8b() -> ModelConfig:
    return ModelConfig(
        arch_id="h2o-danube-1.8b",
        family="dense",
        num_layers=24,
        d_model=2560,
        num_heads=32,
        num_kv_heads=8,
        d_ff=6912,
        vocab_size=32000,
        head_dim=80,
        activation="swiglu",
        sliding_window=4096,
        rope_theta=10000.0,
        remat_policy="full",
        source="arXiv:2401.16818; hf",
    )
