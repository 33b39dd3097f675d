"""Mamba-2 370M — attention-free SSD state-space model [arXiv:2405.21060].

Port of ``src/repro/configs/mamba2_370m.py``.
"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register


@register("mamba2-370m")
def mamba2_370m() -> ModelConfig:
    return ModelConfig(
        arch_id="mamba2-370m",
        family="ssm",
        num_layers=48,
        d_model=1024,
        num_heads=32,          # SSD heads: d_inner / head_dim = 2048/64
        num_kv_heads=32,
        d_ff=0,                # mamba blocks have no separate MLP
        vocab_size=50280,
        ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, conv_dim=4,
                      chunk=256, n_groups=1),
        remat_policy="full",
        source="arXiv:2405.21060",
    )
