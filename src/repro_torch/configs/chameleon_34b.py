"""Chameleon 34B — early-fusion VLM token backbone with QK-norm [arXiv:2405.09818].

The modality frontend is a STUB: ``input_specs()`` provides mixed
text/VQ-image token ids directly (vocab 65536 includes image codes).

Port of ``src/repro/configs/chameleon_34b.py``.
"""
from repro_torch.configs.base import ModelConfig, register


@register("chameleon-34b")
def chameleon_34b() -> ModelConfig:
    return ModelConfig(
        arch_id="chameleon-34b",
        family="vlm",
        num_layers=48,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        d_ff=22016,
        vocab_size=65536,
        head_dim=128,
        activation="swiglu",
        qk_norm=True,
        frontend="vq_tokens",
        remat_policy="full",
        grad_accum=4,
        source="arXiv:2405.09818",
    )
