"""Model and shape configs. Port of ``src/repro/configs/`` (copied: pure
data, one module per architecture)."""
from repro_torch.configs.base import (
    ALL_SHAPES,
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    MoEConfig,
    ShapeConfig,
    SSMConfig,
    get_config,
    list_archs,
    register,
    shapes_for,
    smoke_config,
)

__all__ = [
    "ALL_SHAPES", "DECODE_32K", "LONG_500K", "PREFILL_32K", "SHAPES",
    "TRAIN_4K", "ModelConfig", "MoEConfig", "ShapeConfig", "SSMConfig",
    "get_config", "list_archs", "register", "shapes_for", "smoke_config",
]
