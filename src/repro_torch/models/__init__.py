"""The LM zoo (dense path). Port of ``src/repro/models/``."""
from repro_torch.models.api import build_model, make_batch

__all__ = ["build_model", "make_batch"]
