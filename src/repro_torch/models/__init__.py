"""The LM zoo: dense, MoE, SSM and hybrid decoder-only LMs. Port of
``src/repro/models/`` (enc-dec still to port)."""
from repro_torch.models.api import build_model, make_batch

__all__ = ["build_model", "make_batch"]
