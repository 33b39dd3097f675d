"""The LM zoo: dense, MoE, SSM and hybrid decoder-only LMs and the
encoder-decoder backbone. Port of ``src/repro/models/``."""
from repro_torch.models.api import (batch_axes, build_model, input_specs,
                                    make_batch)

__all__ = ["batch_axes", "build_model", "input_specs", "make_batch"]
