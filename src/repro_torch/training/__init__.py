"""Step functions. Port of ``src/repro/training/`` (prefill and serve steps
only; the optimizer, train step and fault tooling wait for the training
slice)."""
from repro_torch.training.step import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
