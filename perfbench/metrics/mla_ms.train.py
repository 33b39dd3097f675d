"""Milliseconds a traced step spends in latent attention up to its
attention call (the program's ``mla.latent`` spans: the projections, the
latent norm, RoPE and the concatenation, in the forward and in remat's
recompute), by the device's clock (``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("mla.latent",))
