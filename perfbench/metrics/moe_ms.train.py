"""Milliseconds a traced step spends in the MoE blocks (the program's
``moe.route``, ``moe.experts`` and ``moe.shared`` spans: router scores,
choice and gates, the held experts' gather, products and combine, the
shared expert; forward and remat's recompute), by the device's clock
(``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("moe.route", "moe.experts",
                                   "moe.shared"))
