"""Milliseconds a traced step spends in the forward of its micro-batches
(the program's ``train.forward`` spans: the tracked leaves and
``model.loss``), by the device's clock (``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("train.forward",))
