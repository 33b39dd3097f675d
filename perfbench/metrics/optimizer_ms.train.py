"""Milliseconds a traced step spends summing its micro-batches' gradients
and in the AdamW update (the program's ``train.accumulate`` and
``train.update`` spans), by the device's clock (``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("train.accumulate", "train.update"))
