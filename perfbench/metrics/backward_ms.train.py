"""Milliseconds a traced step spends in the backward of its micro-batches
(the program's ``train.backward`` spans: ``torch.autograd.grad``, so the
remat recompute and every backward), by the device's clock
(``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("train.backward",))
