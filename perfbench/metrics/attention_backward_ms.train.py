"""Milliseconds a traced step spends in the attention's backward (the
program's ``flash_attention.backward`` spans, ``FlashAttentionFunction
.backward``, inside a ``train.backward``), by the device's clock
(``perfbench.spans``)."""
from perfbench import spans


def read(ctx):
    return spans.ms_per_step(ctx, ("flash_attention.backward",),
                             parent="train.backward")
