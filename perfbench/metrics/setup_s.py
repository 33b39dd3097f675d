"""Seconds from the start of the process to the start of the window:
loading, building the kernels (first run only), making the weights and
warming every shape the cell uses."""


def read(ctx):
    return ctx.setup_s
