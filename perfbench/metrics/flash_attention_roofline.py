"""``flash_attention``'s share of its roofline in the traced calls: the
sum over its calls of the least time their shapes allow
(``perfbench.flops.flash_call``: bytes over the HBM bandwidth or
operations over the bf16 peak, the larger) over the device time of its
kernels, by the names below. One call a layer a prefill."""

KERNELS = ("flash_mma_kernel", "flash_fma_kernel")


def read(ctx):
    w, f = ctx.window, ctx.flops
    if w.trace is None or ctx.mix["kind"] != "serve":
        return None
    secs = ctx.trace_seconds(KERNELS, KERNELS, "flash_attention")
    if not secs:
        return None
    bound = sum(ctx.cfg["num_layers"] * f.bound_seconds(
        *f.flash_call(ctx.cfg, r["rows"], r["length"])) for r in w.traced)
    return 100.0 * bound / secs
