"""The training forward's ``flash_attention`` share of its roofline in the
traced step: the sum over its launches (the wrapper's launch count: each
micro-batch's forward and remat's recompute, one a layer) of the least
time a micro-batch's causal call allows (the arch file's ``flash_call``:
bytes over the HBM bandwidth or operations over the bf16 peak, the
larger) over the device time of its kernels, by the names below."""

KERNELS = ("flash_mma_kernel", "flash_fma_kernel")


def read(ctx):
    w, f, mix = ctx.window, ctx.flops, ctx.mix
    if w.trace is None or mix["kind"] != "train":
        return None
    secs = ctx.trace_seconds(KERNELS, KERNELS, "flash_attention")
    if not secs:
        return None
    launched = sum(s["launches"].get("flash_attention", 0)
                   for s in w.trace["spans"])
    rows = mix["global_batch"] // mix["accum"]
    bound = launched * f.bound_seconds(*f.flash_call(ctx.cfg, rows,
                                                     mix["seq_len"]))
    return 100.0 * bound / secs
