"""Model FLOPs of the steps completed in the window (a traced run's window follows its traced calls)
(``perfbench.flops.train_step_flops``: 6 x the weights each token
multiplies by x tokens, plus attention forward and backward at the causal
pairs) over its seconds, as a share of the bf16 peak."""


def read(ctx):
    w, f, mix = ctx.window, ctx.flops, ctx.mix
    if mix["kind"] != "train":
        return None
    work = len(w.rest) * f.train_step_flops(ctx.cfg, mix["global_batch"],
                                            mix["seq_len"])
    secs = w.rest[-1]["t1"] - w.start
    return 100.0 * work / secs / ctx.peaks.BF16_FLOPS_PER_S
