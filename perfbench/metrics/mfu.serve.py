"""Model FLOPs of the calls completed in the window (a traced run's window follows its traced calls)
(``perfbench.flops.serve_call_flops``: 2 x the weights each token
multiplies by, the logits of the positions computed, attention at each
row's length and window) over its seconds, as a share of the bf16 peak."""


def read(ctx):
    w, f = ctx.window, ctx.flops
    if ctx.mix["kind"] != "serve":
        return None
    work = sum(f.serve_call_flops(ctx.cfg, r["rows"], r["length"],
                                  ctx.mix["gen_tokens"]) for r in w.rest)
    secs = w.rest[-1]["t1"] - w.start
    return 100.0 * work / secs / ctx.peaks.BF16_FLOPS_PER_S
