"""Tokens of the steps completed in the window over the window's seconds;
the window closes at the end of the step running when its seconds have
passed."""


def read(ctx):
    w = ctx.window
    if ctx.mix["kind"] != "train":
        return None
    return sum(r["tokens"] for r in w.rest) / (w.rest[-1]["t1"] - w.start)
