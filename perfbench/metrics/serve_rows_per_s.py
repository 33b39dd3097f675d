"""Rows (requests) completed in the window over the window's seconds. The
window closes at the end of the generate call running when its seconds
have passed, so no call is counted in part."""


def read(ctx):
    w = ctx.window
    if ctx.mix["kind"] != "serve":
        return None
    return sum(r["rows"] for r in w.rest) / (w.rest[-1]["t1"] - w.start)
