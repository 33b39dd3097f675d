"""Share of the traced window's wall time in which no operation ran on the
device: 1 - (union of the device's operation intervals) / (first span's
start to last span's end), in percent."""


def read(ctx):
    t = ctx.window.trace
    if t is None or ctx.mix["kind"] != "serve" or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
