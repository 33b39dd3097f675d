"""The 95th percentile, over every row of the window, of the time from
its call being handed to ``ServingEngine.generate`` to its tokens being
back on the host (numpy's linear interpolation)."""
import numpy as np


def read(ctx):
    if ctx.mix["kind"] != "serve":
        return None
    lat = np.concatenate([np.full(r["rows"], r["t1"] - r["t0"])
                          for r in ctx.window.rest])
    return float(np.percentile(lat, 95)) * 1e3
