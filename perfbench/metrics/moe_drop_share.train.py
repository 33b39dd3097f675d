"""Share of the token copies routed to the card's held experts that their
capacity dropped, in the traced steps: the program's ``moe.dropped`` over
its ``moe.routed`` counts (``repro_torch.tracing.count``), in percent.
None where the program keeps no such counts."""


def read(ctx):
    traced = ctx.window.traced
    if ctx.mix["kind"] != "train" or not traced:
        return None
    try:
        from repro_torch.tracing import counts
    except ImportError:
        return None
    lo, hi = traced[0]["t0"], traced[-1]["t1"]
    total = {"moe.routed": 0.0, "moe.dropped": 0.0}
    for c in counts():
        if c.name in total and lo <= c.t <= hi:
            total[c.name] += c.value
    if not total["moe.routed"]:
        return None
    return 100.0 * total["moe.dropped"] / total["moe.routed"]
