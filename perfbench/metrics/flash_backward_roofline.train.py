"""The attention backward's share of its roofline in the traced step: the
sum over the program's ``flash_attention.backward`` spans (one a layer a
micro-batch, inside ``train.backward``) of the least time a micro-batch's
causal backward allows (the arch file's ``flash_backward_call``: its five
products over the bf16 peak, or its bytes over the HBM bandwidth, the
larger) over those spans' device milliseconds. None where the arch file
has no such count or the program no such span."""


def read(ctx):
    w, mix = ctx.window, ctx.mix
    traced = w.traced
    if mix["kind"] != "train" or not traced:
        return None
    try:
        from repro_torch.tracing import spans
    except ImportError:
        return None
    lo, hi = traced[0]["t0"], traced[-1]["t1"]
    got = [s for s in spans() if s.name == "flash_attention.backward"
           and s.parent == "train.backward" and lo <= s.t0 and s.t1 <= hi]
    if not got:
        return None
    ms = sum(s.device_ms if s.device_ms is not None else (s.t1 - s.t0) * 1e3
             for s in got)
    rows = mix["global_batch"] // mix["accum"]
    f = ctx.flops
    bound = len(got) * f.bound_seconds(*f.flash_backward_call(
        ctx.cfg, rows, mix["seq_len"]))
    return 100.0 * bound * 1e3 / ms
