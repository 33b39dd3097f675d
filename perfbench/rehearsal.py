"""The CPU rehearsal of a cell, for the benchmark's tests only: the same
harness path at smoke width (the cell's architecture's cut: a few layers,
narrow widths), with short prompts, on the CPU, where every kernel wrapper
runs its plain version. Nothing of it is a measurement of the card.

The program runs in float32 there, so a sound run agrees with the float32
reference to rounding and every compared number is held to ``LIMIT``; the
card's limits are set for bfloat16 at full width. A fault, or the float8
control, reads far above it."""
from __future__ import annotations

import copy
from types import SimpleNamespace

LIMIT = 1e-3


def shrink(c: SimpleNamespace) -> SimpleNamespace:
    cfg = dict(c.arch.smoke(c.cfg), dtype="float32", param_dtype="float32")
    mix = copy.deepcopy(c.mix)
    if mix["kind"] == "serve":
        mix["slots"] = 16
        mix["block"] = [[max(8, n // 64), k] for n, k in mix["block"]]
        mix["check_calls"] = [max(8, n // 64) for n in mix["check_calls"]]
        mix["gen_tokens"] = min(mix["gen_tokens"], 6)
        mix["max_len"] = max(n for n, _ in mix["block"]) + mix["gen_tokens"]
        mix["trace_calls"] = min(mix["trace_calls"], 3)
    else:
        mix.update(global_batch=4, seq_len=64, accum=2)
    limits = {k: LIMIT for k in c.limits}
    return SimpleNamespace(**dict(vars(c), cfg=cfg, mix=mix, limits=limits))
