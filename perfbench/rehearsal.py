"""The CPU rehearsal of a cell, for the benchmark's tests only: the same
harness path at smoke width (a few layers, narrow widths, short prompts),
on the CPU, where every kernel wrapper runs its plain version. Nothing of
it is a measurement of the card.

The program runs in float32 there, so a sound run agrees with the float32
reference to rounding and every compared number is held to ``LIMIT``; the
card's limits are set for bfloat16 at full width. A fault, or the float8
control, reads far above it."""
from __future__ import annotations

import copy
from types import SimpleNamespace

SMOKE = {"d_model": 64, "num_heads": 4, "head_dim": 16, "d_ff": 128,
         "vocab_size": 512, "dtype": "float32", "param_dtype": "float32"}
LIMIT = 1e-3


def shrink(c: SimpleNamespace) -> SimpleNamespace:
    cfg = dict(c.cfg, **SMOKE)
    cfg["num_layers"] = 2
    cfg["num_kv_heads"] = min(c.cfg["num_kv_heads"], 2)
    if cfg.get("sliding_window"):
        cfg["sliding_window"] = 48      # shorter than the longest prompt
    if cfg.get("moe"):
        cfg["moe"] = dict(cfg["moe"], num_experts=8, top_k=2,
                          d_ff_expert=32)
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
