"""One traced run of the benchmark's ``danube-train`` cell (card only), with
its profile kept, to hold the program's spans (``repro_torch.tracing``)
against the profiler's own view of the same traced step:

    python3 scripts/torch_train_span_probe.py --seed 7 [--seconds 30]

It prints, as JSON on its last line: the harness's result; the spans of
the traced step, counted by name and parent, with their device and host
milliseconds; by span, the device events whose launching op has
``repro_torch/<span>`` among its parents in the profile (count, summed
ms, ms of their union); and the names of any device events that carry a
``repro_torch/`` name (there should be none: the spans are host ops
only).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from pathlib import Path

STARTED = time.perf_counter()
ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, trace  # noqa: E402
from repro_torch import tracing  # noqa: E402


def kernels_under_spans(prof) -> dict:
    """By ``repro_torch/`` span: the device events whose launching op has
    the span among its parents, as their summed ms and as the ms of the
    union of their intervals (the two differ where events overlap). An
    op's device events are those the profiler links to it (``kernels``),
    found by the same correlation id in the raw results."""
    from torch.autograd import DeviceType
    dev = defaultdict(list)
    for k in prof.profiler.kineto_results.events():
        if k.device_type() == DeviceType.CUDA:
            dev[k.linked_correlation_id()].append((k.start_ns() / 1e3,
                                                   k.end_ns() / 1e3))
    under = defaultdict(list)
    for e in prof.events():
        if not e.kernels:
            continue
        up = e
        while up is not None:
            if up.name.startswith(tracing.PREFIX):
                under[up.name] += dev[e.id]
            up = up.cpu_parent
    return {n: {"events": len(iv),
                "sum_ms": sum(b - a for a, b in iv) / 1e3,
                "union_ms": sum(b - a for a, b in
                                trace.merged(iv, -1e30, 1e30)) / 1e3}
            for n, iv in under.items()}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    kept = []

    class Kept(trace.Profiled):
        def __enter__(self):
            kept.append(self)
            return super().__enter__()

    harness.Profiled = Kept
    log = lambda m: print(m, file=sys.stderr, flush=True)  # noqa: E731
    result, _ = harness.run("danube-train", args.seed, args.seconds, True,
                            started=STARTED, log=log)
    prof = kept[0].prof
    by = defaultdict(lambda: {"count": 0, "device_ms": 0.0, "host_ms": 0.0})
    for s in tracing.spans():          # recorded in the traced step alone
        b = by[f"{s.name} < {s.parent}"]
        b["count"] += 1
        b["device_ms"] += s.device_ms or 0.0
        b["host_ms"] += (s.t1 - s.t0) * 1e3
    from torch.autograd import DeviceType
    on_device = sorted({e.name for e in prof.events()
                        if e.device_type == DeviceType.CUDA
                        and e.name.startswith(tracing.PREFIX)})
    print(json.dumps({"result": result, "spans": by,
                      "kernels_under_spans_ms": kernels_under_spans(prof),
                      "span_names_on_device": on_device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
