"""One traced run of the benchmark's ``danube-train`` cell (card only), with
its profile kept, to hold the program's spans (``repro_torch.tracing``)
against the profiler's own view of the same traced step:

    python3 scripts/torch_train_span_probe.py --seed 7 [--seconds 30]

It prints, as JSON on its last line: the harness's result; the spans of
the traced step, counted by name and parent, with their device and host
milliseconds; by span, the device events whose launching op has
``repro_torch/<span>`` among its parents in the profile (count, summed
ms, ms of their union, and the summed ms of the ten largest kernel names);
the names of any device events that carry a ``repro_torch/`` name (there
should be none: the spans are host ops only); and the backward kernel's
launches in the traced step (``flash_attention.backward_launch_count``).
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
from repro_torch.kernels import flash_attention  # noqa: E402


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
                                                   k.end_ns() / 1e3,
                                                   k.name()))
    under = defaultdict(list)
    for e in prof.events():
        if not e.kernels:
            continue
        up = e
        while up is not None:
            if up.name.startswith(tracing.PREFIX):
                under[up.name] += dev[e.id]
            up = up.cpu_parent
    out = {}
    for n, ev in under.items():
        names = defaultdict(float)
        for a, b, name in ev:
            names[name[:80]] += (b - a) / 1e3
        top = sorted(names.items(), key=lambda kv: -kv[1])[:10]
        out[n] = {"events": len(ev),
                  "sum_ms": sum(b - a for a, b, _ in ev) / 1e3,
                  "union_ms": sum(b - a for a, b in trace.merged(
                      [(a, b) for a, b, _ in ev], -1e30, 1e30)) / 1e3,
                  "kernels_ms": dict(top)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=30.0)
    args = ap.parse_args()
    kept = []

    class Kept(trace.Profiled):
        def __enter__(self):
            kept.append(self)
            self.launches = flash_attention.backward_launch_count
            return super().__enter__()

        def __exit__(self, *exc):
            self.launches = (flash_attention.backward_launch_count
                             - self.launches)
            return super().__exit__(*exc)

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
                      "span_names_on_device": on_device,
                      "backward_launches": kept[0].launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
