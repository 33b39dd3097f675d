"""The traced part of a ``--trace 1`` window: ``torch.profiler`` over
whole calls or steps, each inside a span of the harness's own
(``record_function("perfbench/<label>")``), reduced to what the per-layer
readers and the result's ``breakdown`` need.

Device time comes from the device's own events only (kernels, copies,
sets); a CPU op's device time would count its kernels again. The
profiler has lost kernel events on this card, so the kernel wrappers'
launch counts of each traced call travel with the trace and each reader
checks its kernel's event count against them, call by call
(``kernel_seconds``).
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Sequence, Tuple

SPAN = "perfbench/"
LOST_AT_MOST = 0.10         # a kernel's events a trace may lose and be read


class Profiled:
    """Context manager: profile the calls made inside it; ``summary`` after
    it closes."""

    def __init__(self, device):
        import torch
        from torch.profiler import ProfilerActivity, profile
        self.torch, self.device = torch, device
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)

    def span(self, label: str):
        return self.torch.profiler.record_function(SPAN + label)

    def __enter__(self):
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)
            time.sleep(0.05)            # let the last records land
        return self.prof.__exit__(*exc)

    def summary(self, launches: Sequence[Dict[str, int]]) -> dict:
        """``launches``: the wrappers' launch counts of each span, in the
        order the spans ran."""
        from torch.autograd import DeviceType
        dev, spans, tops = [], [], []
        for e in self.prof.events():
            t0, t1 = e.time_range.start, e.time_range.end
            if e.name.startswith(SPAN):
                # a span shows on the device too, as an annotation
                if e.device_type != DeviceType.CUDA:
                    spans.append((t0, t1, e.name[len(SPAN):]))
            elif e.device_type == DeviceType.CUDA:
                dev.append((t0, t1, e.name))
            elif e.cpu_parent is not None and \
                    e.cpu_parent.name.startswith(SPAN):
                tops.append((t0, t1, e.name))
        return reduce(dev, sorted(spans), sorted(tops), launches)


def merged(intervals: Sequence[Tuple[float, float]], lo: float,
           hi: float) -> List[Tuple[float, float]]:
    """The union of ``intervals`` clipped to ``[lo, hi]``, sorted."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


class _Index:
    """Sorted, disjoint labelled intervals, looked up by a time."""

    def __init__(self, items: Sequence[Tuple[float, float, str]]):
        self.items = items
        self.starts = [a for a, _, _ in items]

    def at(self, t: float) -> Optional[str]:
        i = bisect.bisect_right(self.starts, t) - 1
        if i >= 0 and self.items[i][0] <= t <= self.items[i][1]:
            return self.items[i][2]
        return None


def reduce(dev, spans, tops, launches: Sequence[Dict[str, int]]) -> dict:
    """Times in µs in, seconds out: the traced window (first span's start
    to last span's end), the device's busy time in it (the union of its
    operations), time and count by kernel name, in all and in each span
    (a device event goes to the last span that started before it: each
    traced call ends on the host after its device work), the ten costliest
    device operations and the ten idle totals by what the host was
    doing."""
    if not spans:
        raise RuntimeError("the trace holds no span of the harness")
    if len(launches) != len(spans):
        raise RuntimeError(f"{len(spans)} spans for {len(launches)} "
                           "launch counts")
    lo, hi = spans[0][0], max(b for _, b, _ in spans)
    busy = merged([(a, b) for a, b, _ in dev], lo, hi)
    starts = [a for a, _, _ in spans]
    kernels: Dict[str, List[float]] = {}
    by_span: List[Dict[str, List[float]]] = [{} for _ in spans]
    for a, b, name in dev:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        for into in (kernels, by_span[i]):
            k = into.setdefault(name, [0.0, 0])
            k[0] += (b - a) / 1e6
            k[1] += 1
    gaps: Dict[str, float] = {}
    span_at, top_at = _Index(spans).at, _Index(tops).at
    edges = [lo] + [t for ab in busy for t in ab] + [hi]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            label = (f"{span_at(a) or 'between spans'}: "
                     f"{top_at(a) or 'no op of the span'}")
            gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:10]
    return {
        "window_s": (hi - lo) / 1e6,
        "busy_s": sum(b - a for a, b in busy) / 1e6,
        "kernels": kernels,
        "spans": [{"kernels": k, "launches": dict(n)}
                  for k, n in zip(by_span, launches)],
        "device_ops": [[name[:120], s] for name, (s, _) in top],
        "idle_gaps": [[k[:120], s] for k, s in
                      sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
    }


def kernel_seconds(trace: dict, patterns: Sequence[str], per_launch:
                   Sequence[str], wrapper: str, log) -> Optional[float]:
    """Device seconds of the kernels whose names hold any of ``patterns``.
    ``per_launch`` names the kernel each launch of the kernel wrapper
    ``wrapper`` runs once. Span by span, where the trace holds fewer of its
    events than the span's launches, the span's time is scaled up to its
    launches by the span's own events (one call runs one shape); None when
    a span holds more events than launches, or none of them, or when more
    than ``LOST_AT_MOST`` of all were lost, or when there is none to
    read."""
    total, seen, launched = 0.0, 0, 0
    for span in trace["spans"]:
        secs, n = 0.0, 0
        for name, (s, k) in span["kernels"].items():
            if any(p in name for p in patterns):
                secs += s
            if any(p in name for p in per_launch):
                n += k
        want = span["launches"].get(wrapper, 0)
        if n > want or (want and not n):
            log(f"trace: a span holds {n} events of {per_launch} for "
                f"{want} launches")
            return None
        total += secs * want / n if n else secs
        seen, launched = seen + n, launched + want
    if launched == 0:
        return None
    if seen < launched:
        log(f"trace: {seen} events of {per_launch} for {launched} launches")
        if (launched - seen) / launched > LOST_AT_MOST:
            return None
    return total
