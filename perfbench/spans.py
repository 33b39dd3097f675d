"""The program's own spans (``repro_torch.tracing``) in the traced steps of
a train window: those of the given names that opened and closed between
the first traced step's start and the last one's end, their device
milliseconds summed (host milliseconds where a span has no device time,
as on the CPU), over the number of traced steps. The spans are recorded
only while the profiler runs, so only the traced steps have them."""
from __future__ import annotations

from typing import Optional, Sequence


def ms_per_step(ctx, names: Sequence[str],
                parent: Optional[str] = None) -> Optional[float]:
    """None for a serve mix, a window with no traced step, a program
    without spans, or when no span of ``names`` (under ``parent``, where
    given) lies in the traced steps."""
    traced = ctx.window.traced
    if ctx.mix["kind"] != "train" or not traced:
        return None
    try:
        from repro_torch.tracing import spans
    except ImportError:
        return None
    lo, hi = traced[0]["t0"], traced[-1]["t1"]
    got = [s for s in spans() if s.name in names and lo <= s.t0
           and s.t1 <= hi and (parent is None or s.parent == parent)]
    if not got:
        return None
    ms = [s.device_ms if s.device_ms is not None else (s.t1 - s.t0) * 1e3
          for s in got]
    return sum(ms) / len(traced)
