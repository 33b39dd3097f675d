"""Spans inside the port: where a step's time goes, phase by phase.

``with span("train.forward", step=n, micro=i): ...`` marks a stretch of
the program. While no ``torch.profiler`` is recording, ``span`` returns
one shared no-op context: a flag read, nothing allocated. While one is
recording (the process-wide ``torch.autograd.profiler
._is_profiler_enabled``: the profiler's own thread-local state does not
reach every thread that may open a span), a span

- enters ``torch._C._profiler._RecordFunctionFast("repro_torch/<name>")``,
  so it shows in the profiler's host trace, on the clock of the device
  events. It is a plain function-scope op: ``record_function`` is a user
  annotation, which the profiler also draws on the device timeline over
  the kernels launched inside it, as if it were device work;
- stamps ``time.perf_counter()`` at enter and exit;
- where CUDA is initialised, records a timing ``torch.cuda.Event`` on the
  current stream at enter and exit, so its device time can be read after
  the work has run (``Span.device_ms``, which waits for the exit event).

A finished span is a :class:`Span` in an in-memory store of at most
``KEEP`` records (the oldest drop first); :func:`spans` lists them. A
span's ``parent`` is the innermost span open on its own thread or, where
that thread has none, the innermost span open that was given a ``step``
(a phase of the step): on the card autograd runs the backward on a
thread of its own, and this puts a kernel's backward span under the
``train.backward`` that waits for it. ``step`` and ``micro`` default to
the parent's.

Counters go the same way: ``count("moe.dropped", n)`` keeps the device
scalar ``n`` with the host time while a profiler records, and does nothing
otherwise; the caller asks
:func:`recording` before it computes ``n``, so an unprofiled run pays
neither the arithmetic nor a host sync. :func:`counts` lists them, each
read (``Count.value``, a sync) only when asked.
"""
from __future__ import annotations

import collections
import contextlib
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Union

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

PREFIX = "repro_torch/"
KEEP = 1 << 16


@dataclass
class Count:
    """A counted amount: ``name``, the host time it was counted at, and
    ``value``, read from the device when first asked."""
    name: str
    t: float
    _value: Union[torch.Tensor, float]

    @property
    def value(self) -> float:
        if isinstance(self._value, torch.Tensor):
            self._value = float(self._value)
        return self._value


@dataclass
class Span:
    """A finished span. ``t0`` / ``t1``: ``time.perf_counter()`` at enter
    and exit. ``device_ms``: the device time between the enter and exit
    events on the stream current at each, None where CUDA was not
    initialised."""
    name: str
    step: Optional[int]
    micro: Optional[int]
    parent: Optional[str]
    t0: float
    t1: float
    _events: Optional[tuple] = None
    _device_ms: Optional[float] = None

    @property
    def device_ms(self) -> Optional[float]:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._device_ms = start.elapsed_time(end)
            self._events = None
        return self._device_ms


class Store:
    """Finished spans (at most ``keep``), each thread's open spans, and
    the innermost open phase span of any thread."""

    def __init__(self, keep: int = KEEP):
        self.done: collections.deque = collections.deque(maxlen=keep)
        self.counted: collections.deque = collections.deque(maxlen=keep)
        self.local = threading.local()
        self.phase: Optional["_Open"] = None


STORE = Store()


_OFF = contextlib.nullcontext()


class _Open:
    """A span while it is open."""

    def __init__(self, store: Store, name: str, step: Optional[int],
                 micro: Optional[int]):
        self.store, self.name, self.step, self.micro = store, name, step, \
            micro
        self.is_phase = step is not None

    def __enter__(self):
        store = self.store
        stack = getattr(store.local, "stack", None)
        if stack is None:
            stack = store.local.stack = []
        up = stack[-1] if stack else store.phase
        self.parent = up.name if up is not None else None
        if up is not None:
            self.step = up.step if self.step is None else self.step
            self.micro = up.micro if self.micro is None else self.micro
        self.outer_phase = store.phase
        if self.is_phase:
            store.phase = self
        stack.append(self)
        self.rf = _RecordFunctionFast(PREFIX + self.name)
        self.rf.__enter__()
        self.events = None
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        if self.events is not None:
            self.events[1].record()
        self.rf.__exit__(*exc)
        store = self.store
        store.local.stack.pop()
        if self.is_phase:
            store.phase = self.outer_phase
        store.done.append(Span(self.name, self.step, self.micro, self.parent,
                               self.t0, t1, self.events))
        return False


def span(name: str, step: Optional[int] = None, micro: Optional[int] = None):
    """A context that records ``name`` while a profiler records (see the
    module docstring), else a shared no-op."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Open(STORE, name, step, micro)


def spans() -> List[Span]:
    """The finished spans, oldest first."""
    return list(STORE.done)


def recording() -> bool:
    """Whether a profiler records, and so spans and counts are kept."""
    return bool(_profiler._is_profiler_enabled)


def count(name: str, value: Union[torch.Tensor, float]) -> None:
    """Keep ``value`` under ``name`` while a profiler records (see the
    module docstring); else nothing."""
    if not _profiler._is_profiler_enabled:
        return
    if isinstance(value, torch.Tensor):
        value = value.detach()
    STORE.counted.append(Count(name, time.perf_counter(), value))


def counts() -> List[Count]:
    """The counts kept, oldest first."""
    return list(STORE.counted)
