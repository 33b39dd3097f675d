"""Fault tolerance for pod-scale training — and fault *injection* for
the serving path.

Components (all exercised by tests with simulated failures):
  - ``TrainController``: checkpoint-every-N + automatic restart-from-latest
    on step failure; bounded retries; async save so the loop doesn't stall.
  - ``StragglerMonitor``: per-host step-time tracking; flags hosts slower
    than ``median * threshold`` over a sliding window — the mitigation hook
    triggers (a) redistribution (shrink data-parallel degree) or (b) host
    replacement, per policy.
  - ``ElasticScaler``: recompute data-parallel layout when the healthy host
    set changes, and reshard the latest checkpoint onto it (Mvec range
    reads; no full-checkpoint rewrite needed).
  - ``FaultInjector``: the serving-side chaos hook. Threaded through
    ``BackendPool.set_fault_injector`` it fires on every backend
    ``run_infer`` call — probabilistic or scripted ``InjectedFault``
    errors, stalls, and slow batches — so the admission layer's retry /
    breaker / fault-attribution machinery can be exercised by tests and
    ``benchmarks/bench_overload.py`` without a real flaky device.

Port of ``src/repro/training/fault.py`` (numpy and threading only).
``FaultInjector`` keeps numpy's ``default_rng(seed)``, so one seed fails
the same call indices in both packages.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.storage.checkpoint import CheckpointManager


class InjectedFault(RuntimeError):
    """A simulated backend failure (distinguishable from real errors so
    chaos tests can assert nothing *else* broke)."""


@dataclass
class FaultInjector:
    """Deterministic chaos for backend inference calls.

    Faults are decided per ``run_infer`` call (one trunk batch), indexed
    from 0 in call order, so a *retry* of a failed batch is a fresh call
    with a fresh roll — exactly the transient-failure model the
    batcher's retry/backoff path targets. ``scripted_errors`` pins
    specific call indices to fail regardless of ``error_rate`` (e.g.
    ``{0, 1, 2}`` trips a threshold-3 breaker deterministically).

    Thread-safe: lanes on different backends share one injector.
    """
    error_rate: float = 0.0          # P(call raises InjectedFault)
    scripted_errors: Sequence[int] = ()
    slow_rate: float = 0.0           # P(call sleeps slow_s first)
    slow_s: float = 0.0
    stall_rate: float = 0.0          # P(call wedges stall_s — long sleeps
    stall_s: float = 0.0             # exercise the stop-timeout path)
    kinds: Sequence[str] = ("embed", "predict")
    seed: int = 0
    armed: bool = True

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._lock = threading.Lock()
        self._scripted = set(int(i) for i in self.scripted_errors)
        self.calls = 0
        self.injected_errors = 0
        self.injected_slow = 0
        self.injected_stalls = 0
        self.error_calls: List[int] = []   # which call indices failed

    def arm(self) -> None:
        self.armed = True

    def disarm(self) -> None:
        """Stop injecting (counters keep their totals) — benches disarm
        for the fault-free parity leg without rebuilding the server."""
        self.armed = False

    def on_infer(self, spec, n_rows: int) -> None:
        """Called by the backend at the top of every ``run_infer``.
        May sleep (slow/stall) and may raise :class:`InjectedFault`."""
        if not self.armed or getattr(spec, "kind", None) not in self.kinds:
            return
        with self._lock:
            idx = self.calls
            self.calls += 1
            fail = idx in self._scripted \
                or (self.error_rate > 0
                    and self._rng.random() < self.error_rate)
            slow = (self.slow_rate > 0
                    and self._rng.random() < self.slow_rate)
            stall = (self.stall_rate > 0
                     and self._rng.random() < self.stall_rate)
            if slow:
                self.injected_slow += 1
            if stall:
                self.injected_stalls += 1
            if fail:
                self.injected_errors += 1
                self.error_calls.append(idx)
        if slow and self.slow_s > 0:
            time.sleep(self.slow_s)
        if stall and self.stall_s > 0:
            time.sleep(self.stall_s)
        if fail:
            raise InjectedFault(
                f"injected backend fault on infer call {idx} "
                f"({getattr(spec, 'kind', '?')}/"
                f"{getattr(spec, 'task', '?')}, {n_rows} rows)")


@dataclass
class StragglerMonitor:
    threshold: float = 2.0          # x median step time
    window: int = 8
    min_samples: int = 4
    _hist: Dict[int, deque] = field(default_factory=dict)

    def record(self, host: int, step_time: float) -> None:
        self._hist.setdefault(host, deque(maxlen=self.window)).append(step_time)

    def stragglers(self) -> List[int]:
        means = {h: float(np.mean(v)) for h, v in self._hist.items()
                 if len(v) >= self.min_samples}
        if len(means) < 2:
            return []
        med = float(np.median(list(means.values())))
        return [h for h, m in means.items() if m > self.threshold * med]


@dataclass
class ElasticScaler:
    """Tracks the healthy host set; yields dp layout + restore shards."""
    num_hosts: int
    failed: set = field(default_factory=set)

    @property
    def healthy(self) -> List[int]:
        return [h for h in range(self.num_hosts) if h not in self.failed]

    def fail(self, host: int) -> None:
        self.failed.add(host)

    def recover(self, host: int) -> None:
        self.failed.discard(host)

    def layout(self) -> Dict[str, Any]:
        n = len(self.healthy)
        return {"dp_degree": n, "hosts": self.healthy}

    def reshard_plan(self, ckpt: CheckpointManager, template) -> Dict[int, Any]:
        """Per-healthy-host restore slices from the latest checkpoint."""
        n = len(self.healthy)
        plan = {}
        for rank, host in enumerate(self.healthy):
            state, step = ckpt.restore(template, shard=rank, num_hosts=n)
            plan[host] = (state, step)
        return plan


class TrainController:
    """Checkpointed, restartable training loop."""

    def __init__(self, step_fn: Callable, ckpt: CheckpointManager,
                 *, ckpt_every: int = 10, max_restarts: int = 5,
                 monitor: Optional[StragglerMonitor] = None,
                 on_event: Optional[Callable[[str, dict], None]] = None):
        self.step_fn = step_fn
        self.ckpt = ckpt
        self.ckpt_every = ckpt_every
        self.max_restarts = max_restarts
        self.monitor = monitor or StragglerMonitor()
        self.events: List[Tuple[str, dict]] = []
        self._on_event = on_event

    def _event(self, kind: str, **info) -> None:
        self.events.append((kind, info))
        if self._on_event:
            self._on_event(kind, info)

    def run(self, state, num_steps: int, *, start_step: int = 0,
            num_shards: int = 1):
        """Run ``num_steps``; on exception restore latest checkpoint and
        continue. ``state`` is the full pytree the step_fn maps over."""
        step = start_step
        restarts = 0
        if self.ckpt.latest_step() is not None:
            state, step = self.ckpt.restore(state)
            self._event("resume", step=step)
        while step < num_steps:
            t0 = time.time()
            try:
                state = self.step_fn(state, step)
            except Exception as e:  # noqa: BLE001 - any step failure
                restarts += 1
                self._event("failure", step=step, error=repr(e),
                            restarts=restarts)
                if restarts > self.max_restarts:
                    raise RuntimeError(
                        f"exceeded {self.max_restarts} restarts") from e
                self.ckpt.wait()
                if self.ckpt.latest_step() is not None:
                    state, step = self.ckpt.restore(state)
                    self._event("restart", from_step=step)
                continue
            dt = time.time() - t0
            self.monitor.record(0, dt)
            step += 1
            if step % self.ckpt_every == 0:
                self.ckpt.save_async(step, state, num_shards=num_shards)
                self._event("checkpoint", step=step)
        self.ckpt.wait()
        return state, step
