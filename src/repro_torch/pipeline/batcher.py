"""Batch inference as a window function (paper §5.2 'Batch Inferences').

``WindowBatcher`` reproduces the kernel-side mechanics the paper adds to
PostgreSQL's window function: (1) window data aggregation — rows are
copied into an intermediate state until the window fills; (2) batch
inference execution — the filled window is converted to tensors in
parallel and run as one batch; (3) cleanup + result caching — results are
re-associated with row ids and raw rows released.

``ContinuousBatcher`` is the serving-engine version: an admission queue
with cost-model-selected batch size and waiting-time bound. It runs
either as a one-shot loop (``run(total)``) or as a long-lived service
(``start()`` / ``submit()`` / ``result()`` / ``stop()``) whose worker
thread coalesces queued requests into batches and publishes results
through a condition variable — the serving-path sibling of the
window-function batcher.

With an :class:`~repro_torch.pipeline.admission.AdmissionPolicy` attached the
batcher is the production-hardened serving lane: priority-class queues
with depth caps and backpressure (typed ``Rejected``), weighted lane
draining, deadline-aware dynamic Eq. 11 row budgets
(:class:`~repro_torch.pipeline.cost.DynamicBudget`), capped-backoff retries
for transient step failures, and a circuit breaker that sheds traffic
after repeated batch failures until a supervisor resets it. Without a
policy it behaves exactly as before: one FIFO, unbounded admission,
no retries, static budget.

Port of ``src/repro/pipeline/batcher.py``.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np

from repro_torch.pipeline.admission import (AdmissionPolicy, CircuitOpen,
                                            LaneBreaker, Rejected, RequestError,
                                            PRIORITIES, validate_priority)
from repro_torch.pipeline.cost import DynamicBudget, OpProfile, choose_batch_size


@dataclass
class BatcherStats:
    batches: int = 0
    rows: int = 0
    infer_seconds: float = 0.0
    convert_seconds: float = 0.0

    @property
    def rows_per_second(self) -> float:
        t = self.infer_seconds + self.convert_seconds
        return self.rows / t if t else 0.0


class WindowBatcher:
    """Window-function-style batcher over a row stream."""

    def __init__(self, infer_fn: Callable[[np.ndarray], np.ndarray],
                 batch_size: int = 16, convert_workers: int = 4,
                 convert_fn: Optional[Callable[[Any], np.ndarray]] = None):
        self.infer_fn = infer_fn
        self.batch_size = max(1, batch_size)
        self.convert_fn = convert_fn or (lambda r: np.asarray(r, np.float32))
        self._pool = (ThreadPoolExecutor(convert_workers)
                      if convert_workers > 1 else None)
        self._window: List[Any] = []
        self._ids: List[int] = []
        self._results: Dict[int, Any] = {}
        self.stats = BatcherStats()

    # (1) window data aggregation
    def add(self, row_id: int, row: Any) -> None:
        self._window.append(row)
        self._ids.append(row_id)
        if len(self._window) >= self.batch_size:
            self._flush()

    # (2) batch inference execution
    def _flush(self) -> None:
        if not self._window:
            return
        t0 = time.time()
        if self._pool:
            tensors = list(self._pool.map(self.convert_fn, self._window))
        else:
            tensors = [self.convert_fn(r) for r in self._window]
        x = np.stack(tensors)
        t1 = time.time()
        out = self.infer_fn(x)
        t2 = time.time()
        # (3) result caching + cleanup
        for rid, o in zip(self._ids, np.asarray(out)):
            self._results[rid] = o
        self.stats.batches += 1
        self.stats.rows += len(self._ids)
        self.stats.convert_seconds += t1 - t0
        self.stats.infer_seconds += t2 - t1
        self._window.clear()
        self._ids.clear()

    def finish(self) -> Dict[int, Any]:
        self._flush()
        return self._results


def run_batched(rows: Sequence[Any],
                infer_fn: Callable[[np.ndarray], np.ndarray],
                batch_size: int = 16, **kw) -> List[Any]:
    b = WindowBatcher(infer_fn, batch_size=batch_size, **kw)
    for i, r in enumerate(rows):
        b.add(i, r)
    res = b.finish()
    return [res[i] for i in range(len(rows))]


# ---------------------------------------------------------------------------
# Serving-engine continuous batcher
# ---------------------------------------------------------------------------

@dataclass
class Request:
    req_id: int
    payload: Any
    arrival: float = field(default_factory=time.time)
    # SLO dimensions (ignored unless the batcher carries an
    # AdmissionPolicy): priority class for weighted draining + caps, and
    # an optional completion deadline relative to arrival (seconds) that
    # feeds the dynamic row budget and the deadline-miss counter
    priority: str = "batch"
    deadline_s: Optional[float] = None


class _Failure:
    """Sentinel wrapping a step_fn exception so result() can re-raise."""

    __slots__ = ("error",)

    def __init__(self, error: BaseException):
        self.error = error


class ContinuousBatcher:
    """Admission queue -> cost-model batch size -> batched step loop.

    Two usage modes:

    - one-shot: ``submit()`` requests, then ``run(total)`` serves exactly
      ``total`` of them on the calling thread and returns their results;
    - service: ``start()`` spawns a worker thread, concurrent producers
      ``submit()`` and block on ``result(req_id)`` (a condition variable
      wakes them as batches complete), ``stop(drain=True)`` serves what
      is still queued before joining the worker.

    ``batch_size`` is chosen by the cost model (Eq. 11) and measured in
    payload units: by default one request = one unit, but a ``size_of``
    hook lets multi-row payloads count their rows so coalesced serving
    batches match the cost-model-sized row budget rather than a request
    count. Duplicate ``req_id`` submissions raise (a silent overwrite
    would drop one requester's result).

    ``policy`` (an :class:`AdmissionPolicy`) turns on the production
    hardening: queue-depth caps with reject/block backpressure, weighted
    priority draining, the deadline-aware :class:`DynamicBudget` in
    place of the static row budget, retry-with-backoff on step failures,
    and the lane circuit breaker. ``name`` labels this lane in every
    typed error so operators can tell *which* lane pushed back.
    """

    def __init__(self, step_fn: Callable[[List[Any]], List[Any]],
                 profile: Optional[OpProfile] = None, device: str = "cuda",
                 max_wait_s: float = 0.01, idle_wait_s: float = 0.1,
                 mem_cap_bytes: float = 2e9,
                 batch_size: Optional[int] = None,
                 size_of: Optional[Callable[[Any], int]] = None,
                 hw: Optional[Dict[str, Any]] = None,
                 telemetry_window: int = 10000,
                 name: str = "",
                 policy: Optional[AdmissionPolicy] = None):
        self.step_fn = step_fn
        if batch_size is not None:
            self.batch_size = max(1, int(batch_size))
        else:
            if profile is None:
                raise ValueError("need an OpProfile or explicit batch_size")
            self.batch_size = choose_batch_size(profile, device,
                                                mem_cap_bytes=mem_cap_bytes,
                                                hw=hw)
        self.max_wait_s = max_wait_s
        self.idle_wait_s = idle_wait_s
        self.size_of = size_of or (lambda _p: 1)
        self.name = name
        self.policy = policy
        # admission state: per-priority FIFO deques drained by weighted
        # round-robin; all guarded by the one condition variable
        self._queues: Dict[str, "deque[Request]"] = {
            p: deque() for p in PRIORITIES}
        self._credits: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._queued_units = 0
        self._queued_units_by: Dict[str, int] = {p: 0 for p in PRIORITIES}
        self._queued_reqs = 0
        self._cv = threading.Condition()
        self._results: Dict[int, Any] = {}
        self._latency_of: Dict[int, float] = {}
        self._submitted: Set[int] = set()
        self._pending = 0                    # submitted but not yet served
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # SLO machinery (active only with a policy): dynamic Eq. 11
        # budget + the windowed tightest admitted deadline it tracks,
        # and the lane circuit breaker
        self.budget: Optional[DynamicBudget] = None
        self.breaker: Optional[LaneBreaker] = None
        if policy is not None:
            self.budget = DynamicBudget(
                base_rows=self.batch_size,
                min_rows=policy.min_batch_rows,
                shrink_at=policy.shrink_at, grow_at=policy.grow_at)
            if policy.breaker_threshold > 0:
                self.breaker = LaneBreaker(
                    threshold=policy.breaker_threshold,
                    cooldown_s=policy.breaker_cooldown_s)
        self._deadline_window: "deque[float]" = deque(maxlen=256)
        # robustness counters (read via health())
        self.rejected = 0
        self.rejected_by_priority: Dict[str, int] = {
            p: 0 for p in PRIORITIES}
        self.retries = 0
        self.failed_batches = 0
        self.deadline_misses = 0
        self.deadlines_admitted = 0
        self.breaker_resets = 0
        # telemetry is windowed so a long-running service doesn't grow
        # without bound; per-request state is evicted by result()
        self.latencies: "deque[float]" = deque(maxlen=telemetry_window)
        self.batch_sizes: "deque[int]" = deque(maxlen=telemetry_window)
        self.lat_by_priority: Dict[str, "deque[float]"] = {
            p: deque(maxlen=telemetry_window) for p in PRIORITIES}

    def _label(self) -> str:
        return f"lane {self.name!r}" if self.name else "batcher"

    # -- admission ---------------------------------------------------------
    def _has_room_locked(self, priority: str, units: int) -> bool:
        if self.policy is None:
            return True
        pol = self.policy
        if self._queued_units + units > pol.max_queue_rows:
            return False
        return (self._queued_units_by[priority] + units
                <= pol.cap_of(priority))

    def _reject_locked(self, req: Request, units: int,
                       reason: str) -> None:
        self.rejected += 1
        self.rejected_by_priority[req.priority] += 1
        cap = (self.policy.cap_of(req.priority) if self.policy else 0)
        raise Rejected(
            f"{self._label()} rejected req_id {req.req_id!r} "
            f"({req.priority}, {units} units): {reason} "
            f"(queued {self._queued_units} units, cap {cap})",
            lane=self.name, priority=req.priority,
            queued_units=self._queued_units, cap=cap, reason=reason)

    def submit(self, req: Request) -> int:
        """Admit one request, or push back.

        Raises ``RuntimeError`` after ``stop()`` (the worker is gone —
        enqueueing would orphan the request), :class:`CircuitOpen` while
        the lane breaker is open, and :class:`Rejected` when the queue
        caps push back (immediately under the ``reject`` policy, after
        ``block_timeout_s`` of waiting for drain under ``block``)."""
        validate_priority(req.priority)
        units = self.size_of(req.payload)
        with self._cv:
            if req.req_id in self._submitted:
                raise ValueError(f"duplicate req_id {req.req_id!r}")
            self._check_stopped_locked(req)
            if not self._has_room_locked(req.priority, units):
                if self.policy is not None and self.policy.mode == "block":
                    ok = self._cv.wait_for(
                        lambda: (self._stop.is_set()
                                 or (self.breaker is not None
                                     and self.breaker.open)
                                 or self._has_room_locked(req.priority,
                                                          units)),
                        timeout=self.policy.block_timeout_s)
                    self._check_stopped_locked(req)
                    if not ok or not self._has_room_locked(req.priority,
                                                           units):
                        self._reject_locked(req, units, "block_timeout")
                else:
                    self._reject_locked(req, units, "queue_full")
            if req.req_id in self._submitted:   # re-check after blocking
                raise ValueError(f"duplicate req_id {req.req_id!r}")
            self._submitted.add(req.req_id)
            self._pending += 1
            # enqueue under the cv so the stop check and the put are
            # atomic w.r.t. stop(drain=False)'s queue drain — a request
            # can be admitted or rejected, never accepted-then-orphaned
            self._queues[req.priority].append(req)
            self._queued_units += units
            self._queued_units_by[req.priority] += units
            self._queued_reqs += 1
            if req.deadline_s is not None and req.deadline_s > 0:
                self._deadline_window.append(float(req.deadline_s))
                self.deadlines_admitted += 1
            self._cv.notify_all()
        return req.req_id

    def _check_stopped_locked(self, req: Request) -> None:
        if self._stop.is_set():
            raise RuntimeError(
                f"{self._label()} stopped: no worker will serve "
                f"req_id {req.req_id!r}")
        if self.breaker is not None and self.breaker.open:
            raise CircuitOpen(
                f"{self._label()} circuit breaker open after "
                f"{self.breaker.failures} consecutive batch failures; "
                "shedding until the supervisor resets it",
                lane=self.name, priority=req.priority,
                failures=self.breaker.failures)

    # -- weighted draining -------------------------------------------------
    def _pop_locked(self) -> Request:
        """Pop the next request under weighted round-robin: each class
        spends ``weight`` credits per cycle while others wait, so
        interactive traffic drains first without starving best-effort.
        Caller holds the cv and has checked a request is queued."""
        while True:
            for p in PRIORITIES:
                if self._queues[p] and self._credits[p] > 0:
                    self._credits[p] -= 1
                    req = self._queues[p].popleft()
                    units = self.size_of(req.payload)
                    self._queued_units -= units
                    self._queued_units_by[p] -= units
                    self._queued_reqs -= 1
                    return req
            # every queued class is out of credits: start a new cycle
            for p in PRIORITIES:
                self._credits[p] = (self.policy.weight_of(p)
                                    if self.policy else
                                    {"interactive": 8, "batch": 3,
                                     "best_effort": 1}[p])

    def _target_units(self) -> int:
        return self.budget.current if self.budget is not None \
            else self.batch_size

    def _collect(self, limit: Optional[int] = None) -> List[Request]:
        # Block on the first request (bounded by idle_wait_s) so an empty
        # queue parks the thread in the OS wait instead of busy-spinning.
        with self._cv:
            self._cv.wait_for(
                lambda: self._queued_reqs > 0 or self._stop.is_set(),
                timeout=self.idle_wait_s)
            if self._queued_reqs == 0:
                return []
            batch = [self._pop_locked()]
            units = self.size_of(batch[0].payload)
            target = self._target_units()
            deadline = time.time() + self.max_wait_s
            while units < target and (limit is None
                                      or len(batch) < limit):
                timeout = deadline - time.time()
                if timeout <= 0:
                    break
                if self._queued_reqs == 0:
                    self._cv.wait_for(lambda: self._queued_reqs > 0
                                      or self._stop.is_set(),
                                      timeout=timeout)
                if self._queued_reqs == 0:
                    break
                req = self._pop_locked()
                batch.append(req)
                units += self.size_of(req.payload)
            # popping freed queue room: wake block-mode submitters
            self._cv.notify_all()
        return batch

    # -- serving -----------------------------------------------------------
    def _run_step(self, batch: List[Request]
                  ) -> Tuple[List[Any], Optional[Exception], int]:
        """Execute the step with the policy's retry budget. Returns
        (outputs, final error or None, attempts made)."""
        payloads = [r.payload for r in batch]
        retry_limit = self.policy.retry_limit if self.policy else 0
        attempt = 0
        while True:
            attempt += 1
            try:
                outs: List[Any] = list(self.step_fn(payloads))
                if len(outs) != len(batch):
                    raise RuntimeError(
                        f"step_fn returned {len(outs)} results for "
                        f"{len(batch)} requests")
                return outs, None, attempt
            except Exception as e:      # surfaced via result() / run()
                if attempt > retry_limit:
                    return [], e, attempt
                with self._cv:
                    self.retries += 1
                # capped exponential backoff: transient backend hiccups
                # (a preempted device, a flaky remote) get a beat to
                # clear before the batch retries
                time.sleep(self.policy.backoff_s(attempt))

    def _serve(self, batch: List[Request]) -> Optional[Exception]:
        """Run one step (with retries) and publish its results; a step
        error is attributed to exactly the requests in this batch — it
        is stored per request as a typed :class:`RequestError` (surfaced
        by ``result()``), returned raw (for ``run()``), and the lane
        worker survives to serve the next batch."""
        outs, err, attempts = self._run_step(batch)
        now = time.time()
        if err is not None:
            wrapped = RequestError(
                f"{self._label()} batch of {len(batch)} request(s) "
                f"failed after {attempts} attempt(s): {err!r}",
                lane=self.name, attempts=attempts,
                req_ids=[r.req_id for r in batch])
            wrapped.__cause__ = err
            outs = [_Failure(wrapped)] * len(batch)
        with self._cv:
            for r, o in zip(batch, outs):
                self._results[r.req_id] = o
                lat = now - r.arrival
                self._latency_of[r.req_id] = lat
                self.latencies.append(lat)
                self.lat_by_priority[r.priority].append(lat)
                if (r.deadline_s is not None and r.deadline_s > 0
                        and lat > r.deadline_s):
                    self.deadline_misses += 1
            self._pending -= len(batch)
            self.batch_sizes.append(len(batch))
            if err is not None:
                self.failed_batches += 1
                if self.breaker is not None \
                        and self.breaker.record_failure(now):
                    self._drain_queues_locked(CircuitOpen(
                        f"{self._label()} circuit breaker tripped after "
                        f"{self.breaker.failures} consecutive batch "
                        "failures; queued requests shed",
                        lane=self.name, failures=self.breaker.failures))
            elif self.breaker is not None:
                self.breaker.record_success()
            if self.budget is not None:
                self.budget.update(self._windowed_p95_locked(),
                                   self._tightest_deadline_locked(),
                                   self._queued_units)
            self._cv.notify_all()
        return err

    def _windowed_p95_locked(self) -> Optional[float]:
        if len(self.latencies) < 5:
            return None
        return float(np.percentile(list(self.latencies), 95))

    def _tightest_deadline_locked(self) -> Optional[float]:
        return min(self._deadline_window) if self._deadline_window \
            else None

    def _drain_queues_locked(self, error: BaseException) -> None:
        """Fail every queued request with ``error`` (caller holds cv)."""
        for p in PRIORITIES:
            q = self._queues[p]
            while q:
                r = q.popleft()
                self._results[r.req_id] = _Failure(error)
                self._pending -= 1
        self._queued_units = 0
        self._queued_units_by = {p: 0 for p in PRIORITIES}
        self._queued_reqs = 0

    def run(self, total: int) -> Dict[int, Any]:
        """Serve exactly ``total`` queued requests on the calling thread
        and raise on the first step error (one-shot mode has no
        ``result()`` call to surface failures through). Collection is
        capped at the remaining count so a batch never crosses the
        ``total`` boundary (no overcounting when ``total`` is not a
        batch multiple)."""
        served = 0
        while served < total:
            batch = self._collect(limit=total - served)
            if not batch:
                continue
            err = self._serve(batch)
            if err is not None:
                raise err
            served += len(batch)
        return dict(self._results)

    # -- service lifecycle -------------------------------------------------
    def start(self) -> "ContinuousBatcher":
        if self._thread is not None:
            raise RuntimeError("batcher already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            batch = self._collect()
            if batch:
                self._serve(batch)
            elif self._stop.is_set() and self.queued_units == 0:
                # drain contract: only exit once the queues are empty
                return

    def result(self, req_id: int, timeout: Optional[float] = None, *,
               evict: bool = True) -> Any:
        """Block until ``req_id`` has been served and return its output
        (re-raising the step error if its batch failed). With ``evict``
        (default) the request's stored result and bookkeeping are
        released — each result is retrievable once, which is what keeps
        a long-running service's memory bounded."""
        with self._cv:
            if req_id not in self._submitted:
                raise KeyError(f"unknown req_id {req_id!r}")
            ok = self._cv.wait_for(lambda: req_id in self._results,
                                   timeout=timeout)
            if not ok:
                raise TimeoutError(f"req_id {req_id!r} not served in time")
            if evict:
                out = self._results.pop(req_id)
                self._latency_of.pop(req_id, None)
                self._submitted.discard(req_id)
            else:
                out = self._results[req_id]
        if isinstance(out, _Failure):
            raise out.error
        return out

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> Dict[int, Any]:
        """Shut the worker down. With ``drain`` (default) every queued
        request is served first; otherwise unserved requests are dropped
        and their ``result()`` calls fail.

        ``timeout`` bounds the worker join: a worker that has not exited
        within it (a step function wedged in a backend call) raises
        TimeoutError instead of hanging the caller forever. The worker
        reference is kept so a later ``stop()`` can retry the join once
        the step returns."""
        # _stop is set inside the cv block so submit()'s check-and-put
        # is atomic against it: a request is either rejected, failed
        # here (drain=False), or guaranteed served by the drain
        with self._cv:
            if not drain:
                for p in PRIORITIES:
                    q = self._queues[p]
                    while q:
                        r = q.popleft()
                        self._results[r.req_id] = _Failure(RuntimeError(
                            f"{self._label()} stopped before serving "
                            f"req_id {r.req_id!r}"))
                        self._pending -= 1
                self._queued_units = 0
                self._queued_units_by = {p: 0 for p in PRIORITIES}
                self._queued_reqs = 0
            self._stop.set()
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=timeout)
            if self._thread.is_alive():
                raise TimeoutError(
                    f"{self._label()} worker did not join within "
                    f"{timeout}s; its step function is still running")
            self._thread = None
        elif drain:
            # never started: no worker owns the drain, so serve the
            # queue inline — stop() must not orphan admitted requests
            while self.queued_units > 0 or self._queued_reqs > 0:
                batch = self._collect()
                if batch:
                    self._serve(batch)
        return dict(self._results)

    def latency(self, req_id: int) -> float:
        """Queue-to-completion latency of a served request (seconds)."""
        with self._cv:
            return self._latency_of[req_id]

    def evict(self, req_id: int) -> None:
        """Release a served request's stored result and bookkeeping."""
        with self._cv:
            self._results.pop(req_id, None)
            self._latency_of.pop(req_id, None)
            self._submitted.discard(req_id)

    def reset_telemetry(self) -> None:
        """Clear the windowed telemetry (latency + batch-size deques,
        per-priority windows) and the robustness counters. Served-request
        bookkeeping and breaker *state* are untouched — this only
        re-bases the windows so e.g. percentiles computed after a warmup
        phase don't mix pre- and post-warmup samples."""
        with self._cv:
            self.latencies.clear()
            self.batch_sizes.clear()
            for d in self.lat_by_priority.values():
                d.clear()
            self.rejected = 0
            self.rejected_by_priority = {p: 0 for p in PRIORITIES}
            self.retries = 0
            self.failed_batches = 0
            self.deadline_misses = 0
            self.deadlines_admitted = 0

    def telemetry(self) -> Tuple[List[float], List[int]]:
        """Consistent snapshot of (latencies, batch sizes) — the live
        deques mutate under the worker thread, so readers must not
        iterate them directly."""
        with self._cv:
            return list(self.latencies), list(self.batch_sizes)

    @property
    def pending(self) -> int:
        with self._cv:
            return self._pending

    @property
    def queued_units(self) -> int:
        """Queued-but-unserved work, in ``size_of`` units."""
        with self._cv:
            return self._queued_units

    @property
    def current_batch_rows(self) -> int:
        """The row budget the next batch will target (dynamic when a
        policy is attached, else the static Eq. 11 choice)."""
        with self._cv:
            return self._target_units()

    def reset_breaker(self, *, force: bool = False) -> bool:
        """Close an open breaker (the supervisor path). Unless ``force``,
        only resets after the policy's cooldown has elapsed. Returns
        True when the breaker was actually closed."""
        with self._cv:
            if self.breaker is None or not self.breaker.open:
                return False
            if not force and not self.breaker.cooled_down(time.time()):
                return False
            self.breaker.reset()
            self.breaker_resets += 1
            self._cv.notify_all()
            return True

    def telemetry_by_priority(self) -> Dict[str, List[float]]:
        """Consistent snapshot of per-priority-class latencies."""
        with self._cv:
            return {p: list(d) for p, d in self.lat_by_priority.items()}

    def health(self) -> Dict[str, Any]:
        """Snapshot of the lane's robustness counters and SLO state."""
        with self._cv:
            return {
                "name": self.name,
                "queued_units": self._queued_units,
                "queued_by_priority": dict(self._queued_units_by),
                "rejected": self.rejected,
                "rejected_by_priority": dict(self.rejected_by_priority),
                "retries": self.retries,
                "failed_batches": self.failed_batches,
                "deadline_misses": self.deadline_misses,
                "deadlines_admitted": self.deadlines_admitted,
                "breaker_open": (self.breaker.open
                                 if self.breaker else False),
                "breaker_trips": (self.breaker.trips
                                  if self.breaker else 0),
                "breaker_resets": self.breaker_resets,
                "batch_rows": self._target_units(),
                "budget_shrinks": (self.budget.shrinks
                                   if self.budget else 0),
                "budget_grows": (self.budget.grows
                                 if self.budget else 0),
            }
