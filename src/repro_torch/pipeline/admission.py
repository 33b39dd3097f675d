"""Admission control for the serving lanes (ROADMAP: "SLO-aware
admission and scheduling under production load").

The cost model sizes batches to minimize inference time (Eq. 10/11);
this module supplies the layer that keeps those batches healthy when
the offered load exceeds what the hardware can absorb:

- :class:`AdmissionPolicy` — one declarative knob bundle per server:
  per-lane queue-depth caps with a backpressure mode (``reject`` returns
  a typed :class:`Rejected` immediately, ``block`` waits up to a timeout
  for the queue to drain), per-request **priority classes** with
  weighted lane draining, retry/backoff limits for transient backend
  failures, and the circuit-breaker thresholds;
- typed admission outcomes — :class:`Rejected` (backpressure),
  :class:`CircuitOpen` (the lane's breaker tripped after repeated batch
  failures), :class:`RequestError` (this request's batch failed after
  retries; the *lane* is fine and keeps serving);
- :class:`LaneBreaker` — consecutive-failure circuit breaker: a lane
  whose batches fail ``breaker_threshold`` times in a row stops
  admitting (queued requests drain with :class:`CircuitOpen`) until a
  supervisor resets it after ``breaker_cooldown_s``.

The deadline-aware dynamic row budget that pairs with this policy lives
in :class:`repro_torch.pipeline.cost.DynamicBudget` (it is Eq. 11 made
adaptive, so it belongs with the rest of the batch-size math).

Port of ``src/repro/pipeline/admission.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Mapping, Optional, Sequence, Tuple

# priority classes, in draining-preference order. The weights say how
# many requests of a class the weighted-round-robin drain pops per
# credit cycle while lower classes still have queued work: interactive
# traffic is preferred 8:3:1 but best-effort is never fully starved.
INTERACTIVE = "interactive"
BATCH = "batch"
BEST_EFFORT = "best_effort"
PRIORITIES: Tuple[str, ...] = (INTERACTIVE, BATCH, BEST_EFFORT)
DEFAULT_WEIGHTS: Dict[str, int] = {INTERACTIVE: 8, BATCH: 3, BEST_EFFORT: 1}


def _rebuild_error(cls, args, state):
    """Reconstruct a typed admission error from (class, args, attrs).

    The default exception pickling replays ``cls(*args)``, which loses
    every keyword-only field (lane, priority, reason, ...). These errors
    cross the dispatch tier's process boundary, so they rebuild from the
    message args plus the full attribute dict instead."""
    err = cls.__new__(cls)
    RuntimeError.__init__(err, *args)
    err.__dict__.update(state)
    return err


class Rejected(RuntimeError):
    """Typed admission failure: the lane's queue-depth cap (or its
    block-timeout) pushed back. Carries enough context for the caller
    to decide whether to retry, downgrade priority, or shed."""

    def __init__(self, message: str, *, lane: str = "",
                 priority: str = BATCH, queued_units: int = 0,
                 cap: int = 0, reason: str = "queue_full"):
        super().__init__(message)
        self.lane = lane
        self.priority = priority
        self.queued_units = queued_units
        self.cap = cap
        self.reason = reason

    def __reduce__(self):
        return _rebuild_error, (type(self), self.args, dict(self.__dict__))


class CircuitOpen(Rejected):
    """The lane's circuit breaker is open: repeated batch failures
    tripped it and the lane sheds all traffic until a supervisor resets
    it (``MorphingServer`` does so on the next submit after the
    cooldown)."""

    def __init__(self, message: str, *, lane: str = "",
                 priority: str = BATCH, failures: int = 0):
        super().__init__(message, lane=lane, priority=priority,
                         reason="breaker_open")
        self.failures = failures


class RequestError(RuntimeError):
    """A served request's batch failed after the retry budget. The
    failure is scoped to the requests that shared the batch — the lane
    worker survived and keeps serving; ``__cause__`` holds the backend
    exception."""

    def __init__(self, message: str, *, lane: str = "",
                 attempts: int = 1,
                 req_ids: Sequence[int] = ()):
        super().__init__(message)
        self.lane = lane
        self.attempts = attempts
        self.req_ids = tuple(req_ids)

    def __reduce__(self):
        return _rebuild_error, (type(self), self.args, dict(self.__dict__))


@dataclass(frozen=True)
class AdmissionPolicy:
    """Declarative per-server admission/robustness policy, applied to
    every lane (`docs/serving.md` "Admission & SLOs").

    Queue caps are measured in the lane's ``size_of`` units — rows for
    serving lanes — and bound *queued* work only; in-flight batches are
    bounded by the (dynamic) Eq. 11 row budget.
    """
    max_queue_rows: int = 65536          # per-lane cap over all classes
    # optional tighter per-class caps, e.g. {"best_effort": 2048}: a
    # class at its cap rejects while the others keep admitting
    per_priority_rows: Mapping[str, int] = field(default_factory=dict)
    mode: str = "reject"                 # 'reject' | 'block'
    block_timeout_s: float = 1.0
    weights: Mapping[str, int] = field(
        default_factory=lambda: dict(DEFAULT_WEIGHTS))
    # transient-failure handling: a failed batch retries with capped
    # exponential backoff before surfacing RequestError
    retry_limit: int = 2
    retry_backoff_s: float = 0.01
    retry_backoff_cap_s: float = 0.25
    # circuit breaker: this many *consecutive* permanently-failed
    # batches trip the lane (0 disables)
    breaker_threshold: int = 3
    breaker_cooldown_s: float = 0.5
    # deadline-aware dynamic Eq. 11 budget (cost.DynamicBudget)
    min_batch_rows: int = 8
    shrink_at: float = 0.8               # p95/deadline ratio that shrinks
    grow_at: float = 0.4                 # ratio below which budgets regrow

    def __post_init__(self):
        if self.mode not in ("reject", "block"):
            raise ValueError(f"unknown backpressure mode {self.mode!r}")
        bad = set(self.per_priority_rows) - set(PRIORITIES)
        bad |= set(self.weights) - set(PRIORITIES)
        if bad:
            raise ValueError(f"unknown priority classes {sorted(bad)}")

    def weight_of(self, priority: str) -> int:
        return max(int(self.weights.get(priority,
                                        DEFAULT_WEIGHTS.get(priority, 1))),
                   1)

    def cap_of(self, priority: str) -> int:
        """Effective queue cap for one class (min of the class cap and
        the lane-wide cap)."""
        cap = self.per_priority_rows.get(priority, self.max_queue_rows)
        return min(int(cap), int(self.max_queue_rows))

    def backoff_s(self, attempt: int) -> float:
        """Capped exponential backoff before retry ``attempt`` (1-based)."""
        return min(self.retry_backoff_s * (2.0 ** max(attempt - 1, 0)),
                   self.retry_backoff_cap_s)


def validate_priority(priority: str) -> str:
    if priority not in PRIORITIES:
        raise ValueError(
            f"unknown priority {priority!r}; expected one of {PRIORITIES}")
    return priority


@dataclass
class LaneBreaker:
    """Consecutive-failure circuit breaker for one lane.

    Not thread-safe by itself — the owning batcher mutates it under its
    condition variable. ``threshold <= 0`` disables tripping."""
    threshold: int = 3
    cooldown_s: float = 0.5
    failures: int = 0                    # consecutive failed batches
    trips: int = 0
    open: bool = False
    opened_at: float = 0.0

    def record_success(self) -> None:
        self.failures = 0

    def record_failure(self, now: float) -> bool:
        """Count one permanently-failed batch; returns True when this
        failure trips the breaker open."""
        self.failures += 1
        if self.threshold > 0 and self.failures >= self.threshold \
                and not self.open:
            self.open = True
            self.opened_at = now
            self.trips += 1
            return True
        return False

    def cooled_down(self, now: float) -> bool:
        return self.open and (now - self.opened_at) >= self.cooldown_s

    def reset(self) -> None:
        self.open = False
        self.failures = 0
