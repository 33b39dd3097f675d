"""Multi-process dispatch tier: front-door routing to mesh-backed workers.

Serving scales across devices *inside* one process through the backend
pool; this module scales past the process boundary: :class:`DispatchServer`
speaks the same ``submit/predict/result/stats/health/stop`` surface as
:class:`MorphingServer` but routes coalesced ``PREDICT`` batches to N
worker processes, each owning its own ``MorphingSession`` — backends,
``BackendPool``/mesh, share cache — spawned via stdlib
``multiprocessing`` (queue transport, no new dependencies). The shape
is modeled on EVA's parallel executor dispatching plan fragments to
remote workers.

Dataflow:

- the **front door** owns a full session on a shared ``DecoupledStore``
  root: it parses the SQL, snapshots the selected rows, resolves tasks
  (persisting models into the shared store so workers can resolve them
  by ``model_id``), and runs one admission
  :class:`~repro_torch.pipeline.batcher.ContinuousBatcher` per *trunk* — the
  same coalescing, priority classes, backpressure and breaker
  supervision the in-process server applies, now in front of the
  process boundary;
- a front lane's coalesced batch becomes a **lease**: its items
  ``(req_id, task, rows, priority, deadline)`` ship to a worker over
  its command queue, results return on the shared results queue, and
  the lease stays outstanding until some worker answers. Worker
  **heartbeats** plus process liveness decide when a worker is dead;
  its outstanding leases re-dispatch to survivors — at-most-once per
  request: the first completed copy of a lease wins, late duplicates
  are counted (``DispatchStats.duplicates_dropped``) and dropped;
- **placement** is staging-aware and cost-driven
  (:class:`PlacementPolicy`): a trunk is resident on as few workers as
  its measured load needs, so K fine-tunes of one base hit one worker's
  shared embed lane. A hot trunk scales out only when the front lane's
  backlog crosses the admission watermark *and* the Eq. 7 staging cost
  is earned back by the Eq. 10/11 throughput gain computed from the
  worker's calibrated :class:`~repro_torch.pipeline.cost.HardwareProfile`;
  idle trunks drain back to one replica (workers unstage via
  ``MorphingServer.unstage_trunk``);
- :class:`DispatchStats` aggregates every worker's ``ServerStats``
  (rows/s, share/approx hits, breaker state) with the dispatch-level
  counters (leases, re-dispatches, duplicates dropped, scale in/out,
  per-worker staged bytes) into one view.

Everything crossing the boundary is picklable by construction:
``ResolvedModel`` heads are module-level callables, ``ServerStats`` is
a plain dataclass, and the typed admission errors carry their fields
through ``__reduce__`` — regression-tested in ``tests/test_dispatch.py``
so a new field can't silently break transport.

Port of ``src/repro/engine/dispatch.py``. Workers inherit the front
door's ``EngineConfig``, ``torch_device`` included, so on one card every
worker opens its own CUDA context on the same device; only numpy arrays
and picklable dataclasses cross the queues (lanes hand back numpy).
"""
from __future__ import annotations

import dataclasses
import itertools
import multiprocessing as mp
import queue as queue_mod
import threading
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.engine.config import EngineConfig
from repro_torch.engine.serve import (MorphingServer, ServeResult, ServerStats,
                                _LANE_BATCH_CANDIDATES)
from repro_torch.engine.session import MorphingSession
from repro_torch.pipeline.admission import AdmissionPolicy, validate_priority
from repro_torch.pipeline.batcher import ContinuousBatcher, Request
from repro_torch.pipeline.cost import (HardwareProfile, choose_batch_size,
                                 exec_time, split_profile, trans_cost)


# ---------------------------------------------------------------------------
# Placement policy
# ---------------------------------------------------------------------------

@dataclass
class PlacementPolicy:
    """Staging-aware replica policy for one dispatch tier.

    ``watermark_rows`` is the admission watermark: a trunk is considered
    for scale-out only while its front lane's queued rows are at/above
    it. Crossing the watermark is necessary, not sufficient — with
    ``cost_gated`` (default) the new replica must also *pay for itself*:
    the Eq. 6 drain-time reduction of going from R to R+1 replicas,
    computed on the worker's calibrated HardwareProfile, must exceed the
    Eq. 7 staging cost of moving the trunk plus ``min_gain_s``.

    ``max_replicas`` caps a trunk's replicas (0 = every live worker).
    ``idle_scale_in_s`` of front-lane silence drains a multi-replica
    trunk back to one worker (the extras unstage). ``stage_timeout_s``
    bounds the front door's wait for a worker's staged/unstaged ack.
    """
    watermark_rows: int = 4096
    max_replicas: int = 0
    idle_scale_in_s: float = 5.0
    min_gain_s: float = 0.0
    cost_gated: bool = True
    stage_timeout_s: float = 120.0


# ---------------------------------------------------------------------------
# Aggregated stats
# ---------------------------------------------------------------------------

@dataclass
class DispatchStats:
    """One view over the whole dispatch tier (docs/serving.md "Dispatch
    tier" documents every field)."""
    # tier shape
    workers: int = 0                 # workers spawned
    alive_workers: int = 0           # workers currently alive
    # front-door traffic
    requests: int = 0                # requests admitted at the front door
    rows: int = 0                    # rows returned to callers
    rejected: int = 0                # front-lane admission rejections
    p50_latency_s: float = 0.0       # end-to-end front-door latency
    p95_latency_s: float = 0.0
    # lease / failover accounting
    leases: int = 0                  # batches dispatched (first sends)
    redispatches: int = 0            # leases re-sent after a worker death
    duplicates_dropped: int = 0      # late duplicate lease answers dropped
    worker_deaths: int = 0           # workers declared dead
    # placement
    scale_outs: int = 0              # trunk replicas added under load
    scale_ins: int = 0               # idle replicas drained back
    staged_bytes_by_worker: Dict[int, int] = field(default_factory=dict)
    trunks_by_worker: Dict[int, List[str]] = field(default_factory=dict)
    replicas_by_trunk: Dict[str, int] = field(default_factory=dict)
    # per-worker ServerStats plus their aggregates
    per_worker: Dict[int, ServerStats] = field(default_factory=dict)
    worker_rows: int = 0             # rows scored across all workers
    infer_seconds: float = 0.0       # summed worker compute seconds
    share_hits: int = 0
    share_misses: int = 0
    approx_hits: int = 0
    dedup_rows: int = 0
    embed_rows: int = 0
    retries: int = 0
    failed_batches: int = 0
    breaker_open_lanes: List[str] = field(default_factory=list)

    @property
    def rows_per_second(self) -> float:
        return (self.worker_rows / self.infer_seconds
                if self.infer_seconds else 0.0)

    @property
    def share_hit_rate(self) -> float:
        hits = self.share_hits + self.approx_hits
        t = hits + self.share_misses
        return hits / t if t else 0.0


# ---------------------------------------------------------------------------
# Worker process
# ---------------------------------------------------------------------------

def _worker_main(wid: int, root: str, cfg: EngineConfig, serve_kw: dict,
                 opts: dict, cmd_q, res_q) -> None:
    """Worker entry point (spawn target; must stay module-level so the
    child can import it). Owns a full session + server on the shared
    store root; serves leases in gather threads so the command loop
    stays responsive to stage/stats/stop while batches run."""
    hb_interval_s = float(opts.get("hb_interval_s", 0.25))
    result_timeout_s = float(opts.get("result_timeout_s", 120.0))
    try:
        sess = MorphingSession(root=Path(root), config=cfg)
        server = MorphingServer(session=sess, **serve_kw).start()
    except Exception as e:          # startup failure: report, don't hang
        res_q.put(("ready", wid, None, f"{type(e).__name__}: {e}"))
        return
    res_q.put(("ready", wid, sess.hw, None))
    stop_evt = threading.Event()

    def _heartbeat() -> None:
        while not stop_evt.is_set():
            try:
                res_q.put(("hb", wid, time.time()))
            except Exception:       # queue torn down: front door is gone
                return
            stop_evt.wait(hb_interval_s)

    threading.Thread(target=_heartbeat, daemon=True,
                     name=f"dispatch-hb-{wid}").start()

    def _serve_lease(lease_id: int, items: list) -> None:
        # slots mirror items positionally: ("ok", scores) on success,
        # ("err", exception) for per-request failures — the typed
        # admission errors pickle with their fields intact
        slots: List[Tuple[str, Any]] = [None] * len(items)
        waiting = []
        for i, (req_id, task, X, priority, deadline_ms) in enumerate(items):
            try:
                local = server.submit_rows(task, np.asarray(X),
                                           priority=priority,
                                           deadline_ms=deadline_ms)
                waiting.append((i, local))
            except Exception as e:
                slots[i] = ("err", e)
        for i, local in waiting:
            try:
                out = server.result(local, timeout=result_timeout_s)
                slots[i] = ("ok", np.asarray(out.scores))
            except Exception as e:
                slots[i] = ("err", e)
        res_q.put(("done", wid, lease_id, slots))

    while True:
        try:
            msg = cmd_q.get(timeout=1.0)
        except queue_mod.Empty:
            continue
        except (EOFError, OSError):
            break
        kind = msg[0]
        try:
            if kind == "stage":
                _, task, model_id, spec, in_dim, mode = msg
                try:
                    # the front door may have registered the model after
                    # this worker's catalog loaded: re-read the tables
                    sess.catalog.reload()
                    if task not in sess.registry._tasks:
                        sess.create_task(spec)
                    sample = np.zeros((1, max(int(in_dim or 1), 1)),
                                      np.float32)
                    sess.resolve_task(task, sample, None,
                                      model_id=model_id,
                                      mode=mode or "full")
                    res_q.put(("staged", wid, task, None))
                except Exception as e:
                    res_q.put(("staged", wid, task,
                               f"{type(e).__name__}: {e}"))
            elif kind == "unstage":
                _, trunk, tasks = msg
                ok = server.unstage_trunk(trunk)
                for t in tasks:
                    # drop the resolutions too: scale-in releases the
                    # trunk bytes, not just the staged device state
                    sess.models.pop(t, None)
                res_q.put(("unstaged", wid, trunk, ok))
            elif kind == "batch":
                _, lease_id, items = msg
                threading.Thread(target=_serve_lease,
                                 args=(lease_id, items), daemon=True,
                                 name=f"dispatch-lease-{lease_id}").start()
            elif kind == "stats":
                res_q.put(("stats", wid, server.stats()))
            elif kind == "health":
                res_q.put(("health", wid, server.health()))
            elif kind == "reset":
                server.reset_telemetry()
            elif kind == "fault":
                from repro_torch.training.fault import FaultInjector
                fault_kw = msg[1]
                sess.backends.set_fault_injector(
                    FaultInjector(**fault_kw) if fault_kw else None)
                res_q.put(("fault_set", wid, None))
            elif kind == "stop":
                drain = bool(msg[1]) if len(msg) > 1 else True
                try:
                    server.stop(drain=drain)
                except Exception:
                    pass
                stop_evt.set()
                res_q.put(("stopped", wid))
                break
        except Exception as e:      # a broken command must not kill the
            try:                    # worker loop; report and keep serving
                res_q.put(("worker_error", wid,
                           f"{kind}: {type(e).__name__}: {e}"))
            except Exception:
                break


# ---------------------------------------------------------------------------
# Front-door bookkeeping
# ---------------------------------------------------------------------------

def _payload_rows(p) -> int:
    return max(len(p[2]), 1)


class _Mailbox:
    """Keyed one-slot mailbox for worker acks (staged/stats/health/...).
    The receiver thread posts; request threads wait on their key."""

    def __init__(self):
        self._cv = threading.Condition()
        self._msgs: Dict[Tuple, Any] = {}

    def post(self, msg: tuple) -> None:
        kind, wid = msg[0], msg[1]
        key = (kind, wid)
        if kind in ("staged", "unstaged"):
            key = (kind, wid, msg[2])
        with self._cv:
            self._msgs[key] = msg
            self._cv.notify_all()

    def wait(self, key: Tuple, timeout: float,
             alive=None) -> Optional[tuple]:
        deadline = time.time() + timeout
        with self._cv:
            while key not in self._msgs:
                if alive is not None and not alive():
                    return None
                remaining = deadline - time.time()
                if remaining <= 0:
                    return None
                self._cv.wait(min(remaining, 0.2))
            return self._msgs.pop(key)


@dataclass
class _WorkerHandle:
    wid: int
    proc: Any
    cmd_q: Any
    alive: bool = True
    last_hb: float = 0.0
    ready: threading.Event = field(default_factory=threading.Event)
    ready_err: Optional[str] = None
    hw: Optional[Dict[str, HardwareProfile]] = None
    stage_lock: threading.Lock = field(default_factory=threading.Lock)
    staged_tasks: Set[str] = field(default_factory=set)
    trunks: Dict[str, int] = field(default_factory=dict)   # fp -> bytes
    delta_bytes: Dict[str, int] = field(default_factory=dict)
    inflight_rows: int = 0
    last_stats: Optional[ServerStats] = None
    errors: List[str] = field(default_factory=list)

    @property
    def staged_bytes(self) -> int:
        return sum(self.trunks.values()) + sum(self.delta_bytes.values())


@dataclass
class _Lease:
    lease_id: int
    wid: int
    trunk: str
    items: list
    rows: int
    event: threading.Event = field(default_factory=threading.Event)
    slots: Optional[list] = None
    done: bool = False
    redispatched: int = 0


@dataclass
class _TrunkPlacement:
    trunk: str
    tasks: Set[str] = field(default_factory=set)
    replicas: List[int] = field(default_factory=list)
    last_active: float = 0.0
    scaling: bool = False            # a scale-out is already in flight


@dataclass
class _FrontLane:
    key: str
    batcher: ContinuousBatcher
    batch_rows: int


# ---------------------------------------------------------------------------
# The front door
# ---------------------------------------------------------------------------

class DispatchServer:
    """Front-door server routing coalesced PREDICT batches to worker
    processes. Same surface as :class:`MorphingServer`
    (``submit/submit_rows/predict/result/stats/health/stop`` plus
    context-manager lifecycle); requires a ``model_store='decoupled'``
    session because workers resolve models from the shared store root
    by ``model_id``.

    ``workers`` defaults to ``EngineConfig.workers``. ``worker_backend``
    overrides the workers' backend flavour (the front door's own
    backends never run inference): ``'torch'`` workers run the trunks on
    ``EngineConfig.torch_device``, ``'numpy'`` workers give real
    multi-core scaling on CPU hosts.
    Workers auto-calibrate through the on-disk memo
    (``EngineConfig.calib_memo_path``, defaulted to a file under the
    shared root) so N processes pay the two-point probe once.
    """

    def __init__(self, session: Optional[MorphingSession] = None, *,
                 config: Optional[EngineConfig] = None,
                 workers: Optional[int] = None,
                 placement: Optional[PlacementPolicy] = None,
                 policy: Optional[AdmissionPolicy] = None,
                 worker_backend: Optional[str] = None,
                 max_wait_s: float = 0.002, idle_wait_s: float = 0.05,
                 mem_cap_bytes: float = 2e9,
                 heartbeat_s: float = 0.25,
                 heartbeat_timeout_s: float = 2.0,
                 monitor_interval_s: float = 0.2,
                 lease_timeout_s: float = 120.0,
                 stop_timeout_s: float = 30.0,
                 start_timeout_s: float = 120.0,
                 **session_kw):
        if session is None:
            cfg = config or EngineConfig(model_store="decoupled")
            session = MorphingSession(config=cfg, **session_kw)
        self.session = session
        cfg = session.config
        if session.model_store != "decoupled":
            raise ValueError(
                "DispatchServer requires model_store='decoupled': workers "
                "resolve served models from the shared store root")
        self.workers_requested = int(
            workers if workers is not None else cfg.workers)
        if self.workers_requested < 1:
            raise ValueError(
                f"workers must be >= 1, got {self.workers_requested}")
        self.placement = placement or PlacementPolicy()
        self.policy = policy if policy is not None else cfg.policy
        self.max_wait_s = max_wait_s
        self.idle_wait_s = idle_wait_s
        self.mem_cap_bytes = mem_cap_bytes
        self.heartbeat_s = heartbeat_s
        self.heartbeat_timeout_s = heartbeat_timeout_s
        self.monitor_interval_s = monitor_interval_s
        self.lease_timeout_s = lease_timeout_s
        self.stop_timeout_s = stop_timeout_s
        self.start_timeout_s = start_timeout_s
        # workers inherit the engine config with their own backend
        # flavour, a default retry/breaker policy for their lanes, and
        # the shared calibration memo (first prober writes, rest read)
        self._worker_cfg = dataclasses.replace(
            cfg,
            backend=worker_backend or cfg.backend,
            model_store="decoupled",
            policy=cfg.policy or AdmissionPolicy(),
            calib_memo_path=(cfg.calib_memo_path or
                             str(self.session.root / "hw_calib_memo.json")))
        self._serve_kw = {"max_wait_s": max_wait_s,
                          "idle_wait_s": idle_wait_s,
                          "mem_cap_bytes": mem_cap_bytes,
                          "share_lanes": True,
                          "stop_timeout_s": stop_timeout_s}
        self._worker_opts = {"hb_interval_s": heartbeat_s,
                             "result_timeout_s": lease_timeout_s}
        self._workers: Dict[int, _WorkerHandle] = {}
        self._lanes: Dict[str, _FrontLane] = {}
        self._lane_of_task: Dict[str, _FrontLane] = {}
        self._task_of: Dict[int, str] = {}
        self._placements: Dict[str, _TrunkPlacement] = {}
        self._leases: Dict[int, _Lease] = {}
        self._finished: Set[int] = set()
        self._mail = _Mailbox()
        self._ids = itertools.count()
        self._lease_ids = itertools.count()
        self._lock = threading.Lock()
        self._place_lock = threading.Lock()
        self._res_q = None
        self._recv_thread: Optional[threading.Thread] = None
        self._monitor_thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()   # halts failover/monitor
        self._recv_stop = threading.Event()  # halts the receiver last
        self._running = False
        self._stopped = False
        # counters (under self._lock)
        self._requests = 0
        self._rows_served = 0
        self._lease_count = 0
        self._redispatches = 0
        self._dup_dropped = 0
        self._worker_deaths = 0
        self._scale_outs = 0
        self._scale_ins = 0

    # reuse the in-process server's statement parsing + row snapshot —
    # the front door admits exactly what MorphingServer would
    _parse_predict = MorphingServer._parse_predict
    _rows_for = MorphingServer._rows_for

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "DispatchServer":
        with self._lock:
            if self._running:
                raise RuntimeError("server already started")
            if self._stopped:
                raise RuntimeError("a stopped DispatchServer cannot be "
                                   "restarted; construct a new one")
            self._running = True
        ctx = mp.get_context("spawn")
        self._res_q = ctx.Queue()
        for wid in range(self.workers_requested):
            cmd_q = ctx.Queue()
            proc = ctx.Process(
                target=_worker_main,
                args=(wid, str(self.session.root), self._worker_cfg,
                      self._serve_kw, self._worker_opts, cmd_q,
                      self._res_q),
                daemon=True, name=f"dispatch-worker-{wid}")
            self._workers[wid] = _WorkerHandle(wid=wid, proc=proc,
                                               cmd_q=cmd_q)
        self._recv_thread = threading.Thread(
            target=self._recv_loop, daemon=True, name="dispatch-recv")
        self._recv_thread.start()
        for h in self._workers.values():
            h.proc.start()
        for h in self._workers.values():
            deadline = time.time() + self.start_timeout_s
            while not h.ready.wait(timeout=0.2):
                if not h.proc.is_alive():
                    self.stop(drain=False)
                    raise RuntimeError(
                        f"dispatch worker {h.wid} died during startup "
                        f"(exitcode {h.proc.exitcode})")
                if time.time() > deadline:
                    self.stop(drain=False)
                    raise RuntimeError(
                        f"dispatch worker {h.wid} did not come up within "
                        f"{self.start_timeout_s}s")
            if h.ready_err:
                self.stop(drain=False)
                raise RuntimeError(
                    f"dispatch worker {h.wid} failed to start: "
                    f"{h.ready_err}")
        self._monitor_thread = threading.Thread(
            target=self._monitor_loop, daemon=True, name="dispatch-monitor")
        self._monitor_thread.start()
        return self

    def __enter__(self) -> "DispatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Drain the front lanes (dispatching whatever is queued), stop
        every worker, and join the plumbing threads. Idempotent."""
        with self._lock:
            if self._stopped:
                return
            self._stopped = True
            self._running = False
            lanes = list(self._lanes.values())
        timeout = self.stop_timeout_s if timeout is None else timeout
        stuck: List[str] = []
        for lane in lanes:
            try:
                lane.batcher.stop(drain=drain, timeout=timeout)
            except TimeoutError:
                stuck.append(lane.key)
        # failover must not react to the shutdown kills below
        self._stopping.set()
        for h in self._workers.values():
            if h.alive and h.proc.is_alive():
                try:
                    h.cmd_q.put(("stop", drain))
                except Exception:
                    pass
        deadline = time.time() + max(timeout, 5.0)
        for h in self._workers.values():
            h.proc.join(timeout=max(deadline - time.time(), 0.1))
            if h.proc.is_alive():
                h.proc.terminate()
                h.proc.join(timeout=2.0)
            h.alive = False
        self._recv_stop.set()
        for t in (self._monitor_thread, self._recv_thread):
            if t is not None:
                t.join(timeout=2.0)
        for h in self._workers.values():
            try:
                h.cmd_q.close()
                h.cmd_q.cancel_join_thread()
            except Exception:
                pass
        if self._res_q is not None:
            try:
                self._res_q.close()
                self._res_q.cancel_join_thread()
            except Exception:
                pass
        if stuck:
            raise RuntimeError(
                f"front lane worker(s) did not join within {timeout}s: "
                f"{stuck}")

    # -- receiver / monitor ------------------------------------------------
    def _recv_loop(self) -> None:
        while not self._recv_stop.is_set():
            try:
                msg = self._res_q.get(timeout=0.2)
            except queue_mod.Empty:
                continue
            except (EOFError, OSError):
                return
            kind = msg[0]
            if kind == "hb":
                h = self._workers.get(msg[1])
                if h is not None:
                    h.last_hb = time.time()
            elif kind == "done":
                self._complete_lease(msg[2], msg[1], msg[3])
            elif kind == "ready":
                h = self._workers.get(msg[1])
                if h is not None:
                    h.hw = msg[2]
                    h.ready_err = msg[3]
                    h.last_hb = time.time()
                    h.ready.set()
            elif kind == "worker_error":
                h = self._workers.get(msg[1])
                if h is not None:
                    h.errors.append(msg[2])
            else:
                self._mail.post(msg)

    def _monitor_loop(self) -> None:
        while not self._stopping.wait(self.monitor_interval_s):
            now = time.time()
            for h in list(self._workers.values()):
                if not h.alive:
                    continue
                hb_stale = (h.last_hb > 0 and
                            now - h.last_hb > self.heartbeat_timeout_s)
                if not h.proc.is_alive() or hb_stale:
                    self._on_worker_death(h)
            self._maybe_scale_in(now)

    # -- worker failure / lease failover -----------------------------------
    def _on_worker_death(self, h: _WorkerHandle) -> None:
        with self._lock:
            if not h.alive:
                return
            h.alive = False
            self._worker_deaths += 1
            orphans = [ls for ls in self._leases.values()
                       if ls.wid == h.wid and not ls.done]
        with self._place_lock:
            h.staged_tasks.clear()
            h.trunks.clear()
            h.delta_bytes.clear()
            for pl in self._placements.values():
                if h.wid in pl.replicas:
                    pl.replicas.remove(h.wid)
        for lease in orphans:
            try:
                self._redispatch(lease)
            except Exception as e:
                self._fail_lease(lease, RuntimeError(
                    f"worker {h.wid} died and lease {lease.lease_id} "
                    f"could not be re-dispatched: {e}"))

    def _redispatch(self, lease: _Lease) -> None:
        """Re-send a dead worker's lease to a survivor, re-staging the
        trunk where the load moved if no replica survives."""
        with self._place_lock:
            pl = self._placements.get(lease.trunk)
            cands = [w for w in (pl.replicas if pl else [])
                     if self._workers[w].alive]
        if cands:
            wid = cands[0]
        else:
            wid = self._add_replica(lease.trunk, exclude=(lease.wid,))
        with self._lock:
            if lease.done:           # answered while we were re-staging
                return
            lease.wid = wid
            lease.redispatched += 1
            self._redispatches += 1
            self._workers[wid].inflight_rows += lease.rows
        self._workers[wid].cmd_q.put(("batch", lease.lease_id, lease.items))

    def _fail_lease(self, lease: _Lease, err: Exception) -> None:
        with self._lock:
            if lease.done:
                return
            lease.done = True
            lease.slots = [("err", err)] * len(lease.items)
            self._leases.pop(lease.lease_id, None)
            self._finished.add(lease.lease_id)
        lease.event.set()

    def _complete_lease(self, lease_id: int, wid: int, slots: list) -> None:
        with self._lock:
            lease = self._leases.get(lease_id)
            if lease is None or lease.done:
                # a re-dispatched lease answered twice: first copy won
                if lease_id in self._finished:
                    self._dup_dropped += 1
                return
            lease.done = True
            lease.slots = slots
            self._leases.pop(lease_id, None)
            self._finished.add(lease_id)
            h = self._workers.get(lease.wid)
            if h is not None:
                h.inflight_rows = max(h.inflight_rows - lease.rows, 0)
        lease.event.set()

    # -- placement ---------------------------------------------------------
    def _pick_worker(self, exclude: Tuple[int, ...] = ()) -> int:
        """Least-loaded live worker for a new trunk replica: fewest
        staged bytes (Eq. 7 pressure), then fewest in-flight rows."""
        alive = [h for h in self._workers.values()
                 if h.alive and h.wid not in exclude]
        if not alive:
            raise RuntimeError("no live dispatch workers")
        return min(alive, key=lambda h: (h.staged_bytes,
                                         h.inflight_rows, h.wid)).wid

    def _stage_on(self, wid: int, task: str) -> None:
        """Synchronous stage handshake: ship the task spec + model_id,
        wait for the worker's staged ack, record the staging bytes."""
        rm = self.session.models[task]
        h = self._workers[wid]
        with h.stage_lock:
            if task in h.staged_tasks:
                return
            spec = self.session.registry.get(task)
            h.cmd_q.put(("stage", task, rm.model_id, spec,
                         int(rm.in_dim or 1), rm.load_mode))
            msg = self._mail.wait(("staged", wid, task),
                                  self.placement.stage_timeout_s,
                                  alive=lambda: h.alive)
            if msg is None:
                raise RuntimeError(
                    f"worker {wid} did not acknowledge staging task "
                    f"{task!r} (dead or wedged)")
            if msg[3] is not None:
                raise RuntimeError(
                    f"worker {wid} failed to stage task {task!r}: "
                    f"{msg[3]}")
            with self._place_lock:
                h.staged_tasks.add(task)
                trunk = rm.trunk_fp or rm.version
                # the shared trunk's bytes count once per (worker,
                # trunk); each fine-tune adds only its delta bytes
                trunk_bytes = max(int(rm.stored_bytes) -
                                  int(rm.delta_bytes), 0)
                prev = h.trunks.get(trunk, 0)
                h.trunks[trunk] = max(prev, trunk_bytes)
                if rm.is_delta and rm.delta_bytes:
                    h.delta_bytes[task] = int(rm.delta_bytes)

    def _add_replica(self, trunk: str,
                     exclude: Tuple[int, ...] = ()) -> int:
        """Stage every task riding ``trunk`` onto a fresh worker and
        register it as a replica. Returns the worker id."""
        with self._place_lock:
            pl = self._placements.setdefault(
                trunk, _TrunkPlacement(trunk=trunk,
                                       last_active=time.time()))
            tasks = sorted(pl.tasks)
            exclude = tuple(exclude) + tuple(pl.replicas)
        wid = self._pick_worker(exclude=exclude)
        for task in tasks:
            self._stage_on(wid, task)
        with self._place_lock:
            if wid not in pl.replicas:
                pl.replicas.append(wid)
        return wid

    def _ensure_placed(self, trunk: str, task: str) -> None:
        """First-touch placement: a trunk starts on exactly one worker
        (K fine-tunes of one base share that worker's embed lane until
        load justifies replication)."""
        with self._place_lock:
            pl = self._placements.setdefault(
                trunk, _TrunkPlacement(trunk=trunk,
                                       last_active=time.time()))
            pl.tasks.add(task)
            replicas = [w for w in pl.replicas if self._workers[w].alive]
            need: List[int] = [w for w in replicas
                               if task not in
                               self._workers[w].staged_tasks]
            fresh = not replicas
        if fresh:
            self._add_replica(trunk)
        else:
            for wid in need:
                self._stage_on(wid, task)

    def _scale_out_pays(self, trunk: str, backlog_rows: int,
                        replicas: int) -> bool:
        """Eq. 7 vs Eq. 10/11 on the worker's calibrated profile: does
        splitting the backlog over one more replica save more drain time
        than staging the trunk there costs?"""
        if not self.placement.cost_gated:
            return True
        with self._place_lock:
            pl = self._placements.get(trunk)
            task = next(iter(pl.tasks)) if pl and pl.tasks else None
        rm = self.session.models.get(task) if task else None
        if rm is None:
            return True
        hw = None
        for h in self._workers.values():   # workers are homogeneous
            if h.alive and h.hw:
                hw = h.hw
                break
        drain = exec_time(rm.profile, int(backlog_rows), "host", hw)
        gain = drain * (1.0 / max(replicas, 1) - 1.0 / (replicas + 1))
        stage = trans_cost(rm.profile, 0, "host", hw)
        return gain > stage + self.placement.min_gain_s

    def _maybe_scale_out(self, trunk: str, lane: _FrontLane) -> None:
        backlog = lane.batcher.queued_units
        if backlog < max(self.placement.watermark_rows, 1):
            return
        with self._place_lock:
            pl = self._placements.get(trunk)
            if pl is None:
                return
            live = [w for w in pl.replicas if self._workers[w].alive]
            alive_total = sum(1 for h in self._workers.values() if h.alive)
            cap = self.placement.max_replicas or alive_total
            if not live or len(live) >= min(cap, alive_total):
                return
            if pl.scaling:            # one scale-out in flight per trunk:
                return                # concurrent submits must not stack
            pl.scaling = True
            replicas = len(live)
        try:
            if not self._scale_out_pays(trunk, backlog, replicas):
                return
            try:
                self._add_replica(trunk)
            except RuntimeError:
                return                # no spare live worker: stay put
            with self._lock:
                self._scale_outs += 1
        finally:
            with self._place_lock:
                pl.scaling = False

    def _maybe_scale_in(self, now: float) -> None:
        with self._place_lock:
            placements = list(self._placements.values())
        for pl in placements:
            with self._place_lock:
                live = [w for w in pl.replicas if self._workers[w].alive]
                idle_for = now - pl.last_active
            if len(live) <= 1:
                continue
            if idle_for < self.placement.idle_scale_in_s:
                continue
            lane = self._lanes.get(pl.trunk)
            if lane is not None and (lane.batcher.queued_units or
                                     lane.batcher.pending):
                continue
            with self._lock:
                outstanding = any(ls.trunk == pl.trunk and not ls.done
                                  for ls in self._leases.values())
            if outstanding:
                continue
            for wid in live[1:]:     # drain back to a single replica
                self._unstage_on(wid, pl)

    def _unstage_on(self, wid: int, pl: _TrunkPlacement) -> None:
        h = self._workers[wid]
        with self._place_lock:
            tasks = sorted(pl.tasks)
        try:
            h.cmd_q.put(("unstage", pl.trunk, tasks))
        except Exception:
            return
        self._mail.wait(("unstaged", wid, pl.trunk),
                        self.placement.stage_timeout_s,
                        alive=lambda: h.alive)
        with self._place_lock:
            if wid in pl.replicas:
                pl.replicas.remove(wid)
            for task in tasks:
                h.staged_tasks.discard(task)
                h.delta_bytes.pop(task, None)
            h.trunks.pop(pl.trunk, None)
        with self._lock:
            self._scale_ins += 1

    def prestage(self, task: str,
                 replicas: Optional[int] = None) -> List[int]:
        """Explicitly stage a resolved task's trunk on ``replicas``
        workers (default: all live ones) ahead of traffic — the warm
        path benchmarks and latency-critical deployments use to skip
        the organic watermark ramp. Returns the replica worker ids."""
        rm = self.session.models[task]
        trunk = rm.trunk_fp or rm.version
        self._ensure_placed(trunk, task)
        want = (sum(1 for h in self._workers.values() if h.alive)
                if replicas is None else int(replicas))
        while True:
            with self._place_lock:
                pl = self._placements[trunk]
                have = [w for w in pl.replicas if self._workers[w].alive]
            if len(have) >= want:
                return have
            try:
                self._add_replica(trunk)
            except RuntimeError:
                return have

    # -- front lanes -------------------------------------------------------
    def _front_step(self, key: str):
        def step(payloads: List[tuple]) -> List[Any]:
            with self._place_lock:
                pl = self._placements.get(key)
                if pl is not None:
                    pl.last_active = time.time()
                replicas = [w for w in (pl.replicas if pl else [])
                            if self._workers[w].alive]
            if not replicas:
                replicas = [self._add_replica(key)]
            parts = self._split(payloads, len(replicas))
            leases = []
            for wid, sub in zip(replicas, parts):
                if sub:
                    leases.append(self._dispatch(key, wid, sub))
            deadline = time.time() + self.lease_timeout_s
            for lease in leases:
                if not lease.event.wait(
                        max(deadline - time.time(), 0.001)):
                    self._fail_lease(lease, TimeoutError(
                        f"lease {lease.lease_id} on trunk {key} "
                        f"unanswered after {self.lease_timeout_s}s"))
            out_of: Dict[int, Any] = {}
            for lease in leases:
                for item, slot in zip(lease.items, lease.slots):
                    status, value = slot
                    out_of[item[0]] = value
            return [out_of[p[0]] for p in payloads]
        return step

    @staticmethod
    def _split(payloads: List[tuple], n: int) -> List[List[tuple]]:
        """Row-balanced partition of a coalesced batch across replicas
        (largest requests placed first onto the lightest part)."""
        parts: List[List[tuple]] = [[] for _ in range(n)]
        load = [0] * n
        for p in sorted(payloads, key=lambda p: -len(p[2])):
            i = load.index(min(load))
            parts[i].append(p)
            load[i] += max(len(p[2]), 1)
        return parts

    def _dispatch(self, trunk: str, wid: int, items: List[tuple]) -> _Lease:
        lease = _Lease(lease_id=next(self._lease_ids), wid=wid,
                       trunk=trunk, items=items,
                       rows=sum(len(p[2]) for p in items))
        with self._lock:
            self._leases[lease.lease_id] = lease
            self._lease_count += 1
            self._workers[wid].inflight_rows += lease.rows
        self._workers[wid].cmd_q.put(("batch", lease.lease_id, items))
        return lease

    def _front_lane(self, task: str) -> _FrontLane:
        rm = self.session.models[task]
        key = rm.trunk_fp or rm.version
        lane = self._lanes.get(key)
        if lane is None:
            with self._lock:
                lane = self._lanes.get(key)
                if lane is None:
                    embed_prof, _ = split_profile(rm.profile, rm.head_dim)
                    rows = choose_batch_size(
                        embed_prof, "host",
                        candidates=_LANE_BATCH_CANDIDATES,
                        mem_cap_bytes=self.mem_cap_bytes,
                        hw=self.session.hw)
                    # the front lane feeds every replica: scale the
                    # Eq. 11 budget by the worker count so one coalesced
                    # batch can saturate the whole tier
                    rows = int(rows) * max(self.workers_requested, 1)
                    lane = _FrontLane(
                        key=key, batch_rows=rows,
                        batcher=ContinuousBatcher(
                            self._front_step(key), batch_size=rows,
                            max_wait_s=self.max_wait_s,
                            idle_wait_s=self.idle_wait_s,
                            size_of=_payload_rows,
                            name=f"dispatch:{key}", policy=self.policy))
                    if self._running:
                        lane.batcher.start()
                    self._lanes[key] = lane
        self._lane_of_task[task] = lane
        self._ensure_placed(key, task)
        return lane

    # -- request surface ---------------------------------------------------
    def resolve_task(self, name: str, X, y, **kw) -> None:
        """Resolve into the *shared* store (workers stage from it)."""
        with self._lock:
            if name not in self.session.models:
                self.session.resolve_task(name, X, y, **kw)

    def submit(self, sql: str,
               sample: Optional[Tuple[np.ndarray, np.ndarray]] = None, *,
               priority: str = "batch",
               deadline_ms: Optional[float] = None) -> int:
        """Admit one PREDICT statement (same contract as
        :meth:`MorphingServer.submit`: snapshot at admission, typed
        ``Rejected``/``CircuitOpen`` backpressure from the front lane).
        Crossing the placement watermark may scale the task's trunk out
        to another worker before this call returns."""
        validate_priority(priority)
        task, col, table, preds = self._parse_predict(sql)
        if task not in self.session.models:
            if not self._running:
                raise RuntimeError("server not started: call start() or "
                                   "use 'with server:'")
            if sample is None:
                raise RuntimeError(
                    f"task {task} unresolved and no sample given")
            self.resolve_task(task, *sample)
        return self.submit_rows(task, self._rows_for(table, col, preds),
                                priority=priority, deadline_ms=deadline_ms)

    def submit_rows(self, task: str, X: np.ndarray, *,
                    priority: str = "batch",
                    deadline_ms: Optional[float] = None) -> int:
        validate_priority(priority)
        if not self._running:
            raise RuntimeError(
                "server not started: call start() or use 'with server:'")
        if task not in self.session.models:
            raise RuntimeError(
                f"task {task} unresolved; resolve_task() it first")
        X = np.asarray(X)
        lane = self._front_lane(task)
        lane.batcher.reset_breaker()
        req_id = next(self._ids)
        lane.batcher.submit(Request(
            req_id, (req_id, task, X, priority, deadline_ms),
            priority=priority,
            deadline_s=(deadline_ms / 1000.0
                        if deadline_ms is not None else None)))
        self._task_of[req_id] = task
        with self._lock:
            self._requests += 1
        rm = self.session.models[task]
        self._maybe_scale_out(rm.trunk_fp or rm.version, lane)
        return req_id

    def result(self, req_id: int,
               timeout: Optional[float] = None) -> ServeResult:
        """Block for the request's scores. Worker-side failures surface
        here with their original typed exception (Rejected /
        RequestError / CircuitOpen cross the process boundary with
        fields intact)."""
        task = self._task_of[req_id]
        lane = self._lane_of_task[task]
        try:
            out = lane.batcher.result(req_id, timeout=timeout,
                                      evict=False)
            latency = lane.batcher.latency(req_id)
        except TimeoutError:
            raise
        except BaseException:
            lane.batcher.evict(req_id)
            self._task_of.pop(req_id, None)
            raise
        lane.batcher.evict(req_id)
        self._task_of.pop(req_id, None)
        if isinstance(out, BaseException):
            raise out
        scores = np.asarray(out)
        with self._lock:
            self._rows_served += len(scores)
        return ServeResult(req_id=req_id, task=task, scores=scores,
                           rows=len(scores), latency_s=latency)

    def predict(self, sql: str,
                sample: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                timeout: Optional[float] = None, *,
                priority: str = "batch",
                deadline_ms: Optional[float] = None) -> ServeResult:
        return self.result(self.submit(sql, sample=sample,
                                       priority=priority,
                                       deadline_ms=deadline_ms),
                           timeout=timeout)

    # -- telemetry ---------------------------------------------------------
    def stats(self, timeout: float = 10.0) -> DispatchStats:
        """Aggregate the tier: dispatch counters + per-worker
        ``ServerStats`` (dead workers contribute their last report)."""
        st = DispatchStats()
        with self._lock:
            handles = list(self._workers.values())
            st.workers = len(handles)
            st.requests = self._requests
            st.rows = self._rows_served
            st.leases = self._lease_count
            st.redispatches = self._redispatches
            st.duplicates_dropped = self._dup_dropped
            st.worker_deaths = self._worker_deaths
            st.scale_outs = self._scale_outs
            st.scale_ins = self._scale_ins
            lanes = list(self._lanes.values())
        for h in handles:
            if h.alive:
                try:
                    h.cmd_q.put(("stats",))
                except Exception:
                    pass
        for h in handles:
            if h.alive:
                msg = self._mail.wait(("stats", h.wid), timeout,
                                      alive=lambda h=h: h.alive)
                if msg is not None:
                    h.last_stats = msg[2]
                st.alive_workers += 1
            st.staged_bytes_by_worker[h.wid] = h.staged_bytes
            st.trunks_by_worker[h.wid] = sorted(h.trunks)
            ws = h.last_stats
            if ws is not None:
                st.per_worker[h.wid] = ws
                st.worker_rows += ws.rows
                st.infer_seconds += ws.infer_seconds
                st.share_hits += ws.share_hits
                st.share_misses += ws.share_misses
                st.approx_hits += ws.approx_hits
                st.dedup_rows += ws.dedup_rows
                st.embed_rows += ws.embed_rows
                st.retries += ws.retries
                st.failed_batches += ws.failed_batches
                st.breaker_open_lanes.extend(
                    f"w{h.wid}:{k}" for k in ws.breaker_open_lanes)
        with self._place_lock:
            for trunk, pl in self._placements.items():
                st.replicas_by_trunk[trunk] = sum(
                    1 for w in pl.replicas if self._workers[w].alive)
        lat: List[float] = []
        for lane in lanes:
            lane_lat, _ = lane.batcher.telemetry()
            lat.extend(lane_lat)
            st.rejected += lane.batcher.health()["rejected"]
        if lat:
            st.p50_latency_s = float(np.percentile(lat, 50))
            st.p95_latency_s = float(np.percentile(lat, 95))
        return st

    def health(self) -> Dict[str, Dict]:
        """Front-lane health (same schema as ``MorphingServer.health``,
        keyed ``lane:<trunk>``) plus per-worker liveness rows."""
        out: Dict[str, Dict] = {}
        with self._lock:
            lanes = list(self._lanes.items())
        for key, lane in lanes:
            out[f"lane:{key}"] = lane.batcher.health()
        now = time.time()
        for wid, h in self._workers.items():
            out[f"worker:{wid}"] = {
                "alive": bool(h.alive and h.proc.is_alive()),
                "pid": h.proc.pid,
                "heartbeat_age_s": ((now - h.last_hb)
                                    if h.last_hb else None),
                "staged_trunks": sorted(h.trunks),
                "staged_tasks": sorted(h.staged_tasks),
                "inflight_rows": h.inflight_rows,
                "errors": list(h.errors),
            }
        return out

    def reset_telemetry(self) -> None:
        """Clear latency windows + rate counters on the front lanes and
        every live worker (placement/failover counters are retained)."""
        with self._lock:
            lanes = list(self._lanes.values())
            self._requests = 0
            self._rows_served = 0
        for lane in lanes:
            lane.batcher.reset_telemetry()
        for h in self._workers.values():
            if h.alive:
                try:
                    h.cmd_q.put(("reset",))
                except Exception:
                    pass

    # -- chaos hooks -------------------------------------------------------
    def inject_fault(self, wid: int,
                     fault_kw: Optional[dict]) -> None:
        """Arm (or clear, with None) a ``FaultInjector`` on one worker's
        backends — the test/chaos-bench hook for exercising worker-side
        retry and failover without killing the process."""
        h = self._workers[wid]
        h.cmd_q.put(("fault", fault_kw))
        self._mail.wait(("fault_set", wid), 10.0, alive=lambda: h.alive)

    def kill_worker(self, wid: int) -> None:
        """Hard-kill one worker process (failover tests: SIGTERM, no
        drain). The monitor declares it dead and re-dispatches its
        leases to survivors."""
        h = self._workers[wid]
        h.proc.terminate()
