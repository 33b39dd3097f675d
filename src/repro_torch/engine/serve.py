"""MorphingServer: the share-aware continuous-batching serving path.

Paper cross-reference: lane row budgets are Eq. 11 batch-size selection
applied per stage (``cost.split_profile`` sizes the trunk's embed budget
and the head's much larger budget separately), and the one-time weight
staging per trunk lane is exactly the amortization TransCost (Eq. 7)
assumes — including its delta-aware form, where a fleet of fine-tunes
sharing one base trunk stages it once. Field-by-field telemetry
reference: ``docs/serving.md``.

Batch analytics (``MorphingSession.sql``) plans one big query; the online
regime is many small concurrent ``PREDICT ... USING TASK`` requests
arriving inside the DBMS. The optimizer's biggest throughput lever — the
embed/head split with vector sharing (paper §5.1) — lives inside the
server too: lanes are keyed by *trunk*, not task, and split every request
into a share-cached embed stage plus a cheap per-task head stage. Because
the lane key is ``ResolvedModel.trunk_fp`` — the *resolved layer-path*
identity — K fine-tune deltas of one base model land in their base
trunk's embed lane automatically: one trunk forward (staged once, under
the trunk fingerprint) feeds K cheap delta-composed head stages
(``ExecutionBackend.run_head``), and ``ServerStats`` reports the fleet's
delta task count and byte accounting.

- admission goes through a long-running :class:`ContinuousBatcher` per
  trunk lane (start/submit/result/stop, results condition variable,
  drain-on-stop); tasks whose resolved models share a trunk fingerprint
  (``ResolvedModel.trunk_fp``, tracked by the DecoupledStore layer-tensor
  identity) feed one lane;
- a lane's coalesced batch consults the :class:`VectorShareCache` first
  through the batched row-granular API (``get_many`` — one vectorized
  fingerprint pass over the whole chunk), so warm rows cost a gather,
  not a forward pass;
- identical in-flight rows are single-flight deduplicated: each lane has
  one worker, batches serialize, and within a batch only the *unique*
  missing rows run through the trunk (``ServerStats.dedup_rows`` counts
  the folded duplicates); results write back via ``put_many`` before the
  next batch collects, so N concurrent identical requests compute one
  embedding;
- row budgets come from Eq. 11 sized per stage (``cost.split_profile``):
  the embed lane batches to the trunk's budget, the head stage to its
  own (much larger) budget, executed through the backend's head-only
  entry point (``ExecutionBackend.run_head``);
- resolution rides the session's partial-load path: on a decoupled
  store, a head-mode task's trunk stays on disk while the share cache
  keeps hitting.

    server = MorphingServer(session=sess).start()
    rid = server.submit("PREDICT emb USING TASK sent FROM reviews "
                        "WHERE len > 20")
    out = server.result(rid)          # ServeResult: scores + latency
    server.stats().share_hit_rate
    server.stop()                     # drains the queues, joins workers

``share_lanes=False`` restores the per-task full-predict lanes (the
ablation baseline ``benchmarks/bench_serving.py`` measures against).

Port of ``src/repro/engine/serve.py``. Lanes are placed by Eq. 10 over
the session's devices, ``("host", "cuda")`` by default; a trunk lane on
``"cuda"`` runs the session's ``TorchBackend``, so a linear-mode trunk
embeds through the CUDA ``fused_embed``. Each lane's batcher steps on its
own thread; the device->host copy at the end of ``run_infer`` is where a
step waits for the card, and lanes hand numpy back to callers.
"""
from __future__ import annotations

import itertools
import threading
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.zoo import adapt_input_width
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.session import MorphingSession
from repro_torch.engine.sql import QueryStmt, parse
from repro_torch.engine.plan import _make_pred
from repro_torch.pipeline.admission import (AdmissionPolicy, CircuitOpen,
                                      PRIORITIES, validate_priority)
from repro_torch.pipeline.backend import (ExecutionBackend, InferSpec,
                                    default_host_backend)
from repro_torch.pipeline.batcher import BatcherStats, ContinuousBatcher, Request
from repro_torch.pipeline.cost import (choose_batch_size, choose_device,
                                 split_profile)

# Eq. 11 candidates for the serving row budgets: lanes coalesce many
# requests, so the sweep extends past the per-operator 8-128 window.
_LANE_BATCH_CANDIDATES = (32, 64, 128, 256, 512, 1024, 2048, 4096)
# the serving row cache is content-addressed per trunk, not per table:
# identical rows from different requests/tables share one entry
_SHARE_TABLE = "__serve__"


@dataclass
class ServeResult:
    """One served PREDICT request."""
    req_id: int
    task: str
    scores: np.ndarray
    rows: int
    latency_s: float


@dataclass
class ServerStats:
    """Aggregate serving telemetry across all trunk lanes."""
    requests: int = 0
    rows: int = 0                    # rows served (scored by a head)
    batches: int = 0
    requests_by_task: Dict[str, int] = field(default_factory=dict)
    mean_coalesced: float = 0.0      # requests fused per executed batch
    p50_latency_s: float = 0.0
    p95_latency_s: float = 0.0
    max_latency_s: float = 0.0
    infer_seconds: float = 0.0       # embed + head compute seconds
    loaded_bytes: int = 0            # model bytes read from disk
    stored_bytes: int = 0            # model bytes held by the store
    # share-aware serving: the embed/head split inside the lanes
    share_hits: int = 0              # embed rows served exactly from cache
    share_misses: int = 0            # embed rows not in cache (pre-dedup)
    approx_hits: int = 0             # embed rows served by the ANN tier
    #                                # (nearest cached neighbor within the
    #                                # calibrated radius, not byte-equal)
    false_accepts: int = 0           # audited approx hits whose exact
    #                                # recomputation exceeded the bound
    dedup_rows: int = 0              # in-flight duplicates folded away
    embed_rows: int = 0              # rows actually run through a trunk
    embed_batches: int = 0
    head_rows: int = 0               # rows scored by per-task head stages
    head_batches: int = 0
    share_hit_rate_by_lane: Dict[str, float] = field(default_factory=dict)
    # fine-tune delta serving: tasks whose resolved model is a delta
    # variant (ResolvedModel.base_model_id) riding a shared trunk lane
    lanes: int = 0                   # live embed/predict lanes
    tasks_by_lane: Dict[str, int] = field(default_factory=dict)
    # mesh dimension: how many devices the trunk embed lanes span, and
    # the measured aggregate embed rate across them (rows the trunks
    # actually computed / their wall seconds — share hits excluded)
    devices: int = 1
    mesh_rows_per_s: float = 0.0
    delta_tasks: int = 0             # served tasks that are fine-tunes
    delta_loaded_bytes: int = 0      # disk bytes their resolutions read
    #                                # (≈ K·delta when the base is warm)
    delta_stored_bytes: int = 0      # their delta layers' bytes on disk
    # storage-compression gauges (session-lifetime DecoupledStore stats;
    # docs/architecture.md "Compressed deltas & tensor-page dedup")
    dedup_pages: int = 0             # page writes elided by content dedup
    dedup_bytes_saved: int = 0       # bytes those elided writes would cost
    compressed_delta_bytes: int = 0  # on-disk bytes of compressed deltas
    quant_error_bound: float = 0.0   # max declared quant bound in play
    # admission / robustness layer (populated when the server carries an
    # AdmissionPolicy; zeros otherwise) — docs/serving.md "Admission &
    # SLOs" documents every field
    rejected: int = 0                # submits pushed back (Rejected)
    rejected_by_priority: Dict[str, int] = field(default_factory=dict)
    retries: int = 0                 # transient-failure batch retries
    failed_batches: int = 0          # batches that failed after retries
    deadline_misses: int = 0         # served past their deadline_ms
    deadlines_admitted: int = 0      # requests admitted with a deadline
    breaker_trips: int = 0           # lane breakers tripped open
    breaker_resets: int = 0          # supervisor breaker resets
    breaker_open_lanes: List[str] = field(default_factory=list)
    p50_latency_s_by_priority: Dict[str, float] = field(
        default_factory=dict)
    p95_latency_s_by_priority: Dict[str, float] = field(
        default_factory=dict)
    batch_rows_by_lane: Dict[str, int] = field(default_factory=dict)
    budget_shrinks: int = 0          # dynamic-budget shrink events
    budget_grows: int = 0            # dynamic-budget regrow events

    @property
    def rows_per_second(self) -> float:
        return self.rows / self.infer_seconds if self.infer_seconds else 0.0

    @property
    def share_hit_rate(self) -> float:
        """Cache-served fraction of embed rows — exact and approximate
        hits both spared a trunk forward."""
        hits = self.share_hits + self.approx_hits
        t = hits + self.share_misses
        return hits / t if t else 0.0

    @property
    def dedup_rate(self) -> float:
        """Fraction of would-be trunk rows eliminated by single-flight
        dedup of identical in-flight rows."""
        t = self.dedup_rows + self.embed_rows
        return self.dedup_rows / t if t else 0.0


@dataclass
class _HeadStage:
    """Per-task head stage: consumes embeddings at its own Eq. 11 row
    budget (``spec.batch_size``) through the backend's head-only entry
    point, which owns the slicing and the stats accumulation."""
    task: str
    spec: InferSpec                  # kind='head'; stats = head telemetry
    backend: ExecutionBackend
    batch_rows: int

    def run(self, F: np.ndarray) -> np.ndarray:
        return self.backend.run_head(self.spec, F)


@dataclass
class _Lane:
    """One serving lane: a batcher plus the embed/head stage specs.

    With share lanes the key is the trunk fingerprint and ``heads`` maps
    every task feeding the lane to its head stage; in legacy mode the
    key is the task and ``spec`` executes the fused full predict.
    """
    key: str
    device: str
    batcher: ContinuousBatcher
    spec: InferSpec                  # embed spec (share) / predict (legacy)
    batch_rows: int                  # Eq. 11 embed (or predict) row budget
    heads: Dict[str, _HeadStage] = field(default_factory=dict)
    in_dim: int = 0                  # trunk input width (0 = adapt per batch)
    requests_by_task: Dict[str, int] = field(default_factory=dict)
    # share counters are written by the single lane worker and read by
    # stats() under the lane lock
    lock: threading.Lock = field(default_factory=threading.Lock)
    share_hits: int = 0
    share_misses: int = 0
    approx_hits: int = 0
    false_accepts: int = 0
    dedup_rows: int = 0

    @property
    def requests(self) -> int:
        return sum(self.requests_by_task.values())


class MorphingServer:
    """Concurrent PREDICT requests -> share-aware continuous batching.

    Wraps a :class:`MorphingSession` (constructing one from ``**session_kw``
    when not given — the session auto-calibrates unless opted out, so
    lane batch sizes come from measured hardware profiles). The server
    only accepts ``PREDICT col USING TASK t FROM table [WHERE ...]``
    statements; analytics SQL belongs on ``session.sql``.
    """

    def __init__(self, session: Optional[MorphingSession] = None, *,
                 config: Optional[EngineConfig] = None,
                 max_wait_s: float = 0.002, idle_wait_s: float = 0.05,
                 mem_cap_bytes: float = 2e9, nrows_hint: int = 2048,
                 share_lanes: bool = True, devices: Optional[int] = None,
                 stop_timeout_s: float = 30.0,
                 policy: Optional[AdmissionPolicy] = None, **session_kw):
        if devices is not None:
            warnings.warn(
                "MorphingServer(devices=...) is deprecated; pass "
                "config=EngineConfig(device_count=...) (shared with "
                "MorphingSession) instead", DeprecationWarning,
                stacklevel=2)
        if session is None:
            if devices is not None:
                session_kw.setdefault("device_count", devices)
            session = MorphingSession(config=config, **session_kw)
        elif devices is not None and devices != getattr(
                session, "device_count", 1):
            raise ValueError(
                f"devices={devices} conflicts with the session's backend "
                f"pool ({getattr(session, 'device_count', 1)} devices); "
                "construct the session with device_count instead")
        self.session = session
        # effective mesh width of the session's backend pool (clamped to
        # real devices): trunk embed lanes size their Eq. 11 row budgets
        # against this many devices' aggregate throughput
        self.devices = getattr(session, "device_count", 1)
        self.max_wait_s = max_wait_s
        self.idle_wait_s = idle_wait_s
        self.mem_cap_bytes = mem_cap_bytes
        self.nrows_hint = nrows_hint
        self.share_lanes = share_lanes
        self.stop_timeout_s = stop_timeout_s
        # admission policy is applied to every lane; None keeps the
        # legacy unbounded FIFO lanes. The shared EngineConfig is the
        # canonical source (explicit policy= overrides it).
        if policy is None:
            src = config or getattr(session, "config", None)
            policy = src.policy if src is not None else None
        self.policy = policy
        # decoupled-store trunk pins held for the active lanes (released
        # on stop): the layer-cache LRU never evicts a trunk a live
        # embed lane would immediately re-read
        self._pins: List[str] = []
        self._lanes: Dict[str, _Lane] = {}
        self._lane_of_task: Dict[str, _Lane] = {}
        self._task_of: Dict[int, str] = {}
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._running = False

    # -- lifecycle ---------------------------------------------------------
    def _pin_task(self, rm) -> None:
        """Pin a served task's trunk layers in the decoupled store so the
        byte-capped layer cache evicts around them (must be called with
        ``self._lock`` held; refcounted, released on :meth:`stop`)."""
        if rm.store != "decoupled":
            return
        try:
            self.session.dstore.pin_model(rm.model_id)
        except KeyError:
            return                   # not in this store's catalog
        self._pins.append(rm.model_id)

    def start(self) -> "MorphingServer":
        with self._lock:
            if self._running:
                raise RuntimeError("server already started")
            self._running = True
            for lane in self._lanes.values():
                # a restart re-pins the lanes' trunks (stop released them)
                for task in lane.requests_by_task:
                    rm = self.session.models.get(task)
                    if rm is not None:
                        self._pin_task(rm)
                lane.batcher.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop every lane. With ``drain`` (default) queued requests are
        served before the workers join — including their share-cache
        write-backs; otherwise they are dropped and their ``result()``
        calls raise.

        Workers are joined with a per-lane ``timeout`` (default
        ``stop_timeout_s``); a worker stuck in a step — a wedged backend,
        a deadlocked kernel — surfaces as a RuntimeError naming the
        stuck lanes instead of hanging the shutdown forever. The stuck
        workers stay daemon threads; a later ``stop()`` retries the
        join."""
        with self._lock:
            was_running = self._running
            self._running = False
            lanes = list(self._lanes.values())
        if not was_running and all(lane.batcher._thread is None
                                   for lane in lanes):
            return          # nothing left to join: idempotent stop
        # not-running but with live workers = a prior stop() timed out
        # on a wedged lane; fall through so this call retries the joins
        timeout = self.stop_timeout_s if timeout is None else timeout
        stuck: List[str] = []
        try:
            for lane in lanes:
                try:
                    lane.batcher.stop(drain=drain, timeout=timeout)
                except TimeoutError:
                    stuck.append(lane.key)
        finally:
            # release the trunk pins: a stopped server's lanes no longer
            # defend their trunks against layer-cache eviction
            with self._lock:
                pins, self._pins = self._pins, []
            for mid in pins:
                self.session.dstore.unpin_model(mid)
        if stuck:
            raise RuntimeError(
                f"serving lane worker(s) did not join within {timeout}s: "
                f"{stuck}; their step functions are still running "
                "(wedged backend?) — results for their pending requests "
                "will not arrive")

    def unstage_trunk(self, key: str, *,
                      timeout: Optional[float] = None) -> bool:
        """Tear down one trunk lane (the dispatch tier's scale-in path):
        drain and join its batcher, release the member tasks' store
        pins, and evict the staged weights from every backend. The tasks
        stay resolved — the next submit for one of them rebuilds the
        lane, re-staging the trunk (Eq. 7 paid again, by design).
        Returns False when no lane with that key exists. Callers should
        quiesce traffic for the trunk first; the drain serves whatever
        is still queued."""
        with self._lock:
            lane = self._lanes.pop(key, None)
            if lane is None:
                return False
            tasks = [t for t, ln in list(self._lane_of_task.items())
                     if ln is lane]
            for t in tasks:
                self._lane_of_task.pop(t, None)
        lane.batcher.stop(drain=True,
                          timeout=(self.stop_timeout_s
                                   if timeout is None else timeout))
        for b in {id(b): b for b in
                  self.session.backends.values()}.values():
            b.unstage(lane.spec.version)
        with self._lock:
            for t in tasks:
                rm = self.session.models.get(t)
                if rm is not None and rm.model_id in self._pins:
                    self._pins.remove(rm.model_id)
                    self.session.dstore.unpin_model(rm.model_id)
        return True

    def __enter__(self) -> "MorphingServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- request admission -------------------------------------------------
    def _parse_predict(self, sql: str) -> Tuple[str, str, str, list]:
        stmt = parse(sql)
        ops = stmt.plan.ops() if isinstance(stmt, QueryStmt) else []
        if ops not in (["scan", "predict"], ["scan", "predict", "filter"]):
            raise ValueError(
                "MorphingServer serves PREDICT ... USING TASK statements; "
                "run analytics SQL through MorphingSession.sql")
        pred = next(n for n in stmt.plan.nodes if n.op == "predict")
        preds = [p for n in stmt.plan.nodes if n.op == "filter"
                 for p in n.args["preds"]]
        return pred.args["task"], pred.args["col"], stmt.plan.table, preds

    def _rows_for(self, table: str, col: str, preds: list) -> np.ndarray:
        tab = self.session.tables[table]
        X = np.asarray(tab[col])
        if preds:
            X = X[_make_pred(preds)(tab)]
        return X

    # -- lane construction -------------------------------------------------
    def _head_stage(self, task: str, rm, backend) -> _HeadStage:
        _, head_prof = split_profile(rm.profile, rm.head_dim)
        head_rows = choose_batch_size(
            head_prof, "host", candidates=_LANE_BATCH_CANDIDATES,
            mem_cap_bytes=self.mem_cap_bytes, hw=self.session.hw)
        spec = InferSpec(kind="head", task=task, col="f", out="y",
                         table=_SHARE_TABLE, version=rm.version, model=rm,
                         batch_size=head_rows, share=None,
                         stats=BatcherStats())
        return _HeadStage(task=task, spec=spec, backend=backend,
                          batch_rows=head_rows)

    def _lane_for(self, task: str) -> _Lane:
        sess = self.session
        rm = sess.models[task]
        key = ((rm.trunk_fp or rm.version) if self.share_lanes else task)
        lane = self._lanes.get(key)
        if lane is not None and task in lane.requests_by_task:
            return lane
        with self._lock:
            lane = self._lanes.get(key)
            if lane is None:
                lane = self._build_lane(key, rm)
                if self._running:
                    lane.batcher.start()
                self._lanes[key] = lane
            if task not in lane.requests_by_task:
                # active lanes pin their trunks in the decoupled layer
                # cache (a fine-tune joining a shared lane pins the base
                # trunk its references resolve to)
                self._pin_task(rm)
                # a second task joining an existing trunk lane only needs
                # its own head stage; the trunk work is shared. Mutations
                # go under the lane lock: stats()/reset_telemetry()
                # iterate these dicts while traffic registers new tasks
                if self.share_lanes and task not in lane.heads:
                    backend = (sess.backends.get(lane.device)
                               or default_host_backend())
                    stage = self._head_stage(task, rm, backend)
                    with lane.lock:
                        lane.heads[task] = stage
                with lane.lock:
                    lane.requests_by_task.setdefault(task, 0)
            self._lane_of_task[task] = lane
            return lane

    def _build_lane(self, key: str, rm) -> _Lane:
        sess = self.session
        device = choose_device(rm.profile, self.nrows_hint,
                               sess.devices, sess.hw)
        backend = sess.backends.get(device) or default_host_backend()
        if not self.share_lanes:
            batch_rows = choose_batch_size(
                rm.profile, device, candidates=_LANE_BATCH_CANDIDATES,
                mem_cap_bytes=self.mem_cap_bytes, hw=sess.hw)
            # staging identity is the trunk fingerprint here too (the
            # session staged weights under it): the per-task ablation
            # lanes must not re-stage a duplicate trunk per task
            spec = InferSpec(
                kind="predict", task=rm.task, col="x", out="y",
                table=_SHARE_TABLE, version=(rm.trunk_fp or rm.version),
                model=rm, batch_size=batch_rows, share=None,
                stats=BatcherStats())
            lane = _Lane(key=key, device=device, batcher=None,  # type: ignore
                         spec=spec, batch_rows=batch_rows)
            step = self._legacy_step(lane, backend)
        else:
            embed_prof, _ = split_profile(rm.profile, rm.head_dim)
            batch_rows = choose_batch_size(
                embed_prof, device, candidates=_LANE_BATCH_CANDIDATES,
                mem_cap_bytes=self.mem_cap_bytes, hw=sess.hw)
            # mesh lanes budget against aggregate throughput: each of the
            # N devices takes batch/N rows, so the Eq. 11 optimum for one
            # device scales to N devices at the same per-device latency
            # and memory footprint (capped at the candidate ceiling)
            n_dev = int(getattr(backend, "device_count", 1))
            if n_dev > 1:
                batch_rows = min(batch_rows * n_dev,
                                 _LANE_BATCH_CANDIDATES[-1])
            # the staging identity is the trunk fingerprint (matching
            # MorphingSession._stage_all): fine-tunes riding this lane
            # reuse the one staged base trunk instead of re-staging K
            # identical copies; the share cache is keyed by the lane's
            # trunk fingerprint explicitly in _embed
            spec = InferSpec(
                kind="embed", task=rm.task, col="x", out="f",
                table=_SHARE_TABLE, version=(rm.trunk_fp or rm.version),
                model=rm, batch_size=batch_rows, share=None,
                stats=BatcherStats())
            lane = _Lane(key=key, device=device, batcher=None,  # type: ignore
                         spec=spec, batch_rows=batch_rows,
                         in_dim=int(rm.in_dim or 0))
            lane.heads[rm.task] = self._head_stage(rm.task, rm, backend)
            step = self._share_step(lane, backend)
        lane.batcher = ContinuousBatcher(
            step, batch_size=batch_rows, size_of=lambda p: len(p[1]),
            max_wait_s=self.max_wait_s, idle_wait_s=self.idle_wait_s,
            name=key, policy=self.policy)
        return lane

    # -- lane execution ----------------------------------------------------
    def _legacy_step(self, lane: _Lane, backend: ExecutionBackend):
        """Per-task full-predict step (the pre-share serving path)."""
        def step(payloads: List[Tuple[str, np.ndarray]]) -> List[np.ndarray]:
            arrs = [np.asarray(p, np.float32) for _, p in payloads]
            lens = [len(a) for a in arrs]
            out = np.asarray(
                backend.run_infer(lane.spec, {"x": _stack(arrs)})["y"])
            offs = np.cumsum([0] + lens)
            return [out[a:b] for a, b in zip(offs[:-1], offs[1:])]
        return step

    def _share_step(self, lane: _Lane, backend: ExecutionBackend):
        """Trunk-lane step: batched cache-chain lookup -> single-flight
        dedup -> trunk forward on unique missing rows -> write-back ->
        per-task head stages."""
        # with the ANN tier enabled the lanes consult the whole chain
        # (exact tier first, calibrated nearest-neighbor reuse for the
        # residual misses); otherwise just the exact tier
        share = (self.session.cache_chain
                 if getattr(self.session, "ann", None) is not None
                 else self.session.share)
        use_share = self.session.enable_share

        def step(payloads: List[Tuple[str, np.ndarray]]) -> List[np.ndarray]:
            arrs = [np.asarray(p, np.float32) for _, p in payloads]
            lens = [len(a) for a in arrs]
            X = _stack(arrs, width=lane.in_dim or None)
            n = len(X)
            E = self._embed(lane, backend, share if use_share else None, X)
            offs = np.cumsum([0] + lens)
            outs: List[np.ndarray] = []
            for (task, _), a, b in zip(payloads, offs[:-1], offs[1:]):
                outs.append(lane.heads[task].run(E[a:b]) if b > a
                            else np.zeros(0, np.float32))
            return outs
        return step

    def _embed(self, lane: _Lane, backend: ExecutionBackend,
               share, X: np.ndarray) -> np.ndarray:
        """Embeddings for one coalesced chunk: cache rows are gathered
        (exactly or via the ANN tier's calibrated reuse), unique missing
        rows computed once, results written back. Audited approx hits
        are recomputed exactly, reported via ``record_audit`` and served
        exact — the serving path keeps the tier's radius honest."""
        n = len(X)
        if n == 0:
            return np.zeros((0, 1), np.float32)
        if share is None:
            return np.asarray(
                backend.run_infer(lane.spec, {"x": X})[lane.spec.out])
        look = share.lookup_many(_SHARE_TABLE, lane.key, X,
                                 version=lane.key)
        keys, miss = look.keys, look.miss
        n_miss = int(miss.sum())
        n_approx = len(look.approx_idx)
        # rows that must run the trunk: real misses plus the audit
        # sample of the approximate hits
        need = miss.copy()
        if len(look.audit_idx):
            need[look.audit_idx] = True
        if not need.any():
            with lane.lock:
                lane.share_hits += n - n_approx
                lane.approx_hits += n_approx
            return look.found
        # single-flight dedup: identical in-flight rows (across the
        # coalesced requests of this batch) compute once. The lane's
        # single worker serializes batches, so rows computed here are in
        # the cache before any later batch looks them up.
        need_idx = np.flatnonzero(need)
        uniq, first = np.unique(keys[need_idx], return_index=True)
        comp_idx = need_idx[first]
        computed = np.asarray(
            backend.run_infer(lane.spec, {"x": X[comp_idx]})[lane.spec.out],
            np.float32)
        E = (np.asarray(look.found, np.float32) if look.found is not None
             else np.zeros((n, computed.shape[1]), np.float32))
        fa = 0
        if len(look.audit_idx):
            exact = computed[np.searchsorted(uniq, keys[look.audit_idx])]
            errs = np.linalg.norm(
                E[look.audit_idx].astype(np.float64) - exact, axis=1)
            order = np.argsort(look.approx_idx, kind="stable")
            loc = order[np.searchsorted(look.approx_idx[order],
                                        look.audit_idx)]
            record = getattr(share, "record_audit", None)
            if record is not None:
                record(_SHARE_TABLE, lane.key, lane.key,
                       look.approx_dist[loc], errs)
            ann = getattr(share, "ann", None)
            if ann is not None:
                fa = int((errs > ann.cfg.error_bound).sum())
        # computed[j] embeds uniq[j] (np.unique sorts): scatter back to
        # every duplicate needed row in one searchsorted — audited rows
        # get their exact recomputation, not the approximation
        E[need_idx] = computed[np.searchsorted(uniq, keys[need_idx])]
        share.insert_many(_SHARE_TABLE, lane.key, keys[comp_idx],
                          X[comp_idx], computed, version=lane.key)
        with lane.lock:
            lane.share_hits += n - n_miss - n_approx
            lane.share_misses += n_miss
            lane.approx_hits += n_approx
            lane.false_accepts += fa
            lane.dedup_rows += len(need_idx) - len(comp_idx)
        return E

    # -- request admission -------------------------------------------------
    def resolve_task(self, name: str, X: np.ndarray, y: np.ndarray,
                     **kw) -> None:
        """Resolve a task ahead of traffic (partial-load aware)."""
        with self._lock:
            if name not in self.session.models:
                self.session.resolve_task(name, X, y, **kw)

    def submit(self, sql: str,
               sample: Optional[Tuple[np.ndarray, np.ndarray]] = None, *,
               priority: str = "batch",
               deadline_ms: Optional[float] = None) -> int:
        """Admit one PREDICT statement; returns its request id. The rows
        the statement selects are snapshotted at admission (the window
        the request observed) and coalesced with other requests whose
        tasks resolve to the same trunk.

        With an :class:`AdmissionPolicy` on the server, ``priority``
        (``interactive``/``batch``/``best_effort``) picks the lane queue
        and drain weight, ``deadline_ms`` feeds the deadline-aware row
        budget and the deadline-miss counter, and this call raises
        :class:`Rejected` under backpressure or :class:`CircuitOpen`
        while the lane's breaker is open. The supervisor lives here: a
        tripped breaker past its cooldown is reset on the next submit
        (the lane "restarts" and the request is admitted)."""
        validate_priority(priority)
        task, col, table, preds = self._parse_predict(sql)
        if task not in self.session.models:
            if not self._running:
                raise RuntimeError(
                    "server not started: call start() or use "
                    "'with server:'")
            if sample is None:
                raise RuntimeError(
                    f"task {task} unresolved and no sample given")
            self.resolve_task(task, *sample)
        return self.submit_rows(task, self._rows_for(table, col, preds),
                                priority=priority, deadline_ms=deadline_ms)

    def submit_rows(self, task: str, X: np.ndarray, *,
                    priority: str = "batch",
                    deadline_ms: Optional[float] = None) -> int:
        """Admit pre-selected rows for an already-resolved task — the
        row-level entry the dispatch tier's workers use (the front door
        parsed the SQL and snapshotted the window before shipping the
        rows over). Identical admission semantics to :meth:`submit`:
        priority classes, deadlines, breaker supervision, and
        Rejected/CircuitOpen backpressure."""
        validate_priority(priority)
        if not self._running:
            raise RuntimeError(
                "server not started: call start() or use 'with server:'")
        if task not in self.session.models:
            raise RuntimeError(
                f"task {task} unresolved; resolve_task() it first")
        lane = self._lane_for(task)
        # supervisor: an open breaker whose cooldown elapsed is closed
        # here, so the first post-cooldown submit restarts the lane
        # instead of requiring an operator action
        lane.batcher.reset_breaker()
        req_id = next(self._ids)
        # bookkeeping only after a successful admission (submit raises
        # when racing a stop()); counter writes go under the lane lock
        lane.batcher.submit(Request(
            req_id, (task, np.asarray(X)), priority=priority,
            deadline_s=(deadline_ms / 1000.0
                        if deadline_ms is not None else None)))
        self._task_of[req_id] = task
        with lane.lock:
            lane.requests_by_task[task] = \
                lane.requests_by_task.get(task, 0) + 1
        return req_id

    def result(self, req_id: int,
               timeout: Optional[float] = None) -> ServeResult:
        """Block until the request's batch has executed. Each result is
        retrievable once: returning it releases the server's per-request
        state (long-running services stay memory-bounded)."""
        task = self._task_of[req_id]
        lane = self._lane_of_task[task]
        try:
            scores = lane.batcher.result(req_id, timeout=timeout,
                                         evict=False)
            latency = lane.batcher.latency(req_id)
        except TimeoutError:
            raise                        # still pending: retry result()
        except BaseException:
            lane.batcher.evict(req_id)   # failed: release the slot
            self._task_of.pop(req_id, None)
            raise
        lane.batcher.evict(req_id)
        self._task_of.pop(req_id, None)
        return ServeResult(req_id=req_id, task=task,
                           scores=np.asarray(scores), rows=len(scores),
                           latency_s=latency)

    def predict(self, sql: str,
                sample: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                timeout: Optional[float] = None, *,
                priority: str = "batch",
                deadline_ms: Optional[float] = None) -> ServeResult:
        """submit + result convenience for a single caller thread."""
        return self.result(self.submit(sql, sample=sample,
                                       priority=priority,
                                       deadline_ms=deadline_ms),
                           timeout=timeout)

    # -- telemetry ---------------------------------------------------------
    def stats(self) -> ServerStats:
        st = ServerStats()
        st.devices = self.devices
        lat: List[float] = []
        lat_by_prio: Dict[str, List[float]] = {p: [] for p in PRIORITIES}
        coalesced: List[int] = []
        embed_seconds = 0.0
        with self._lock:
            lanes = list(self._lanes.values())
        st.lanes = len(lanes)
        for lane in lanes:
            lane_lat, lane_sizes = lane.batcher.telemetry()
            for p, samples in lane.batcher.telemetry_by_priority().items():
                lat_by_prio[p].extend(samples)
            h = lane.batcher.health()
            st.rejected += h["rejected"]
            for p, c in h["rejected_by_priority"].items():
                if c:
                    st.rejected_by_priority[p] = \
                        st.rejected_by_priority.get(p, 0) + c
            st.retries += h["retries"]
            st.failed_batches += h["failed_batches"]
            st.deadline_misses += h["deadline_misses"]
            st.deadlines_admitted += h["deadlines_admitted"]
            st.breaker_trips += h["breaker_trips"]
            st.breaker_resets += h["breaker_resets"]
            if h["breaker_open"]:
                st.breaker_open_lanes.append(lane.key)
            st.batch_rows_by_lane[lane.key] = h["batch_rows"]
            st.budget_shrinks += h["budget_shrinks"]
            st.budget_grows += h["budget_grows"]
            with lane.lock:
                served_tasks = list(lane.requests_by_task.items())
                heads = list(lane.heads.values())
                st.share_hits += lane.share_hits
                st.share_misses += lane.share_misses
                st.approx_hits += lane.approx_hits
                st.false_accepts += lane.false_accepts
                st.dedup_rows += lane.dedup_rows
                hits = lane.share_hits + lane.approx_hits
                t = hits + lane.share_misses
                st.share_hit_rate_by_lane[lane.key] = \
                    hits / t if t else 0.0
                st.tasks_by_lane[lane.key] = len(lane.requests_by_task)
            for task, c in served_tasks:
                st.requests += c
                st.requests_by_task[task] = \
                    st.requests_by_task.get(task, 0) + c
            st.batches += len(lane_sizes)
            if heads:                            # share-aware lane
                st.embed_rows += lane.spec.stats.rows
                st.embed_batches += lane.spec.stats.batches
                st.infer_seconds += lane.spec.stats.infer_seconds
                embed_seconds += lane.spec.stats.infer_seconds
                for h in heads:
                    st.rows += h.spec.stats.rows     # every served row
                    st.head_rows += h.spec.stats.rows  # passes one head
                    st.head_batches += h.spec.stats.batches
                    st.infer_seconds += h.spec.stats.infer_seconds
            else:                                # legacy full-predict lane
                st.rows += lane.spec.stats.rows
                st.infer_seconds += lane.spec.stats.infer_seconds
            lat.extend(lane_lat)
            coalesced.extend(lane_sizes)
        if embed_seconds:
            st.mesh_rows_per_s = st.embed_rows / embed_seconds
        if coalesced:
            st.mean_coalesced = float(np.mean(coalesced))
        if lat:
            st.p50_latency_s = float(np.percentile(lat, 50))
            st.p95_latency_s = float(np.percentile(lat, 95))
            st.max_latency_s = float(np.max(lat))
        for p, samples in lat_by_prio.items():
            if samples:
                st.p50_latency_s_by_priority[p] = \
                    float(np.percentile(samples, 50))
                st.p95_latency_s_by_priority[p] = \
                    float(np.percentile(samples, 95))
        # bytes are scoped to tasks actually served through a lane — a
        # shared session's analytics-only resolutions don't belong in
        # serving telemetry
        seen = set()
        for lane in lanes:
            with lane.lock:
                tasks = list(lane.requests_by_task)
            for task in tasks:
                rm = self.session.models.get(task)
                if rm is not None and task not in seen:
                    seen.add(task)
                    st.loaded_bytes += rm.loaded_bytes
                    st.stored_bytes += rm.stored_bytes
                    if rm.is_delta:
                        st.delta_tasks += 1
                        st.delta_loaded_bytes += rm.loaded_bytes
                        st.delta_stored_bytes += rm.delta_bytes
        sstats = self.session.dstore.stats
        st.dedup_pages = sstats.dedup_pages
        st.dedup_bytes_saved = sstats.dedup_bytes_saved
        st.compressed_delta_bytes = sstats.compressed_delta_bytes
        st.quant_error_bound = sstats.quant_error_bound
        return st

    def health(self) -> Dict[str, Dict]:
        """Per-lane robustness snapshot (queue depths, rejections,
        retries, breaker state, current dynamic row budget) keyed by
        lane. The fleet aggregate lives on :meth:`stats`."""
        with self._lock:
            lanes = list(self._lanes.values())
        return {lane.key: lane.batcher.health() for lane in lanes}

    def reset_telemetry(self) -> None:
        """Re-base every telemetry window: latency/batch-size deques,
        share/dedup counters, and per-stage BatcherStats. Percentiles and
        rates from :meth:`stats` then describe only the traffic served
        after the reset (e.g. post-warmup). Pending requests still serve
        normally — only the counters restart."""
        with self._lock:
            lanes = list(self._lanes.values())
        for lane in lanes:
            lane.batcher.reset_telemetry()
            with lane.lock:
                lane.share_hits = lane.share_misses = lane.dedup_rows = 0
                lane.approx_hits = lane.false_accepts = 0
                for task in lane.requests_by_task:
                    lane.requests_by_task[task] = 0
                heads = list(lane.heads.values())
            # fresh sinks: backends read spec.stats per call, so swapping
            # the object re-bases without racing in-flight accumulation
            lane.spec.stats = BatcherStats()
            for h in heads:
                h.spec.stats = BatcherStats()


def _stack(payloads: List[np.ndarray],
           width: Optional[int] = None) -> np.ndarray:
    """Concatenate request payloads, adapting rows to a common width so
    requests over differently-shaped tables can share a batch. With
    ``width`` (the lane trunk's input width) rows are adapted to the
    model's own geometry, which keeps content fingerprints stable across
    batches; otherwise the widest payload wins (the backend re-adapts to
    the model's input width anyway)."""
    arrs = [np.asarray(p, np.float32) for p in payloads]
    if any(a.ndim < 2 for a in arrs):        # non-tabular rows: as-is
        return arrs[0] if len(arrs) == 1 else np.concatenate(arrs)
    if width is None:
        if len(arrs) == 1:
            return arrs[0]
        width = max(a.shape[1] for a in arrs)
    if len(arrs) == 1:
        return adapt_input_width(arrs[0], width)
    return np.concatenate([adapt_input_width(a, width) for a in arrs])
