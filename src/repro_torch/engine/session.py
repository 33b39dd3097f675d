"""MorphingSession: the task-centric query engine facade.

One object owns the whole paper pipeline: registered tables, CREATE TASK
specs, model resolution through the transferability-subspace selector
*and* the storage catalog (the chosen model's weights round-trip through
the BLOB store rather than living in Python memory), a shared
pre-embedding cache, and compiled plan execution on the chunked pipeline
runtime. Every query returns its rows plus a :class:`QueryReport` that
merges `ExecStats` / `ShareStats` / `BatcherStats` into one telemetry
view.

    sess = MorphingSession(selector=sel, zoo=zoo)
    sess.register_table("reviews", {...})
    sess.sql("CREATE TASK sentiment (INPUT=Series, OUTPUT IN ('P','N'), "
             "TYPE='Classification')")
    sess.resolve_task("sentiment", X_sample, y_sample)
    res = sess.sql("SELECT gender, AVG(sentiment(emb)) FROM reviews "
                   "WHERE len > 20 GROUP BY gender")
    res.rows, res.report.share_hit_rate, res.report.device_of

Port of ``src/repro/engine/session.py``.
"""
from __future__ import annotations

import dataclasses
import tempfile
import threading
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.task import TaskRegistry, TaskSpec
from repro_torch.core.zoo import ZooModel, adapt_input_width
from repro_torch.engine.config import UNSET, EngineConfig
from repro_torch.engine.plan import (CompileContext, LogicalPlan, PlanNode,
                                     compile_plan, optimize)
from repro_torch.engine.sql import CreateTaskStmt, QueryStmt, encode_text, parse
from repro_torch.pipeline.backend import (ExecutionBackend, MeshTorchBackend,
                                          NumpyBackend, TorchBackend,
                                          make_backends)
from repro_torch.pipeline.batcher import BatcherStats
from repro_torch.pipeline.cost import (HardwareProfile, OpProfile, calibrate,
                                       delta_staged_profile, load_profile_memo,
                                       profile_for_model, profile_memo_fingerprint,
                                       store_profile_memo)
from repro_torch.pipeline.operators import (Batch, aggregate, batch_len,
                                            groupby_aggs)
from repro_torch.pipeline.scheduler import PipelineExecutor
from repro_torch.pipeline.share import (AnnConfig, AnnShareTier, CacheChain,
                                        VectorShareCache)
from repro_torch.storage.catalog import Catalog
from repro_torch.storage.stores import BlobStore, DecoupledStore


@dataclass
class ResolvedModel:
    """A task's model, loaded back through a model store (BLOB or
    decoupled layer tables with partial loading / fine-tune deltas)."""
    task: str
    model_id: str
    version: str
    features: Callable[[np.ndarray], np.ndarray]   # expensive extractor
    head: Callable[[np.ndarray], np.ndarray]       # cheap score head
    profile: OpProfile
    zoo_model: Optional[ZooModel] = None           # raw weights (staging)
    head_kind: str = "mean"          # 'mean' lets device backends fuse the
    #                                # head; anything else runs head on host
    store: str = "blob"              # which store served the weights
    load_mode: str = "full"          # full | partial | head
    loaded_bytes: int = 0            # disk bytes this resolution read
    stored_bytes: int = 0            # bytes the store holds for the model
    in_dim: int = 0                  # input width the trunk consumes
    head_dim: int = 0                # embedding width the head consumes
    trunk_fp: str = ""               # trunk identity: tasks sharing it can
    #                                # share one serving embed lane
    base_model_id: str = ""          # fine-tune lineage ("" = not a delta)
    base_fp: str = ""                # the base model's trunk fingerprint;
    #                                # == trunk_fp when the trunk is fully
    #                                # inherited (shared embed lane)
    delta_bytes: int = 0             # disk bytes of this model's delta
    #                                # layers (marginal cost over the base)

    @property
    def is_delta(self) -> bool:
        """True for a fine-tune variant served by delta composition."""
        return bool(self.base_model_id)


class _LazyZooModel:
    """Defers a trunk load until the first attribute access — a head-only
    resolution never pays for trunk weights unless an embed actually
    needs them (share-cache hits keep the trunk on disk)."""

    def __init__(self, loader: Callable[[], ZooModel]):
        self._loader = loader
        self._zm: Optional[ZooModel] = None
        self._force_lock = threading.Lock()

    @property
    def materialized(self) -> bool:
        return self._zm is not None

    def _force(self) -> ZooModel:
        with self._force_lock:
            if self._zm is None:
                self._zm = self._loader()
            return self._zm

    def __getattr__(self, name: str) -> Any:
        return getattr(self._force(), name)


@dataclass
class QueryReport:
    """Per-query telemetry: executor + share cache + batcher, merged."""
    sql: str = ""
    plan: str = ""
    resolution: Dict[str, str] = field(default_factory=dict)
    wall_seconds: float = 0.0
    rows_in: int = 0
    rows_out: int = 0
    op_seconds: Dict[str, float] = field(default_factory=dict)
    device_of: Dict[str, str] = field(default_factory=dict)
    backend_of: Dict[str, str] = field(default_factory=dict)
    batch_size_of: Dict[str, int] = field(default_factory=dict)
    compile_count: int = 0          # jit compiles triggered by this query
    share_hits: int = 0
    share_misses: int = 0
    approx_hits: int = 0            # rows served by the ANN tier (within
    #                               # the calibrated distance of a cached
    #                               # row, not byte-identical)
    false_accepts: int = 0          # audited approx hits whose exact
    #                               # recomputation exceeded the bound
    sim_trunk_rows: int = 0         # rows the similarity path had to run
    #                               # through the trunk (0 = warm cache)
    index_scan: bool = False        # ORDER BY SIMILARITY lowered to the
    #                               # ANN index-scan fast path
    batch_batches: int = 0
    batch_rows: int = 0
    batch_infer_seconds: float = 0.0
    loaded_bytes: int = 0           # model bytes read from disk (resolution)
    stored_bytes: int = 0           # model bytes the store holds
    delta_bytes: int = 0            # fine-tune delta bytes among the
    #                               # resolutions this query touched
    # storage-compression gauges (session-lifetime DecoupledStore stats,
    # docs/architecture.md "Compressed deltas & tensor-page dedup"):
    dedup_pages: int = 0            # page writes elided by content dedup
    dedup_bytes_saved: int = 0      # bytes those elided writes would cost
    compressed_delta_bytes: int = 0  # on-disk bytes of compressed deltas
    quant_error_bound: float = 0.0  # max declared quant bound in play

    @property
    def share_hit_rate(self) -> float:
        t = self.share_hits + self.share_misses
        return self.share_hits / t if t else 0.0


@dataclass
class QueryResult:
    rows: Batch
    report: QueryReport


# Heads must be picklable (ResolvedModel crosses the dispatch tier's
# process boundary), so the standard readouts are module-level callables
# rather than closures.
class _MeanHead:
    """Mean readout over feature columns (the zoo's default head)."""

    def __call__(self, F):
        return np.asarray(F, np.float32).mean(axis=1)


class _LinearHead:
    """Stored linear readout ``F @ w`` (decoupled-store heads)."""

    def __init__(self, w):
        self.w = np.asarray(w, np.float32)

    def __call__(self, F):
        return np.asarray(F, np.float32) @ self.w


# Process-wide fast-calibration cache. Calibration measures the *machine*
# (per-row throughput, launch latency, link BW of a backend class), not a
# session, so one measurement per backend flavour serves every session in
# the process — tier-1 tests constructing dozens of sessions pay once.
# ``memo_path`` (EngineConfig.calib_memo_path) extends the memo across
# processes: dispatch workers and repeated CI legs read the first
# process's probe from disk instead of re-measuring.
_FAST_CALIB_CACHE: Dict[Tuple[str, Any], HardwareProfile] = {}
_FAST_CALIB_LOCK = threading.Lock()
_FAST_CALIB_ROWS = (64, 512)
# The card's probe sizes. At 64 and 512 rows a call on an H100 is all
# launch and the two take the same time, so the slope clamped at 1e-12 s
# a row; 2^14 and 2^17 rows (the order of a served request) resolve it
# (``scripts/torch_calib_probe.py``; PERF.md §5).
_CUDA_CALIB_ROWS = (1 << 14, 1 << 17)


def _calib_rows(device: str) -> Tuple[int, int]:
    """Probe row counts of the fast calibration for a device annotation:
    ``"cuda"`` gets sizes its per-row cost shows at, every other device
    the small ones."""
    return _CUDA_CALIB_ROWS if device == "cuda" else _FAST_CALIB_ROWS


def _fast_profile(backend: ExecutionBackend, device: str,
                  memo_path: Optional[str] = None
                  ) -> Optional[HardwareProfile]:
    """Measured HardwareProfile for a backend's *class* (memoized). A
    fresh probe instance of the same flavour is calibrated so the live
    backend's stage/compile counters stay untouched (its kernel launches
    do count in ``fused_embed.launch_count``)."""
    if isinstance(backend, MeshTorchBackend):
        # a mesh profile is per (mesh devices, probe size): the aggregate
        # rate the serving lanes size against depends on the devices the
        # mesh spans. The probe shares the live mesh
        key = ("torch-mesh", tuple(str(d) for d in backend.mesh.devices),
               _calib_rows(device))
        probe_fn = lambda: MeshTorchBackend(mesh=backend.mesh)  # noqa: E731
    elif isinstance(backend, TorchBackend):
        # one profile per torch device and probe size: a CUDA card and the
        # CPU are different machines to the cost model, and a profile
        # probed at the small sizes cannot serve "cuda"
        key = ("torch", str(backend.device), _calib_rows(device))
        probe_fn = lambda: TorchBackend(  # noqa: E731
            device=str(backend.device))
    elif isinstance(backend, NumpyBackend):
        key = ("numpy", None)
        probe_fn = NumpyBackend
    else:
        return None                  # unknown backend: keep spec defaults
    with _FAST_CALIB_LOCK:
        prof = _FAST_CALIB_CACHE.get(key)
        if prof is None and memo_path:
            # disk memo: the fingerprint embeds the torch version and the
            # CUDA device name/count (cpu count for host backends), so
            # stale entries just miss
            prof = load_profile_memo(memo_path).get(
                profile_memo_fingerprint(key))
            if prof is not None:
                _FAST_CALIB_CACHE[key] = prof
        if prof is None:
            prof = calibrate(probe_fn(), device, rows=_calib_rows(device),
                             repeats=1)
            _FAST_CALIB_CACHE[key] = prof
            if memo_path:
                try:
                    store_profile_memo(
                        memo_path, profile_memo_fingerprint(key), prof)
                except OSError:      # memo is best-effort, never fatal
                    pass
    return dataclasses.replace(prof, name=device)


class MorphingSession:
    """Register tables -> create tasks -> resolve models -> run SQL."""

    def __init__(self, selector=None, zoo: Optional[List[ZooModel]] = None,
                 root: Optional[Path] = None, *,
                 config: Optional[EngineConfig] = None,
                 devices: Tuple[str, ...] = UNSET,
                 device_count: int = UNSET,
                 backend: str = UNSET, enable_share: bool = UNSET,
                 chunk_rows: int = UNSET, max_inflight: int = UNSET,
                 workers: int = UNSET, optimize_plans: bool = UNSET,
                 share_capacity_bytes: int = UNSET,
                 model_store: str = UNSET,
                 auto_calibrate: bool = UNSET,
                 cache_tiers: Tuple[str, ...] = UNSET,
                 ann: Optional[AnnConfig] = UNSET):
        # every legacy kwarg is a deprecation shim overlaying the shared
        # EngineConfig; passing only kwargs builds a config from them
        cfg = (config or EngineConfig()).overlaid({
            "devices": devices, "device_count": device_count,
            "backend": backend, "enable_share": enable_share,
            "chunk_rows": chunk_rows, "max_inflight": max_inflight,
            "workers": workers, "optimize_plans": optimize_plans,
            "share_capacity_bytes": share_capacity_bytes,
            "model_store": model_store, "auto_calibrate": auto_calibrate,
            "cache_tiers": cache_tiers, "ann": ann}).validate()
        self.config = cfg
        self.root = Path(root) if root else Path(
            tempfile.mkdtemp(prefix="morphingdb-"))
        self.catalog = Catalog(self.root / "catalog")
        self.blobs = BlobStore(self.root / "models", self.catalog)
        self.dstore = DecoupledStore(
            self.root / "layers", self.catalog,
            compress_deltas=cfg.compress_deltas,
            quant_dtype=cfg.quant_dtype,
            sparse_eps=cfg.sparse_eps,
            dedup_pages=cfg.dedup_pages,
            page_bytes=cfg.page_bytes)
        self.model_store = cfg.model_store
        self.share = VectorShareCache(
            self.root / "share", capacity_bytes=cfg.share_capacity_bytes)
        # the share surface is a CacheTier chain: the exact fingerprint
        # tier always leads; the opt-in ANN tier serves residual misses
        # with calibrated nearest-neighbor reuse
        tiers = [self.share]
        self.ann: Optional[AnnShareTier] = None
        if "ann" in cfg.cache_tiers:
            self.ann = AnnShareTier(cfg.ann or AnnConfig(),
                                    capacity_bytes=cfg.share_capacity_bytes)
            tiers.append(self.ann)
        self.cache_chain = CacheChain(tiers)
        self.registry = TaskRegistry(selector=selector, zoo=zoo)
        self.zoo = zoo or []
        self.devices = cfg.devices
        # the pool is dict-compatible with the old registry; torch
        # backends run on cfg.torch_device ("cuda" unless the caller asks
        # for the CPU) and raise rather than degrade when it is missing
        self.backends = make_backends(
            cfg.backend, devices=cfg.devices,
            device_count=cfg.device_count, torch_device=cfg.torch_device)
        self.device_count = getattr(self.backends, "device_count", 1)
        self.enable_share = cfg.enable_share
        self.hw: Optional[Dict[str, HardwareProfile]] = None
        self.chunk_rows = cfg.chunk_rows
        self.max_inflight = cfg.max_inflight
        self.workers = cfg.workers
        self.optimize_plans = cfg.optimize_plans
        self.tables: Dict[str, Batch] = {}
        self.models: Dict[str, ResolvedModel] = {}
        if cfg.auto_calibrate:
            self._auto_calibrate()

    def _auto_calibrate(self) -> None:
        """Fast calibration at construction (ROADMAP open item): use the
        process-wide memoized profiles so Eq. 10/11 planning starts from
        measured numbers without each session paying a measurement. Full
        per-session measurement stays available via :meth:`calibrate`."""
        try:
            hw = {}
            for dev, b in self.backends.items():
                prof = _fast_profile(b, dev,
                                     memo_path=self.config.calib_memo_path)
                if prof is not None:
                    hw[dev] = prof
            self.hw = hw or None
        except Exception:            # calibration must never block startup
            self.hw = None

    # -- catalog-facing API ----------------------------------------------
    def register_table(self, name: str, table: Batch) -> None:
        self.tables[name] = table

    def create_task(self, spec: TaskSpec) -> None:
        self.registry.create_task(spec)

    def resolve_task(self, name: str, X: np.ndarray, y: np.ndarray,
                     force: bool = False,
                     mode: Optional[str] = None,
                     model_id: Optional[str] = None) -> ResolvedModel:
        """Select a model for the task from sample data, persist it via
        the session's model store + catalog, and load the weights back
        from storage (the served model is the stored one, not the
        in-memory zoo object).

        ``model_id`` pins the task to an explicitly named model already
        in the decoupled catalog — e.g. a fine-tune registered with
        :meth:`register_finetune` — bypassing the selector. Fine-tune
        variants resolve by *delta composition*: unchanged layers come
        from the base model's files (warm via the cross-model layer
        cache, so a fleet of K fine-tunes loads the base trunk once),
        and only their delta bytes hit the disk.

        ``mode`` controls the decoupled store's load shape (ignored for
        the BLOB store, which is all-or-nothing):

        - ``'full'``    — every layer eagerly (the default);
        - ``'partial'`` — the head eagerly plus a *width-sliced* trunk:
          only the first ``X.shape[1]`` rows of the projection leave the
          disk (``load_layer_rows``), since width-adapted inputs zero the
          rest; radial trunks load centers and skip the projection.
          Explicit opt-in: the slice is keyed to the resolution sample's
          width, so the sample must match the serving schema (queries
          over *wider* columns would be truncated to the slice). Delta
          trunks slice base and delta rows consistently;
        - ``'head'``    — only the head eagerly; the trunk stays on disk
          until an embed actually needs it (share-cache hits never pay).
        """
        if not force and name in self.models:
            cached = self.models[name]
            if (mode is not None and cached.store == "decoupled"
                    and cached.load_mode != mode):
                raise ValueError(
                    f"task {name!r} already resolved with load mode "
                    f"{cached.load_mode!r}; pass force=True to "
                    f"re-resolve as {mode!r}")
            if model_id is not None and cached.model_id != model_id:
                raise ValueError(
                    f"task {name!r} already resolved to "
                    f"{cached.model_id!r}; pass force=True to re-bind "
                    f"to {model_id!r}")
            return cached
        if model_id is not None:
            if self.model_store != "decoupled":
                raise ValueError(
                    "model_id resolution requires model_store='decoupled'")
            self.registry.get(name)          # the task must exist
            rm = self._resolve_from_store(name, model_id, X,
                                          mode=mode or "full")
        else:
            idx = self.registry.resolve(name, X, y, force=force)
            zm = self.zoo[idx]
            spec = self.registry.get(name)
            if self.model_store == "decoupled":
                rm = self._resolve_decoupled(name, zm, spec, X,
                                             mode=mode or "full")
            else:
                rm = self._resolve_blob(name, zm, spec)
        self.models[name] = rm
        return rm

    def register_finetune(self, model_id: str, base_model_id: str,
                          updates: Dict[str, np.ndarray], *,
                          task_types: Optional[List[str]] = None,
                          modality: Optional[str] = None) -> Path:
        """Store a fine-tuned variant of a decoupled base model at its
        marginal cost: unchanged layers become references into the base
        (zero new bytes), changed layers land as per-layer *delta* files
        composed back at load time (``DecoupledStore.save(base_model=)``).

        ``updates`` maps layer names (e.g. ``"head/w"``, ``"trunk/W"``)
        to replacement tensors of the base layer's shape; every other
        layer is inherited. A head-only fine-tune keeps the base trunk
        fingerprint, so serving routes it into the base trunk's embed
        lane. Resolve a task against the variant with
        ``resolve_task(name, X, y, model_id=model_id)``.
        """
        if self.model_store != "decoupled":
            raise ValueError(
                "fine-tune deltas require model_store='decoupled'")
        info = self.catalog.get_model(base_model_id)  # KeyError if unsaved
        if info.storage != "decoupled":
            raise ValueError(
                f"base {base_model_id!r} is stored as {info.storage!r}, "
                "not decoupled layer tables")
        arch, flat = self.dstore.load(base_model_id)
        unknown = sorted(set(updates) - set(flat))
        if unknown:
            raise KeyError(
                f"updates for layers the base lacks: {unknown}")
        for lname, arr in updates.items():
            arr = np.asarray(arr, dtype=flat[lname].dtype)
            if arr.shape != flat[lname].shape:
                raise ValueError(
                    f"layer {lname!r} shape {arr.shape} != base shape "
                    f"{flat[lname].shape}")
            flat[lname] = arr
        return self.dstore.save(
            model_id, arch, flat, base_model=base_model_id,
            task_types=task_types or list(info.task_types),
            modality=modality or info.modality)

    def _stage_all(self, rm: ResolvedModel, stored: ZooModel) -> None:
        # one-time weight staging under the *trunk identity*: each
        # distinct backend moves the weights to its device now, not per
        # chunk (TransCost, Eq. 7), and fine-tunes whose trunk is fully
        # inherited stage nothing new — the base trunk is already
        # resident under the shared fingerprint (delta-aware Eq. 7)
        for b in {id(b): b for b in self.backends.values()}.values():
            b.stage(rm.trunk_fp or rm.version, stored)

    def _resolve_blob(self, name: str, zm: ZooModel,
                      spec: TaskSpec) -> ResolvedModel:
        params: Dict[str, np.ndarray] = {"W": zm.W}
        if zm.centers is not None:
            params["centers"] = zm.centers
        arch = {"name": zm.name, "mode": zm.mode, "sigma": float(zm.sigma),
                "source_family": zm.source_family}
        path = self.blobs.save(zm.name, arch, params,
                               task_types=[spec.kind],
                               modality=spec.input_type)
        arch2, flat = self.blobs.load(zm.name)
        stored = ZooModel(name=arch2["name"],
                          source_family=arch2["source_family"],
                          W=np.asarray(flat["W"]), mode=arch2["mode"],
                          centers=(np.asarray(flat["centers"])
                                   if "centers" in flat else None),
                          sigma=arch2["sigma"])
        dim = stored.W.shape[0]
        nbytes = path.stat().st_size
        rm = ResolvedModel(
            task=name, model_id=zm.name, version=f"{zm.name}@1.0",
            features=stored.features,
            head=_MeanHead(),
            profile=profile_for_model(n_params=float(stored.W.size),
                                      bytes_per_row=dim * 4),
            zoo_model=stored, store="blob", load_mode="full",
            loaded_bytes=nbytes, stored_bytes=nbytes,
            in_dim=dim, head_dim=self._trunk_out_dim(stored),
            # BLOB trunks have no layer identity: the version string is
            # the trunk fingerprint (same stored model -> shared lane)
            trunk_fp=f"{zm.name}@1.0")
        self._stage_all(rm, stored)
        return rm

    # -- decoupled store: partial-load resolution -------------------------
    @staticmethod
    def _trunk_out_dim(zm: ZooModel) -> int:
        if zm.mode == "radial":
            return int(zm.centers.shape[0])
        if zm.mode == "proj1d":
            return 2 * int(zm.W.shape[1])
        return int(zm.W.shape[1])

    def _load_trunk(self, model_id: str, arch: dict,
                    width_limit: Optional[int] = None) -> ZooModel:
        """Materialize a trunk from layer tables. ``width_limit`` slices
        the projection to the rows the input width actually touches."""
        in_dim = int(arch["in_dim"])
        if arch["mode"] == "radial":
            # radial features are distances to centers; the stored
            # projection (identity) never runs, so it never loads
            _, flat = self.dstore.load(
                model_id, layer_filter=lambda n: n == "trunk/centers")
            return ZooModel(name=arch["name"],
                            source_family=arch["source_family"],
                            W=np.eye(in_dim, dtype=np.float32),
                            mode="radial",
                            centers=np.asarray(flat["trunk/centers"]),
                            sigma=arch["sigma"])
        if width_limit is not None and width_limit < in_dim:
            W = np.asarray(self.dstore.load_layer_rows(
                model_id, "trunk/W", 0, width_limit))
        else:
            _, flat = self.dstore.load(
                model_id, layer_filter=lambda n: n == "trunk/W")
            W = np.asarray(flat["trunk/W"])
        return ZooModel(name=arch["name"],
                        source_family=arch["source_family"],
                        W=W, mode=arch["mode"], sigma=arch["sigma"])

    def _resolve_decoupled(self, name: str, zm: ZooModel, spec: TaskSpec,
                           X: np.ndarray, mode: str) -> ResolvedModel:
        if mode not in ("full", "partial", "head"):
            raise ValueError(f"unknown load mode {mode!r}")
        out_dim = self._trunk_out_dim(zm)
        arch = {"name": zm.name, "mode": zm.mode, "sigma": float(zm.sigma),
                "source_family": zm.source_family,
                "in_dim": int(zm.W.shape[0]), "out_dim": out_dim}
        try:
            already = (self.catalog.get_model(zm.name).storage
                       == "decoupled")
        except KeyError:
            already = False
        if not already:
            # layer tables: trunk/* (expensive extractor weights) +
            # head/* (the score head — a mean readout stored explicitly
            # so a head-only load has a real layer to fetch)
            params: Dict[str, np.ndarray] = {
                "trunk/W": zm.W,
                "head/w": np.full(out_dim, 1.0 / out_dim, np.float32)}
            if zm.centers is not None:
                params["trunk/centers"] = zm.centers
            self.dstore.save(zm.name, arch, params,
                             task_types=[spec.kind],
                             modality=spec.input_type)
        return self._resolve_from_store(name, zm.name, X, mode)

    def _resolve_from_store(self, name: str, model_id: str,
                            X: np.ndarray, mode: str) -> ResolvedModel:
        """Resolve a task directly against a model in the decoupled
        store. For fine-tune variants (catalog ``base_model`` lineage)
        every read composes ``base + delta``: a warm base trunk costs
        cache bytes, not disk bytes, and the Eq. 7 staging profile
        charges only the delta when the trunk is already resident."""
        if mode not in ("full", "partial", "head"):
            raise ValueError(f"unknown load mode {mode!r}")
        try:
            info = self.catalog.get_model(model_id)
        except KeyError:
            raise KeyError(
                f"model {model_id!r} not in the catalog; resolve its "
                "base task first or register_finetune() it") from None
        if info.storage != "decoupled":
            raise ValueError(
                f"model {model_id!r} is stored as {info.storage!r}; "
                "direct resolution needs decoupled layer tables")
        b0 = self.dstore.stats.loaded_bytes
        arch2, head_flat = self.dstore.load(
            model_id, layer_filter=lambda n: n.startswith("head/"))
        w_head = np.asarray(head_flat["head/w"], np.float32)
        head_bytes = self.dstore.stats.loaded_bytes - b0
        out_dim = int(arch2["out_dim"])
        in_dim_full = int(arch2["in_dim"])
        width_limit = (int(np.asarray(X).shape[1])
                       if mode == "partial" else None)
        # a width-sliced trunk is a distinct embedder for inputs wider
        # than the sample — tag the version so share-cache entries and
        # staged weights never cross between the slices
        sliced = width_limit is not None and width_limit < in_dim_full
        version = (f"{model_id}@1.0+w{width_limit}" if sliced
                   else f"{model_id}@1.0")
        # trunk identity from resolved layer paths: a fine-tune whose
        # trunk layers are all references fingerprints equal to its base
        # (shared embed lane), while a trunk-delta variant gets its own
        # identity; a width slice tags the fingerprint too
        trunk_fp = self.dstore.trunk_fingerprint(model_id)
        base_id = info.base_model or ""
        base_fp = (self.dstore.trunk_fingerprint(base_id) if base_id
                   else "")
        if sliced:
            trunk_fp = f"{trunk_fp}+w{width_limit}"
            if base_fp:
                base_fp = f"{base_fp}+w{width_limit}"
        delta_b = self.dstore.delta_bytes(model_id) if base_id else 0
        prof = profile_for_model(
            n_params=float(info.param_count),
            bytes_per_row=in_dim_full * 4,
            # compressed deltas / deduped pages shrink what a cold
            # resolve reads off disk; Eq. 7's host mem term charges the
            # on-disk bytes, the link term the full dequantized model
            stored_bytes=float(self.dstore.cold_resolve_bytes(model_id)))

        def trunk_resident(m: ResolvedModel) -> bool:
            # a head-mode resolution whose lazy trunk never materialized
            # hasn't loaded or staged anything — it can't discount this
            # variant's Eq. 7 staging cost
            zm = m.zoo_model
            return (m.trunk_fp == trunk_fp and zm is not None
                    and getattr(zm, "materialized", True))

        if base_id and any(trunk_resident(m)
                           for m in self.models.values()):
            # the shared trunk is already resident in this session:
            # staging this variant moves only its delta layers (Eq. 7)
            prof = delta_staged_profile(prof, delta_b)
        rm = ResolvedModel(
            task=name, model_id=model_id, version=version,
            features=None, head=None, profile=prof,
            zoo_model=None, store="decoupled", load_mode=mode,
            loaded_bytes=head_bytes,
            stored_bytes=self.dstore.stored_bytes(model_id),
            in_dim=(width_limit if sliced else in_dim_full),
            head_dim=out_dim, trunk_fp=trunk_fp,
            base_model_id=base_id, base_fp=base_fp,
            delta_bytes=delta_b)
        # a fine-tuned (non-uniform) head is no longer the mean readout
        # the device backends fuse — keep it on host for exactness
        rm.head_kind = ("mean" if np.allclose(w_head, 1.0 / max(out_dim, 1))
                        else "linear")
        rm.head = _LinearHead(w_head)

        def load_trunk() -> ZooModel:
            s0 = self.dstore.stats.loaded_bytes
            stored = self._load_trunk(model_id, arch2,
                                      width_limit=width_limit)
            rm.loaded_bytes += self.dstore.stats.loaded_bytes - s0
            return stored

        if mode == "head":
            lazy = _LazyZooModel(load_trunk)
            rm.zoo_model = lazy
            rm.features = lambda A, _l=lazy: _l._force().features(A)
            # no eager staging: backends late-stage through the lazy
            # proxy on the first embed that actually misses the cache
        else:
            stored = load_trunk()
            rm.zoo_model = stored
            rm.features = stored.features
            self._stage_all(rm, stored)
        return rm

    def calibrate(self, rows=(256, 2048),
                  repeats: int = 3) -> Dict[str, HardwareProfile]:
        """Measure per-row throughput + launch latency from each live
        backend (cost.calibrate) and use the measured profiles for all
        subsequent Eq. 10/11 planning decisions. A backend shared by
        several device names is measured once and the profile reused."""
        import dataclasses
        measured: Dict[int, HardwareProfile] = {}
        self.hw = {}
        for dev, b in self.backends.items():
            if id(b) not in measured:
                measured[id(b)] = calibrate(b, dev, rows=rows,
                                            repeats=repeats)
            self.hw[dev] = dataclasses.replace(measured[id(b)], name=dev)
        return self.hw

    # -- query execution -------------------------------------------------
    def compile(self, plan: LogicalPlan,
                nrows_hint: Optional[int] = None) -> LogicalPlan:
        """Run the optimizer passes against this session's resolutions."""
        if not self.optimize_plans:
            return plan
        profiles = {t: m.profile for t, m in self.models.items()}
        hint = nrows_hint or batch_len(self.tables.get(plan.table, {})) or 1024
        return optimize(plan, profiles, nrows_hint=hint,
                        devices=self.devices, hw=self.hw)

    # -- similarity queries -----------------------------------------------
    def _sim_model(self, nodes: List[PlanNode],
                   col: str) -> Optional[ResolvedModel]:
        """Task context for ``SIMILARITY(col, ...)``: the first
        embed/predict node consuming the column scopes similarity to
        that task's trunk embedding space; without one, similarity runs
        in raw row space."""
        for node in nodes:
            if (node.op in ("embed", "predict")
                    and node.args.get("col") == col):
                rm = self.models.get(node.args.get("task"))
                if rm is not None:
                    return rm
        return None

    def _sim_embed(self, tname: str, col: str, rows: np.ndarray,
                   rm: ResolvedModel) -> Tuple[np.ndarray, int]:
        """Embeddings for similarity scoring, served through the cache
        chain under the same (table, column, trunk) keys the embed
        nodes use — on a warm cache this is a pure gather (exact tier)
        or ANN reuse, zero trunk rows. Returns ``(E, trunk_rows)``."""
        if not self.enable_share:
            return np.asarray(rm.features(np.asarray(rows)),
                              np.float32), len(rows)
        c0 = self.cache_chain.computed_rows
        E = self.cache_chain.get_or_embed(
            tname, col, rows,
            lambda A: np.asarray(rm.features(np.asarray(A)), np.float32),
            version=(rm.trunk_fp or rm.version))
        return np.asarray(E, np.float32), \
            self.cache_chain.computed_rows - c0

    def _similarity_scores(self, tname: str, col: str, rows: np.ndarray,
                           query, rm: Optional[ResolvedModel]
                           ) -> Tuple[np.ndarray, int]:
        """Similarity (negative L2 distance — larger = nearer) of every
        table row to the query, in the task trunk's embedding space when
        one scopes the column, else raw row space. The query is a vector
        literal (input-width, or embedding-width to skip the query-side
        embed entirely) or a text string feature-hashed to input width.
        Returns ``(sims, trunk_rows)``."""
        R = np.asarray(rows)
        Rf = R.reshape(len(R), -1).astype(np.float32, copy=False)
        width = Rf.shape[1]
        if rm is None:                       # raw row space: no trunk
            q = (encode_text(query, width) if isinstance(query, str)
                 else np.asarray(query, np.float32).reshape(-1))
            q = adapt_input_width(q[None], width)[0]
            return -np.linalg.norm(Rf - q[None], axis=1), 0
        E, trunk_rows = self._sim_embed(tname, col, R, rm)
        if (not isinstance(query, str)
                and len(np.asarray(query).reshape(-1)) == rm.head_dim
                and rm.head_dim != width):
            # embedding-width literal: compare directly, no query embed
            qE = np.asarray(query, np.float32).reshape(-1)
        else:
            qrow = (encode_text(query, width) if isinstance(query, str)
                    else np.asarray(query, np.float32).reshape(-1))
            qrow = adapt_input_width(qrow[None], width).astype(
                Rf.dtype if R.dtype == np.float32 else np.float32)
            qe, qt = self._sim_embed(tname, col, qrow, rm)
            qE, trunk_rows = qe[0], trunk_rows + qt
        return -np.linalg.norm(E - qE[None], axis=1), trunk_rows

    def _run_index_scan(self, node: PlanNode, table: Batch
                        ) -> Tuple[Batch, np.ndarray, int]:
        """The lowered top-k fast path: score the whole table against
        the query through the cache chain (warm = ANN/exact gather, no
        trunk) and slice the k nearest rows as the new source table."""
        args = node.args
        rows = np.asarray(table[args["col"]])
        rm = self.models.get(args.get("task") or "")
        sims, trunk_rows = self._similarity_scores(
            args["table"], args["col"], rows, args["query"], rm)
        order = np.argsort(-sims, kind="stable")[:args["k"]]
        sliced = {c: np.asarray(v)[order] for c, v in table.items()}
        return sliced, sims[order], trunk_rows

    @staticmethod
    def _slice_rows(rows: Batch, idx: np.ndarray) -> Batch:
        return {c: np.asarray(v)[idx] for c, v in rows.items()}

    def execute_plan(self, plan: LogicalPlan, sql_text: str = "",
                     chunk_rows: Optional[int] = None,
                     max_inflight: Optional[int] = None) -> QueryResult:
        table = self.tables[plan.table]
        for node in plan.nodes:
            if node.op == "predict" and node.args["task"] not in self.models:
                raise RuntimeError(
                    f"task {node.args['task']!r} not resolved; call "
                    "resolve_task(name, X_sample, y_sample) first")
        plan = self.compile(plan, nrows_hint=batch_len(table))
        # similarity ordering + limit run over the concatenated stream
        # (like final aggregation); an index_scan source replaces the
        # scan entirely — the k-row slice feeds the rest of the dag
        post_nodes = [n for n in plan.nodes if n.op in ("sort", "limit")]
        core_nodes = [n for n in plan.nodes
                      if n.op not in ("sort", "limit")]
        idx_node = (core_nodes[0]
                    if core_nodes and core_nodes[0].op == "index_scan"
                    else None)
        if idx_node is not None:
            core_nodes = ([PlanNode("scan",
                                    {"table": idx_node.args["table"]})]
                          + core_nodes[1:])
        exec_plan = (LogicalPlan(core_nodes)
                     if (post_nodes or idx_node is not None) else plan)
        ctx = CompileContext(
            models=self.models,
            # embeddings depend only on the trunk, so the share cache and
            # the staged-weight lookup key on the trunk identity: fine-
            # tunes of one base reuse the base's cached embeddings and
            # staged trunk (BLOB models fall back to the version string).
            # With the ANN tier enabled the embed nodes consult the whole
            # chain row-granularly; otherwise the classic chunk-level
            # exact cache serves them.
            share=((self.cache_chain if self.ann is not None
                    else self.share) if self.enable_share else None),
            share_version_of={t: (m.trunk_fp or m.version)
                              for t, m in self.models.items()})
        dag, source_id, sink_id, agg_node = compile_plan(exec_plan, ctx)
        h0, m0 = self.share.stats.hits, self.share.stats.misses
        a0 = (self.ann.stats.approx_hits, self.ann.stats.false_accepts) \
            if self.ann is not None else (0, 0)
        sim_trunk_rows = 0
        sim_scores: Optional[np.ndarray] = None
        if idx_node is not None:
            table, sim_scores, sim_trunk_rows = \
                self._run_index_scan(idx_node, table)
        distinct_backends = {id(b): b for b in self.backends.values()}
        c0 = sum(getattr(b, "compile_count", 0)
                 for b in distinct_backends.values())
        ex = PipelineExecutor(dag, workers=self.workers,
                              backends=self.backends)
        if sink_id == source_id:                    # pure scan
            rows = table
        else:
            rows = ex.execute_chunked(
                source_id, table, chunk_rows=chunk_rows or self.chunk_rows,
                sink_id=sink_id, max_inflight=max_inflight
                or self.max_inflight)
        # final aggregation over the concatenated stream (exact groups)
        if agg_node is not None:
            g = agg_node.args.get("group_by")
            specs = agg_node.args["specs"]
            rows = (groupby_aggs(rows, g, specs) if g
                    else aggregate(rows, specs))
        drop_col: Optional[str] = None
        if idx_node is not None:
            # chunked execution of a filterless plan preserves row
            # order, so the index_scan's similarity column re-attaches
            # positionally to the k output rows
            if sim_scores is not None and batch_len(rows) == len(sim_scores):
                rows = dict(rows)
                rows["_sim"] = sim_scores
            drop_col = idx_node.args.get("drop_col")
        for pn in post_nodes:
            if pn.op == "sort":
                col = pn.args["col"]
                rm = self._sim_model(core_nodes, col)
                sims, t = self._similarity_scores(
                    plan.table, col, np.asarray(rows[col]),
                    pn.args["query"], rm)
                sim_trunk_rows += t
                order = np.argsort(
                    sims if pn.args.get("ascending") else -sims,
                    kind="stable")
                rows = self._slice_rows(rows, order)
                rows["_sim"] = sims[order]
                drop_col = pn.args.get("drop_col") or drop_col
            elif pn.op == "limit":
                k = pn.args["k"]
                if batch_len(rows) > k:
                    rows = self._slice_rows(
                        rows, np.arange(k, dtype=np.int64))
        if drop_col is not None and drop_col in rows:
            rows = {c: v for c, v in rows.items() if c != drop_col}
        report = QueryReport(
            sql=sql_text, plan=plan.describe(),
            resolution={t: m.model_id for t, m in self.models.items()
                        if any(n.op in ("predict", "embed")
                               and n.args.get("task") == t
                               for n in plan.nodes)},
            wall_seconds=ex.stats.wall_seconds,
            rows_in=batch_len(table), rows_out=batch_len(rows),
            op_seconds=dict(ex.stats.op_seconds),
            device_of=dict(ex.stats.device_of),
            backend_of=dict(ex.stats.backend_of),
            compile_count=sum(getattr(b, "compile_count", 0)
                              for b in distinct_backends.values()) - c0,
            batch_size_of={n.args["task"]: int(n.args["batch_size"])
                           for n in plan.nodes
                           if n.op == "embed" and "batch_size" in n.args},
            share_hits=self.share.stats.hits - h0,
            share_misses=self.share.stats.misses - m0,
            approx_hits=(self.ann.stats.approx_hits - a0[0]
                         if self.ann is not None else 0),
            false_accepts=(self.ann.stats.false_accepts - a0[1]
                           if self.ann is not None else 0),
            sim_trunk_rows=sim_trunk_rows,
            index_scan=idx_node is not None)
        for t in report.resolution:
            m = self.models[t]
            report.loaded_bytes += m.loaded_bytes
            report.stored_bytes += m.stored_bytes
            report.delta_bytes += m.delta_bytes
        sstats = self.dstore.stats
        report.dedup_pages = sstats.dedup_pages
        report.dedup_bytes_saved = sstats.dedup_bytes_saved
        report.compressed_delta_bytes = sstats.compressed_delta_bytes
        report.quant_error_bound = sstats.quant_error_bound
        for st in ctx.batcher_stats.values():
            report.batch_batches += st.batches
            report.batch_rows += st.rows
            report.batch_infer_seconds += st.infer_seconds
        return QueryResult(rows=rows, report=report)

    def sql(self, statement: str, sample: Optional[Tuple] = None):
        """Execute one SQL statement. ``sample=(X, y)`` supplies the
        resolution sample for any not-yet-resolved task references."""
        stmt = parse(statement)
        if isinstance(stmt, CreateTaskStmt):
            self.create_task(stmt.spec)
            return f"TASK {stmt.spec.name} CREATED"
        assert isinstance(stmt, QueryStmt)
        for t in stmt.tasks:
            if t not in self.registry._tasks:
                raise ValueError(f"unknown task {t}; CREATE TASK first")
            if t not in self.models:
                if sample is None:
                    raise RuntimeError(
                        f"task {t} unresolved and no sample given")
                self.resolve_task(t, *sample)
        return self.execute_plan(stmt.plan, sql_text=statement)
