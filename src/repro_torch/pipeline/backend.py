"""Execution backends: make ``Node.device`` annotations real.

The planner (Eq. 10) annotates inference nodes with a device; this module
supplies the *executors* those annotations dispatch to. A backend owns
three responsibilities for embed/predict operators:

- **staging** — weights move to the execution device once per resolved
  task (``stage`` at ``MorphingSession.resolve_task``), never per chunk,
  which is exactly the amortization the cost model's TransCost term
  (Eq. 7) assumes;
- **device forward** — :class:`TorchBackend` builds each resolved
  ``ZooModel`` forward pass (all four modes: linear/radial/relu/proj1d)
  plus the fused mean score head as torch functions on one device. The
  linear mode routes through the hand-written fused normalize+project+tanh
  CUDA kernel (``repro_torch.kernels.fused_embed``), whose wrapper takes
  its plain PyTorch version on the CPU. :class:`MeshTorchBackend` splits
  each chunk's rows over a serving mesh's devices;
- **shape bucketing** — ragged chunk row counts are padded to the next
  power of two and sliced on return, so a whole query sees at most
  O(log n) distinct shapes instead of one per distinct chunk length.
  ``compile_count`` counts distinct (fn, bucket) shapes exactly as the
  reference's jit cache does, so report counters match across the two
  packages, and ``on_compile`` is a hook for tests.

``PipelineExecutor`` holds a registry ``{device annotation -> backend}``
and routes each node through it; nodes without a native backend
implementation fall back to their lowered host closure (``node.fn``).

Port of ``src/repro/pipeline/backend.py``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple

import numpy as np

from repro_torch.core.zoo import adapt_input_width
from repro_torch.pipeline.batcher import BatcherStats, WindowBatcher


@dataclass
class InferSpec:
    """Everything a backend needs to run one inference operator natively.

    Attached to ``Node.meta['infer']`` by plan lowering; ``kind`` is
    'embed' (features only, share-cached) or 'predict' (features + score
    head fused). ``stats`` is the shared per-task BatcherStats sink.
    """
    kind: str
    task: str
    col: str
    out: str
    table: str
    version: str
    model: Any                       # ResolvedModel (or shim): .features,
    #                                # .head, .zoo_model
    batch_size: int = 32
    share: Optional[Any] = None      # VectorShareCache
    stats: BatcherStats = field(default_factory=BatcherStats)


class ExecutionBackend:
    """Base backend: share-cache plumbing + node fallback dispatch."""

    name = "base"

    def __init__(self):
        # InferSpec.stats is shared across concurrent chunk runs of the
        # same node: accumulate under a lock (same race class as
        # ExecStats in the executor)
        self._stats_lock = threading.Lock()
        # chaos hook (duck-typed; see training.fault.FaultInjector):
        # fires at the top of run_infer when set, so tests and the
        # overload bench can inject errors/stalls without a flaky device
        self.fault_injector: Optional[Any] = None

    # -- staging ----------------------------------------------------------
    def stage(self, version: str, zoo_model) -> Any:
        """Move a resolved model's weights onto the execution device.
        Idempotent per version; called once at resolve time."""
        return zoo_model

    def unstage(self, version: str) -> bool:
        """Release staged device state for one trunk identity (the
        dispatch tier's scale-in path). Idempotent; returns True when
        something was actually evicted. Host backends keep no staged
        state, so the base implementation is a no-op."""
        return False

    # -- node dispatch ----------------------------------------------------
    def run_node(self, node, inputs: List[Any]) -> Any:
        spec = node.meta.get("infer") if node.meta else None
        if spec is not None and inputs:
            return self.run_infer(spec, inputs[0])
        if node.fn:
            return node.fn(*inputs)
        return inputs[0] if inputs else None

    def run_infer(self, spec: InferSpec, batch: Dict[str, np.ndarray]
                  ) -> Dict[str, np.ndarray]:
        fi = self.fault_injector
        if fi is not None:
            fi.on_infer(spec, len(batch.get(spec.col, ())))
        res = dict(batch)
        X = batch[spec.col]
        if spec.kind == "embed":
            if spec.share is not None and len(X):
                res[spec.out] = spec.share.get_or_embed(
                    spec.table, spec.col, np.asarray(X),
                    lambda A: self._features(spec, A),
                    version=spec.version)
            else:
                res[spec.out] = self._features(spec, X)
        else:  # full predict: features + score head
            res[spec.out] = self._predict(spec, X)
        return res

    def run_head(self, spec: InferSpec, F: np.ndarray) -> np.ndarray:
        """Head-only execution entry point: consume embeddings, produce
        scores in ``spec.batch_size``-row slices (the head stage's own
        Eq. 11 budget). Heads are O(rows * head_dim) host work (plan
        lowering keeps them as host closures too), so the base
        implementation is shared by every backend; stats land in
        ``spec.stats`` so serving telemetry can report head rows next to
        embed rows."""
        F = np.asarray(F, np.float32)
        if len(F) == 0:
            return np.zeros(0, np.float32)
        bs = max(1, spec.batch_size)
        t0 = time.perf_counter()
        outs = [np.asarray(spec.model.head(F[i:i + bs]))
                for i in range(0, len(F), bs)]
        dt = time.perf_counter() - t0
        st = spec.stats
        with self._stats_lock:
            st.batches += len(outs)
            st.rows += len(F)
            st.infer_seconds += dt
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    # -- to implement ------------------------------------------------------
    def _features(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError

    def _predict(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        raise NotImplementedError


class NumpyBackend(ExecutionBackend):
    """Host reference path: the resolved model's numpy forward, batched in
    window-sized slices (paper §5.2 window-function batch inference).

    A columnar 2-D numeric input already *is* an aggregated window, so it
    runs as vectorized ``batch_size`` slices; ragged/object rows fall
    back to the row-at-a-time WindowBatcher (which owns the per-row
    tensor conversion the vectorized path skips)."""

    name = "numpy"

    def _batched(self, spec: InferSpec, X: np.ndarray,
                 fn: Callable[[np.ndarray], np.ndarray]) -> np.ndarray:
        if len(X) == 0:
            # empty chunk: keep the true output width so cross-chunk
            # concatenation stays shape-consistent
            return np.asarray(fn(X))
        Xa = np.asarray(X)
        if Xa.dtype != object and Xa.ndim >= 2:
            return self._batched_sliced(spec, Xa, fn)
        wb = WindowBatcher(fn, batch_size=spec.batch_size,
                           convert_workers=1)
        for i in range(len(X)):
            wb.add(i, X[i])
        res = wb.finish()
        st = spec.stats
        with self._stats_lock:
            st.batches += wb.stats.batches
            st.rows += wb.stats.rows
            st.infer_seconds += wb.stats.infer_seconds
            st.convert_seconds += wb.stats.convert_seconds
        return np.stack([np.asarray(res[i]) for i in range(len(X))])

    def _batched_sliced(self, spec: InferSpec, X: np.ndarray,
                        fn: Callable[[np.ndarray], np.ndarray]
                        ) -> np.ndarray:
        bs = max(1, spec.batch_size)
        t0 = time.perf_counter()
        outs = [np.asarray(fn(X[i:i + bs])) for i in range(0, len(X), bs)]
        dt = time.perf_counter() - t0
        st = spec.stats
        with self._stats_lock:
            st.batches += len(outs)
            st.rows += len(X)
            st.infer_seconds += dt
        return np.concatenate(outs) if len(outs) > 1 else outs[0]

    def _features(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        return self._batched(spec, X, spec.model.features)

    def _predict(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        return spec.model.head(self._batched(spec, X, spec.model.features))


@dataclass
class StagedModel:
    """One resolved model, staged: device-resident weights + forward fns."""
    version: str
    mode: str
    in_dim: int
    out_dim: int
    features_fn: Callable            # [B, in_dim] -> [B, out_dim]
    predict_fn: Callable             # [B, in_dim] -> [B]
    seen_shapes: Set[Tuple[str, int]] = field(default_factory=set)


def _next_pow2(n: int) -> int:
    return 1 << (max(n, 1) - 1).bit_length()



def _torch():
    import torch  # deferred so numpy-only paths never pay the import
    return torch


def resolve_device(device: str = "cuda"):
    """``torch.device`` for a backend, or raise. An entry point asked for
    CUDA on a machine without it fails here; it never degrades to the
    CPU (only an explicit ``"cpu"`` runs there)."""
    torch = _torch()
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"torch device {device!r} requested but CUDA is "
                           "not available; pass device='cpu' explicitly "
                           "to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported torch device {device!r}")
    return dev


class TorchBackend(ExecutionBackend):
    """Device path with shape bucketing + one-time staging (port of the
    reference's ``JaxBackend``).

    ``device`` defaults to ``"cuda"`` and raises when CUDA is missing;
    the tests pass ``"cpu"``, where ``fused_embed`` takes its plain
    PyTorch version. Whole chunks run as one device call — the bucketing
    supersedes host-side window batching, so ``batch_size`` annotations
    are telemetry-only on this backend.

    TF32 is switched off for this process's float32 products and
    convolutions (``torch.backends.cuda.matmul.allow_tf32 = False``,
    ``torch.backends.cudnn.allow_tf32 = False``): the radial/relu/proj1d
    trunks use ``torch.matmul``, and the reference holds every trunk mode
    to atol 1e-5 against the numpy oracle, which TF32's ~1e-3 relative
    error would break.
    """

    name = "torch"

    def __init__(self, *, device: str = "cuda", min_bucket: int = 32):
        super().__init__()
        torch = _torch()
        self._torch = torch
        self.device = resolve_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.min_bucket = min_bucket
        self._staged: Dict[str, StagedModel] = {}
        self._lock = threading.Lock()
        self.stage_count = 0             # actual device stagings performed
        self.on_compile: Optional[Callable[[str, Tuple[str, int]], None]] \
            = None

    # -- staging ----------------------------------------------------------
    def _put_weight(self, arr) -> Any:
        """Move one weight tensor onto the execution device (f32)."""
        return self._torch.tensor(np.asarray(arr, np.float32),
                                  device=self.device)

    def _raw_forward(self, zoo_model) -> Tuple[str, int, int, Callable,
                                               Tuple[Any, ...]]:
        """Build the forward for one resolved model: ``(mode, in_dim,
        out_dim, raw, weights)`` where ``raw(X, *weights)`` maps a
        [B, in_dim] device tensor to features and the weights are staged
        by :meth:`_put_weight`. Weights are arguments, not closure
        captures, so the mesh subclass can pass each device its copy."""
        torch = self._torch
        from repro_torch.kernels.fused_embed import fused_embed

        mode = zoo_model.mode
        in_dim = int(zoo_model.W.shape[0])
        if mode == "radial":
            centers = self._put_weight(zoo_model.centers)
            inv_two_sig2 = 1.0 / (2.0 * float(zoo_model.sigma) ** 2)
            out_dim = int(zoo_model.centers.shape[0])

            def raw(X, centers):
                d2 = ((X[:, None, :] - centers[None]) ** 2).sum(-1)
                return torch.exp(-d2 * inv_two_sig2)
            return mode, in_dim, out_dim, raw, (centers,)
        W = self._put_weight(zoo_model.W)
        if mode == "relu":
            out_dim = int(zoo_model.W.shape[1])

            def raw(X, W):
                return torch.clamp_min(X @ W, 0.0)
            return mode, in_dim, out_dim, raw, (W,)
        if mode == "proj1d":
            out_dim = 2 * int(zoo_model.W.shape[1])

            def raw(X, W):
                Z = X @ W
                return torch.tanh(torch.cat([Z, Z ** 2 - 1.0], dim=1))
            return mode, in_dim, out_dim, raw, (W,)
        # linear -> hand-written fused normalize+project+tanh kernel
        out_dim = int(zoo_model.W.shape[1])

        def raw(X, W):
            return fused_embed(X, W)
        return mode, in_dim, out_dim, raw, (W,)

    def _compile_forward(self, raw: Callable, weights: Tuple[Any, ...]
                         ) -> Tuple[Callable, Callable]:
        """(features_fn, predict_fn): each maps a [B, in_dim] host tensor
        to its device result. predict fuses the mean score head. The mesh
        subclass overrides this to split the rows across its devices."""
        torch, dev = self._torch, self.device

        def features(X):
            return raw(X.to(dev), *weights)

        def predict(X):
            return raw(X.to(dev), *weights).to(torch.float32).mean(dim=1)
        return features, predict

    def stage(self, version: str, zoo_model) -> StagedModel:
        with self._lock:
            if version in self._staged:
                return self._staged[version]
        mode, in_dim, out_dim, raw, weights = self._raw_forward(zoo_model)
        features_fn, predict_fn = self._compile_forward(raw, weights)
        staged = StagedModel(
            version=version, mode=mode, in_dim=in_dim, out_dim=out_dim,
            features_fn=features_fn, predict_fn=predict_fn)
        with self._lock:
            if version not in self._staged:   # lost race: first stage wins
                self._staged[version] = staged
                self.stage_count += 1
        return self._staged[version]

    def unstage(self, version: str) -> bool:
        """Drop the staged weights + forward fns for one version. A later
        request for the same version late-stages transparently through
        :meth:`_staged_for`."""
        with self._lock:
            return self._staged.pop(version, None) is not None

    @property
    def compile_count(self) -> int:
        """Distinct (fn, bucket) shapes across staged models — what the
        reference's jit compiles once each."""
        with self._lock:
            return sum(len(s.seen_shapes) for s in self._staged.values())

    # -- bucketed execution ------------------------------------------------
    def _staged_for(self, spec: InferSpec) -> StagedModel:
        staged = self._staged.get(spec.version)
        if staged is None:                    # not staged at resolve: late
            staged = self.stage(spec.version, spec.model.zoo_model)
        return staged

    def _bucket_for(self, n: int) -> int:
        """Padded row count for an n-row chunk."""
        return max(_next_pow2(n), self.min_bucket)

    def _bucketed(self, staged: StagedModel, fn_key: str, fn: Callable,
                  X: np.ndarray, out_shape: Tuple[int, ...]) -> np.ndarray:
        n = len(X)
        if n == 0:
            return np.zeros(out_shape, np.float32)
        Xp = adapt_input_width(np.asarray(X, np.float32), staged.in_dim)
        d = staged.in_dim
        bucket = self._bucket_for(n)
        if bucket == n:                       # aligned chunk: no pad copy
            Xb = np.ascontiguousarray(Xp)
        else:
            Xb = np.zeros((bucket, d), np.float32)
            Xb[:n] = Xp
        key = (fn_key, bucket)
        with self._lock:
            new_shape = key not in staged.seen_shapes
            if new_shape:
                staged.seen_shapes.add(key)
        if new_shape and self.on_compile is not None:
            self.on_compile(staged.version, key)
        out = fn(self._torch.from_numpy(Xb))
        return out[:n].cpu().numpy()

    def _features(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        staged = self._staged_for(spec)
        t0 = time.perf_counter()
        out = self._bucketed(staged, "features", staged.features_fn, X,
                             (0, staged.out_dim))
        dt = time.perf_counter() - t0
        st = spec.stats
        with self._stats_lock:
            st.batches += 1 if len(X) else 0
            st.rows += len(X)
            st.infer_seconds += dt
        return out

    def _predict(self, spec: InferSpec, X: np.ndarray) -> np.ndarray:
        staged = self._staged_for(spec)
        t0 = time.perf_counter()
        # the staged predict_fn fuses the *mean* score head (what
        # ResolvedModel serves); a model carrying a custom head keeps
        # numpy-backend parity by running features on device + head on host
        if getattr(spec.model, "head_kind", "mean") == "mean":
            out = self._bucketed(staged, "predict", staged.predict_fn, X,
                                 (0,))
        else:
            F = self._bucketed(staged, "features", staged.features_fn, X,
                               (0, staged.out_dim))
            out = np.asarray(spec.model.head(F))
        dt = time.perf_counter() - t0
        st = spec.stats
        with self._stats_lock:
            st.batches += 1 if len(X) else 0
            st.rows += len(X)
            st.infer_seconds += dt
        return out

    # -- calibration hooks -------------------------------------------------
    def synchronize(self) -> None:
        """Wait for the device (a no-op on the CPU)."""
        if self.device.type == "cuda":
            self._torch.cuda.synchronize(self.device)

    def measure_link_bandwidth(self, nbytes: int = 8 << 20,
                               repeats: int = 3) -> float:
        """bytes/s of the host->device staging path: a pinned host
        buffer copied to the device (a plain copy on the CPU)."""
        torch = self._torch
        buf = torch.ones(nbytes // 4, dtype=torch.float32)
        if self.device.type == "cuda":
            buf = buf.pin_memory()
        best = float("inf")
        for _ in range(repeats):
            self.synchronize()
            t0 = time.perf_counter()
            buf.to(self.device, copy=True)
            self.synchronize()
            best = min(best, time.perf_counter() - t0)
        return buf.numel() * 4 / max(best, 1e-9)


class MeshTorchBackend(TorchBackend):
    """Data-parallel path over a serving mesh
    (``repro_torch.launch.mesh.ServingMesh``), the counterpart of the
    reference's ``MeshJaxBackend``.

    Staging copies each trunk's weights once to every distinct device of
    the mesh (``repro_torch.distributed.sharding.serving_rules``: every
    weight axis replicated, the batch axis split over ``"data"``). A
    bucket's rows split into ``device_count`` equal contiguous shards; each
    shard is copied to its device and runs the same raw forward there (the
    linear mode launches the CUDA ``fused_embed`` once a shard), and the
    shards come back in order. Every copy and launch is issued before the
    first copy back, and no device waits on another, so distinct devices
    run their shards at once. A mesh that names one device twice runs its
    shards one after another on it.

    Shape bucketing rounds the power-of-two bucket up to a multiple of the
    device count; for a power-of-two mesh the bucket already is one, so
    ``compile_count`` matches the single-device backend's.
    """

    name = "torch-mesh"

    def __init__(self, mesh=None, *, device_count: Optional[int] = None,
                 device: str = "cuda", min_bucket: int = 32):
        if mesh is None:
            from repro_torch.launch import mesh as mesh_mod
            dtype = _torch().device(device).type
            n = (len(mesh_mod.visible_devices(dtype)) if device_count is None
                 else int(device_count))
            mesh = mesh_mod.make_serving_mesh(n, dtype)
        super().__init__(device=str(mesh.devices[0]), min_bucket=min_bucket)
        for d in mesh.distinct_devices():
            resolve_device(str(d))
        self.mesh = mesh
        self.device_count = len(mesh.devices)

    # -- mesh staging + execution -----------------------------------------
    def _put_weight(self, arr) -> Dict[Any, Any]:
        """One copy of the weight on each distinct mesh device."""
        a = np.asarray(arr, np.float32)
        return {d: self._torch.tensor(a, device=d)
                for d in self.mesh.distinct_devices()}

    def _compile_forward(self, raw: Callable, weights: Tuple[Any, ...]
                         ) -> Tuple[Callable, Callable]:
        torch, devs = self._torch, self.mesh.devices

        def sharded(X, head):
            rows = X.shape[0] // len(devs)
            outs = []
            for i, d in enumerate(devs):      # every copy and launch first
                xs = X[i * rows:(i + 1) * rows].to(d, non_blocking=True)
                outs.append(head(raw(xs, *(w[d] for w in weights))))
            out = torch.empty((X.shape[0],) + tuple(outs[0].shape[1:]),
                              dtype=outs[0].dtype)
            for i, o in enumerate(outs):      # then the copies back, in order
                out[i * rows:(i + 1) * rows].copy_(o)
            return out

        def features(X):
            return sharded(X, lambda F: F)

        def predict(X):
            return sharded(X, lambda F: F.to(torch.float32).mean(dim=1))
        return features, predict

    def _bucket_for(self, n: int) -> int:
        b = max(_next_pow2(n), self.min_bucket)
        nd = self.device_count
        return -(-b // nd) * nd

    # -- calibration hooks -------------------------------------------------
    def synchronize(self) -> None:
        for d in self.mesh.distinct_devices():
            if d.type == "cuda":
                self._torch.cuda.synchronize(d)

    def per_device_probe(self) -> TorchBackend:
        """A fresh single-device backend on the mesh's first device, so
        ``cost.calibrate`` can report the per-device rate beside the
        mesh-aggregate rate it measures through this backend."""
        return TorchBackend(device=str(self.mesh.devices[0]),
                            min_bucket=self.min_bucket)


_HOST_BACKEND: Optional[NumpyBackend] = None


def default_host_backend() -> NumpyBackend:
    """Singleton numpy backend used by lowered ``node.fn`` closures so
    executors constructed without a registry keep working."""
    global _HOST_BACKEND
    if _HOST_BACKEND is None:
        _HOST_BACKEND = NumpyBackend()
    return _HOST_BACKEND


class BackendPool(Dict[str, ExecutionBackend]):
    """Placement-aware ``{device annotation -> backend}`` pool.

    A dict (same mapping protocol as the reference's, so planner and
    session lookups are untouched) that also owns the *mesh dimension* of
    placement: ``device_count`` is how many devices the accelerator
    annotation spans, and ``mesh`` the live serving mesh when it spans
    more than one. A single-device pool carries no mesh and holds exactly
    the single-device backends.
    """

    def __init__(self, mapping: Dict[str, ExecutionBackend], *,
                 kind: str = "auto", device_count: int = 1, mesh=None):
        super().__init__(mapping)
        self.kind = kind
        self.device_count = int(device_count)
        self.mesh = mesh

    def backend_for(self, device: str) -> ExecutionBackend:
        return self.get(device) or default_host_backend()

    def distinct(self) -> List[ExecutionBackend]:
        return list({id(b): b for b in self.values()}.values())

    def set_fault_injector(self, injector: Optional[Any]) -> None:
        """Thread a chaos hook (``training.fault.FaultInjector`` or
        ``None`` to clear) through every distinct backend in the pool."""
        for b in self.distinct():
            b.fault_injector = injector


def _mesh_torch_backend(device_count: int, torch_device: str
                        ) -> Tuple[TorchBackend, int, Any]:
    """(backend, effective device count, mesh) for the accelerator slot.

    ``device_count`` is clamped to the devices of ``torch_device``'s type
    that ``repro_torch.launch.mesh.visible_devices`` lists; a clamp to one
    device gives the plain single-device :class:`TorchBackend` on
    ``torch_device``, the path of a pool with no mesh."""
    from repro_torch.launch import mesh as mesh_mod
    dtype = _torch().device(torch_device).type
    n = int(device_count)
    if n > 1:
        n = max(1, min(n, len(mesh_mod.visible_devices(dtype))))
    if n == 1:
        return TorchBackend(device=torch_device), 1, None
    b = MeshTorchBackend(device_count=n, device=dtype)
    return b, b.device_count, b.mesh


def make_backends(kind: str = "auto",
                  devices: Tuple[str, ...] = ("host", "cuda"),
                  device_count: int = 1,
                  torch_device: str = "cuda") -> BackendPool:
    """Build the placement-aware backend pool.

    'auto'  -> host: numpy, cuda: torch
    'numpy' -> every device runs the host numpy path
    'torch' -> every device runs the torch path on ``torch_device``

    ``device_count > 1`` asks for a mesh: the torch-backed annotations are
    served by one :class:`MeshTorchBackend` over the first
    ``min(device_count, visible)`` devices of ``torch_device``'s type. The
    numpy path has no devices to span, so a numpy pool always reports
    ``device_count == 1``. Unlike the reference, 'auto' never degrades: a
    torch backend that cannot be built (no CUDA for ``torch_device='cuda'``)
    raises.
    """
    np_b = NumpyBackend()
    if kind == "numpy":
        return BackendPool({d: np_b for d in devices}, kind=kind)
    if kind == "torch":
        tb, n, mesh = _mesh_torch_backend(device_count, torch_device)
        return BackendPool({d: tb for d in devices}, kind=kind,
                           device_count=n, mesh=mesh)
    if kind != "auto":
        raise ValueError(f"unknown backend kind {kind!r}")
    tb, n, mesh = None, 1, None
    if "cuda" in devices:
        tb, n, mesh = _mesh_torch_backend(device_count, torch_device)
    return BackendPool({d: tb if d == "cuda" else np_b for d in devices},
                       kind=kind, device_count=n, mesh=mesh)
