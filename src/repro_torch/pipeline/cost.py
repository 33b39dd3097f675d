"""Operator cost model + device placement (paper §5.2, Eq. 5-11),
re-derived for the CUDA target.

Equation map (each implemented here by name):

- **Eq. 5** — operator cost ``C_op = ExecTime + TransCost``
  (:func:`op_cost`); for remote models the cost collapses to the
  endpoint's end-to-end latency (:func:`exec_time`'s ``api`` branch).
- **Eq. 6** — ``ExecTime = max(FLOPs/FLOPS(dev), bytes/MemBW) * nrows``
  roofline (:func:`exec_time`).
- **Eq. 7** — ``TransCost = ModelSize/MemBW + ModelSize/AccelBW +
  Latency`` (:func:`trans_cost`); staged once per resolved task, never
  per chunk, and *delta-aware*: a fine-tune sharing a resident base
  trunk only moves its delta layers (:func:`delta_staged_profile`).
- **Eq. 9** — host placement pays only the memory-bus load
  (:func:`trans_cost`'s host branch).
- **Eq. 10** — device decision rule ``argmin C_op``
  (:func:`choose_device`, :func:`place_dag`).
- **Eq. 11** — batch-size selection: argmax throughput s.t. memory cap
  and latency bound (:func:`choose_batch_size`); :func:`split_profile`
  sizes the serving embed and head stages separately.

Devices: 'host' (CPU relational ops + small models), 'cuda' (one NVIDIA
H100), 'api' (remote endpoint). See ``docs/architecture.md`` for where each
decision lands in the dataflow.

Hardware numbers come in two flavours: the static spec-sheet defaults
below (``DEFAULT_HW``), and *measured* :class:`HardwareProfile` entries
produced by :func:`calibrate`, which times the live execution backend
(per-row throughput + launch latency from a two-point linear fit, link
bandwidth from a staging transfer) so Eq. 10/11 decisions reflect the
machine actually running the query. Every cost function takes an
optional ``hw`` mapping of device name -> HardwareProfile that overrides
the defaults.

Port of ``src/repro/pipeline/cost.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

# hardware constants. Host numbers are order-of-magnitude estimates (as in
# the reference). The CUDA numbers are NVIDIA's H100 SXM data sheet: the
# trunks run in float32 outside the tensor cores (67 TFLOP/s), HBM3 at
# 3.35 TB/s, PCIe Gen5 x16 at 128 GB/s both ways (64 GB/s host->device).
# The launch latency is an estimate of one eager torch call per chunk, not
# a data-sheet number; calibrate() replaces all of them with measurements.
HOST_FLOPS = 5e10          # ~50 GFLOP/s effective numpy single-core
HOST_MEM_BW = 2e10         # bytes/s host memory effective
CUDA_FLOPS = 67e12         # f32 (non-tensor-core) peak, H100 SXM
CUDA_HBM_BW = 3.35e12
HOST_TO_CUDA_BW = 64e9     # PCIe Gen5 x16, one direction
CUDA_LAUNCH_LATENCY = 5e-5  # dispatch overhead per call (s), estimate


@dataclass(frozen=True)
class HardwareProfile:
    """Per-device throughput/latency numbers the cost model consumes.

    ``flops_per_s``/``mem_bw`` bound ExecTime (Eq. 6 roofline);
    ``link_bw`` is the host<->device staging path and ``launch_latency_s``
    the per-call dispatch overhead (both enter TransCost, Eq. 7).
    ``measured`` marks profiles produced by :func:`calibrate`.
    """
    name: str
    flops_per_s: float
    mem_bw: float
    link_bw: float = float("inf")
    launch_latency_s: float = 0.0
    measured: bool = False
    # mesh dimension: how many devices the profile's throughput numbers
    # aggregate over. ``flops_per_s``/``mem_bw`` are *mesh-aggregate*
    # (what Eq. 6/11 see for a batch split across the mesh);
    # ``device_flops_per_s`` is the measured single-device rate, so the
    # scaling efficiency is device_flops_per_s * device_count vs
    # flops_per_s. 0.0 means "not separately measured" and reads as the
    # aggregate divided evenly.
    device_count: int = 1
    device_flops_per_s: float = 0.0

    @property
    def per_device_flops(self) -> float:
        return (self.device_flops_per_s
                or self.flops_per_s / max(self.device_count, 1))


DEFAULT_HW: Dict[str, HardwareProfile] = {
    "host": HardwareProfile("host", HOST_FLOPS, HOST_MEM_BW),
    "cuda": HardwareProfile("cuda", CUDA_FLOPS, CUDA_HBM_BW,
                            link_bw=HOST_TO_CUDA_BW,
                            launch_latency_s=CUDA_LAUNCH_LATENCY),
}


def _hw_for(device: str,
            hw: Optional[Dict[str, HardwareProfile]] = None) -> HardwareProfile:
    table = dict(DEFAULT_HW)
    if hw:
        table.update(hw)
    return table.get(device, table["host"])


@dataclass(frozen=True)
class OpProfile:
    """Static profile of one operator instance."""
    flops_per_row: float = 0.0
    bytes_per_row: float = 0.0
    model_bytes: float = 0.0       # weights to stage (0 for relational ops)
    api_latency_s: float = 0.0     # >0 => remote model
    # on-disk bytes a cold resolve reads (compressed deltas / deduped
    # pages make this < model_bytes; 0 = uncompressed, same as
    # model_bytes). The Eq. 7/9 host mem-read term charges these bytes —
    # decompression happens at memory speed — while the host->device
    # link still moves the full dequantized model_bytes.
    stored_model_bytes: float = 0.0

    @property
    def cold_read_bytes(self) -> float:
        return self.stored_model_bytes or self.model_bytes


def exec_time(p: OpProfile, nrows: int, device: str,
              hw: Optional[Dict[str, HardwareProfile]] = None) -> float:
    if device == "api":
        return p.api_latency_s  # end-to-end response latency (Eq. 5 note)
    h = _hw_for(device, hw)
    flops = p.flops_per_row * nrows
    byts = p.bytes_per_row * nrows
    return max(flops / h.flops_per_s, byts / h.mem_bw)


def trans_cost(p: OpProfile, nrows: int, device: str,
               hw: Optional[Dict[str, HardwareProfile]] = None) -> float:
    if device == "api":
        return 0.0
    host = _hw_for("host", hw)
    if device == "host":
        return p.cold_read_bytes / host.mem_bw  # Eq. 9
    h = _hw_for(device, hw)
    # read (possibly compressed) weights from host storage, then stage
    # the full model + batch over the host<->device link (Eq. 7)
    batch_bytes = p.bytes_per_row * nrows
    return (p.cold_read_bytes / host.mem_bw
            + (p.model_bytes + batch_bytes) / h.link_bw
            + h.launch_latency_s)


def op_cost(p: OpProfile, nrows: int, device: str,
            hw: Optional[Dict[str, HardwareProfile]] = None) -> float:
    return exec_time(p, nrows, device, hw) + trans_cost(p, nrows, device, hw)


def choose_device(p: OpProfile, nrows: int,
                  devices=("host", "cuda"),
                  hw: Optional[Dict[str, HardwareProfile]] = None) -> str:
    """Eq. 10 generalized over the available device set."""
    cand = list(devices)
    if p.api_latency_s > 0:
        cand.append("api")
    return min(cand, key=lambda d: op_cost(p, nrows, d, hw))


def place_dag(dag, profiles: Dict[str, OpProfile], nrows_hint: int = 1024,
              devices=("host", "cuda"),
              hw: Optional[Dict[str, HardwareProfile]] = None
              ) -> Dict[str, str]:
    """Plan-time device placement (Eq. 10) over an operator DAG.

    Annotates each ``Node.device`` in place and returns the placement map.
    This is a *planning* pass — `PipelineExecutor` is a pure runtime and
    only reads the annotations (`repro_torch.engine` calls this while lowering a
    logical plan; callers building DAGs by hand call it directly).
    """
    placement = {}
    for op_id, node in dag.nodes.items():
        prof = profiles.get(op_id)
        if node.kind in ("predict", "embed") and prof is not None:
            placement[op_id] = choose_device(prof, nrows_hint, devices, hw)
        else:
            placement[op_id] = "host"
        node.device = placement[op_id]
    return placement


# ---------------------------------------------------------------------------
# Batch-size selection (Eq. 11)
# ---------------------------------------------------------------------------

def batch_cost(p: OpProfile, batch: int, device: str,
               *, fixed_overhead_s: float = 2e-4,
               hw: Optional[Dict[str, HardwareProfile]] = None
               ) -> Dict[str, float]:
    t = op_cost(p, batch, device, hw) + fixed_overhead_s
    return {"latency_s": t, "throughput": batch / t,
            "mem_bytes": p.bytes_per_row * batch + p.model_bytes}


def choose_batch_size(p: OpProfile, device: str, *,
                      candidates=(1, 2, 4, 8, 16, 32, 64, 128),
                      mem_cap_bytes: float = 2e9,
                      latency_bound_s: Optional[float] = None,
                      hw: Optional[Dict[str, HardwareProfile]] = None) -> int:
    """argmax throughput s.t. memory cap + optional latency bound. The
    paper's observed sweet spot (8-32) falls out of the overhead/memory
    trade-off rather than being hard-coded."""
    best, best_tp = candidates[0], -1.0
    for b in candidates:
        c = batch_cost(p, b, device, hw=hw)
        if c["mem_bytes"] > mem_cap_bytes:
            continue
        if latency_bound_s and c["latency_s"] > latency_bound_s:
            continue
        if c["throughput"] > best_tp:
            best, best_tp = b, c["throughput"]
    return best


@dataclass
class DynamicBudget:
    """Eq. 11 made adaptive for SLO-aware serving lanes.

    ``base_rows`` is the static Eq. 11 optimum (:func:`choose_batch_size`
    picked it for peak throughput). Under deadline pressure a lane
    trades that throughput for tail latency: when the windowed p95 of
    request latency approaches the **tightest admitted deadline**, the
    row budget halves (down to ``min_rows``) so batches complete — and
    queued requests start — sooner; when the pressure clears or the lane
    goes idle the budget doubles back toward the Eq. 11 optimum.

    The controller is pure state + arithmetic (no clocks, no threads):
    the owning batcher calls :meth:`update` after each served batch with
    its measured p95 and the tightest deadline currently admitted, and
    reads :attr:`current` when sizing the next batch.
    """
    base_rows: int
    min_rows: int = 8
    shrink_at: float = 0.8      # p95/deadline ratio that triggers shrink
    grow_at: float = 0.4        # ratio below which the budget regrows
    current: int = 0
    shrinks: int = 0
    grows: int = 0

    def __post_init__(self):
        self.base_rows = max(int(self.base_rows), 1)
        self.min_rows = max(min(int(self.min_rows), self.base_rows), 1)
        if not self.current:
            self.current = self.base_rows

    def update(self, p95_s: Optional[float],
               tightest_deadline_s: Optional[float],
               queued_units: int = 0) -> int:
        """One control step; returns the new row budget.

        ``p95_s`` is the lane's windowed tail latency (None = no samples
        yet), ``tightest_deadline_s`` the smallest relative deadline
        among recently admitted requests (None = nobody asked for one),
        ``queued_units`` the backlog depth (0 = idle, which always
        regrows — an idle lane should re-enter traffic at full Eq. 11
        throughput)."""
        if tightest_deadline_s is None or tightest_deadline_s <= 0:
            return self._grow()          # no SLO pressure: run at optimum
        if queued_units == 0:
            return self._grow()          # idle: regrow toward base
        if p95_s is None:
            return self.current
        ratio = p95_s / tightest_deadline_s
        if ratio > self.shrink_at:
            if self.current > self.min_rows:
                self.current = max(self.current // 2, self.min_rows)
                self.shrinks += 1
        elif ratio < self.grow_at:
            self._grow()
        return self.current

    def _grow(self) -> int:
        if self.current < self.base_rows:
            self.current = min(self.current * 2, self.base_rows)
            self.grows += 1
        return self.current


def profile_for_model(n_params: float, bytes_per_row: float,
                      flops_per_row: Optional[float] = None,
                      dtype_bytes: int = 4,
                      stored_bytes: Optional[float] = None) -> OpProfile:
    """``stored_bytes`` is the on-disk size a cold resolve actually reads
    (compressed deltas, deduped pages); omit it for uncompressed models."""
    return OpProfile(
        flops_per_row=flops_per_row if flops_per_row else 2.0 * n_params,
        bytes_per_row=bytes_per_row,
        model_bytes=n_params * dtype_bytes,
        stored_model_bytes=float(stored_bytes or 0.0))


def split_profile(p: OpProfile, head_dim: int,
                  dtype_bytes: int = 4) -> Tuple[OpProfile, OpProfile]:
    """Split a full-predict profile into (embed, head) stage profiles so
    Eq. 11 sizes the serving row budgets separately: the trunk keeps the
    model's FLOPs and staged weight bytes; the head is an O(head_dim)
    readout over already-computed embeddings with (next to) no weights
    to stage, so its budget lands on much larger batches."""
    head_dim = max(int(head_dim), 1)
    head_flops = 2.0 * head_dim
    head = OpProfile(flops_per_row=head_flops,
                     bytes_per_row=float(head_dim * dtype_bytes),
                     model_bytes=float(head_dim * dtype_bytes))
    embed = OpProfile(
        flops_per_row=max(p.flops_per_row - head_flops, 1.0),
        bytes_per_row=p.bytes_per_row,
        model_bytes=p.model_bytes,
        api_latency_s=p.api_latency_s,
        stored_model_bytes=p.stored_model_bytes)
    return embed, head


def delta_staged_profile(p: OpProfile, delta_bytes: float) -> OpProfile:
    """Eq. 7 staging for a fine-tune whose base trunk is already resident
    (resolved by another task, so its weights are warm in the layer cache
    and staged on device under the shared trunk identity): only the delta
    layers still have to move, so TransCost's ModelSize term shrinks to
    ``delta_bytes``. ExecTime is untouched — the composed model does the
    same math as a fully-materialized one."""
    return OpProfile(flops_per_row=p.flops_per_row,
                     bytes_per_row=p.bytes_per_row,
                     model_bytes=max(float(delta_bytes), 0.0),
                     api_latency_s=p.api_latency_s)


# ---------------------------------------------------------------------------
# Calibration: measure the live backend instead of trusting the spec sheet
# ---------------------------------------------------------------------------

def calibrate(backend, device: str = "host", *,
              dim: int = 32, width: int = 64,
              rows=(256, 2048), repeats: int = 3,
              seed: int = 0) -> HardwareProfile:
    """Measure a :class:`HardwareProfile` from a live execution backend.

    Runs a synthetic ``tanh(X @ W)`` embedder (the dominant inference
    shape) through ``backend.run_infer`` at a small and a large row count
    and linear-fits ``t(n) = launch + n * per_row``: the slope gives the
    effective per-row FLOP/byte throughput, the intercept the per-call
    launch latency — the numbers Eq. 10/11 actually need, including every
    real overhead (batching loops, kernel launches, padding) that spec-sheet
    constants miss. Link bandwidth is measured from a staging transfer
    when the backend exposes one (``measure_link_bandwidth``).

    Each timed call ends with ``backend.synchronize()`` where the backend
    has one (``torch.cuda.synchronize`` for a CUDA backend), so the clock
    reads finished device work.

    Mesh backends (``backend.device_count > 1``) are measured twice: the
    main fit runs through the mesh (so ``flops_per_s``/``mem_bw`` are the
    *aggregate* rates Eq. 11 sizes row budgets against), and a fresh
    single-device probe (``backend.per_device_probe()``) supplies the
    per-device rate recorded in ``device_flops_per_s``.
    """
    per_row, launch = _fit_per_row(backend, device, dim=dim, width=width,
                                   rows=rows, repeats=repeats, seed=seed)
    flops_per_row = 2.0 * dim * width + width      # matmul + tanh
    bytes_per_row = 4.0 * (dim + width)
    link_bw = DEFAULT_HW.get(device, DEFAULT_HW["host"]).link_bw
    measure_link = getattr(backend, "measure_link_bandwidth", None)
    if measure_link is not None:
        link_bw = measure_link()
    n_dev = int(getattr(backend, "device_count", 1))
    device_flops = 0.0
    probe_fn = getattr(backend, "per_device_probe", None)
    if n_dev > 1 and probe_fn is not None:
        dev_per_row, _ = _fit_per_row(probe_fn(), device, dim=dim,
                                      width=width, rows=rows,
                                      repeats=repeats, seed=seed)
        device_flops = flops_per_row / dev_per_row
    return HardwareProfile(
        name=device,
        flops_per_s=flops_per_row / per_row,
        mem_bw=bytes_per_row / per_row,
        link_bw=link_bw,
        launch_latency_s=launch,
        measured=True,
        device_count=n_dev,
        device_flops_per_s=device_flops)


def _fit_per_row(backend, device: str, *, dim: int, width: int, rows,
                 repeats: int, seed: int) -> Tuple[float, float]:
    """Two-point linear fit of the backend's embed time: (per-row
    seconds, launch latency)."""
    import numpy as np

    from repro_torch.pipeline.backend import InferSpec  # lazy import: cycle
    from repro_torch.pipeline.batcher import BatcherStats
    from repro_torch.core.zoo import ZooModel

    rng = np.random.default_rng(seed)
    W = (rng.standard_normal((dim, width)).astype(np.float32)
         / np.sqrt(dim))
    zm = ZooModel(name=f"__calib_{device}", source_family="gauss", W=W,
                  mode="linear")
    version = f"__calib_{device}@{dim}x{width}"
    model = _CalibModel(zm)
    spec = InferSpec(kind="embed", task="__calib__", col="x", out="f",
                     table="__calib__", version=version, model=model,
                     batch_size=32, share=None, stats=BatcherStats())
    backend.stage(version, zm)
    sync = getattr(backend, "synchronize", lambda: None)
    times = []
    for n in rows:
        X = rng.standard_normal((n, dim)).astype(np.float32)
        batch = {"x": X}
        backend.run_infer(spec, batch)          # warmup: build + stage
        sync()
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            backend.run_infer(spec, batch)
            sync()
            best = min(best, time.perf_counter() - t0)
        times.append(best)
    n0, n1 = int(rows[0]), int(rows[-1])
    t0_, t1_ = times[0], times[-1]
    per_row = max((t1_ - t0_) / max(n1 - n0, 1), 1e-12)
    launch = max(t0_ - n0 * per_row, 0.0)
    return per_row, launch


class _CalibModel:
    """ResolvedModel-shaped shim around a raw ZooModel for calibration."""

    def __init__(self, zm):
        self.zoo_model = zm
        self.features = zm.features
        self.head = lambda F: F.mean(axis=1)


# ---------------------------------------------------------------------------
# On-disk calibration memo: share probe results across processes and runs
# ---------------------------------------------------------------------------

def profile_memo_fingerprint(parts) -> str:
    """Host/backend/device-count identity of one calibration memo entry.

    The key *is* the staleness guard: torch-flavoured backends embed the
    torch version and, on CUDA, the device name and count; host-only ones
    the cpu count. An upgrade, another card or another device count simply
    misses the memo and re-probes. Backends that never touch torch
    deliberately don't import it here — numpy-only paths stay torch-free."""
    import os
    import platform
    toks = [platform.node() or "host"]
    toks += [str(p) for p in parts if p is not None]
    if any("torch" in t for t in toks[1:]):
        import torch
        toks.append(f"torch={torch.__version__}")
        if any("cuda" in t for t in toks[1:]):
            toks.append(f"cudadev={torch.cuda.get_device_name(0)}")
            toks.append(f"cudacount={torch.cuda.device_count()}")
        else:
            toks.append(f"cpus={os.cpu_count()}")
    else:
        toks.append(f"cpus={os.cpu_count()}")
    return "|".join(toks)


def load_profile_memo(path) -> Dict[str, HardwareProfile]:
    """Read an on-disk calibration memo ({fingerprint: profile fields}).
    Unreadable files and schema-drifted entries read as empty/stale —
    the caller just re-probes."""
    import json
    from pathlib import Path
    try:
        raw = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    if not isinstance(raw, dict):
        return {}
    out: Dict[str, HardwareProfile] = {}
    for fp, fields in raw.items():
        try:
            out[fp] = HardwareProfile(**fields)
        except TypeError:
            continue                       # schema drift: treat as stale
    return out


def store_profile_memo(path, fingerprint: str, prof: HardwareProfile) -> None:
    """Merge one measured profile into the on-disk memo. Atomic replace;
    concurrent workers race benignly (last writer wins with equivalent
    measurements for the same fingerprint)."""
    import dataclasses as _dc
    import json
    import os
    from pathlib import Path
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    memo = {fp: _dc.asdict(p) for fp, p in load_profile_memo(path).items()}
    memo[fingerprint] = _dc.asdict(prof)
    tmp = path.with_name(f"{path.name}.tmp{os.getpid()}")
    tmp.write_text(json.dumps(memo, indent=1, sort_keys=True))
    tmp.replace(path)
