"""EngineConfig: the one construction surface for the engine.

`MorphingSession` and `MorphingServer` historically grew overlapping
keyword arguments (the server's ``devices=`` int versus the session's
``device_count=``, duplicated store/calibration/share knobs forwarded
through ``**session_kw``), each pair needing its own conflict check.
`EngineConfig` collapses them into one validated dataclass consumed by
both entry points::

    cfg = EngineConfig(model_store="decoupled", device_count=2,
                       cache_tiers=("exact", "ann"),
                       ann=AnnConfig(error_bound=0.1))
    sess = MorphingSession(selector=sel, zoo=zoo, config=cfg)
    server = MorphingServer(config=cfg)

Every legacy keyword keeps working as a deprecation shim: explicit
kwargs overlay the config (and the server's ``devices=`` emits a
DeprecationWarning pointing at ``device_count``).

Port of ``src/repro/engine/config.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from repro_torch.pipeline.share import AnnConfig

# sentinel distinguishing "kwarg not passed" from an explicit value, so
# legacy kwargs can overlay a provided config without clobbering it
UNSET: Any = object()

_VALID_STORES = ("blob", "decoupled")
_VALID_TIERS = ("exact", "ann")


@dataclass
class EngineConfig:
    """Shared engine configuration (session + server).

    ``cache_tiers`` names the share-cache chain in lookup order:
    ``("exact",)`` is the classic fingerprint-equality cache;
    ``("exact", "ann")`` appends the opt-in approximate tier
    (:class:`repro_torch.pipeline.share.AnnShareTier`) configured by ``ann``.
    ``policy`` is the serving admission policy (ignored by plain
    sessions).

    ``calib_memo_path`` opts fast auto-calibration into an on-disk memo
    (JSON) keyed by a host/backend/device-count fingerprint, so N worker
    processes and repeated CI legs stop re-paying the two-point probe;
    entries go stale — and re-probe — when the torch version or the CUDA
    device name or count changes (the fingerprint embeds them).

    ``backend`` is ``"auto"`` (host: numpy, cuda: torch), ``"numpy"`` or
    ``"torch"``. ``torch_device`` is the device every torch backend runs
    on: ``"cuda"`` by default, and a session asked for it on a machine
    without CUDA raises rather than degrading. Tests pass ``"cpu"``, where
    the kernels' wrappers take their plain PyTorch versions."""

    model_store: str = "blob"
    backend: str = "auto"
    devices: Tuple[str, ...] = ("host", "cuda")
    device_count: int = 1
    torch_device: str = "cuda"
    # decoupled-store compression (docs/architecture.md): sparse/quantized
    # fine-tune deltas and content-hashed tensor-page dedup. Off by
    # default — both change on-disk layout (reads stay transparent).
    compress_deltas: bool = False
    quant_dtype: str = "int8"            # code width for dense residuals
    sparse_eps: float = 0.0              # |delta| <= eps sparsified away
    dedup_pages: bool = False
    page_bytes: int = 64 << 10
    auto_calibrate: bool = True
    calib_memo_path: Optional[str] = None
    enable_share: bool = True
    share_capacity_bytes: int = 1 << 30
    cache_tiers: Tuple[str, ...] = ("exact",)
    ann: Optional[AnnConfig] = None
    chunk_rows: int = 256
    max_inflight: int = 3
    workers: int = 4
    optimize_plans: bool = True
    policy: Optional[Any] = None         # AdmissionPolicy (serving only)

    def validate(self) -> "EngineConfig":
        if self.model_store not in _VALID_STORES:
            raise ValueError(f"unknown model_store {self.model_store!r}")
        tiers = tuple(self.cache_tiers)
        unknown = [t for t in tiers if t not in _VALID_TIERS]
        if unknown:
            raise ValueError(
                f"unknown cache tier(s) {unknown}; valid: {_VALID_TIERS}")
        if tiers and tiers[0] != "exact":
            # approximate tiers serve *residual* misses; putting one in
            # front of the exact tier would approximate rows the cache
            # could have answered exactly
            raise ValueError("cache_tiers must start with 'exact'")
        if self.device_count < 1:
            raise ValueError(
                f"device_count must be >= 1, got {self.device_count}")
        if self.quant_dtype not in ("int8", "int16"):
            raise ValueError(
                f"quant_dtype must be int8|int16, got {self.quant_dtype!r}")
        if self.sparse_eps < 0:
            raise ValueError(
                f"sparse_eps must be >= 0, got {self.sparse_eps}")
        if self.page_bytes < 1:
            raise ValueError(
                f"page_bytes must be >= 1, got {self.page_bytes}")
        return self

    def overlaid(self, overrides: Dict[str, Any]) -> "EngineConfig":
        """Copy with explicitly-passed legacy kwargs overlaid (UNSET
        entries are dropped)."""
        real = {k: v for k, v in overrides.items() if v is not UNSET}
        return dataclasses.replace(self, **real) if real else self
