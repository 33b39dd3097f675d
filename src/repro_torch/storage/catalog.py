"""Catalog tables (paper Fig. 2): model_info_table + model_layer_info_table.

A light embedded 'system catalog' kept as JSON on disk — the structural
analogue of MorphingDB's PostgreSQL tables, recording model metadata,
storage format, base-model lineage (decoupled storage), and per-layer
tensor locations for partial loading.

Port of ``src/repro/storage/catalog.py``.
"""
from __future__ import annotations

import json
import threading
import time
from dataclasses import asdict, dataclass, field
from pathlib import Path
from typing import Dict, List, Optional


@dataclass
class ModelInfo:
    model_id: str
    version: str = "1.0"
    task_types: List[str] = field(default_factory=list)
    modality: str = "text"               # text | image | series | multimodal
    storage: str = "decoupled"           # blob | decoupled | api
    path: str = ""                       # blob file / layer-table dir / URL
    base_model: Optional[str] = None     # decoupled: architecture lineage
    param_count: int = 0
    created_at: float = field(default_factory=time.time)
    extra: Dict = field(default_factory=dict)


@dataclass
class LayerInfo:
    model_id: str
    layer_name: str                      # flattened pytree key path
    layer_index: int
    dtype: str
    shape: List[int]
    nbytes: int
    file: str                            # Mvec file relative to table dir
    delta_of: Optional[str] = None       # fine-tune delta base layer
    enc: str = "dense"                   # payload encoding on disk
    bound: float = 0.0                   # declared max abs reconstruction err


class Catalog:
    """Thread-safe JSON-backed catalog."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self._lock = threading.Lock()
        self._models: Dict[str, ModelInfo] = {}
        self._layers: Dict[str, List[LayerInfo]] = {}
        self._load()

    # -- persistence -----------------------------------------------------
    @property
    def _models_file(self) -> Path:
        return self.root / "model_info_table.json"

    @property
    def _layers_file(self) -> Path:
        return self.root / "model_layer_info_table.json"

    def _load(self) -> None:
        if self._models_file.exists():
            raw = json.loads(self._models_file.read_text())
            self._models = {k: ModelInfo(**v) for k, v in raw.items()}
        if self._layers_file.exists():
            raw = json.loads(self._layers_file.read_text())
            self._layers = {k: [LayerInfo(**e) for e in v]
                            for k, v in raw.items()}

    def _flush(self) -> None:
        tmp = self._models_file.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {k: asdict(v) for k, v in self._models.items()}, indent=1))
        tmp.replace(self._models_file)
        tmp = self._layers_file.with_suffix(".tmp")
        tmp.write_text(json.dumps(
            {k: [asdict(e) for e in v] for k, v in self._layers.items()},
            indent=1))
        tmp.replace(self._layers_file)

    def reload(self) -> None:
        """Re-read the catalog tables from disk. Long-lived readers in
        other processes (dispatch-tier workers) call this before
        resolving a model that another process may have registered after
        this catalog was constructed."""
        with self._lock:
            self._models = {}
            self._layers = {}
            self._load()

    # -- API ----------------------------------------------------------------
    def register_model(self, info: ModelInfo) -> None:
        with self._lock:
            self._models[info.model_id] = info
            self._flush()

    def register_layers(self, model_id: str, layers: List[LayerInfo]) -> None:
        with self._lock:
            self._layers[model_id] = layers
            self._flush()

    def get_model(self, model_id: str) -> ModelInfo:
        return self._models[model_id]

    def get_layers(self, model_id: str) -> List[LayerInfo]:
        return self._layers.get(model_id, [])

    def list_models(self, task_type: Optional[str] = None,
                    modality: Optional[str] = None) -> List[ModelInfo]:
        out = list(self._models.values())
        if task_type:
            out = [m for m in out if task_type in m.task_types]
        if modality:
            out = [m for m in out if m.modality == modality]
        return out

    def drop_model(self, model_id: str) -> None:
        with self._lock:
            self._models.pop(model_id, None)
            self._layers.pop(model_id, None)
            self._flush()
