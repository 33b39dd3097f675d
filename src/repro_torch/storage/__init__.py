"""Model stores, the system catalog and the Mvec tensor format.

Port of ``src/repro/storage/__init__.py``.
"""
from repro_torch.storage import mvec
from repro_torch.storage.catalog import Catalog, LayerInfo, ModelInfo
from repro_torch.storage.checkpoint import CheckpointManager
from repro_torch.storage.stores import (ApiModelRegistry, BlobStore,
                                        DecoupledStore, StoreStats,
                                        flatten_params, unflatten_like)

__all__ = [
    "mvec", "Catalog", "LayerInfo", "ModelInfo", "CheckpointManager",
    "ApiModelRegistry", "BlobStore", "DecoupledStore", "StoreStats",
    "flatten_params", "unflatten_like",
]
