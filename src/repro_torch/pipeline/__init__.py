"""Port of ``src/repro/pipeline/__init__.py``."""
from repro_torch.pipeline.admission import (AdmissionPolicy, CircuitOpen,
                                            LaneBreaker, Rejected, RequestError,
                                            BATCH, BEST_EFFORT, INTERACTIVE,
                                            PRIORITIES, validate_priority)
from repro_torch.pipeline.backend import (ExecutionBackend, InferSpec,
                                          NumpyBackend, StagedModel, TorchBackend,
                                          default_host_backend, make_backends)
from repro_torch.pipeline.batcher import (BatcherStats, ContinuousBatcher, Request,
                                          WindowBatcher, run_batched)
from repro_torch.pipeline.cost import (DEFAULT_HW, DynamicBudget, HardwareProfile,
                                       OpProfile, batch_cost, calibrate,
                                       choose_batch_size, choose_device,
                                       delta_staged_profile, op_cost, place_dag,
                                       profile_for_model, split_profile)
from repro_torch.pipeline.dag import Dag, Edge, Node
from repro_torch.pipeline.operators import (Batch, aggregate, batch_len,
                                            concat_batches, filter_op, groupby_agg,
                                            groupby_aggs, iter_chunks, join, scan,
                                            slice_batch, window_op)
from repro_torch.pipeline.scheduler import ExecStats, PipelineExecutor
from repro_torch.pipeline.share import (AnnConfig, AnnShareTier, AnnStats,
                                        CacheChain, CacheTier, IvfFlatIndex,
                                        ShareStats, TierLookup, VectorShareCache,
                                        fingerprint, fingerprint_rows,
                                        simd_normalize_embed)

__all__ = [
    "AdmissionPolicy", "CircuitOpen", "LaneBreaker", "Rejected",
    "RequestError", "BATCH", "BEST_EFFORT", "INTERACTIVE", "PRIORITIES",
    "validate_priority", "DynamicBudget",
    "ExecutionBackend", "InferSpec", "NumpyBackend",
    "StagedModel", "TorchBackend", "default_host_backend", "make_backends",
    "BatcherStats", "ContinuousBatcher", "Request", "WindowBatcher",
    "run_batched", "DEFAULT_HW", "HardwareProfile", "OpProfile",
    "batch_cost", "calibrate", "choose_batch_size", "choose_device",
    "delta_staged_profile", "op_cost", "place_dag", "profile_for_model",
    "split_profile",
    "Dag", "Edge", "Node",
    "Batch", "aggregate", "batch_len", "concat_batches", "filter_op",
    "groupby_agg", "groupby_aggs", "iter_chunks", "join", "scan",
    "slice_batch", "window_op", "ExecStats", "PipelineExecutor",
    "AnnConfig", "AnnShareTier", "AnnStats", "CacheChain", "CacheTier",
    "IvfFlatIndex", "TierLookup",
    "ShareStats", "VectorShareCache", "fingerprint", "fingerprint_rows",
    "simd_normalize_embed",
]
