"""Task-centric query engine: SQL -> logical plan -> optimizer ->
annotated DAG -> chunked pipeline runtime, with model resolution through
the selection subspace + storage catalog and pre-embedding via the
vector-share cache. `MorphingSession` is the single entry point.

Port of ``src/repro/engine/__init__.py``: the session path, the online
serving tier (``MorphingServer``) and the multi-process dispatch tier
(``DispatchServer``).
"""
from repro_torch.engine.config import EngineConfig
from repro_torch.engine.dispatch import (DispatchServer, DispatchStats,
                                         PlacementPolicy)
from repro_torch.engine.plan import (CompileContext, LogicalPlan, PlanNode,
                                     annotate_plan, compile_plan, insert_embeds,
                                     lower_similarity, optimize,
                                     push_down_filters)
from repro_torch.pipeline.admission import (AdmissionPolicy, CircuitOpen,
                                            Rejected, RequestError)
from repro_torch.engine.serve import MorphingServer, ServeResult, ServerStats
from repro_torch.engine.session import (MorphingSession, QueryReport, QueryResult,
                                        ResolvedModel)
from repro_torch.engine.sql import (CreateTaskStmt, QueryStmt, SelectItem,
                                    TaskCall, encode_text, parse, tokenize)
from repro_torch.pipeline.share import (AnnConfig, AnnShareTier, CacheChain,
                                        CacheTier, IvfFlatIndex, TierLookup)

__all__ = [
    "EngineConfig", "DispatchServer", "DispatchStats", "PlacementPolicy",
    "MorphingServer", "ServeResult", "ServerStats",
    "CompileContext", "LogicalPlan", "PlanNode", "annotate_plan",
    "compile_plan", "insert_embeds", "lower_similarity", "optimize",
    "push_down_filters",
    "AdmissionPolicy", "CircuitOpen", "Rejected", "RequestError",
    "MorphingSession", "QueryReport", "QueryResult", "ResolvedModel",
    "CreateTaskStmt", "QueryStmt", "SelectItem", "TaskCall",
    "encode_text", "parse", "tokenize",
    "AnnConfig", "AnnShareTier", "CacheChain", "CacheTier",
    "IvfFlatIndex", "TierLookup",
]
