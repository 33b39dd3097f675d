"""Pipelined DAG execution (paper §5.2 'Pipeline Processing').

The executor is a *pure runtime*: it walks an already-annotated DAG in
Algorithm-1 order; independent operators of a wave run concurrently on a
thread pool (host relational work overlaps device inference), and each
node runs on the device its ``Node.device`` annotation names. Placement
itself is a planning decision — `repro_torch.pipeline.cost.place_dag` (Eq. 10)
or the `repro_torch.engine` optimizer annotates the DAG before execution.
Chunked mode streams table chunks through the whole DAG so stage i of
chunk c overlaps stage i+1 of chunk c-1 — the paper's 'minimize idle
time between stages' — with a configurable in-flight depth.

Port of ``src/repro/pipeline/scheduler.py``.
"""
from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from repro_torch.pipeline.backend import ExecutionBackend
from repro_torch.pipeline.dag import Dag, Node
from repro_torch.pipeline.operators import (Batch, batch_len, concat_batches,
                                            iter_chunks, slice_batch)


@dataclass
class ExecStats:
    wall_seconds: float = 0.0
    op_seconds: Dict[str, float] = field(default_factory=dict)
    device_of: Dict[str, str] = field(default_factory=dict)
    backend_of: Dict[str, str] = field(default_factory=dict)
    calls_of: Dict[str, int] = field(default_factory=dict)
    rows_out: int = 0


class PipelineExecutor:
    def __init__(self, dag: Dag, *, workers: int = 4,
                 backends: Optional[Dict[str, ExecutionBackend]] = None):
        self.dag = dag
        self.workers = workers
        self.backends = backends or {}
        self.stats = ExecStats()
        self._stats_lock = threading.Lock()

    # -- execution ---------------------------------------------------------
    def _run_node(self, node: Node, inputs: List[Any]) -> Any:
        backend = self.backends.get(node.device)
        t0 = time.perf_counter()
        if backend is not None:
            out = backend.run_node(node, inputs)
        else:
            out = (node.fn(*inputs) if node.fn
                   else (inputs[0] if inputs else None))
        dt = time.perf_counter() - t0
        # chunked mode runs nodes from pool threads: accumulate under the
        # lock (dict read-modify-write is not atomic across threads)
        with self._stats_lock:
            s = self.stats
            s.op_seconds[node.op_id] = s.op_seconds.get(node.op_id, 0.0) + dt
            s.calls_of[node.op_id] = s.calls_of.get(node.op_id, 0) + 1
            s.device_of[node.op_id] = node.device
            s.backend_of[node.op_id] = (backend.name if backend is not None
                                        else "fn")
        return out

    def execute(self, sources: Dict[str, Any]) -> Dict[str, Any]:
        """Single-shot wave execution with intra-wave parallelism."""
        dep = self.dag.dependency_map()
        results: Dict[str, Any] = dict(sources)
        t0 = time.time()
        with ThreadPoolExecutor(self.workers) as pool:
            for wave in self.dag.stages():
                futs: Dict[str, Future] = {}
                for op_id in wave:
                    if op_id in results:  # source node
                        continue
                    node = self.dag.nodes[op_id]
                    ins = [results[d] for d in sorted(
                        dep[op_id],
                        key=lambda u: node.meta.get("arg_order", {}).get(u, 0))]
                    futs[op_id] = pool.submit(self._run_node, node, ins)
                for op_id, f in futs.items():
                    results[op_id] = f.result()
        self.stats.wall_seconds = time.time() - t0
        return results

    def execute_chunked(self, source_id: str, table: Batch,
                        chunk_rows: int = 256,
                        sink_id: Optional[str] = None,
                        static: Optional[Dict[str, Any]] = None,
                        max_inflight: int = 3) -> Batch:
        """Stream chunks through the DAG with cross-chunk stage overlap:
        chunk c's wave w runs while chunk c+1's wave w-1 runs. ``static``
        supplies non-streamed sources (e.g. dimension tables);
        ``max_inflight`` bounds how many chunks may be in the pipeline at
        once (memory vs overlap trade-off)."""
        static = static or {}
        max_inflight = max(1, max_inflight)
        order = [v for v in self.dag.execution_order()
                 if v != source_id and v not in static]
        dep = self.dag.dependency_map()
        t0 = time.time()
        outs: List[Batch] = []
        with ThreadPoolExecutor(self.workers) as pool:
            inflight: List[Dict[str, Future]] = []

            def launch(chunk: Batch) -> Dict[str, Future]:
                futs: Dict[str, Future] = {}
                base: Dict[str, Any] = {source_id: chunk, **static}

                def make_runner(op_id):
                    node = self.dag.nodes[op_id]

                    def run():
                        ins = []
                        for d in sorted(dep[op_id], key=lambda u: node.meta
                                        .get("arg_order", {}).get(u, 0)):
                            ins.append(base[d] if d in base
                                       else futs[d].result())
                        return self._run_node(node, ins)
                    return run

                for op_id in order:
                    futs[op_id] = pool.submit(make_runner(op_id))
                return futs

            chunks = iter_chunks(table, chunk_rows)
            if batch_len(table) == 0:
                # stream one empty chunk so the output keeps the schema
                # the pipeline produces (columns, dtypes) at zero rows
                chunks = iter([slice_batch(table, 0, 0)])
            for chunk in chunks:
                inflight.append(launch(chunk))
                if len(inflight) > max_inflight - 1:  # bounded depth
                    done = inflight.pop(0)
                    outs.append(done[sink_id or order[-1]].result())
            for futs in inflight:
                outs.append(futs[sink_id or order[-1]].result())
        self.stats.wall_seconds = time.time() - t0
        result = concat_batches(outs) if outs else {}
        self.stats.rows_out = batch_len(result)
        return result
