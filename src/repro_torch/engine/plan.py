"""Logical plan IR + optimizer for the task-centric query engine.

A :class:`LogicalPlan` is an ordered chain of operators over one table
(the SQL subset the engine speaks is single-table):

    scan -> [filter|project|embed|predict]* -> [agg]

The optimizer runs three passes before lowering to a `repro_torch.pipeline.Dag`:

1. **Predicate pushdown** — filters that only reference base columns are
   moved below `predict`/`embed` nodes so inference never runs on rows a
   WHERE clause would discard.
2. **Embed insertion** (paper §5.1 pre-embedding) — each `predict` is
   split into an `embed` node (the expensive feature extraction, routed
   through :class:`~repro_torch.pipeline.share.VectorShareCache` so repeated
   queries over the same data reuse stored vectors) and a cheap head-only
   `predict`.
3. **Placement + batch annotation** (paper Eq. 10/11) — each inference
   node is annotated with the cost-model device and batch size; the
   executor is a pure runtime and only reads the annotations.

Lowering (:func:`compile_plan`) binds operator closures: `embed` nodes go
through the share cache with a :class:`~repro_torch.pipeline.batcher.WindowBatcher`
inside (window aggregation -> one batched device call), `filter` nodes
evaluate conjunctive predicates, and the final `agg` is *not* streamed —
the session applies it after chunks are concatenated so grouped results
are exact under chunked execution.

Port of ``src/repro/engine/plan.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.pipeline.backend import InferSpec, default_host_backend
from repro_torch.pipeline.batcher import BatcherStats
from repro_torch.pipeline.cost import (HardwareProfile, OpProfile,
                                       choose_batch_size, choose_device)
from repro_torch.pipeline.dag import Dag, Node
from repro_torch.pipeline.operators import Batch, filter_op

# predicate operators for conjunctive WHERE clauses
_CMP: Dict[str, Callable[[np.ndarray, Any], np.ndarray]] = {
    ">": lambda c, v: c > v,
    ">=": lambda c, v: c >= v,
    "<": lambda c, v: c < v,
    "<=": lambda c, v: c <= v,
    "=": lambda c, v: c == v,
    "!=": lambda c, v: c != v,
}


@dataclass
class PlanNode:
    op: str                      # scan | filter | project | embed
    #                            # | predict | agg | sort | limit
    #                            # | index_scan
    args: Dict[str, Any] = field(default_factory=dict)

    def describe(self) -> str:
        a = self.args
        if self.op == "scan":
            return f"scan({a['table']})"
        if self.op == "index_scan":
            return (f"index_scan({a['table']}.{a['col']} "
                    f"top-{a['k']} via cache chain)")
        if self.op == "sort":
            d = "ASC" if a.get("ascending") else "DESC"
            return f"sort(SIMILARITY({a['col']}) {d})"
        if self.op == "limit":
            return f"limit({a['k']})"
        if self.op == "filter":
            preds = " AND ".join(f"{c}{o}{v!r}" for c, o, v in a["preds"])
            return f"filter({preds})"
        if self.op == "project":
            return f"project({', '.join(a['cols'])})"
        if self.op == "embed":
            dev = a.get("device", "?")
            bs = a.get("batch_size", "?")
            return (f"embed({a['task']}.{a['col']} -> {a['out']} "
                    f"@{dev} b={bs} shared)")
        if self.op == "predict":
            dev = a.get("device", "?")
            head = " head" if a.get("head_only") else ""
            return f"predict({a['task']}({a['col']}) -> {a['out']} @{dev}{head})"
        if self.op == "agg":
            g = a.get("group_by")
            s = ", ".join(f"{agg}({c})" for c, agg, _ in a["specs"])
            return f"agg({s}{' GROUP BY ' + g if g else ''})"
        return self.op


@dataclass
class LogicalPlan:
    nodes: List[PlanNode] = field(default_factory=list)

    # -- builder ---------------------------------------------------------
    @staticmethod
    def scan(table: str) -> "LogicalPlan":
        return LogicalPlan([PlanNode("scan", {"table": table})])

    def filter(self, preds: Sequence[Tuple[str, str, Any]]) -> "LogicalPlan":
        self.nodes.append(PlanNode("filter", {"preds": list(preds)}))
        return self

    def project(self, cols: Sequence[str]) -> "LogicalPlan":
        self.nodes.append(PlanNode("project", {"cols": list(cols)}))
        return self

    def predict(self, task: str, col: str,
                out: Optional[str] = None) -> "LogicalPlan":
        self.nodes.append(PlanNode("predict", {
            "task": task, "col": col, "out": out or "_score"}))
        return self

    def agg(self, group_by: Optional[str],
            specs: Sequence[Tuple[str, str, str]]) -> "LogicalPlan":
        self.nodes.append(PlanNode("agg", {"group_by": group_by,
                                           "specs": list(specs)}))
        return self

    def order_by_similarity(self, col: str, query: Any,
                            ascending: bool = False,
                            drop_col: Optional[str] = None
                            ) -> "LogicalPlan":
        """Rank rows by nearness of ``col`` to ``query`` (a vector or a
        text string). Like `agg`, sorting is applied by the session over
        the concatenated stream, not per chunk. ``drop_col`` marks a
        column carried only for ordering (dropped from the output)."""
        self.nodes.append(PlanNode("sort", {
            "col": col, "query": query, "ascending": ascending,
            "drop_col": drop_col}))
        return self

    def limit(self, k: int) -> "LogicalPlan":
        self.nodes.append(PlanNode("limit", {"k": int(k)}))
        return self

    # -- introspection ---------------------------------------------------
    @property
    def table(self) -> str:
        return self.nodes[0].args["table"]

    def describe(self) -> str:
        return " -> ".join(n.describe() for n in self.nodes)

    def ops(self) -> List[str]:
        return [n.op for n in self.nodes]


# ---------------------------------------------------------------------------
# Optimizer passes
# ---------------------------------------------------------------------------

def _produced_columns(node: PlanNode) -> List[str]:
    if node.op in ("embed", "predict"):
        return [node.args["out"]]
    return []


def push_down_filters(plan: LogicalPlan) -> LogicalPlan:
    """Move filters below embed/predict nodes whose outputs they don't
    reference (classic predicate pushdown: don't infer on rows WHERE
    would drop)."""
    nodes = list(plan.nodes)
    moved = True
    while moved:
        moved = False
        for i in range(1, len(nodes)):
            if nodes[i].op != "filter":
                continue
            above = nodes[i - 1]
            if above.op not in ("embed", "predict", "project"):
                continue
            pred_cols = {c for c, _, _ in nodes[i].args["preds"]}
            if above.op == "project":
                # projection only narrows columns; filter needs them upstream
                if not pred_cols <= set(above.args["cols"]):
                    continue
            elif pred_cols & set(_produced_columns(above)):
                continue  # filter reads the inference output: can't move
            nodes[i - 1], nodes[i] = nodes[i], nodes[i - 1]
            moved = True
    plan.nodes = nodes
    return plan


def insert_embeds(plan: LogicalPlan) -> LogicalPlan:
    """Split each full `predict` into `embed` (expensive features, served
    through the vector-share cache) + head-only `predict`."""
    out: List[PlanNode] = []
    for node in plan.nodes:
        if node.op == "predict" and not node.args.get("head_only"):
            task, col = node.args["task"], node.args["col"]
            emb_col = f"__emb_{task}_{col}"
            out.append(PlanNode("embed", {
                "task": task, "col": col, "out": emb_col}))
            out.append(PlanNode("predict", {
                "task": task, "col": emb_col, "out": node.args["out"],
                "head_only": True}))
        else:
            out.append(node)
    plan.nodes = out
    return plan


def annotate_plan(plan: LogicalPlan, profiles: Dict[str, OpProfile],
                  nrows_hint: int = 1024, devices=("host", "cuda"),
                  mem_cap_bytes: float = 2e9,
                  hw: Optional[Dict[str, HardwareProfile]] = None
                  ) -> LogicalPlan:
    """Plan-time device placement (Eq. 10) and batch-size selection
    (Eq. 11). ``profiles`` maps task name -> OpProfile of the resolved
    model; ``hw`` supplies calibrated hardware profiles (measured from
    the live backends) that override the spec-sheet defaults. Head-only
    predicts are O(rows) host work."""
    for node in plan.nodes:
        if node.op == "embed" or (node.op == "predict"
                                  and not node.args.get("head_only")):
            prof = profiles.get(node.args["task"])
            if prof is None:
                node.args.setdefault("device", "host")
                node.args.setdefault("batch_size", 32)
                continue
            dev = choose_device(prof, nrows_hint, devices, hw)
            node.args["device"] = dev
            node.args["batch_size"] = choose_batch_size(
                prof, dev, mem_cap_bytes=mem_cap_bytes, hw=hw)
        elif node.op == "predict":
            node.args["device"] = "host"
    return plan


def lower_similarity(plan: LogicalPlan) -> LogicalPlan:
    """Serve ``ORDER BY SIMILARITY(...) LIMIT k`` straight from the
    share-cache chain: when the plan has no filter or aggregate and
    wants the nearest rows first, the scan is replaced by an
    ``index_scan`` node that scores the whole table through the cache
    tiers (warm cache = exact/ANN gather, zero trunk rows) and feeds
    only the k nearest rows to the rest of the plan."""
    ops = plan.ops()
    if "sort" not in ops or "limit" not in ops:
        return plan
    if "filter" in ops or "agg" in ops:
        # predicates/aggregates must see every surviving row before the
        # top-k cut; fall back to the post-stream sort + limit
        return plan
    sort = next(n for n in plan.nodes if n.op == "sort")
    if sort.args.get("ascending"):
        return plan                  # fast path is nearest-first only
    lim = next(n for n in plan.nodes if n.op == "limit")
    col = sort.args["col"]
    # an embed/predict consuming the column scopes similarity to that
    # task's trunk embedding space (the session resolves the model)
    task = next((n.args["task"] for n in plan.nodes
                 if n.op in ("embed", "predict")
                 and n.args.get("col") == col), None)
    idx = PlanNode("index_scan", {
        "table": plan.table, "col": col, "query": sort.args["query"],
        "k": int(lim.args["k"]), "task": task,
        "drop_col": sort.args.get("drop_col")})
    plan.nodes = [idx] + [n for n in plan.nodes[1:]
                          if n.op not in ("sort", "limit")]
    return plan


def optimize(plan: LogicalPlan, profiles: Dict[str, OpProfile],
             nrows_hint: int = 1024, devices=("host", "cuda"),
             hw: Optional[Dict[str, HardwareProfile]] = None) -> LogicalPlan:
    plan = push_down_filters(plan)
    plan = insert_embeds(plan)
    # pushdown again: embed insertion may leave a filter above an embed
    plan = push_down_filters(plan)
    plan = lower_similarity(plan)
    return annotate_plan(plan, profiles, nrows_hint, devices, hw=hw)


# ---------------------------------------------------------------------------
# Lowering: LogicalPlan -> pipeline Dag
# ---------------------------------------------------------------------------

@dataclass
class CompileContext:
    """Runtime bindings the lowered DAG closes over."""
    models: Dict[str, Any]                  # task -> ResolvedModel
    share: Optional[Any] = None             # VectorShareCache
    batcher_stats: Dict[str, BatcherStats] = field(default_factory=dict)
    share_version_of: Dict[str, str] = field(default_factory=dict)


def _make_pred(preds: Sequence[Tuple[str, str, Any]]):
    def pred(b: Batch) -> np.ndarray:
        mask = None
        for col, op, val in preds:
            m = _CMP[op](b[col], val)
            mask = m if mask is None else (mask & m)
        return mask
    return pred


def _infer_node(op_id: str, kind: str, spec: InferSpec,
                device: str, cost_hint: float) -> Node:
    """Build an inference Node: the InferSpec in ``meta`` is what a
    registered backend executes natively; ``fn`` is the host fallback
    (same spec through the singleton numpy backend) for executors built
    without a registry."""
    node = Node(op_id, kind,
                fn=lambda b, _s=spec: default_host_backend().run_infer(_s, b),
                cost_hint=cost_hint, device=device)
    node.meta["infer"] = spec
    return node


def compile_plan(plan: LogicalPlan, ctx: CompileContext,
                 workers_hint: int = 4) -> Tuple[Dag, str, str,
                                                 Optional[PlanNode]]:
    """Lower to a Dag. Returns (dag, source_id, sink_id, agg_node);
    ``agg_node`` (if any) is applied by the caller *after* chunked
    results are concatenated, so grouped aggregates stay exact."""
    dag = Dag()
    table = plan.table
    dag.add(Node(table, "scan"))
    prev = table
    agg_node: Optional[PlanNode] = None
    counters: Dict[str, int] = {}

    def fresh(opname: str) -> str:
        counters[opname] = counters.get(opname, 0) + 1
        n = counters[opname]
        return opname if n == 1 else f"{opname}{n}"

    for node in plan.nodes[1:]:
        if node.op == "agg":
            agg_node = node
            continue
        if node.op == "filter":
            op_id = fresh("filter")
            pred = _make_pred(node.args["preds"])
            dag.add(Node(op_id, "filter",
                         fn=(lambda p: lambda b: filter_op(b, p))(pred)),
                    deps=(prev,))
        elif node.op == "project":
            op_id = fresh("project")
            cols = list(node.args["cols"])
            dag.add(Node(op_id, "project",
                         fn=(lambda cs: lambda b: {k: b[k] for k in cs
                                                   if k in b})(cols)),
                    deps=(prev,))
        elif node.op == "embed":
            op_id = fresh("embed")
            task = node.args["task"]
            spec = InferSpec(
                kind="embed", task=task, col=node.args["col"],
                out=node.args["out"], table=table,
                version=ctx.share_version_of.get(task, "v1"),
                model=ctx.models[task],
                batch_size=int(node.args.get("batch_size", 32)),
                share=ctx.share,
                stats=ctx.batcher_stats.setdefault(task, BatcherStats()))
            dag.add(_infer_node(op_id, "embed", spec, cost_hint=8.0,
                                device=node.args.get("device", "host")),
                    deps=(prev,))
        elif node.op == "predict":
            op_id = fresh("predict")
            task = node.args["task"]
            model = ctx.models[task]
            col, out = node.args["col"], node.args["out"]
            if node.args.get("head_only"):
                # cheap O(rows) score head: stays a host closure
                def pred_fn(b, _c=col, _o=out, _m=model):
                    res = dict(b)
                    res[_o] = _m.head(b[_c])
                    return res
                dag.add(Node(op_id, "predict", fn=pred_fn, cost_hint=1.0,
                             device=node.args.get("device", "host")),
                        deps=(prev,))
            else:
                spec = InferSpec(
                    kind="predict", task=task, col=col, out=out,
                    table=table,
                    version=ctx.share_version_of.get(task, "v1"),
                    model=model,
                    batch_size=int(node.args.get("batch_size", 32)),
                    share=None,
                    stats=ctx.batcher_stats.setdefault(task,
                                                       BatcherStats()))
                dag.add(_infer_node(op_id, "predict", spec, cost_hint=8.0,
                                    device=node.args.get("device", "host")),
                        deps=(prev,))
        else:
            raise ValueError(f"cannot lower plan op {node.op}")
        prev = op_id
    return dag, table, prev, agg_node
