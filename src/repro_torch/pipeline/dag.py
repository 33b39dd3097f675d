"""Operator DAG + Algorithm 1 (pipeline dependency discovery).

Queries are parsed into a DAG of relational + inference operators. The
dependency-discovery algorithm labels edges (data vs control dependency)
and produces a DFS-based topological execution order, prioritizing
high-cost operators (paper §5.2, Algorithm 1).

Port of ``src/repro/pipeline/dag.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Set, Tuple


@dataclass
class Node:
    op_id: str
    kind: str                     # scan | filter | join | groupby | window
    #                             # | predict | embed | sink
    fn: Optional[Callable] = None
    cost_hint: float = 1.0        # relative cost estimate for prioritization
    device: str = "host"          # host | cuda | api  (set by the cost model)
    meta: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Edge:
    src: str
    dst: str
    label: str = "data"           # data | control (Algorithm 1 lines 6-12)


class Dag:
    def __init__(self):
        self.nodes: Dict[str, Node] = {}
        self.edges: List[Edge] = []

    def add(self, node: Node, deps: Tuple[str, ...] = (),
            control_deps: Tuple[str, ...] = ()) -> Node:
        if node.op_id in self.nodes:
            raise ValueError(f"duplicate op {node.op_id}")
        self.nodes[node.op_id] = node
        for d in deps:
            self.edges.append(Edge(d, node.op_id, "data"))
        for d in control_deps:
            self.edges.append(Edge(d, node.op_id, "control"))
        return node

    # -- Algorithm 1 -------------------------------------------------------
    def dependency_map(self) -> Dict[str, Set[str]]:
        """lines 3-5: D(v) = {u | (u, v) in E}."""
        dep: Dict[str, Set[str]] = {v: set() for v in self.nodes}
        for e in self.edges:
            dep[e.dst].add(e.src)
        return dep

    def label_edges(self) -> List[Edge]:
        """lines 6-12: classify edges. An edge is a *data* dependency when
        the upstream's output feeds the downstream's input; control
        dependencies only constrain ordering (e.g. barrier after DDL)."""
        for e in self.edges:
            if e.label not in ("data", "control"):
                e.label = "data"
        return self.edges

    def execution_order(self) -> List[str]:
        """lines 13-15: DFS topological sort; among ready nodes the
        higher-cost operator is scheduled first so long poles start early
        (critical-path prioritization)."""
        dep = self.dependency_map()
        order: List[str] = []
        visited: Set[str] = set()
        visiting: Set[str] = set()

        def dfs(v: str) -> None:
            if v in visited:
                return
            if v in visiting:
                raise ValueError(f"cycle through {v}")
            visiting.add(v)
            for u in sorted(dep[v],
                            key=lambda u: -self.nodes[u].cost_hint):
                dfs(u)
            visiting.discard(v)
            visited.add(v)
            order.append(v)

        roots = sorted(self.nodes,
                       key=lambda v: -self.nodes[v].cost_hint)
        for v in roots:
            dfs(v)
        return order

    def stages(self) -> List[List[str]]:
        """Wave decomposition: nodes whose deps are all satisfied run in
        the same stage (the unit of pipeline overlap)."""
        dep = self.dependency_map()
        done: Set[str] = set()
        waves: List[List[str]] = []
        remaining = set(self.nodes)
        while remaining:
            ready = sorted([v for v in remaining if dep[v] <= done],
                           key=lambda v: -self.nodes[v].cost_hint)
            if not ready:
                raise ValueError("cycle detected")
            waves.append(ready)
            done.update(ready)
            remaining -= set(ready)
        return waves

    def validate_topological(self, order: List[str]) -> bool:
        pos = {v: i for i, v in enumerate(order)}
        return all(pos[e.src] < pos[e.dst] for e in self.edges)
