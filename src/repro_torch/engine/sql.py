"""MiniSQL: the task-centric SQL surface (paper §2.1, Table 1), promoted
from the original `examples/` regex demo into a real tokenizer + recursive
descent parser that lowers to the engine's logical plan IR.

Supported statements::

    CREATE TASK name (INPUT=Series, OUTPUT IN ('POS','NEG'),
        TYPE='Classification');

    SELECT gender, AVG(sentiment_classifier(emb)), COUNT(*)
        FROM reviews WHERE len > 20 AND gender = 1 GROUP BY gender;

    PREDICT emb USING TASK sentiment_classifier FROM reviews
        WHERE len > 20;

    SELECT id FROM reviews
        ORDER BY SIMILARITY(emb, [0.1, 0.2, 0.3]) LIMIT 5;

WHERE supports conjunctions of ``col <op> literal`` with op in
``> >= < <= = !=``; aggregates are ``COUNT(*|col)``, ``SUM``, ``AVG``
over plain columns or task calls ``task(col)``. Task calls resolve to a
model through the session (selection subspace + catalog) — the user never
names a model.

``ORDER BY SIMILARITY(col, <query>)`` ranks rows by nearness to the
query — a ``[v1, v2, ...]`` vector literal or a quoted text string
(feature-hashed to the column width by :func:`encode_text`). The default
(``DESC``) order is nearest-first; with ``LIMIT k`` and no filter or
aggregate, the optimizer lowers the whole query to an index scan served
from the share-cache chain (the ANN tier's top-k fast path).

Port of ``src/repro/engine/sql.py``.
"""
from __future__ import annotations

import re
import zlib
from dataclasses import dataclass, field
from typing import Any, List, Optional, Tuple

import numpy as np

from repro_torch.core.task import TaskSpec
from repro_torch.engine.plan import LogicalPlan

_TOKEN_RE = re.compile(
    r"\s*(?:(?P<num>-?\d+\.\d+|-?\d+)|(?P<id>[A-Za-z_]\w*)"
    r"|(?P<str>'[^']*'|\"[^\"]*\")|(?P<sym><=|>=|!=|<>|[(),*=<>;\[\]]))")

_AGGS = {"COUNT": "count", "SUM": "sum", "AVG": "mean"}
_CMP_OPS = {">", ">=", "<", "<=", "=", "!=", "<>"}


def encode_text(text: str, dim: int) -> np.ndarray:
    """Deterministic feature-hashing text vectorizer for SIMILARITY
    query literals: character trigrams hashed (crc32, stable across
    processes) into ``dim`` signed buckets, L2-normalised. Not a learned
    embedding — just a fixed, reproducible text -> R^dim map so quoted
    strings can be compared against vector columns."""
    v = np.zeros(max(int(dim), 1), dtype=np.float32)
    t = f"  {text.lower()}  "
    for i in range(len(t) - 2):
        h = zlib.crc32(t[i:i + 3].encode("utf-8"))
        v[h % len(v)] += 1.0 if (h >> 16) & 1 else -1.0
    n = float(np.linalg.norm(v))
    return v / n if n else v


def tokenize(sql: str) -> List[str]:
    toks, pos = [], 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            if sql[pos:].strip():
                raise ValueError(f"bad token at: {sql[pos:pos + 20]!r}")
            break
        pos = m.end()
        tok = m.group().strip()
        if tok:
            toks.append(tok)
    return toks


@dataclass
class TaskCall:
    task: str
    col: str


@dataclass
class SelectItem:
    expr: Any                    # str column | TaskCall
    agg: Optional[str] = None    # count | sum | mean
    star: bool = False           # COUNT(*)


@dataclass
class CreateTaskStmt:
    spec: TaskSpec


@dataclass
class QueryStmt:
    plan: LogicalPlan
    tasks: List[str] = field(default_factory=list)
    output_cols: List[str] = field(default_factory=list)


Statement = Any  # CreateTaskStmt | QueryStmt


class _Parser:
    def __init__(self, toks: List[str]):
        self.toks = toks
        self.i = 0

    # -- plumbing --------------------------------------------------------
    def peek(self) -> Optional[str]:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        t = self.peek()
        if t is None:
            raise ValueError("unexpected end of statement")
        self.i += 1
        return t

    def expect(self, *alts: str) -> str:
        t = self.next()
        if t.upper() not in alts and t not in alts:
            raise ValueError(f"expected {'/'.join(alts)}, got {t!r}")
        return t

    def at_kw(self, kw: str) -> bool:
        t = self.peek()
        return t is not None and t.upper() == kw

    # -- terminals -------------------------------------------------------
    def literal(self) -> Any:
        t = self.next()
        if t[0] in "'\"":
            return t[1:-1]
        if re.fullmatch(r"-?\d+", t):
            return int(t)
        if re.fullmatch(r"-?\d+\.\d+", t):
            return float(t)
        return t  # bare identifier treated as string literal

    # -- clauses ---------------------------------------------------------
    def where_clause(self) -> List[Tuple[str, str, Any]]:
        preds = []
        while True:
            col = self.next()
            op = self.next()
            if op not in _CMP_OPS:
                raise ValueError(f"bad comparison operator {op!r}")
            if op == "<>":
                op = "!="
            preds.append((col, op, self.literal()))
            if self.at_kw("AND"):
                self.next()
                continue
            break
        return preds

    def similarity_clause(self) -> Tuple[str, Any, bool]:
        """``SIMILARITY(col, <[vector]|'text'>) [ASC|DESC]`` — returns
        (col, query, ascending); DESC (nearest first) is the default."""
        self.expect("SIMILARITY")
        self.expect("(")
        col = self.next()
        self.expect(",")
        if self.peek() == "[":
            self.next()
            vals: List[float] = []
            while self.peek() != "]":
                vals.append(float(self.literal()))
                if self.peek() == ",":
                    self.next()
            self.expect("]")
            query: Any = np.asarray(vals, dtype=np.float32)
        else:
            t = self.next()
            if t[0] not in "'\"":
                raise ValueError(
                    "SIMILARITY query must be a [vector] literal or a "
                    f"quoted text string, got {t!r}")
            query = t[1:-1]
        self.expect(")")
        ascending = False
        if self.at_kw("ASC"):
            self.next()
            ascending = True
        elif self.at_kw("DESC"):
            self.next()
        return col, query, ascending

    def order_limit(self) -> Tuple[Optional[Tuple[str, Any, bool]],
                                   Optional[int]]:
        order = None
        if self.at_kw("ORDER"):
            self.next()
            self.expect("BY")
            order = self.similarity_clause()
        limit = None
        if self.at_kw("LIMIT"):
            self.next()
            k = self.literal()
            if not isinstance(k, int) or k < 1:
                raise ValueError(f"LIMIT expects a positive integer, "
                                 f"got {k!r}")
            limit = k
        return order, limit

    def select_item(self) -> SelectItem:
        t = self.next()
        up = t.upper()
        if up in _AGGS:
            self.expect("(")
            if self.peek() == "*":
                self.next()
                self.expect(")")
                return SelectItem(None, agg=_AGGS[up], star=True)
            inner = self.next()
            if self.peek() == "(":          # task call inside aggregate
                self.next()
                col = self.next()
                self.expect(")")
                self.expect(")")
                return SelectItem(TaskCall(inner, col), agg=_AGGS[up])
            self.expect(")")
            return SelectItem(inner, agg=_AGGS[up])
        if self.peek() == "(":              # bare task call
            self.next()
            col = self.next()
            self.expect(")")
            return SelectItem(TaskCall(t, col))
        return SelectItem(t)

    # -- statements ------------------------------------------------------
    def create_task(self) -> CreateTaskStmt:
        self.expect("TASK")
        name = self.next()
        self.expect("(")
        self.expect("INPUT")
        self.expect("=")
        input_type = self.next().lower()
        self.expect(",")
        self.expect("OUTPUT")
        self.expect("IN")
        self.expect("(")
        labels = []
        while self.peek() != ")":
            labels.append(str(self.literal()))
            if self.peek() == ",":
                self.next()
        self.expect(")")
        self.expect(",")
        self.expect("TYPE")
        self.expect("=")
        kind = str(self.literal()).lower()
        self.expect(")")
        return CreateTaskStmt(TaskSpec(name, input_type, tuple(labels),
                                       kind))

    def select(self) -> QueryStmt:
        items = [self.select_item()]
        while self.peek() == ",":
            self.next()
            items.append(self.select_item())
        self.expect("FROM")
        table = self.next()
        preds = []
        if self.at_kw("WHERE"):
            self.next()
            preds = self.where_clause()
        group_by = None
        if self.at_kw("GROUP"):
            self.next()
            self.expect("BY")
            group_by = self.next()
        order, limit = self.order_limit()
        return self._build_select(items, table, preds, group_by,
                                  order, limit)

    def _build_select(self, items, table, preds, group_by,
                      order=None, limit=None) -> QueryStmt:
        plan = LogicalPlan.scan(table)
        tasks: List[str] = []
        score_of = {}               # (task, col) -> score column

        def score_col(tc: TaskCall) -> str:
            key = (tc.task, tc.col)
            if key not in score_of:
                name = "_score" if not score_of else f"_score{len(score_of) + 1}"
                score_of[key] = name
                plan.predict(tc.task, tc.col, out=name)
                tasks.append(tc.task)
            return score_of[key]

        specs: List[Tuple[str, str, str]] = []
        out_cols: List[str] = []
        plain_cols: List[str] = []
        has_agg = any(it.agg for it in items)
        for it in items:
            if it.agg:
                if it.star:
                    specs.append(("*", "count", "count"))
                    out_cols.append("count")
                    continue
                col = (score_col(it.expr)
                       if isinstance(it.expr, TaskCall) else it.expr)
                name = f"{it.agg}_{col}"
                specs.append((col, it.agg, name))
                out_cols.append(name)
            elif isinstance(it.expr, TaskCall):
                if has_agg:
                    raise ValueError("bare task calls cannot be mixed "
                                     "with aggregates")
                out_cols.append(score_col(it.expr))
            else:
                plain_cols.append(it.expr)
                out_cols.append(it.expr)
        # WHERE is evaluated after SELECT-item lowering here (inference
        # first); the optimizer's pushdown pass restores filter-first
        # order whenever predicates only touch base columns.
        if preds:
            plan.filter(preds)
        if has_agg:
            if order is not None:
                raise ValueError("ORDER BY SIMILARITY cannot be combined "
                                 "with aggregates")
            if plain_cols and group_by is None:
                raise ValueError("bare columns with aggregates require "
                                 "GROUP BY")
            for c in plain_cols:
                if c != group_by:
                    raise ValueError(f"column {c!r} not in GROUP BY")
            plan.agg(group_by, specs)
        elif group_by is not None:
            raise ValueError("GROUP BY without aggregates")
        elif order is not None:
            ocol, query, ascending = order
            proj = list(out_cols)
            drop = None
            if ocol not in proj:
                # ordering needs the column downstream of the projection;
                # carry it through and drop it from the final output
                proj.append(ocol)
                drop = ocol
            plan.project(proj)
            plan.order_by_similarity(ocol, query, ascending=ascending,
                                     drop_col=drop)
        else:
            plan.project(out_cols)      # SELECT list narrows the output
        if limit is not None:
            plan.limit(limit)
        return QueryStmt(plan, tasks=tasks, output_cols=out_cols)

    def predict_stmt(self) -> QueryStmt:
        col = self.next()
        self.expect("USING")
        self.expect("TASK")
        task = self.next()
        self.expect("FROM")
        table = self.next()
        preds = []
        if self.at_kw("WHERE"):
            self.next()
            preds = self.where_clause()
        order, limit = self.order_limit()
        plan = LogicalPlan.scan(table)
        plan.predict(task, col, out="_score")
        if preds:
            plan.filter(preds)
        if order is not None:
            # PREDICT keeps every column, so the ordering column is
            # already in the output: nothing to drop
            ocol, query, ascending = order
            plan.order_by_similarity(ocol, query, ascending=ascending)
        if limit is not None:
            plan.limit(limit)
        return QueryStmt(plan, tasks=[task], output_cols=["_score"])

    def statement(self) -> Statement:
        t = self.next().upper()
        if t == "CREATE":
            return self.create_task()
        if t == "SELECT":
            return self.select()
        if t == "PREDICT":
            return self.predict_stmt()
        raise ValueError(f"unsupported statement {t}")


def parse(sql: str) -> Statement:
    toks = tokenize(sql.strip().rstrip(";"))
    p = _Parser([t for t in toks if t != ";"])
    stmt = p.statement()
    if p.peek() is not None:
        raise ValueError(f"trailing tokens: {p.toks[p.i:]}")
    return stmt
