"""Columnar operators for the batch inference pipeline.

A *batch* is a dict of equal-length numpy columns. Relational operators
(scan/filter/join/groupby/window) run on host; ``predict`` nodes run the
resolved task model on the device the cost model chose; ``embed`` nodes
materialize shared pre-embeddings (paper §5.1).

Port of ``src/repro/pipeline/operators.py``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import numpy as np

Batch = Dict[str, np.ndarray]


def batch_len(b: Batch) -> int:
    return len(next(iter(b.values()))) if b else 0


def concat_batches(bs: Sequence[Batch]) -> Batch:
    keys = bs[0].keys()
    return {k: np.concatenate([b[k] for b in bs]) for k in keys}


def slice_batch(b: Batch, lo: int, hi: int) -> Batch:
    return {k: v[lo:hi] for k, v in b.items()}


def iter_chunks(b: Batch, size: int) -> Iterator[Batch]:
    n = batch_len(b)
    for lo in range(0, n, size):
        yield slice_batch(b, lo, min(lo + size, n))


# -- relational ops -----------------------------------------------------------

def scan(table: Batch) -> Batch:
    return table


def filter_op(b: Batch, pred: Callable[[Batch], np.ndarray]) -> Batch:
    mask = pred(b)
    return {k: v[mask] for k, v in b.items()}


def join(left: Batch, right: Batch, on: str,
         suffix: str = "_r") -> Batch:
    """Sort-merge inner join on an integer/str key column.

    Fully vectorized (argsort + searchsorted + repeat): no per-row
    interpreter iterations, so the host-relational path the pipeline
    overlaps with device inference scales to large build/probe sides.
    Output ordering matches the classic hash join: probe (left) rows in
    order, ties expanded in right-side row order (stable sort).
    """
    lk, rk = np.asarray(left[on]), np.asarray(right[on])
    order = np.argsort(rk, kind="stable")
    rs = rk[order]
    lo = np.searchsorted(rs, lk, side="left")
    hi = np.searchsorted(rs, lk, side="right")
    cnt = hi - lo
    li_a = np.repeat(np.arange(len(lk), dtype=np.int64), cnt)
    total = int(cnt.sum())
    if total:
        starts = np.repeat(lo, cnt)
        group_first = np.repeat(np.cumsum(cnt) - cnt, cnt)
        offs = np.arange(total, dtype=np.int64) - group_first
        ri_a = order[starts + offs]
    else:
        ri_a = np.zeros(0, np.int64)
    out = {k: v[li_a] for k, v in left.items()}
    for k, v in right.items():
        if k == on:
            continue
        out[k + suffix if k in out else k] = v[ri_a]
    return out


def groupby_agg(b: Batch, key: str, col: str,
                agg: str = "mean") -> Batch:
    keys, inv = np.unique(b[key], return_inverse=True)
    sums = np.zeros(len(keys), np.float64)
    cnts = np.zeros(len(keys), np.int64)
    np.add.at(sums, inv, b[col].astype(np.float64))
    np.add.at(cnts, inv, 1)
    if agg == "mean":
        vals = sums / np.maximum(cnts, 1)
    elif agg == "sum":
        vals = sums
    elif agg == "count":
        vals = cnts.astype(np.float64)
    else:
        raise ValueError(agg)
    return {key: keys, f"{agg}_{col}": vals}


def groupby_aggs(b: Batch, key: str,
                 specs: Sequence[tuple]) -> Batch:
    """Multi-aggregate group-by: ``specs`` is a sequence of
    ``(col, agg, out_name)`` with agg in mean|sum|count (count ignores
    ``col``; pass '*'). One pass over the group index serves all specs."""
    keys, inv = np.unique(b[key], return_inverse=True)
    cnts = np.zeros(len(keys), np.int64)
    np.add.at(cnts, inv, 1)
    out: Batch = {key: keys}
    for col, agg, name in specs:
        if agg == "count":
            out[name] = cnts.astype(np.float64)
            continue
        sums = np.zeros(len(keys), np.float64)
        np.add.at(sums, inv, b[col].astype(np.float64))
        if agg == "sum":
            out[name] = sums
        elif agg == "mean":
            out[name] = sums / np.maximum(cnts, 1)
        else:
            raise ValueError(agg)
    return out


def aggregate(b: Batch, specs: Sequence[tuple]) -> Batch:
    """Whole-table aggregates (no GROUP BY): one-row batch of
    ``(col, agg, out_name)`` results."""
    n = batch_len(b)
    out: Batch = {}
    for col, agg, name in specs:
        if agg == "count":
            out[name] = np.array([float(n)])
        elif agg == "sum":
            out[name] = np.array([float(b[col].sum()) if n else 0.0])
        elif agg == "mean":
            out[name] = np.array([float(b[col].mean()) if n else 0.0])
        else:
            raise ValueError(agg)
    return out


def window_op(b: Batch, col: str, size: int, fn: str = "mean") -> Batch:
    """Sliding window over a column (series tasks)."""
    x = b[col].astype(np.float64)
    if len(x) < size:
        return dict(b)
    c = np.convolve(x, np.ones(size) / size, mode="same")
    out = dict(b)
    out[f"{fn}{size}_{col}"] = c
    return out
