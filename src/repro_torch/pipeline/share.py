"""Pre-embedding with vector sharing (paper §5.1).

Embeddings are computed once per (table, column, content-fingerprint,
embedder-version) and stored as Mvec blocks; later queries referencing the
same data reuse them instead of re-embedding. In cost-model terms this
zeroes Eq. 5's ExecTime term for warm rows — the trunk forward that
dominates ``C_op = ExecTime + TransCost`` becomes a fingerprint lookup
and gather — which is why both the optimizer's embed split and the
serving lanes (Eq. 11 row budgets, ``docs/serving.md``) consult this
cache before any backend runs. The *embedder-version* key is the trunk
identity (``ResolvedModel.trunk_fp``), so fine-tune deltas of one base
share their base's cached embeddings. The paper pairs sharing with SIMD
vectorization — our GPU analogue is the fused normalize+project CUDA
kernel (repro_torch.kernels.fused_embed); on host we batch-vectorize with
numpy (SIMD via BLAS), including the one-pass murmur-style row
fingerprints ``get_many``/``put_many`` ride.

Port of ``src/repro/pipeline/share.py``.
"""
from __future__ import annotations

import hashlib
import threading
import time
import warnings
from collections import OrderedDict
from dataclasses import dataclass, field
from pathlib import Path
from typing import (Callable, Dict, List, Optional, Protocol, Sequence,
                    Tuple, runtime_checkable)

import numpy as np

from repro_torch.storage import mvec


def fingerprint(arr: np.ndarray) -> str:
    # Full-content hash: query results are served from this cache, so a
    # partial fingerprint would silently return stale embeddings after a
    # mid-buffer mutation. sha1 is ~1 GB/s — noise next to embedding.
    h = hashlib.sha1()
    h.update(str(arr.shape).encode())
    h.update(str(arr.dtype).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()[:16]


# Word-wise murmur3-style hash (rotate-multiply rounds + avalanche
# finalizer). Plain FNV is not enough here: float rows concentrate
# entropy in a word's *high* bits (sign/exponent), and multiply-only
# mixing never diffuses high bits downward, so one-hot rows collide.
# One 64-bit fingerprint per row matches the chunk-level convention
# (``fingerprint`` keeps 64 bits of sha1); collisions are birthday-
# bounded at ~n^2 / 2^65 over distinct rows.
_SEED = np.uint64(0xCBF29CE484222325)
_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_MIX1 = np.uint64(0xFF51AFD7ED558CCD)
_MIX2 = np.uint64(0xC4CEB9FE1A85EC53)


def _rotl(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def fingerprint_rows(arr: np.ndarray) -> np.ndarray:
    """Per-row content fingerprints of a whole chunk in one vectorized
    pass: ``(n,)`` uint64. The naive form — one ``hashlib`` call per
    row — dominates small-batch serving cost; here the hash state is an
    n-vector and the loop runs over the *words per row* (a handful), so
    the work is O(row_bytes) numpy ops instead of O(n) Python calls."""
    A = np.ascontiguousarray(arr)
    n = len(A)
    if n == 0:
        return np.zeros(0, np.uint64)
    row_bytes = A.view(np.uint8).reshape(n, -1)
    nb = row_bytes.shape[1]
    pad = (-nb) % 8
    if pad:                              # zero-pad rows to whole words
        padded = np.zeros((n, nb + pad), np.uint8)
        padded[:, :nb] = row_bytes
        row_bytes = padded
    # words-first layout: each loop step reads one contiguous n-vector
    words = np.ascontiguousarray(
        np.ascontiguousarray(row_bytes).view(np.uint64).T)
    # row width/dtype participate so e.g. float32 and float64 views of
    # the same bytes can never alias
    salt = np.uint64(hash((str(A.dtype), nb)) & 0xFFFFFFFFFFFFFFFF)
    with np.errstate(over="ignore"):
        h = np.full(n, _SEED ^ salt, np.uint64)
        for w in words:
            k = _rotl(w * _C1, 31) * _C2
            h = _rotl(h ^ k, 27) * np.uint64(5) + np.uint64(0x52DCE729)
        # final avalanche: residual structure must not survive into the
        # sorted-lookup key space
        h ^= h >> np.uint64(33)
        h *= _MIX1
        h ^= h >> np.uint64(29)
        h *= _MIX2
        h ^= h >> np.uint64(32)
    return h


class _RowBlock:
    """Row-granular store for one (table, column, version) key space:
    embeddings live in one contiguous matrix keyed by a parallel
    fingerprint vector, so a batched lookup is one ``searchsorted`` over
    the sorted fingerprints plus one fancy-index gather — no per-row
    Python. The sort order is rebuilt lazily after inserts (inserts are
    the cold path; lookups are the serving hot path)."""

    __slots__ = ("E", "fps", "used", "_sorted", "_order")

    def __init__(self, width: int, dtype, cap: int = 256):
        self.E = np.empty((cap, width), dtype)
        self.fps = np.empty(cap, np.uint64)
        self.used = 0
        self._sorted: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None

    @property
    def nbytes(self) -> int:
        return self.used * (self.E.shape[1] * self.E.itemsize + 8)

    def lookup(self, q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(row indices into E, found mask) for fingerprints ``q``."""
        if self.used == 0:
            return np.zeros(len(q), np.int64), np.zeros(len(q), bool)
        if self._sorted is None:
            self._order = np.argsort(self.fps[:self.used])
            self._sorted = self.fps[:self.used][self._order]
        pos = np.searchsorted(self._sorted, q)
        pos[pos == self.used] = 0            # clamp; mask rejects below
        found = self._sorted[pos] == q
        return self._order[pos], found

    def put(self, fps: np.ndarray, rows: np.ndarray) -> int:
        """Insert rows whose fingerprints aren't present; returns bytes
        added. Duplicates (in-call or vs stored) insert once."""
        _, present = self.lookup(fps)
        uniq, first = np.unique(fps[~present], return_index=True)
        sel = np.flatnonzero(~present)[first]
        if len(sel) == 0:
            return 0
        need = self.used + len(sel)
        if need > len(self.E):
            cap = max(need, 2 * len(self.E))
            grown = np.empty((cap, self.E.shape[1]), self.E.dtype)
            grown[:self.used] = self.E[:self.used]
            self.E = grown
            gfps = np.empty(cap, np.uint64)
            gfps[:self.used] = self.fps[:self.used]
            self.fps = gfps
        before = self.nbytes
        self.E[self.used:need] = rows[sel]
        self.fps[self.used:need] = fps[sel]
        self.used = need
        self._sorted = self._order = None    # re-sort lazily
        return self.nbytes - before

    def drop_oldest(self, keep_frac: float = 0.5) -> int:
        """Evict the oldest (insertion-order) rows, keeping the newest
        ``keep_frac``; the buffers are reallocated so freed memory is
        actually returned. Returns bytes freed."""
        keep = max(int(self.used * keep_frac), 1)
        start = self.used - keep
        if start <= 0:
            return 0
        before = self.nbytes
        self.E = self.E[start:self.used].copy()
        self.fps = self.fps[start:self.used].copy()
        self.used = keep
        self._sorted = self._order = None
        return before - self.nbytes


@dataclass
class ShareStats:
    hits: int = 0
    misses: int = 0
    embed_seconds: float = 0.0
    bytes_stored: int = 0


def _no_idx() -> np.ndarray:
    return np.zeros(0, np.int64)


def _no_dist() -> np.ndarray:
    return np.zeros(0, np.float32)


@dataclass
class TierLookup:
    """Result of one batch-granular cache-tier lookup.

    ``keys`` are the uint64 row fingerprints (reusable by
    :meth:`CacheTier.insert_many`); ``found`` is an ``(n, width)`` array
    whose *hit* rows are filled — rows flagged by ``miss`` hold
    unspecified data and must be overwritten by the caller (``None``
    when nothing hit). ``approx_idx`` lists the hit rows that were
    served *approximately* (nearest cached neighbor, not byte-equal),
    with their input-space distances in ``approx_dist``; ``audit_idx``
    is the subset the tier asks the caller to recompute exactly and
    report back via ``record_audit`` so false accepts are counted and
    the reuse radius stays honest.
    """

    keys: np.ndarray
    found: Optional[np.ndarray]
    miss: np.ndarray
    approx_idx: np.ndarray = field(default_factory=_no_idx)
    approx_dist: np.ndarray = field(default_factory=_no_dist)
    audit_idx: np.ndarray = field(default_factory=_no_idx)

    @property
    def hits(self) -> int:
        return int(len(self.miss) - self.miss.sum())


@runtime_checkable
class CacheTier(Protocol):
    """The one share-cache surface every tier speaks (and
    :class:`CacheChain` composes): batch-granular lookup and insert
    plus a ``stats`` counter object. ``VectorShareCache`` implements it
    with exact fingerprint equality; ``AnnShareTier`` with calibrated
    nearest-neighbor reuse. ``keys`` may carry precomputed fingerprints
    so chained tiers don't re-hash the same rows."""

    stats: object

    def lookup_many(self, table: str, column: str, rows: np.ndarray,
                    version: str = "v1", *,
                    keys: Optional[np.ndarray] = None) -> TierLookup: ...

    def insert_many(self, table: str, column: str, keys: np.ndarray,
                    rows: np.ndarray, embs: np.ndarray,
                    version: str = "v1") -> None: ...


class VectorShareCache:
    """In-DB embedding cache: memory tier + optional Mvec disk tier."""

    def __init__(self, root: Optional[Path] = None,
                 capacity_bytes: int = 1 << 30):
        self.root = Path(root) if root else None
        if self.root:
            self.root.mkdir(parents=True, exist_ok=True)
        self.capacity = capacity_bytes
        self._mem: "OrderedDict[str, np.ndarray]" = OrderedDict()
        self._used = 0
        # row tier: (table, column, version) -> _RowBlock, LRU over
        # whole blocks (rows inside a block age out together — the
        # serving path shares one block per trunk lane)
        self._rows: "OrderedDict[str, _RowBlock]" = OrderedDict()
        self._rows_used = 0
        self._lock = threading.Lock()
        self.stats = ShareStats()

    def _key(self, table: str, column: str, fp: str, version: str) -> str:
        return f"{table}.{column}.{version}.{fp}"

    def get_or_embed(self, table: str, column: str, data: np.ndarray,
                     embed_fn: Callable[[np.ndarray], np.ndarray],
                     version: str = "v1") -> np.ndarray:
        key = self._key(table, column, fingerprint(data), version)
        with self._lock:
            if key in self._mem:
                self.stats.hits += 1
                self._mem.move_to_end(key)
                return self._mem[key]
        if self.root and (self.root / f"{key}.mvec").exists():
            vec = mvec.decode((self.root / f"{key}.mvec").read_bytes())
            with self._lock:
                self.stats.hits += 1
                self._put(key, np.asarray(vec))
            return np.asarray(vec)
        t0 = time.time()
        vec = np.asarray(embed_fn(data))
        dt = time.time() - t0
        with self._lock:
            self.stats.misses += 1
            self.stats.embed_seconds += dt
            self._put(key, vec)
        if self.root:
            (self.root / f"{key}.mvec").write_bytes(mvec.encode(vec))
            self.stats.bytes_stored += vec.nbytes
        return vec

    def _put(self, key: str, vec: np.ndarray) -> None:
        if key in self._mem:
            self._used -= self._mem[key].nbytes
        self._mem[key] = vec
        self._mem.move_to_end(key)
        self._used += vec.nbytes
        # capacity bounds the *whole* cache: chunk tier + row tier
        while (self._used + self._rows_used > self.capacity
               and len(self._mem) > 1):
            _, old = self._mem.popitem(last=False)
            self._used -= old.nbytes

    # -- batched row-granular tier (serving hot path) ----------------------
    def get_many(self, table: str, column: str, rows: np.ndarray,
                 version: str = "v1"
                 ) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
        """Batched row-granular lookup: fingerprint the whole chunk in
        one vectorized pass and gather every cached row in one
        ``searchsorted`` + fancy index — no per-row Python anywhere.

        Returns ``(keys, found, miss)``: ``keys`` (uint64 fingerprints)
        identify rows for :meth:`put_many`; ``found`` is an ``(n, width)``
        array whose *hit* rows are filled — rows flagged by ``miss`` hold
        unspecified data and must be overwritten by the caller (one plain
        gather is ~20x cheaper than a masked scatter on the all-hit warm
        path). ``found`` is ``None`` when this key space has no cached
        rows yet; ``miss[i]`` is True when row i must be computed.
        Hit/miss stats are counted per *row* — the serving analogue of
        the chunk-level counts ``get_or_embed`` keeps.
        """
        keys = fingerprint_rows(np.asarray(rows))
        n = len(keys)
        with self._lock:
            block = self._rows.get(self._blockkey(table, column, version))
            if block is None or block.used == 0:
                self.stats.misses += n
                return keys, None, np.ones(n, bool)
            self._rows.move_to_end(self._blockkey(table, column, version))
            idx, hit = block.lookup(keys)
            miss = ~hit
            found = block.E[idx]         # miss rows: clamped idx, garbage
            self.stats.hits += int(hit.sum())
            self.stats.misses += int(miss.sum())
        return keys, found, miss

    def put_many(self, table: str, column: str, keys: np.ndarray,
                 rows: np.ndarray, version: str = "v1") -> None:
        """Write computed rows back under keys from :meth:`get_many`."""
        rows = np.asarray(rows)
        keys = np.asarray(keys, np.uint64)
        if len(keys) == 0:
            return
        if len(keys) != len(rows):
            raise ValueError(f"{len(keys)} keys for {len(rows)} rows")
        bk = self._blockkey(table, column, version)
        with self._lock:
            block = self._rows.get(bk)
            if block is None:
                block = _RowBlock(rows.shape[1], rows.dtype,
                                  cap=max(256, len(rows)))
                self._rows[bk] = block
            self._rows.move_to_end(bk)
            self._rows_used += block.put(keys, rows)
            while (self._rows_used + self._used > self.capacity
                   and len(self._rows) > 1):
                _, old = self._rows.popitem(last=False)
                self._rows_used -= old.nbytes
            # a lone block must not grow unbounded (it would also starve
            # the chunk tier forever): shed its oldest rows until the
            # combined usage fits
            while self._rows_used + self._used > self.capacity:
                freed = block.drop_oldest()
                if freed == 0:
                    break
                self._rows_used -= freed

    # -- CacheTier protocol -------------------------------------------------
    def lookup_many(self, table: str, column: str, rows: np.ndarray,
                    version: str = "v1", *,
                    keys: Optional[np.ndarray] = None) -> TierLookup:
        """:class:`CacheTier` lookup: exact fingerprint equality. With
        precomputed ``keys`` the rows are not re-hashed (the chain path
        fingerprints once for all tiers)."""
        if keys is None:
            k, found, miss = self.get_many(table, column, rows, version)
            return TierLookup(k, found, miss)
        keys = np.asarray(keys, np.uint64)
        n = len(keys)
        bk = self._blockkey(table, column, version)
        with self._lock:
            block = self._rows.get(bk)
            if block is None or block.used == 0:
                self.stats.misses += n
                return TierLookup(keys, None, np.ones(n, bool))
            self._rows.move_to_end(bk)
            idx, hit = block.lookup(keys)
            miss = ~hit
            found = block.E[idx]
            self.stats.hits += int(hit.sum())
            self.stats.misses += int(miss.sum())
        return TierLookup(keys, found, miss)

    def insert_many(self, table: str, column: str, keys: np.ndarray,
                    rows: np.ndarray, embs: np.ndarray,
                    version: str = "v1") -> None:
        """:class:`CacheTier` insert. The exact tier keys purely by
        fingerprint, so the raw ``rows`` are unused here (the ANN tier
        needs them to index input space)."""
        del rows
        self.put_many(table, column, keys, embs, version)

    def get_row(self, table: str, column: str, row: np.ndarray,
                version: str = "v1") -> Optional[np.ndarray]:
        """Single-row lookup. Deprecated: use :meth:`lookup_many` (or
        the batched :meth:`get_many`) — per-row calls forfeit the
        vectorized fingerprint/gather path."""
        warnings.warn("VectorShareCache.get_row is deprecated; use "
                      "lookup_many/get_many", DeprecationWarning,
                      stacklevel=2)
        _, found, miss = self.get_many(table, column,
                                       np.asarray(row)[None], version)
        return None if (found is None or miss[0]) else found[0]

    def put_row(self, table: str, column: str, row: np.ndarray,
                emb: np.ndarray, version: str = "v1") -> None:
        """Single-row insert. Deprecated: use :meth:`insert_many` (or
        the batched :meth:`put_many`)."""
        warnings.warn("VectorShareCache.put_row is deprecated; use "
                      "insert_many/put_many", DeprecationWarning,
                      stacklevel=2)
        row = np.asarray(row)[None]
        self.put_many(table, column, fingerprint_rows(row),
                      np.asarray(emb)[None], version)

    @staticmethod
    def _blockkey(table: str, column: str, version: str) -> str:
        return f"{table}.{column}.{version}"

    @property
    def hit_rate(self) -> float:
        t = self.stats.hits + self.stats.misses
        return self.stats.hits / t if t else 0.0


# ---------------------------------------------------------------------------
# Approximate tier: IVF-flat ANN index + calibrated-radius embedding reuse
# ---------------------------------------------------------------------------


class IvfFlatIndex:
    """Pure-numpy IVF-flat ANN index (FAISS-style, no dependency).

    Below ``train_min`` stored vectors the index brute-forces (exact
    nearest neighbor); past it, a few Lloyd rounds of k-means train
    ``nlist`` coarse centroids and vectors bucket into inverted lists
    kept in CSR layout (one ``argsort`` — ids sorted by list, plus a
    starts vector). A query probes the ``nprobe`` nearest lists only.
    Appends assign against the existing centroids; the index retrains
    when it has grown ``retrain_growth``x since the last training, so
    amortized maintenance stays O(n log n). ``search1`` is fully
    vectorized across the query batch — the serving hot path must not
    pay per-row Python any more than the exact tier does."""

    def __init__(self, nlist: int = 16, nprobe: int = 4,
                 train_min: int = 64, retrain_growth: float = 2.0,
                 seed: int = 0):
        self.nlist = max(int(nlist), 1)
        self.nprobe = max(int(nprobe), 1)
        self.train_min = max(int(train_min), 2)
        self.retrain_growth = float(retrain_growth)
        self._rng = np.random.default_rng(seed)
        self.V: Optional[np.ndarray] = None      # (cap, d) float32
        self.used = 0
        self._centroids: Optional[np.ndarray] = None
        self._assign: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None   # CSR ids by list
        self._starts: Optional[np.ndarray] = None
        self._Vord: Optional[np.ndarray] = None    # V[order] slab
        self._vn_ord: Optional[np.ndarray] = None  # its row norms^2
        self._listed = 0                           # rows covered by CSR
        self._trained_at = 0                       # size at last k-means

    def __len__(self) -> int:
        return self.used

    @property
    def nbytes(self) -> int:
        return 0 if self.V is None else self.used * self.V.shape[1] * 4

    def add(self, vecs: np.ndarray) -> None:
        vecs = np.ascontiguousarray(np.asarray(vecs, np.float32))
        if vecs.ndim != 2 or len(vecs) == 0:
            return
        if self.V is None:
            cap = max(256, len(vecs))
            self.V = np.empty((cap, vecs.shape[1]), np.float32)
        need = self.used + len(vecs)
        if need > len(self.V):
            cap = max(need, 2 * len(self.V))
            grown = np.empty((cap, self.V.shape[1]), np.float32)
            grown[:self.used] = self.V[:self.used]
            self.V = grown
        self.V[self.used:need] = vecs
        self.used = need

    @staticmethod
    def _sq_dists(X: np.ndarray, C: np.ndarray) -> np.ndarray:
        # ||x-c||^2 via the dot trick: one GEMM instead of an
        # (n, m, d) broadcast temp
        d = (np.einsum("ij,ij->i", X, X)[:, None]
             - 2.0 * (X @ C.T)
             + np.einsum("ij,ij->i", C, C)[None, :])
        return np.maximum(d, 0.0)

    def _train(self) -> None:
        V = self.V[:self.used]
        nc = min(self.nlist, max(1, self.used // 8))
        pick = self._rng.choice(self.used, nc, replace=False)
        C = V[pick].copy()
        for _ in range(4):
            a = self._sq_dists(V, C).argmin(1)
            for j in range(nc):
                m = a == j
                if m.any():
                    C[j] = V[m].mean(0)
        self._centroids = C
        self._assign = self._sq_dists(V, C).argmin(1)
        self._rebuild_csr()
        self._trained_at = self.used

    def _rebuild_csr(self) -> None:
        self._order = np.argsort(self._assign, kind="stable")
        counts = np.bincount(self._assign,
                             minlength=len(self._centroids))
        self._starts = np.concatenate(
            [[0], np.cumsum(counts)]).astype(np.int64)
        # contiguous per-list slab: search scores each probed list with
        # one GEMM against it instead of gathering ragged candidates
        self._Vord = np.ascontiguousarray(self.V[self._order])
        self._vn_ord = np.einsum("ij,ij->i", self._Vord, self._Vord)
        self._listed = self.used

    def _ensure_built(self) -> None:
        if self.used < self.train_min:
            self._centroids = None
            return
        if (self._centroids is None
                or self.used >= self.retrain_growth
                * max(self._trained_at, 1)):
            self._train()
        elif self._listed < self.used:
            new = self.V[self._listed:self.used]
            a = self._sq_dists(new, self._centroids).argmin(1)
            self._assign = np.concatenate(
                [self._assign[:self._listed], a])
            self._rebuild_csr()

    def _brute1(self, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        d = self._sq_dists(Q, self.V[:self.used])
        idx = d.argmin(1).astype(np.int64)
        diff = Q - self.V[:self.used][idx]     # exact winner distance
        return np.sqrt(np.einsum("ij,ij->i", diff, diff)), idx

    def search1(self, Q: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Nearest stored vector per query row: ``(dist, idx)`` with
        L2 distances; ``idx`` is -1 (dist inf) where nothing was found.
        Queries are bucketed by probed list and each list is scored
        with one GEMM against its contiguous slab (dot trick), merged
        into the running per-query minimum — no ragged megagather of
        candidate rows and no global sort over the candidate set."""
        Q = np.ascontiguousarray(np.asarray(Q, np.float32))
        nq = len(Q)
        if nq == 0 or self.used == 0:
            return (np.full(nq, np.inf, np.float32),
                    np.full(nq, -1, np.int64))
        self._ensure_built()
        if self._centroids is None:
            return self._brute1(Q)
        C = self._centroids
        npr = min(self.nprobe, len(C))
        dc = self._sq_dists(Q, C)
        probe = np.argpartition(dc, npr - 1, axis=1)[:, :npr]
        starts, order = self._starts, self._order
        qn = np.einsum("ij,ij->i", Q, Q)
        best = np.full(nq, np.inf, np.float32)
        idx = np.full(nq, -1, np.int64)
        # group (query, list) pairs by list: one stable sort of nq*npr
        # small ints, then a contiguous query batch per probed list
        qlist = np.repeat(np.arange(nq, dtype=np.int64), npr)
        lsort = np.argsort(probe.reshape(-1), kind="stable")
        lflat = probe.reshape(-1)[lsort]
        bounds = np.searchsorted(lflat, np.arange(len(C) + 1))
        scored_any = False
        for li in range(len(C)):
            lo, hi = int(bounds[li]), int(bounds[li + 1])
            s, e = int(starts[li]), int(starts[li + 1])
            if lo == hi or s == e:
                continue
            scored_any = True
            qs = qlist[lsort[lo:hi]]        # unique: one probe per list
            dl = (qn[qs, None]
                  - 2.0 * (Q[qs] @ self._Vord[s:e].T)
                  + self._vn_ord[None, s:e])
            j = dl.argmin(1)
            dmin = dl[np.arange(len(qs)), j]
            upd = dmin < best[qs]
            best[qs[upd]] = dmin[upd]
            idx[qs[upd]] = order[s + j[upd]]
        if not scored_any:
            return self._brute1(Q)
        # the dot trick cancels catastrophically for near-duplicates
        # (the exact regime the reuse radius gates on): recompute the
        # winner's distance from the actual difference vector
        fin = idx >= 0
        if fin.any():
            diff = Q[fin] - self.V[:self.used][idx[fin]]
            best[fin] = np.sqrt(np.einsum("ij,ij->i", diff, diff))
        return best, idx


@dataclass
class AnnConfig:
    """Approximate-tier knobs. The contract is *error-bounded reuse*:
    a row may be served a cached neighbor's embedding only when the
    input-space distance is within ``max_dist``. When ``max_dist`` is
    None the radius is calibrated online as
    ``error_bound / (safety * lip_hat)`` where ``lip_hat`` is the
    largest observed ``||Δembedding|| / ||Δrow||`` ratio over inserted
    (row, embedding) pairs — an empirical local Lipschitz estimate that
    sharpens exactly when near-duplicate traffic exists. ``audit_rate``
    of approx hits are recomputed exactly by the caller; audits whose
    error exceeds ``error_bound`` count as false accepts and tighten
    the radius."""

    error_bound: float = 0.05
    max_dist: Optional[float] = None
    safety: float = 1.5
    audit_rate: float = 0.05
    nlist: int = 16
    nprobe: int = 4
    min_train: int = 64
    retrain_growth: float = 2.0
    calib_sample: int = 64
    seed: int = 0


@dataclass
class AnnStats:
    approx_hits: int = 0
    misses: int = 0
    inserts: int = 0
    audits: int = 0
    false_accepts: int = 0
    bytes_stored: int = 0

    @property
    def hits(self) -> int:
        return self.approx_hits


class _AnnBlock:
    """Backing store for one (table, column, version) key space of the
    ANN tier: raw input rows ``R`` (distance space), their embeddings
    ``E`` (what gets served), parallel fingerprints for dedup, the IVF
    index over ``R``, and the running Lipschitz estimate."""

    __slots__ = ("R", "E", "fps", "used", "index", "lip")

    def __init__(self, in_width: int, out_width: int, cfg: AnnConfig):
        self.R = np.empty((256, in_width), np.float32)
        self.E = np.empty((256, out_width), np.float32)
        self.fps = np.empty(256, np.uint64)
        self.used = 0
        self.index = IvfFlatIndex(cfg.nlist, cfg.nprobe, cfg.min_train,
                                  cfg.retrain_growth, cfg.seed)
        self.lip = 0.0

    @property
    def nbytes(self) -> int:
        per = self.R.shape[1] * 4 + self.E.shape[1] * 4 + 8
        return self.used * per + self.index.nbytes

    def put(self, fps: np.ndarray, rows: np.ndarray,
            embs: np.ndarray) -> int:
        """Insert rows whose fingerprints aren't stored yet (dedup
        in-call and vs stored); returns bytes added. New rows feed the
        IVF index incrementally."""
        fresh = ~np.isin(fps, self.fps[:self.used])
        uniq, first = np.unique(fps[fresh], return_index=True)
        sel = np.flatnonzero(fresh)[first]
        if len(sel) == 0:
            return 0
        need = self.used + len(sel)
        if need > len(self.R):
            cap = max(need, 2 * len(self.R))
            for name in ("R", "E"):
                old = getattr(self, name)
                grown = np.empty((cap, old.shape[1]), np.float32)
                grown[:self.used] = old[:self.used]
                setattr(self, name, grown)
            gfps = np.empty(cap, np.uint64)
            gfps[:self.used] = self.fps[:self.used]
            self.fps = gfps
        before = self.nbytes
        self.R[self.used:need] = rows[sel]
        self.E[self.used:need] = embs[sel]
        self.fps[self.used:need] = fps[sel]
        self.used = need
        self.index.add(rows[sel])
        return self.nbytes - before


class AnnShareTier:
    """Approximate :class:`CacheTier`: rows within a calibrated
    input-space distance of a cached row reuse that row's embedding.

    Opt-in (``EngineConfig.cache_tiers`` must name it) and
    error-bounded: until enough (row, embedding) pairs have calibrated
    a Lipschitz estimate — or the caller pins ``max_dist`` — the radius
    is 0 and every lookup misses, so the tier can never serve wild
    guesses cold. Composes behind the exact tier in a
    :class:`CacheChain`; byte-capped with whole-block LRU like the
    exact tier."""

    def __init__(self, config: Optional[AnnConfig] = None,
                 capacity_bytes: int = 1 << 30):
        self.cfg = config or AnnConfig()
        self.capacity = capacity_bytes
        self._blocks: "OrderedDict[str, _AnnBlock]" = OrderedDict()
        self._used = 0
        self._lock = threading.Lock()
        self._audit_rng = np.random.default_rng(self.cfg.seed + 1)
        self._calib_rng = np.random.default_rng(self.cfg.seed + 2)
        self.stats = AnnStats()

    @staticmethod
    def _blockkey(table: str, column: str, version: str) -> str:
        return f"{table}.{column}.{version}"

    def _radius_of(self, block: Optional[_AnnBlock]) -> float:
        if self.cfg.max_dist is not None:
            return float(self.cfg.max_dist)
        if block is None or block.lip <= 0.0:
            return 0.0
        return self.cfg.error_bound / (self.cfg.safety * block.lip)

    def radius(self, table: str, column: str,
               version: str = "v1") -> float:
        """Current reuse radius for a key space (0 = not calibrated)."""
        with self._lock:
            return self._radius_of(
                self._blocks.get(self._blockkey(table, column, version)))

    def lookup_many(self, table: str, column: str, rows: np.ndarray,
                    version: str = "v1", *,
                    keys: Optional[np.ndarray] = None) -> TierLookup:
        rows = np.asarray(rows)
        X = rows.reshape(len(rows), -1).astype(np.float32, copy=False)
        if keys is None:
            keys = fingerprint_rows(rows)
        n = len(X)
        miss_all = TierLookup(keys, None, np.ones(n, bool))
        with self._lock:
            bk = self._blockkey(table, column, version)
            block = self._blocks.get(bk)
            radius = self._radius_of(block)
            if (n == 0 or block is None or block.used == 0
                    or radius <= 0.0
                    or X.shape[1] != block.R.shape[1]):
                self.stats.misses += n
                return miss_all
            self._blocks.move_to_end(bk)
            dist, idx = block.index.search1(X)
            hit = (idx >= 0) & (dist <= radius)
            hidx = np.flatnonzero(hit)
            if len(hidx) == 0:
                self.stats.misses += n
                return miss_all
            found = np.zeros((n, block.E.shape[1]), np.float32)
            found[hidx] = block.E[idx[hidx]]
            audit_idx = _no_idx()
            if self.cfg.audit_rate > 0.0:
                draw = self._audit_rng.random(len(hidx))
                audit_idx = hidx[draw < self.cfg.audit_rate]
            self.stats.approx_hits += len(hidx)
            self.stats.misses += n - len(hidx)
        return TierLookup(keys, found, ~hit, hidx,
                          dist[hidx].astype(np.float32), audit_idx)

    def insert_many(self, table: str, column: str, keys: np.ndarray,
                    rows: np.ndarray, embs: np.ndarray,
                    version: str = "v1") -> None:
        rows = np.asarray(rows)
        X = rows.reshape(len(rows), -1).astype(np.float32, copy=False)
        E = np.asarray(embs, np.float32).reshape(len(rows), -1)
        keys = np.asarray(keys, np.uint64)
        if len(X) == 0:
            return
        bk = self._blockkey(table, column, version)
        with self._lock:
            block = self._blocks.get(bk)
            if block is None:
                block = _AnnBlock(X.shape[1], E.shape[1], self.cfg)
                self._blocks[bk] = block
            elif (X.shape[1] != block.R.shape[1]
                  or E.shape[1] != block.E.shape[1]):
                return                       # width changed: ignore
            self._blocks.move_to_end(bk)
            # calibrate BEFORE inserting: each sampled new row's nearest
            # *existing* neighbor gives an observed ||dE||/||dR|| ratio
            if block.used and self.cfg.max_dist is None:
                s = min(len(X), self.cfg.calib_sample)
                sel = (np.arange(len(X)) if s == len(X) else
                       self._calib_rng.choice(len(X), s, replace=False))
                d, i = block.index.search1(X[sel])
                ok = (i >= 0) & (d > 1e-9) & np.isfinite(d)
                if ok.any():
                    de = np.linalg.norm(E[sel][ok] - block.E[i[ok]],
                                        axis=1)
                    block.lip = max(block.lip,
                                    float((de / d[ok]).max()))
            added = block.put(keys, X, E)
            self._used += added
            self.stats.inserts += len(X)
            self.stats.bytes_stored += max(added, 0)
            while self._used > self.capacity and len(self._blocks) > 1:
                _, old = self._blocks.popitem(last=False)
                self._used -= old.nbytes

    def record_audit(self, table: str, column: str, version: str,
                     dists: np.ndarray, errors: np.ndarray) -> None:
        """Caller reports exact recomputations of audited approx hits:
        errors above ``error_bound`` count as false accepts and raise
        the Lipschitz estimate, shrinking the calibrated radius."""
        dists = np.asarray(dists, np.float64)
        errors = np.asarray(errors, np.float64)
        with self._lock:
            self.stats.audits += len(errors)
            bad = errors > self.cfg.error_bound
            self.stats.false_accepts += int(bad.sum())
            block = self._blocks.get(
                self._blockkey(table, column, version))
            if block is not None and bad.any():
                ok = bad & (dists > 1e-9)
                if ok.any():
                    block.lip = max(block.lip,
                                    float((errors[ok] / dists[ok]).max()))


class CacheChain:
    """Compose :class:`CacheTier`s into one cache: lookups consult
    tiers in order (exact first), each tier serving only the residual
    misses of the previous one; inserts broadcast to every tier. Also
    carries the chunk-style ``get_or_embed`` entry point the analytics
    embed nodes use, which runs the full audit protocol: audited
    approx hits are recomputed exactly, compared, reported back via
    ``record_audit``, and served exact."""

    def __init__(self, tiers: Sequence[CacheTier]):
        if not tiers:
            raise ValueError("CacheChain needs at least one tier")
        self.tiers: List[CacheTier] = list(tiers)
        self.computed_rows = 0     # rows embed_fn actually computed

    def lookup_many(self, table: str, column: str, rows: np.ndarray,
                    version: str = "v1", *,
                    keys: Optional[np.ndarray] = None) -> TierLookup:
        rows = np.asarray(rows)
        out = self.tiers[0].lookup_many(table, column, rows, version,
                                        keys=keys)
        for tier in self.tiers[1:]:
            if not out.miss.any():
                break
            ridx = np.flatnonzero(out.miss)
            sub = tier.lookup_many(table, column, rows[ridx], version,
                                   keys=out.keys[ridx])
            hit_sub = np.flatnonzero(~sub.miss)
            if len(hit_sub) == 0:
                continue
            if out.found is None:
                out.found = np.zeros((len(rows), sub.found.shape[1]),
                                     sub.found.dtype)
            gidx = ridx[hit_sub]
            out.found[gidx] = sub.found[hit_sub]
            out.miss[gidx] = False
            out.approx_idx = np.concatenate(
                [out.approx_idx, ridx[sub.approx_idx]])
            out.approx_dist = np.concatenate(
                [out.approx_dist, sub.approx_dist])
            out.audit_idx = np.concatenate(
                [out.audit_idx, ridx[sub.audit_idx]])
        return out

    def insert_many(self, table: str, column: str, keys: np.ndarray,
                    rows: np.ndarray, embs: np.ndarray,
                    version: str = "v1") -> None:
        for tier in self.tiers:
            tier.insert_many(table, column, keys, rows, embs, version)

    def record_audit(self, table: str, column: str, version: str,
                     dists: np.ndarray, errors: np.ndarray) -> None:
        for tier in self.tiers:
            fn = getattr(tier, "record_audit", None)
            if fn is not None:
                fn(table, column, version, dists, errors)

    @property
    def ann(self) -> Optional[AnnShareTier]:
        for tier in self.tiers:
            if isinstance(tier, AnnShareTier):
                return tier
        return None

    def get_or_embed(self, table: str, column: str, data: np.ndarray,
                     embed_fn: Callable[[np.ndarray], np.ndarray],
                     version: str = "v1") -> np.ndarray:
        """Row-granular replacement for the chunk-level
        ``VectorShareCache.get_or_embed``: hit rows gather from the
        chain, miss rows embed once per distinct fingerprint
        (single-flight within the call), and audited approx hits are
        recomputed, compared against the bound, and refreshed exact."""
        rows = np.asarray(data)
        n = len(rows)
        if n == 0:
            return np.asarray(embed_fn(rows))
        tl = self.lookup_many(table, column, rows, version)
        need = tl.miss.copy()
        if len(tl.audit_idx):
            need[tl.audit_idx] = True
        if not need.any():
            return tl.found
        cidx = np.flatnonzero(need)
        uniq, first = np.unique(tl.keys[cidx], return_index=True)
        comp_idx = cidx[first]
        computed = np.asarray(embed_fn(rows[comp_idx]))
        self.computed_rows += len(comp_idx)
        E = tl.found
        if E is None:
            E = np.zeros((n, computed.shape[1]), computed.dtype)
        if len(tl.audit_idx):
            exact = computed[np.searchsorted(uniq, tl.keys[tl.audit_idx])]
            errs = np.linalg.norm(
                E[tl.audit_idx].astype(np.float64) - exact, axis=1)
            order = np.argsort(tl.approx_idx, kind="stable")
            loc = order[np.searchsorted(tl.approx_idx[order],
                                        tl.audit_idx)]
            self.record_audit(table, column, version,
                              tl.approx_dist[loc], errs)
        E[cidx] = computed[np.searchsorted(uniq, tl.keys[cidx])]
        self.insert_many(table, column, tl.keys[comp_idx],
                         rows[comp_idx], computed, version)
        return E


def simd_normalize_embed(X: np.ndarray, W: np.ndarray,
                         mean: float = 0.0, scale: float = 1.0) -> np.ndarray:
    """Host reference of the fused normalize+project embedder (the CUDA
    kernel's oracle): y = tanh(((x - mean) * scale) @ W)."""
    Z = (X.astype(np.float32) - mean) * scale
    return np.tanh(Z @ W.astype(np.float32))
