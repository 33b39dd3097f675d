"""Model stores (paper §3.1): BLOB all-in-one, decoupled layer tables with
fine-tune deltas and partial loading, and API-based external endpoints.

This module is the storage half of the cost model's TransCost term
(Eq. 7): ``ModelSize/MemBW + ModelSize/AccelBW`` is paid on the bytes a
resolution actually reads, so everything here is about shrinking
``ModelSize`` without changing the served model — partial loads read a
subset of layers (or a row range inside one, §3.2 Mvec slicing), and
fine-tune *deltas* store a variant as references to unchanged base
layers plus small per-layer delta tensors composed back at read time
(``base + delta``; the NeurStore-style delta compression argument).
``trunk_fingerprint`` turns the resolved layer identity into the lane
key the serving path (Eq. 11 row budgets, ``docs/serving.md``) uses to
coalesce fine-tunes of one base into a single embed lane. The remote
``ApiModelRegistry`` models Eq. 5's end-to-end latency term.
See ``docs/architecture.md`` for where each store sits in the dataflow.

The decoupled store is also the substrate for distributed checkpointing
(:mod:`repro_torch.storage.checkpoint`): each layer is an independent Mvec
file, so a restore can read any subset (elastic resharding, partial
update, variant reuse) — the paper's partial-load property at pod scale.

Port of ``src/repro/storage/stores.py``. Leaves may be numpy arrays or
torch tensors on any device, bfloat16 included: every leaf goes to the
host through :func:`repro_torch.storage.mvec.payload_array` (a CUDA tensor
by ``.detach().cpu()``, bf16 as its uint16 bit pattern), so the files
equal the reference's byte for byte. As in the reference, whose bf16
(``ml_dtypes``) arrays are not of a numeric numpy kind, a changed bf16
layer of a fine-tune is stored whole, not as a delta.
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import pickle
import shutil
import struct
import threading
import time
import zlib
from collections import OrderedDict
from dataclasses import dataclass, replace as dc_replace
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.storage import mvec
from repro_torch.storage.catalog import Catalog, LayerInfo, ModelInfo


# Layer keys are the on-disk contract, so the walk below yields exactly
# what the reference's ``jax.tree_util.tree_flatten_with_path`` yields:
# dict keys sorted (OrderedDict in insertion order), namedtuple fields in
# order, list/tuple indices, ``None`` subtrees dropped, everything else a
# leaf; a path joins with "/" ("a/b/0"). torch tensors are leaves.

def _children(node):
    """``[(key, child)]`` of a container node, or None for a leaf."""
    if isinstance(node, OrderedDict):
        return list(node.items())
    if isinstance(node, dict):
        return sorted(node.items(), key=lambda kv: kv[0])
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return [(f, getattr(node, f)) for f in node._fields]
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    return None


def _walk(node, prefix: Tuple[str, ...]):
    if node is None:
        return
    kids = _children(node)
    if kids is None:
        yield "/".join(prefix), node
        return
    for k, child in kids:
        yield from _walk(child, prefix + (str(k),))


def flatten_params(params) -> Dict[str, Any]:
    return dict(_walk(params, ()))


def unflatten_like(template, flat: Dict[str, Any]):
    def build(node, prefix: Tuple[str, ...]):
        if node is None:
            return None
        kids = _children(node)
        if kids is None:
            key = "/".join(prefix)
            if key not in flat:
                raise KeyError(f"missing layer {key}")
            return flat[key]
        built = [(k, build(c, prefix + (str(k),))) for k, c in kids]
        if isinstance(node, dict):
            return type(node)(built) if isinstance(node, OrderedDict) \
                else dict(built)
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(v for _, v in built))
        return type(node)(v for _, v in built)
    return build(template, ())


# ---------------------------------------------------------------------------
# BLOB store
# ---------------------------------------------------------------------------

def _numel(leaf) -> int:
    """Element count of a numpy array, a torch tensor or a scalar."""
    numel = getattr(leaf, "numel", None)
    return int(numel() if callable(numel) else np.asarray(leaf).size)


class BlobStore:
    """All-in-one serialized model object (architecture + params)."""

    def __init__(self, root: Path, catalog: Optional[Catalog] = None):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.catalog = catalog

    def save(self, model_id: str, arch_meta: dict, params,
             task_types: Optional[List[str]] = None,
             modality: str = "text") -> Path:
        flat = flatten_params(params)
        payload = {
            "arch": arch_meta,
            "layers": {k: mvec.encode(v) for k, v in flat.items()},
        }
        path = self.root / f"{model_id}.blob"
        with open(path, "wb") as f:
            pickle.dump(payload, f, protocol=4)
        if self.catalog:
            self.catalog.register_model(ModelInfo(
                model_id=model_id, storage="blob", path=str(path),
                task_types=task_types or [], modality=modality,
                param_count=int(sum(_numel(v) for v in flat.values()))))
        return path

    def load(self, model_id: str, template=None):
        path = self.root / f"{model_id}.blob"
        with open(path, "rb") as f:
            payload = pickle.load(f)
        flat = {k: mvec.decode(b) for k, b in payload["layers"].items()}
        if template is not None:
            return payload["arch"], unflatten_like(template, flat)
        return payload["arch"], flat


# ---------------------------------------------------------------------------
# Decoupled store
# ---------------------------------------------------------------------------

@dataclass
class StoreStats:
    """I/O accounting for partial loading: how many bytes actually came
    off disk vs were served from the in-memory layer cache. Partial-load
    wins are exactly ``loaded_bytes`` staying below the stored size."""
    loads: int = 0               # load() / load_layer_rows() calls
    partial_loads: int = 0       # calls that read a subset (filter/slice)
    loaded_bytes: int = 0        # bytes read from disk
    cache_hits: int = 0
    cache_hit_bytes: int = 0     # bytes served from the layer cache
    cache_evictions: int = 0     # tensors LRU-evicted over the byte cap
    cache_evicted_bytes: int = 0
    cache_bytes: int = 0         # tensor bytes currently held (gauge)
    delta_composes: int = 0      # base+delta compositions performed
    delta_bytes: int = 0         # delta bytes (subset of loaded_bytes)
    dedup_pages: int = 0         # page writes elided (content already stored)
    dedup_bytes_saved: int = 0   # bytes those elided page writes would cost
    compressed_delta_bytes: int = 0  # on-disk bytes of compressed delta files
    quant_error_bound: float = 0.0   # max declared quant bound seen (gauge)


class PageStore:
    """Content-hashed, refcounted tensor pages (NeurStore-style dedup).

    Layer payloads are chunked into fixed-size pages keyed by the sha256
    of their content; identical trunk pages across zoo models and
    fine-tune chains are stored once. Refcounts persist in a JSON
    sidecar updated atomically; ``decref`` only drops the count (the
    page file stays on disk until :meth:`vacuum` collects orphans), so a
    crash between a decref and a vacuum can never lose referenced data —
    the failure mode is garbage, which the next vacuum removes.
    """

    REFS_FILE = "_refcounts.json"

    def __init__(self, root: Path, page_bytes: int = 64 << 10):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.page_bytes = int(page_bytes)
        self._lock = threading.Lock()
        self._refs: Dict[str, int] = {}
        refs_path = self.root / self.REFS_FILE
        if refs_path.exists():
            self._refs = {k: int(v) for k, v in
                          json.loads(refs_path.read_text()).items()}

    def _page_path(self, hex_digest: str) -> Path:
        return self.root / f"{hex_digest}.page"

    def _flush_locked(self) -> None:
        tmp = self.root / (self.REFS_FILE + ".tmp")
        tmp.write_text(json.dumps(self._refs, indent=0))
        tmp.replace(self.root / self.REFS_FILE)

    def chunk_digests(self, data: bytes) -> List[bytes]:
        return [hashlib.sha256(data[i:i + self.page_bytes]).digest()
                for i in range(0, len(data), self.page_bytes)] if data \
            else []

    def put(self, data: bytes) -> Tuple[List[bytes], int, int]:
        """Store a payload's pages and take one reference on each.
        Returns ``(digests, dup_pages, dup_bytes)`` — the dedup counters
        tell how many page writes were elided because the content was
        already stored (by this model or any other)."""
        digests: List[bytes] = []
        dup_pages = dup_bytes = 0
        with self._lock:
            for off in range(0, len(data), self.page_bytes):
                chunk = data[off:off + self.page_bytes]
                dg = hashlib.sha256(chunk).digest()
                digests.append(dg)
                hexd = dg.hex()
                path = self._page_path(hexd)
                if hexd in self._refs and path.exists():
                    dup_pages += 1
                    dup_bytes += len(chunk)
                else:
                    tmp = path.with_suffix(".tmp")
                    tmp.write_bytes(chunk)
                    tmp.replace(path)
                self._refs[hexd] = self._refs.get(hexd, 0) + 1
            self._flush_locked()
        return digests, dup_pages, dup_bytes

    def incref(self, digests) -> None:
        with self._lock:
            for dg in digests:
                self._refs[dg.hex()] = self._refs.get(dg.hex(), 0) + 1
            self._flush_locked()

    def decref(self, digests) -> None:
        with self._lock:
            for dg in digests:
                hexd = dg.hex()
                left = self._refs.get(hexd, 0) - 1
                if left > 0:
                    self._refs[hexd] = left
                else:
                    self._refs.pop(hexd, None)
            self._flush_locked()

    def refcount(self, digest: bytes) -> int:
        with self._lock:
            return self._refs.get(digest.hex(), 0)

    def read_page(self, digest: bytes) -> bytes:
        return self._page_path(digest.hex()).read_bytes()

    def page_size_on_disk(self, digest: bytes) -> int:
        path = self._page_path(digest.hex())
        return path.stat().st_size if path.exists() else 0

    def total_bytes(self) -> int:
        return sum(p.stat().st_size for p in self.root.glob("*.page"))

    def vacuum(self) -> Tuple[int, int]:
        """GC orphaned pages: remove every ``*.page`` file whose digest
        holds no reference. Returns ``(pages_removed, bytes_freed)``.
        Referenced pages are never touched."""
        removed = freed = 0
        with self._lock:
            for path in list(self.root.glob("*.page")):
                if path.stem not in self._refs:
                    freed += path.stat().st_size
                    path.unlink()
                    removed += 1
            for path in self.root.glob("*.tmp"):   # crash leftovers
                path.unlink()
        return removed, freed


class DecoupledStore:
    """Architecture/parameters separation with per-layer Mvec files.

    Supports: partial loading (subset of layers), fine-tune *deltas*,
    and range reads within a layer (Mvec slicing) for per-shard restore.

    ``save(base_model=...)`` stores a fine-tuned variant at its marginal
    cost: layers identical to the base become references (zero new
    bytes), and changed same-geometry layers become per-layer *delta*
    tensors (``variant - base``, tagged ``mvec.FLAG_DELTA`` on disk).
    Reads compose ``base + delta`` transparently — integer deltas
    round-trip exactly (wraparound), float deltas within 1 ulp — and
    row-range reads slice base and delta consistently, so width-sliced
    partial loads work for deltas too.

    Every read is accounted in :class:`StoreStats`, and layer tensors are
    cached in memory keyed by their *resolved* file path — referenced
    layers resolve into the base model's files, so two models sharing a
    trunk share one cached tensor (the NeurStore-style cross-model
    reuse), and a fine-tune resolved after its base pays only delta
    bytes of disk I/O (the warm-base accounting Eq. 7 staging relies
    on). Composed delta layers are cached under the delta file's path.

    Two opt-in compression layers shrink the stored zoo without changing
    what any read returns:

    - ``compress_deltas=True``: fine-tune residuals are stored sparse
      (CSR index+value, exact) when few entries changed, or int8/int16
      quantized (``quant_dtype``) when dense — whichever is smallest;
      raw wins ties so integer deltas and adversarial floats stay
      bit-exact. Every compressed file declares its max abs
      reconstruction error (0 for sparse/integer payloads,
      ``scale/2`` for quantized ones), surfaced as the
      ``quant_error_bound`` stats gauge.
    - ``dedup_pages=True``: plain (non-delta) layer payloads are chunked
      into content-hashed pages in a refcounted :class:`PageStore`
      (``_pages/`` beside the model dirs), so identical trunk pages
      across models store once. ``save``/``delete`` manage refcounts;
      :meth:`vacuum` collects orphaned pages.

    Both compose transparently through every read path — width slices,
    base+delta composition, chained fine-tunes, the layer LRU, pinning.
    """

    def __init__(self, root: Path, catalog: Optional[Catalog] = None,
                 cache_layers: bool = True,
                 cache_capacity_bytes: int = 256 << 20,
                 compress_deltas: bool = False,
                 quant_dtype: str = "int8",
                 sparse_eps: float = 0.0,
                 dedup_pages: bool = False,
                 page_bytes: int = 64 << 10):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.catalog = catalog or Catalog(self.root / "_catalog")
        self.cache_layers = cache_layers
        if quant_dtype not in ("int8", "int16"):
            raise ValueError(f"quant_dtype must be int8|int16, "
                             f"got {quant_dtype!r}")
        self.compress_deltas = bool(compress_deltas)
        self.quant_dtype = quant_dtype
        self.sparse_eps = float(sparse_eps)
        self.dedup_pages = bool(dedup_pages)
        self.page_bytes = int(page_bytes)
        self._page_store: Optional[PageStore] = None
        # byte-capped LRU: a long-lived session resolving many models
        # (a delta fleet's composed trunks, analytics over a wide zoo)
        # must not grow the cross-model tensor cache without bound.
        # Insertion order == recency order (moved-to-end on hit).
        self.cache_capacity_bytes = int(cache_capacity_bytes)
        self._layer_cache: "OrderedDict[Tuple[str, Optional[Tuple[int, int]]], np.ndarray]" = OrderedDict()
        self._cache_lock = threading.Lock()
        # trunk pinning (serving integration): refcounted file paths the
        # LRU must evict around — an active embed lane's trunk would be
        # re-read immediately, so evicting it only adds disk churn
        self._pin_count: Dict[str, int] = {}      # model_id -> pins
        self._pin_paths: Dict[str, List[str]] = {}  # model_id -> files
        self._pinned_paths: Dict[str, int] = {}   # file path -> refcount
        self.stats = StoreStats()

    def _dir(self, model_id: str) -> Path:
        return self.root / model_id

    @property
    def pages(self) -> PageStore:
        """The shared page store (created on first use; an existing
        ``_pages/`` dir is picked up even when ``dedup_pages`` is off,
        so a reader store can resolve paged layers a writer produced)."""
        if self._page_store is None:
            self._page_store = PageStore(self.root / "_pages",
                                         self.page_bytes)
        return self._page_store

    def _encode_delta(self, delta: np.ndarray) -> Tuple[bytes, str, float]:
        """Pick the smallest encoding for a fine-tune residual:
        raw dense, sparse (exact for eps=0 / integers), or quantized
        (floats only, finite only). Raw wins ties, so compression never
        costs bytes and never loses exactness without winning space.
        Returns ``(mvec_bytes, encoding, declared_bound)``."""
        n, item = delta.size, delta.itemsize
        dense_cost = n * item
        kind = delta.dtype.kind
        eps = self.sparse_eps if kind == "f" else 0.0
        if eps and kind == "f":
            nnz = int(np.count_nonzero(np.abs(delta) > eps))
        else:
            nnz = int(np.count_nonzero(delta))
        best = ("dense", dense_cost)
        sparse_cost = 16 + nnz * (8 + item)
        if sparse_cost < best[1]:
            best = ("sparse", sparse_cost)
        can_quant = (kind == "f" and n > 0
                     and bool(np.isfinite(delta).all()))
        if can_quant:
            code_item = 1 if self.quant_dtype == "int8" else 2
            quant_cost = 28 + n * code_item
            if quant_cost < best[1]:
                best = ("quant", quant_cost)
        if best[0] == "sparse":
            buf = mvec.encode_sparse(delta, flags=mvec.FLAG_DELTA, eps=eps)
            return buf, "sparse", float(eps)
        if best[0] == "quant":
            buf = mvec.encode_quant(delta, self.quant_dtype,
                                    flags=mvec.FLAG_DELTA)
            return buf, "quant", mvec.decode_aux(buf).bound
        return mvec.encode(delta, flags=mvec.FLAG_DELTA), "dense", 0.0

    def _decref_model_pages(self, model_id: str) -> None:
        """Drop page references held by a model's current layer files
        (before a re-save overwrites them, or a delete removes them)."""
        for li in self.catalog.get_layers(model_id):
            if li.file.startswith("@"):
                continue
            path = self._dir(model_id) / li.file
            if not path.exists():
                continue
            try:
                with open(path, "rb") as f:
                    head, aux = mvec.read_aux(f)
            except (ValueError, struct.error):
                continue
            if head.is_paged:
                self.pages.decref(aux.digests)

    def save(self, model_id: str, arch_meta: dict, params,
             base_model: Optional[str] = None,
             task_types: Optional[List[str]] = None,
             modality: str = "text") -> Path:
        """Save params as layer tables. With ``base_model``, only layers
        that differ from the base are written (delta storage)."""
        d = self._dir(model_id)
        d.mkdir(parents=True, exist_ok=True)
        # rewritten layer files invalidate caches — including composed
        # tensors of fine-tunes whose deltas reference this model
        # (transitively: a re-saved base stales every variant chain)
        stale, frontier = {model_id}, [model_id]
        while frontier:
            cur = frontier.pop()
            for info in self.catalog.list_models():
                if info.base_model == cur and info.model_id not in stale:
                    stale.add(info.model_id)
                    frontier.append(info.model_id)
        # separator suffix: 'm1' must not evict 'm10'
        prefixes = tuple(str(self._dir(m)) + os.sep for m in stale)
        with self._cache_lock:
            for k in [k for k in self._layer_cache
                      if k[0].startswith(prefixes)]:
                self.stats.cache_bytes -= self._layer_cache.pop(k).nbytes
        # re-save under the same id: release page references held by the
        # files about to be overwritten, and clear the old layer files so
        # a save with fewer layers leaves no unreachable garbage behind
        old_layers = self.catalog.get_layers(model_id)
        if old_layers:
            self._decref_model_pages(model_id)
            for li in old_layers:
                if not li.file.startswith("@"):
                    (d / li.file).unlink(missing_ok=True)
        (d / "architecture.json").write_text(json.dumps(arch_meta, indent=1))
        flat = flatten_params(params)
        base_flat: Dict[str, Any] = {}
        if base_model:
            base_flat = {li.layer_name: li
                         for li in self.catalog.get_layers(base_model)}
        layers: List[LayerInfo] = []
        for i, (key, leaf) in enumerate(sorted(flat.items())):
            # host payload (bf16 as uint16 bits) and the logical dtype name
            arr, dname = mvec.payload_array(leaf)
            if base_model and key in base_flat:
                base_arr, base_name = mvec.payload_array(
                    self._read_layer_file(base_model, base_flat[key]))
                if (base_arr.shape == arr.shape and base_name == dname
                        and base_arr.tobytes() == arr.tobytes()):
                    # unchanged: reference the base *layer* (resolved
                    # through the catalog at read time, so chains —
                    # references to references, or to layers the base
                    # itself stores as deltas — stay correct), and
                    # write nothing
                    layers.append(LayerInfo(
                        model_id=model_id, layer_name=key, layer_index=i,
                        dtype=dname, shape=list(arr.shape),
                        nbytes=arr.nbytes,
                        file=f"@{base_model}:{key}",
                        delta_of=base_model))
                    continue
                if (base_arr.shape == arr.shape and base_name == dname
                        and dname != "bfloat16"
                        and arr.dtype.kind in "fiu"):
                    # changed, same geometry: store only the per-layer
                    # delta; reads compose base + delta (integers exact
                    # via wraparound, floats within 1 ulp — or within
                    # the declared bound when compression quantizes)
                    with np.errstate(over="ignore"):
                        delta = arr - base_arr
                    if self.compress_deltas:
                        buf, enc, bound = self._encode_delta(delta)
                    else:
                        buf = mvec.encode(delta, flags=mvec.FLAG_DELTA)
                        enc, bound = "dense", 0.0
                    fname = f"layer_{i:05d}.delta.mvec"
                    (d / fname).write_bytes(buf)
                    if enc != "dense":
                        self.stats.compressed_delta_bytes += len(buf)
                        self.stats.quant_error_bound = max(
                            self.stats.quant_error_bound, bound)
                    layers.append(LayerInfo(
                        model_id=model_id, layer_name=key, layer_index=i,
                        dtype=dname, shape=list(arr.shape),
                        nbytes=arr.nbytes, file=fname,
                        delta_of=base_model, enc=enc, bound=bound))
                    continue
            fname = f"layer_{i:05d}.mvec"
            enc = "dense"
            if self.dedup_pages:
                digests, dup_pages, dup_bytes = self.pages.put(arr.tobytes())
                (d / fname).write_bytes(mvec.encode_paged(
                    dname, arr.shape, self.pages.page_bytes, digests))
                self.stats.dedup_pages += dup_pages
                self.stats.dedup_bytes_saved += dup_bytes
                enc = "paged"
            else:
                (d / fname).write_bytes(mvec.encode(leaf))
            layers.append(LayerInfo(
                model_id=model_id, layer_name=key, layer_index=i,
                dtype=dname, shape=list(arr.shape),
                nbytes=arr.nbytes, file=fname, delta_of=None, enc=enc))
        self.catalog.register_layers(model_id, layers)
        # save generation: rewriting a model's files under the same id
        # must change every identity derived from them (trunk
        # fingerprints key share-cache entries and staged device
        # weights, which would otherwise serve the old tensors)
        try:
            gen = int(self.catalog.get_model(model_id)
                      .extra.get("save_gen", 0)) + 1
        except KeyError:
            gen = 1
        self.catalog.register_model(ModelInfo(
            model_id=model_id, storage="decoupled", path=str(d),
            base_model=base_model, task_types=task_types or [],
            modality=modality,
            param_count=int(sum(_numel(v) for v in flat.values())),
            extra={"save_gen": gen}))
        return d

    def _ref_target(self, li: LayerInfo
                    ) -> Optional[Tuple[str, LayerInfo]]:
        """Resolve an unchanged-layer reference one hop: ``@model:layer``
        points at the base model's *layer* (looked up in the catalog, so
        chained fine-tunes — references to references, or to layers the
        base itself stores as deltas — compose correctly); the legacy
        ``@model/file`` form references a concrete plain file (pre-delta
        stores never wrote anything else)."""
        if not li.file.startswith("@"):
            return None
        ref = li.file[1:]
        if ":" in ref:
            ref_model, ref_layer = ref.split(":", 1)
            target = next((b for b in self.catalog.get_layers(ref_model)
                           if b.layer_name == ref_layer), None)
            if target is None:
                raise KeyError(
                    f"layer {li.layer_name!r} of {li.model_id!r} "
                    f"references missing layer {ref_layer!r} in "
                    f"{ref_model!r}")
            return ref_model, target
        ref_model, ref_file = ref.split("/", 1)
        return ref_model, dc_replace(li, model_id=ref_model,
                                     file=ref_file, delta_of=None)

    def _resolve_layer(self, model_id: str,
                       li: LayerInfo) -> Tuple[str, LayerInfo]:
        """Follow the reference chain to the (owner model, layer) that
        actually defines a layer's content."""
        ref = self._ref_target(li)
        while ref is not None:
            model_id, li = ref
            ref = self._ref_target(li)
        return model_id, li

    def _resolve_layer_path(self, model_id: str, li: LayerInfo) -> Path:
        """Concrete file that defines a layer's content: references
        follow the chain to the defining model; a composed delta layer
        resolves to its delta file (the composed tensor really is a
        different tensor — that is what makes ``trunk_fingerprint``
        separate trunk-delta variants while inherited trunks share)."""
        owner, li = self._resolve_layer(model_id, li)
        return self._dir(owner) / li.file

    def _save_gen(self, model_id: str) -> int:
        try:
            return int(self.catalog.get_model(model_id)
                       .extra.get("save_gen", 0))
        except KeyError:
            return 0

    def _layer_ident(self, model_id: str, li: LayerInfo) -> str:
        """Content identity of a layer: the defining file's path plus
        the save generation of *every* model contributing to the
        tensor. A composed delta depends on its base chain too — a
        re-saved base must change the variant's identity even though
        the delta file itself is untouched."""
        ref = self._ref_target(li)
        if ref is not None:
            return self._layer_ident(*ref)
        ident = f"{self._dir(model_id) / li.file}@g{self._save_gen(model_id)}"
        if self._is_composed_delta(li):
            base_li = next(
                (b for b in self.catalog.get_layers(li.delta_of)
                 if b.layer_name == li.layer_name), None)
            if base_li is not None:
                ident += "+" + self._layer_ident(li.delta_of, base_li)
        return ident

    @staticmethod
    def _is_composed_delta(li: LayerInfo) -> bool:
        # delta_of + "@" file = unchanged reference (read base's layer);
        # delta_of + own file = stored delta tensor (compose base + delta)
        return li.delta_of is not None and not li.file.startswith("@")

    # -- trunk pinning + delta-aware eviction ------------------------------
    def _layer_paths(self, model_id: str, li: LayerInfo) -> List[str]:
        """Every concrete file a layer read touches: references follow
        the chain to the defining file; a composed delta needs its delta
        file *and* the base layer's files (composition re-reads both)."""
        ref = self._ref_target(li)
        if ref is not None:
            return self._layer_paths(*ref)
        out = [str(self._dir(model_id) / li.file)]
        if self._is_composed_delta(li):
            base_li = next(
                (b for b in self.catalog.get_layers(li.delta_of)
                 if b.layer_name == li.layer_name), None)
            if base_li is not None:
                out += self._layer_paths(li.delta_of, base_li)
        return out

    def pin_model(self, model_id: str, prefix: str = "trunk/") -> None:
        """Pin a model's trunk layers (resolved through references and
        delta composition, so a fine-tune pins the base files it
        actually reads) against layer-cache eviction. Refcounted: every
        ``pin_model`` needs a matching :meth:`unpin_model`. Raises
        KeyError for a model the catalog doesn't know."""
        self.catalog.get_model(model_id)          # KeyError if unknown
        with self._cache_lock:
            if model_id in self._pin_count:
                self._pin_count[model_id] += 1
                return
            paths = sorted({
                p for li in self.catalog.get_layers(model_id)
                if li.layer_name.startswith(prefix)
                for p in self._layer_paths(model_id, li)})
            self._pin_count[model_id] = 1
            self._pin_paths[model_id] = paths
            for p in paths:
                self._pinned_paths[p] = self._pinned_paths.get(p, 0) + 1

    def unpin_model(self, model_id: str) -> None:
        """Release one :meth:`pin_model` reference (no-op when the model
        isn't pinned — a stop path may race a never-started lane)."""
        with self._cache_lock:
            if model_id not in self._pin_count:
                return
            self._pin_count[model_id] -= 1
            if self._pin_count[model_id] > 0:
                return
            del self._pin_count[model_id]
            for p in self._pin_paths.pop(model_id, []):
                left = self._pinned_paths.get(p, 0) - 1
                if left > 0:
                    self._pinned_paths[p] = left
                else:
                    self._pinned_paths.pop(p, None)

    def _is_pinned(self, path_str: str) -> bool:
        return self._pinned_paths.get(path_str, 0) > 0

    def _chain_members(self, model_id: str) -> set:
        """The model plus every fine-tune whose base chain passes
        through it — the entries whose cached tensors depend on this
        model's files (the same traversal ``save`` uses to invalidate
        stale composed tensors)."""
        out, frontier = {model_id}, [model_id]
        while frontier:
            cur = frontier.pop()
            for info in self.catalog.list_models():
                if info.base_model == cur and info.model_id not in out:
                    out.add(info.model_id)
                    frontier.append(info.model_id)
        return out

    def _evict_chain_locked(self, victim_key) -> None:
        """Evict a victim together with every unpinned cached tensor of
        its delta chain (the victim's model + dependents composing
        against it): once part of a chain's files must be re-read, keeping
        the dependents' fragments only splits the chain's residency."""
        owners = self._chain_members(Path(victim_key[0]).parent.name)
        dirs = tuple(str(self._dir(m)) + os.sep for m in owners)
        for k in [k for k in self._layer_cache
                  if k == victim_key
                  or (k[0].startswith(dirs) and not self._is_pinned(k[0]))]:
            arr = self._layer_cache.pop(k)
            self.stats.cache_bytes -= arr.nbytes
            self.stats.cache_evictions += 1
            self.stats.cache_evicted_bytes += arr.nbytes

    def _cache_get(self, key):
        if not self.cache_layers:
            return None
        with self._cache_lock:
            cached = self._layer_cache.get(key)
            if cached is not None:
                self._layer_cache.move_to_end(key)   # freshen LRU order
        if cached is not None:
            self.stats.cache_hits += 1
            self.stats.cache_hit_bytes += cached.nbytes
        return cached

    def _cache_put(self, key, arr) -> None:
        if not self.cache_layers:
            return
        nbytes = int(arr.nbytes)
        cap = self.cache_capacity_bytes
        if nbytes > cap:
            return          # a tensor bigger than the cache never enters
        with self._cache_lock:
            old = self._layer_cache.pop(key, None)
            if old is not None:
                self.stats.cache_bytes -= old.nbytes
            self._layer_cache[key] = arr
            self.stats.cache_bytes += nbytes
            while self.stats.cache_bytes > cap and self._layer_cache:
                # LRU victim selection skips pinned trunks (files an
                # active serving lane holds); the victim's whole delta
                # chain leaves with it
                victim_key = next(
                    (k for k in self._layer_cache
                     if not self._is_pinned(k[0])), None)
                if victim_key is None:
                    break       # everything resident is pinned: stay over
                self._evict_chain_locked(victim_key)

    def _read_layer_file(self, model_id: str, li: LayerInfo,
                         rows: Optional[Tuple[int, int]] = None):
        ref = self._ref_target(li)
        if ref is not None:              # unchanged layer: read the
            return self._read_layer_file(*ref, rows=rows)  # base's
        if self._is_composed_delta(li):
            return self._read_delta_layer(model_id, li, rows)
        path = self._dir(model_id) / li.file
        key = (str(path), rows)
        cached = self._cache_get(key)
        if cached is not None:
            return cached
        with open(path, "rb") as f:
            head = mvec.read_header(f)
            if head.is_delta:
                raise ValueError(
                    f"{path} holds a FLAG_DELTA payload but is "
                    "catalogued as plain weights")
            if head.is_paged:
                arr, nread = self._read_paged(path, rows)
                self.stats.loaded_bytes += nread
            elif rows is not None:
                arr, nread, _aux = mvec.read_slice_counted(
                    f, rows[0], rows[1])
                self.stats.loaded_bytes += nread
            else:
                buf = f.read()
                arr = mvec.decode(buf)
                self.stats.loaded_bytes += len(buf)
        self._cache_put(key, arr)
        return arr

    def _read_paged(self, path: Path,
                    rows: Optional[Tuple[int, int]] = None
                    ) -> Tuple[np.ndarray, int]:
        """Materialize a paged layer (or a row range of it) from the
        page store, reading only the table plus the pages that overlap
        the requested byte range — paging preserves the partial-load
        property at page granularity."""
        buf = path.read_bytes()
        h = mvec.decode_header(buf)
        aux = mvec.decode_aux(buf)
        nread = len(buf)
        row_bytes = h.itemsize
        for dim in h.shape[1:]:
            row_bytes *= dim
        if rows is None:
            lo, hi = 0, h.nbytes
            out_shape = h.shape
        else:
            start = min(max(0, rows[0]), h.shape[0])
            stop = min(max(rows[1], start), h.shape[0])
            lo, hi = start * row_bytes, stop * row_bytes
            out_shape = (stop - start,) + h.shape[1:]
        pb = aux.page_bytes
        p0 = lo // pb if pb else 0
        p1 = -(-hi // pb) if pb else 0
        data = b"".join(self.pages.read_page(dg)
                        for dg in aux.digests[p0:p1])
        nread += len(data)
        raw = data[lo - p0 * pb:hi - p0 * pb]
        arr = np.frombuffer(raw, dtype=np.dtype(
            {"bfloat16": np.uint16}.get(h.dtype, h.dtype))
        ).reshape(out_shape)
        return mvec._finish(arr, h.dtype), nread

    def _read_delta_layer(self, model_id: str, li: LayerInfo,
                          rows: Optional[Tuple[int, int]] = None):
        """Compose ``base + delta`` for a fine-tune layer stored as a
        delta tensor. The base layer goes through :meth:`_read_layer_file`
        (so a warm base costs cache bytes, not disk bytes — only the
        delta's bytes count as loaded), and row-range reads slice base
        and delta identically, keeping width-sliced partial loads valid
        for deltas. The composed tensor is cached under the delta file's
        path; ``save`` invalidates it when base or variant is rewritten."""
        path = self._dir(model_id) / li.file
        key = (str(path), rows)
        cached = self._cache_get(key)
        if cached is not None:
            return cached
        base_li = next(
            (b for b in self.catalog.get_layers(li.delta_of)
             if b.layer_name == li.layer_name), None)
        if base_li is None:
            raise KeyError(
                f"delta layer {li.layer_name!r} of {model_id!r} references "
                f"missing base layer in {li.delta_of!r}")
        base_arr, _ = mvec.payload_array(
            self._read_layer_file(li.delta_of, base_li, rows=rows))
        with open(path, "rb") as f:
            head = mvec.read_header(f)
            if not head.is_delta:
                raise ValueError(
                    f"{path} is catalogued as a delta of {li.delta_of!r} "
                    "but its Mvec header lacks FLAG_DELTA")
            if rows is not None:
                delta, nread, aux = mvec.read_slice_counted(
                    f, rows[0], rows[1])
            else:
                buf = f.read()
                delta = mvec.decode(buf)
                nread = len(buf)
                aux = mvec.decode_aux(buf)
        self.stats.loaded_bytes += nread
        self.stats.delta_bytes += nread
        self.stats.delta_composes += 1
        if aux.bound:
            self.stats.quant_error_bound = max(
                self.stats.quant_error_bound, aux.bound)
        with np.errstate(over="ignore"):
            arr = base_arr + delta
        self._cache_put(key, arr)
        return arr

    def load(self, model_id: str, template=None,
             layer_filter: Optional[Callable[[str], bool]] = None):
        """Full or partial load. ``layer_filter(name)`` selects layers."""
        arch = json.loads((self._dir(model_id) / "architecture.json")
                          .read_text())
        self.stats.loads += 1
        if layer_filter is not None:
            self.stats.partial_loads += 1
        flat = {}
        for li in self.catalog.get_layers(model_id):
            if layer_filter and not layer_filter(li.layer_name):
                continue
            flat[li.layer_name] = self._read_layer_file(model_id, li)
        if template is not None and layer_filter is None:
            return arch, unflatten_like(template, flat)
        return arch, flat

    def load_layer_rows(self, model_id: str, layer_name: str,
                        start: int, stop: int):
        """Range read within one layer (per-shard restore / width-sliced
        trunk path): only the requested rows' bytes leave the disk."""
        for li in self.catalog.get_layers(model_id):
            if li.layer_name == layer_name:
                self.stats.loads += 1
                self.stats.partial_loads += 1
                return self._read_layer_file(model_id, li, rows=(start, stop))
        raise KeyError(layer_name)

    def trunk_fingerprint(self, model_id: str,
                          prefix: str = "trunk/") -> str:
        """Identity of a model's trunk: the *resolved* file paths of its
        trunk layers — the same key the layer-tensor cache uses, so two
        models whose fine-tune deltas reference one base trunk (or two
        tasks resolving to the same stored model) fingerprint equal and
        can share a serving embed lane. Paths are bound to their layer
        names (the same file set wired to different layers is a
        different trunk) and to the save generation of every
        contributing model (``_layer_ident``), so re-saving a model —
        or the base a delta composes against — changes the fingerprint
        instead of silently serving stale share-cache embeddings and
        staged weights."""
        pairs = sorted(
            (li.layer_name, self._layer_ident(model_id, li))
            for li in self.catalog.get_layers(model_id)
            if li.layer_name.startswith(prefix))
        if not pairs:
            return model_id
        digest = hashlib.sha1(
            "|".join(f"{n}={p}" for n, p in pairs).encode()
        ).hexdigest()[:16]
        return f"trunk:{digest}"

    def _file_stored_bytes(self, path: Path) -> int:
        """Disk bytes a layer file accounts for: its own size, plus its
        referenced pages for a paged table (a page shared with another
        model is attributed to both — per-model sums overstate shared
        storage; :meth:`disk_footprint` is the deduplicated truth)."""
        size = path.stat().st_size
        try:
            with open(path, "rb") as f:
                head, aux = mvec.read_aux(f)
        except (ValueError, struct.error):
            return size
        if head.is_paged:
            size += sum(self.pages.page_size_on_disk(dg)
                        for dg in aux.digests)
        return size

    def stored_bytes(self, model_id: str) -> int:
        """Actual new bytes on disk (referenced base layers count 0)."""
        total = 0
        for li in self.catalog.get_layers(model_id):
            if not li.file.startswith("@"):
                total += self._file_stored_bytes(
                    self._dir(model_id) / li.file)
        return total

    def delta_bytes(self, model_id: str) -> int:
        """Disk bytes of the model's fine-tune *delta* layers (0 for a
        base model): the marginal storage cost of the variant over its
        base — the 'K·delta' term in the fleet accounting
        ``base + K·delta`` that ``docs/benchmarks.md`` gates."""
        total = 0
        for li in self.catalog.get_layers(model_id):
            if self._is_composed_delta(li):
                total += (self._dir(model_id) / li.file).stat().st_size
        return total

    def cold_resolve_bytes(self, model_id: str) -> int:
        """Disk bytes a cold full load of the model reads: every unique
        concrete file its layers resolve through (delta chains include
        the base files the composition re-reads), with paged tables
        counting table + referenced pages. This is the compressed
        ``ModelSize`` the Eq. 7 host mem-read term should charge."""
        paths = sorted({p for li in self.catalog.get_layers(model_id)
                        for p in self._layer_paths(model_id, li)})
        return sum(self._file_stored_bytes(Path(p)) for p in paths)

    def disk_footprint(self) -> int:
        """Total bytes the store holds on disk — every model's layer
        files and architecture metadata plus the (deduplicated) page
        store. Shared pages count once, which is the whole point."""
        total = 0
        for info in self.catalog.list_models():
            d = self._dir(info.model_id)
            if not d.is_dir():
                continue
            total += sum(p.stat().st_size for p in d.iterdir()
                         if p.is_file())
        if (self.root / "_pages").is_dir():
            total += self.pages.total_bytes()
        return total

    def dependents(self, model_id: str) -> List[str]:
        """Models whose stored layers depend on this one: fine-tune
        lineage (``base_model``/``delta_of``) or direct ``@model:layer``
        / ``@model/file`` references."""
        out = set()
        for info in self.catalog.list_models():
            if info.model_id == model_id:
                continue
            if info.base_model == model_id:
                out.add(info.model_id)
                continue
            for li in self.catalog.get_layers(info.model_id):
                if (li.delta_of == model_id
                        or li.file.startswith(f"@{model_id}:")
                        or li.file.startswith(f"@{model_id}/")):
                    out.add(info.model_id)
                    break
        return sorted(out)

    def delete(self, model_id: str) -> None:
        """Drop a model: refuse while dependents still read through it
        (so a page or base layer reachable via ``'@model:layer'``
        references can never lose its owner), release its page
        references, evict its cached tensors, remove its files and
        catalog rows. Orphaned pages stay on disk until :meth:`vacuum`.
        """
        self.catalog.get_model(model_id)          # KeyError if unknown
        deps = self.dependents(model_id)
        if deps:
            raise ValueError(
                f"cannot delete {model_id!r}: referenced by {deps}")
        self._decref_model_pages(model_id)
        d = self._dir(model_id)
        prefix = str(d) + os.sep
        with self._cache_lock:
            for k in [k for k in self._layer_cache
                      if k[0].startswith(prefix)]:
                self.stats.cache_bytes -= self._layer_cache.pop(k).nbytes
            self._pin_count.pop(model_id, None)
            for p in self._pin_paths.pop(model_id, []):
                left = self._pinned_paths.get(p, 0) - 1
                if left > 0:
                    self._pinned_paths[p] = left
                else:
                    self._pinned_paths.pop(p, None)
        if d.is_dir():
            shutil.rmtree(d)
        self.catalog.drop_model(model_id)

    def vacuum(self) -> Tuple[int, int]:
        """GC orphaned tensor pages (refcount 0). Returns
        ``(pages_removed, bytes_freed)``; referenced pages — including
        ones reachable only through ``'@model:layer'`` chains, whose
        references :meth:`delete` refuses to orphan — are never
        collected."""
        if not (self.root / "_pages").is_dir():
            return 0, 0
        return self.pages.vacuum()


# ---------------------------------------------------------------------------
# API-based models (simulated remote endpoints)
# ---------------------------------------------------------------------------

class ApiModelRegistry:
    """External model endpoints as logical operators (paper §3.1).

    No real network in this environment: endpoints are callables with a
    latency model, retry/timeout logic, and a response cache — the same
    control surface the paper describes for remote closed-source models.
    """

    def __init__(self, catalog: Optional[Catalog] = None):
        self.catalog = catalog
        self._endpoints: Dict[str, dict] = {}
        self._cache: Dict[Tuple[str, bytes], Any] = {}
        self.stats: Dict[str, Dict[str, float]] = {}

    def register(self, model_id: str, fn: Callable, *,
                 url: str = "https://api.example/v1",
                 latency_s: float = 0.05, jitter_s: float = 0.0,
                 failure_rate: float = 0.0, quota: Optional[int] = None,
                 timeout_s: float = 1.0, max_retries: int = 3,
                 cache: bool = True) -> None:
        self._endpoints[model_id] = dict(
            fn=fn, url=url, latency_s=latency_s, jitter_s=jitter_s,
            failure_rate=failure_rate, quota=quota, used=0,
            timeout_s=timeout_s, max_retries=max_retries, cache=cache)
        self.stats[model_id] = {"calls": 0, "retries": 0, "cache_hits": 0,
                                "latency_total": 0.0}
        if self.catalog:
            self.catalog.register_model(ModelInfo(
                model_id=model_id, storage="api", path=url,
                extra={"latency_s": latency_s}))

    def invoke(self, model_id: str, payload, rng: Optional[np.random.Generator] = None):
        ep = self._endpoints[model_id]
        st = self.stats[model_id]
        rng = rng or np.random.default_rng(0)
        key = None
        if ep["cache"]:
            try:
                key = (model_id, pickle.dumps(np.asarray(payload)))
            except Exception:
                key = None
            if key is not None and key in self._cache:
                st["cache_hits"] += 1
                return self._cache[key]
        if ep["quota"] is not None and ep["used"] >= ep["quota"]:
            raise RuntimeError(f"quota exhausted for {model_id}")
        last_err = None
        for attempt in range(ep["max_retries"] + 1):
            st["calls"] += 1
            ep["used"] += 1
            lat = ep["latency_s"] + float(rng.random()) * ep["jitter_s"]
            if lat > ep["timeout_s"]:
                st["retries"] += 1
                last_err = TimeoutError(f"{model_id} timed out")
                continue
            if ep["failure_rate"] and float(rng.random()) < ep["failure_rate"]:
                st["retries"] += 1
                last_err = ConnectionError(f"{model_id} transient failure")
                continue
            st["latency_total"] += lat
            time.sleep(min(lat, 0.002))  # token sleep, keep tests fast
            out = ep["fn"](payload)
            if key is not None:
                self._cache[key] = out
            return out
        raise last_err or RuntimeError("unreachable")

    def expected_latency(self, model_id: str) -> float:
        return self._endpoints[model_id]["latency_s"]
