"""Mvec tensor representation (paper §3.2).

A shape-aware binary tensor format: a *shape array* (dimension sizes) and a
*data array* (row-major flattened elements), extended here with an explicit
dtype tag so bf16/f32/int8 zoo tensors round-trip losslessly between the
store and PyTorch. Supports SQL-style slicing and partial (range) loads without
deserializing the whole tensor — the property the paper uses for
fine-grained in-DB access, which we use for per-shard checkpoint reads and
width-sliced trunk resolution.

The ``flags`` byte tags what the payload *means*: ``FLAG_DELTA`` marks a
fine-tune delta tensor (``variant - base``, same shape/dtype as the base
layer) that only makes sense composed onto its base layer. The tag makes
delta files self-describing on disk, so a reader can never mistake a delta
for full weights (``DecoupledStore`` validates it on every delta read).

Compressed payload encodings (the NeurStore-style delta compression the
store applies to fine-tune residuals) keep the *logical* dtype/shape in
the header and select an aux header + packed payload via flags:

``FLAG_SPARSE``
    CSR-style index+value encoding for deltas where most entries are
    (near-)zero. Aux: ``nnz u64 | bound f64``; payload: ``nnz`` sorted
    i64 flat indices then ``nnz`` values in the logical dtype. Exact
    when ``bound == 0`` (only exact zeros dropped).
``FLAG_QUANT``
    Symmetric int8/int16 quantization of a dense float residual. Aux:
    ``code u8 | pad 3B | scale f64 | zero_point f64 | bound f64``;
    payload: fixed-width integer codes. Dequant is
    ``(codes - zero_point) * scale`` in float64, cast to the logical
    dtype; ``bound`` declares the max abs reconstruction error
    (``scale/2`` for round-to-nearest). ``zero_point`` is always 0 here
    so exact-zero delta entries stay exactly zero through a round trip.
``FLAG_PAGED``
    The payload lives in a content-hashed page store; the file holds
    only a page table. Aux: ``page_bytes u32 | npages u32`` then
    ``npages`` 32-byte sha256 digests of consecutive chunks of the
    dense row-major payload. Decoding requires the page store, so
    ``decode`` refuses paged buffers (``DecoupledStore`` resolves them).

All encodings support row-range slicing without materializing the full
tensor: quant/paged payloads are fixed-stride (seek), sparse payloads
binary-search the index array and read only the covered value range.

Wire layout (little-endian):
  magic  u32 = 0x4D564543 ("MVEC")
  dtype  u8 code | flags u8 | reserved u16
  ndim   u32
  shape  u64[ndim]
  aux    encoding-specific header (FLAG_SPARSE/FLAG_QUANT/FLAG_PAGED only)
  data   raw bytes, row-major (packed per encoding)

Port of ``src/repro/storage/mvec.py``. The wire format is the reference's,
byte for byte. One difference: numpy has no bfloat16 of its own, and the
reference views bf16 payloads through ``ml_dtypes`` (returning raw
``uint16`` where it is missing). The port decodes bf16 through torch
instead and returns a CPU ``torch.bfloat16`` tensor; ``encode`` takes
torch tensors of any supported dtype as well as numpy arrays.
"""
from __future__ import annotations

import struct
import sys
from dataclasses import dataclass
from typing import BinaryIO, Optional, Sequence, Tuple, Union

import numpy as np

MAGIC = 0x4D564543

# flags byte: payload semantics beyond shape/dtype
FLAG_DELTA = 0x01      # fine-tune delta (variant - base); compose before use
FLAG_SPARSE = 0x02     # CSR-style index+value payload (sparse residual)
FLAG_QUANT = 0x04      # int8/int16 quantized codes + scale/zero-point
FLAG_PAGED = 0x08      # payload is a page table into a content-hashed store

ENCODING_FLAGS = FLAG_SPARSE | FLAG_QUANT | FLAG_PAGED

_SPARSE_AUX = struct.Struct("<Qd")       # nnz, bound
_QUANT_AUX = struct.Struct("<B3xddd")    # code dtype, scale, zero_point, bound
_PAGED_AUX = struct.Struct("<II")        # page_bytes, npages
_DIGEST_SIZE = 32                        # sha256

_DTYPES = ["float32", "float64", "float16", "bfloat16", "int8", "int16",
           "int32", "int64", "uint8", "uint32", "bool"]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}

# bfloat16 has no numpy dtype; store as uint16 payload with the bf16 tag.
_NP_FOR = {"bfloat16": np.uint16, "bool": np.bool_}


def _np_dtype(name: str):
    return np.dtype(_NP_FOR.get(name, name))


def _torch_tensor(arr):
    """``arr`` if it is a torch tensor, else None (torch is not imported
    here: an array can only be a tensor once torch is loaded)."""
    torch = sys.modules.get("torch")
    return arr if torch is not None and isinstance(arr, torch.Tensor) \
        else None


def dtype_name(arr) -> str:
    return str(arr.dtype).replace("torch.", "")


def _bf16_from_bits(arr: np.ndarray):
    """uint16 bf16 bit patterns -> CPU ``torch.bfloat16`` tensor."""
    import torch
    bits = np.array(arr, dtype=np.uint16, copy=True).view(np.int16)
    return torch.from_numpy(bits).view(torch.bfloat16)


@dataclass(frozen=True)
class MvecHeader:
    dtype: str
    shape: Tuple[int, ...]
    flags: int = 0

    @property
    def is_delta(self) -> bool:
        return bool(self.flags & FLAG_DELTA)

    @property
    def is_sparse(self) -> bool:
        return bool(self.flags & FLAG_SPARSE)

    @property
    def is_quant(self) -> bool:
        return bool(self.flags & FLAG_QUANT)

    @property
    def is_paged(self) -> bool:
        return bool(self.flags & FLAG_PAGED)

    @property
    def encoding(self) -> str:
        if self.is_sparse:
            return "sparse"
        if self.is_quant:
            return "quant"
        if self.is_paged:
            return "paged"
        return "dense"

    @property
    def itemsize(self) -> int:
        return _np_dtype(self.dtype).itemsize

    @property
    def size(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n

    @property
    def nbytes(self) -> int:
        return self.size * self.itemsize

    @property
    def header_size(self) -> int:
        return 12 + 8 * len(self.shape)


@dataclass(frozen=True)
class AuxInfo:
    """Decoded aux header of a compressed payload (``decode_aux``).
    ``bound`` is the declared max abs reconstruction error (0 = exact);
    ``aux_size`` is the aux header's byte length after the shape array."""
    encoding: str = "dense"
    bound: float = 0.0
    scale: float = 0.0
    zero_point: float = 0.0
    code_dtype: str = ""
    nnz: int = 0
    page_bytes: int = 0
    digests: Tuple[bytes, ...] = ()
    aux_size: int = 0


def _pack_header(name: str, shape: Sequence[int], flags: int) -> bytes:
    head = struct.pack("<IBBH I", MAGIC, _DTYPE_CODE[name], flags & 0xFF, 0,
                       len(shape))
    head += struct.pack(f"<{len(shape)}Q", *shape)
    return head


def payload_array(arr) -> Tuple[np.ndarray, str]:
    """Contiguous storage view of an array (bf16 -> uint16) plus its
    logical dtype name — the raw row-major bytes every encoding packs."""
    name = dtype_name(arr)
    if name not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {name}")
    t = _torch_tensor(arr)
    if t is not None:
        import torch
        t = t.detach().cpu().contiguous()
        np_arr = (t.view(torch.int16).numpy().view(np.uint16)
                  if name == "bfloat16" else t.numpy())
    else:
        np_arr = np.asarray(arr)
        if name == "bfloat16":
            np_arr = np_arr.view(np.uint16)
    if np_arr.ndim:  # NB: ascontiguousarray promotes 0-d -> 1-d
        np_arr = np.ascontiguousarray(np_arr)
    return np_arr, name


def encode(arr, flags: int = 0) -> bytes:
    """torch/numpy array -> Mvec bytes (row-major, shape+dtype preserved).
    ``flags`` tags payload semantics (e.g. ``FLAG_DELTA``); compressed
    encodings have their own constructors (``encode_sparse`` /
    ``encode_quant`` / ``encode_paged``)."""
    if flags & ENCODING_FLAGS:
        raise ValueError("use encode_sparse/encode_quant/encode_paged "
                         "for compressed payloads")
    np_arr, name = payload_array(arr)
    return _pack_header(name, np_arr.shape, flags) + np_arr.tobytes()


def encode_sparse(arr, flags: int = 0, eps: float = 0.0) -> bytes:
    """CSR-style sparse encoding: entries with ``|x| <= eps`` are
    dropped (``eps=0`` drops only exact zeros — lossless up to the sign
    of zero). The declared error bound is ``eps``."""
    if flags & ENCODING_FLAGS:
        raise ValueError("encoding flag bits are set by the encoder")
    np_arr, name = payload_array(arr)
    flat = np_arr.reshape(-1)
    if name == "bfloat16":
        keep = flat != 0          # uint16 view: drop +0.0 words only
    elif eps and np_arr.dtype.kind == "f":
        keep = np.abs(flat) > eps
    else:
        keep = flat != 0
    idx = np.flatnonzero(keep).astype(np.int64)
    vals = flat[idx]
    bound = float(eps) if np_arr.dtype.kind == "f" else 0.0
    head = _pack_header(name, np_arr.shape, (flags | FLAG_SPARSE) & 0xFF)
    aux = _SPARSE_AUX.pack(len(idx), bound)
    return head + aux + idx.tobytes() + vals.tobytes()


def encode_quant(arr, code_dtype: str = "int8", flags: int = 0) -> bytes:
    """Symmetric integer quantization of a float tensor:
    ``scale = max|x| / qmax``, ``zero_point = 0`` (exact zeros survive),
    round-to-nearest codes, declared bound ``scale/2``. Values must be
    finite (callers keep non-finite residuals dense)."""
    if flags & ENCODING_FLAGS:
        raise ValueError("encoding flag bits are set by the encoder")
    if code_dtype not in ("int8", "int16"):
        raise ValueError(f"unsupported quant code dtype {code_dtype}")
    np_arr, name = payload_array(arr)
    if np_arr.dtype.kind != "f":
        raise ValueError("quantization only applies to float tensors")
    qmax = 127 if code_dtype == "int8" else 32767
    max_abs = float(np.max(np.abs(np_arr))) if np_arr.size else 0.0
    if not np.isfinite(max_abs):
        raise ValueError("cannot quantize non-finite values")
    scale = max_abs / qmax
    if scale > 0.0:
        codes = np.clip(np.rint(np_arr.astype(np.float64) / scale),
                        -qmax, qmax).astype(code_dtype)
        bound = scale / 2.0
    else:
        codes = np.zeros(np_arr.shape, dtype=code_dtype)
        bound = 0.0
    head = _pack_header(name, np_arr.shape, (flags | FLAG_QUANT) & 0xFF)
    aux = _QUANT_AUX.pack(_DTYPE_CODE[code_dtype], scale, 0.0, bound)
    return head + aux + codes.tobytes()


def encode_paged(dtype: str, shape: Sequence[int], page_bytes: int,
                 digests: Sequence[bytes], flags: int = 0) -> bytes:
    """Page-table file for a tensor whose dense payload lives in a
    content-hashed page store (``npages`` sha256 digests of consecutive
    ``page_bytes`` chunks; the last chunk may be short)."""
    if flags & ENCODING_FLAGS:
        raise ValueError("encoding flag bits are set by the encoder")
    if dtype not in _DTYPE_CODE:
        raise ValueError(f"unsupported dtype {dtype}")
    for dg in digests:
        if len(dg) != _DIGEST_SIZE:
            raise ValueError("page digests must be 32-byte sha256")
    head = _pack_header(dtype, tuple(shape), (flags | FLAG_PAGED) & 0xFF)
    aux = _PAGED_AUX.pack(int(page_bytes), len(digests))
    return head + aux + b"".join(digests)


def decode_header(buf: Union[bytes, memoryview]) -> MvecHeader:
    magic, code, flags, _r, ndim = struct.unpack_from("<IBBH I", buf, 0)
    if magic != MAGIC:
        raise ValueError("not an Mvec buffer")
    shape = struct.unpack_from(f"<{ndim}Q", buf, 12)
    return MvecHeader(_DTYPES[code], tuple(int(s) for s in shape),
                      flags=int(flags))


def decode_aux(buf: Union[bytes, memoryview]) -> AuxInfo:
    """Parse the encoding-specific aux header (``AuxInfo(encoding='dense')``
    for plain payloads). ``buf`` needs only header + aux bytes."""
    h = decode_header(buf)
    off = h.header_size
    if h.is_sparse:
        nnz, bound = _SPARSE_AUX.unpack_from(buf, off)
        return AuxInfo(encoding="sparse", bound=float(bound), nnz=int(nnz),
                       aux_size=_SPARSE_AUX.size)
    if h.is_quant:
        code, scale, zp, bound = _QUANT_AUX.unpack_from(buf, off)
        return AuxInfo(encoding="quant", bound=float(bound),
                       scale=float(scale), zero_point=float(zp),
                       code_dtype=_DTYPES[code], aux_size=_QUANT_AUX.size)
    if h.is_paged:
        page_bytes, npages = _PAGED_AUX.unpack_from(buf, off)
        base = off + _PAGED_AUX.size
        digests = tuple(
            bytes(buf[base + i * _DIGEST_SIZE:base + (i + 1) * _DIGEST_SIZE])
            for i in range(npages))
        return AuxInfo(encoding="paged", page_bytes=int(page_bytes),
                       digests=digests,
                       aux_size=_PAGED_AUX.size + npages * _DIGEST_SIZE)
    return AuxInfo()


def _finish(arr: np.ndarray, dtype: str):
    return _bf16_from_bits(arr) if dtype == "bfloat16" else arr


def _dequant(codes: np.ndarray, aux: AuxInfo, dtype: str) -> np.ndarray:
    out = (codes.astype(np.float64) - aux.zero_point) * aux.scale
    return out.astype(_np_dtype(dtype))


def _row_elems(h: MvecHeader) -> int:
    n = 1
    for d in h.shape[1:]:
        n *= d
    return n


def _clip_rows(h: MvecHeader, start: int, stop: int) -> Tuple[int, int]:
    if not h.shape:
        raise ValueError("cannot slice a scalar")
    rows = h.shape[0]
    start = min(max(0, start), rows)
    stop = min(max(stop, start), rows)
    return start, stop


def decode(buf: Union[bytes, memoryview]):
    """Mvec bytes -> numpy array (bf16 as a CPU ``torch.bfloat16``
    tensor). Sparse and quantized
    payloads decode to the dense logical tensor; paged payloads need the
    page store and are rejected here."""
    h = decode_header(buf)
    off = h.header_size
    if h.is_paged:
        raise ValueError("paged Mvec payloads resolve through a page store")
    if h.is_sparse:
        aux = decode_aux(buf)
        base = off + aux.aux_size
        idx = np.frombuffer(buf, np.int64, aux.nnz, base)
        vals = np.frombuffer(buf, _np_dtype(h.dtype), aux.nnz,
                             base + 8 * aux.nnz)
        out = np.zeros(h.size, dtype=_np_dtype(h.dtype))
        out[idx] = vals
        return _finish(out.reshape(h.shape), h.dtype)
    if h.is_quant:
        aux = decode_aux(buf)
        codes = np.frombuffer(buf, _np_dtype(aux.code_dtype), h.size,
                              off + aux.aux_size)
        return _finish(_dequant(codes, aux, h.dtype).reshape(h.shape),
                       h.dtype)
    raw = np.frombuffer(buf, dtype=_np_dtype(h.dtype), offset=off,
                        count=h.size)
    return _finish(raw.reshape(h.shape), h.dtype)


def decode_slice(buf: Union[bytes, memoryview], start: int, stop: int):
    """Partial load: rows [start, stop) along axis 0 without materializing
    the rest (the paper's SQL-level slicing / partial loading). Works for
    sparse (index binary search) and quantized (fixed-stride) payloads."""
    h = decode_header(buf)
    start, stop = _clip_rows(h, start, stop)
    row_elems = _row_elems(h)
    lo, hi = start * row_elems, stop * row_elems
    if h.is_paged:
        raise ValueError("paged Mvec payloads resolve through a page store")
    if h.is_sparse:
        aux = decode_aux(buf)
        base = h.header_size + aux.aux_size
        idx = np.frombuffer(buf, np.int64, aux.nnz, base)
        i0, i1 = np.searchsorted(idx, (lo, hi))
        vals = np.frombuffer(buf, _np_dtype(h.dtype), int(i1 - i0),
                             base + 8 * aux.nnz + int(i0) * h.itemsize)
        out = np.zeros(hi - lo, dtype=_np_dtype(h.dtype))
        out[idx[i0:i1] - lo] = vals
        return _finish(out.reshape((stop - start,) + h.shape[1:]), h.dtype)
    if h.is_quant:
        aux = decode_aux(buf)
        code_item = _np_dtype(aux.code_dtype).itemsize
        codes = np.frombuffer(buf, _np_dtype(aux.code_dtype), hi - lo,
                              h.header_size + aux.aux_size + lo * code_item)
        return _finish(
            _dequant(codes, aux, h.dtype)
            .reshape((stop - start,) + h.shape[1:]), h.dtype)
    offset = h.header_size + lo * h.itemsize
    raw = np.frombuffer(buf, dtype=_np_dtype(h.dtype), offset=offset,
                        count=hi - lo)
    return _finish(raw.reshape((stop - start,) + h.shape[1:]), h.dtype)


def read_header(f: BinaryIO) -> MvecHeader:
    pos = f.tell()
    head = f.read(12)
    magic, code, flags, _r, ndim = struct.unpack("<IBBH I", head)
    if magic != MAGIC:
        raise ValueError("not an Mvec file")
    shape = struct.unpack(f"<{ndim}Q", f.read(8 * ndim))
    f.seek(pos)
    return MvecHeader(_DTYPES[code], tuple(int(s) for s in shape),
                      flags=int(flags))


def read_aux(f: BinaryIO) -> Tuple[MvecHeader, AuxInfo]:
    """Read header + aux from a file without touching the data region
    (file position restored)."""
    pos = f.tell()
    h = read_header(f)
    if not (h.flags & ENCODING_FLAGS):
        return h, AuxInfo()
    f.seek(pos + h.header_size)
    if h.is_sparse:
        raw = f.read(_SPARSE_AUX.size)
    elif h.is_quant:
        raw = f.read(_QUANT_AUX.size)
    else:
        raw = f.read(_PAGED_AUX.size)
        page_bytes, npages = _PAGED_AUX.unpack(raw)
        raw += f.read(npages * _DIGEST_SIZE)
    f.seek(pos)
    return h, decode_aux(
        _pack_header(h.dtype, h.shape, h.flags) + raw)


def read_slice_counted(f: BinaryIO, start: int, stop: int
                       ) -> Tuple[np.ndarray, int, AuxInfo]:
    """File-level partial read: seek + read only the bytes the requested
    rows need. Returns ``(rows_array, bytes_read, aux)`` so callers can
    account actual disk I/O — for a sparse payload that is the full index
    array (consulted to locate the row range) plus the covered values;
    for quantized payloads just the covered codes."""
    pos = f.tell()
    h, aux = read_aux(f)
    start, stop = _clip_rows(h, start, stop)
    row_elems = _row_elems(h)
    lo, hi = start * row_elems, stop * row_elems
    out_shape = (stop - start,) + h.shape[1:]
    data0 = pos + h.header_size + aux.aux_size
    if h.is_paged:
        raise ValueError("paged Mvec payloads resolve through a page store")
    if h.is_sparse:
        f.seek(data0)
        idx = np.frombuffer(f.read(8 * aux.nnz), np.int64)
        i0, i1 = (int(x) for x in np.searchsorted(idx, (lo, hi)))
        f.seek(data0 + 8 * aux.nnz + i0 * h.itemsize)
        raw = f.read((i1 - i0) * h.itemsize)
        vals = np.frombuffer(raw, _np_dtype(h.dtype))
        out = np.zeros(hi - lo, dtype=_np_dtype(h.dtype))
        out[idx[i0:i1] - lo] = vals
        f.seek(pos)
        return (_finish(out.reshape(out_shape), h.dtype),
                aux.aux_size + 8 * aux.nnz + len(raw), aux)
    if h.is_quant:
        code_item = _np_dtype(aux.code_dtype).itemsize
        f.seek(data0 + lo * code_item)
        raw = f.read((hi - lo) * code_item)
        codes = np.frombuffer(raw, _np_dtype(aux.code_dtype))
        f.seek(pos)
        return (_finish(_dequant(codes, aux, h.dtype).reshape(out_shape),
                        h.dtype),
                aux.aux_size + len(raw), aux)
    f.seek(data0 + lo * h.itemsize)
    raw = f.read((hi - lo) * h.itemsize)
    arr = np.frombuffer(raw, dtype=_np_dtype(h.dtype)).reshape(out_shape)
    f.seek(pos)
    return _finish(arr, h.dtype), len(raw), aux


def read_slice(f: BinaryIO, start: int, stop: int):
    """File-level partial read (seek + read only the requested rows)."""
    return read_slice_counted(f, start, stop)[0]
