"""Build and load the port's CUDA kernels: nvcc -> ``.so`` -> ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone
into ``build/<name>-<hash>.so`` beside this file (the directory is listed
in ``.gitignore``), with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

The hash covers the source, every shared header ``csrc/*.cuh`` and the
flags, so an edited kernel or header rebuilds and an unchanged one is
reused. A library is built and loaded at most once per
process, under a lock, because the pipeline executor calls the kernels from
several threads. Nothing here runs at import: the first launch (or
:func:`build_all`) builds. There is no fallback: a missing ``nvcc`` or a
failed build raises.

:class:`Kernel` is what every wrapper shares around its launch: the device
check, the current stream, the CUDA error and the launch count.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, Sequence

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOCK = threading.Lock()
_NAME_LOCKS: Dict[str, threading.Lock] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}
_COUNT_LOCK = threading.Lock()
_SMS: Dict[int, int] = {}               # device index -> SM count
build_seconds: Dict[str, float] = {}     # name -> nvcc wall seconds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the port's CUDA kernels build with "
                       "the CUDA toolkit (PATH or CUDA_HOME)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _compile(name: str) -> Path:
    out = _library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_seconds[name] = time.perf_counter() - t0
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{proc.stderr}")
    tmp.replace(out)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    with _LOCK:
        lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with lock:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_compile(name)))
            _LIBS[name] = lib
        return lib


def on_cpu(name: str, *tensors: torch.Tensor) -> bool:
    """True if every tensor lies on the CPU, False if all lie on one CUDA
    device; raises ``ValueError`` otherwise, and for a fake tensor
    (``FakeTensorMode``, as a dry-run traces), which has no data to
    read."""
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise ValueError(f"{name}: a fake tensor has no data; trace the "
                         "plain route (use_kernels=False)")
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return True
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"{name}: inputs on {sorted(map(str, devs))}; all "
                         "must be on the CPU or on one CUDA device")
    return False


def records_grad(*tensors: torch.Tensor) -> bool:
    """True if autograd is recording and an input requires grad."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def refuse_grad(name: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` where autograd would need a backward of a
    kernel that has none, rather than return a tensor without a
    ``grad_fn``."""
    if records_grad(*tensors):
        raise RuntimeError(f"{name}: the kernel has no backward; call it "
                           "under torch.no_grad() / inference_mode, or "
                           "with inputs that require no grad")


def check_aligned(name: str, d: int, *tensors: torch.Tensor) -> None:
    """Raise ``ValueError`` unless a kernel that copies 16-byte chunks can
    read every tensor: D a multiple of 8, each data pointer and each
    stride but the last (of a dim longer than 1) a multiple of 16 bytes."""
    if d % 8:
        raise ValueError(f"{name}: head dim {d} is not a multiple of 8")
    for t in tensors:
        size = t.element_size()
        if t.data_ptr() % 16 or any(
                st * size % 16 for st, n in zip(t.stride()[:-1], t.shape)
                if n > 1):
            raise ValueError(f"{name}: a {t.dtype} operand with strides "
                             f"{t.stride()} at offset {t.data_ptr() % 16} "
                             "is not 16-byte aligned")


def sm_count(device: torch.device) -> int:
    """The SM count of the CUDA ``device``, read once per device."""
    index = (torch.cuda.current_device() if device.index is None
             else device.index)
    sms = _SMS.get(index)
    if sms is None:
        with _LOCK:
            sms = _SMS.setdefault(index, torch.cuda.get_device_properties(
                index).multi_processor_count)
    return sms


def even_grid(units: int, cap: int) -> int:
    """The fewest blocks, at most ``cap``, that take ``units`` work units
    (rows, tiles) in as few rounds as ``cap`` blocks would: each block
    then takes the same count, give or take one, and no block of a
    persistent grid idles through the last round."""
    rounds = -(-units // cap)
    return -(-units // rounds)


class Query:
    """A C function ``symbol`` of ``csrc/<lib>.cu`` that launches nothing
    and returns an int (an occupancy query); it runs with ``device``
    current. The library is loaded at the first call."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib, self.symbol, self.argtypes = lib, symbol, list(argtypes)
        self._fn = None

    def __call__(self, device: torch.device, *args) -> int:
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        with torch.cuda.device(device):
            return int(self._fn(*args))


class Kernel:
    """One C entry point ``symbol`` of ``csrc/<lib>.cu``. Its last
    parameter is the CUDA stream, and it returns ``cudaGetLastError()``.
    The library is loaded at the first launch."""

    def __init__(self, lib: str, symbol: str, argtypes: Sequence):
        self.lib, self.symbol = lib, symbol
        self.argtypes = [*argtypes, ctypes.c_void_p]
        self._fn = None

    def launch(self, wrapper: Callable, device: torch.device, *args,
               what: Callable[[], str]) -> None:
        """Run the kernel on ``device``'s current stream; raise on a CUDA
        error (``what()`` names the call), else add one to
        ``wrapper.launch_count``. A launch is on the hot path of a decode
        step, so the device is switched only when it is not current."""
        if self._fn is None:
            fn = getattr(load(self.lib), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        index = device.index
        current = torch._C._cuda_getDevice()
        if index is None or index == current:
            err = self._fn(*args, torch._C._cuda_getCurrentRawStream(current))
        else:
            with torch.cuda.device(index):
                err = self._fn(*args,
                               torch._C._cuda_getCurrentRawStream(index))
        if err != 0:
            raise RuntimeError(f"{wrapper.__name__} kernel launch failed: "
                               f"CUDA error {err} at {what()}")
        with _COUNT_LOCK:
            wrapper.launch_count += 1


def build_all() -> Dict[str, float]:
    """Build every kernel source, one nvcc per source, all started
    together; returns ``{name: build seconds}`` (0.0 for a library already
    on disk)."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    with ThreadPoolExecutor(max_workers=max(len(names), 1)) as pool:
        for f in [pool.submit(load, n) for n in names]:
            f.result()
    return {n: build_seconds.get(n, 0.0) for n in names}
