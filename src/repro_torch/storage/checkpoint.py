"""Distributed checkpointing on the decoupled Mvec layer store.

Design (maps MorphingDB's partial-load property onto pod-scale training):
  - every parameter and optimizer leaf is one Mvec layer file (axis-0 ranges
    readable without touching the rest);
  - per-step checkpoints live under ``<root>/step_<N>/`` with an atomic
    COMMIT marker written last — a crashed save is never restorable;
  - saves can run asynchronously (background thread) double-buffered, so
    the train loop only blocks on the previous save;
  - restore can *reshard elastically*: a checkpoint written as S shard
    files per layer restores onto S' != S hosts via Mvec range reads.

Port of ``src/repro/storage/checkpoint.py``. The on-disk format is the
reference's byte for byte (``index.json``, ``COMMIT``, the ``.mvec``
shards), so a checkpoint written by either package restores in the
other. A leaf may be a numpy array or a ``torch.Tensor`` on any device;
a tensor is written from ``.detach().cpu()``. Restored leaves are numpy
arrays, except bfloat16 ones, which come back as CPU ``torch.bfloat16``
tensors (numpy has no bfloat16; see ``repro_torch.storage.mvec``).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np

from repro_torch.storage import mvec
from repro_torch.storage.stores import flatten_params, unflatten_like


def _host(leaf, copy: bool = False):
    """A leaf as the host array that is written: a torch tensor through
    ``.detach().cpu()`` (a private copy with ``copy``, for a snapshot the
    caller may go on mutating), anything else through ``np.asarray``."""
    t = mvec._torch_tensor(leaf)
    if t is None:
        return np.asarray(leaf)
    return t.detach().to("cpu", copy=copy)


def _concat(parts: list):
    """Row-concatenate decoded shards (torch tensors for bfloat16)."""
    if len(parts) == 1:
        return parts[0]
    if mvec._torch_tensor(parts[0]) is not None:
        import torch
        return torch.cat(parts, dim=0)
    return np.concatenate(parts, axis=0)


class CheckpointManager:
    def __init__(self, root: Path, keep: int = 3):
        self.root = Path(root)
        self.root.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # -- save ----------------------------------------------------------------
    def _step_dir(self, step: int) -> Path:
        return self.root / f"step_{step:08d}"

    def save(self, step: int, state, *, num_shards: int = 1) -> Path:
        """Blocking save. ``state`` is any pytree (params, opt, rng...)."""
        d = self._step_dir(step)
        tmp = d.with_suffix(".tmp")
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        flat = flatten_params(state)
        index = {}
        for key, leaf in flat.items():
            arr = _host(leaf)
            dtype = mvec.dtype_name(arr)
            safe = key.replace("/", "__")
            if num_shards > 1 and arr.ndim >= 1 and arr.shape[0] >= num_shards:
                rows = arr.shape[0]
                bounds = [rows * i // num_shards for i in range(num_shards + 1)]
                files = []
                for s in range(num_shards):
                    fn = f"{safe}.shard{s:03d}.mvec"
                    (tmp / fn).write_bytes(
                        mvec.encode(arr[bounds[s]:bounds[s + 1]]))
                    files.append(fn)
                index[key] = {"dtype": dtype, "shape": list(arr.shape),
                              "shards": files, "bounds": bounds}
            else:
                fn = f"{safe}.mvec"
                (tmp / fn).write_bytes(mvec.encode(arr))
                index[key] = {"dtype": dtype, "shape": list(arr.shape),
                              "shards": [fn], "bounds": [0, arr.shape[0] if arr.ndim else 0]}
        (tmp / "index.json").write_text(json.dumps(index))
        (tmp / "COMMIT").write_text(str(time.time()))
        if d.exists():
            shutil.rmtree(d)
        tmp.rename(d)
        self._gc()
        return d

    def save_async(self, step: int, state, *, num_shards: int = 1) -> None:
        """Non-blocking save; blocks only if a previous save is running."""
        self.wait()
        # snapshot to host memory before returning control
        host_state = unflatten_like(
            state, {k: _host(v, copy=True)
                    for k, v in flatten_params(state).items()})

        def work():
            try:
                self.save(step, host_state, num_shards=num_shards)
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    # -- restore ---------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.root.glob("step_*"):
            if p.is_dir() and (p / "COMMIT").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                shard: Optional[int] = None, num_hosts: int = 1):
        """Restore full state, or host ``shard`` of ``num_hosts`` (elastic:
        num_hosts need not match the shard count at save time)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError("no committed checkpoint")
        d = self._step_dir(step)
        index = json.loads((d / "index.json").read_text())
        flat: Dict[str, Any] = {}
        for key, meta in index.items():
            flat[key] = self._read_leaf(d, meta, shard, num_hosts)
        return unflatten_like(template, flat), step

    def _read_leaf(self, d: Path, meta: dict, shard: Optional[int],
                   num_hosts: int):
        shape = meta["shape"]
        files, bounds = meta["shards"], meta["bounds"]
        if shard is None or not shape or shape[0] < num_hosts:
            out = _concat([mvec.decode((d / f).read_bytes()) for f in files])
            return out.reshape(shape) if not shape else out
        # elastic per-host range read across saved shard files
        rows = shape[0]
        lo = rows * shard // num_hosts
        hi = rows * (shard + 1) // num_hosts
        pieces = []
        for i, f in enumerate(files):
            s_lo, s_hi = bounds[i], bounds[i + 1]
            a, b = max(lo, s_lo), min(hi, s_hi)
            if a >= b:
                continue
            with open(d / f, "rb") as fh:
                pieces.append(mvec.read_slice(fh, a - s_lo, b - s_lo))
        return _concat(pieces)
