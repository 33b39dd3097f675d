"""Tokenized data pipeline: synthetic corpus + file-backed shards, per-host
sharding, deterministic resume (step -> batch mapping is stateless).

Port of ``src/repro/data/pipeline.py``, numpy only. The per-batch seed is
the reference's ``hash((seed, step, host)) % (1 << 31)``: a tuple of ints
hashes the same in every process (no hash randomisation), so the batches
equal the reference's byte for byte. ``batch`` returns numpy arrays; the
caller moves them to its device.
"""
from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Dict, Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 32000
    seq_len: int = 1024
    global_batch: int = 8
    seed: int = 0
    # Markov-chain synthetic text: learnable structure (not pure noise)
    order_mix: float = 0.8
    branching: int = 16   # successors per token (lower = easier)


class SyntheticCorpus:
    """Deterministic synthetic LM data with learnable bigram structure.

    batch(step, host, num_hosts) is pure — restart-safe without dataloader
    checkpoints (the step index IS the state).
    """

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # sparse bigram table: each token -> `branching` likely successors
        self._succ = rng.integers(0, v, size=(v, cfg.branching)).astype(
            np.int32)

    def batch(self, step: int, host: int = 0, num_hosts: int = 1
              ) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // num_hosts
        seed = hash((cfg.seed, step, host)) % (1 << 31)
        rng = np.random.default_rng(seed)
        B, S = per_host, cfg.seq_len
        toks = np.empty((B, S), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, B)
        follow = rng.random((B, S)) < cfg.order_mix
        choice = rng.integers(0, cfg.branching, (B, S))
        rand_tok = rng.integers(0, cfg.vocab_size, (B, S))
        for t in range(1, S):
            succ = self._succ[toks[:, t - 1], choice[:, t]]
            toks[:, t] = np.where(follow[:, t], succ, rand_tok[:, t])
        return {"tokens": toks}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1


class FileShardedCorpus:
    """Pre-tokenized .npy shards, round-robin across hosts with a
    deterministic (step -> shard, offset) mapping for elastic restarts."""

    def __init__(self, root: Path, seq_len: int, global_batch: int):
        self.files = sorted(Path(root).glob("*.npy"))
        if not self.files:
            raise FileNotFoundError(f"no .npy shards under {root}")
        self.seq_len = seq_len
        self.global_batch = global_batch
        self._cache: Dict[int, np.ndarray] = {}

    def _shard(self, i: int) -> np.ndarray:
        if i not in self._cache:
            self._cache = {i: np.load(self.files[i], mmap_mode="r")}
        return self._cache[i]

    def batch(self, step: int, host: int = 0, num_hosts: int = 1):
        per_host = self.global_batch // num_hosts
        out = np.empty((per_host, self.seq_len), np.int32)
        for b in range(per_host):
            gidx = step * self.global_batch + host * per_host + b
            shard = self._shard(gidx % len(self.files))
            rows = (len(shard) - self.seq_len) or 1
            off = (gidx * 9176) % rows
            out[b] = shard[off:off + self.seq_len]
        return {"tokens": out}
