"""Task feature extraction (paper §4.3's CLIP forward features).

No CLIP offline; the stand-in is a *frozen* random-projection encoder plus
dataset meta-features — the mechanism the paper relies on (fixed pretrained
features whose geometry correlates with transferability) rather than the
specific network. Tasks drawn from similar distributions land close in
feature space, which is the assumption Eq. 3 needs.

Port of ``src/repro/core/features.py``.
"""
from __future__ import annotations

import numpy as np

_MAX_DIM = 512


class TaskFeaturizer:
    """(X, y) -> fixed-length task feature vector."""

    def __init__(self, proj_dim: int = 24, seed: int = 7):
        self.proj_dim = proj_dim
        rng = np.random.default_rng(seed)
        self._proj = rng.standard_normal((_MAX_DIM, proj_dim)).astype(
            np.float32) / np.sqrt(_MAX_DIM)

    @property
    def dim(self) -> int:
        # proj mean + proj std + class-geometry stats + meta
        return 2 * self.proj_dim + 6

    def features(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        y = np.asarray(y)
        n, d = X.shape
        W = self._proj[:d] if d <= _MAX_DIM else self._proj
        Xp = np.tanh((X[:, :_MAX_DIM] @ W))                  # frozen encoder
        mu = Xp.mean(axis=0)
        sd = Xp.std(axis=0)
        classes = np.unique(y)
        C = len(classes)
        # class geometry in encoder space (transfer-relevant structure)
        cents = np.stack([Xp[y == c].mean(axis=0) for c in classes]) \
            if C > 1 else np.zeros((1, Xp.shape[1]), np.float32)
        between = float(np.linalg.norm(cents - cents.mean(0), axis=1).mean())
        within = float(np.mean([Xp[y == c].std(axis=0).mean()
                                for c in classes])) if C > 1 else float(sd.mean())
        counts = np.array([(y == c).mean() for c in classes])
        entropy = float(-(counts * np.log(counts + 1e-12)).sum())
        meta = np.array([
            np.log1p(n), np.log1p(d), float(C),
            entropy, between, between / (within + 1e-6),
        ], np.float32)
        return np.concatenate([mu, sd, meta]).astype(np.float32)
