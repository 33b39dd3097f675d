"""Random-forest regressor, from scratch (paper §4.3 uses a random forest
to map LVM forward features -> latent task embeddings).

CART regression trees with variance-reduction splits, feature and sample
bagging, multi-output leaves. Pure numpy — training sets here are small
(hundreds of historical tasks), so an exact quantile-threshold search is
affordable and dependency-free.

Port of ``src/repro/core/forest.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np


@dataclass
class _Node:
    feature: int = -1
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    value: Optional[np.ndarray] = None  # leaf payload [out_dim]


class DecisionTreeRegressor:
    def __init__(self, max_depth: int = 8, min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, rng: Optional[np.random.Generator] = None):
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng(0)
        self.nodes: List[_Node] = []

    def fit(self, X: np.ndarray, Y: np.ndarray) -> "DecisionTreeRegressor":
        self.nodes = []
        self._build(X, Y, depth=0)
        return self

    def _build(self, X, Y, depth) -> int:
        idx = len(self.nodes)
        self.nodes.append(_Node())
        n, d = X.shape
        if (depth >= self.max_depth or n < 2 * self.min_samples_leaf
                or np.allclose(Y.var(axis=0).sum(), 0.0)):
            self.nodes[idx].value = Y.mean(axis=0)
            return idx
        k = self.max_features or max(1, int(np.sqrt(d)))
        feats = self.rng.choice(d, size=min(k, d), replace=False)
        best = (None, None, np.inf)
        base_sse = ((Y - Y.mean(0)) ** 2).sum()
        for f in feats:
            xs = X[:, f]
            qs = np.unique(np.quantile(xs, np.linspace(0.1, 0.9, 9)))
            for t in qs:
                m = xs <= t
                nl = int(m.sum())
                if nl < self.min_samples_leaf or n - nl < self.min_samples_leaf:
                    continue
                yl, yr = Y[m], Y[~m]
                sse = (((yl - yl.mean(0)) ** 2).sum()
                       + ((yr - yr.mean(0)) ** 2).sum())
                if sse < best[2]:
                    best = (f, t, sse)
        if best[0] is None or best[2] >= base_sse:
            self.nodes[idx].value = Y.mean(axis=0)
            return idx
        f, t, _ = best
        m = X[:, f] <= t
        self.nodes[idx].feature = int(f)
        self.nodes[idx].threshold = float(t)
        self.nodes[idx].left = self._build(X[m], Y[m], depth + 1)
        self.nodes[idx].right = self._build(X[~m], Y[~m], depth + 1)
        return idx

    def predict(self, X: np.ndarray) -> np.ndarray:
        out = []
        for x in X:
            i = 0
            while self.nodes[i].value is None:
                nd = self.nodes[i]
                i = nd.left if x[nd.feature] <= nd.threshold else nd.right
            out.append(self.nodes[i].value)
        return np.stack(out)


class RandomForestRegressor:
    """Bagged multi-output CART forest (paper's regressor R, Eq. 3)."""

    def __init__(self, n_trees: int = 32, max_depth: int = 8,
                 min_samples_leaf: int = 2,
                 max_features: Optional[int] = None, seed: int = 0):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.seed = seed
        self.trees: List[DecisionTreeRegressor] = []

    def fit(self, X: np.ndarray, Y: np.ndarray) -> "RandomForestRegressor":
        X = np.asarray(X, np.float32)
        Y = np.asarray(Y, np.float32)
        if Y.ndim == 1:
            Y = Y[:, None]
        rng = np.random.default_rng(self.seed)
        n = X.shape[0]
        self.trees = []
        for t in range(self.n_trees):
            bag = rng.integers(0, n, size=n)
            tree = DecisionTreeRegressor(
                self.max_depth, self.min_samples_leaf, self.max_features,
                rng=np.random.default_rng(rng.integers(1 << 31)))
            tree.fit(X[bag], Y[bag])
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.asarray(X, np.float32)
        preds = np.stack([t.predict(X) for t in self.trees])
        return preds.mean(axis=0)


class RidgeRegressor:
    """Closed-form ridge alternative (JAX-friendly ablation baseline)."""

    def __init__(self, l2: float = 1e-2):
        self.l2 = l2
        self.Wb: Optional[np.ndarray] = None

    def fit(self, X, Y):
        X = np.asarray(X, np.float64)
        Y = np.asarray(Y, np.float64)
        if Y.ndim == 1:
            Y = Y[:, None]
        Xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        A = Xb.T @ Xb + self.l2 * np.eye(Xb.shape[1])
        self.Wb = np.linalg.solve(A, Xb.T @ Y)
        return self

    def predict(self, X):
        X = np.asarray(X, np.float64)
        Xb = np.concatenate([X, np.ones((X.shape[0], 1))], axis=1)
        return Xb @ self.Wb
