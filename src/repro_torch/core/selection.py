"""Two-phase task-centric model selection (paper §4).

Offline: NMF of the transfer matrix V [M x N] -> W (model embeddings),
H (task embeddings); train regressor R: task features -> H rows.
Online: t* = R(features(task)); Trans(m_i, t*) = <w_i, t*>; argmax.
Selection is O(M x k) vector math — no per-model fine-tuning (the paper's
cost argument vs AutoML).

Port of ``src/repro/core/selection.py``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.features import TaskFeaturizer
from repro_torch.core.forest import RandomForestRegressor, RidgeRegressor
from repro_torch.core.nmf import nmf, reconstruction_error


@dataclass
class SelectionReport:
    chosen: int
    scores: np.ndarray
    online_ms: float


def _kcenter_rows(V: np.ndarray, k: int, seed: int = 0) -> List[int]:
    """Greedy k-center over rows — maximally diverse model behaviors."""
    rng = np.random.default_rng(seed)
    first = int(np.argmax(V.var(axis=1)))
    chosen = [first]
    d = np.linalg.norm(V - V[first], axis=1)
    for _ in range(k - 1):
        nxt = int(np.argmax(d))
        chosen.append(nxt)
        d = np.minimum(d, np.linalg.norm(V - V[nxt], axis=1))
    return chosen


class ModelSelector:
    """Two-phase selector. ``n_anchors > 0`` adds *landmark features*: the
    probe accuracy of a few diverse anchor models on the target sample —
    still O(anchors) forward passes + least-squares, no fine-tuning (the
    same cost class as the paper's LVM feature extraction)."""

    def __init__(self, k: int = 8, regressor: str = "forest",
                 nmf_iters: int = 400, seed: int = 0, n_anchors: int = 4):
        self.k = k
        self.nmf_iters = nmf_iters
        self.seed = seed
        self.n_anchors = n_anchors
        self.featurizer = TaskFeaturizer()
        if regressor == "forest":
            self.reg = RandomForestRegressor(n_trees=48, max_depth=9,
                                             seed=seed)
        elif regressor == "ridge":
            self.reg = RidgeRegressor(l2=1e-1)
        else:
            raise ValueError(regressor)
        self.W: Optional[np.ndarray] = None
        self.H: Optional[np.ndarray] = None
        self.anchor_idx: List[int] = []
        self.anchor_models: List = []
        self.offline_seconds: float = 0.0
        self.recon_error: float = 0.0

    # -- offline phase ----------------------------------------------------
    def fit_offline(self, V: np.ndarray, task_features: np.ndarray,
                    mask: Optional[np.ndarray] = None,
                    zoo: Optional[List] = None,
                    nmf_init: Optional[Tuple[np.ndarray, np.ndarray]] = None
                    ) -> "ModelSelector":
        """V: [M, N] historical transfer matrix; task_features: [N, F].
        With ``zoo`` given, anchor landmark features are enabled.
        ``nmf_init=(W0, H0)`` replaces the NMF's seeded start."""
        t0 = time.time()
        V = np.asarray(V, np.float32)
        res = nmf(V, self.k, iters=self.nmf_iters,
                  mask=None if mask is None else np.asarray(mask, np.float32),
                  seed=self.seed, init=nmf_init)
        self.W = np.asarray(res.W)
        self.H = np.asarray(res.H)
        self.recon_error = reconstruction_error(
            V, res.W, res.H,
            None if mask is None else np.asarray(mask, np.float32))
        feats = np.asarray(task_features, np.float32)
        if zoo is not None and self.n_anchors > 0:
            self.anchor_idx = _kcenter_rows(V, min(self.n_anchors, len(zoo)),
                                            self.seed)
            self.anchor_models = [zoo[i] for i in self.anchor_idx]
            # historical anchor features come directly from V
            feats = np.concatenate([feats, V[self.anchor_idx].T], axis=1)
        self.reg.fit(feats, self.H)
        self.offline_seconds = time.time() - t0
        return self

    # -- online phase -------------------------------------------------------
    def _online_features(self, X: np.ndarray, y: np.ndarray) -> np.ndarray:
        feats = self.featurizer.features(X, y)
        if self.anchor_models:
            from repro_torch.core.zoo import Task, linear_probe_accuracy
            n = X.shape[0]
            cut = max(2, int(n * 0.7))
            t = Task("online", "?", X[:cut], y[:cut], X[cut:], y[cut:])
            anchors = np.array(
                [linear_probe_accuracy(m, t) for m in self.anchor_models],
                np.float32)
            feats = np.concatenate([feats, anchors])
        return feats

    def embed_task(self, feats: np.ndarray) -> np.ndarray:
        t = self.reg.predict(feats[None] if feats.ndim == 1 else feats)
        return t[0] if feats.ndim == 1 else t

    def scores(self, feats: np.ndarray) -> np.ndarray:
        t = self.embed_task(feats)
        return self.W @ t

    def select(self, X: np.ndarray, y: np.ndarray) -> SelectionReport:
        t0 = time.time()
        feats = self._online_features(X, y)
        s = self.scores(feats)
        return SelectionReport(int(np.argmax(s)), s,
                               (time.time() - t0) * 1e3)

    def rank(self, X: np.ndarray, y: np.ndarray, top: int = 5) -> List[int]:
        return list(np.argsort(-self.select(X, y).scores)[:top])


# ---------------------------------------------------------------------------
# Evaluation helpers (selection regret vs oracle / exhaustive baselines)
# ---------------------------------------------------------------------------

def selection_regret(selector: ModelSelector, V_true_col: np.ndarray,
                     X: np.ndarray, y: np.ndarray) -> Dict[str, float]:
    """Regret of the selector's pick vs the oracle-best model, plus the
    rank of the chosen model (1 = best)."""
    rep = selector.select(X, y)
    best = float(V_true_col.max())
    got = float(V_true_col[rep.chosen])
    order = np.argsort(-V_true_col)
    rank = int(np.where(order == rep.chosen)[0][0]) + 1
    return {"regret": best - got, "chosen_acc": got, "oracle_acc": best,
            "rank": rank, "online_ms": rep.online_ms}
