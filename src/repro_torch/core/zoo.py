"""Mini model-zoo + task generator for the selection experiments.

A real transfer-learning microcosm that runs on CPU in seconds:
  - *tasks* are classification datasets drawn from parameterized families
    (rotated Gaussian mixtures, nonlinear ring/spiral maps, sparse
    features) — the analogue of the paper's series/NLP/image datasets;
  - *zoo models* are frozen feature extractors "pretrained" on a source
    task (their projection encodes the source's class geometry: top
    class-scatter eigendirections + noise);
  - *transfer performance* = held-out accuracy of a least-squares linear
    probe on the frozen features — the standard transferability measure.

Models transfer better to tasks resembling their source family, so the
transfer matrix V has genuine low-rank structure for the NMF to find.

Port of ``src/repro/core/zoo.py``.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

FAMILIES = ("gauss", "ring", "sparse", "stripe")


def adapt_input_width(X: np.ndarray, d: int) -> np.ndarray:
    """Slice wide inputs / zero-pad narrow ones to feature width ``d``.

    The single source of truth for input-width adaptation: every
    execution path (numpy ``ZooModel.features`` and the staged device
    backends) must use this so backends stay numerically interchangeable.
    """
    if X.shape[1] >= d:
        return X[:, :d]
    return np.pad(X, ((0, 0), (0, d - X.shape[1])))


@dataclass
class Task:
    name: str
    family: str
    X: np.ndarray
    y: np.ndarray
    X_test: np.ndarray
    y_test: np.ndarray
    params: Dict = field(default_factory=dict)


def make_task(rng: np.random.Generator, family: str, *, n: int = 240,
              dim: int = 16, classes: int = 3, noise: float = 0.4,
              name: str = "") -> Task:
    n_test = max(60, n // 3)
    total = n + n_test
    rot = np.linalg.qr(rng.standard_normal((dim, dim)))[0]
    y = rng.integers(0, classes, size=total)
    if family == "gauss":
        cents = rng.standard_normal((classes, dim)) * 2.0
        X = cents[y] + rng.standard_normal((total, dim)) * noise * 2
    elif family == "ring":
        r = 1.0 + y * 1.2 + rng.standard_normal(total) * noise
        theta = rng.uniform(0, 2 * np.pi, total)
        base = np.stack([r * np.cos(theta), r * np.sin(theta)], axis=1)
        pad = rng.standard_normal((total, dim - 2)) * noise
        X = np.concatenate([base, pad], axis=1)
    elif family == "sparse":
        X = rng.standard_normal((total, dim)) * noise
        for c in range(classes):
            mask = y == c
            X[mask, c % dim] += 2.5
            X[mask, (c * 2 + 1) % dim] -= 1.5
    else:  # stripe: class = quantized linear projection
        w = rng.standard_normal(dim)
        z = rng.standard_normal((total, dim))
        proj = z @ w
        edges = np.quantile(proj, np.linspace(0, 1, classes + 1)[1:-1])
        y = np.digitize(proj, edges)
        X = z + rng.standard_normal((total, dim)) * noise
    X = (X @ rot).astype(np.float32)
    return Task(name or f"{family}-{rng.integers(1e6)}", family,
                X[:n], y[:n], X[n:], y[n:],
                params={"dim": dim, "classes": classes, "noise": noise})


@dataclass
class ZooModel:
    """Frozen feature extractor with a family-typical inductive bias.

    mode 'linear' -> tanh(X W)          (gauss-style class-scatter dirs)
    mode 'radial' -> RBF to source centers (ring-style geometry)
    mode 'relu'   -> relu(X W)          (sparse-style axis features)
    mode 'proj1d' -> soft bins of 1-D projections (stripe-style)
    Inductive-bias match drives transfer — the zoo analogue of the paper's
    ResNet/YOLO/ALBERT variants suiting different data regimes.
    """
    name: str
    source_family: str
    W: np.ndarray
    mode: str = "linear"
    centers: Optional[np.ndarray] = None
    sigma: float = 1.0
    meta: Dict = field(default_factory=dict)

    def features(self, X: np.ndarray) -> np.ndarray:
        Xp = adapt_input_width(X, self.W.shape[0])
        if self.mode == "radial":
            d2 = ((Xp[:, None, :] - self.centers[None]) ** 2).sum(-1)
            return np.exp(-d2 / (2 * self.sigma ** 2))
        Z = Xp @ self.W
        if self.mode == "relu":
            return np.maximum(Z, 0.0)
        if self.mode == "proj1d":
            return np.tanh(np.concatenate([Z, Z ** 2 - 1.0], axis=1))
        return np.tanh(Z)


_FAMILY_MODE = {"gauss": "linear", "ring": "radial", "sparse": "relu",
                "stripe": "proj1d"}


def pretrain_model(task: Task, width: int = 32, noise: float = 0.3,
                   seed: int = 0, name: str = "",
                   mode: Optional[str] = None) -> ZooModel:
    """'Pretraining': encode the source task's class-scatter directions
    under the model's inductive bias; off-source directions are only
    weakly represented (narrow capacity -> genuine specialization)."""
    rng = np.random.default_rng(seed)
    X, y = task.X, task.y
    dim = X.shape[1]
    mode = mode or _FAMILY_MODE[task.family]
    classes = np.unique(y)
    cents = np.stack([X[y == c].mean(axis=0) for c in classes])
    if mode == "radial":
        # centers sampled from the source task (per class)
        per = max(2, width // max(len(classes), 1))
        cs = []
        for c in classes:
            pts = X[y == c]
            cs.append(pts[rng.choice(len(pts), size=min(per, len(pts)),
                                     replace=False)])
        centers = np.concatenate(cs)[:width]
        centers = centers + noise * rng.standard_normal(centers.shape)
        sigma = float(np.median(np.linalg.norm(X - X.mean(0), axis=1))) + 1e-3
        return ZooModel(name or f"zoo-{task.family}-{seed}", task.family,
                        np.eye(dim, dtype=np.float32), mode="radial",
                        centers=centers.astype(np.float32), sigma=sigma)
    scatter = (cents - cents.mean(0)).T @ (cents - cents.mean(0))
    scatter += 0.05 * np.cov(X.T)
    vals, vecs = np.linalg.eigh(scatter)
    top = vecs[:, ::-1][:, :min(width, dim)]
    fill = rng.standard_normal((dim, max(0, width - top.shape[1]))) \
        * (0.15 / np.sqrt(dim))                       # weak off-source dirs
    W = np.concatenate([top, fill], axis=1)
    W = W + noise * rng.standard_normal(W.shape) / np.sqrt(dim)
    return ZooModel(name or f"zoo-{task.family}-{seed}", task.family,
                    W.astype(np.float32), mode=mode)


def linear_probe_accuracy(model: ZooModel, task: Task,
                          l2: float = 1e-2) -> float:
    """Held-out accuracy of a least-squares probe on frozen features —
    the transfer score ground truth v_ij."""
    F = model.features(task.X)
    Ft = model.features(task.X_test)
    classes = np.unique(task.y)
    Y = (task.y[:, None] == classes[None, :]).astype(np.float32)
    Fb = np.concatenate([F, np.ones((F.shape[0], 1), np.float32)], axis=1)
    A = Fb.T @ Fb + l2 * np.eye(Fb.shape[1], dtype=np.float32)
    Wp = np.linalg.solve(A, Fb.T @ Y)
    Ftb = np.concatenate([Ft, np.ones((Ft.shape[0], 1), np.float32)], axis=1)
    pred = classes[np.argmax(Ftb @ Wp, axis=1)]
    return float((pred == task.y_test).mean())


def build_zoo(n_models: int = 24, seed: int = 0) -> List[ZooModel]:
    rng = np.random.default_rng(seed)
    zoo = []
    for i in range(n_models):
        fam = FAMILIES[i % len(FAMILIES)]
        src = make_task(rng, fam, noise=float(rng.uniform(0.2, 0.6)))
        # 1 in 4 models carries a mismatched inductive bias (zoo diversity)
        mode = None
        if rng.random() < 0.25:
            mode = _FAMILY_MODE[FAMILIES[int(rng.integers(len(FAMILIES)))]]
        width = int(rng.integers(8, 40))              # capacity spread
        zoo.append(pretrain_model(src, width=width,
                                  noise=float(rng.uniform(0.1, 0.5)),
                                  seed=int(rng.integers(1 << 31)),
                                  name=f"zoo{i:02d}-{fam}", mode=mode))
    return zoo


def build_tasks(n_tasks: int = 40, seed: int = 1) -> List[Task]:
    rng = np.random.default_rng(seed)
    return [make_task(rng, FAMILIES[i % len(FAMILIES)],
                      dim=16, classes=int(rng.integers(2, 5)),
                      noise=float(rng.uniform(0.2, 0.7)),
                      name=f"task{i:03d}")
            for i in range(n_tasks)]


def transfer_matrix(zoo: List[ZooModel],
                    tasks: List[Task]) -> np.ndarray:
    """V[i, j] = probe accuracy of model i on task j (paper's historical
    transfer matrix)."""
    V = np.zeros((len(zoo), len(tasks)), np.float32)
    for i, m in enumerate(zoo):
        for j, t in enumerate(tasks):
            V[i, j] = linear_probe_accuracy(m, t)
    return V
