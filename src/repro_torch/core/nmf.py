"""Non-negative matrix factorization (paper §4.2, Eq. 2), in PyTorch.

Port of ``src/repro/core/nmf.py``.

Decomposes the historical transfer-performance matrix V [M models x N
tasks] into W [M x k] (model embeddings) and H [N x k] (task embeddings)
with multiplicative updates minimizing ||V - W H^T||_F^2 s.t. W,H >= 0.

Supports masked factorization (missing entries in V — not every model was
evaluated on every historical task) by weighting the objective.

The reference runs the updates under ``jit`` + ``lax.scan``; here they are
a plain loop on the given device (the matrices are tens of rows, so the
loop is launch-bound wherever it runs). The reference seeds W and H from
``jax.random``, which torch cannot reproduce: the port draws them from a
``torch.Generator(seed)``, and ``init=(W0, H0)`` hands in a given start
(the parity tests pass the reference's draws).
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

_EPS = 1e-9


class NMFResult(NamedTuple):
    W: np.ndarray          # [M, k] model embeddings
    H: np.ndarray          # [N, k] task embeddings
    loss_curve: np.ndarray


def nmf(V, k: int, *, iters: int = 300, mask=None, seed: int = 0,
        init: Optional[Tuple[np.ndarray, np.ndarray]] = None,
        device: str = "cpu") -> NMFResult:
    """Multiplicative-update NMF. ``init=(W0, H0)`` replaces the seeded
    uniform(0.1, 1.0) * scale start."""
    dev = torch.device(device)
    Vt = torch.tensor(np.asarray(V, np.float32), device=dev)
    M, N = Vt.shape
    mk = (None if mask is None else
          torch.tensor(np.asarray(mask, np.float32), device=dev))
    if init is None:
        g = torch.Generator().manual_seed(int(seed))
        scale = float(np.sqrt(max(float(Vt.mean()), _EPS) / k))
        W = (torch.rand((M, k), generator=g) * 0.9 + 0.1).to(dev) * scale
        H = (torch.rand((N, k), generator=g) * 0.9 + 0.1).to(dev) * scale
    else:
        W = torch.tensor(np.asarray(init[0], np.float32), device=dev)
        H = torch.tensor(np.asarray(init[1], np.float32), device=dev)
        if W.shape != (M, k) or H.shape != (N, k):
            raise ValueError(f"init shapes {tuple(W.shape)}, "
                             f"{tuple(H.shape)} != ({M}, {k}), ({N}, {k})")
    Vm = Vt if mk is None else Vt * mk
    losses = torch.empty(iters, dtype=torch.float32, device=dev)
    for i in range(iters):
        WH = W @ H.T
        WHm = WH if mk is None else WH * mk
        # H <- H * (V^T W) / (WH^T W)
        H = H * (Vm.T @ W) / (WHm.T @ W + _EPS)
        WH = W @ H.T
        WHm = WH if mk is None else WH * mk
        W = W * (Vm @ H) / (WHm @ H + _EPS)
        resid = Vm - (W @ H.T if mk is None else (W @ H.T) * mk)
        losses[i] = torch.sum(resid * resid)
    return NMFResult(W.cpu().numpy(), H.cpu().numpy(), losses.cpu().numpy())


def reconstruction_error(V, W, H, mask=None) -> float:
    V, W, H = (np.asarray(a, np.float32) for a in (V, W, H))
    R = V - W @ H.T
    if mask is not None:
        mask = np.asarray(mask, np.float32)
        R = R * mask
        denom = max(float(np.sum(mask * V * V)), _EPS)
    else:
        denom = max(float(np.sum(V * V)), _EPS)
    return float(np.sum(R * R) / denom)
