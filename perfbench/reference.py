"""The plain reference's generic parts: float32 PyTorch with no kernel,
cache or batching of the program, and AdamW over a configuration's loss.
It imports nothing of the program; it reads the benchmark's weight tree
(``perfbench.weights``) and token ids, and makes its float32 copies
itself. Each architecture's model (its block, ``loss`` and ``Forward``)
lives in the file its configuration names (``perfbench/archs``), built
from the pieces here.

RMSNorm has the ``(1 + w)`` scale; RoPE turns the two halves of each
head. Params are stored in the configuration's ``param_dtype``: an AdamW
update is computed in float32 and the new param rounded to it, as the
configuration stores them.

``precision="fp8"`` is the control: every matrix product's two operands
are rounded to float8 e4m3 (one scale a tensor) first, the step below
bfloat16; in training the rounding passes the gradient straight through.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List

import torch

from perfbench.weights import leaves

F32 = torch.float32


@contextlib.contextmanager
def full_f32():
    """float32 products in float32: TF32 off while the reference runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def _fp8(t: torch.Tensor) -> torch.Tensor:
    s = t.detach().abs().amax().clamp(min=1e-30) / 448.0
    r = (t.detach() / s).to(torch.float8_e4m3fn).to(t.dtype) * s
    return t + (r - t.detach())         # the gradient passes straight through


def matmul_for(precision: str) -> Callable:
    if precision == "f32":
        return torch.matmul
    if precision == "fp8":
        return lambda a, b: torch.matmul(_fp8(a), _fp8(b))
    raise ValueError(f"precision {precision!r}: f32 or fp8")


def rmsnorm(x, w, eps: float):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * (1.0 + w)


def rope(x, theta: float):
    """x [B, S, H, D], positions 0 .. S-1."""
    S, D = x.shape[1], x.shape[-1]
    freqs = 1.0 / theta ** (torch.arange(0, D, 2, dtype=F32,
                                         device=x.device) / D)
    ang = torch.arange(S, dtype=F32, device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def lr_at(o: dict, step: int) -> float:
    """Linear warm-up, then a cosine decay to ``min_lr_ratio``."""
    if step < o["warmup_steps"]:
        return o["learning_rate"] * step / max(o["warmup_steps"], 1)
    frac = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    r = o["min_lr_ratio"]
    return o["learning_rate"] * (r + (1 - r) * 0.5 * (1 + math.cos(
        math.pi * frac)))


def train(cfg: dict, opt: dict, weights: dict, batches: List[torch.Tensor],
          accum: int, precision: str = "f32", *, loss: Callable) -> dict:
    """AdamW steps on ``loss(cfg, w32, tokens, mm)`` (the architecture's,
    ``perfbench/archs``) over ``batches`` ([rows, S] token ids each,
    ``accum`` equal micro-batches a step) from ``weights``: each step's
    loss, each leaf's norm of the first step's clipped gradient, and each
    leaf's norm of the params' change after the last step. ``weights`` is
    not modified."""
    mm = matmul_for(precision)
    p = _tree_map(lambda t: t, weights)
    mom = _tree_map(lambda t: torch.zeros(t.shape, dtype=F32,
                                          device=t.device), weights)
    vel = _tree_map(lambda t: torch.zeros(t.shape, dtype=F32,
                                          device=t.device), weights)
    b1, b2 = opt["beta1"], opt["beta2"]
    losses, grad_norms = [], {}
    with full_f32():
        for step, tokens in enumerate(batches, start=1):
            w32 = _tree_map(
                lambda t: t.to(F32, copy=True).requires_grad_(True), p)
            names = list(leaves(w32))
            gsum, lsum = None, 0.0
            for mb in tokens.chunk(accum, dim=0):
                ls = loss(cfg, w32, mb, mm)
                g = torch.autograd.grad(ls, list(leaves(w32).values()))
                gsum = list(g) if gsum is None else [
                    a.add_(b) for a, b in zip(gsum, g)]
                lsum += float(ls.detach())
                del g, ls
            del w32
            grads = dict(zip(names, (a / accum for a in gsum)))
            del gsum
            losses.append(lsum / accum)
            gnorm = math.sqrt(sum(float((g * g).sum()) for g in
                                  grads.values()))
            scale = min(1.0, opt["grad_clip"] / max(gnorm, 1e-9))
            if step == 1:
                grad_norms = {n: float(g.norm()) * scale
                              for n, g in grads.items()}
            lr = lr_at(opt, step)
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            pl, ml, vl = leaves(p), leaves(mom), leaves(vel)
            for n in names:
                g = grads.pop(n) * scale
                ml[n].mul_(b1).add_(g, alpha=1 - b1)
                vl[n].mul_(b2).add_(g * g, alpha=1 - b2)
                delta = (ml[n] / bc1) / (torch.sqrt(vl[n] / bc2)
                                         + opt["eps"])
                old = pl[n]
                if old.ndim >= 2:
                    delta = delta + opt["weight_decay"] * old.to(F32)
                _set(p, n, (old.to(F32) - lr * delta).to(old.dtype))
    change = {n: float((t.to(F32) - weights_leaf.to(F32)).norm())
              for (n, t), weights_leaf in zip(leaves(p).items(),
                                              leaves(weights).values())}
    return {"losses": losses, "grad_norms": grad_norms, "change": change}


def _set(tree: dict, path: str, value) -> None:
    *parents, leaf = path.split("/")
    for k in parents:
        tree = tree[k]
    tree[leaf] = value
