"""The plain reference: the LM of a configuration file in float32 PyTorch,
with no kernel, cache or batching of the program, and AdamW over it.
It imports nothing of the program; it reads the benchmark's weight tree
(``perfbench.weights``) and token ids, and makes its float32 copies
itself.

It computes what the configuration states: RMSNorm with the ``(1 + w)``
scale, RoPE on the two halves of each head, causal attention under the
sliding window, GQA (query head h reads kv head h // (Hq / Hkv)), optional
per-head QK-norm, a SwiGLU MLP, or a top-k MoE whose k gates are
renormalised and whose experts keep the first ``cap_e`` copies routed to
them in token order (``cap_e`` from the capacity factor over the call's
tokens, at least 8, a multiple of 8), and logits over the real vocabulary.
Params are stored in the configuration's ``param_dtype``: an AdamW update
is computed in float32 and the new param rounded to it, as the
configuration stores them.

``precision="fp8"`` is the control: every matrix product's two operands
are rounded to float8 e4m3 (one scale a tensor) first, the step below
bfloat16; in training the rounding passes the gradient straight through.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.flops import head_dim
from perfbench.weights import leaves

F32 = torch.float32
SCORES = 1 << 28        # float32 attention scores a block holds


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


def attention(q, k, v, window: Optional[int]):
    """Causal softmax attention, q [B, S, Hq, D], k / v [B, S, Hkv, D],
    in blocks of query rows."""
    B, S, Hq, D = q.shape
    Hkv = k.shape[2]
    qg = q.reshape(B, S, Hkv, Hq // Hkv, D) * D ** -0.5
    rows = max(1, SCORES // (B * Hq * S))
    pos = torch.arange(S, device=q.device)
    outs = []
    for lo in range(0, S, rows):
        hi = min(lo + rows, S)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, lo:hi], k[:, :hi])
        qp, kp = pos[lo:hi, None], pos[None, :hi]
        mask = kp <= qp
        if window is not None:
            mask = mask & (kp > qp - window)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        outs.append(torch.einsum("bkgqs,bskd->bqkgd", p, v[:, :hi]))
    return torch.cat(outs, dim=1).reshape(B, S, Hq, D)


def capacity(tokens_times_k: int, experts: int, factor: float) -> int:
    cap = math.ceil(tokens_times_k / experts * factor)
    return max(8, -(-cap // 8) * 8)


def moe(cfg: dict, p: dict, x, mm):
    """x [T, d] -> (y [T, d], load-balance aux)."""
    m = cfg["moe"]
    E, k = m["num_experts"], m["top_k"]
    T = x.shape[0]
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    gate, idx = torch.topk(probs, k, dim=-1)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    flat, fgate = idx.reshape(-1), gate.reshape(-1)
    cap = capacity(T * k, E, m["capacity_factor"])
    y = torch.zeros_like(x)
    for e in range(E):
        pos = torch.nonzero(flat == e).squeeze(1)[:cap]
        if pos.numel() == 0:
            continue
        tok = pos // k
        xe = x[tok]
        h = F.silu(mm(xe, p["wg"][e])) * mm(xe, p["wi"][e])
        y = y.index_add(0, tok, mm(h, p["wo"][e]) * fgate[pos, None])
    hard = torch.zeros_like(probs).scatter(1, idx, 1.0)
    aux = E * torch.sum(hard.mean(0) / k * probs.mean(0))
    return y, aux


def block(cfg: dict, p: dict, x, mm):
    """One layer on x [B, S, d] -> (x, aux)."""
    B, S, d = x.shape
    hd, eps = head_dim(cfg), cfg["norm_eps"]
    hq, hkv = cfg["num_heads"], cfg["num_kv_heads"]
    a = p["attn"]
    h = rmsnorm(x, p["norm1"], eps)
    q = mm(h, a["wq"].reshape(d, hq * hd)).reshape(B, S, hq, hd)
    k_ = mm(h, a["wk"].reshape(d, hkv * hd)).reshape(B, S, hkv, hd)
    v = mm(h, a["wv"].reshape(d, hkv * hd)).reshape(B, S, hkv, hd)
    if cfg.get("qk_norm"):
        q, k_ = rmsnorm(q, a["q_norm"], eps), rmsnorm(k_, a["k_norm"], eps)
    q, k_ = rope(q, cfg["rope_theta"]), rope(k_, cfg["rope_theta"])
    o = attention(q, k_, v, cfg.get("sliding_window"))
    x = x + mm(o.reshape(B, S, hq * hd), a["wo"].reshape(hq * hd, d))
    h = rmsnorm(x, p["norm2"], eps)
    if cfg.get("moe"):
        y, aux = moe(cfg, p["moe"], h.reshape(B * S, d), mm)
        return x + y.reshape(B, S, d), aux
    w = p["mlp"]
    y = mm(F.silu(mm(h, w["wg"])) * mm(h, w["wi"]), w["wo"])
    return x + y, torch.zeros((), dtype=F32, device=x.device)


def layer(tree: dict, i: int, cast: bool = True) -> dict:
    """Layer ``i``'s params from the stacked ``[L, ...]`` tree, float32."""
    return {k: layer(v, i, cast) if isinstance(v, dict)
            else (v[i].to(F32) if cast else v[i]) for k, v in tree.items()}


class Forward:
    """The reference's forward over fixed weights (no autograd)."""

    def __init__(self, cfg: dict, weights: dict, precision: str = "f32"):
        self.cfg, self.w, self.mm = cfg, weights, matmul_for(precision)

    @torch.no_grad()
    def logits(self, tokens: torch.Tensor, positions=None) -> torch.Tensor:
        """tokens [B, S] -> float32 logits [B, n, vocab] at ``positions``
        (default every position)."""
        cfg, w = self.cfg, self.w
        with full_f32():
            x = w["embed"]["embedding"][tokens].to(F32)
            for i in range(cfg["num_layers"]):
                x, _ = block(cfg, layer(w["layers"], i), x, self.mm)
            if positions is not None:
                x = x[:, positions]
            x = rmsnorm(x, w["final_norm"].to(F32), cfg["norm_eps"])
            out = self.mm(x, w["embed"]["unembed"].to(F32))
        return out[..., :cfg["vocab_size"]]


def loss(cfg: dict, w32: dict, tokens: torch.Tensor, mm):
    """Mean next-token cross entropy over ``tokens`` [B, S] plus the MoE
    load-balance term, each layer recomputed in the backward."""
    x = w32["embed"]["embedding"][tokens]
    aux = torch.zeros((), dtype=F32, device=x.device)
    for i in range(cfg["num_layers"]):
        x, a = checkpoint(lambda x, p: block(cfg, p, x, mm), x,
                          layer(w32["layers"], i, cast=False),
                          use_reentrant=False)
        aux = aux + a
    x = rmsnorm(x, w32["final_norm"], cfg["norm_eps"])
    logits = mm(x[:, :-1], w32["embed"]["unembed"])[..., :cfg["vocab_size"]]
    ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                         tokens[:, 1:].reshape(-1))
    if cfg.get("moe"):
        ce = ce + cfg["moe"]["router_aux_coef"] * aux / cfg["num_layers"]
    return ce


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
          accum: int, precision: str = "f32") -> dict:
    """AdamW steps over ``batches`` ([rows, S] token ids each, ``accum``
    equal micro-batches a step) from ``weights``: each step's loss, each
    leaf's norm of the first step's clipped gradient, and each leaf's norm
    of the params' change after the last step. ``weights`` is not
    modified."""
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
