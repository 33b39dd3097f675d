"""The decoder-only transformer of the port's dense and MoE families
(h2o-danube, olmoe): its weight layout, its float32 reference, its FLOP
and byte counts and its CPU smoke cut (the interface in
``perfbench/archs/__init__.py``). It imports nothing of the program.

The reference computes what the configuration states: RMSNorm with the
``(1 + w)`` scale, RoPE on the two halves of each head, causal attention
under the sliding window, GQA (query head h reads kv head h // (Hq / Hkv)),
optional per-head QK-norm, a SwiGLU MLP, or a top-k MoE whose k gates are
renormalised and whose experts keep the first ``cap_e`` copies routed to
them in token order (``cap_e`` from the capacity factor over the call's
tokens, at least 8, a multiple of 8), and logits over the real vocabulary.
Every layer is one ``[L, ...]`` stack of the same block.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.flops import (attention_pairs, decode_keys, head_dim,
                             padded_vocab)
from perfbench.reference import F32, full_f32, matmul_for, rmsnorm, rope
from perfbench.weights import Layout

SCORES = 1 << 28        # float32 attention scores a block holds
# the rehearsal's widths
SMOKE = {"d_model": 64, "num_heads": 4, "head_dim": 16, "d_ff": 128,
         "vocab_size": 512}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def layout(cfg: dict) -> Layout:
    """Leaf path -> (shape, std) of every weight."""
    L, d, hd = cfg["num_layers"], cfg["d_model"], head_dim(cfg)
    hq, hkv, V = cfg["num_heads"], cfg["num_kv_heads"], padded_vocab(cfg)
    out = {
        "embed/embedding": ((V, d), 0.02),
        "embed/unembed": ((d, V), 0.02),
        "final_norm": ((d,), 0.1),
        "layers/norm1": ((L, d), 0.1),
        "layers/norm2": ((L, d), 0.1),
        "layers/attn/wq": ((L, d, hq, hd), 1 / math.sqrt(d)),
        "layers/attn/wk": ((L, d, hkv, hd), 1 / math.sqrt(d)),
        "layers/attn/wv": ((L, d, hkv, hd), 1 / math.sqrt(d)),
        "layers/attn/wo": ((L, hq, hd, d), 1 / math.sqrt(hq * hd)),
    }
    if cfg.get("qk_norm"):
        out["layers/attn/q_norm"] = ((L, hd), 0.1)
        out["layers/attn/k_norm"] = ((L, hd), 0.1)
    moe = cfg.get("moe")
    if moe:
        E, f = moe["num_experts"], moe["d_ff_expert"]
        out["layers/moe/router"] = ((L, d, E), 0.02)
        out["layers/moe/wi"] = ((L, E, d, f), 1 / math.sqrt(d))
        out["layers/moe/wg"] = ((L, E, d, f), 1 / math.sqrt(d))
        out["layers/moe/wo"] = ((L, E, f, d), 1 / math.sqrt(f))
    else:
        f = cfg["d_ff"]
        out["layers/mlp/wi"] = ((L, d, f), 1 / math.sqrt(d))
        out["layers/mlp/wg"] = ((L, d, f), 1 / math.sqrt(d))
        out["layers/mlp/wo"] = ((L, f, d), 1 / math.sqrt(f))
    return out


# ---------------------------------------------------------------------------
# The float32 reference
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# FLOPs and bytes
# ---------------------------------------------------------------------------

def layer_matmul_params(cfg: dict) -> int:
    """Weights one token multiplies by in one layer (the active experts
    only, the router included)."""
    d, hd = cfg["d_model"], head_dim(cfg)
    attn = d * hd * (2 * cfg["num_heads"] + 2 * cfg["num_kv_heads"])
    moe = cfg.get("moe")
    if moe:
        mlp = 3 * d * moe["d_ff_expert"] * (moe["top_k"]
                                            + moe.get("num_shared_experts", 0))
        mlp += d * moe["num_experts"]
    else:
        mlp = 3 * d * cfg["d_ff"]
    return attn + mlp


def attention_flops(cfg: dict, pairs: int) -> float:
    """Score and value products of one layer over ``pairs`` (q, k) pairs:
    2 x 2 x head_dim operations a pair and query head."""
    return 4.0 * cfg["num_heads"] * head_dim(cfg) * pairs


def serve_call_flops(cfg: dict, rows: int, length: int,
                     gen_tokens: int) -> float:
    """Model FLOPs of one generate call: a prefill of ``rows`` x
    ``length`` tokens whose last position's logits are computed, then
    ``gen_tokens - 1`` decode steps of ``rows`` tokens, each with its
    logits; attention at each row's real length and window."""
    L, W = cfg["num_layers"], cfg.get("sliding_window")
    per_tok = 2.0 * L * layer_matmul_params(cfg)
    head = 2.0 * cfg["d_model"] * padded_vocab(cfg)
    f = rows * (length * per_tok + head
                + L * attention_flops(cfg, attention_pairs(length, W)))
    for j in range(gen_tokens - 1):
        keys = decode_keys(length + j, W)
        f += rows * (per_tok + head + L * attention_flops(cfg, keys))
    return f


def train_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step over ``rows`` x ``seq`` tokens:
    6 x the weights each token multiplies by (the unembedding included,
    the embedding lookup not) x tokens, plus attention's score and value
    products forward and backward (3 x the forward, PaLM appendix B) at
    the causal pairs. Remat's recompute is not model work."""
    L, W = cfg["num_layers"], cfg.get("sliding_window")
    n = L * layer_matmul_params(cfg) + cfg["d_model"] * padded_vocab(cfg)
    attn = 3.0 * L * attention_flops(cfg, attention_pairs(seq, W))
    return rows * (6.0 * n * seq + attn)


def flash_call(cfg: dict, rows: int, length: int, elem: int = 2):
    """(operations, bytes) of one ``flash_attention`` call of a causal
    prefill: q and o of every query head, k and v of every kv head, each
    read or written once."""
    hd = head_dim(cfg)
    ops = attention_flops(cfg, attention_pairs(
        length, cfg.get("sliding_window"))) * rows
    nbytes = elem * rows * length * hd * (2 * cfg["num_heads"]
                                          + 2 * cfg["num_kv_heads"])
    return ops, nbytes


def decode_call(cfg: dict, rows: int, index: int, elem: int = 2):
    """(operations, bytes) of one ``decode_attention`` call at position
    ``index``: q and o of each query head, and the keys and values it
    reaches, each read or written once."""
    hd = head_dim(cfg)
    keys = decode_keys(index, cfg.get("sliding_window"))
    ops = attention_flops(cfg, keys) * rows
    nbytes = elem * rows * hd * (2 * cfg["num_heads"]
                                 + 2 * cfg["num_kv_heads"] * keys)
    return ops, nbytes


# ---------------------------------------------------------------------------
# The rehearsal's cut
# ---------------------------------------------------------------------------

def smoke(cfg: dict) -> dict:
    """Two layers at ``SMOKE``'s widths, at most 2 kv heads, a window
    shorter than the rehearsal's longest prompt, 8 experts of 32 top-2."""
    out = dict(cfg, **SMOKE)
    out["num_layers"] = 2
    out["num_kv_heads"] = min(cfg["num_kv_heads"], 2)
    if out.get("sliding_window"):
        out["sliding_window"] = 48      # shorter than the longest prompt
    if out.get("moe"):
        out["moe"] = dict(out["moe"], num_experts=8, top_k=2,
                          d_ff_expert=32)
    return out
