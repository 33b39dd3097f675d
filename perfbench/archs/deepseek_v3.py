"""DeepSeek-V3's decoder (Moonlight-16B-A3B): latent attention, a leading
dense layer, then MoE layers with sigmoid routing, a selection bias,
routed scaling and shared experts; one card's share of an expert- and
vocabulary-parallel deployment. Its weight layout, its float32 reference,
its FLOP and byte counts and its CPU smoke cut (the interface in
``perfbench/archs/__init__.py``). It imports nothing of the program; the
blocked attention, the capacity rule, RMSNorm and RoPE are
``transformer.py``'s and ``perfbench.reference``'s.

The reference computes, per the published description (DeepSeek-V3's
modeling code as Moonlight's config sets it: no q LoRA, ``n_group`` =
``topk_group`` = 1, ``norm_topk_prob``):

- latent attention: ``q = h W_q`` (per head 128 plain + 64 rotated
  columns), ``[c, k_r] = h W_kv_a``, ``c`` RMS-normed, ``[k_nope, v] = c
  W_kv_b`` per head, ``k = [k_nope, rope(k_r)]`` with one rotated key for
  all heads, causal softmax at ``192 ** -0.5``, ``o W_o``;
- MoE: sigmoid scores of the router over all ``num_experts *
  expert_shards`` experts, the top-k of scores + the selection bias, the
  gates the chosen scores (unbiased) renormalised and times
  ``routed_scaling``; the card's held experts (the first ``num_experts``)
  each keep the first ``cap_e`` copies routed to them in token order
  (``cap_e`` over every expert of the layer), and the shared SwiGLU of
  ``num_shared_experts * d_ff_expert`` runs on every token;
- layer 0's MLP is a dense SwiGLU of ``d_ff``; logits over the card's
  vocabulary slice.

Departures, each stated in the configuration's ``assumed``: what the other
cards' experts would add is left out (the cut); capacity drops where the
published model drops nothing; the selection bias is fixed; no
sequence-wise balance loss; RoPE on halves rather than de-interleaved
pairs; norm weights as ``(1 + w)``. The blocked attention takes one head
width for q, k and v, so the values go in zero-padded to q's width and the
output is cut back, which changes no number.

Memory: the check's AdamW over float32 copies of 2.78 B parameters holds
61-67 GiB before a micro-batch's activations (``perfbench.reference``: the
float32 weights, two gradient trees, two moments, and from the third
step three bf16 copies of the params). So the card has room for little
else, and :func:`loss` spends it sparingly, in ways that change no
number: each stacked leaf is cut into its layers once (``torch.unbind``),
so a leaf's gradient is stacked once at the end of the backward rather
than built as a full-size tensor for every layer's slice; the attention
runs one head at a time, each head recomputed in the backward; and the
caching allocator's expandable segments are turned on at its first CUDA
call (fixed segments left 6-8 GiB reserved but unusable). All of it runs
only in the check, after the program's window.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.archs.transformer import attention, capacity, layer
from perfbench.flops import attention_pairs, decode_keys, padded_vocab
from perfbench.reference import F32, full_f32, matmul_for, rmsnorm, rope
from perfbench.weights import Layout

# the rehearsal's widths: 3 layers (one dense), 2 of 8 experts held
SMOKE = {"num_layers": 3, "d_model": 64, "num_heads": 4, "num_kv_heads": 4,
         "d_ff": 96, "vocab_size": 512,
         "mla": {"kv_lora_rank": 32, "qk_nope_head_dim": 16,
                 "qk_rope_head_dim": 8, "v_head_dim": 16}}


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

def _stack(prefix: str, n: int, cfg: dict, moe: bool) -> Layout:
    d, H, a = cfg["d_model"], cfg["num_heads"], cfg["mla"]
    qk = a["qk_nope_head_dim"] + a["qk_rope_head_dim"]
    r, dv = a["kv_lora_rank"], a["v_head_dim"]
    out = {
        f"{prefix}/norm1": ((n, d), 0.1),
        f"{prefix}/norm2": ((n, d), 0.1),
        f"{prefix}/attn/wq": ((n, d, H, qk), 1 / math.sqrt(d)),
        f"{prefix}/attn/wkv_a": ((n, d, r + a["qk_rope_head_dim"]),
                                 1 / math.sqrt(d)),
        f"{prefix}/attn/kv_norm": ((n, r), 0.1),
        f"{prefix}/attn/wkv_b": ((n, r, H, a["qk_nope_head_dim"] + dv),
                                 1 / math.sqrt(r)),
        f"{prefix}/attn/wo": ((n, H, dv, d), 1 / math.sqrt(H * dv)),
    }
    if not moe:
        f = cfg["d_ff"]
        out[f"{prefix}/mlp/wi"] = ((n, d, f), 1 / math.sqrt(d))
        out[f"{prefix}/mlp/wg"] = ((n, d, f), 1 / math.sqrt(d))
        out[f"{prefix}/mlp/wo"] = ((n, f, d), 1 / math.sqrt(f))
        return out
    m = cfg["moe"]
    E, f = m["num_experts"], m["d_ff_expert"]
    fs = m["num_shared_experts"] * f
    out.update({
        f"{prefix}/moe/router": ((n, d, routed(cfg)), 0.02),
        f"{prefix}/moe/wi": ((n, E, d, f), 1 / math.sqrt(d)),
        f"{prefix}/moe/wg": ((n, E, d, f), 1 / math.sqrt(d)),
        f"{prefix}/moe/wo": ((n, E, f, d), 1 / math.sqrt(f)),
        f"{prefix}/moe/shared/wi": ((n, d, fs), 1 / math.sqrt(d)),
        f"{prefix}/moe/shared/wg": ((n, d, fs), 1 / math.sqrt(d)),
        f"{prefix}/moe/shared/wo": ((n, fs, d), 1 / math.sqrt(fs)),
    })
    return out


def layout(cfg: dict) -> Layout:
    """Leaf path -> (shape, std) of every weight: the dense layers under
    ``dense_layers``, the MoE layers under ``layers``."""
    d, V = cfg["d_model"], padded_vocab(cfg)
    n = cfg["first_dense_layers"]
    out = {
        "embed/embedding": ((V, d), 0.02),
        "embed/unembed": ((d, V), 0.02),
        "final_norm": ((d,), 0.1),
    }
    out.update(_stack("dense_layers", n, cfg, moe=False))
    out.update(_stack("layers", cfg["num_layers"] - n, cfg, moe=True))
    return out


def routed(cfg: dict) -> int:
    """Experts the router scores: every card's."""
    m = cfg["moe"]
    return m["num_experts"] * m.get("expert_shards", 1)


# ---------------------------------------------------------------------------
# The float32 reference
# ---------------------------------------------------------------------------

def latent_attention(cfg: dict, a: dict, h, mm):
    """h [B, S, d] -> [B, S, d]."""
    B, S, d = h.shape
    H, m, eps = cfg["num_heads"], cfg["mla"], cfg["norm_eps"]
    nope, rp = m["qk_nope_head_dim"], m["qk_rope_head_dim"]
    r, dv = m["kv_lora_rank"], m["v_head_dim"]
    q = mm(h, a["wq"].reshape(d, H * (nope + rp))).reshape(B, S, H,
                                                           nope + rp)
    ckr = mm(h, a["wkv_a"])
    c = rmsnorm(ckr[..., :r], a["kv_norm"], eps)
    kv = mm(c, a["wkv_b"].reshape(r, H * (nope + dv))).reshape(B, S, H,
                                                               nope + dv)
    theta = cfg["rope_theta"]
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    k_r = rope(ckr[..., r:][:, :, None], theta).expand(B, S, H, rp)
    k = torch.cat([kv[..., :nope], k_r], dim=-1)
    v = F.pad(kv[..., nope:], (0, nope + rp - dv))
    window = cfg.get("sliding_window")
    o = torch.cat([checkpoint(attention, q[:, :, h:h + 1], k[:, :, h:h + 1],
                              v[:, :, h:h + 1], window, use_reentrant=False)
                   for h in range(H)], dim=2)[..., :dv]
    return mm(o.reshape(B, S, H * dv), a["wo"].reshape(H * dv, d))


def swiglu(w: dict, x, mm):
    return mm(F.silu(mm(x, w["wg"])) * mm(x, w["wi"]), w["wo"])


def route(cfg: dict, router, x, mm):
    """x [T, d] -> (gates [T, k], expert ids [T, k]) over every card's
    experts: sigmoid scores, the top-k of scores + the selection bias, the
    unbiased scores renormalised and scaled."""
    m = cfg["moe"]
    scores = torch.sigmoid(mm(x, router))
    choice = scores
    if m.get("selection_bias"):
        choice = scores + torch.tensor(m["selection_bias"], dtype=F32,
                                       device=x.device)
    idx = torch.topk(choice, m["top_k"], dim=-1).indices
    gate = scores.gather(1, idx)
    gate = gate / gate.sum(-1, keepdim=True).clamp(min=1e-9)
    return gate * m.get("routed_scaling", 1.0), idx


def moe(cfg: dict, p: dict, x, mm, first: int = 0):
    """x [T, d] -> y [T, d]: the routed part that experts ``first`` ..
    ``first + num_experts`` (``p``'s, in that order) give, plus the shared
    expert."""
    m = cfg["moe"]
    T, k = x.shape[0], m["top_k"]
    gate, idx = route(cfg, p["router"], x, mm)
    flat, fgate = idx.reshape(-1), gate.reshape(-1)
    cap = capacity(T * k, routed(cfg), m["capacity_factor"])
    y = swiglu(p["shared"], x, mm) if "shared" in p else torch.zeros_like(x)
    for e in range(m["num_experts"]):
        pos = torch.nonzero(flat == first + e).squeeze(1)[:cap]
        if pos.numel() == 0:
            continue
        tok = pos // k
        ye = swiglu({n: p[n][e] for n in ("wi", "wg", "wo")}, x[tok], mm)
        y = y.index_add(0, tok, ye * fgate[pos, None])
    return y


def block(cfg: dict, p: dict, x, mm):
    """One layer (dense MLP or MoE, by its params) on x [B, S, d]."""
    B, S, d = x.shape
    eps = cfg["norm_eps"]
    x = x + latent_attention(cfg, p["attn"], rmsnorm(x, p["norm1"], eps), mm)
    h = rmsnorm(x, p["norm2"], eps)
    if "moe" in p:
        return x + moe(cfg, p["moe"], h.reshape(B * S, d), mm).reshape(B, S,
                                                                      d)
    return x + swiglu(p["mlp"], h, mm)


def _layers(cfg: dict, w: dict):
    """Each layer's float32 params, in order."""
    n = cfg["first_dense_layers"]
    return ([layer(w["dense_layers"], i) for i in range(n)]
            + [layer(w["layers"], i) for i in range(cfg["num_layers"] - n)])


def _unbound(cfg: dict, w: dict):
    """Each layer's params, in order, as the pieces of one ``unbind`` of
    every stacked leaf (see the module docstring)."""
    def cut(tree):
        return {k: cut(v) if isinstance(v, dict) else torch.unbind(v)
                for k, v in tree.items()}

    def pick(tree, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in tree.items()}

    n = cfg["first_dense_layers"]
    dense, moe_ = cut(w["dense_layers"]), cut(w["layers"])
    return ([pick(dense, i) for i in range(n)]
            + [pick(moe_, i) for i in range(cfg["num_layers"] - n)])


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
            for p in _layers(cfg, w):
                x = block(cfg, p, x, self.mm)
            if positions is not None:
                x = x[:, positions]
            x = rmsnorm(x, w["final_norm"].to(F32), cfg["norm_eps"])
            out = self.mm(x, w["embed"]["unembed"].to(F32))
        return out[..., :cfg["vocab_size"]]


def _expandable_segments() -> None:
    """The CUDA caching allocator's expandable segments, from here on
    (see the module docstring)."""
    global _EXPANDABLE
    if not _EXPANDABLE:
        torch.cuda.memory._set_allocator_settings("expandable_segments:True")
        _EXPANDABLE = True


_EXPANDABLE = False


def loss(cfg: dict, w32: dict, tokens: torch.Tensor, mm):
    """Mean next-token cross entropy over ``tokens`` [B, S] (no balance
    loss: ``router_aux_coef`` is 0), each layer recomputed in the
    backward."""
    if cfg["moe"].get("router_aux_coef"):
        raise NotImplementedError("a sequence-wise balance loss")
    if tokens.is_cuda:
        _expandable_segments()
    x = w32["embed"]["embedding"][tokens]
    for p in _unbound(cfg, w32):
        x = checkpoint(lambda x, p: block(cfg, p, x, mm), x, p,
                       use_reentrant=False)
    x = rmsnorm(x, w32["final_norm"], cfg["norm_eps"])
    logits = mm(x[:, :-1], w32["embed"]["unembed"])[..., :cfg["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           tokens[:, 1:].reshape(-1))


# ---------------------------------------------------------------------------
# FLOPs and bytes
# ---------------------------------------------------------------------------

def _widths(cfg: dict):
    m = cfg["mla"]
    return m["qk_nope_head_dim"] + m["qk_rope_head_dim"], m["v_head_dim"]


def attention_matmul_params(cfg: dict) -> int:
    """Weights of one latent attention a token multiplies by: q, the
    latent down-projection, the per-head up-projection, the output."""
    d, H, m = cfg["d_model"], cfg["num_heads"], cfg["mla"]
    qk, dv = _widths(cfg)
    r = m["kv_lora_rank"]
    return (d * H * qk + d * (r + m["qk_rope_head_dim"])
            + r * H * (m["qk_nope_head_dim"] + dv) + H * dv * d)


def layer_matmul_params(cfg: dict, dense: bool) -> float:
    """Weights one token multiplies by in one layer: the dense MLP, or the
    router, the shared expert and the held experts at their expected
    ``top_k * num_experts / routed`` copies a token."""
    d = cfg["d_model"]
    n = attention_matmul_params(cfg)
    if dense:
        return n + 3 * d * cfg["d_ff"]
    m = cfg["moe"]
    f = m["d_ff_expert"]
    held = m["top_k"] * m["num_experts"] / routed(cfg)
    return (n + d * routed(cfg) + 3 * d * f * m["num_shared_experts"]
            + 3 * d * f * held)


def matmul_params(cfg: dict) -> float:
    """Every layer's, and the unembedding (not the embedding lookup)."""
    n = cfg["first_dense_layers"]
    return (n * layer_matmul_params(cfg, True)
            + (cfg["num_layers"] - n) * layer_matmul_params(cfg, False)
            + cfg["d_model"] * padded_vocab(cfg))


def attention_flops(cfg: dict, pairs: int) -> float:
    """Score and value products of one layer over ``pairs`` (q, k) pairs:
    2 x (q.k width + value width) operations a pair and head."""
    qk, dv = _widths(cfg)
    return 2.0 * cfg["num_heads"] * (qk + dv) * pairs


def train_step_flops(cfg: dict, rows: int, seq: int) -> float:
    """Model FLOPs of one train step over ``rows`` x ``seq`` tokens: 6 x
    the weights each token multiplies by x tokens, plus attention's
    products forward and backward (3 x the forward) at the causal pairs.
    Remat's recompute is not model work."""
    attn = 3.0 * cfg["num_layers"] * attention_flops(
        cfg, attention_pairs(seq, cfg.get("sliding_window")))
    return rows * (6.0 * matmul_params(cfg) * seq + attn)


def serve_call_flops(cfg: dict, rows: int, length: int,
                     gen_tokens: int) -> float:
    """Model FLOPs of one generate call: a prefill of ``rows`` x
    ``length`` whose last position's logits are computed, then
    ``gen_tokens - 1`` decode steps (the program does not serve this
    model yet; the count is the interface's)."""
    L, W = cfg["num_layers"], cfg.get("sliding_window")
    per_tok = 2.0 * (matmul_params(cfg) - cfg["d_model"] * padded_vocab(cfg))
    head = 2.0 * cfg["d_model"] * padded_vocab(cfg)
    f = rows * (length * per_tok + head
                + L * attention_flops(cfg, attention_pairs(length, W)))
    for j in range(gen_tokens - 1):
        keys = decode_keys(length + j, W)
        f += rows * (per_tok + head + L * attention_flops(cfg, keys))
    return f


def flash_call(cfg: dict, rows: int, length: int, elem: int = 2):
    """(operations, bytes) of one causal ``flash_attention`` call: q and k
    of every head at the q.k width, v and o at the value width, each read
    or written once."""
    qk, dv = _widths(cfg)
    ops = attention_flops(cfg, attention_pairs(
        length, cfg.get("sliding_window"))) * rows
    nbytes = elem * rows * length * cfg["num_heads"] * (2 * qk + 2 * dv)
    return ops, nbytes


def flash_backward_call(cfg: dict, rows: int, length: int, elem: int = 2):
    """(operations, bytes) of one backward of that call: the five products
    (S = q k^T and dK = dS^T q and dQ = dS k at the q.k width; dP = dO v^T
    and dV = P^T dO at the value width), 2 operations a multiply-add, at
    the causal pairs; q, k, v, o and dO read and dq, dk, dv written once."""
    qk, dv = _widths(cfg)
    pairs = attention_pairs(length, cfg.get("sliding_window"))
    ops = 2.0 * cfg["num_heads"] * (3 * qk + 2 * dv) * pairs * rows
    nbytes = elem * rows * length * cfg["num_heads"] * (4 * qk + 4 * dv)
    return ops, nbytes


# ---------------------------------------------------------------------------
# The rehearsal's cut
# ---------------------------------------------------------------------------

def smoke(cfg: dict) -> dict:
    """``SMOKE``'s widths: one dense and two MoE layers, 2 experts held of
    8 routed (the bias's first 8), top-3, the shared expert kept."""
    out = dict(cfg, **SMOKE)
    m = cfg["moe"]
    out["moe"] = dict(m, num_experts=2, expert_shards=4, top_k=3,
                      d_ff_expert=32,
                      selection_bias=m["selection_bias"][:8])
    return out
