"""The benchmark's own arithmetic: model FLOPs of a served call or a train
step, and the operations and bytes of one attention kernel call, all from
shapes. Nothing here reads the program.

``cfg`` is a configuration file's dict (``perfbench/configs/*.json``).
"""
from __future__ import annotations

from typing import Optional

from perfbench import peaks


def padded_vocab(cfg: dict) -> int:
    """The vocabulary rounded up to a multiple of 256, as the logits are
    computed."""
    return -(-cfg["vocab_size"] // 256) * 256


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["num_heads"]


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


def attention_pairs(length: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal prefill of ``length`` positions scores
    under an optional sliding window: sum over q of min(q + 1, window)."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def decode_keys(index: int, window: Optional[int]) -> int:
    """Keys a decode step at absolute position ``index`` attends to."""
    return index + 1 if window is None else min(index + 1, window)


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


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(flops / peaks.BF16_FLOPS_PER_S,
               nbytes / peaks.HBM_BYTES_PER_S)


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
