"""The benchmark's own arithmetic that no architecture owns: attention's
causal pairs and decode keys, the head width and padded vocabulary of a
configuration, and a kernel call's least time from its operations and
bytes. Each architecture's FLOP and byte counts, built from these, live in
the file its configuration names (``perfbench/archs``). Nothing here reads
the program.

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


def attention_pairs(length: int, window: Optional[int]) -> int:
    """(query, key) pairs a causal prefill of ``length`` positions scores
    under an optional sliding window: sum over q of min(q + 1, window)."""
    if window is None or window >= length:
        return length * (length + 1) // 2
    return window * (window + 1) // 2 + (length - window) * window


def decode_keys(index: int, window: Optional[int]) -> int:
    """Keys a decode step at absolute position ``index`` attends to."""
    return index + 1 if window is None else min(index + 1, window)


def bound_seconds(flops: float, nbytes: float) -> float:
    """The least time the chip could take: the larger of operations over
    the bf16 peak and bytes over the HBM bandwidth."""
    return max(flops / peaks.BF16_FLOPS_PER_S,
               nbytes / peaks.HBM_BYTES_PER_S)
