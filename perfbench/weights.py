"""Weights made by the benchmark from ``--seed``, on the device, in the
dtype they are served in: one ``torch.randn`` call per stacked leaf
(``[layers, ...]``), from one ``torch.Generator``. Both the program and the
reference take this tree; its keys and shapes are the program's parameter
layout (a CPU test holds them to ``LM.abstract()``).
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

from perfbench.flops import head_dim, padded_vocab

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# (shape, scale) of each leaf; a scale of None is N(0, 1) / sqrt(fan-in),
# the fan-in being the given int
Layout = Dict[str, Tuple[Tuple[int, ...], float]]


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


def make(cfg: dict, seed: int, device) -> dict:
    """The nested weight tree for ``cfg`` drawn from ``seed``."""
    dt = _DTYPES[cfg["param_dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    tree: dict = {}
    for path, (shape, std) in sorted(layout(cfg).items()):
        t = torch.randn(shape, generator=gen, device=device, dtype=dt)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t.mul_(std)
    return tree


def leaves(tree, prefix: str = "") -> Dict[str, torch.Tensor]:
    """Path -> tensor of every leaf, paths sorted."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(leaves(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix.rstrip("/"): tree}
