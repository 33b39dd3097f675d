"""Weights made by the benchmark from ``--seed``, on the device, in the
dtype they are served in: one ``torch.randn`` call per leaf of a layout
(stacked ``[layers, ...]`` where the architecture stacks them), from one
``torch.Generator``. Both the program and the reference take this tree;
the layout is the architecture's (``perfbench/archs``), its keys and
shapes the program's parameter layout (a CPU test holds them to
``LM.abstract()``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}

# leaf path -> (shape, std): the leaf is drawn as std x N(0, 1)
Layout = Dict[str, Tuple[Tuple[int, ...], float]]


def make(cfg: dict, layout: Layout, seed: int, device) -> dict:
    """The nested weight tree of ``layout`` in ``cfg``'s ``param_dtype``,
    drawn from ``seed``."""
    dt = _DTYPES[cfg["param_dtype"]]
    gen = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    tree: dict = {}
    for path, (shape, std) in sorted(layout.items()):
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
