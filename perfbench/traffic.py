"""The one traffic generator: reads a mix from ``perfbench/traffic/*.json``
and makes each call's token ids from ``--seed``.

A serving mix lists ``block``: ``[length, calls]`` pairs, one block of
calls repeated. The calls of a block are spread evenly (each length at
even intervals through the block), in the same order for every seed: in
a closed loop the window ends inside a block, and a seed-drawn order made
the work of that last part, and so rows a second, swing by 7% from seed
to seed (danube-score). Only the ids change with the seed.
"""
from __future__ import annotations

from typing import List

import numpy as np


def rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([seed % (1 << 63), *stream])


def spread_block(block) -> List[int]:
    """The block's lengths, each length's calls at even intervals: the
    call at fraction (i + 0.5) / n of the block for i < n calls."""
    slots = [((i + 0.5) / n, k, length)
             for k, (length, n) in enumerate(block) for i in range(n)]
    return [length for _, _, length in sorted(slots)]


class ServeTraffic:
    """Call ``i``'s prompt length and its ``[slots, length]`` token ids."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed
        self.base = spread_block(mix["block"])
        self.slots = mix["slots"]
        self.gen_tokens = mix["gen_tokens"]

    def length(self, i: int) -> int:
        return self.base[i % len(self.base)]

    def prompts(self, i: int) -> np.ndarray:
        return rng(self.seed, 1, i).integers(
            0, self.vocab, (self.slots, self.length(i)), dtype=np.int64)

    def lengths(self) -> List[int]:
        """Every distinct length, ascending (what set-up warms)."""
        return sorted({length for length, _ in self.mix["block"]})


class TrainTraffic:
    """Step ``i``'s ``[global_batch, seq_len]`` token ids: new rows every
    step, uniform over the vocabulary."""

    def __init__(self, mix: dict, vocab: int, seed: int):
        self.mix, self.vocab, self.seed = mix, vocab, seed

    def tokens(self, i: int) -> np.ndarray:
        return rng(self.seed, 2, i).integers(
            0, self.vocab, (self.mix["global_batch"], self.mix["seq_len"]),
            dtype=np.int64)
