"""The traffic generator: fixed by its seed, every block holding the mix's
stated counts, new rows every train step."""
import json
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import traffic  # noqa: E402

MIXES = sorted((ROOT / "perfbench" / "traffic").glob("*.json"))
SEEDS = [0, 7, 2 ** 31 + 17, 2 ** 33 + 5]


def _mix(path):
    with open(path) as f:
        return json.load(f)


@pytest.mark.parametrize("path", [p for p in MIXES
                                  if _mix(p)["kind"] == "serve"],
                         ids=lambda p: p.stem)
@pytest.mark.parametrize("seed", SEEDS)
def test_serve_blocks_hold_the_stated_counts(path, seed):
    mix = _mix(path)
    t = traffic.ServeTraffic(mix, 1000, seed)
    n = sum(k for _, k in mix["block"])
    want = Counter({length: k for length, k in mix["block"]})
    for block in range(4):
        got = Counter(t.length(block * n + i) for i in range(n))
        assert got == want
    assert t.lengths() == sorted(want)


@pytest.mark.parametrize("path", MIXES, ids=lambda p: p.stem)
def test_traffic_is_fixed_by_its_seed(path):
    mix = _mix(path)
    if mix["kind"] == "serve":
        a, b = (traffic.ServeTraffic(mix, 1000, 2 ** 31 + 3)
                for _ in range(2))
        c = traffic.ServeTraffic(mix, 1000, 2 ** 31 + 4)
        assert [a.length(i) for i in range(60)] == \
            [b.length(i) for i in range(60)]
        pa, pc = a.prompts(5), c.prompts(5)
        assert np.array_equal(pa, b.prompts(5))
        assert not np.array_equal(pa[:, :8], pc[:, :8])
        assert pa.shape == (mix["slots"], a.length(5))
        assert pa.min() >= 0 and pa.max() < 1000
    else:
        a, b = (traffic.TrainTraffic(mix, 1000, 2 ** 31 + 3)
                for _ in range(2))
        assert np.array_equal(a.tokens(2), b.tokens(2))
        assert not np.array_equal(a.tokens(2), a.tokens(3))
        assert a.tokens(0).shape == (mix["global_batch"], mix["seq_len"])


def test_spread_block_spaces_each_length_evenly():
    order = traffic.spread_block([[1, 4], [2, 2], [3, 1]])
    assert Counter(order) == Counter({1: 4, 2: 2, 3: 1})
    ones = [i for i, x in enumerate(order) if x == 1]
    assert max(np.diff(ones)) <= 2
