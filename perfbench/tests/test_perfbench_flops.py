"""The benchmark's FLOP and byte arithmetic against hand counts at a small
shape: the generic parts (``perfbench.flops``) and the transformer's
counts (``perfbench/archs/transformer.py``)."""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import flops, peaks  # noqa: E402
from perfbench.archs import transformer  # noqa: E402

CFG = {"num_layers": 2, "d_model": 8, "num_heads": 4, "num_kv_heads": 2,
       "head_dim": 2, "d_ff": 16, "vocab_size": 300, "sliding_window": 3}
MOE = dict(CFG, moe={"num_experts": 4, "top_k": 2, "d_ff_expert": 5})


def test_pairs_and_keys():
    # causal pairs of 5 positions under a window of 3: 1 + 2 + 3 + 3 + 3
    assert flops.attention_pairs(5, 3) == 12
    assert flops.attention_pairs(5, None) == 15
    assert flops.attention_pairs(2, 3) == 3
    assert flops.decode_keys(7, 3) == 3 and flops.decode_keys(1, None) == 2


def test_layer_params_dense_and_moe():
    # q, k, v, o: 8 * 2 * (4 + 2 + 2 + 4) = 192; mlp 3 * 8 * 16 = 384
    assert transformer.layer_matmul_params(CFG) == 192 + 384
    # 2 of 4 experts: 3 * 8 * 5 * 2 = 240, router 8 * 4 = 32
    assert transformer.layer_matmul_params(MOE) == 192 + 240 + 32
    assert flops.padded_vocab(CFG) == 512


def test_serve_call_flops_by_hand():
    rows, length = 3, 5
    per_tok = 2 * 2 * 576                   # 2 layers, 2 x weights
    head = 2 * 8 * 512
    attn = 2 * 4 * 4 * 2 * 12               # layers x 4 x heads x hd x pairs
    want = rows * (length * per_tok + head + attn)
    assert transformer.serve_call_flops(CFG, rows, length, 1) == want
    # two decode steps at positions 5 and 6: 3 keys each (the window)
    step = rows * (per_tok + head + 2 * 4 * 4 * 2 * 3)
    assert transformer.serve_call_flops(CFG, rows, length, 3) == \
        want + 2 * step


def test_train_step_flops_by_hand():
    n = 2 * 576 + 8 * 512
    attn = 3 * 2 * 4 * 4 * 2 * 12
    assert transformer.train_step_flops(CFG, 3, 5) == 3 * (6 * n * 5 + attn)


def test_kernel_calls_by_hand():
    ops, nbytes = transformer.flash_call(CFG, 3, 5)
    assert ops == 4 * 4 * 2 * 12 * 3
    assert nbytes == 2 * 3 * 5 * 2 * (2 * 4 + 2 * 2)
    ops, nbytes = transformer.decode_call(CFG, 3, 9)
    assert ops == 4 * 4 * 2 * 3 * 3
    assert nbytes == 2 * 3 * 2 * (2 * 4 + 2 * 2 * 3)
    assert flops.bound_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert flops.bound_seconds(1.0, peaks.HBM_BYTES_PER_S) == \
        pytest.approx(1.0)
