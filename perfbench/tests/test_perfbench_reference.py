"""The benchmark's plain reference (``perfbench/archs/transformer.py`` over
``perfbench.reference``) against the program on the CPU at a small
float32 size (the test loads both; the reference itself loads nothing of
the program), and each configuration's weight layout, through its own
architecture file, against the program's."""
import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, reference, weights  # noqa: E402
from perfbench.archs import transformer  # noqa: E402

SMALL = {"source": "test", "arch_id": "small", "num_layers": 3, "d_model": 32, "num_heads": 4,
         "num_kv_heads": 2, "head_dim": 8, "d_ff": 48, "vocab_size": 200,
         "activation": "swiglu", "norm": "rmsnorm", "norm_eps": 1e-5,
         "rope_theta": 10000.0, "dtype": "float32",
         "param_dtype": "float32", "remat_policy": "none"}
CONFIGS = {
    "dense-window": dict(SMALL, family="dense", sliding_window=5),
    # capacity 0.5: experts drop copies, so the capacity rule is held too
    "moe-drops": dict(SMALL, family="moe", qk_norm=True, moe={
        "num_experts": 4, "top_k": 2, "d_ff_expert": 16,
        "capacity_factor": 0.5, "impl": "batched",
        "router_aux_coef": 0.01}),
}
OPT = {"learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 2,
       "total_steps": 10, "min_lr_ratio": 0.1, "opt_dtype": "float32"}


def _program(cfg):
    from repro_torch.models import build_model
    return build_model(harness.model_config(cfg), attn_impl="naive")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_logits_match_the_program(name):
    cfg = CONFIGS[name]
    w = weights.make(cfg, transformer.layout(cfg), 3, "cpu")
    tokens = torch.randint(0, cfg["vocab_size"], (3, 12),
                           generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got, _ = _program(cfg).apply(w, tokens)
    want = transformer.Forward(cfg, w).logits(tokens)
    assert torch.allclose(got[..., :cfg["vocab_size"]], want, atol=2e-5)
    last = transformer.Forward(cfg, w).logits(tokens, torch.tensor([11]))
    assert torch.allclose(last, want[:, 11:], atol=1e-6)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_reference_train_steps_match_the_program(name):
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    cfg = CONFIGS[name]
    w = weights.make(cfg, transformer.layout(cfg), 4, "cpu")
    batches = [torch.randint(0, cfg["vocab_size"], (4, 10),
                             generator=torch.Generator().manual_seed(i))
               for i in range(2)]
    step = make_train_step(_program(cfg), OptimizerConfig(**OPT),
                           accum_steps=2)
    p, s, losses = w, init_state(w), []
    for i, b in enumerate(batches):
        p, s, out = step(p, s, {"tokens": b})
        losses.append(float(out["loss"]))
        if i == 0:
            g1 = {k: float(m.norm()) / (1 - OPT["beta1"])
                  for k, m in weights.leaves(s.m).items()}
    ref = reference.train(cfg, OPT, w, batches, accum=2,
                          loss=transformer.loss)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, v in ref["grad_norms"].items():
        assert g1[k] == pytest.approx(v, rel=1e-4, abs=1e-9), k
    p0 = weights.leaves(w)
    for k, q in weights.leaves(p).items():
        assert float((q - p0[k]).norm()) == pytest.approx(
            ref["change"][k], rel=1e-4, abs=1e-9), k


@pytest.mark.parametrize("conf", sorted(
    (ROOT / "perfbench" / "configs").glob("*.json")), ids=lambda p: p.stem)
def test_weight_layout_is_the_programs(conf):
    with open(conf) as f:
        cfg = json.load(f)
    want = weights.leaves(_program(cfg).abstract())
    got = harness.load_arch(conf.name, cfg).layout(cfg)
    assert sorted(got) == sorted(want)
    for k, (shape, _) in got.items():
        assert tuple(want[k].shape) == shape, k
