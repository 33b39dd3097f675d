"""The program's Moonlight path (latent attention, sigmoid routing with a
selection bias and routed scaling, shared experts, a card's share of the
experts, the dense first layer) against the plain float32 reference of
``perfbench/archs/deepseek_v3.py`` on the CPU, at a small size on seeded
random weights, the program on its plain kernel versions; the share test
ties a card's share to the uncut layer; the rehearsal of
``moonlight-train-8k`` fails under planted faults.

Tolerances: 2e-5 on outputs and 1e-4 relative on gradients (float32
products summed in another order: the program's flash / chunked attention
against the reference's blocked one, its batched expert products against
a loop over experts)."""
import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from perfbench import harness, reference, weights  # noqa: E402
from perfbench.archs import deepseek_v3 as ds  # noqa: E402

CONF = json.loads((ROOT / "perfbench/configs/moonlight-16b-a3b.json")
                  .read_text())
SMALL = dict(ds.smoke(CONF), dtype="float32", param_dtype="float32",
             remat_policy="none")
OPT = {"learning_rate": 1e-2, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
       "weight_decay": 0.1, "grad_clip": 1.0, "warmup_steps": 2,
       "total_steps": 10, "min_lr_ratio": 0.1, "opt_dtype": "float32"}
MM = torch.matmul


def _cfg(**moe):
    return dict(SMALL, moe=dict(SMALL["moe"], **moe))


def _weights(cfg, seed=3):
    return weights.make(cfg, ds.layout(cfg), seed, "cpu")


def _x(shape, seed):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed))


def _program(cfg, attn_impl="chunked"):
    from repro_torch.models import build_model
    return build_model(harness.model_config(cfg), attn_impl=attn_impl)


def _close(got, want, tol):
    got, want = got.detach(), want.detach()
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.parametrize("impl, use_kernels, S", [
    ("chunked", True, 70), ("naive", False, 70), ("chunked", False, 1024)])
def test_latent_attention_output_and_grads(impl, use_kernels, S):
    """The kernel route (``flash_attention``'s plain version with values
    narrower than q.k) and both plain implementations (the chunked one in
    chunks at 1024 positions)."""
    from repro_torch.models import mla
    cfg = SMALL
    mcfg = harness.model_config(cfg)
    a = {k: v[0].clone().requires_grad_() for k, v in
         _weights(cfg)["layers"]["attn"].items()}
    h = _x((2, S, cfg["d_model"]), 1).requires_grad_()
    pos = torch.arange(S)[None].expand(2, S)
    got = mla.mla_apply(mcfg, a, h, positions=pos, impl=impl,
                        use_kernels=use_kernels)
    want = ds.latent_attention(cfg, a, h, MM)
    _close(got, want, 2e-5)
    dy = _x(got.shape, 2)
    leaves = [h] + list(a.values())
    for g, w in zip(torch.autograd.grad(got, leaves, dy),
                    torch.autograd.grad(want, leaves, dy)):
        _close(g, w, 1e-4)


def test_sigmoid_routing_takes_the_bias_for_the_choice_only():
    """The choice is the top-k of scores + bias, and the bias flips some
    tokens' choices; the gates are the chosen unbiased scores, normalised
    and scaled, equal to the reference's."""
    from repro_torch.models import moe
    cfg = _cfg(selection_bias=[0.3 * (-1) ** i for i in range(8)])
    mcfg = harness.model_config(cfg)
    router = _weights(cfg)["layers"]["moe"]["router"][0]
    x = _x((64, cfg["d_model"]), 4)
    _, gate, idx, _ = moe._route(mcfg, router, x)
    want_gate, want_idx = ds.route(cfg, router, x, MM)
    assert torch.equal(idx, want_idx)
    _close(gate, want_gate, 1e-6)
    scores = torch.sigmoid(x @ router)
    unbiased = torch.topk(scores, 3).indices
    assert not torch.equal(idx.sort(-1).values, unbiased.sort(-1).values)
    chosen = scores.gather(1, idx)
    _close(gate, chosen / chosen.sum(-1, keepdim=True) * 2.446, 1e-6)


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_share_matches_the_reference(capacity_factor):
    """The held experts' part (capacity over every card's experts, so 0.5
    drops copies) plus the shared expert."""
    from repro_torch.models import moe
    cfg = _cfg(capacity_factor=capacity_factor)
    p = {k: v[1] for k, v in _weights(cfg)["layers"]["moe"].items()
         if k != "shared"}
    p["shared"] = {k: v[1] for k, v in
                   _weights(cfg)["layers"]["moe"]["shared"].items()}
    x = _x((3, 40, cfg["d_model"]), 5)
    got, _ = moe.moe_apply(harness.model_config(cfg), p, x)
    want = ds.moe(cfg, p, x.reshape(-1, cfg["d_model"]), MM)
    _close(got.reshape(want.shape), want, 2e-5)


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards of 2 experts each: their routed parts, each computed by
    the program's batched layer at its rank, plus the shared expert once,
    are the reference's layer over all 8 experts on one card (capacity
    that drops nothing)."""
    from repro_torch.models import moe
    share = _cfg(capacity_factor=8.0)
    whole = _cfg(capacity_factor=8.0, num_experts=8, expert_shards=1)
    pw = {k: v[0] for k, v in _weights(whole)["layers"]["moe"].items()
          if k != "shared"}
    pw["shared"] = {k: v[0] for k, v in
                    _weights(whole)["layers"]["moe"]["shared"].items()}
    x = _x((96, share["d_model"]), 6)
    want = ds.moe(whole, pw, x, MM)
    mcfg = harness.model_config(share)
    _, gate, idx, _ = moe._route(mcfg, pw["router"], x)
    parts = [moe._batched(mcfg, x, gate, idx,
                          *(pw[n][2 * r:2 * r + 2] for n in ("wi", "wg",
                                                             "wo")),
                          ep=4, rank=r) for r in range(4)]
    got = sum(parts) + ds.swiglu(pw["shared"], x, MM)
    _close(got, want, 2e-5)
    # the card's own layer is share 0 with the shared expert
    p0 = dict(pw, **{n: pw[n][:2] for n in ("wi", "wg", "wo")})
    mine, _ = moe.moe_apply(mcfg, p0, x[None])
    _close(mine[0], parts[0] + ds.swiglu(pw["shared"], x, MM), 2e-5)


@pytest.mark.parametrize("dense", [1, 2])
def test_the_loss_and_every_gradient_match(dense):
    """The whole model (``dense`` leading dense layers, then MoE layers):
    its loss and the gradient of every leaf."""
    cfg = dict(SMALL, first_dense_layers=dense, num_layers=dense + 2)
    w = _weights(cfg, 7)
    tokens = torch.randint(0, cfg["vocab_size"], (2, 48),
                           generator=torch.Generator().manual_seed(8))
    model = _program(cfg)
    tracked = {k: v for k, v in weights.leaves(w).items()}
    leaves = [t.clone().requires_grad_() for t in tracked.values()]
    tree = {}
    for path, t in zip(tracked, leaves):
        node = tree
        *up, last = path.split("/")
        for n in up:
            node = node.setdefault(n, {})
        node[last] = t
    got, _ = model.loss(tree, {"tokens": tokens})
    want = ds.loss(cfg, tree, tokens, MM)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    assert "dense_layers" in tree and "mlp" in tree["dense_layers"]
    for path, g, r in zip(tracked, torch.autograd.grad(got, leaves),
                          torch.autograd.grad(want, leaves)):
        assert float((g - r).norm()) <= 1e-4 * max(float(r.norm()),
                                                   1e-6), path


def test_adamw_steps_match_the_reference():
    """Two train steps of 2 micro-batches through ``make_train_step``
    against ``reference.train`` over the arch file's loss."""
    from repro_torch.training import (OptimizerConfig, init_state,
                                      make_train_step)
    cfg = SMALL
    w = _weights(cfg, 9)
    batches = [torch.randint(0, cfg["vocab_size"], (4, 32),
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
    ref = reference.train(cfg, OPT, w, batches, accum=2, loss=ds.loss)
    assert losses == pytest.approx(ref["losses"], rel=1e-5)
    for k, v in ref["grad_norms"].items():
        assert g1[k] == pytest.approx(v, rel=1e-4, abs=1e-9), k
    p0 = weights.leaves(w)
    for k, q in weights.leaves(p).items():
        assert float((q - p0[k]).norm()) == pytest.approx(
            ref["change"][k], rel=1e-4, abs=1e-9), k


@pytest.mark.parametrize("call", ["prefill", "decode_step", "init_cache"])
def test_latent_attention_does_not_serve(call):
    model = _program(SMALL)
    args = {"prefill": (None, torch.zeros((1, 4), dtype=torch.long)),
            "decode_step": (None, None, torch.zeros((1, 1),
                                                    dtype=torch.long)),
            "init_cache": (1, 8)}[call]
    with pytest.raises(NotImplementedError, match="latent attention"):
        getattr(model, call)(*args)


def test_counts_by_hand():
    """The published widths: 1.105 B weights a token (held experts at 6 x
    8 / 64 copies), 640 and 1664 operations a (q, k) pair and head for the
    flash forward and backward."""
    per_moe = (2048 * 16 * 192 + 2048 * 576 + 512 * 16 * 256 + 16 * 128
               * 2048) + 2048 * 64 + 3 * 2048 * 2816 + 3 * 2048 * 1408 * 0.75
    per_dense = per_moe - (2048 * 64 + 3 * 2048 * 2816
                           + 3 * 2048 * 1408 * 0.75) + 3 * 2048 * 11264
    n = 26 * per_moe + per_dense + 2048 * 20480
    assert ds.matmul_params(CONF) == pytest.approx(n, rel=1e-12)
    assert 1.104e9 < n < 1.106e9
    pairs = 8192 * 8193 // 2
    assert ds.train_step_flops(CONF, 4, 8192) == pytest.approx(
        4 * (6 * n * 8192 + 3 * 27 * 640 * 16 * pairs), rel=1e-12)
    assert ds.flash_call(CONF, 2, 8192) == (
        2 * 640 * 16 * pairs, 2 * 2 * 8192 * 16 * (2 * 192 + 2 * 128))
    assert ds.flash_backward_call(CONF, 2, 8192) == (
        2 * 1664 * 16 * pairs, 2 * 2 * 8192 * 16 * (4 * 192 + 4 * 128))


def _rehearse():
    return harness.run("moonlight-train-8k", 2 ** 31 + 41, 0.3, False,
                       started=time.perf_counter(), rehearse=True,
                       log=lambda m: None)


def test_the_rehearsal_is_correct():
    res, _ = _rehearse()
    assert res["correct"] is True, res["checked"]


@pytest.mark.parametrize("fault", ["bias_ignored", "no_routed_scaling"])
def test_a_planted_fault_fails_the_check(fault, monkeypatch):
    from repro_torch.models import moe
    if fault == "bias_ignored":
        monkeypatch.setattr(moe, "_bias", lambda m, device: torch.zeros(
            len(m.selection_bias), device=device))
    else:
        real = harness.model_config
        monkeypatch.setattr(harness, "model_config", lambda cfg: real(
            cfg).replace(moe=dataclasses.replace(real(cfg).moe,
                                                 routed_scaling=1.0)))
    res, _ = _rehearse()
    assert res["correct"] is False
