"""Port parity for AdamW (``repro_torch.training.optimizer``): the port of
``tests/test_optimizer.py`` (textbook AdamW, clipping, the schedule, bf16
moments) and one ``apply_updates`` against the reference's from the same
params, grads and state, carried across by ``adamw_state_from_numpy``.

Tolerances: 1e-5 relative against the float64 textbook step, as the
reference's test; 1e-6 against the reference's own step (float32, the
same arithmetic in the same order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.training import optimizer as jopt  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.training.optimizer import (AdamWState,  # noqa: E402
                                            OptimizerConfig, apply_updates,
                                            clip_by_global_norm, global_norm,
                                            init_state, lr_schedule,
                                            tree_leaves, tree_map)

STEP_TOL = 1e-6


def _adamw_ref(p, g, m, v, step, cfg):
    """Textbook AdamW single-tensor reference."""
    m = cfg.beta1 * m + (1 - cfg.beta1) * g
    v = cfg.beta2 * v + (1 - cfg.beta2) * g * g
    mh = m / (1 - cfg.beta1 ** step)
    vh = v / (1 - cfg.beta2 ** step)
    lr = float(lr_schedule(cfg, step))
    upd = mh / (np.sqrt(vh) + cfg.eps)
    if p.ndim >= 2:
        upd = upd + cfg.weight_decay * p
    return p - lr * upd, m, v


def test_matches_textbook_adamw():
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=0, grad_clip=1e9)
    rng = np.random.default_rng(0)
    p = {"w": rng.standard_normal((4, 3)).astype(np.float32),
         "b": rng.standard_normal(3).astype(np.float32)}
    g = {"w": rng.standard_normal((4, 3)).astype(np.float32) * 0.1,
         "b": rng.standard_normal(3).astype(np.float32) * 0.1}
    params = tree_map(torch.from_numpy, p)
    state = init_state(params)
    new_p, new_s, _ = apply_updates(cfg, params, tree_map(torch.from_numpy, g),
                                    state)
    for k in ("w", "b"):
        want, _, _ = _adamw_ref(p[k], g[k], np.zeros_like(p[k]),
                                np.zeros_like(p[k]), 1, cfg)
        np.testing.assert_allclose(new_p[k].numpy(), want, rtol=1e-5)
    assert int(new_s.step) == 1 and int(state.step) == 0


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["a"])) == pytest.approx(1.0,
                                                                   rel=1e-4)
    small = {"a": torch.full((4,), 0.1, dtype=torch.bfloat16)}
    kept, _ = clip_by_global_norm(small, 1.0)
    assert kept["a"].dtype == torch.float32
    assert torch.equal(kept["a"], small["a"].float())


def test_schedule_shape():
    cfg = OptimizerConfig(learning_rate=1e-3, warmup_steps=100,
                          total_steps=1000, min_lr_ratio=0.1)
    lrs = [float(lr_schedule(cfg, s)) for s in (0, 50, 100, 500, 1000)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(5e-4)
    assert lrs[2] == pytest.approx(1e-3, rel=1e-2)
    assert lrs[3] < lrs[2]
    assert lrs[4] == pytest.approx(1e-4, rel=1e-2)


@pytest.mark.parametrize("step", [0, 1, 7, 99, 100, 101, 640, 1000, 5000])
def test_schedule_matches_reference(step):
    cfg = OptimizerConfig(learning_rate=3e-4, warmup_steps=100,
                          total_steps=1000)
    jcfg = jopt.OptimizerConfig(learning_rate=3e-4, warmup_steps=100,
                                total_steps=1000)
    got = lr_schedule(cfg, torch.tensor(step, dtype=torch.int32))
    want = jopt.lr_schedule(jcfg, jnp.asarray(step, jnp.int32))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6, abs=1e-12)


def test_bf16_moments_halve_memory():
    p = {"w": torch.zeros((128, 128))}
    s32 = init_state(p, "float32")
    s16 = init_state(p, "bfloat16")
    assert s16.m["w"].dtype == torch.bfloat16
    assert s16.m["w"].nbytes * 2 == s32.m["w"].nbytes
    assert s16.step.dtype == torch.int32 and int(s16.step) == 0


def _tree(rng, bf16=False):
    t = {"layers": {"w": rng.standard_normal((3, 8, 5)).astype(np.float32),
                    "norm": rng.standard_normal((3, 8)).astype(np.float32)},
         "embed": {"embedding": rng.standard_normal((16, 8)).astype(
             np.float32)}}
    if bf16:
        t = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                         t)
    return t


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_bf16", [False, True])
def test_apply_updates_matches_reference(opt_dtype, param_bf16):
    """Three reference steps make a state with nonzero moments; from it
    both packages take one more step with the same grads."""
    rng = np.random.default_rng(1)
    jcfg = jopt.OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                                total_steps=10, grad_clip=0.5,
                                opt_dtype=opt_dtype)
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                          total_steps=10, grad_clip=0.5, opt_dtype=opt_dtype)
    jparams = jax.tree.map(jnp.asarray, _tree(rng, param_bf16))
    jstate = jopt.init_state(jparams, opt_dtype)
    for _ in range(3):
        jgrads = jax.tree.map(jnp.asarray, _tree(rng))
        jparams, jstate, _ = jopt.apply_updates(jcfg, jparams, jgrads, jstate)
    grads_np = _tree(rng)
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    state = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate))
    assert int(state.step) == 3 and state.m["layers"]["w"].dtype == (
        torch.bfloat16 if opt_dtype == "bfloat16" else torch.float32)
    want_p, want_s, want_o = jopt.apply_updates(
        jcfg, jparams, jax.tree.map(jnp.asarray, grads_np), jstate)
    got_p, got_s, got_o = apply_updates(
        cfg, params, tree_map(torch.from_numpy, grads_np), state)
    assert int(got_s.step) == int(want_s.step) == 4
    for k in ("grad_norm", "lr"):
        assert float(got_o[k]) == pytest.approx(float(want_o[k]), rel=1e-6)
    for got, want in ((got_p, want_p), (got_s.m, want_s.m),
                      (got_s.v, want_s.v)):
        for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
            assert g.dtype == (torch.bfloat16 if w.dtype == jnp.bfloat16
                               else torch.float32)
            np.testing.assert_allclose(g.float().numpy(),
                                       np.asarray(w, np.float32),
                                       rtol=0, atol=STEP_TOL)


def test_global_norm_is_over_every_leaf():
    g = {"a": torch.ones(4), "b": {"c": torch.full((3,), 2.0)}}
    assert float(global_norm(g)) == pytest.approx(4.0)
    assert isinstance(init_state(g), AdamWState)


def _whole_leaf_update(cfg, params, grads, state):
    """The update before it went in place and in slices: each leaf whole,
    new m and v."""
    from repro_torch.training.optimizer import _clip_scale
    scale, _ = _clip_scale(grads, cfg.grad_clip)
    step = (state.step + 1).to(torch.float32)
    lr = lr_schedule(cfg, state.step + 1)
    bc1, bc2 = 1 - torch.pow(cfg.beta1, step), 1 - torch.pow(cfg.beta2, step)
    out = {}
    for k in params:
        p, g = params[k], grads[k].to(torch.float32) * scale
        m32 = cfg.beta1 * state.m[k].float() + (1 - cfg.beta1) * g
        v32 = cfg.beta2 * state.v[k].float() + (1 - cfg.beta2) * g * g
        delta = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:
            delta = delta + cfg.weight_decay * p.float()
        out[k] = ((p.float() - lr * delta).to(p.dtype),
                  m32.to(state.m[k].dtype), v32.to(state.v[k].dtype))
    return out


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("param_bf16", [False, True])
def test_sliced_in_place_update_matches_the_whole_leaf_one(
        monkeypatch, opt_dtype, param_bf16):
    """Slices of 6 rows' worth of elements: a [20, 3, 2] leaf takes four
    slices, a [7] leaf and a scalar one. New params, m and v within 1 ulp
    of f32 of the whole-leaf update; the params returned are new tensors
    (a reference kept before the step keeps the old values), the moments
    the state's own, updated in place."""
    from repro_torch.training import optimizer
    monkeypatch.setattr(optimizer, "UPDATE_ELEMENTS", 36)
    cfg = OptimizerConfig(learning_rate=1e-2, warmup_steps=2,
                          total_steps=10, grad_clip=0.5, opt_dtype=opt_dtype)
    g = torch.Generator().manual_seed(5)
    pdt = torch.bfloat16 if param_bf16 else torch.float32
    params = {"w": torch.randn((20, 3, 2), generator=g).to(pdt),
              "b": torch.randn((7,), generator=g).to(pdt),
              "s": torch.randn((), generator=g).to(pdt)}
    state = init_state(params, opt_dtype)
    for k in params:           # moments of earlier steps
        state.m[k].copy_(torch.randn(params[k].shape, generator=g) * 0.1)
        state.v[k].copy_(torch.rand(params[k].shape, generator=g) * 0.01)
    state = AdamWState(torch.tensor(3, dtype=torch.int32), state.m, state.v)
    grads = {k: torch.randn(p.shape, generator=g) for k, p in params.items()}
    kept = {k: p.clone() for k, p in params.items()}
    want = _whole_leaf_update(cfg, params, grads, AdamWState(
        state.step, {k: t.clone() for k, t in state.m.items()},
        {k: t.clone() for k, t in state.v.items()}))
    m_before = dict(state.m)
    got_p, got_s, _ = apply_updates(cfg, params, grads, state)
    assert int(got_s.step) == 4
    for k in params:
        assert got_p[k] is not params[k] and torch.equal(params[k], kept[k])
        assert got_s.m[k] is m_before[k]
        for a, b in ((got_p[k], want[k][0]), (got_s.m[k], want[k][1]),
                     (got_s.v[k], want[k][2])):
            assert a.dtype == b.dtype
            a32, b32 = a.float(), b.float()
            ulp = torch.finfo(torch.float32).eps * b32.abs().clamp(
                min=torch.finfo(torch.float32).tiny)
            assert bool(((a32 - b32).abs() <= ulp).all()), k
