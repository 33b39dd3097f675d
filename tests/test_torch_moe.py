"""Port parity for the MoE layer: ``repro_torch.models.moe`` against
``repro.models.moe`` on the CPU, in float32, at olmoe-1b-7b's smoke size.

Params come from the reference's ``init_params(moe_specs(cfg), PRNGKey)``
and inputs from numpy seeds; both cross as numpy. Tolerances are the
reference's own (``tests/test_moe.py``): 1e-5 on outputs, 1e-6 on the aux
loss (float32 products summed in another order).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import _torch_dist_workers as W  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import moe  # noqa: E402

ARCH = "olmoe-1b-7b"
Y_TOL, AUX_TOL = 1e-5, 1e-6
IMPLS = {"dense": (jmoe.moe_dense, moe.moe_dense),
         "ragged": (jmoe.moe_ragged_local, moe.moe_ragged_local),
         "batched": (jmoe.moe_batched_local, moe.moe_batched_local)}


def _cfgs(**moe_kw):
    jcfg, cfg = jsmoke(ARCH), smoke_config(ARCH)
    if moe_kw:
        jcfg = jcfg.replace(moe=dataclasses.replace(jcfg.moe, **moe_kw))
        cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
    return jcfg, cfg


def _world(seed=3, shape=(4, 16), scale=0.5, **moe_kw):
    jcfg, cfg = _cfgs(**moe_kw)
    jp = jinit(jmoe.moe_specs(jcfg), jax.random.PRNGKey(seed), "float32")
    p = lm_params_from_numpy(jax.tree.map(np.asarray, jp))
    x = (np.random.default_rng(seed + 1).standard_normal(
        shape + (cfg.d_model,)) * scale).astype(np.float32)
    return jcfg, cfg, jp, p, x


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


@pytest.mark.parametrize("impl", list(IMPLS))
def test_impl_matches_reference(impl):
    jcfg, cfg, jp, p, x = _world()
    jf, f = IMPLS[impl]
    want, waux = jf(jcfg, jp, jnp.asarray(x))
    got, aux = f(cfg, p, torch.from_numpy(x))
    assert got.shape == x.shape
    assert _err(got.numpy(), want) < Y_TOL
    assert abs(float(aux) - float(waux)) < AUX_TOL


def test_routing_matches_reference():
    jcfg, cfg, jp, p, x = _world()
    x2 = x.reshape(-1, cfg.d_model)
    jprobs, jgate, jidx, jaux = jmoe._route(jcfg, jp["router"],
                                            jnp.asarray(x2))
    probs, gate, idx, aux = moe._route(cfg, p["router"], torch.from_numpy(x2))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert _err(gate.numpy(), jgate) < AUX_TOL
    assert _err(probs.numpy(), jprobs) < AUX_TOL


@pytest.mark.parametrize("impl", ["ragged", "batched"])
def test_local_impls_match_dense(impl):
    """At the smoke config's capacity 8.0 no copy drops: every
    implementation is the dense oracle."""
    _, cfg, _, p, x = _world()
    yd, auxd = moe.moe_dense(cfg, p, torch.from_numpy(x))
    y, aux = IMPLS[impl][1](cfg, p, torch.from_numpy(x))
    assert _err(y.numpy(), yd.numpy()) < Y_TOL
    assert abs(float(aux) - float(auxd)) < AUX_TOL


def test_aux_loss_uniform_router_is_one():
    _, cfg, _, p, x = _world()
    p = dict(p, router=torch.zeros_like(p["router"]))
    _, aux = moe.moe_dense(cfg, p, torch.from_numpy(x))
    assert 0.9 < float(aux) < 1.1


@pytest.mark.parametrize("impl", ["ragged", "batched"])
def test_capacity_drops_the_reference_copies(impl):
    """capacity_factor 0.05: most copies drop. The port keeps and drops the
    same copies as the reference (its sort is stable, as jnp.argsort is),
    so outputs agree at 1e-5, the same rows come out all zero, and both
    differ from the dense oracle."""
    jcfg, cfg, jp, p, x = _world(seed=0, shape=(2, 32), scale=1.0,
                                 capacity_factor=0.05)
    jf, f = IMPLS[impl]
    want, _ = jf(jcfg, jp, jnp.asarray(x))
    got, _ = f(cfg, p, torch.from_numpy(x))
    assert _err(got.numpy(), want) < Y_TOL
    zero_got = (got.reshape(-1, cfg.d_model) == 0).all(dim=1).numpy()
    zero_want = np.asarray(
        (jnp.asarray(want).reshape(-1, cfg.d_model) == 0).all(axis=1))
    np.testing.assert_array_equal(zero_got, zero_want)
    assert zero_got.any()
    yd, _ = moe.moe_dense(cfg, p, torch.from_numpy(x))
    assert _err(got.numpy(), yd.numpy()) > 1e-3
    assert bool(torch.isfinite(got).all())


def test_batched_decode_capacity_matches_reference():
    """At decode T = B tokens: cap_e is the floor of 8 slots, so a batch of
    32 rows at top-2 over 8 experts can overflow an expert."""
    jcfg, cfg, jp, p, x = _world(seed=5, shape=(32, 1), scale=2.0,
                                 capacity_factor=1.0)
    want, _ = jmoe.moe_batched_local(jcfg, jp, jnp.asarray(x))
    got, _ = moe.moe_batched_local(cfg, p, torch.from_numpy(x))
    assert _err(got.numpy(), want) < Y_TOL


def test_moe_apply_dispatches_on_impl_and_refuses_a_mesh(tmp_path):
    """Without a mesh each impl is the reference's; on a 1-rank (1, 1)
    device mesh (a gloo group) ragged and batched take the EP branch,
    which at one rank is the single-device call, and a mesh without a
    "model" axis takes the local path; an object that is no mesh is
    refused."""
    cfgs, want = {}, {}
    for impl in IMPLS:
        jcfg, cfg, jp, p, x = _world(impl=impl)
        want[impl] = jmoe.moe_apply(jcfg, jp, jnp.asarray(x))
        got, _ = moe.moe_apply(cfg, p, torch.from_numpy(x))
        assert _err(got.numpy(), want[impl][0]) < Y_TOL, impl
        cfgs[impl] = cfg
    with pytest.raises(TypeError, match="mesh"):
        moe.moe_apply(cfg, p, torch.from_numpy(x), mesh=object())
    pn = jax.tree.map(np.asarray, jp)
    out = W.run_group(W.moe_one_rank, 1, tmp_path, cfgs, pn, x,
                      timeout=60.0)[0]
    for impl, (y, aux) in want.items():
        r = out[impl]
        assert r["dtensor"] == ("Tensor" if impl == "dense" else "DTensor")
        for got_y, got_aux in ((r["y"], r["aux"]),
                               (r["serving_y"], r["serving_aux"])):
            assert _err(got_y, y) < Y_TOL, impl
            assert abs(got_aux - float(aux)) < AUX_TOL, impl


def test_bf16_batched_runs_in_the_configs_dtype():
    _, cfg, _, p, x = _world()
    cfg = cfg.replace(dtype="bfloat16")
    y, aux = moe.moe_batched_local(cfg, p,
                                   torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    assert bool(torch.isfinite(y).all())
    # rows whose routing bf16 rounding did not swap stay within bf16 error
    yd, _ = moe.moe_batched_local(cfg.replace(dtype="float32"), p,
                                  torch.from_numpy(x))
    row_err = (y.float() - yd).abs().reshape(-1, cfg.d_model).amax(dim=1)
    assert float((row_err < 0.05).float().mean()) > 0.8
