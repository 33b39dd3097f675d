"""Port parity for the LM zoo's dense path: ``repro_torch.models`` against
``repro.models`` on the CPU, in float32, at smoke sizes.

Inputs come from numpy seeds; model params come from the reference's
``model.init(PRNGKey(0))`` and cross by ``lm_params_from_numpy``. The
reference runs its XLA attention (``attn_impl="naive"``); the port runs
its kernel route, whose wrappers take the kernels' plain versions for CPU
tensors, and (``use_kernels=False``) its plain route. Tolerance 2e-4 for
model outputs, the reference's own decode-vs-forward bound
(``tests/test_models.py``); 2e-5 for single layers (float32, summation
order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.models.api import make_batch  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.training import make_prefill_step  # noqa: E402

LAYER_TOL = 2e-5
MODEL_TOL = 2e-4


def _normal(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


# -- layers -----------------------------------------------------------------

@pytest.mark.parametrize("use_kernels", [True, False])
def test_rmsnorm_layer_matches_reference(use_kernels):
    x, w = _normal((2, 5, 128), 0), _normal((128,), 1, 0.1)
    want = jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w), 1e-6)
    got = layers.rmsnorm(_t(x), _t(w), 1e-6, use_kernels=use_kernels)
    assert got.shape == x.shape
    assert _err(got.numpy(), want) < LAYER_TOL


def test_rmsnorm_plain_scale_is_refused():
    with pytest.raises(NotImplementedError):
        layers.rmsnorm(torch.zeros(2, 8), torch.zeros(8), one_plus=False)


def test_rope_matches_reference():
    x = _normal((2, 12, 4, 32), 2)
    pos = np.broadcast_to(np.arange(12)[None] + 50, (2, 12))
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = layers.apply_rope(_t(x), torch.from_numpy(pos.copy()), 10000.0)
    assert _err(got.numpy(), want) < LAYER_TOL


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "gemma-2b"])
def test_mlp_matches_reference(arch):
    cfg, jcfg = smoke_config(arch), jsmoke(arch)
    p = {"wi": _normal((128, 256), 3, 0.05), "wg": _normal((128, 256), 4, 0.05),
         "wo": _normal((256, 128), 5, 0.05)}
    x = _normal((2, 7, 128), 6)
    want = jlayers.mlp_apply(jcfg, {k: jnp.asarray(v) for k, v in p.items()},
                             jnp.asarray(x))
    got = layers.mlp_apply(cfg, {k: _t(v) for k, v in p.items()}, _t(x))
    assert _err(got.numpy(), want) < LAYER_TOL


# -- attention --------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("S", [96, 256])
def test_naive_and_chunked_attention_match_reference(causal, window, S):
    q, k, v = (_normal((2, S, 4, 32), 7), _normal((2, S, 2, 32), 8),
               _normal((2, S, 2, 32), 9))
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    want = jattn.naive_attention(jq, jk, jv, causal=causal, window=window)
    got = attn.naive_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window)
    assert _err(got.numpy(), want) < LAYER_TOL
    want_c = jattn.chunked_attention(jq, jk, jv, causal=causal, window=window,
                                     q_chunk=64, kv_chunk=64)
    got_c = attn.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                                   window=window, q_chunk=64, kv_chunk=64)
    assert _err(got_c.numpy(), want_c) < LAYER_TOL


def _attn_params(cfg, seed):
    d, hd, hq, hkv = (cfg.d_model, cfg.resolved_head_dim, cfg.num_heads,
                      cfg.num_kv_heads)
    return {"wq": _normal((d, hq, hd), seed, 0.1),
            "wk": _normal((d, hkv, hd), seed + 1, 0.1),
            "wv": _normal((d, hkv, hd), seed + 2, 0.1),
            "wo": _normal((hq, hd, d), seed + 3, 0.1)}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("softcap", [None, 30.0])
def test_attn_apply_matches_reference(use_kernels, softcap):
    """The kernel route (flash kernel's plain version on the CPU) and the
    plain route both give the reference's block output; a softcap config
    takes the plain path on the CPU."""
    cfg = smoke_config("h2o-danube-1.8b").replace(attn_logit_softcap=softcap)
    jcfg = jsmoke("h2o-danube-1.8b").replace(attn_logit_softcap=softcap)
    p = _attn_params(cfg, 10)
    x = _normal((2, 96, 128), 11)
    pos = np.broadcast_to(np.arange(96)[None], (2, 96)).copy()
    want, (wk, wv) = jattn.attn_apply(
        jcfg, {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        positions=jnp.asarray(pos), window=64, impl="naive",
        kv_for_cache=True)
    got, (gk, gv) = attn.attn_apply(
        cfg, {k: _t(v) for k, v in p.items()}, _t(x),
        positions=torch.from_numpy(pos), window=64, impl="chunked",
        kv_for_cache=True, use_kernels=use_kernels)
    assert _err(got.numpy(), want) < LAYER_TOL
    assert _err(gk.numpy(), wk) < LAYER_TOL and _err(gv.numpy(), wv) == 0


@pytest.mark.parametrize("window", [None, 64])
@pytest.mark.parametrize("index", [0, 37, 63, 64, 100, 191])
def test_decode_attention_both_sides_of_the_wrap(window, index):
    """The kernel's ``length = min(index + 1, W)`` against the reference's
    slot mask, for a full cache and a circular one before and after it
    wraps (W = 64 when windowed, 192 otherwise)."""
    W = 64 if window else 192
    q = _normal((2, 1, 4, 32), index)
    kc, vc = _normal((2, W, 2, 32), 1), _normal((2, W, 2, 32), 2)
    want = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(index),
                                  window=window)
    plain = attn.decode_attention(_t(q), _t(kc), _t(vc), index, window=window)
    kernel = attn.decode_attention_kernel(
        _t(q).reshape(2, 4, 32), _t(kc).transpose(1, 2),
        _t(vc).transpose(1, 2), min(index + 1, W))
    assert _err(plain.numpy(), want) < LAYER_TOL
    assert _err(kernel.reshape(2, 1, 4, 32).numpy(), want) < LAYER_TOL


# -- whole model --------------------------------------------------------------

PROMPT, STEPS = 96, 6


def _models(arch):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    jm = jbuild(jcfg, attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg, attn_impl="naive"), params


@pytest.fixture(scope="module", params=["h2o-danube-1.8b", "llama3-405b"])
def lm_pair(request):
    return request.param, _models(request.param)


def _tokens(arch, n):
    return np.random.default_rng(len(arch)).integers(0, 512, (2, n))


def test_apply_logits_match_reference(lm_pair):
    arch, (jm, jparams, m, params) = lm_pair
    toks = _tokens(arch, PROMPT)
    want, _ = jm.apply(jparams, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got, _ = m.apply(params, torch.from_numpy(toks))
    assert got.shape == want.shape
    assert _err(got.numpy(), want) < MODEL_TOL


def test_prefill_and_six_decode_steps_match_reference(lm_pair):
    """96-token prompt (past h2o's window of 64, so its cache is circular
    and wraps during decode), then 6 teacher-forced decode steps."""
    arch, (jm, jparams, m, params) = lm_pair
    toks = _tokens(arch, PROMPT + STEPS)
    max_len = PROMPT + STEPS
    jlog, jstate = jm.prefill(jparams, jnp.asarray(toks[:, :PROMPT],
                                                   jnp.int32),
                              max_len=max_len)
    with torch.inference_mode():
        log, state = m.prefill(params, torch.from_numpy(toks[:, :PROMPT]),
                               max_len=max_len)
    assert _err(log.numpy(), jlog) < MODEL_TOL
    assert state.index == int(jstate.index) == PROMPT
    assert tuple(state.kv.k.shape) == tuple(jstate.kv.k.shape)
    assert _err(state.kv.k.numpy(), jstate.kv.k) < MODEL_TOL
    assert _err(state.kv.v.numpy(), jstate.kv.v) < MODEL_TOL
    step = jax.jit(jm.decode_step)
    for t in range(PROMPT, PROMPT + STEPS):
        jlog, jstate = step(jparams, jstate,
                            jnp.asarray(toks[:, t:t + 1], jnp.int32))
        with torch.inference_mode():
            log, state = m.decode_step(params, state,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert _err(log.numpy(), jlog) < MODEL_TOL, t
    assert _err(state.kv.k.numpy(), jstate.kv.k) < MODEL_TOL


def test_init_cache_matches_reference():
    for arch, max_len in (("h2o-danube-1.8b", 200), ("llama3-405b", 40)):
        jstate = jbuild(jsmoke(arch)).init_cache(3, max_len)
        state = build_model(smoke_config(arch)).init_cache(3, max_len)
        assert tuple(state.kv.k.shape) == tuple(jstate.kv.k.shape)
        assert state.index == 0 and not state.kv.k.any()


def test_prefill_step_is_the_models_prefill(lm_pair):
    arch, (_, _, m, params) = lm_pair
    toks = torch.from_numpy(_tokens(arch, 20))
    with torch.inference_mode():
        got, _ = make_prefill_step(m)(params, {"tokens": toks})
        want, _ = m.prefill(params, toks)
    assert torch.equal(got, want)


def test_plain_route_matches_kernel_route_on_the_cpu():
    _, _, m, params = _models("h2o-danube-1.8b")
    plain = build_model(smoke_config("h2o-danube-1.8b"), use_kernels=False)
    toks = torch.from_numpy(_tokens("x", 80))
    with torch.inference_mode():
        a, _ = m.apply(params, toks)
        b, _ = plain.apply(params, toks)
    assert _err(a.numpy(), b.numpy()) < MODEL_TOL


def test_full_cache_decode_past_its_slots_raises():
    _, _, m, params = _models("llama3-405b")
    toks = torch.from_numpy(_tokens("y", 9))
    with torch.inference_mode():
        _, state = m.prefill(params, toks[:, :8], max_len=8)
        with pytest.raises(ValueError):
            m.decode_step(params, state, toks[:, 8:9])


# -- the MoE, SSM and hybrid families ----------------------------------------
# olmoe (every block attention + MoE), mamba2 (every block SSM) and
# recurrentgemma (cycles of rglru, rglru, attn over a 64-slot window). The
# "+rest" case gives recurrentgemma 5 layers: one cycle and a remainder of
# two RG-LRU blocks (rest0, rest1), as the full config's 38 = 12 x 3 + 2.
# Decode states are compared element for element: kv, conv and rec in the
# reference's flat layer order.

FAMILIES = {"olmoe-1b-7b": None, "mamba2-370m": None,
            "recurrentgemma-9b": None, "recurrentgemma-9b+rest": 5}


def _family_models(case):
    arch = case.split("+")[0]
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    if FAMILIES[case]:
        jcfg = jcfg.replace(num_layers=FAMILIES[case])
        cfg = cfg.replace(num_layers=FAMILIES[case])
    jm = jbuild(jcfg, attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, build_model(cfg, attn_impl="naive"), params


@pytest.fixture(scope="module", params=list(FAMILIES))
def family_pair(request):
    return request.param, _family_models(request.param)


def _state_parts(state):
    kv = state.kv
    return {"k": None if kv is None else kv.k,
            "v": None if kv is None else kv.v,
            "conv": state.conv, "rec": state.rec}


def _assert_states_match(state, jstate, where):
    got, want = _state_parts(state), _state_parts(jstate)
    for name in got:
        assert (got[name] is None) == (want[name] is None), (where, name)
        if got[name] is not None:
            assert tuple(got[name].shape) == tuple(want[name].shape), \
                (where, name)
            assert _err(got[name].numpy(), want[name]) < MODEL_TOL, \
                (where, name)


def test_family_params_follow_the_reference_tree(family_pair):
    case, (jm, jparams, m, params) = family_pair
    specs = m.specs()

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    def spec_shapes(tree):
        return {k: spec_shapes(v) if isinstance(v, dict) else v.shape
                for k, v in tree.items()}

    assert spec_shapes(specs) == shapes(params)
    init = m.init(torch.Generator().manual_seed(0))
    assert shapes(init) == shapes(params)


def test_family_apply_logits_and_aux_match_reference(family_pair):
    case, (jm, jparams, m, params) = family_pair
    toks = _tokens(case, PROMPT)
    want, waux = jm.apply(jparams, jnp.asarray(toks, jnp.int32))
    with torch.inference_mode():
        got, aux = m.apply(params, torch.from_numpy(toks))
    assert got.shape == want.shape
    assert _err(got.numpy(), want) < MODEL_TOL
    assert abs(float(aux) - float(waux)) < 1e-5


def test_family_prefill_and_six_decode_steps_match_reference(family_pair):
    """96-token prompt (past recurrentgemma's 64-slot window, so its cache
    wraps), then 6 teacher-forced decode steps: logits and every state
    tensor after the prefill and after each step."""
    case, (jm, jparams, m, params) = family_pair
    toks = _tokens(case, PROMPT + STEPS)
    max_len = PROMPT + STEPS
    jlog, jstate = jm.prefill(jparams, jnp.asarray(toks[:, :PROMPT],
                                                   jnp.int32),
                              max_len=max_len)
    with torch.inference_mode():
        log, state = m.prefill(params, torch.from_numpy(toks[:, :PROMPT]),
                               max_len=max_len)
    assert _err(log.numpy(), jlog) < MODEL_TOL
    assert state.index == int(jstate.index) == PROMPT
    _assert_states_match(state, jstate, "prefill")
    step = jax.jit(jm.decode_step)
    for t in range(PROMPT, PROMPT + STEPS):
        jlog, jstate = step(jparams, jstate,
                            jnp.asarray(toks[:, t:t + 1], jnp.int32))
        with torch.inference_mode():
            log, state = m.decode_step(params, state,
                                       torch.from_numpy(toks[:, t:t + 1]))
        assert _err(log.numpy(), jlog) < MODEL_TOL, t
        _assert_states_match(state, jstate, t)
    assert state.index == int(jstate.index)


@pytest.mark.parametrize("case", list(FAMILIES))
def test_family_init_cache_matches_reference(case):
    arch = case.split("+")[0]
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    if FAMILIES[case]:
        jcfg = jcfg.replace(num_layers=FAMILIES[case])
        cfg = cfg.replace(num_layers=FAMILIES[case])
    jstate = jbuild(jcfg).init_cache(3, 100)
    state = build_model(cfg).init_cache(3, 100)
    got, want = _state_parts(state), _state_parts(jstate)
    for name in got:
        assert (got[name] is None) == (want[name] is None), name
        if got[name] is not None:
            assert tuple(got[name].shape) == tuple(want[name].shape), name
            assert got[name].dtype == {"float32": torch.float32}[
                str(want[name].dtype)] and not got[name].any()
    assert state.index == 0


def test_family_plain_route_matches_kernel_route_on_the_cpu(family_pair):
    case, (_, _, m, params) = family_pair
    plain = build_model(m.cfg, use_kernels=False)
    toks = torch.from_numpy(_tokens("z", 80))
    with torch.inference_mode():
        a, aux_a = m.apply(params, toks)
        b, aux_b = plain.apply(params, toks)
    assert _err(a.numpy(), b.numpy()) < MODEL_TOL
    assert float(aux_a) == float(aux_b)


def test_family_decode_writes_its_state_in_place(family_pair):
    """The recurrent stacks and the KV cache are updated in place: the
    state a step returns holds the very tensors it was given."""
    case, (_, _, m, params) = family_pair
    toks = torch.from_numpy(_tokens("w", 20))
    with torch.inference_mode():
        _, state = m.prefill(params, toks[:, :19], max_len=20)
        before = {k: v for k, v in _state_parts(state).items()
                  if v is not None}
        snap = {k: v.clone() for k, v in before.items()}
        _, new = m.decode_step(params, state, toks[:, 19:])
    for k, v in before.items():
        assert _state_parts(new)[k] is v
        assert not torch.equal(v, snap[k]), k


def test_make_batch_is_seeded_and_in_vocab():
    cfg = smoke_config("h2o-danube-1.8b")
    a = make_batch(cfg, ShapeConfig("s", 16, 3, "train"), seed=4)["tokens"]
    b = make_batch(cfg, ShapeConfig("s", 16, 3, "train"), seed=4)["tokens"]
    assert a.shape == (3, 16) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < cfg.vocab_size


def test_bf16_params_cross_through_their_bits():
    w = jnp.asarray(_normal((4, 8), 12)).astype(jnp.bfloat16)
    got = lm_params_from_numpy({"a": {"w": np.asarray(w)}})["a"]["w"]
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(w.astype(jnp.float32)))
