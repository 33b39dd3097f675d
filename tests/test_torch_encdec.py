"""Port parity for the encoder-decoder family (whisper-medium):
``repro_torch.models.encdec`` against ``repro.models.encdec`` on the CPU,
in float32, at smoke size (2 encoder + 2 decoder layers, d 128).

Params come from the reference's ``init(PRNGKey(0))`` and cross by
``lm_params_from_numpy``; inputs come from numpy seeds. The reference runs
``attn_impl="naive"`` as its own tests do; the port runs its kernel route
(the kernels' plain versions on the CPU) and its plain route. Tolerances:
2e-4 for logits, the reference's own decode-vs-forward bound
(``tests/test_models.py``); 1e-5 for the loss (a float32 mean of ~1e3
token NLLs near ln(512) = 6.2); 2e-4 for caches.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import batch_axes, build_model, make_batch  # noqa: E402
from repro_torch.models.encdec import EncDecModel  # noqa: E402
from repro_torch.training import make_prefill_step, make_serve_step  # noqa: E402

ARCH = "whisper-medium"
MODEL_TOL = 2e-4
LOSS_TOL = 1e-5


def _err(got, want):
    return float(np.abs(np.asarray(got, np.float32)
                        - np.asarray(want, np.float32)).max())


@pytest.fixture(scope="module")
def pair():
    jm = jbuild(jsmoke(ARCH), attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    params = lm_params_from_numpy(jax.tree.map(np.asarray, jparams))
    return jm, jparams, params


def _batch(frames, tokens, seed=0):
    rng = np.random.default_rng(seed)
    return {"frames": rng.standard_normal((2, frames, 128)).astype(np.float32),
            "tokens": rng.integers(0, 512, (2, tokens))}


def _j(batch):
    return {"frames": jnp.asarray(batch["frames"]),
            "tokens": jnp.asarray(batch["tokens"], jnp.int32)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_build_model_gives_the_encdec_model():
    m = build_model(smoke_config(ARCH))
    assert isinstance(m, EncDecModel)
    assert batch_axes(m.cfg) == {"frames": ("batch", "seq", "act_embed"),
                                 "tokens": ("batch", "seq")}


def test_params_follow_the_reference_tree(pair):
    _, _, params = pair
    m = build_model(smoke_config(ARCH))

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape)
                for k, v in tree.items()}

    init = m.init(torch.Generator().manual_seed(0))
    assert shapes(init) == shapes(params)
    assert {"enc_proj", "enc_layers", "enc_norm", "dec_layers"} <= set(params)


def test_make_batch_layout():
    cfg = smoke_config(ARCH)
    b = make_batch(cfg, ShapeConfig("s", 64, 3, "train"), seed=1)
    assert tuple(b["frames"].shape) == (3, 32, 128)
    assert b["frames"].dtype == torch.float32
    assert tuple(b["tokens"].shape) == (3, 32)
    assert int(b["tokens"].max()) < cfg.vocab_size
    again = make_batch(cfg, ShapeConfig("s", 64, 3, "train"), seed=1)
    assert torch.equal(b["frames"], again["frames"])


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("frames,tokens", [(32, 32), (48, 16)])
def test_apply_logits_match_reference(pair, use_kernels, frames, tokens):
    """(48, 16): cross-attention with S_dec != S_enc."""
    jm, jparams, params = pair
    batch = _batch(frames, tokens, seed=frames)
    want, _ = jm.apply(jparams, _j(batch))
    m = build_model(smoke_config(ARCH), attn_impl="naive",
                    use_kernels=use_kernels)
    with torch.inference_mode():
        got, aux = m.apply(params, _t(batch))
    assert got.shape == want.shape == (2, tokens, 512)
    assert float(aux) == 0.0
    assert _err(got.numpy(), want) < MODEL_TOL


@pytest.mark.parametrize("mask", [False, True])
def test_loss_matches_reference(pair, mask):
    jm, jparams, params = pair
    batch = _batch(32, 32, seed=5)
    if mask:
        batch["mask"] = (np.random.default_rng(6).random((2, 31)) > 0.3
                         ).astype(np.float32)
    jb = _j(batch)
    if mask:
        jb["mask"] = jnp.asarray(batch["mask"])
    want, wm = jm.loss(jparams, jb)
    m = build_model(smoke_config(ARCH), attn_impl="naive")
    with torch.no_grad():
        got, gm = m.loss(params, _t(batch))
    assert abs(float(got) - float(want)) < LOSS_TOL
    assert abs(float(gm["ce"]) - float(wm["ce"])) < LOSS_TOL


def test_decode_matches_full_forward(pair):
    """The reference's ``test_decode_matches_full_forward``: prefill S - 1
    tokens with ``max_len = S``, one decode step, equal to the full
    forward's last logits."""
    _, _, params = pair
    S = 32
    batch = _batch(S, S, seed=9)
    m = build_model(smoke_config(ARCH), attn_impl="naive")
    tb = _t(batch)
    with torch.inference_mode():
        full, _ = m.apply(params, tb)
        _, state = m.prefill(params, {"frames": tb["frames"],
                                      "tokens": tb["tokens"][:, :-1]},
                             max_len=S)
        lg, _ = m.decode_step(params, state, tb["tokens"][:, S - 1:S])
    assert _err(lg.numpy(), full[:, S - 1:S].numpy()) < MODEL_TOL


@pytest.mark.parametrize("use_kernels", [True, False])
def test_prefill_and_six_greedy_steps_match_reference(pair, use_kernels):
    """Prefill 16 tokens against 48 frames (max_len 24, so the self cache
    is padded), then 6 greedy steps: logits, tokens, the self cache and the
    cross caches element for element."""
    jm, jparams, params = pair
    batch = _batch(48, 16, seed=11)
    max_len = 24
    jlog, jstate = jm.prefill(jparams, _j(batch), max_len=max_len)
    m = build_model(smoke_config(ARCH), attn_impl="naive",
                    use_kernels=use_kernels)
    with torch.inference_mode():
        log, state = m.prefill(params, _t(batch), max_len=max_len)
    assert _err(log.numpy(), jlog) < MODEL_TOL
    assert state.index == int(jstate.index) == 16
    assert state.self_kv.index == int(jstate.self_kv.index) == 16
    for got, want in ((state.self_kv.k, jstate.self_kv.k),
                      (state.self_kv.v, jstate.self_kv.v),
                      (state.cross_k, jstate.cross_k),
                      (state.cross_v, jstate.cross_v)):
        assert tuple(got.shape) == tuple(want.shape)
        assert _err(got.numpy(), want) < MODEL_TOL
    assert tuple(state.self_kv.k.shape) == (2, 2, max_len, 2, 32)
    assert tuple(state.cross_k.shape) == (2, 2, 48, 2, 32)

    jstep = jax.jit(jm.decode_step)
    tok = torch.from_numpy(np.array(jnp.argmax(jlog[:, -1:], axis=-1)))
    jtok = jnp.asarray(tok.numpy(), jnp.int32)
    for t in range(6):
        jlog, jstate = jstep(jparams, jstate, jtok)
        with torch.inference_mode():
            log, state = m.decode_step(params, state, tok)
        assert _err(log.numpy(), jlog) < MODEL_TOL, t
        jtok = jnp.argmax(jlog[:, -1:], axis=-1).astype(jnp.int32)
        tok = log[:, -1:].argmax(dim=-1)
        assert np.array_equal(tok.numpy(), np.asarray(jtok)), t
    assert state.index == int(jstate.index) == 22
    for got, want in ((state.self_kv.k, jstate.self_kv.k),
                      (state.self_kv.v, jstate.self_kv.v),
                      (state.cross_k, jstate.cross_k),
                      (state.cross_v, jstate.cross_v)):
        assert _err(got.numpy(), want) < MODEL_TOL


def test_init_cache_splits_the_budget_as_the_reference(pair):
    jm, _, _ = pair
    m = build_model(smoke_config(ARCH))
    for max_len in (64, 65, 7):
        js = jm.init_cache(3, max_len)
        st = m.init_cache(3, max_len)
        assert tuple(st.self_kv.k.shape) == tuple(js.self_kv.k.shape)
        assert tuple(st.cross_k.shape) == tuple(js.cross_k.shape)
        assert st.self_kv.k.shape[2] == max_len // 2
        assert st.cross_k.shape[2] == max_len - max_len // 2
        assert st.index == int(js.index) == 0 and not st.cross_k.any()


def test_prefill_step_and_serve_step_drive_the_encdec_model(pair):
    """``make_prefill_step`` passes the batch (no max_len: the self cache
    holds the prompt only, as in the reference); ``make_serve_step`` then
    raises past the full cache's last slot."""
    _, _, params = pair
    m = build_model(smoke_config(ARCH), attn_impl="naive")
    tb = _t(_batch(32, 8, seed=3))
    with torch.inference_mode():
        got, state = make_prefill_step(m)(params, tb)
        want, _ = m.prefill(params, tb)
        assert torch.equal(got, want)
        assert state.self_kv.k.shape[2] == 8
        with pytest.raises(ValueError):
            make_serve_step(m)(params, state, tb["tokens"][:, :1])
