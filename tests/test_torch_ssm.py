"""Port parity for the recurrent blocks: ``repro_torch.models.mamba2`` and
``repro_torch.models.rglru`` against ``repro.models.mamba2`` /
``repro.models.rglru`` on the CPU, in float32, at smoke sizes.

Params come from the reference's ``init_params`` and inputs from numpy
seeds. Tolerances: the reference's own, 1e-3 for ``ssd_chunked`` against
the step-by-step recurrence (``tests/test_attention.py``) and 1e-4 for a
block's full-sequence pass against its decode steps; 1e-5 for a port block
against the reference block (float32, summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.models import mamba2 as jmamba  # noqa: E402
from repro.models import rglru as jrglru  # noqa: E402
from repro.models.spec import init_params as jinit  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_numpy  # noqa: E402
from repro_torch.models import mamba2, rglru  # noqa: E402

SSD_TOL = 1e-3
STEP_TOL = 1e-4
BLOCK_TOL = 1e-5


def _err(a, b):
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _ssd_naive(x, dt, A, B, C):
    """Step-by-step recurrence oracle: h = h*exp(dt*A) + dt * B (x) x."""
    b, S, H, P = x.shape
    G, N = B.shape[2], B.shape[3]
    rep = H // G
    Bf = np.repeat(np.asarray(B, np.float64), rep, axis=2)
    Cf = np.repeat(np.asarray(C, np.float64), rep, axis=2)
    xf, dtf, Af = (np.asarray(a, np.float64) for a in (x, dt, A))
    h = np.zeros((b, H, P, N))
    ys = []
    for t in range(S):
        decay = np.exp(dtf[:, t] * Af[None, :])
        upd = np.einsum("bhn,bhp->bhpn", Bf[:, t],
                        xf[:, t] * dtf[:, t][..., None])
        h = h * decay[..., None, None] + upd
        ys.append(np.einsum("bhn,bhpn->bhp", Cf[:, t], h))
    return np.stack(ys, axis=1), h


def _ssd_inputs(S=64, seed=0):
    rng = np.random.default_rng(seed)
    b, H, P, G, N = 2, 4, 8, 2, 8
    return (rng.standard_normal((b, S, H, P)).astype(np.float32),
            rng.uniform(0.01, 0.2, (b, S, H)).astype(np.float32),
            (-rng.uniform(0.5, 2.0, (H,))).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32),
            rng.standard_normal((b, S, G, N)).astype(np.float32))


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_ssd_chunked_matches_reference_and_recurrence(chunk):
    x, dt, A, B, C = _ssd_inputs()
    y, h = mamba2.ssd_chunked(*map(_t, (x, dt, A, B, C)), chunk)
    y_ref, h_ref = _ssd_naive(x, dt, A, B, C)
    jy, jh = jmamba.ssd_chunked(*map(jnp.asarray, (x, dt, A, B, C)), chunk)
    assert y.shape == x.shape and h.dtype == torch.float32
    assert _err(y.numpy(), y_ref) < SSD_TOL
    assert _err(h.numpy(), h_ref) < SSD_TOL
    assert _err(y.numpy(), jy) < SSD_TOL and _err(h.numpy(), jh) < SSD_TOL


def test_ssd_chunked_masks_the_overflow_above_the_diagonal():
    """Large decays overflow exp(diff) above the diagonal; the mask selects
    (torch.where), so no nan reaches y."""
    x, dt, A, B, C = _ssd_inputs(S=32, seed=1)
    dt = dt * 400.0                  # cum spans ~-1e3 inside a chunk
    y, h = mamba2.ssd_chunked(*map(_t, (x, dt, A, B, C)), 32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    y_ref, _ = _ssd_naive(x, dt, A, B, C)
    assert _err(y.numpy(), y_ref) < SSD_TOL


def test_ssd_chunked_gradient_is_finite_where_the_decay_overflows():
    """The same overflow in the backward: the reference's ``jax.grad`` of
    its SSD is nan for dt there (a full-width chunk of 256 reaches it:
    dt 0.1, A -16); the port masks before the exp, so its gradient is
    finite and equals the step-by-step recurrence's (float64 autograd)."""
    x, dt, A, B, C = _ssd_inputs(S=32, seed=1)
    dt = dt * 400.0
    jg = jax.grad(lambda d: jnp.sum(jmamba.ssd_chunked(
        jnp.asarray(x), d, jnp.asarray(A), jnp.asarray(B), jnp.asarray(C),
        32)[0]))(jnp.asarray(dt))
    assert bool(jnp.isnan(jg).any())
    d = _t(dt).requires_grad_()
    y, _ = mamba2.ssd_chunked(_t(x), d, *map(_t, (A, B, C)), 32)
    g, = torch.autograd.grad(y.sum(), [d])
    assert bool(torch.isfinite(g).all())

    def recurrence(d):
        Bf, Cf = (torch.from_numpy(np.repeat(np.asarray(a, np.float64),
                                             A.shape[0] // B.shape[2],
                                             axis=2)) for a in (B, C))
        xf, Af = (torch.from_numpy(np.asarray(a, np.float64)) for a in (x, A))
        h, ys = torch.zeros(x.shape[0], x.shape[2], x.shape[3], B.shape[3],
                            dtype=torch.float64), []
        for t in range(x.shape[1]):
            decay = torch.exp(d[:, t] * Af[None, :])
            upd = torch.einsum("bhn,bhp->bhpn", Bf[:, t],
                               xf[:, t] * d[:, t][..., None])
            h = h * decay[..., None, None] + upd
            ys.append(torch.einsum("bhn,bhpn->bhp", Cf[:, t], h))
        return torch.stack(ys, 1).sum()

    d64 = torch.from_numpy(dt.astype(np.float64)).requires_grad_()
    want, = torch.autograd.grad(recurrence(d64), [d64])
    assert _err(g.numpy(), want.numpy()) < SSD_TOL * float(
        want.abs().max())


def _block(arch, specs_fn, seed):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    jp = jinit(specs_fn(jcfg), jax.random.PRNGKey(seed), "float32")
    return jcfg, cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp))


@pytest.mark.parametrize("S", [32, 64, 40])      # 40: chunk falls back to S
def test_mamba_apply_matches_reference(S):
    jcfg, cfg, jp, p = _block("mamba2-370m", jmamba.mamba_specs, 0)
    x = (np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    want, (wconv, wh) = jmamba.mamba_apply(jcfg, jp, jnp.asarray(x),
                                           return_state=True)
    got, (conv, h) = mamba2.mamba_apply(cfg, p, _t(x), return_state=True)
    assert _err(got.numpy(), want) < BLOCK_TOL
    assert _err(conv.numpy(), wconv) < BLOCK_TOL
    assert _err(h.numpy(), wh) < BLOCK_TOL


@pytest.mark.parametrize("arch", ["mamba2-370m", "recurrentgemma-9b"])
def test_prefill_states_hold_only_their_own_bytes(arch):
    """The conv window [B,K-1,C] and the last state a full-sequence pass
    returns are copies: a view of the [B,S,C] conv input (or of the
    RG-LRU's [B,S,W] scan) would keep it alive with each layer's cache
    (mamba2-370m prefill_32k: 16.66 GB of temps a rank, 2.47 without)."""
    mod, specs = ((mamba2, jmamba.mamba_specs) if arch.startswith("mamba")
                  else (rglru, jrglru.rglru_specs))
    _, cfg, _, p = _block(arch, specs, 0)
    x = np.random.default_rng(3).standard_normal((2, 64, cfg.d_model))
    apply = mod.mamba_apply if mod is mamba2 else mod.rglru_apply
    _, state = apply(cfg, p, _t(x * 0.5), return_state=True)
    for t in state:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()


def test_mamba_decode_steps_match_reference_and_the_full_pass():
    jcfg, cfg, jp, p = _block("mamba2-370m", jmamba.mamba_specs, 1)
    x = (np.random.default_rng(2).standard_normal((2, 16, cfg.d_model))
         * 0.5).astype(np.float32)
    full, (conv_f, h_f) = mamba2.mamba_apply(cfg, p, _t(x),
                                             return_state=True)
    s, _, nheads, cc = mamba2._dims(cfg)
    conv = torch.zeros((2, s.conv_dim - 1, cc))
    h = torch.zeros((2, nheads, s.head_dim, s.state_dim))
    jconv, jh = jnp.asarray(conv.numpy()), jnp.asarray(h.numpy())
    outs = []
    for t in range(16):
        o, (conv, h) = mamba2.mamba_decode_step(cfg, p, _t(x[:, t:t + 1]),
                                                conv, h)
        jo, (jconv, jh) = jmamba.mamba_decode_step(
            jcfg, jp, jnp.asarray(x[:, t:t + 1]), jconv, jh)
        assert _err(o.numpy(), jo) < BLOCK_TOL, t
        outs.append(o)
    assert _err(torch.cat(outs, 1).numpy(), full.numpy()) < STEP_TOL
    assert _err(h.numpy(), h_f.numpy()) < STEP_TOL
    assert _err(conv.numpy(), conv_f.numpy()) < STEP_TOL
    assert _err(h.numpy(), jh) < BLOCK_TOL


def test_gated_norm_and_conv_match_reference():
    rng = np.random.default_rng(3)
    y, z = (rng.standard_normal((2, 5, 64)).astype(np.float32)
            for _ in range(2))
    w = (rng.standard_normal(64) * 0.1).astype(np.float32)
    assert _err(mamba2._gated_norm(_t(y), _t(z), _t(w), 1e-6).numpy(),
                jmamba._gated_norm(*map(jnp.asarray, (y, z, w)), 1e-6)
                ) < BLOCK_TOL
    x = rng.standard_normal((2, 9, 16)).astype(np.float32)
    k = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal(16).astype(np.float32)
    assert _err(mamba2._causal_conv(_t(x), _t(k), _t(b)).numpy(),
                jmamba._causal_conv(*map(jnp.asarray, (x, k, b)))
                ) < BLOCK_TOL


@pytest.mark.parametrize("S", [1, 2, 7, 64, 100])
def test_linear_scan_is_the_sequential_recurrence(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 8)).astype(np.float32)
    b = rng.standard_normal((2, S, 8)).astype(np.float32)
    h = np.zeros((2, 8), np.float64)
    want = []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        want.append(h)
    got = rglru.linear_scan(_t(a), _t(b))
    assert _err(got.numpy(), np.stack(want, 1)) < BLOCK_TOL


@pytest.mark.parametrize("S", [16, 33])
def test_rglru_apply_matches_reference(S):
    jcfg, cfg, jp, p = _block("recurrentgemma-9b", jrglru.rglru_specs, 0)
    x = (np.random.default_rng(S).standard_normal((2, S, cfg.d_model))
         * 0.5).astype(np.float32)
    want, (wconv, wh) = jrglru.rglru_apply(jcfg, jp, jnp.asarray(x),
                                           return_state=True)
    got, (conv, h) = rglru.rglru_apply(cfg, p, _t(x), return_state=True)
    assert _err(got.numpy(), want) < BLOCK_TOL
    assert _err(conv.numpy(), wconv) < BLOCK_TOL
    assert _err(h.numpy(), wh) < BLOCK_TOL


def test_rglru_scan_matches_its_decode_steps():
    """The doubling scan against per-step decode updates, and each step
    against the reference's (``tests/test_attention.py``'s case)."""
    jcfg, cfg, jp, p = _block("recurrentgemma-9b", jrglru.rglru_specs, 0)
    x = (np.random.default_rng(1).standard_normal((2, 16, cfg.d_model))
         * 0.5).astype(np.float32)
    full, (conv_f, h_f) = rglru.rglru_apply(cfg, p, _t(x), return_state=True)
    w = cfg.rglru_width or cfg.d_model
    conv, h = torch.zeros((2, 3, w)), torch.zeros((2, w))
    jconv, jh = jnp.zeros((2, 3, w)), jnp.zeros((2, w))
    outs = []
    for t in range(16):
        o, (conv, h) = rglru.rglru_decode_step(cfg, p, _t(x[:, t:t + 1]),
                                               conv, h)
        jo, (jconv, jh) = jrglru.rglru_decode_step(
            jcfg, jp, jnp.asarray(x[:, t:t + 1]), jconv, jh)
        assert _err(o.numpy(), jo) < BLOCK_TOL, t
        outs.append(o)
    assert _err(torch.cat(outs, 1).numpy(), full.numpy()) < STEP_TOL
    assert _err(h.numpy(), h_f.numpy()) < STEP_TOL
    assert _err(conv.numpy(), conv_f.numpy()) < STEP_TOL
