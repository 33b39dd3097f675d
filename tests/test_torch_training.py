"""Port parity for the training path: ``cross_entropy``, ``loss`` and its
gradients for every family, remat, the kernels' ``autograd.Function``s,
the train / eval steps, the launcher and a train -> checkpoint -> serve
round trip, against ``repro`` on the CPU in float32 at smoke sizes.

Params come from the reference's ``init(PRNGKey(0))`` and cross by
``lm_params_from_numpy``; inputs come from numpy seeds; the reference runs
``attn_impl="naive"`` as its own tests do. Tolerances: losses 1e-5 (a
float32 mean of ~200 token NLLs near ln(512) = 6.2; measured <= 1e-6);
gradients leaf by leaf at rtol 1e-4 / atol 1e-5 (measured: the worst
leaf uses 1.1% of that bound, recurrentgemma's embedding); one train
step's params and metrics at 1e-5 (AdamW's first step moves each weight
by about lr, 1e-3, so 1e-5 is 1% of the move).
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import make_batch as jmake_batch  # noqa: E402
from repro.training import OptimizerConfig as JOptCfg  # noqa: E402
from repro.training import init_state as jinit_state  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.convert import (adamw_state_from_numpy,  # noqa: E402
                                 lm_params_from_numpy)
from repro_torch.kernels.ref import (flash_attention_ref,  # noqa: E402
                                     rmsnorm_ref)
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import attention as attn  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.storage import CheckpointManager  # noqa: E402
from repro_torch.training import (OptimizerConfig, init_state,  # noqa: E402
                                  make_eval_step, make_train_step)
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402

# the modules (the package re-exports each wrapper under its module's name)
flash_mod = importlib.import_module("repro_torch.kernels.flash_attention")
rmsnorm_mod = importlib.import_module("repro_torch.kernels.rmsnorm")

LOSS_TOL = 1e-5
RTOL, ATOL = 1e-4, 1e-5
STEP_TOL = 1e-5


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: np.asarray(tree, np.float32)}


def _assert_trees_close(got, want, rtol, atol, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in g:
        assert g[k].shape == w[k].shape, (what, k)
        np.testing.assert_allclose(g[k], w[k], rtol=rtol, atol=atol,
                                   err_msg=f"{what}: {k}")


def _np_tree(tree):
    return tree_map(lambda t: t.detach().numpy(), tree)


# -- cross entropy ------------------------------------------------------------

@pytest.mark.parametrize("mask", [None, "some", "none_kept"])
def test_cross_entropy_matches_reference(mask):
    """rtol 1e-6: a float32 sum of up to 51 NLLs (~11 each) taken in
    another order (measured 2.5e-7, two ulps)."""
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 17, 300)) * 4).astype(np.float32)
    labels = rng.integers(0, 300, (3, 17))
    m = None
    if mask == "some":
        m = (rng.random((3, 17)) > 0.4).astype(np.float32)
    elif mask == "none_kept":     # mask.sum() == 0: the max(., 1) guard
        m = np.zeros((3, 17), np.float32)
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
    got = layers.cross_entropy(torch.from_numpy(logits),
                               torch.from_numpy(labels),
                               None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))


def test_cross_entropy_takes_bf16_logits_in_float32():
    rng = np.random.default_rng(1)
    logits = torch.from_numpy(rng.standard_normal((2, 5, 64)).astype(
        np.float32)).to(torch.bfloat16)
    labels = torch.from_numpy(rng.integers(0, 64, (2, 5)))
    got = layers.cross_entropy(logits, labels)
    want = torch.nn.functional.cross_entropy(
        logits.float().reshape(-1, 64), labels.reshape(-1))
    assert got.dtype == torch.float32
    assert abs(float(got) - float(want)) < 1e-6


# -- loss and gradients, every family ---------------------------------------

FAMILIES = ["h2o-danube-1.8b", "olmoe-1b-7b", "mamba2-370m",
            "recurrentgemma-9b", "whisper-medium"]


def _batch(arch, seed=3, S=96):
    rng = np.random.default_rng(seed)
    if arch == "whisper-medium":
        return {"frames": rng.standard_normal((2, 32, 128)).astype(
            np.float32), "tokens": rng.integers(0, 512, (2, 32))}
    return {"tokens": rng.integers(0, 512, (2, S))}


def _jbatch(b):
    out = {"tokens": jnp.asarray(b["tokens"], jnp.int32)}
    if "frames" in b:
        out["frames"] = jnp.asarray(b["frames"])
    return out


def _tbatch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _pair(arch, layers_=None):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    if layers_:
        jcfg, cfg = (jcfg.replace(num_layers=layers_),
                     cfg.replace(num_layers=layers_))
    jm = jbuild(jcfg, attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    return jm, jparams, cfg, lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams))


def _grads(model, params, batch):
    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, metrics = model.loss(tracked, batch)
    leaves = tree_leaves(tracked)
    got = iter(torch.autograd.grad(loss, leaves))
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            tree_map(lambda _: next(got), params))


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_match_reference(arch):
    jm, jparams, cfg, params = _pair(arch)
    b = _batch(arch)
    (jloss, jmet), jgrads = jax.value_and_grad(jm.loss, has_aux=True)(
        jparams, _jbatch(b))
    m = build_model(cfg, attn_impl="naive")
    loss, met, grads = _grads(m, params, _tbatch(b))
    assert abs(float(loss) - float(jloss)) < LOSS_TOL
    for k in jmet:
        assert abs(float(met[k]) - float(jmet[k])) < LOSS_TOL, k
    _assert_trees_close(_np_tree(grads), jax.tree.map(np.asarray, jgrads),
                        RTOL, ATOL, f"{arch} grads")


def test_lm_loss_with_a_mask_matches_reference():
    jm, jparams, cfg, params = _pair("h2o-danube-1.8b")
    b = _batch("h2o-danube-1.8b", seed=4, S=40)
    mask = (np.random.default_rng(5).random((2, 40)) > 0.25).astype(
        np.float32)
    jl, _ = jm.loss(jparams, {**_jbatch(b), "mask": jnp.asarray(mask)})
    with torch.no_grad():
        gl, _ = build_model(cfg, attn_impl="naive").loss(
            params, {**_tbatch(b), "mask": torch.from_numpy(mask)})
    assert abs(float(gl) - float(jl)) < LOSS_TOL


def test_moe_loss_carries_the_aux_term():
    """olmoe's loss is ce + router_aux_coef * aux / 16-layer-count, with aux
    equal to the reference's."""
    jm, jparams, cfg, params = _pair("olmoe-1b-7b")
    b = _batch("olmoe-1b-7b", seed=8, S=48)
    jl, jmet = jm.loss(jparams, _jbatch(b))
    with torch.no_grad():
        gl, met = build_model(cfg, attn_impl="naive").loss(params,
                                                           _tbatch(b))
    assert float(met["aux"]) > 0.5
    assert abs(float(met["aux"]) - float(jmet["aux"])) < LOSS_TOL
    coef = cfg.moe.router_aux_coef
    assert abs(float(gl) - float(met["ce"] + coef * met["aux"])) < 1e-6


# -- remat --------------------------------------------------------------------

@pytest.mark.parametrize("arch,layers_", [("h2o-danube-1.8b", None),
                                          ("recurrentgemma-9b", 5),
                                          ("whisper-medium", None)])
@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gives_the_grads_of_no_remat(arch, layers_, policy):
    """recurrentgemma at 5 layers: one remat'd cycle and two plain
    remainder layers."""
    _, _, cfg, params = _pair(arch, layers_)
    b = _tbatch(_batch(arch, seed=6, S=48))
    l0, _, g0 = _grads(build_model(cfg.replace(remat_policy="none"),
                                   attn_impl="naive"), params, b)
    l1, _, g1 = _grads(build_model(cfg.replace(remat_policy=policy),
                                   attn_impl="naive"), params, b)
    assert float(l0) == float(l1)
    _assert_trees_close(_np_tree(g1), _np_tree(g0), 0, 1e-7, policy)


def test_remat_recomputes_only_while_autograd_records(monkeypatch):
    """A 'full' model under inference_mode or no_grad makes no checkpoint;
    with grad it checkpoints each layer once."""
    from repro_torch.models import transformer
    calls = []
    real = transformer.checkpoint

    def spy(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(transformer, "checkpoint", spy)
    _, _, cfg, params = _pair("h2o-danube-1.8b")
    m = build_model(cfg.replace(remat_policy="full"), attn_impl="naive")
    toks = torch.from_numpy(_batch("h2o-danube-1.8b", S=16)["tokens"])
    with torch.inference_mode():
        m.apply(params, toks)
    with torch.no_grad():
        m.apply(params, toks)
    assert calls == []
    _grads(m, params, {"tokens": toks})
    assert len(calls) == cfg.num_layers


# -- the stacked leaves, cut once ----------------------------------------------

# the param trees stacked [L, ...] over the layers
STACKS = ("dense_layers", "layers", "cycles", "enc_layers", "dec_layers")


def _cut_once_cfg(case):
    """The smoke configs of each layout of stacks: a dense LM; an MoE with
    a dense first layer and latent attention (Moonlight's layout, sigmoid
    routing, a shared expert); a hybrid of two cycles and a remainder;
    the encoder-decoder."""
    if case == "moe_mla":
        cfg = smoke_config("olmoe-1b-7b")
        return cfg.replace(
            num_layers=3, first_dense_layers=1,
            mla=MLAConfig(kv_lora_rank=32, qk_nope_head_dim=32,
                          qk_rope_head_dim=16, v_head_dim=16),
            moe=dataclasses.replace(
                cfg.moe, scoring="sigmoid", num_shared_experts=1,
                routed_scaling=2.5,
                selection_bias=tuple(0.01 * i for i in range(8))))
    if case == "hybrid":
        return smoke_config("recurrentgemma-9b").replace(num_layers=7)
    return smoke_config(case)


def _select_each_layer(stacked, n):
    """The route the cut replaced: layer i as ``v[i]`` of every leaf."""
    def pick(t, i):
        return {k: pick(v, i) if isinstance(v, dict) else v[i]
                for k, v in t.items()}
    return [pick(stacked, i) for i in range(n)]


@pytest.mark.parametrize("remat", ["none", "full"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["h2o-danube-1.8b", "moe_mla", "hybrid",
                                  "whisper-medium"])
def test_stacked_leaves_are_cut_once(monkeypatch, case, dtype, remat):
    """Each stacked leaf reaches the loss through exactly one
    ``UnbindBackward0`` and no ``SelectBackward0``, and its gradient is
    ``torch.equal`` to the one of the ``v[i]`` route (whose backward
    zero-fills and adds a whole stack a layer: adding zeros is exact)."""
    from repro_torch.models import encdec, transformer
    cfg = _cut_once_cfg(case).replace(dtype=dtype, param_dtype=dtype,
                                      remat_policy=remat)
    model = build_model(cfg, attn_impl="naive")
    params = model.init(torch.Generator().manual_seed(0))
    b = _tbatch(_batch("whisper-medium" if case == "whisper-medium"
                       else "h2o-danube-1.8b", seed=9, S=32))

    tracked = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss, _ = model.loss(tracked, b)
    stacked = tree_leaves({k: tracked[k] for k in STACKS if k in tracked})
    assert stacked
    feeds = {}    # a leaf -> the names of the nodes whose gradient it sums
    seen, todo = set(), [loss.grad_fn]
    while todo:
        node = todo.pop()
        if node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            if nxt is None:
                continue
            if hasattr(nxt, "variable"):
                feeds.setdefault(id(nxt.variable), []).append(node.name())
            todo.append(nxt)
    for leaf in stacked:
        assert feeds[id(leaf)] == ["UnbindBackward0"], feeds[id(leaf)]
    leaves = tree_leaves(tracked)
    got = torch.autograd.grad(loss, leaves)

    monkeypatch.setattr(transformer, "unstack", _select_each_layer)
    monkeypatch.setattr(encdec, "unstack", _select_each_layer)
    tracked2 = tree_map(lambda p: p.detach().requires_grad_(True), params)
    loss2, _ = model.loss(tracked2, b)
    want = torch.autograd.grad(loss2, tree_leaves(tracked2))
    assert torch.equal(loss.detach(), loss2.detach())
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)


# -- the kernels' autograd Functions -------------------------------------------

def _dense(shape, seed, scale=1.0):
    return torch.from_numpy((np.random.default_rng(seed).standard_normal(shape)
                             * scale).astype(np.float32))


def test_rmsnorm_function_grads_equal_plain_autograd():
    x, w, dy = _dense((37, 96), 0), _dense((96,), 1, 0.1), _dense((37, 96), 2)
    want = torch.autograd.grad(
        rmsnorm_ref(x.requires_grad_(), w.requires_grad_(), 1e-6), (x, w), dy)
    xs, ws = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = rmsnorm_mod.RMSNormFunction.apply(xs, ws, 1e-6)
    got = torch.autograd.grad(y, (xs, ws), dy)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # only x requires grad: w gets none
    xs = x.detach().requires_grad_()
    y = rmsnorm_mod.RMSNormFunction.apply(xs, w.detach(), 1e-6)
    (gx,) = torch.autograd.grad(y, (xs,), dy)
    torch.testing.assert_close(gx, want[0], rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal,window,Sq,Sk", [
    (True, None, 200, 200), (True, 48, 200, 200), (False, None, 64, 150),
    (False, None, 150, 64), (False, 33, 130, 130)])
@pytest.mark.parametrize("chunked", [False, True])
def test_flash_function_grads_equal_plain_autograd(monkeypatch, causal,
                                                   window, Sq, Sk, chunked):
    """The Function's backward against autograd through the plain version,
    on the model's strided [B, S, H, D] views; ``chunked`` cuts the
    backward into 64-row chunks of queries, whose k and v gradients are
    summed in another order (atol 1e-5 on gradients up to ~5; measured
    2.4e-6)."""
    if chunked:
        monkeypatch.setattr(flash_mod, "BACKWARD_SCORES", 1)
    B, Hq, Hkv, D = 2, 4, 2, 16
    q = _dense((B, Sq, Hq, D), 3)
    k, v = _dense((B, Sk, Hkv, D), 4), _dense((B, Sk, Hkv, D), 5)
    do = _dense((B, Hq, Sq, D), 6)

    def views():
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        return leaves, [t.transpose(1, 2) for t in leaves]

    leaves, (qv, kv, vv) = views()
    o = flash_attention_ref(qv, kv, vv, causal=causal, window=window)
    want = torch.autograd.grad(o, leaves, do)
    leaves, (qv, kv, vv) = views()
    o = flash_mod.FlashAttentionFunction.apply(qv, kv, vv, causal, window)
    got = torch.autograd.grad(o, leaves, do)
    for name, a, b in zip("qkv", got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5, msg=name)


def test_backward_chunks_are_multiples_of_64_rows():
    assert flash_mod._backward_rows(2, 32, 4096) == 1024
    assert flash_mod._backward_rows(1, 1, 1) % 64 == 0
    assert flash_mod._backward_rows(64, 64, 1 << 20) == 64


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-medium"])
def test_model_grads_through_the_functions_equal_the_plain_route(
        monkeypatch, arch):
    """With the model's rmsnorm and flash calls forced through their
    ``autograd.Function`` (the plain version on the CPU), the grads equal
    the plain route's."""
    _, _, cfg, params = _pair(arch)
    cfg = cfg.replace(remat_policy="full")
    b = _tbatch(_batch(arch, seed=7, S=64))
    _, _, want = _grads(build_model(cfg, attn_impl="naive",
                                    use_kernels=False), params, b)
    monkeypatch.setattr(layers, "rmsnorm_kernel",
                        lambda x, w, eps: rmsnorm_mod.RMSNormFunction.apply(
                            x, w, eps))
    monkeypatch.setattr(attn, "flash_attention",
                        lambda q, k, v, causal, window:
                        flash_mod.FlashAttentionFunction.apply(
                            q, k, v, causal, window))
    _, _, got = _grads(build_model(cfg, attn_impl="naive"), params, b)
    _assert_trees_close(_np_tree(got), _np_tree(want), RTOL, ATOL, arch)


# -- train / eval steps --------------------------------------------------------

def _ref_step(arch, accum, batch_rows=8, S=32):
    jm, jparams, cfg, params = _pair(arch)
    jbatch = jmake_batch(jsmoke(arch), JShape("s", S, batch_rows, "train"))
    jopt = JOptCfg(learning_rate=1e-3)
    jstate = jinit_state(jparams)
    jp1, js1, jout = jax.jit(jmake_train_step(jm, jopt, accum_steps=accum))(
        jparams, jstate, jbatch)
    batch = {k: torch.from_numpy(np.array(v)) for k, v in jbatch.items()}
    state = adamw_state_from_numpy(jax.tree.map(np.asarray, jstate))
    step = make_train_step(build_model(cfg, attn_impl="naive"),
                           OptimizerConfig(learning_rate=1e-3),
                           accum_steps=accum)
    p1, s1, out = step(params, state, batch)
    return (jp1, js1, jout), (p1, s1, out)


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-medium"])
@pytest.mark.parametrize("accum", [1, 4])
def test_train_step_matches_reference(arch, accum):
    (jp1, js1, jout), (p1, s1, out) = _ref_step(arch, accum)
    assert int(s1.step) == int(js1.step) == 1
    for k in ("loss", "grad_norm", "lr", "ce"):
        assert abs(float(out[k]) - float(jout[k])) < STEP_TOL, k
    _assert_trees_close(_np_tree(p1), jax.tree.map(np.asarray, jp1), 0,
                        STEP_TOL, "params")
    _assert_trees_close(_np_tree(s1.m), jax.tree.map(np.asarray, js1.m), 0,
                        STEP_TOL, "m")
    _assert_trees_close(_np_tree(s1.v), jax.tree.map(np.asarray, js1.v), 0,
                        STEP_TOL, "v")


def test_grad_accumulation_equivalence():
    """The reference's test: accum 4 against accum 1 on one batch."""
    _, _, cfg, params = _pair("granite-3-8b", 2)
    rng = np.random.default_rng(10)
    batch = {"tokens": torch.from_numpy(rng.integers(0, 512, (8, 32)))}
    m = build_model(cfg, attn_impl="naive")
    oc = OptimizerConfig(learning_rate=1e-3)
    p1, _, o1 = make_train_step(m, oc, 1)(params, init_state(params), batch)
    p4, _, o4 = make_train_step(m, oc, 4)(params, init_state(params), batch)
    assert abs(float(o1["loss"]) - float(o4["loss"])) < 1e-4
    diffs = [float((a.float() - b.float()).abs().max())
             for a, b in zip(tree_leaves(p1), tree_leaves(p4))]
    assert max(diffs) < 5e-3


def test_accumulation_needs_equal_micro_batches():
    _, _, cfg, params = _pair("h2o-danube-1.8b")
    step = make_train_step(build_model(cfg, attn_impl="naive"),
                           OptimizerConfig(), accum_steps=3)
    with pytest.raises(ValueError, match="micro-batches"):
        step(params, init_state(params),
             {"tokens": torch.zeros((4, 8), dtype=torch.long)})


def test_training_learns():
    """The reference's test: a 2-layer gemma-2b with a 128-token vocab
    overfits a fixed batch; the loss halves in 60 steps."""
    cfg = smoke_config("gemma-2b").replace(num_layers=2, vocab_size=128)
    m = build_model(cfg, attn_impl="naive")
    params = m.init(torch.Generator().manual_seed(0))
    opt = init_state(params)
    step = make_train_step(m, OptimizerConfig(
        learning_rate=3e-3, warmup_steps=5, total_steps=60, weight_decay=0.0))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(2).integers(0, 128, (4, 32)))}
    first = None
    for _ in range(60):
        params, opt, out = step(params, opt, batch)
        first = first if first is not None else float(out["loss"])
    assert float(out["loss"]) < first * 0.5, (first, float(out["loss"]))


def test_train_step_raises_on_a_param_cut_off_from_the_loss():
    _, _, cfg, params = _pair("h2o-danube-1.8b")
    params = {**params, "orphan": torch.zeros(4, 4)}
    step = make_train_step(build_model(cfg, attn_impl="naive"),
                           OptimizerConfig())
    with pytest.raises(RuntimeError, match="orphan"):
        step(params, init_state(params),
             {"tokens": torch.zeros((2, 8), dtype=torch.long)})


def test_train_step_updates_params_and_leaves_its_inputs():
    _, _, cfg, params = _pair("mamba2-370m")
    before = tree_map(lambda t: t.clone(), params)
    state = init_state(params)
    step = make_train_step(build_model(cfg, attn_impl="naive"),
                           OptimizerConfig(learning_rate=1e-3))
    p1, s1, out = step(params, state, _tbatch(_batch("mamba2-370m", S=32)))
    assert np.isfinite(float(out["loss"])) and np.isfinite(
        float(out["grad_norm"]))
    assert int(s1.step) == 1 and int(state.step) == 0
    moved = max(float((a - b).abs().max())
                for a, b in zip(tree_leaves(p1), tree_leaves(params)))
    assert moved > 0
    for a, b in zip(tree_leaves(params), tree_leaves(before)):
        assert torch.equal(a, b)


def test_eval_step_is_the_loss_without_a_graph():
    _, _, cfg, params = _pair("h2o-danube-1.8b")
    m = build_model(cfg, attn_impl="naive")
    b = _tbatch(_batch("h2o-danube-1.8b", S=24))
    out = make_eval_step(m)(params, b)
    loss, _ = m.loss(params, b)
    assert float(out["loss"]) == float(loss)
    assert out["loss"].grad_fn is None and set(out) == {"loss", "ce", "aux"}


# -- the launcher ----------------------------------------------------------------

def test_train_launcher_runs_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "6", "--batch", "4",
            "--seq", "64", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "3"]
    assert train_launcher.main(argv) == 0
    out = capsys.readouterr().out
    assert "step 0: loss=" in out and "step 5: loss=" in out
    assert "done: 6 steps" in out
    run = train_launcher.train(train_launcher.parse_args(
        argv[:-4] + ["--ckpt-dir", str(tmp_path / "b"), "--ckpt-every",
                     "100"]))
    assert run.step == 6 and len(run.losses) == 6
    assert all(np.isfinite(run.losses))
    assert np.isfinite(float(run.metrics["grad_norm"]))
    kinds = [k for k, _ in run.events]
    assert "failure" not in kinds and "restart" not in kinds
    assert int(run.opt.step) == 6
    # the first launcher's run left checkpoints at steps 3 and 6
    assert CheckpointManager(tmp_path / "gemma-2b").all_steps() == [3, 6]


def test_train_launcher_resumes_from_its_checkpoint(tmp_path, capsys):
    argv = ["--arch", "gemma-2b", "--smoke", "--steps", "4", "--batch", "2",
            "--seq", "32", "--device", "cpu", "--ckpt-dir", str(tmp_path),
            "--ckpt-every", "2"]
    train_launcher.main(argv)
    run = train_launcher.train(train_launcher.parse_args(
        argv[:4] + ["6"] + argv[5:]))
    assert run.events[0] == ("resume", {"step": 4})
    assert run.step == 6 and len(run.losses) == 2
    assert all(t.device.type == "cpu" for t in tree_leaves(run.params))


@pytest.mark.parametrize("mesh", ["host", "single", "multi"])
def test_train_launcher_refuses_a_mesh(mesh, tmp_path):
    """``--mesh host`` trains in a 1-rank world the launcher starts and
    stops (a 1 x 1 mesh); the production meshes refuse a world that is
    not their 256 / 512 ranks, and leave no process group behind."""
    import torch.distributed as dist
    base = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--steps",
            "2", "--batch", "2", "--seq", "32", "--ckpt-dir"]
    argv = base + [str(tmp_path), "--mesh", mesh]
    if mesh == "host":
        run = train_launcher.train(train_launcher.parse_args(argv))
        off = train_launcher.train(train_launcher.parse_args(
            base + [str(tmp_path / "none")]))
        assert run.params["final_norm"].device_mesh.shape == (1, 1)
        np.testing.assert_allclose(run.losses, off.losses, rtol=0,
                                   atol=1e-5)
    else:
        ranks = {"single": 256, "multi": 512}[mesh]
        with pytest.raises(ValueError, match=f"needs {ranks} ranks"):
            train_launcher.main(argv)
    assert not dist.is_initialized()


def test_train_launcher_needs_cuda_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train_launcher.main(["--arch", "gemma-2b", "--smoke", "--steps", "1",
                             "--ckpt-dir", str(tmp_path)])


# -- train, checkpoint, serve ------------------------------------------------------

def test_train_checkpoint_serve_roundtrip(tmp_path):
    """The reference's ``test_train_checkpoint_serve_roundtrip``: a 2-layer
    h2o-danube trains 8 steps, is checkpointed and restored, and both
    copies decode the same logits within 2e-6."""
    cfg = smoke_config("h2o-danube-1.8b").replace(num_layers=2)
    m = build_model(cfg, attn_impl="naive")
    params = m.init(torch.Generator().manual_seed(0))
    opt = init_state(params)
    step = make_train_step(m, OptimizerConfig(learning_rate=1e-3))
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 32)))}
    for _ in range(8):
        params, opt, out = step(params, opt, batch)
    cm = CheckpointManager(tmp_path)
    cm.save(8, {"params": params})
    got, s = cm.restore({"params": params})
    assert s == 8
    restored = tree_map(lambda a: torch.from_numpy(np.array(a)),
                        got["params"])
    tokens = batch["tokens"][:, :16]
    with torch.inference_mode():
        _, state = m.prefill(params, tokens, max_len=20)
        l1, _ = m.decode_step(params, state, tokens[:, -1:])
        _, state2 = m.prefill(restored, tokens, max_len=20)
        l2, _ = m.decode_step(restored, state2, tokens[:, -1:])
    assert float((l1 - l2).abs().max()) < 2e-6
