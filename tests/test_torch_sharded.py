"""Port parity for the sharded LM: logical axes, DTensor annotations, the
sharded train step, expert-parallel MoE and ``launch/train.py --mesh``.

- Axes and stand-ins: ``param_axes()`` of every registered config's smoke
  model (whisper's included) equals the reference's tuple for tuple;
  ``input_specs``, ``abstract_params``, ``abstract_state`` and
  ``state_axes`` match the reference's ``ShapeDtypeStruct``s in shape and
  dtype, as ``meta`` tensors.
- ``lshard``: a no-op without rules, ``to_placements``' placements on a
  DTensor, a rank mismatch refused (a 1-rank gloo group).
- ``kv_head_slice``: every (Hq, Hkv, tp) a registered config allows.
- ``unstack`` in a 2-rank gloo group on (2, 1) and (1, 2) meshes
  (danube, recurrentgemma's cycles, whisper's two stacks): each layer's
  piece keeps its DTensor leaf's placements and local slice; the train
  step's gradients (remat ``"full"``) equal the unsharded ones at 1e-5.
- One module-scoped 4-rank gloo group (spawned ranks, no jax) runs the
  reference test's case on a (2, 2) mesh: granite-3-8b smoke, 2 layers,
  ``ShapeConfig('s', 32, 8, 'train')``. The port's sharded step is held to
  the reference's single-device ``jax.jit(step)`` on the same numpy params
  at the reference test's bounds (loss 1e-4, params 5e-3), and to the
  port's own unsharded step at 1e-5 (the same float32 math summed in
  another order; one AdamW step moves a weight by about lr, 1e-3). The
  kernel route, forced through the kernels' ``autograd.Function``s on the
  CPU, calls them on local tensors as often as off the mesh; remat
  ``"full"`` gives the same step. EP ``moe_apply`` at (1, 4) and (2, 2)
  against the reference's ``moe_dense`` (olmoe smoke, x (4, 16, d) * 0.5):
  y at 1e-4, aux at 1e-5, and the gradient of ``sum(y * ct) + 3 aux``
  against ``jax.grad`` of the dense function at 1e-5 (``jax.grad`` through
  the reference's own EP branch equals it; no copy drops at this size).
  ``launch.train --mesh host`` in that world: 3 steps whose losses equal
  the ``--mesh none`` run's within 1e-4. One step of every other family's
  smoke model (gemma-2b with its heads replicated, olmoe with EP inside
  the LM, mamba2, recurrentgemma, whisper) on the mesh equals its step
  off the mesh at 1e-5. gemma-2b (2 q heads whole over a 4-wide
  ``"model"`` axis, (1, 4)), mamba2 (SSD heads split) and recurrentgemma
  (RG-LRU width split) each take one step from the reference's params,
  held to the reference's ``jax.jit(step)`` at its test's bounds, and each
  rank's SSD / scan / attention input is its share.
- The vocab-split cross entropy (logits split over ``"model"`` on their
  vocab, padding slots at -1e9) and embedding lookup (table split over
  its vocab and FSDP dim) on the (2, 2) mesh against the plain ones:
  loss 1e-6, gradients 1e-5; a dispatch mode on each rank sees no local
  op make a tensor with the whole padded vocab.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import _torch_dist_workers as W  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.models import build_model as jbuild  # noqa: E402
from repro.models import input_specs as jinput_specs  # noqa: E402
from repro.models import make_batch as jmake_batch  # noqa: E402
from repro.models.moe import moe_dense as jmoe_dense  # noqa: E402
from repro.models.moe import moe_specs as jmoe_specs  # noqa: E402
from repro.models.spec import init_params as jinit_params  # noqa: E402
from repro.training import OptimizerConfig as JOptCfg  # noqa: E402
from repro.training import abstract_state as jabstract_state  # noqa: E402
from repro.training import init_state as jinit_state  # noqa: E402
from repro.training import make_train_step as jmake_train_step  # noqa: E402
from repro.training import state_axes as jstate_axes  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.distributed.sharding import (axis_rules, lshard,  # noqa: E402
                                              make_rules, to_placements)
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import build_model, input_specs  # noqa: E402
from repro_torch.models.attention import kv_head_slice  # noqa: E402
from repro_torch.training import abstract_state, state_axes  # noqa: E402

GROUP_TIMEOUT_S = 120.0
LOSS_TOL, PARAM_TOL = 1e-4, 5e-3        # the reference test's bounds
# a first AdamW step in warm-up moves each param by about lr / 100 = 1e-5,
# whatever its gradient's size: the gradients themselves are held, each
# leaf within FAMILY_GRAD_RTOL of its largest reference value
FAMILY_GRAD_RTOL = 1e-4
SELF_TOL = 1e-5                         # against the port's unsharded step
Y_TOL, AUX_TOL, GRAD_TOL = 1e-4, 1e-5, 1e-5
ARCH = "granite-3-8b"
LAUNCHER_ARGV = ["--arch", "h2o-danube-1.8b", "--smoke", "--device", "cpu",
                 "--steps", "3", "--batch", "8", "--seq", "64",
                 "--ckpt-every", "100", "--log-every", "100"]


def _pairs(ref_tree, port_tree, path=""):
    """(path, reference leaf, port leaf) for every leaf of two trees."""
    if isinstance(ref_tree, dict):
        assert set(ref_tree) == set(port_tree), path
        for k in ref_tree:
            yield from _pairs(ref_tree[k], port_tree[k], f"{path}/{k}")
    else:
        yield path, ref_tree, port_tree


def _max_err(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float32)
                        - np.asarray(b, np.float32)).max())


# -- axes and stand-ins ------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_param_axes_and_abstract_params_match_reference(arch):
    jm, m = jbuild(jsmoke(arch)), build_model(smoke_config(arch))
    leaves = list(_pairs(jm.param_axes(), m.param_axes()))
    assert leaves
    for path, a, b in leaves:
        assert isinstance(b, tuple) and tuple(a) == b, path
    for path, a, b in _pairs(jm.abstract(), m.abstract()):
        assert b.device.type == "meta", path
        assert tuple(a.shape) == tuple(b.shape), path
        assert str(a.dtype) == str(b.dtype).replace("torch.", ""), path


@pytest.mark.parametrize("arch", ["h2o-danube-1.8b", "whisper-medium"])
@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_input_specs_and_state_stand_ins_match_reference(arch, opt_dtype):
    jcfg, cfg = jsmoke(arch), smoke_config(arch)
    shape = (JShape("s", 32, 8, "train"), ShapeConfig("s", 32, 8, "train"))
    want, got = jinput_specs(jcfg, shape[0], 4), input_specs(cfg, shape[1], 4)
    assert set(want) == set(got)
    for k in want:
        assert got[k].device.type == "meta"
        assert tuple(got[k].shape) == tuple(want[k].shape), k
        assert str(got[k].dtype) == "torch." + str(want[k].dtype), k
    jm, m = jbuild(jcfg), build_model(cfg)
    js, s = jabstract_state(jm.abstract(), opt_dtype), \
        abstract_state(m.abstract(), opt_dtype)
    assert s.step.device.type == "meta" and s.step.dtype == torch.int32
    assert tuple(s.step.shape) == tuple(js.step.shape) == ()
    for tree, jtree in ((s.m, js.m), (s.v, js.v)):
        for path, a, b in _pairs(jtree, tree):
            assert b.device.type == "meta", path
            assert tuple(a.shape) == tuple(b.shape), path
            assert str(b.dtype) == "torch." + str(a.dtype), path
    jax_, ax = jstate_axes(jm.param_axes()), state_axes(m.param_axes())
    assert ax.step == jax_.step == ()
    for jt, t in ((jax_.m, ax.m), (jax_.v, ax.v)):
        for path, a, b in _pairs(jt, t):
            assert tuple(a) == b, path


# -- lshard ------------------------------------------------------------------

def test_lshard_is_a_no_op_without_rules_and_checks_rank():
    x = torch.ones(2, 3)
    assert lshard(x, "batch", "act_embed") is x
    with axis_rules(make_rules()):
        assert lshard(x, "batch", "act_embed") is x   # not a DTensor
        with pytest.raises(ValueError, match="rank"):
            lshard(x, "batch")


def test_carry_rules_installs_the_callers_rules_in_another_thread():
    """A remat recompute runs in autograd's device thread on the card,
    where the caller's (thread-local) rules are not installed."""
    import threading

    from repro_torch.distributed.sharding import _current, carry_rules
    rules, seen = make_rules(), []
    with axis_rules(rules):
        plain = _current
        carried = carry_rules(_current)
    for fn in (plain, carried):
        t = threading.Thread(target=lambda: seen.append(fn()))
        t.start()
        t.join(10)
        assert not t.is_alive()
    assert seen == [None, rules]
    assert carry_rules(len) is len          # no rules: the function itself


def test_lshard_places_a_dtensor(tmp_path):
    out = W.run_group(W.lshard_cases, 1, tmp_path, timeout=GROUP_TIMEOUT_S)[0]
    names = ("data", "model")
    rules = make_rules()
    assert out["embed"] == to_placements(("batch", "seq", "act_embed"),
                                         rules, names)
    assert out["embed"] == (Shard(0), Replicate())
    assert out["heads"] == (Shard(0), Shard(2))
    assert out["partial_reduced"] == (Shard(0), Replicate())
    assert out["partial_value"] == pytest.approx(6.0)
    assert "rank" in out["rank_error"]
    assert out["no_rules_same"]


CUT_ARCHS = ("h2o-danube-1.8b", "recurrentgemma-9b", "whisper-medium")


@pytest.fixture(scope="module")
def cut_world(tmp_path_factory):
    return W.run_group(W.unstack_cases, 2, tmp_path_factory.mktemp("cut"),
                       CUT_ARCHS, timeout=GROUP_TIMEOUT_S)[0]


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
@pytest.mark.parametrize("arch", CUT_ARCHS)
def test_unstack_keeps_placements_and_grads_on_a_2_device_mesh(
        cut_world, arch, shape):
    """Each stack cut once on a 2-device mesh: every layer's piece of a
    stacked DTensor leaf keeps its leaf's placements (the layers dim is
    never split) and its local slice, and the train step's gradients
    equal the unsharded ones at 1e-5."""
    r = cut_world[(arch, shape)]
    assert r["placed"]
    assert r["split"] > 0           # some stacked leaf is split on the mesh
    assert r["grad_gap"] < SELF_TOL, r["grad_gap"]


# -- the GQA kv-head slice ---------------------------------------------------

def _allowed():
    """(Hq, Hkv, tp) for every registered config and every tp that splits
    its q heads into whole GQA groups or whole shares of one."""
    out = set()
    for arch in list_archs():
        for cfg in (get_config(arch), smoke_config(arch)):
            hq, hkv = cfg.num_heads, cfg.num_kv_heads
            g = hq // hkv
            for tp in range(1, hq + 1):
                if hq % tp == 0 and ((hq // tp) % g == 0 or g % (hq // tp)
                                     == 0):
                    out.add((hq, hkv, tp))
    return sorted(out)


@pytest.mark.parametrize("hq,hkv,tp", _allowed())
def test_kv_head_slice_pairs_each_q_head_with_its_kv_head(hq, hkv, tp):
    g, local = hq // hkv, hq // tp
    for r in range(tp):
        sl = kv_head_slice(hq, hkv, tp, r)
        heads = range(r * local, (r + 1) * local)
        # the local head map (h_local // (local / n_kv)) reads the global one
        n_kv = sl.stop - sl.start
        assert local % n_kv == 0
        for i, h in enumerate(heads):
            assert sl.start + i // (local // n_kv) == h // g, (r, h)


def test_kv_head_slice_refuses_uneven_splits():
    with pytest.raises(ValueError, match="straddle"):
        kv_head_slice(12, 3, 4, 0)      # 3 heads a shard, groups of 4
    with pytest.raises(ValueError, match="even split"):
        kv_head_slice(4, 2, 3, 0)


# -- the 4-rank world --------------------------------------------------------

# the vocab-split loss and lookup: V 96 slots, the last 6 padding (masked
# to -1e9 as logits_from_hidden masks them), 4 rows of 6 positions, d 20
VOCAB, PADDED, CE_TOL, CE_GRAD_TOL = 90, 96, 1e-6, 1e-5
# the repaired families' sharded steps against the reference's: gemma with
# fewer q heads (2) than the "model" axis (4), kept whole over it; mamba2
# (16 SSD heads) and recurrentgemma (RG-LRU width 128) split over (2, 2)
FAMILY_STEPS = {"gemma-2b": ({"num_heads": 2}, (1, 4)),
                "mamba2-370m": ({}, (2, 2)),
                "recurrentgemma-9b": ({}, (2, 2))}


def _vocab_inputs():
    rng = np.random.default_rng(21)
    logits = rng.standard_normal((4, 6, PADDED)).astype(np.float32) * 3
    logits[..., VOCAB:] = -1e9
    labels = rng.integers(0, VOCAB, (4, 6))
    mask = (rng.random((4, 6)) > 0.3).astype(np.float32)
    table = rng.standard_normal((PADDED, 20)).astype(np.float32)
    tokens = rng.integers(0, VOCAB, (4, 6))
    ct = rng.standard_normal((4, 6, 20)).astype(np.float32)
    return logits, labels, mask, table, tokens, ct

@pytest.fixture(scope="module")
def world(tmp_path_factory):
    root = tmp_path_factory.mktemp("sharded")
    jcfg = jsmoke(ARCH).replace(num_layers=2)
    jm = jbuild(jcfg, attn_impl="naive")
    jparams = jm.init(jax.random.PRNGKey(0))
    jbatch = jmake_batch(jcfg, JShape("s", 32, 8, "train"))
    step = jmake_train_step(jm, JOptCfg(learning_rate=1e-3))
    jp1, _, jout = jax.jit(step)(jparams, jinit_state(jparams), jbatch)

    mcfg = jsmoke("olmoe-1b-7b")
    mp = jinit_params(jmoe_specs(mcfg), jax.random.PRNGKey(3), "float32")
    x = jax.random.normal(jax.random.PRNGKey(4), (4, 16, mcfg.d_model)) * 0.5
    ct = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    yd, auxd = jmoe_dense(mcfg, mp, x)

    def dense_loss(x, p):
        y, aux = jmoe_dense(mcfg, p, x)
        return jnp.sum(y * ct) + 3.0 * aux

    gx, gp = jax.grad(dense_loss, argnums=(0, 1))(x, mp)

    fam_cases, fam_ref = {}, {}
    for arch, (ov, shape) in FAMILY_STEPS.items():
        fcfg = jsmoke(arch).replace(**ov)
        fm = jbuild(fcfg, attn_impl="naive")
        fp = fm.init(jax.random.PRNGKey(11))
        fbatch = jmake_batch(fcfg, JShape("s", 64, 4, "train"))
        fstep = jmake_train_step(fm, JOptCfg(learning_rate=1e-3))
        fp1, _, fout = jax.jit(fstep)(fp, jinit_state(fp), fbatch)
        fgrads = jax.jit(jax.grad(lambda p, b: fm.loss(p, b)[0]))(fp, fbatch)
        fam_cases[arch] = (ov, shape, jax.tree.map(np.asarray, fp),
                           np.asarray(fbatch["tokens"]))
        fam_ref[arch] = (float(fout["loss"]), jax.tree.map(np.asarray, fp1),
                         jax.tree.map(np.asarray, fgrads))

    ranks = W.run_group(
        W.sharded_lm, 4, root / "group", ARCH, 2,
        jax.tree.map(np.asarray, jparams), np.asarray(jbatch["tokens"]),
        jax.tree.map(np.asarray, mp), np.asarray(x), ct,
        LAUNCHER_ARGV + ["--ckpt-dir", str(root / "mesh")], _vocab_inputs(),
        fam_cases, timeout=GROUP_TIMEOUT_S)
    off = train_launcher.train(train_launcher.parse_args(
        LAUNCHER_ARGV + ["--ckpt-dir", str(root / "none")]))
    return SimpleNamespace(
        ranks=ranks, out=ranks[0], ref_loss=float(jout["loss"]),
        ref_params=jax.tree.map(np.asarray, jp1), yd=np.asarray(yd),
        auxd=float(auxd),
        dgrads=[np.asarray(gx)] + [np.asarray(gp[k]) for k in sorted(gp)],
        off_losses=off.losses, fam_ref=fam_ref)


@pytest.mark.parametrize("route", ["plain", "kernels", "remat"])
def test_sharded_train_step_matches_reference_single_device(world, route):
    r = world.out[route]
    assert abs(r["loss"] - world.ref_loss) < LOSS_TOL, route
    md = max(_max_err(b, a) for _, a, b in
             _pairs(world.ref_params, r["params"]))
    assert md < PARAM_TOL, (route, md)


@pytest.mark.parametrize("route", ["plain", "kernels", "remat"])
def test_sharded_train_step_matches_unsharded_port(world, route):
    r = world.out[route]
    assert abs(r["loss"] - r["off_loss"]) < SELF_TOL
    for path, a, b in _pairs(r["off_params"], r["params"]):
        assert _max_err(a, b) < SELF_TOL, (route, path)
    # params and moments come back in the params' placements
    assert r["placed"] and r["moments_placed"]
    # every rank holds the same whole values
    for other in world.ranks[1:]:
        assert other[route]["loss"] == r["loss"]


def test_kernel_route_runs_the_functions_on_local_shards(world):
    """Each rmsnorm / flash call got plain (local) tensors, and the mesh
    step made exactly the calls of the step off the mesh: 2 layers x 2
    norms + the final norm, and one flash call a layer."""
    r = world.out["kernels"]
    assert r["calls"] == r["off_calls"] == {"rmsnorm": 5,
                                            "flash_attention": 2}
    assert world.out["plain"]["calls"] == {"rmsnorm": 0,
                                           "flash_attention": 0}


@pytest.mark.parametrize("shape", ["(1, 4)", "(2, 2)"])
def test_ep_moe_matches_reference_dense(world, shape):
    r = world.out[f"ep{shape}"]
    assert _max_err(r["y"], world.yd) < Y_TOL
    assert abs(r["aux"] - world.auxd) < AUX_TOL
    # the reference's out spec: rows split over data, whole over model
    assert r["y_placements"] == (Shard(0), Replicate())


@pytest.mark.parametrize("shape", ["(1, 4)", "(2, 2)"])
def test_ep_moe_gradient_is_the_single_device_gradient(world, shape):
    got = world.out[f"ep{shape}"]["grads"]
    for name, g, want in zip(["x", "router", "wg", "wi", "wo"], got,
                             world.dgrads):
        assert _max_err(g, want) < GRAD_TOL, (shape, name)


def test_launcher_on_the_host_mesh_matches_no_mesh(world):
    r = world.out["launcher"]
    assert r["mesh"] == (2, 2)
    assert len(r["losses"]) == len(world.off_losses) == 3
    for a, b in zip(r["losses"], world.off_losses):
        assert abs(a - b) < 1e-4


@pytest.mark.parametrize("arch", W.FAMILY_ARCHS)
def test_every_family_trains_on_the_mesh(world, arch):
    r = world.out["families"][arch]
    assert abs(r["loss"] - r["off_loss"]) < SELF_TOL, arch
    assert r["gap"] < SELF_TOL, arch


@pytest.mark.parametrize("case", ["ce", "ce_masked"])
def test_vocab_split_cross_entropy_matches_plain(world, case):
    """Each rank reduces its own vocab slice (max, then sum of exp and the
    gold logit, each over "model"); the loss and the logits' gradient are
    the plain cross entropy's, and no op on a rank makes a tensor with the
    whole padded vocab."""
    from repro_torch.models.layers import cross_entropy
    logits, labels, mask, *_ = _vocab_inputs()
    lg = torch.from_numpy(logits).requires_grad_()
    loss = cross_entropy(lg, torch.from_numpy(labels),
                         torch.from_numpy(mask) if case == "ce_masked"
                         else None)
    g, = torch.autograd.grad(loss, [lg])
    for r in world.ranks:
        got = r["vocab"][case]
        assert abs(got["loss"] - float(loss.detach())) < CE_TOL
        assert _max_err(got["grad"], g.numpy()) < CE_GRAD_TOL
        assert got["shapes"] and all(PADDED not in shp
                                     for shp in got["shapes"])
        assert (4 // 2, 6, PADDED // 2) in got["shapes"]


def test_vocab_split_lookup_matches_plain(world):
    """Each rank reads its vocab slice's rows (others zero) and the pieces
    sum over "model"; the table's gradient stays in its placements."""
    *_, table, tokens, ct = _vocab_inputs()
    tab = torch.from_numpy(table).requires_grad_()
    x = tab[torch.from_numpy(tokens)]
    g, = torch.autograd.grad((x * torch.from_numpy(ct)).sum(), [tab])
    for r in world.ranks:
        got = r["vocab"]["lookup"]
        assert _max_err(got["x"], x.detach().numpy()) < CE_TOL
        assert _max_err(got["grad"], g.numpy()) < CE_GRAD_TOL
        assert got["grad_placements"] == (Shard(1), Shard(0))
        assert all(PADDED not in shp for shp in got["shapes"])


@pytest.mark.parametrize("arch", list(FAMILY_STEPS))
def test_family_sharded_step_matches_reference_single_device(world, arch):
    """gemma's replicated heads, mamba2's split SSD heads and
    recurrentgemma's split RG-LRU width: one sharded step equals the
    reference's jax.jit step at the reference test's bounds, every
    gradient it updates with is the reference's jax.grad leaf by leaf
    (the backward through the split cores, the gathers' reduce-scatters
    and the gated norm's all-reduce), and each rank's core took its
    share."""
    loss, params, grads = world.fam_ref[arch]
    r = world.out["family_steps"][arch]
    assert abs(r["loss"] - loss) < LOSS_TOL
    md = max(_max_err(b, a) for _, a, b in _pairs(params, r["params"]))
    assert md < PARAM_TOL, (arch, md)
    for path, a, b in _pairs(grads, r["grads"]):
        scale = float(np.abs(a).max())
        assert scale > 0, (arch, path)
        assert _max_err(b, a) <= FAMILY_GRAD_RTOL * scale, (
            arch, path, _max_err(b, a), scale)
    seen = r["inputs"]
    if arch == "gemma-2b":
        # (1, 4): the 2 heads whole on each rank, as the reference's
        # compiled step keeps them (every model rank attends all rows)
        assert set(seen["attend"]) == {(4, 64, 2, 32)}
    elif arch == "mamba2-370m":
        # 16 SSD heads of 16 channels, 8 a rank; 2 rows a data shard
        assert seen["ssd"] and set(seen["ssd"]) == {(2, 64, 8, 16)}
    else:
        # the RG-LRU width 128, 64 a rank; 4 q heads, 2 a rank
        assert seen["scan"] and set(seen["scan"]) == {(2, 64, 64)}
        assert set(seen["attend"]) == {(2, 64, 2, 32)}
