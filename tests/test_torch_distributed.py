"""Port parity for ``repro_torch.distributed`` and the ``torch.distributed``
meshes of ``repro_torch.launch.mesh``.

- Sharding tables: ``to_pspec`` / ``tree_pspecs`` give the reference's
  specs for every registered config's parameters and batch under
  ``rules_for_config`` (single and multi-pod) and for ``serving_rules``;
  ``to_placements`` gives the DTensor placements each spec denotes.
- ``compressed_all_reduce`` in a 2-rank gloo group (spawned processes, a
  ``FileStore``) against the reference's bounds and against the
  reference's ``compressed_psum`` under ``shard_map`` on 2 simulated host
  devices (a subprocess, as ``tests/test_distributed.py`` runs it), within
  1e-6 on the same numpy inputs; ``make_host_mesh(2, 1)`` in that world.
- ``gpipe_apply`` in a 4-rank gloo group at the reference test's sizes
  (S 4, 2 layers a stage, D 16, M 8, microbatch 4): forward within 1e-5
  and each rank's stage gradient within 1e-4 of the reference's
  sequential run and its ``jax.grad`` on the same numpy weights.

Every group has a deadline of its own (60 s), so a hang fails its test.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
from jax.sharding import PartitionSpec as RP  # noqa: E402
from torch.distributed.tensor import Replicate, Shard  # noqa: E402

import _torch_dist_workers as W  # noqa: E402
import repro.distributed.sharding as RS  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.models import batch_axes as rbatch_axes  # noqa: E402
from repro.models import build_model as rbuild_model  # noqa: E402
import repro_torch.distributed as PD  # noqa: E402
import repro_torch.distributed.sharding as PS  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.mesh import ServingMesh  # noqa: E402
from repro_torch.models import batch_axes, build_model  # noqa: E402
from repro_torch.models.spec import tree_map_specs  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
GROUP_TIMEOUT_S = 60.0


# -- sharding tables ---------------------------------------------------------

def _pairs(ref_tree, port_tree, path=""):
    """(path, reference spec, port spec) for every leaf of two trees."""
    if isinstance(ref_tree, dict):
        assert set(ref_tree) == set(port_tree), path
        for k in ref_tree:
            yield from _pairs(ref_tree[k], port_tree[k], f"{path}/{k}")
    else:
        yield path, ref_tree, port_tree


def _want_placements(spec, names):
    """The placements a spec denotes, built from its entries directly."""
    want = [Replicate()] * len(names)
    for d, part in enumerate(spec):
        for a in ((part,) if isinstance(part, str) else part or ()):
            want[names.index(a)] = Shard(d)
    return tuple(want)


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_archs())
def test_param_and_batch_pspecs_match_reference(arch, multi_pod):
    rcfg, cfg = rget_config(arch), get_config(arch)
    rrules = RS.rules_for_config(rcfg, multi_pod=multi_pod)
    rules = PS.rules_for_config(cfg, multi_pod=multi_pod)
    assert rules == rrules
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    mesh = SimpleNamespace(mesh_dim_names=names)
    # the port's models carry the reference's logical axes
    axes = tree_map_specs(lambda s: s.axes, build_model(cfg).specs())
    raxes = rbuild_model(rcfg).param_axes()
    for path, a, b in _pairs(raxes, axes):
        assert tuple(a) == tuple(b), path
    for tree, rtree in ((axes, raxes), (batch_axes(cfg), rbatch_axes(rcfg))):
        want = RS.tree_pspecs(rtree, rrules)
        got = PS.tree_pspecs(tree, rules)
        plc = PS.tree_shardings(mesh, tree, rules)
        leaves = list(_pairs(want, got))
        assert leaves
        for (path, w, g), (_, _, pl) in zip(leaves, _pairs(want, plc)):
            assert isinstance(w, RP) and isinstance(g, PS.PartitionSpec)
            assert tuple(g) == tuple(w), path
            assert pl == _want_placements(tuple(w), names), path


def test_serving_rules_and_shardings_match_reference():
    rr, pr = RS.serving_rules(), PS.serving_rules()
    assert pr == rr and PS.SERVING_MESH_AXES == RS.SERVING_MESH_AXES
    for axes in [("batch", "act_embed"), ("embed", "mlp"), ("embed",),
                 ("vocab", None), (None, None, None), ()]:
        assert tuple(PS.to_pspec(axes, pr)) == tuple(RS.to_pspec(axes, rr))
    mesh = ServingMesh((torch.device("cpu"),) * 2)
    assert PS.serving_batch_sharding(mesh) == (Shard(0),)
    for ndim in (1, 2, 3):
        assert PS.serving_weight_sharding(mesh, ndim) == (Replicate(),)


def test_axis_rules_and_placement_errors():
    rules = PS.make_rules(multi_pod=True)
    assert PS._current() is None and PS.current_mesh() is None
    assert PS.to_pspec(("batch", "embed")) == PS.PartitionSpec()
    with PS.axis_rules(rules, mesh="m"):
        assert tuple(PS.to_pspec(("batch", "embed"))) == \
            (("pod", "data"),)
        assert PS.current_mesh() == "m"
        with PS.axis_rules(PS.serving_rules()):
            assert tuple(PS.to_pspec(("batch",))) == ("data",)
        assert PS._current() is rules
    assert PS._current() is None
    # one mesh axis appears once in a spec, as in the reference
    assert tuple(PS.to_pspec(("embed", "batch"), rules)) == \
        tuple(RS.to_pspec(("embed", "batch"), rules)) == (("pod", "data"),)
    assert PS.to_placements(("batch", "mlp"), rules,
                            ("pod", "data", "model")) == \
        (Shard(0), Shard(0), Shard(1))
    with pytest.raises(ValueError, match="not in the mesh"):
        PS.to_placements(("batch",), rules, ("data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        PS.to_placements(("batch",), rules, ("data", "pod", "model"))
    assert repr(PS.to_pspec(("batch",), rules)) == \
        "PartitionSpec(('pod', 'data'),)"


def test_compression_ratio_matches_reference():
    shapes = {"w": (8, 64), "b": (16,), "s": ()}
    g = {k: np.zeros(s, np.float32) for k, s in shapes.items()}
    from repro.distributed.compression import compression_ratio as rratio
    want = rratio({k: jnp.asarray(v) for k, v in g.items()})
    got = PD.compression_ratio({k: torch.from_numpy(v) for k, v in g.items()})
    assert got == pytest.approx(want, rel=1e-12)
    assert PD.pipeline_bubble_fraction(8, 4) == pytest.approx(3 / 11,
                                                              abs=1e-9)


def test_compressed_all_reduce_single_rank_is_one_quantisation_step(
        tmp_path):
    """In a world of one, the reduction is the rank's own dequantised
    gradient: within half a step of it, the residual the rest."""
    g = {"w": torch.from_numpy(np.random.default_rng(3).standard_normal(
        (4, 32)).astype(np.float32))}
    out = W.run_group(W.one_rank_compress, 1, tmp_path, g,
                      timeout=GROUP_TIMEOUT_S)[0]
    step = float(g["w"].abs().max()) / 127.0
    assert float((out["red"]["w"] - g["w"]).abs().max()) <= step / 2 + 1e-7
    assert torch.allclose(out["red"]["w"] + out["resid"]["w"], g["w"],
                          atol=1e-6)
    assert torch.equal(out["plain"]["w"], g["w"])


# -- 2 ranks: compression, host mesh -----------------------------------------

def _grads(world: int):
    """The reference test's per-rank gradients (a [64] weight and a 5x
    [16] bias a rank), from numpy."""
    rng = np.random.default_rng(0)
    return {"w": rng.standard_normal((world, 64)).astype(np.float32),
            "b": (rng.standard_normal((world, 16)) * 5).astype(np.float32)}


_REF_PSUM = """
    import numpy as np, jax
    from jax.sharding import PartitionSpec as P
    from repro.distributed.compression import compressed_psum, init_ef_state
    from repro.distributed.sharding import shard_map
    from repro.launch.mesh import make_host_mesh

    g = dict(np.load({path!r}))
    mesh = make_host_mesh(2, 1)

    def make(enabled):
        def f(g):
            gl = {{k: v[0] for k, v in g.items()}}
            red, ef = compressed_psum(gl, init_ef_state(gl), 'data',
                                      enabled=enabled)
            return red, {{k: v[None] for k, v in ef.residual.items()}}
        spec = {{k: P('data', None) for k in g}}
        return shard_map(f, mesh=mesh, in_specs=(spec,),
                         out_specs=({{k: P() for k in g}}, spec))

    red, resid = jax.jit(make(True))(g)
    red2, _ = jax.jit(make(False))(g)
    out = {{}}
    for k in g:
        out['red_' + k] = np.asarray(red[k])
        out['resid_' + k] = np.asarray(resid[k])
        out['plain_' + k] = np.asarray(red2[k])
    np.savez({out!r}, **out)
"""


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    root = tmp_path_factory.mktemp("two_ranks")
    g = _grads(2)
    ranks = W.run_group(W.compress_and_mesh, 2, root / "group", g,
                        timeout=GROUP_TIMEOUT_S)
    np.savez(root / "g.npz", **g)
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=2",
               PYTHONPATH=str(REPO / "src"))
    code = textwrap.dedent(_REF_PSUM.format(path=str(root / "g.npz"),
                                            out=str(root / "ref.npz")))
    proc = subprocess.run([sys.executable, "-c", code], env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return g, ranks, dict(np.load(root / "ref.npz"))


def test_compressed_all_reduce_two_ranks_within_reference_bounds(two_ranks):
    g, ranks, _ = two_ranks
    for k, v in g.items():
        exact = v.mean(axis=0)
        bound = float(np.abs(v).max()) / 127.0
        for r, out in enumerate(ranks):
            err = float(np.abs(out["red"][k] - exact).max())
            assert err <= bound * 1.5, (k, r, err, bound)
            assert float(np.abs(out["resid"][k]).max()) <= bound * 1.5
            assert float(np.abs(out["plain"][k] - exact).max()) < 1e-6
            assert out["plain_ef_kept"]
        # every rank holds the same reduction
        assert np.array_equal(ranks[0]["red"][k], ranks[1]["red"][k])


def test_compressed_all_reduce_two_ranks_equals_reference_psum(two_ranks):
    g, ranks, ref = two_ranks
    for k in g:
        for r, out in enumerate(ranks):
            np.testing.assert_allclose(out["red"][k], ref[f"red_{k}"],
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(out["resid"][k], ref[f"resid_{k}"][r],
                                       atol=1e-6, rtol=0)
            np.testing.assert_allclose(out["plain"][k], ref[f"plain_{k}"],
                                       atol=1e-6, rtol=0)


def test_host_mesh_in_a_two_rank_world(two_ranks):
    _, ranks, _ = two_ranks
    for out in ranks:
        assert (out["dp"], out["tp"]) == (2, 1)
        assert out["names"] == ("data", "model")
        assert out["mesh_shape"] == (2, 1)
        assert out["placements"] == (Shard(0), Replicate())
        assert "needs 256 ranks" in out["refused"]


def test_device_meshes_need_a_process_group():
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    with pytest.raises(RuntimeError, match="process group"):
        make_host_mesh(2, 1)
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh(multi_pod=True)


# -- 4 ranks: GPipe ----------------------------------------------------------

S, L_PER, D, M, MB = 4, 2, 16, 8, 4


@pytest.fixture(scope="module")
def gpipe_run(tmp_path_factory):
    rng = np.random.default_rng(0)
    Ws = (rng.standard_normal((S, L_PER, D, D)) * (0.5 / D ** 0.5)
          ).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    ranks = W.run_group(W.gpipe, S, tmp_path_factory.mktemp("gpipe"), Ws, x,
                        timeout=GROUP_TIMEOUT_S)

    # the reference test's sequential run and its gradient, on these weights
    def stage_fn(Wst, h):
        def body(h, w):
            return jnp.tanh(h @ w), None
        h, _ = jax.lax.scan(body, h, Wst)
        return h

    def seq(Wa, xa):
        h = xa.reshape(M * MB, D)
        for s in range(S):
            h = stage_fn(Wa[s], h)
        return h.reshape(M, MB, D)

    ref = np.asarray(seq(jnp.asarray(Ws), jnp.asarray(x)))
    g_ref = np.asarray(jax.grad(lambda Wa: seq(Wa, jnp.asarray(x)).sum())(
        jnp.asarray(Ws)))
    return ranks, ref, g_ref


def test_gpipe_forward_matches_sequential(gpipe_run):
    ranks, ref, _ = gpipe_run
    for r, out in enumerate(ranks):
        err = float(np.abs(out["out"] - ref).max())
        assert err < 1e-5, (r, err)


def test_gpipe_stage_grads_match_jax_grad(gpipe_run):
    ranks, _, g_ref = gpipe_run
    for r, out in enumerate(ranks):
        gerr = float(np.abs(out["grad"] - g_ref[r]).max())
        assert gerr < 1e-4, (r, gerr)
        assert float(np.abs(g_ref[r]).max()) > 1e-2      # not vacuous


def test_gpipe_single_rank_equals_sequential(tmp_path):
    rng = np.random.default_rng(1)
    Ws = (rng.standard_normal((1, L_PER, D, D)) * 0.1).astype(np.float32)
    x = rng.standard_normal((M, MB, D)).astype(np.float32)
    out = W.run_group(W.gpipe, 1, tmp_path, Ws, x,
                      timeout=GROUP_TIMEOUT_S)[0]
    Wt = torch.from_numpy(Ws[0]).requires_grad_()
    want = W._stage_fn(Wt, torch.from_numpy(x))
    want.sum().backward()
    # the reference test's tolerances (microbatches of 4 against one
    # [32, 16] product sum in another order)
    np.testing.assert_allclose(out["out"], want.detach().numpy(), atol=1e-5)
    np.testing.assert_allclose(out["grad"], Wt.grad.numpy(), atol=1e-4)


def test_run_group_fails_a_hung_group(tmp_path):
    with pytest.raises(TimeoutError, match="still running"):
        W.run_group(W.hang, 2, tmp_path, timeout=8.0)

