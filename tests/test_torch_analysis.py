"""Port parity for ``repro_torch.analysis``: FLOP counting, the roofline
arithmetic, per-op cost and the report tables.

- ``flops.flops_of`` / ``count_flops`` against the reference's
  ``jaxpr_flops.flops_of`` on the five cases of ``tests/test_analysis.py``
  that do not parse HLO: a dot, a batched dot, a loop of 7 (the
  reference's scan), remat's 3 matmuls (forward, recompute, the input's
  gradient), and the grouped (MoE) product (2·m·k·n whatever the group
  count). Exact: both count integer products.
- ``roofline.model_flops`` equals the reference's ``hlo.model_flops`` for
  every registered config and shape, exactly (the same float arithmetic).
- ``roofline_terms`` equals the reference's once each constant's ratio is
  taken out: compute_s x PEAK_FLOPS, memory_s x HBM_BW and collective_s x
  LINK_BW (the reference's ICI_BW) agree to 1e-12 relative; the byte sums
  and ``dominant`` (whose order the constants can change) are checked
  where the ratios keep it.
- ``op_cost``: the reference's ``HloCost.to_dict()`` keys; a matmul's
  bytes and FLOPs; views move nothing; the XLA-only fields' values; the
  collectives listed by operand shape. DTensor's tensor-meta method,
  which the counting modes wrap, exists on this torch, and its absence
  is refused.
- ``report`` / ``fill_experiments``: ``roofline_row`` (but its note, which
  names the card's terms), ``markdown_table`` and ``build_tables`` give
  the reference's values and strings for the same records.
"""
import json
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.analysis import fill_experiments as rfill  # noqa: E402
from repro.analysis import hlo as rhlo  # noqa: E402
from repro.analysis import report as rreport  # noqa: E402
from repro.analysis.hlo_cost import HloCost  # noqa: E402
from repro.analysis.jaxpr_flops import flops_of as rflops_of  # noqa: E402
from repro.configs import SHAPES as RSHAPES  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro_torch.analysis import fill_experiments, report, roofline  # noqa: E402
from repro_torch.analysis.flops import (count_flops, flops_of,  # noqa: E402
                                        meta_propagation_method)
from repro_torch.analysis.op_cost import OpCost, OpCostMode  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402


def _meta(*shape):
    return torch.empty(shape, dtype=torch.float32, device="meta")


def _sds(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# -- flops -------------------------------------------------------------------

def test_dot_flops_match_reference():
    want = rflops_of(lambda a, b: a @ b, _sds(64, 32), _sds(32, 16))
    got = flops_of(lambda a, b: a @ b, _meta(64, 32), _meta(32, 16))
    assert got == want == 2 * 64 * 32 * 16


def test_batched_dot_flops_match_reference():
    want = rflops_of(lambda a, b: jnp.einsum("bij,bjk->bik", a, b),
                     _sds(4, 8, 16), _sds(4, 16, 32))
    got = flops_of(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                   _meta(4, 8, 16), _meta(4, 16, 32))
    assert got == want == 2 * 4 * 8 * 16 * 32


def test_layer_loop_counts_like_the_reference_scan():
    def jf(x, w):
        y, _ = jax.lax.scan(lambda c, wi: (c @ wi, None), x, w)
        return y

    def tf(x, w):
        for i in range(w.shape[0]):      # the port's layer loop
            x = x @ w[i]
        return x

    want = rflops_of(jf, _sds(32, 32), _sds(7, 32, 32))
    got = flops_of(tf, _meta(32, 32), _meta(7, 32, 32))
    assert got == want == 7 * 2 * 32 ** 3


def test_remat_recompute_is_counted_like_the_reference():
    from torch.utils.checkpoint import checkpoint

    def jf(x, w):
        g = jax.checkpoint(lambda x: jnp.tanh(x @ w))
        return jax.grad(lambda x: g(x).sum())(x).sum()

    def tf(x, w):
        x = x.detach().requires_grad_(True)
        y = checkpoint(lambda x: torch.tanh(x @ w), x, use_reentrant=False)
        return torch.autograd.grad(y.sum(), x)[0].sum()

    want = rflops_of(jf, _sds(16, 16), _sds(16, 16))
    x, w = torch.randn(16, 16), torch.randn(16, 16)
    got = count_flops(tf, x, w)
    # fwd + remat-fwd + bwd-dx (no dw: w is closed over) = 3 matmuls
    assert got == want == 3 * 2 * 16 ** 3


def test_grouped_product_counts_two_m_k_n_like_ragged_dot():
    gs = np.array([20, 0, 33, 11])            # 64 rows in 4 groups

    def jf(lhs, rhs, g):
        return jax.lax.ragged_dot(lhs, rhs, g)

    def tf(lhs, rhs):                          # moe._ragged's product
        out, lo = [], 0
        for e, n in enumerate(gs.tolist()):
            if n:
                out.append(lhs[lo:lo + n] @ rhs[e])
            lo += n
        return torch.cat(out)

    want = rflops_of(jf, _sds(64, 8), _sds(4, 8, 16),
                     jax.ShapeDtypeStruct((4,), jnp.int32))
    got = flops_of(tf, _meta(64, 8), _meta(4, 8, 16))
    assert got == want == 2 * 64 * 8 * 16


# -- roofline ----------------------------------------------------------------

@pytest.mark.parametrize("arch", list_archs())
def test_model_flops_match_reference(arch):
    rc, tc = rget_config(arch), get_config(arch)
    for name in SHAPES:
        for chips, per in ((256, True), (512, True), (1, False)):
            want = rhlo.model_flops(rc, RSHAPES[name], per_device=per,
                                    chips=chips)
            got = roofline.model_flops(tc, SHAPES[name], per_device=per,
                                       chips=chips)
            assert got == want, (arch, name, chips)


@pytest.mark.parametrize("coll", [
    {}, {"all-reduce": 3.5e9}, {"all-gather": 1e8, "reduce-scatter": 2e8},
    {"all-to-all": 7e7, "collective-permute": 1e6, "all-reduce": 4e4}])
def test_roofline_terms_match_reference_up_to_the_constants(coll):
    flops, nbytes = 3.7e13, 2.9e11
    r = rhlo.roofline_terms(flops, nbytes, coll)
    t = roofline.roofline_terms(flops, nbytes, coll)
    for k, mine, ref in (("compute_s", roofline.PEAK_FLOPS, rhlo.PEAK_FLOPS),
                         ("memory_s", roofline.HBM_BW, rhlo.HBM_BW),
                         ("collective_s", roofline.LINK_BW, rhlo.ICI_BW)):
        assert math.isclose(t[k] * mine, r[k] * ref, rel_tol=1e-12), k
    assert t["collective_bytes"] == r["collective_bytes"]
    assert t["collective_bytes_weighted"] == r["collective_bytes_weighted"]
    assert roofline._COLL_WEIGHT == rhlo._COLL_WEIGHT
    # with the reference's constants the port's terms are the reference's
    terms = {"compute": flops / rhlo.PEAK_FLOPS,
             "memory": nbytes / rhlo.HBM_BW,
             "collective": t["collective_bytes_weighted"] / rhlo.ICI_BW}
    assert max(terms, key=terms.get) == r["dominant"]


def test_collective_stats_keys_match_reference():
    a = rhlo.CollectiveStats({"all-reduce": 2}, {"all-reduce": 64},
                             {"all-reduce": 64})
    b = roofline.CollectiveStats({"all-reduce": 2}, {"all-reduce": 64},
                                 {"all-reduce": 64})
    assert a.to_dict() == b.to_dict()


def test_constants_are_the_h100_data_sheet():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert roofline.LINK_BW == 50e9


# -- op_cost -----------------------------------------------------------------

def test_op_cost_dict_has_the_reference_keys_and_xla_only_values():
    c = OpCost()
    assert set(c.to_dict()) == set(HloCost().to_dict())
    d = c.to_dict()
    assert d["bytes_cpu_dtype_artifacts"] == 0 and d["loop_trip_counts"] == []


def test_op_cost_counts_a_matmul_and_no_view():
    a, b = torch.randn(8, 16), torch.randn(16, 4)
    with OpCostMode() as mode:
        out = (a.t().t() @ b).view(32)
    c = mode.cost()
    assert out.shape == (32,)
    assert c.dot_flops == c.global_flops == 2 * 8 * 16 * 4
    assert c.bytes_accessed == 4 * (8 * 16 + 16 * 4 + 8 * 4)
    assert c.collective_counts == {} and c.ops >= 1
    assert c.collective_operand_bytes_raw == c.collective_operand_bytes


def test_dtensor_meta_step_is_wrapped_while_counting():
    """The counting modes skip what DTensor's sharding propagator runs at
    global shapes by wrapping its tensor-meta method; the method exists
    on this torch, is wrapped only inside a mode, and a torch without it
    is refused rather than counted wrong."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    name = meta_propagation_method()
    orig = getattr(ShardingPropagator, name)
    with OpCostMode():
        assert getattr(ShardingPropagator, name) is not orig
    assert getattr(ShardingPropagator, name) is orig


def test_counting_refuses_a_torch_without_the_meta_step(monkeypatch):
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    for name in ("_propagate_tensor_meta_non_cached",
                 "_propagate_tensor_meta"):
        monkeypatch.delattr(ShardingPropagator, name, raising=False)
    with pytest.raises(RuntimeError, match="stand-in"):
        with OpCostMode():
            pass


def test_op_cost_lists_collectives_by_operand_shape():
    c = OpCost(collective_by_shape={
        ("all-reduce", (4, 8), "bfloat16"): [3.0, 192.0],
        ("all-gather", (2,), "float32"): [1.0, 8.0]})
    assert c.collective_ops == [["all-reduce", [4, 8], "bfloat16", 3.0,
                                 192.0],
                                ["all-gather", [2], "float32", 1.0, 8.0]]


# -- report ------------------------------------------------------------------

def _record(arch, shape, mesh, compute, memory, coll, ratio):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "roofline": {"compute_s": compute, "memory_s": memory,
                         "collective_s": coll},
            "useful_flops_ratio": ratio, "model_flops_per_device": 1.5e12,
            "flops_per_device": 2.5e12}


RECORDS = [
    _record("gemma-2b", "train_4k", "single", 0.4, 0.2, 0.1, 0.71),
    _record("gemma-2b", "decode_32k", "single", 1e-5, 3e-3, 1e-3, 0.8),
    _record("olmoe-1b-7b", "train_4k", "single", 0.1, 0.1, 0.9, 0.35),
    _record("zeros", "prefill_32k", "single", 0.0, 0.0, 0.0, None),
    _record("gemma-2b", "train_4k", "multi", 0.2, 0.1, 0.3, 0.7),
    _record("mamba2-370m", "long_500k", "multi", 2e-6, 1e-4, 5e-5, 1.2),
]


@pytest.fixture
def art(tmp_path):
    for r in RECORDS:
        d = tmp_path / r["mesh"] / r["arch"]
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{r['shape']}.json").write_text(json.dumps(r))
    return tmp_path


def test_roofline_rows_match_reference_but_the_note(art):
    for mesh in ("single", "multi"):
        got = [report.roofline_row(r) for r in report.load_records(art, mesh)]
        want = [rreport.roofline_row(r)
                for r in rreport.load_records(art, mesh)]
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            assert g.pop("note") == report.IMPROVEMENT_NOTES[g["dominant"]]
            w.pop("note")
            assert g == w
    assert report.SKIP_NOTES == rreport.SKIP_NOTES
    assert set(report.IMPROVEMENT_NOTES) == set(rreport.IMPROVEMENT_NOTES)
    assert not any("VMEM" in n or "Pallas" in n
                   for n in report.IMPROVEMENT_NOTES.values())


def test_markdown_and_filled_tables_equal_the_reference(art):
    rows = [report.roofline_row(r) for r in report.load_records(art)]
    rrows = [rreport.roofline_row(r) for r in rreport.load_records(art)]
    assert report.markdown_table(rows) == rreport.markdown_table(rrows)
    assert fill_experiments.build_tables(art) == rfill.build_tables(art)
    assert report.summarize(art).keys() == rreport.summarize(art).keys()


def test_fill_experiments_fills_the_marker(art, tmp_path):
    exp = tmp_path / "EXPERIMENTS.md"
    exp.write_text(f"# x\n\n{fill_experiments.MARKER}\n")
    assert fill_experiments.main(art, exp) == 0
    assert fill_experiments.build_tables(art) in exp.read_text()
    assert fill_experiments.main(art, exp) == 1     # marker gone
