"""Port parity for ``storage/``: the on-disk format is the contract.

Stores written by the reference resolve in the port to identical arrays,
and the other way round (BLOB, decoupled full/partial/row-range loads, a
fine-tune delta). Layer keys follow jax's flatten order. bf16 Mvec
payloads decode through torch, with ``ml_dtypes`` blocked. Comparisons are
exact: both packages read and write the same bytes.
"""
import sys
from collections import OrderedDict, namedtuple

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jnp = pytest.importorskip("jax.numpy")

import repro.storage as RS  # noqa: E402
import repro_torch.storage as PS  # noqa: E402
from repro.storage import mvec as rmvec  # noqa: E402
from repro.storage.stores import flatten_params as ref_flatten  # noqa: E402
from repro.storage.stores import unflatten_like as ref_unflatten  # noqa: E402
from repro_torch.storage import mvec as pmvec  # noqa: E402

PAIRS = {"ref->port": (RS, PS), "port->ref": (PS, RS)}


@pytest.fixture
def params():
    rng = np.random.default_rng(0)
    return {"embed": rng.standard_normal((16, 8)).astype(np.float32),
            "layers": {"w1": rng.standard_normal((8, 8)).astype(np.float32),
                       "b1": np.zeros(8, np.float32)},
            "ids": rng.integers(0, 255, 12).astype(np.uint8)}


def _assert_same(a, b):
    assert set(a) == set(b)
    for k in a:
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))


@pytest.mark.parametrize("direction", list(PAIRS))
def test_blob_store_crosses_packages(tmp_path, params, direction):
    w, r = PAIRS[direction]
    w.BlobStore(tmp_path / "blob", w.Catalog(tmp_path / "cat")).save(
        "m1", {"arch": "mlp"}, params, task_types=["classification"])
    arch, flat = r.BlobStore(tmp_path / "blob").load("m1")
    assert arch == {"arch": "mlp"}
    _assert_same(flat, w.flatten_params(params))
    info = r.Catalog(tmp_path / "cat").get_model("m1")
    assert info.storage == "blob" and info.param_count == 16 * 8 + 72 + 12


# plain layer files + FLAG_DELTA deltas; then compressed deltas (SPARSE for
# the mostly-zero embed bump, QUANT for the dense w1 shift) on PAGED,
# content-deduplicated payloads
STORE_OPTS = {"plain": {},
              "compressed+paged": {"compress_deltas": True,
                                   "dedup_pages": True, "page_bytes": 128}}


@pytest.mark.parametrize("opts", list(STORE_OPTS))
@pytest.mark.parametrize("direction", list(PAIRS))
def test_decoupled_store_crosses_packages(tmp_path, params, direction,
                                          opts):
    w, r = PAIRS[direction]
    kw = STORE_OPTS[opts]
    ws = w.DecoupledStore(tmp_path / "dec", w.Catalog(tmp_path / "cat"),
                          **kw)
    ws.save("base", {"arch": "mlp"}, params)
    bump = np.zeros_like(params["embed"])
    bump[3, 2] = 1.5
    ft = dict(params, embed=params["embed"] + bump,
              layers={"w1": params["layers"]["w1"] + 0.125,
                      "b1": params["layers"]["b1"]})
    ws.save("ft", {"arch": "mlp"}, ft, base_model="base")
    assert ws.delta_bytes("ft") > 0

    rs = r.DecoupledStore(tmp_path / "dec", r.Catalog(tmp_path / "cat"),
                          **kw)
    # full loads, with and without a template
    _, full = rs.load("base")
    _assert_same(full, w.flatten_params(params))
    _, tree = rs.load("ft", template=ft)
    np.testing.assert_array_equal(tree["layers"]["w1"],
                                  ws.load("ft", template=ft)[1]["layers"]
                                  ["w1"])
    # partial: one layer, and a row range within one
    _, some = rs.load("ft", layer_filter=lambda n: n == "embed")
    assert list(some) == ["embed"]
    np.testing.assert_array_equal(
        some["embed"], ws.load("ft", layer_filter=lambda n: n == "embed")
        [1]["embed"])
    np.testing.assert_array_equal(rs.load_layer_rows("ft", "layers/w1", 2, 6),
                                  ws.load_layer_rows("ft", "layers/w1", 2, 6))
    # delta composition reads the same bytes the writer composed
    assert rs.trunk_fingerprint("ft") == ws.trunk_fingerprint("ft")
    assert rs.stored_bytes("ft") == ws.stored_bytes("ft")
    assert rs.delta_bytes("ft") == ws.delta_bytes("ft")


@pytest.mark.parametrize("direction", list(PAIRS))
def test_session_finetune_store_crosses_packages(tmp_path, direction):
    """One ``register_finetune`` head delta, written through a session of
    one package, read by the other's store."""
    import repro.core as RC
    import repro.engine as RE
    import repro_torch.core as PC
    import repro_torch.engine as PE
    core, eng, rst = ((RC, RE, PS) if direction == "ref->port"
                      else (PC, PE, RS))
    rng = np.random.default_rng(5)
    src = core.make_task(rng, "gauss", n=120, dim=8, classes=3)
    zoo = [core.pretrain_model(src, width=12, seed=1, name="m0")]
    sess = eng.MorphingSession(zoo=zoo, root=tmp_path, backend="numpy",
                               model_store="decoupled",
                               auto_calibrate=False)
    sess.create_task(core.TaskSpec("t", "series", ("P", "N")))
    sess.registry._resolution["t"] = 0
    sess.resolve_task("t", np.zeros((4, 8), np.float32),
                      np.zeros(4, np.int64))
    head = np.linspace(0.0, 1.0, 12).astype(np.float32)
    sess.register_finetune("m0-ft", "m0", {"head/w": head})
    other = rst.DecoupledStore(tmp_path / "layers",
                               rst.Catalog(tmp_path / "catalog"))
    _, flat = other.load("m0-ft")
    np.testing.assert_array_equal(flat["head/w"], head)
    np.testing.assert_array_equal(flat["trunk/W"], zoo[0].W)
    assert other.trunk_fingerprint("m0-ft") == \
        sess.dstore.trunk_fingerprint("m0-ft")


Pair = namedtuple("Pair", ["b", "a"])


def _trees():
    a = np.arange(3.0)
    return [
        {"z": a, "a": {"y": a + 1, "b": [a + 2, None, a + 3]}},
        OrderedDict([("z", a), ("a", a + 1)]),
        [a, (a + 1, {"k": a + 2}), None],
        Pair(b=a, a={"q": None, "p": a + 1}),
        a,
    ]


@pytest.mark.parametrize("i", range(len(_trees())))
def test_layer_keys_follow_jax_flatten_order(i):
    tree = _trees()[i]
    want = ref_flatten(tree)
    got = PS.flatten_params(tree)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    back_ref = ref_unflatten(tree, want)
    back = PS.unflatten_like(tree, got)
    assert PS.flatten_params(back).keys() == ref_flatten(back_ref).keys()
    assert type(back) is type(back_ref)


def test_unflatten_reports_missing_layer():
    with pytest.raises(KeyError):
        PS.unflatten_like({"a": 1, "b": 2}, {"a": 1})


def _bf16_source():
    return jnp.asarray(np.random.default_rng(0).standard_normal((6, 5)),
                       jnp.bfloat16)


def test_bf16_mvec_decodes_through_torch_without_ml_dtypes(monkeypatch):
    src = _bf16_source()
    bits = np.asarray(src).view(np.uint16)
    dense = rmvec.encode(src)
    sparse = rmvec.encode_sparse(src)
    monkeypatch.setitem(sys.modules, "ml_dtypes", None)
    for buf in (dense, sparse):
        out = pmvec.decode(buf)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.bfloat16
        assert out.shape == (6, 5)
        assert np.array_equal(out.view(torch.int16).numpy().view(np.uint16),
                              bits)
    rows = pmvec.decode_slice(dense, 1, 4)
    assert rows.dtype == torch.bfloat16
    assert np.array_equal(rows.view(torch.int16).numpy().view(np.uint16),
                          bits[1:4])


def test_bf16_torch_tensor_encodes_to_reference_bytes():
    src = _bf16_source()
    bits = np.array(np.asarray(src).view(np.uint16)).view(np.int16)
    t = torch.from_numpy(bits).view(torch.bfloat16)
    assert pmvec.encode(t) == rmvec.encode(src)
    assert pmvec.encode(torch.arange(6.0)) == rmvec.encode(
        np.arange(6.0, dtype=np.float32))


# -- bf16 (and device) leaves through the stores ---------------------------
# The reference saves jax bf16 params and a bf16 fine-tune on a bf16 base;
# the port saves the same model as torch.bfloat16 tensors. Every layer file
# and every catalog row must be equal byte for byte.

def _bf16_model(seed):
    rng = np.random.default_rng(seed)
    return {"embed": rng.standard_normal((16, 8)),
            "layers": {"w1": rng.standard_normal((8, 8)),
                       "b1": np.zeros(8)},
            "scale": rng.standard_normal(8).astype(np.float32)}


def _as_jax(tree):
    return {k: _as_jax(v) if isinstance(v, dict)
            else jnp.asarray(v, jnp.float32 if v.dtype == np.float32
                             else jnp.bfloat16)
            for k, v in tree.items()}


def _as_torch(jtree):
    from repro_torch.convert import lm_params_from_numpy
    return lm_params_from_numpy({k: (np.asarray(v) if not isinstance(v, dict)
                                     else {kk: np.asarray(vv)
                                           for kk, vv in v.items()})
                                 for k, v in jtree.items()})


def _files(root):
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()
            and p.suffix == ".mvec" or p.name == "architecture.json"}


@pytest.mark.parametrize("opts", list(STORE_OPTS))
def test_bf16_model_and_finetune_save_byte_equal(tmp_path, opts):
    kw = STORE_OPTS[opts]
    base = _as_jax(_bf16_model(1))
    ft = dict(base, embed=base["embed"] + jnp.asarray(0.5, jnp.bfloat16),
              scale=base["scale"] * 2.0)
    roots = {}
    for name, pkg, conv in (("ref", RS, lambda t: t), ("port", PS, _as_torch)):
        root = tmp_path / name
        st = pkg.DecoupledStore(root / "dec", pkg.Catalog(root / "cat"), **kw)
        st.save("base", {"arch": "lm"}, conv(base))
        st.save("ft", {"arch": "lm"}, conv(ft), base_model="base")
        roots[name] = (root, st, pkg.Catalog(root / "cat"))
    ref_files, port_files = (_files(roots[n][0] / "dec") for n in roots)
    assert ref_files and ref_files.keys() == port_files.keys()
    for k in ref_files:
        assert port_files[k] == ref_files[k], k
    for mid in ("base", "ft"):
        want = [(li.layer_name, li.dtype, li.shape, li.nbytes, li.file,
                 li.delta_of, li.enc)
                for li in roots["ref"][2].get_layers(mid)]
        got = [(li.layer_name, li.dtype, li.shape, li.nbytes, li.file,
                li.delta_of, li.enc)
               for li in roots["port"][2].get_layers(mid)]
        assert got == want, mid
    # the port reads its own bf16 fine-tune back to the same bits
    _, flat = roots["port"][1].load("ft")
    for k, v in PS.flatten_params(_as_torch(ft)).items():
        got, got_name = pmvec.payload_array(flat[k])
        want, want_name = pmvec.payload_array(v)
        assert got_name == want_name and np.array_equal(got, want), k


def test_bf16_blob_save_byte_equal(tmp_path):
    base = _as_jax(_bf16_model(2))
    RS.BlobStore(tmp_path / "r", RS.Catalog(tmp_path / "rc")).save(
        "m", {"arch": "lm"}, base)
    PS.BlobStore(tmp_path / "p", PS.Catalog(tmp_path / "pc")).save(
        "m", {"arch": "lm"}, _as_torch(base))
    assert ((tmp_path / "p" / "m.blob").read_bytes()
            == (tmp_path / "r" / "m.blob").read_bytes())
    assert (PS.Catalog(tmp_path / "pc").get_model("m").param_count
            == RS.Catalog(tmp_path / "rc").get_model("m").param_count)
