"""Port parity for the backend pool's mesh dimension and the data-parallel
``MeshTorchBackend``, case for case against ``tests/test_sharding.py``.

The reference simulates host devices with
``--xla_force_host_platform_device_count`` in a subprocess; the port's
seam is ``repro_torch.launch.mesh.visible_devices``, monkeypatched here to
list the CPU two or three times, so a mesh's rows really split into
shards, each run on its entry. The mesh backend is held to the
single-device port, the reference's ``JaxBackend`` and the numpy oracle
at atol 1e-5 (float32 products summed in another order); the reference's
own 2-device byte-parity assertion is not carried over.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core.zoo import ZooModel as RZooModel  # noqa: E402
from repro.pipeline.backend import InferSpec as RInferSpec  # noqa: E402
from repro.pipeline.backend import JaxBackend  # noqa: E402
from repro.pipeline.batcher import BatcherStats as RBatcherStats  # noqa: E402
import repro_torch.engine.session as session_mod  # noqa: E402
import repro_torch.launch.mesh as mesh_mod  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402
from repro_torch.engine import (EngineConfig, MorphingServer,  # noqa: E402
                                MorphingSession)
from repro_torch.launch.mesh import ServingMesh, make_serving_mesh  # noqa: E402
from repro_torch.pipeline.backend import (BackendPool, InferSpec,  # noqa: E402
                                          MeshTorchBackend, NumpyBackend,
                                          TorchBackend, make_backends)
from repro_torch.pipeline.batcher import BatcherStats  # noqa: E402
from repro_torch.pipeline.cost import HardwareProfile, calibrate  # noqa: E402

ATOL = 1e-5
MODES = ["linear", "relu", "proj1d", "radial"]
CPU = torch.device("cpu")


def _cpus(monkeypatch, n):
    """Make ``visible_devices("cpu")`` list the CPU ``n`` times."""
    real = mesh_mod.visible_devices

    def fake(device_type="cuda"):
        return (CPU,) * n if device_type == "cpu" else real(device_type)
    monkeypatch.setattr(mesh_mod, "visible_devices", fake)


def _zoo_models(mode, rng, in_dim=16, width=24):
    """(reference ZooModel, port ZooModel) with the same weights."""
    kw = {}
    if mode == "radial":
        kw = dict(centers=rng.standard_normal((8, in_dim))
                  .astype(np.float32), sigma=1.3)
    zm = RZooModel(name=f"zm_{mode}", source_family="gauss",
                   W=rng.standard_normal((in_dim, width)).astype(np.float32),
                   mode=mode, **kw)
    return zm, zoo_from_numpy([zm])[0]


class _RM:
    def __init__(self, zm):
        self.zoo_model = zm
        self.features = zm.features
        self.head_kind = "mean"

    @staticmethod
    def head(F):
        return np.asarray(F).mean(axis=1)


def _spec(zm, version, kind="embed"):
    return InferSpec(kind=kind, task="t", col="x", out="f", table="tb",
                     version=version, model=_RM(zm), stats=BatcherStats())


def _rspec(zm, version, kind="embed"):
    return RInferSpec(kind=kind, task="t", col="x", out="f", table="tb",
                      version=version, model=_RM(zm), stats=RBatcherStats())


# -- the pool is a drop-in registry ----------------------------------------

def test_pool_is_dict_compatible_registry():
    pool = make_backends("auto", torch_device="cpu")
    assert isinstance(pool, dict) and isinstance(pool, BackendPool)
    assert pool.device_count == 1 and pool.mesh is None
    assert isinstance(pool["host"], NumpyBackend)
    assert isinstance(pool["cuda"], TorchBackend)
    assert not isinstance(pool["cuda"], MeshTorchBackend)
    assert set(pool) == {"host", "cuda"}
    assert isinstance(pool.backend_for("nonexistent"), NumpyBackend)
    assert len(pool.distinct()) == 2


def test_pool_numpy_kind_never_meshes(monkeypatch):
    _cpus(monkeypatch, 4)
    pool = make_backends("numpy", device_count=4)
    assert pool.device_count == 1 and pool.mesh is None
    assert all(isinstance(b, NumpyBackend) for b in pool.values())


def test_pool_unknown_kind_raises():
    with pytest.raises(ValueError, match="unknown backend kind"):
        make_backends("jax")


def test_pool_clamps_to_available_devices(monkeypatch):
    """A wider mesh than the visible devices clamps: on the one CPU it is
    the plain single-device backend (no mesh); over three listed entries
    a 3-entry mesh. CUDA asked for where there is none raises."""
    pool = make_backends("torch", device_count=8, torch_device="cpu")
    assert pool.device_count == 1 and pool.mesh is None
    assert type(pool["cuda"]) is TorchBackend
    _cpus(monkeypatch, 3)
    pool = make_backends("torch", device_count=8, torch_device="cpu")
    assert pool.device_count == 3 and pool.mesh.devices == (CPU,) * 3
    assert type(pool["cuda"]) is MeshTorchBackend
    assert pool["host"] is pool["cuda"]
    pool = make_backends("auto", device_count=2, torch_device="cpu")
    assert pool.device_count == 2 and isinstance(pool["host"], NumpyBackend)
    assert pool["cuda"].mesh is pool.mesh
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_backends("torch", device_count=8)


def test_serving_mesh_spans_the_first_visible_devices(monkeypatch):
    _cpus(monkeypatch, 3)
    assert make_serving_mesh(2, "cpu").devices == (CPU, CPU)
    assert len(make_serving_mesh(8, "cpu").devices) == 3
    assert len(make_serving_mesh(0, "cpu").devices) == 1
    m = ServingMesh((CPU, CPU))          # one device named twice
    assert m.axis_names == ("data",) and m.shape == (2,)
    assert m.distinct_devices() == (CPU,)
    assert mesh_mod.dp_size(m) == 2
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no 'cuda' device"):
        make_serving_mesh(2)
    with pytest.raises(ValueError):
        ServingMesh(())


# -- single-device fallback parity -----------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_single_device_pool_parity_vs_oracle(mode):
    """device_count=1 through the pool == a plain TorchBackend, byte for
    byte, and both match the numpy oracle within atol 1e-5."""
    rng = np.random.default_rng(0)
    _, zm = _zoo_models(mode, rng)
    X = rng.standard_normal((37, 16)).astype(np.float32)

    pool = make_backends("torch", device_count=1, torch_device="cpu")
    pooled = pool["cuda"]
    legacy = TorchBackend(device="cpu")
    sp, sl = _spec(zm, f"v_{mode}"), _spec(zm, f"v_{mode}")
    Ep = np.asarray(pooled.run_infer(sp, {"x": X})["f"])
    El = np.asarray(legacy.run_infer(sl, {"x": X})["f"])
    assert Ep.tobytes() == El.tobytes()
    np.testing.assert_allclose(Ep, zm.features(X), atol=ATOL)
    assert pooled.stage_count == legacy.stage_count == 1
    assert pooled.compile_count == legacy.compile_count
    assert (sp.stats.rows, sp.stats.batches) == \
        (sl.stats.rows, sl.stats.batches) == (37, 1)


def test_session_device_count_clamps_and_serves():
    sess = MorphingSession(backend="numpy", device_count=4,
                           auto_calibrate=False)
    assert sess.device_count == 1
    srv = MorphingServer(session=sess)
    assert srv.devices == 1
    assert srv.stats().devices == 1
    sess = MorphingSession(config=EngineConfig(
        backend="torch", torch_device="cpu", device_count=4,
        auto_calibrate=False))
    assert sess.device_count == 1 and sess.backends.mesh is None


def test_server_devices_conflicting_with_session_raises():
    sess = MorphingSession(backend="numpy", auto_calibrate=False)
    with pytest.raises(ValueError, match="conflicts"):
        MorphingServer(session=sess, devices=2)


def test_hardware_profile_mesh_fields_default_single_device():
    hw = HardwareProfile("host", 1e9, 1e9)
    assert hw.device_count == 1
    assert hw.per_device_flops == 1e9
    mesh_hw = HardwareProfile("cuda", 4e9, 1e9, device_count=4)
    assert mesh_hw.per_device_flops == 1e9
    measured = HardwareProfile("cuda", 4e9, 1e9, device_count=4,
                               device_flops_per_s=1.5e9)
    assert measured.per_device_flops == 1.5e9


def test_calibrate_single_device_profile_unchanged_shape():
    prof = calibrate(NumpyBackend(), "host", rows=(64, 256), repeats=1)
    assert prof.measured and prof.device_count == 1
    assert prof.device_flops_per_s == 0.0
    assert prof.per_device_flops == prof.flops_per_s


# -- the mesh backend over 2 and 3 CPU entries ------------------------------

@pytest.mark.parametrize("n_dev", [2, 3])
@pytest.mark.parametrize("kind", ["embed", "predict"])
@pytest.mark.parametrize("mode", MODES)
def test_mesh_backend_parity_all_modes(monkeypatch, mode, kind, n_dev):
    _cpus(monkeypatch, n_dev)
    rng = np.random.default_rng(0)
    ref_zm, zm = _zoo_models(mode, rng)
    X = rng.standard_normal((37, 16)).astype(np.float32)
    mesh_b = MeshTorchBackend(device="cpu")
    assert mesh_b.device_count == n_dev and mesh_b.name == "torch-mesh"
    single = TorchBackend(device="cpu")
    Em = np.asarray(mesh_b.run_infer(_spec(zm, "v", kind), {"x": X})["f"])
    Es = np.asarray(single.run_infer(_spec(zm, "v", kind), {"x": X})["f"])
    Ej = np.asarray(JaxBackend(interpret=True).run_infer(
        _rspec(ref_zm, "v", kind), {"x": X})["f"])
    Eo = zm.features(X)
    if kind == "predict":
        Eo = Eo.mean(axis=1)
    assert Em.shape == Es.shape == Eo.shape
    np.testing.assert_allclose(Em, Es, atol=ATOL)
    np.testing.assert_allclose(Em, Ej, atol=ATOL)
    np.testing.assert_allclose(Em, Eo, atol=ATOL)
    if n_dev == 2:
        # power-of-two buckets are already mesh multiples: the same shapes
        assert mesh_b.compile_count == single.compile_count
    # one copy of each weight a distinct device; empty chunks keep width
    assert mesh_b.stage_count == 1
    E0 = mesh_b.run_infer(_spec(zm, "v", kind), {"x": X[:0]})["f"]
    assert E0.shape == (0,) + Eo.shape[1:]


def test_mesh_bucket_rounding_three_devices(monkeypatch):
    """A non-power-of-two mesh rounds buckets up to mesh multiples so the
    rows split evenly."""
    _cpus(monkeypatch, 3)
    b = MeshTorchBackend(device="cpu")
    assert b.device_count == 3
    assert b._bucket_for(5) == 33       # pow2 -> 32, rounded to x3
    assert b._bucket_for(40) == 66      # pow2 -> 64, rounded to x3
    rng = np.random.default_rng(0)
    _, zm = _zoo_models("relu", rng)
    X = rng.standard_normal((40, 16)).astype(np.float32)
    E = np.asarray(b.run_infer(_spec(zm, "v"), {"x": X})["f"])
    np.testing.assert_allclose(E, zm.features(X), atol=ATOL)


def test_mesh_shards_run_on_each_entry_in_order(monkeypatch):
    """Each shard is a contiguous slice of the bucket, run once on its
    entry, and the shards come back in mesh order."""
    b = MeshTorchBackend(ServingMesh((CPU, CPU, CPU)))
    seen = []

    def raw(X, W):
        seen.append((X.device, X.shape[0], float(X[0, 0])))
        return X @ W
    W = b._put_weight(np.eye(2, dtype=np.float32))
    assert set(W) == {CPU}                 # one copy a distinct device
    features, _ = b._compile_forward(raw, (W,))
    X = torch.arange(12, dtype=torch.float32).reshape(6, 2)
    assert torch.equal(features(X), X)
    assert seen == [(CPU, 2, 0.0), (CPU, 2, 4.0), (CPU, 2, 8.0)]


# -- serving and calibration through the mesh -------------------------------

def test_mesh_pool_server_end_to_end_two_devices(monkeypatch, tmp_path):
    from repro_torch.core import make_task, pretrain_model
    from repro_torch.core.task import TaskSpec

    _cpus(monkeypatch, 2)
    rng = np.random.default_rng(0)
    src = make_task(rng, "gauss", n=120, dim=16, classes=3)
    zoo = [pretrain_model(src, width=48, seed=1, name="m0", mode="linear")]
    X = rng.standard_normal((400, 16)).astype(np.float32)
    y = (X.sum(1) > 0).astype(np.float32)

    def build(devices):
        sess = MorphingSession(zoo=zoo, root=tmp_path / f"d{devices}",
                               config=EngineConfig(
                                   backend="torch", torch_device="cpu",
                                   device_count=devices,
                                   model_store="decoupled"))
        sess.register_table("t", {"x": X})
        sess.create_task(TaskSpec("s", "series", ("P", "N")))
        sess.registry._resolution["s"] = 0
        sess.resolve_task("s", X[:64], y[:64])
        return MorphingServer(session=sess)

    s1 = build(1).start()
    a = s1.predict("PREDICT x USING TASK s FROM t").scores
    b1 = list(s1._lanes.values())[0].batch_rows
    s1.stop()

    s2 = build(2).start()
    r = s2.predict("PREDICT x USING TASK s FROM t")
    st = s2.stats()
    assert st.devices == 2, st.devices
    assert st.mesh_rows_per_s > 0
    assert isinstance(s2.session.backends["cuda"], MeshTorchBackend)
    b2 = list(s2._lanes.values())[0].batch_rows
    s2.stop()
    # mesh lanes budget against aggregate throughput (Eq. 11 x N)
    assert b2 >= b1, (b1, b2)
    assert np.abs(np.asarray(r.scores) - np.asarray(a)).max() < 1e-6


def test_calibrate_mesh_reports_both_rates_two_devices():
    prof = calibrate(MeshTorchBackend(ServingMesh((CPU, CPU))), "cuda",
                     rows=(64, 512), repeats=1)
    assert prof.measured
    assert prof.device_count == 2, prof.device_count
    assert prof.flops_per_s > 0
    assert prof.device_flops_per_s > 0
    assert prof.per_device_flops == prof.device_flops_per_s


def test_fast_profile_mesh_key_and_probe_share_the_mesh(monkeypatch):
    """The session's fast calibration keys a mesh profile by the mesh's
    devices and probe size, and probes through a backend on the live
    mesh (checked before the plain-torch branch: the mesh backend is a
    TorchBackend)."""
    monkeypatch.setattr(session_mod, "_FAST_CALIB_CACHE", {})
    probes = []

    def fake_calibrate(backend, device, rows, repeats):
        probes.append((backend, rows))
        return HardwareProfile(device, 2e9, 1e9, measured=True,
                               device_count=getattr(backend, "device_count", 1),
                               device_flops_per_s=1e9)
    monkeypatch.setattr(session_mod, "calibrate", fake_calibrate)
    mesh = ServingMesh((CPU, CPU))
    b = MeshTorchBackend(mesh)
    prof = session_mod._fast_profile(b, "cuda")
    key = ("torch-mesh", ("cpu", "cpu"), session_mod._calib_rows("cuda"))
    assert list(session_mod._FAST_CALIB_CACHE) == [key]
    (probe, rows), = probes
    assert type(probe) is MeshTorchBackend and probe is not b
    assert probe.mesh is mesh
    assert rows == session_mod._CUDA_CALIB_ROWS
    assert prof.device_count == 2 and prof.name == "cuda"
    session_mod._fast_profile(b, "cuda")     # memoized: no second probe
    assert len(probes) == 1
    session_mod._fast_profile(TorchBackend(device="cpu"), "cuda")
    assert len(probes) == 2 and type(probes[1][0]) is TorchBackend
