"""Port parity for the execution backend: ``TorchBackend(device="cpu")``
against the reference ``JaxBackend(interpret=True)`` and the numpy oracle.

Mirrors ``tests/test_backend.py``: all four trunk modes at atol 1e-5 (the
reference's own tolerance: float32 products summed in another order),
ragged and empty chunks, width adaptation, the fused mean head, bucketed
shape counts, one-time staging, and calibration. Entry points that would
run on CUDA must raise where there is none rather than degrade.
"""
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from repro.core import make_task, pretrain_model  # noqa: E402
from repro.pipeline import JaxBackend  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402
from repro_torch.engine import EngineConfig, MorphingSession  # noqa: E402
from repro_torch.pipeline import (InferSpec, TorchBackend, calibrate,  # noqa: E402
                                  make_backends)
from repro_torch.pipeline.backend import _next_pow2  # noqa: E402
from repro_torch.pipeline.batcher import BatcherStats  # noqa: E402

ATOL = 1e-5
_FAMILY_FOR_MODE = {"linear": "gauss", "radial": "ring", "relu": "sparse",
                    "proj1d": "stripe"}


def _models_for_mode(mode, dim=8, seed=0):
    """(reference ZooModel, port ZooModel) with the same weights."""
    rng = np.random.default_rng(seed)
    src = make_task(rng, _FAMILY_FOR_MODE[mode], n=120, dim=dim, classes=3)
    zm = pretrain_model(src, width=12, seed=seed, name=f"zm-{mode}",
                        mode=mode)
    assert zm.mode == mode
    return zm, zoo_from_numpy([zm])[0]


def _spec_for(zm, version, **kw):
    model = SimpleNamespace(zoo_model=zm, features=zm.features,
                            head=lambda F: np.asarray(F).mean(axis=1))
    defaults = dict(kind="embed", task="t", col="x", out="f", table="tab",
                    version=version, model=model, batch_size=16,
                    share=None, stats=BatcherStats())
    defaults.update(kw)
    return InferSpec(**defaults)


@pytest.mark.parametrize("kind", ["embed", "predict"])
@pytest.mark.parametrize("mode", ["linear", "radial", "relu", "proj1d"])
@pytest.mark.parametrize("n", [133, 1, 0])
def test_torch_forward_matches_jax_backend(mode, n, kind):
    ref_zm, zm = _models_for_mode(mode)
    X = np.random.default_rng(1).standard_normal((n, 8)).astype(np.float32)
    want = JaxBackend(interpret=True).run_infer(
        _spec_for(ref_zm, f"{mode}@parity", kind=kind), {"x": X})["f"]
    got = TorchBackend(device="cpu").run_infer(
        _spec_for(zm, f"{mode}@parity", kind=kind), {"x": X})["f"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL)
    oracle = zm.features(X)
    np.testing.assert_allclose(
        got, oracle if kind == "embed" else oracle.mean(axis=1), atol=ATOL)


@pytest.mark.parametrize("ncols", [4, 8, 12])
def test_torch_forward_pads_or_slices_feature_dim(ncols):
    _, zm = _models_for_mode("linear")
    tb = TorchBackend(device="cpu")
    X = np.random.default_rng(2).standard_normal((37, ncols)) \
        .astype(np.float32)
    np.testing.assert_allclose(
        tb.run_infer(_spec_for(zm, f"linear@dim{ncols}"), {"x": X})["f"],
        zm.features(X), atol=ATOL)


def test_custom_head_runs_on_host():
    _, zm = _models_for_mode("relu")
    w = np.linspace(-1, 1, 12).astype(np.float32)
    model = SimpleNamespace(zoo_model=zm, features=zm.features,
                            head=lambda F: np.asarray(F) @ w,
                            head_kind="linear")
    spec = _spec_for(zm, "relu@head", kind="predict", model=model)
    X = np.random.default_rng(3).standard_normal((50, 8)).astype(np.float32)
    got = TorchBackend(device="cpu").run_infer(spec, {"x": X})["f"]
    np.testing.assert_allclose(got, zm.features(X) @ w, atol=ATOL)


def test_bucketing_compile_count_is_log_n():
    _, zm = _models_for_mode("linear")
    tb = TorchBackend(device="cpu", min_bucket=32)
    spec = _spec_for(zm, "linear@buckets")
    seen = []
    tb.on_compile = lambda version, key: seen.append(key)
    rng = np.random.default_rng(4)
    for n in [3, 7, 17, 33, 65, 100, 129, 200, 257, 400, 511, 600]:
        X = rng.standard_normal((n, 8)).astype(np.float32)
        assert tb.run_infer(spec, {"x": X})["f"].shape == (n, 12)
    assert tb.compile_count == 6          # buckets 32 .. 1024
    assert len(seen) == tb.compile_count
    assert all(b >= 32 and b == _next_pow2(b) for _, b in seen)


def test_stage_is_idempotent_per_version():
    _, zm = _models_for_mode("linear")
    tb = TorchBackend(device="cpu")
    s1 = tb.stage("m@1.0", zm)
    assert tb.stage("m@1.0", zm) is s1 and tb.stage_count == 1
    tb.stage("m@2.0", zm)
    assert tb.stage_count == 2
    assert tb.unstage("m@2.0") and not tb.unstage("m@2.0")


def test_calibrate_measures_a_profile():
    prof = calibrate(TorchBackend(device="cpu"), "cuda", rows=(64, 512),
                     repeats=1)
    assert prof.measured and prof.name == "cuda"
    assert prof.flops_per_s > 0 and prof.mem_bw > 0 and prof.link_bw > 0


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_default_device_without_cuda_raises(monkeypatch):
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TorchBackend()
    with pytest.raises(RuntimeError):
        make_backends("auto")
    with pytest.raises(RuntimeError):
        MorphingSession(config=EngineConfig(backend="torch"))
    # only an explicit CPU request runs on the CPU
    assert TorchBackend(device="cpu").device.type == "cpu"
    assert make_backends("numpy")["cuda"].name == "numpy"


def test_multi_device_pool_is_not_ported():
    # the CPU is one visible device: a 2-device request clamps to the plain
    # single-device backend, no mesh (tests/test_torch_mesh.py has the mesh)
    pool = make_backends("torch", device_count=2, torch_device="cpu")
    assert pool.device_count == 1 and pool.mesh is None
    assert type(pool["cuda"]) is TorchBackend


# -- the fast calibration's probe sizes --------------------------------------
# On the card a 64- or 512-row call is all launch: both probes take the same
# time and the fitted slope clamped at 1e-12 s a row. A backend whose call
# costs a fixed launch, noisy by 0.1 ms, plus a per-row cost on a clock it
# drives itself shows whether a pair of probe sizes resolves the slope.

class _SyntheticBackend:
    """``run_infer`` advances a fake clock by launch + rows * per_row, the
    launch jittered from a seeded generator."""

    def __init__(self, per_row, launch=3e-4, jitter=1e-4, seed=0):
        self.per_row, self.launch, self.jitter = per_row, launch, jitter
        self.rng = np.random.default_rng(seed)
        self.now = 0.0

    def perf_counter(self):
        return self.now

    def stage(self, version, zm):
        pass

    def run_infer(self, spec, batch):
        n = len(batch["x"])
        self.now += (self.launch + n * self.per_row
                     + self.rng.uniform(-self.jitter, self.jitter))


@pytest.mark.parametrize("per_row", [2e-8, 1.3e-7])
@pytest.mark.parametrize("seed", range(4))
def test_cuda_calibration_probe_resolves_the_per_row_cost(monkeypatch,
                                                          per_row, seed):
    from repro_torch.engine import session as sess_mod
    from repro_torch.pipeline import cost
    be = _SyntheticBackend(per_row, seed=seed)
    monkeypatch.setattr(cost, "time", be)
    prof = calibrate(be, "cuda", rows=sess_mod._calib_rows("cuda"),
                     repeats=1)
    got = (2.0 * 32 * 64 + 64) / prof.flops_per_s
    assert got > 1e-12 and abs(got - per_row) / per_row < 0.2
    assert sess_mod._calib_rows("host") == sess_mod._FAST_CALIB_ROWS


def test_small_probes_lose_the_card_per_row_cost(monkeypatch):
    """The old (64, 512) probe against the same backend: the launch noise
    swamps 448 rows' cost, so the fit is off by far more than 20%."""
    from repro_torch.engine import session as sess_mod
    from repro_torch.pipeline import cost
    errs = []
    for seed in range(4):
        be = _SyntheticBackend(2e-8, seed=seed)
        monkeypatch.setattr(cost, "time", be)
        prof = calibrate(be, "cuda", rows=sess_mod._FAST_CALIB_ROWS,
                         repeats=1)
        errs.append(abs((2.0 * 32 * 64 + 64) / prof.flops_per_s - 2e-8)
                    / 2e-8)
    assert max(errs) > 0.2
