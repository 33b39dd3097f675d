"""Checkpoints and fault tooling, port against reference.

A checkpoint written by either package's ``CheckpointManager`` (through
``save_async``) restores bit for bit in the other, for float32, bfloat16
and sharded leaves, full or by elastic host range; both write the same
bytes (``index.json`` and every ``.mvec`` shard). ``FaultInjector`` with one
seed fails the same call indices in both packages, and
``StragglerMonitor``, ``ElasticScaler`` and ``TrainController`` give the
same answers on the same inputs.
"""
import json

import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.storage as RS  # noqa: E402
import repro.training.fault as RF  # noqa: E402
import repro_torch.storage as PS  # noqa: E402
import repro_torch.training as PF  # noqa: E402

KINDS = ("f32", "bf16", "sharded")


def _arrays(kind):
    """numpy leaves of one kind: {name: array} (bf16 as ml_dtypes)."""
    rng = np.random.default_rng(1)
    p = rng.standard_normal((12, 6)).astype(np.float32)
    m = rng.standard_normal((12, 6)).astype(np.float32)
    if kind == "bf16":
        p, m = p.astype(ml_dtypes.bfloat16), m.astype(ml_dtypes.bfloat16)
    return {"p": p, "m": m, "step": np.int32(5)}


def _ref_state(a):
    return {"p": a["p"], "opt": {"m": a["m"]}, "step": a["step"]}


def _port_state(a):
    def t(x):
        x = np.asarray(x)
        if x.dtype == ml_dtypes.bfloat16:
            return torch.from_numpy(x.view(np.int16).copy()).view(
                torch.bfloat16)
        return torch.from_numpy(x.copy())
    return {"p": t(a["p"]), "opt": {"m": t(a["m"])}, "step": a["step"]}


def _bits(x):
    """Raw bit pattern of a restored leaf, whichever package restored it."""
    if isinstance(x, torch.Tensor):
        x = (x.view(torch.int16).numpy() if x.dtype == torch.bfloat16
             else x.numpy())
    x = np.asarray(x)
    return x.view(np.uint16) if x.dtype.itemsize == 2 else x


def _leaves(state):
    return [state["p"], state["opt"]["m"], state["step"]]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("writer", ["ref", "port"])
def test_checkpoint_restores_bit_exact_across_packages(tmp_path, kind,
                                                       writer):
    a = _arrays(kind)
    shards = 3 if kind == "sharded" else 1
    states = {"ref": _ref_state(a), "port": _port_state(a)}
    managers = {"ref": RS.CheckpointManager(tmp_path / "ckpt"),
                "port": PS.CheckpointManager(tmp_path / "ckpt")}
    reader = "port" if writer == "ref" else "ref"
    managers[writer].save_async(7, states[writer], num_shards=shards)
    managers[writer].wait()
    assert managers[reader].all_steps() == [7]
    got, step = managers[reader].restore(states[reader])
    assert step == 7
    for g, want in zip(_leaves(got), _leaves(_ref_state(a))):
        assert g.shape == np.shape(want)
        np.testing.assert_array_equal(_bits(g), _bits(want))
    if kind == "bf16":
        assert (got["p"].dtype == torch.bfloat16 if reader == "port"
                else got["p"].dtype == ml_dtypes.bfloat16)
    # elastic: the host ranges of 2 hosts
    rows = a["p"].shape[0]
    for h in range(2):
        lo, hi = rows * h // 2, rows * (h + 1) // 2
        part, _ = managers[reader].restore(states[reader], shard=h,
                                           num_hosts=2)
        np.testing.assert_array_equal(_bits(part["p"]),
                                      _bits(a["p"][lo:hi]))


@pytest.mark.parametrize("kind", KINDS)
def test_checkpoint_bytes_equal_across_packages(tmp_path, kind):
    a = _arrays(kind)
    shards = 3 if kind == "sharded" else 1
    dirs = {}
    for side, cm, state in (
            ("ref", RS.CheckpointManager(tmp_path / "r"), _ref_state(a)),
            ("port", PS.CheckpointManager(tmp_path / "p"), _port_state(a))):
        dirs[side] = cm.save(3, state, num_shards=shards)
    index = {s: json.loads((d / "index.json").read_text())
             for s, d in dirs.items()}
    assert index["port"] == index["ref"]
    files = sorted(f for meta in index["ref"].values()
                   for f in meta["shards"])
    assert len(files) == (7 if kind == "sharded" else 3)
    for f in files:
        assert (dirs["port"] / f).read_bytes() == (dirs["ref"] / f).read_bytes()


def test_save_async_snapshots_torch_leaves(tmp_path):
    """The snapshot is taken before save_async returns: an in-place update
    right after it is not in the checkpoint."""
    cm = PS.CheckpointManager(tmp_path)
    w = torch.zeros(4, 3)
    cm.save_async(1, {"w": w})
    w += 1.0
    cm.wait()
    got, _ = cm.restore({"w": w})
    np.testing.assert_array_equal(got["w"], np.zeros((4, 3), np.float32))


class _Spec:
    kind, task = "embed", "t"


@pytest.mark.parametrize("seed", [0, 7])
def test_fault_injector_same_seed_same_calls(seed):
    calls = {}
    for side, F in (("ref", RF), ("port", PF)):
        fi = F.FaultInjector(error_rate=0.3, slow_rate=0.2, stall_rate=0.1,
                             scripted_errors=(2,), seed=seed)
        raised = []
        for i in range(60):
            try:
                fi.on_infer(_Spec(), 8)
            except F.InjectedFault:
                raised.append(i)
        fi.disarm()
        fi.on_infer(_Spec(), 8)               # disarmed: no roll, no count
        calls[side] = (fi.error_calls, raised, fi.calls, fi.injected_errors,
                       fi.injected_slow, fi.injected_stalls)
    assert calls["port"] == calls["ref"]
    assert calls["port"][0] == calls["port"][1]
    assert 2 in calls["port"][0] and calls["port"][2] == 60


def test_straggler_monitor_same_answers():
    rng = np.random.default_rng(4)
    times = rng.uniform(0.5, 1.5, (12, 5))
    times[:, 3] *= 3.0                         # host 3 straggles
    out = {}
    for side, F in (("ref", RF), ("port", PF)):
        mon = F.StragglerMonitor(threshold=2.0, window=8, min_samples=4)
        seen = []
        for row in times:
            for h, t in enumerate(row):
                mon.record(h, float(t))
            seen.append(mon.stragglers())
        out[side] = seen
    assert out["port"] == out["ref"]
    assert out["port"][-1] == [3] and out["port"][0] == []


def test_elastic_scaler_same_plan(tmp_path):
    state = {"p": np.arange(48, dtype=np.float32).reshape(24, 2)}
    PS.CheckpointManager(tmp_path).save(5, state, num_shards=4)
    plans = {}
    for side, F, S in (("ref", RF, RS), ("port", PF, PS)):
        es = F.ElasticScaler(num_hosts=5)
        es.fail(1)
        es.fail(3)
        plan = es.reshard_plan(S.CheckpointManager(tmp_path),
                               {"p": state["p"][:8]})
        plans[side] = (es.layout(), {h: (p["p"].tolist(), s)
                                     for h, (p, s) in plan.items()})
    assert plans["port"] == plans["ref"]
    assert plans["port"][0] == {"dp_degree": 3, "hosts": [0, 2, 4]}


def test_train_controller_restarts_like_reference(tmp_path):
    out = {}
    for side, F, S in (("ref", RF, RS), ("port", PF, PS)):
        fail_at = {17, 23}

        def step_fn(state, step, fail_at=fail_at):
            if step in fail_at:
                fail_at.discard(step)          # each fails once
                raise RuntimeError(f"simulated preemption at {step}")
            return {"w": state["w"] + 1.0}

        tc = F.TrainController(step_fn, S.CheckpointManager(tmp_path / side),
                               ckpt_every=5)
        state, step = tc.run({"w": np.zeros(3)}, 30, num_shards=2)
        out[side] = (np.asarray(state["w"]).tolist(), step,
                     [(k, {n: v for n, v in info.items() if n != "error"})
                      for k, info in tc.events])
    assert out["port"] == out["ref"]
    assert out["port"][:2] == ([30.0] * 3, 30)
