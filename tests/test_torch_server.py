"""Serving-tier parity: the reference ``MorphingServer`` (``backend="numpy"``,
or ``"jax"`` with Pallas in interpret mode) against the port's
(``EngineConfig(backend="torch", torch_device="cpu")``), on the fixtures of
``tests/test_serving.py``.

Scores agree at atol 1e-5 (the trunk tolerance of ``tests/test_backend.py``).
Counters that do not depend on how requests coalesce match exactly:
``requests``, ``rows``, ``requests_by_task``, ``lanes``, ``tasks_by_lane``
and the admission errors' fields. Under sequential traffic the share
counters (``share_hits``, ``share_misses``, ``embed_rows``, ``approx_hits``,
``false_accepts``) match too. Both sessions skip auto-calibration, so both
plan from their data-sheet profiles; the port's are the H100's and the
reference's the TPU's, so row budgets may differ, which is why coalescing
counters are not compared.

A lane key is a trunk fingerprint, which hashes the store's file paths, so
each package's keys are mapped to the tasks riding the lane before they are
compared. Every wait has its own timeout.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro.engine as RE  # noqa: E402
import repro.training.fault as RF  # noqa: E402
from repro.core.task import TaskSpec as RTaskSpec  # noqa: E402
import repro_torch.engine as PE  # noqa: E402
import repro_torch.training as PF  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402
from repro_torch.core.task import TaskSpec as PTaskSpec  # noqa: E402
from repro_torch.kernels import fused_embed  # noqa: E402

ATOL = 1e-5
WAIT = 30.0
EXACT = ("requests", "rows", "requests_by_task", "lanes")
SEQUENTIAL = ("share_hits", "share_misses", "embed_rows", "approx_hits",
              "false_accepts")
SIDES = (("ref", RE, RF, RTaskSpec), ("port", PE, PF, PTaskSpec))


# -- fixtures (tests/test_serving.py's) -------------------------------------

@pytest.fixture(scope="module")
def zoos():
    rng = np.random.default_rng(3)
    src = R.make_task(rng, "gauss", n=120, dim=16, classes=3)
    ring = R.make_task(rng, "ring", n=120, dim=16, classes=3)
    ref = [R.pretrain_model(src, width=12, seed=1, name="m0"),
           R.pretrain_model(ring, width=12, seed=2, name="m1",
                            mode="radial")]
    return {"ref": ref, "port": zoo_from_numpy(ref)}


@pytest.fixture(scope="module")
def table():
    rng = np.random.default_rng(0)
    n = 600
    return {"gender": rng.integers(0, 2, n),
            "len": rng.integers(1, 200, n),
            "emb": rng.standard_normal((n, 16)).astype(np.float32)}


@pytest.fixture(scope="module")
def sample():
    return R.make_task(np.random.default_rng(1), "gauss", n=128, dim=16,
                       classes=3)


def _sessions(tmp_path, zoos, tables, sample, *, ref_backend="numpy",
              ann=None, **cfg):
    """{side: resolved session}: task ``sent`` on model m0 over each of
    ``tables``, decoupled store, no auto-calibration."""
    out = {}
    for side, E, _, TaskSpec in SIDES:
        kw = dict(model_store="decoupled", auto_calibrate=False, **cfg)
        if ann is not None:
            kw.update(cache_tiers=("exact", "ann"), ann=E.AnnConfig(**ann))
        if side == "ref":
            kw["backend"] = ref_backend
        else:
            kw.update(backend="torch", torch_device="cpu")
        sess = E.MorphingSession(zoo=zoos[side], root=tmp_path / side,
                                 config=E.EngineConfig(**kw))
        for name, tab in tables.items():
            sess.register_table(name, {k: v.copy() for k, v in tab.items()})
        sess.create_task(TaskSpec("sent", "series", ("P", "N")))
        sess.registry._resolution["sent"] = 0
        sess.resolve_task("sent", sample.X, sample.y)
        out[side] = sess
    return out


def _server(side, sess, *, policy=None, **kw):
    E = RE if side == "ref" else PE
    if policy is not None:
        kw["policy"] = E.AdmissionPolicy(**policy)
    return E.MorphingServer(session=sess, **kw)


def _fault(side, **kw):
    return (RF if side == "ref" else PF).FaultInjector(**kw)


def _lane_name(sess, key):
    """The tasks riding lane ``key`` (a trunk fingerprint, or a task in
    the per-task ablation)."""
    tasks = sorted(t for t, rm in sess.models.items()
                   if (rm.trunk_fp or rm.version) == key)
    return ",".join(tasks) or key


def _counters(sess, st, names=EXACT):
    out = {n: getattr(st, n) for n in names}
    out["tasks_by_lane"] = {_lane_name(sess, k): v
                            for k, v in st.tasks_by_lane.items()}
    return out


def _predict(srv, where, table="reviews", **kw):
    return srv.predict(f"PREDICT emb USING TASK sent FROM {table}{where}",
                       timeout=WAIT, **kw)


def _error_fields(sess, err):
    d = dict(err.__dict__)
    d["lane"] = _lane_name(sess, d.get("lane"))
    return type(err).__name__, d


# -- scores and counters ------------------------------------------------------

@pytest.mark.parametrize("ref_backend", ["numpy", "jax"])
def test_sequential_traffic_matches_reference(tmp_path, zoos, table, sample,
                                              ref_backend):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample,
                     ref_backend=ref_backend)
    wheres = (" WHERE len > 20", " WHERE len > 60", "", " WHERE len > 20",
              " WHERE len > 150")
    scores, stats = {}, {}
    l0 = fused_embed.launch_count
    for side, s in sess.items():
        with _server(side, s, max_wait_s=0.001) as srv:
            scores[side] = [_predict(srv, w).scores for w in wheres]
        stats[side] = _counters(s, srv.stats(), EXACT + SEQUENTIAL)
        assert [ln.device for ln in srv._lanes.values()] == ["host"]
    assert fused_embed.launch_count == l0          # CPU: the plain version
    for a, b in zip(scores["port"], scores["ref"]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL)
    assert stats["port"] == stats["ref"]
    assert stats["port"]["tasks_by_lane"] == {"sent": 1}
    assert stats["port"]["share_hits"] > 0


def test_warm_repeat_is_all_share_hits(tmp_path, zoos, table, sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    wheres = (" WHERE len > 30", " WHERE len > 90")
    warm = {}
    for side, s in sess.items():
        with _server(side, s) as srv:
            cold = [_predict(srv, w).scores for w in wheres]
            srv.reset_telemetry()
            again = [_predict(srv, w).scores for w in wheres]
            st = srv.stats()
        for a, b in zip(cold, again):
            np.testing.assert_array_equal(a, b)
        assert st.share_hit_rate == 1.0
        assert st.embed_rows == st.embed_batches == 0
        warm[side] = (_counters(s, st, EXACT + SEQUENTIAL), again)
    assert warm["port"][0] == warm["ref"][0]
    for a, b in zip(warm["port"][1], warm["ref"][1]):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_concurrent_traffic_matches_reference(tmp_path, zoos, table, sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    thrs = (20, 60, 100)
    ref_scores = {t: sess["ref"].sql(
        f"PREDICT emb USING TASK sent FROM reviews WHERE len > {t}"
    ).rows["_score"] for t in thrs}
    stats = {}
    for side, s in sess.items():
        srv = _server(side, s, max_wait_s=0.002)
        with srv:
            ids = {}

            def client(thr, srv=srv):
                ids[thr] = [srv.submit("PREDICT emb USING TASK sent FROM "
                                       f"reviews WHERE len > {thr}")
                            for _ in range(4)]

            threads = [threading.Thread(target=client, args=(t,))
                       for t in thrs]
            for t in threads:
                t.start()
            for t in threads:
                t.join(WAIT)
                assert not t.is_alive()
            for thr, rids in ids.items():
                for rid in rids:
                    out = srv.result(rid, timeout=WAIT)
                    np.testing.assert_allclose(out.scores, ref_scores[thr],
                                               atol=ATOL)
        stats[side] = _counters(s, srv.stats())
    assert stats["port"] == stats["ref"]
    assert stats["port"]["requests"] == 12


def test_share_lanes_false_matches_reference(tmp_path, zoos, table, sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    out = {}
    for side, s in sess.items():
        with _server(side, s, share_lanes=False) as srv:
            scores = [_predict(srv, w).scores
                      for w in (" WHERE len > 30", " WHERE len > 30")]
        st = srv.stats()
        assert st.share_hits == st.share_misses == st.dedup_rows == 0
        assert st.embed_rows == 0 and st.head_rows == 0
        out[side] = (scores, _counters(s, st))
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["tasks_by_lane"] == {"sent": 1}
    for a, b in zip(out["port"][0], out["ref"][0]):
        np.testing.assert_allclose(a, b, atol=ATOL)


def test_finetune_delta_joins_its_base_trunk_lane(tmp_path, zoos, table,
                                                  sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    w = np.abs(np.random.default_rng(11).standard_normal(
        sess["ref"].models["sent"].head_dim)).astype(np.float32)
    w /= w.sum()
    out = {}
    for side, E, _, TaskSpec in SIDES:
        s = sess[side]
        s.register_finetune("m0-ft0", "m0", {"head/w": w})
        s.create_task(TaskSpec("sent_ft0", "series", ("P", "N")))
        s.resolve_task("sent_ft0", sample.X, sample.y, model_id="m0-ft0")
        assert s.models["sent_ft0"].trunk_fp == s.models["sent"].trunk_fp
        with _server(side, s, max_wait_s=0.001) as srv:
            scores = [srv.predict(f"PREDICT emb USING TASK {t} FROM "
                                  "reviews WHERE len > 50",
                                  timeout=WAIT).scores
                      for t in ("sent", "sent_ft0")]
        st = srv.stats()
        (lane,) = srv._lanes.values()
        assert sorted(lane.heads) == ["sent", "sent_ft0"]
        out[side] = (scores, _counters(s, st, EXACT + SEQUENTIAL),
                     st.delta_tasks, st.delta_stored_bytes)
    assert out["port"][1:] == out["ref"][1:]
    assert out["port"][1]["tasks_by_lane"] == {"sent,sent_ft0": 2}
    assert out["port"][2] == 1
    for a, b in zip(out["port"][0], out["ref"][0]):
        np.testing.assert_allclose(a, b, atol=ATOL)
    X = table["emb"][table["len"] > 50]
    np.testing.assert_allclose(out["port"][0][1],
                               zoos["ref"][0].features(X) @ w, atol=ATOL)


def test_ann_tier_counts_match_reference(tmp_path, zoos, sample):
    rng = np.random.default_rng(5)
    n = 128
    base = rng.standard_normal((n, 16)).astype(np.float32)
    tables = {"t0": {"emb": base}}
    for name in ("t1", "t2"):
        tables[name] = {"emb": base + rng.standard_normal(
            (n, 16)).astype(np.float32) * 1e-3}
    sess = _sessions(tmp_path, zoos, tables, sample,
                     ann={"error_bound": 0.2, "audit_rate": 0.2})
    out = {}
    for side, s in sess.items():
        with _server(side, s) as srv:
            scores = [_predict(srv, "", table=t).scores
                      for t in ("t0", "t1", "t2")]
            st = srv.stats()
        out[side] = (scores, _counters(s, st, EXACT + SEQUENTIAL))
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1]["approx_hits"] > 0
    assert out["port"][1]["false_accepts"] == 0
    for a, b in zip(out["port"][0], out["ref"][0]):
        np.testing.assert_allclose(a, b, atol=ATOL)


# -- admission and faults -----------------------------------------------------

def test_queue_cap_rejects_like_reference(tmp_path, zoos, table, sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    nrows = len(table["len"])
    errs = {}
    for side, s in sess.items():
        s.backends.set_fault_injector(_fault(side, slow_rate=1.0,
                                             slow_s=0.2))
        srv = _server(side, s, policy={"max_queue_rows": int(nrows * 1.5)})
        with srv:
            r0 = srv.submit("PREDICT emb USING TASK sent FROM reviews")
            time.sleep(0.1)       # the worker is inside the slow step
            r1 = srv.submit("PREDICT emb USING TASK sent FROM reviews")
            with pytest.raises(RE.Rejected if side == "ref"
                               else PE.Rejected) as ei:
                srv.submit("PREDICT emb USING TASK sent FROM reviews",
                           priority="best_effort")
            srv.result(r0, timeout=WAIT)
            srv.result(r1, timeout=WAIT)
        s.backends.set_fault_injector(None)
        st = srv.stats()
        assert st.rejected == 1
        assert st.rejected_by_priority == {"best_effort": 1}
        errs[side] = _error_fields(s, ei.value)
    assert errs["port"] == errs["ref"]
    assert errs["port"][1]["reason"] == "queue_full"


def test_breaker_trip_sheds_with_circuit_open_like_reference(
        tmp_path, zoos, table, sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    out = {}
    for side, s in sess.items():
        E = RE if side == "ref" else PE
        srv = _server(side, s, policy={"retry_limit": 0,
                                       "breaker_threshold": 3,
                                       "breaker_cooldown_s": 60.0})
        with srv:
            _predict(srv, " WHERE len < 20")
            fi = _fault(side, scripted_errors={0, 1, 2})
            s.backends.set_fault_injector(fi)
            for t in (40, 60, 80):        # fresh rows: one trunk call each
                with pytest.raises(E.RequestError):
                    _predict(srv, f" WHERE len < {t}")
            with pytest.raises(E.CircuitOpen) as ei:
                srv.submit("PREDICT emb USING TASK sent FROM reviews "
                           "WHERE len < 100")
            st = srv.stats()
        s.backends.set_fault_injector(None)
        assert st.breaker_trips == 1 and st.failed_batches == 3
        out[side] = (_error_fields(s, ei.value), fi.error_calls,
                     fi.injected_errors, [_lane_name(s, k)
                                          for k in st.breaker_open_lanes])
    assert out["port"] == out["ref"]
    assert out["port"][1] == [0, 1, 2]


def test_injected_fault_retried_to_reference_scores(tmp_path, zoos, table,
                                                    sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    out = {}
    for side, s in sess.items():
        with _server(side, s, policy={"retry_limit": 1,
                                      "retry_backoff_s": 0.001}) as srv:
            _predict(srv, " WHERE len > 150")
            fi = _fault(side, scripted_errors={0})
            s.backends.set_fault_injector(fi)
            got = _predict(srv, " WHERE len < 50").scores
            fi.disarm()
            st = srv.stats()
        s.backends.set_fault_injector(None)
        assert fi.injected_errors == 1
        assert st.retries >= 1 and st.failed_batches == 0
        assert st.breaker_trips == 0
        out[side] = got
    np.testing.assert_allclose(out["port"], out["ref"], atol=ATOL)


def test_deadline_misses_counted_like_reference(tmp_path, zoos, table,
                                                sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    out = {}
    for side, s in sess.items():
        with _server(side, s, policy={}) as srv:
            _predict(srv, " WHERE len > 40", deadline_ms=1e-3)   # missed
            _predict(srv, " WHERE len > 80", deadline_ms=60000.0)
            st = srv.stats()
        out[side] = (st.deadlines_admitted, st.deadline_misses,
                     _counters(s, st, EXACT + SEQUENTIAL))
    assert out["port"] == out["ref"]
    assert out["port"][:2] == (2, 1)


def test_stop_with_stalled_lane_raises_like_reference(tmp_path, zoos, table,
                                                      sample):
    sess = _sessions(tmp_path, zoos, {"reviews": table}, sample)
    msgs = {}
    for side, s in sess.items():
        fi = _fault(side, stall_rate=1.0, stall_s=1.0)
        s.backends.set_fault_injector(fi)
        srv = _server(side, s).start()
        srv.submit("PREDICT emb USING TASK sent FROM reviews")
        deadline = time.monotonic() + WAIT
        while fi.injected_stalls == 0 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert fi.injected_stalls == 1       # the worker is wedged
        t0 = time.perf_counter()
        with pytest.raises(RuntimeError, match="did not join") as ei:
            srv.stop(drain=False, timeout=0.2)
        assert time.perf_counter() - t0 < 5.0
        (key,) = srv._lanes
        assert key in str(ei.value)          # names the stuck lane
        msgs[side] = str(ei.value).replace(key, "<lane>")
        fi.disarm()
        srv.stop(timeout=WAIT)               # the retry joins cleanly
        assert all(ln.batcher._thread is None for ln in srv._lanes.values())
        s.backends.set_fault_injector(None)
    assert msgs["port"] == msgs["ref"]


def test_default_config_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PE.MorphingServer()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PE.DispatchServer()
