"""Dispatch-tier parity: the port's ``DispatchServer`` with
``worker_backend="torch"`` workers on the CPU (``torch_device="cpu"``)
against the reference's with ``worker_backend="numpy"`` workers, on the
fixtures of ``tests/test_dispatch.py``.

Each server spawns two worker processes (a spawn imports torch, so the
file keeps to three servers of the port). Scores agree at atol 1e-5 and
the request and row totals are equal; a worker killed mid-traffic has its
leases re-dispatched to the survivor with the same scores; the ``fault``
command arms a ``FaultInjector`` on a worker's backends, whose lane retry
absorbs it. Every wait has its own timeout.
"""
import time

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro.engine as RE  # noqa: E402
from repro.core.task import TaskSpec as RTaskSpec  # noqa: E402
import repro_torch.engine as PE  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402
from repro_torch.core.task import TaskSpec as PTaskSpec  # noqa: E402

ATOL = 1e-5
WAIT = 120.0


@pytest.fixture(scope="module")
def zoos():
    rng = np.random.default_rng(3)
    src = R.make_task(rng, "gauss", n=120, dim=16, classes=3)
    ref = [R.pretrain_model(src, width=12, seed=1, name="m0")]
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


def _dispatch(side, tmp_path, zoos, table, sample, enable_share=True,
              **kw):
    """(session, DispatchServer with 2 workers) for one package: the
    reference's numpy workers or the port's torch-on-CPU workers."""
    if side == "ref":
        E, TaskSpec, worker_backend = RE, RTaskSpec, "numpy"
        cfg = RE.EngineConfig(model_store="decoupled", backend="numpy",
                              enable_share=enable_share)
    else:
        E, TaskSpec, worker_backend = PE, PTaskSpec, "torch"
        cfg = PE.EngineConfig(model_store="decoupled", backend="numpy",
                              torch_device="cpu", enable_share=enable_share)
    sess = E.MorphingSession(zoo=zoos[side], root=tmp_path / side,
                             config=cfg)
    sess.register_table("reviews", {k: v.copy() for k, v in table.items()})
    sess.create_task(TaskSpec("sent", "series", ("P", "N")))
    sess.registry._resolution["sent"] = 0
    sess.resolve_task("sent", sample.X, sample.y)
    kw.setdefault("placement", E.PlacementPolicy(watermark_rows=1 << 20))
    return sess, E.DispatchServer(session=sess, workers=2,
                                  worker_backend=worker_backend, **kw)


def _sql(thr):
    return f"PREDICT emb USING TASK sent FROM reviews WHERE len > {thr}"


def _reference_scores(tmp_path, zoos, table, sample, thrs):
    """The reference session's scores (its server is never started)."""
    sess, _ = _dispatch("ref", tmp_path, zoos, table, sample)
    return {t: np.asarray(sess.sql(_sql(t)).rows["_score"]) for t in thrs}


def test_dispatch_matches_reference(tmp_path, zoos, table, sample):
    thrs = (20, 60, 100)
    out = {}
    for side in ("ref", "port"):
        sess, srv = _dispatch(side, tmp_path, zoos, table, sample)
        with srv:
            ids = {t: srv.submit(_sql(t)) for t in thrs}
            scores = {t: srv.result(rid, timeout=WAIT).scores
                      for t, rid in ids.items()}
            st = srv.stats()
            hw = {w: h.hw for w, h in srv._workers.items()}
        assert st.workers == 2 and st.alive_workers == 2
        assert st.worker_deaths == 0 and st.redispatches == 0
        assert st.duplicates_dropped == 0 and st.failed_batches == 0
        assert sum(ws.embed_rows for ws in st.per_worker.values()) > 0
        out[side] = (scores, (st.requests, st.rows, st.worker_rows), hw)
    assert out["port"][1] == out["ref"][1]
    assert out["port"][1][0] == 3
    for t in thrs:
        np.testing.assert_allclose(out["port"][0][t], out["ref"][0][t],
                                   atol=ATOL)
    # every port worker calibrated its torch backend before it was ready
    for hw in out["port"][2].values():
        assert hw["cuda"].measured


def test_worker_killed_mid_traffic_redispatches(tmp_path, zoos, table,
                                                sample):
    _, srv = _dispatch("port", tmp_path, zoos, table, sample,
                       monitor_interval_s=0.1, heartbeat_timeout_s=1.0)
    thrs = list(range(10, 110, 10))
    refs = _reference_scores(tmp_path, zoos, table, sample, thrs)
    with srv:
        assert srv.predict(_sql(150), timeout=WAIT).rows > 0
        st0 = srv.stats()
        victim = [w for w, b in st0.staged_bytes_by_worker.items()
                  if b > 0][0]
        # slow the victim so its leases are in flight when it dies
        srv.inject_fault(victim, {"slow_rate": 1.0, "slow_s": 0.5})
        ids = {t: srv.submit(_sql(t)) for t in thrs}
        time.sleep(0.3)
        srv.kill_worker(victim)
        for t, rid in ids.items():
            np.testing.assert_allclose(srv.result(rid, timeout=WAIT).scores,
                                       refs[t], atol=ATOL)
        st = srv.stats()
    assert st.worker_deaths == 1
    assert st.redispatches >= 1
    assert st.duplicates_dropped == 0
    assert st.alive_workers == 1
    staged = [w for w, b in st.staged_bytes_by_worker.items() if b > 0]
    assert staged and victim not in staged


def test_fault_command_reaches_worker_backends(tmp_path, zoos, table,
                                               sample):
    _, srv = _dispatch("port", tmp_path, zoos, table, sample,
                       enable_share=False)
    refs = _reference_scores(tmp_path, zoos, table, sample, (30, 70))
    with srv:
        assert srv.predict(_sql(150), timeout=WAIT).rows > 0
        (wid,) = [w for w, b in srv.stats().staged_bytes_by_worker.items()
                  if b > 0]
        srv.inject_fault(wid, {"scripted_errors": [0], "seed": 5})
        for t, ref in refs.items():
            np.testing.assert_allclose(srv.predict(_sql(t),
                                                   timeout=WAIT).scores,
                                       ref, atol=ATOL)
        srv.inject_fault(wid, None)
        st = srv.stats()
    assert st.retries >= 1
    assert st.per_worker[wid].retries == st.retries
    assert st.failed_batches == 0
    assert st.worker_deaths == 0
