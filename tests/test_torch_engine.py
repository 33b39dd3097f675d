"""End-to-end port parity: the same SQL on the reference session
(``repro.engine.MorphingSession(backend="jax")``, Pallas in interpret mode)
and on the port's (``backend="torch"``, ``torch_device="cpu"``).

Both sessions resolve their task through their own ``ModelSelector``, the
port's with the reference's NMF init injected, and must pick the same
model. Rows and scores agree at atol 1e-5 (the backends' float32 trunk
tolerance; aggregation is the same host code in both). Report counters
must match the reference's contract: one staging, no new shapes on a warm
repeat, share hit rate 1.0 on the repeat. The linear-only zoo makes the
``fused_embed`` path certain; the default zoo resolves what the selector
picks (a proj1d model for this sample).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro.engine as RE  # noqa: E402
import repro_torch.core as P  # noqa: E402
import repro_torch.engine as PE  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402
from repro_torch.kernels import fused_embed  # noqa: E402

ATOL = 1e-5
N_ROWS = 1500
QUERIES = [
    "SELECT gender, AVG(t(emb)) FROM reviews WHERE len > 20 GROUP BY gender",
    "PREDICT emb USING TASK t FROM reviews WHERE len > 150",
    "SELECT gender, AVG(t(emb)) FROM reviews WHERE len > 1000 GROUP BY gender",
]


def _reference_init(V, k, seed=0):
    jnp = jax.numpy
    V = jnp.asarray(V, jnp.float32)
    r1, r2 = jax.random.split(jax.random.PRNGKey(seed))
    scale = jnp.sqrt(jnp.maximum(V.mean(), 1e-9) / k)
    W = jax.random.uniform(r1, (V.shape[0], k), jnp.float32, 0.1, 1.0)
    H = jax.random.uniform(r2, (V.shape[1], k), jnp.float32, 0.1, 1.0)
    return np.asarray(W * scale), np.asarray(H * scale)


@pytest.fixture(scope="module")
def worlds():
    """zoo kind -> (reference zoo, reference selector, port zoo, port
    selector)."""
    full = R.build_zoo(16, seed=0)
    hist = R.build_tasks(24, seed=1)
    fz = R.TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    out = {}
    for kind, zoo, k, anchors in (
            ("linear", [m for m in full if m.mode == "linear"], 2, 2),
            ("default", full, 6, 3)):
        V = R.transfer_matrix(zoo, hist)
        rsel = R.ModelSelector(k=k, n_anchors=anchors).fit_offline(
            V, feats, zoo=zoo)
        pzoo = zoo_from_numpy(zoo)
        psel = P.ModelSelector(k=k, n_anchors=anchors).fit_offline(
            V, feats, zoo=pzoo, nmf_init=_reference_init(V, k))
        out[kind] = (zoo, rsel, pzoo, psel)
    return out


def _table():
    rng = np.random.default_rng(0)
    return {"gender": rng.integers(0, 2, N_ROWS),
            "len": rng.integers(1, 200, N_ROWS),
            "emb": rng.standard_normal((N_ROWS, 16)).astype(np.float32)}


def _run(sess):
    """CREATE TASK, resolve, then every query cold and the first again
    warm. Returns (results, repeat result, resolved model, backend)."""
    sess.register_table("reviews", _table())
    sess.sql("CREATE TASK t (INPUT=Series, OUTPUT IN ('POS','NEG','NEU'), "
             "TYPE='Classification');")
    sample = R.make_task(np.random.default_rng(7), "gauss", n=128, dim=16,
                         classes=3)
    rm = sess.resolve_task("t", sample.X, sample.y)
    backend = next(iter({id(b): b for b in sess.backends.values()}
                        .values()))
    res = [sess.sql(q) for q in QUERIES]
    return res, sess.sql(QUERIES[0]), rm, backend


@pytest.mark.parametrize("store", ["blob", "decoupled"])
@pytest.mark.parametrize("zoo_kind", ["linear", "default"])
def test_same_sql_same_rows(worlds, zoo_kind, store, tmp_path):
    zoo, rsel, pzoo, psel = worlds[zoo_kind]
    ref = RE.MorphingSession(selector=rsel, zoo=zoo, root=tmp_path / "r",
                             backend="jax", model_store=store)
    l0 = fused_embed.launch_count
    port = PE.MorphingSession(
        selector=psel, zoo=pzoo, root=tmp_path / "p",
        config=PE.EngineConfig(backend="torch", torch_device="cpu",
                               model_store=store))
    r_res, r_warm, r_rm, r_b = _run(ref)
    p_res, p_warm, p_rm, p_b = _run(port)

    assert p_rm.model_id == r_rm.model_id
    if zoo_kind == "linear":
        assert p_rm.zoo_model.mode == "linear"
    assert fused_embed.launch_count == l0       # CPU: the plain version
    for a, b, q in zip(p_res, r_res, QUERIES):
        assert list(a.rows) == list(b.rows), q
        for col in b.rows:
            np.testing.assert_allclose(np.asarray(a.rows[col], np.float64),
                                       np.asarray(b.rows[col], np.float64),
                                       atol=ATOL, err_msg=f"{q}: {col}")
        assert a.report.rows_out == b.report.rows_out
        assert a.report.resolution == b.report.resolution
        assert set(a.report.backend_of.values()) == {"torch"}
    assert p_res[2].report.rows_out == 0        # WHERE filtered every row
    np.testing.assert_allclose(p_warm.rows["mean__score"],
                               r_warm.rows["mean__score"], atol=ATOL)
    # counters: staged once, warm repeat adds no shapes, all share hits
    assert p_b.stage_count == r_b.stage_count == 1
    assert p_res[0].report.compile_count == r_res[0].report.compile_count
    assert p_warm.report.compile_count == r_warm.report.compile_count == 0
    assert p_warm.report.share_hit_rate == r_warm.report.share_hit_rate \
        == 1.0


def test_resolved_trunk_stages_on_the_session_device(worlds, tmp_path):
    zoo, rsel, pzoo, psel = worlds["linear"]
    sess = PE.MorphingSession(
        selector=psel, zoo=pzoo, root=tmp_path,
        config=PE.EngineConfig(backend="torch", torch_device="cpu"))
    res, _, rm, backend = _run(sess)
    staged = backend._staged[rm.trunk_fp or rm.version]
    assert staged.mode == "linear"
    assert backend.device.type == "cpu"
    assert res[0].report.batch_rows > 0
