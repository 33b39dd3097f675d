"""Port parity for ``core/``: NMF, two-phase selection, and the copied
zoo/task substrate, against the reference package.

The reference seeds NMF from ``jax.random``, which torch cannot reproduce,
so the tests rebuild that init here (same key split as the reference's
``nmf``) and hand it to the port through ``init=`` / ``nmf_init=``.

Tolerances: NMF W, H and loss to rtol 1e-4 (float32 multiplicative
updates; XLA and torch sum the small products in different orders, and
~400 iterations carry that rounding along; measured here: 8e-6).
Selector scores to atol 1e-5: the NMF rounding carried through the
forest's leaf means and one dot product (measured here: 3e-7, while the
reference's top-1 margins on these samples are 4.6e-4 to 1.1e-2).
``chosen`` must agree wherever the top-1 margin exceeds that tolerance.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro_torch.convert import zoo_from_numpy  # noqa: E402

NMF_RTOL = 1e-4
SCORE_ATOL = 1e-5


def reference_init(V, k, seed=0):
    """The reference ``nmf``'s start: uniform(0.1, 1) * sqrt(mean(V)/k)
    from ``jax.random.split(PRNGKey(seed))``."""
    V = jnp.asarray(V, jnp.float32)
    M, N = V.shape
    r1, r2 = jax.random.split(jax.random.PRNGKey(seed))
    scale = jnp.sqrt(jnp.maximum(V.mean(), 1e-9) / k)
    W = jax.random.uniform(r1, (M, k), jnp.float32, 0.1, 1.0) * scale
    H = jax.random.uniform(r2, (N, k), jnp.float32, 0.1, 1.0) * scale
    return np.asarray(W), np.asarray(H)


@pytest.fixture(scope="module")
def world():
    zoo = R.build_zoo(16, seed=0)
    hist = R.build_tasks(24, seed=1)
    V = R.transfer_matrix(zoo, hist)
    fz = R.TaskFeaturizer()
    feats = np.stack([fz.features(t.X, t.y) for t in hist])
    return zoo, hist, V, feats


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("k", [2, 6])
def test_nmf_matches_reference_with_its_init(world, masked, k):
    V = world[2]
    mask = None
    if masked:
        mask = (np.random.default_rng(3).random(V.shape) < 0.8) \
            .astype(np.float32)
    ref = R.nmf(V, k, iters=400, mask=mask, seed=0)
    got = P.nmf(V, k, iters=400, mask=mask,
                init=reference_init(V, k, seed=0))
    for a, b in ((got.W, ref.W), (got.H, ref.H),
                 (got.loss_curve, ref.loss_curve)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=NMF_RTOL,
                                   atol=1e-7)
    assert abs(P.reconstruction_error(V, got.W, got.H, mask)
               - R.reconstruction_error(V, ref.W, ref.H, mask)) < 1e-5


def test_nmf_seeded_init_is_deterministic_and_nonnegative(world):
    V = world[2]
    a = P.nmf(V, 4, iters=50, seed=5)
    b = P.nmf(V, 4, iters=50, seed=5)
    np.testing.assert_array_equal(a.W, b.W)
    assert (a.W >= 0).all() and (a.H >= 0).all()
    assert a.loss_curve[-1] <= a.loss_curve[5] + 1e-5


def test_nmf_rejects_misshaped_init(world):
    V = world[2]
    W0, H0 = reference_init(V, 3)
    with pytest.raises(ValueError):
        P.nmf(V, 4, iters=5, init=(W0, H0))


@pytest.fixture(scope="module")
def selectors(world):
    zoo, hist, V, feats = world
    ref = R.ModelSelector(k=6, n_anchors=3).fit_offline(V, feats, zoo=zoo)
    port = P.ModelSelector(k=6, n_anchors=3).fit_offline(
        V, feats, zoo=zoo_from_numpy(zoo),
        nmf_init=reference_init(V, 6, seed=0))
    return ref, port


def _samples():
    """The 24 resolution samples: four families, seeds 0-5."""
    return [(fam, s, R.make_task(np.random.default_rng(s), fam, n=128,
                                 dim=16, classes=3))
            for fam in R.FAMILIES for s in range(6)]


@pytest.mark.parametrize("fam", list(R.FAMILIES))
def test_selector_scores_and_choice_match_reference(selectors, fam):
    ref, port = selectors
    for f, seed, task in _samples():
        if f != fam:
            continue
        a = ref.select(task.X, task.y)
        b = port.select(task.X, task.y)
        np.testing.assert_allclose(b.scores, a.scores, atol=SCORE_ATOL)
        top2 = np.sort(a.scores)[-2:]
        if top2[1] - top2[0] > SCORE_ATOL:
            assert b.chosen == a.chosen, (fam, seed)


def test_selector_offline_state_matches_reference(selectors):
    ref, port = selectors
    np.testing.assert_allclose(port.W, ref.W, rtol=NMF_RTOL, atol=1e-7)
    np.testing.assert_allclose(port.H, ref.H, rtol=NMF_RTOL, atol=1e-7)
    assert port.anchor_idx == ref.anchor_idx
    assert abs(port.recon_error - ref.recon_error) < 1e-5


def test_zoo_tasks_and_transfer_matrix_equal_reference(world):
    zoo, hist, V, _ = world
    pzoo = P.build_zoo(16, seed=0)
    for a, b in zip(pzoo, zoo):
        assert (a.name, a.mode, a.source_family) == \
            (b.name, b.mode, b.source_family)
        np.testing.assert_array_equal(a.W, b.W)
        if b.centers is None:
            assert a.centers is None
        else:
            np.testing.assert_array_equal(a.centers, b.centers)
        assert a.sigma == b.sigma
    phist = P.build_tasks(24, seed=1)
    for a, b in zip(phist, hist):
        np.testing.assert_array_equal(a.X, b.X)
        np.testing.assert_array_equal(a.y, b.y)
    np.testing.assert_array_equal(P.transfer_matrix(pzoo, phist), V)


def test_zoo_from_numpy_carries_weights(world):
    zoo = world[0]
    conv = zoo_from_numpy(zoo)
    X = np.random.default_rng(0).standard_normal((9, 16)).astype(np.float32)
    for a, b in zip(conv, zoo):
        assert isinstance(a, P.ZooModel) and a.mode == b.mode
        np.testing.assert_array_equal(a.features(X), b.features(X))
