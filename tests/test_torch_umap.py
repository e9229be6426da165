"""The port's UMAP (ark_tpu_torch.ops.umap) against the JAX package's, on the
CPU, on the same seeded inputs.

Tolerances, each with its reason:

- k-NN: distances rtol 1e-5 (atol 1e-6): both expand |r|^2 - 2 r.c + |c|^2
  in f32, with the products summed in another order. Neighbour lists are
  equal row by row, except in rows with a near-tie: two of the row's k + 1
  smallest squared distances closer than NEAR_TIE * (|r|^2 + max |c|^2),
  the size of the expansion's f32 rounding, where either order is right.
- bandwidths, edge weights: rtol 1e-5 (exp and a 15-term sum in another
  order; a bisection step decided the other way moves sigma by less).
- ``_optimize``, given the JAX package's own negatives: atol 2e-5 after one
  epoch and 1e-4 after 3 to 6, on coordinates of size ~10-30 (XLA's CPU
  backend fuses multiply-adds inside the jitted scan and its pow differs in
  the last bits, so not bitwise). The epochs are a chaotic map: a term near
  its +-4 clip, or a negative that lands beside its point (1 / (0.001 + d^2)),
  multiplies a last-bit difference, so after 8 epochs at the full learning
  rate single coordinates part further (2.6e-4 seen, 1 of 1200). There
  99.5% of the coordinates are held to 1e-4 and every one to 5e-3.
- PCA: equal up to a sign per component, rtol 1e-5 of the largest score.
- The seeded negatives are the port's own stream (``jax.random`` cannot be
  replayed): held to a Python-integer reference bit for bit, and to
  uniformity on [0, n) by a chi-square bound. The whole fit is held to the
  quality bars of tests/ops/test_umap_quality.py, never to a looser
  tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.ops import umap as JU
from ark_tpu_torch.ops import segment_reduce
from ark_tpu_torch.ops import umap as TU

torch.set_num_threads(2)

NEAR_TIE = 8 * 2.0 ** -24
RTOL = 1e-5
OPT_ATOL = 1e-4


def _blobs(seed, k=4, n_per=50, d=8, sep=8.0, scale=0.4):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * sep
    data = (centers[:, None, :] + rng.normal(0, scale, (k, n_per, d))).reshape(-1, d)
    labels = np.repeat(np.arange(k), n_per)
    perm = rng.permutation(len(data))
    return data[perm].astype(np.float32), labels[perm]


def _near_tie_rows(data, k):
    """Rows whose k + 1 smallest squared distances (f64, self excluded)
    hold two closer than NEAR_TIE * (|r|^2 + max |c|^2)."""
    x = data.astype(np.float64)
    sq = (x * x).sum(1)
    d2 = sq[:, None] - 2.0 * x @ x.T + sq[None, :]
    np.fill_diagonal(d2, np.inf)
    smallest = np.sort(d2, axis=1)[:, :k + 1]
    return (np.diff(smallest, axis=1) < NEAR_TIE * (sq[:, None] + sq.max())).any(axis=1)


@pytest.mark.parametrize("n,c,k,block_rows,block_cols", [
    (200, 5, 15, 4096, 2048), (2000, 20, 15, 4096, 2048), (2500, 8, 10, 512, 256),
    (300, 3, 299, 128, 256), (20, 4, 30, 4096, 2048)])
def test_knn_matches_jax(n, c, k, block_rows, block_cols):
    data = np.random.default_rng(n).normal(size=(n, c)).astype(np.float32)
    want_i, want_d = JU._knn(jnp.asarray(data), k, block_rows, block_cols)
    got_i, got_d = TU._knn(torch.as_tensor(data), k, block_rows, block_cols)
    want_i, want_d = np.asarray(want_i), np.asarray(want_d)
    assert got_i.shape == want_i.shape == (n, min(k, n - 1))
    np.testing.assert_allclose(got_d.numpy(), want_d, rtol=RTOL, atol=1e-6)
    ties = _near_tie_rows(data, min(k, n - 2))
    assert ties.mean() < 0.25                   # the rule excuses few rows
    np.testing.assert_array_equal(got_i.numpy()[~ties], want_i[~ties])
    assert (got_i.numpy() != np.arange(n)[:, None]).all()          # self excluded
    assert (np.diff(got_d.numpy(), axis=1) >= 0).all()             # ascending


def test_knn_duplicate_points_and_tf32_refusal():
    """Coincident points are each other's nearest, at a distance of the
    expansion's rounding (as in the JAX package) against ~2 to any other;
    a TF32 matmul setting is refused (it flips neighbour ranks)."""
    data = np.random.default_rng(0).normal(size=(50, 6)).astype(np.float32)
    data[10] = data[3]
    idx, d = TU._knn(torch.as_tensor(data), 5)
    assert idx[10, 0] == 3 and idx[3, 0] == 10 and d[10, 0] < 5e-3 and d[3, 0] < 5e-3
    assert d[:, 1].min() > 0.5
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            TU._knn(torch.as_tensor(data), 5)
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.fixture(scope="module")
def graph():
    """The JAX package's neighbour lists of 600 seeded points, for the
    stages downstream of the k-NN."""
    data, labels = _blobs(3, k=4, n_per=150, d=10)
    idx, dists = JU._knn(jnp.asarray(data), 15)
    return data, np.asarray(idx), np.asarray(dists)


def test_smooth_knn_matches_jax(graph):
    _, _, dists = graph
    want_rho, want_sigma = JU._smooth_knn(jnp.asarray(dists))
    got_rho, got_sigma = TU._smooth_knn(torch.as_tensor(dists))
    np.testing.assert_array_equal(got_rho.numpy(), np.asarray(want_rho))
    np.testing.assert_allclose(got_sigma.numpy(), np.asarray(want_sigma), rtol=RTOL)
    # the definition: sum_j exp(-(d_ij - rho_i) / sigma_i) = log2(k)
    total = np.exp(-np.maximum(dists - dists[:, :1], 0) / got_sigma.numpy()[:, None]).sum(1)
    np.testing.assert_allclose(total, np.log2(15), rtol=1e-4)


def _jax_edges(idx, dists):
    """The fuzzy-set symmetrisation as UMAP.fit_transform writes it."""
    idx, dists = jnp.asarray(idx), jnp.asarray(dists)
    n, k = idx.shape
    rho, sigma = JU._smooth_knn(dists)
    w = jnp.exp(-jnp.maximum(dists - rho[:, None], 0.0) / sigma[:, None])
    heads = jnp.repeat(jnp.arange(n), k)
    tails = idx.reshape(-1)
    wflat = w.reshape(-1)
    w_rev = jnp.sum(jnp.take(w, tails, axis=0)
                    * (jnp.take(idx, tails, axis=0) == heads[:, None]), axis=1)
    return np.asarray(heads), np.asarray(tails), np.asarray(wflat + w_rev - wflat * w_rev)


def test_edge_weights_match_jax(graph):
    _, idx, dists = graph
    want_h, want_t, want_w = _jax_edges(idx, dists)
    got_h, got_t, got_w = TU.fuzzy_graph(torch.as_tensor(idx).long(), torch.as_tensor(dists))
    np.testing.assert_array_equal(got_h.numpy(), want_h)
    np.testing.assert_array_equal(got_t.numpy(), want_t)
    np.testing.assert_allclose(got_w.numpy(), want_w, rtol=RTOL, atol=1e-7)
    assert got_w.min() > 0 and got_w.max() <= 1


def _jax_negatives(seed, n_epochs, rate, n_edges, n):
    """The draws of ``ark_tpu.ops.umap._optimize``'s scan, replayed: one
    split of the key and one randint an epoch."""
    key = jax.random.PRNGKey(seed)
    out = []
    for _ in range(n_epochs):
        key, sub = jax.random.split(key)
        out.append(np.asarray(jax.random.randint(sub, (rate, n_edges), 0, n)))
    return np.stack(out)


@pytest.mark.parametrize("n_epochs,rate,n_components,as_callable,atol,outliers", [
    (1, 5, 2, False, 2e-5, 0.0), (3, 5, 2, False, OPT_ATOL, 0.0),
    (8, 5, 2, False, OPT_ATOL, 0.005), (5, 2, 3, True, OPT_ATOL, 0.0),
    (6, 0, 2, False, OPT_ATOL, 0.0)])
def test_optimize_matches_jax_given_its_negatives(graph, n_epochs, rate, n_components,
                                                  as_callable, atol, outliers):
    data, idx, dists = graph
    heads, tails, w = _jax_edges(idx, dists)
    n = len(data)
    emb0 = np.asarray(JU._pca(jnp.asarray(data), n_components))
    emb0 = (emb0 / (np.abs(emb0).max() + 1e-12) * 10.0).astype(np.float32)
    want = np.asarray(JU._optimize(
        jnp.asarray(emb0), jnp.asarray(heads), jnp.asarray(tails), jnp.asarray(w),
        jax.random.PRNGKey(11), n_epochs=n_epochs, negative_sample_rate=rate))
    negs = torch.as_tensor(_jax_negatives(11, n_epochs, rate, len(heads), n))
    got = TU._optimize(
        torch.as_tensor(emb0), torch.as_tensor(heads), torch.as_tensor(tails),
        torch.as_tensor(w), n_epochs=n_epochs, negative_sample_rate=rate,
        negatives=(lambda epoch: negs[epoch]) if as_callable else negs).numpy()
    assert np.abs(want - emb0).max() > 0.1            # the epochs moved the points
    err = np.abs(got - want)
    assert (err > atol).mean() <= outliers and err.max() <= (5e-3 if outliers else atol)


def test_optimize_sums_through_segment_sum(graph, monkeypatch):
    """Two plans a fit and two sorted segment sums an epoch, each with the
    background row (point 0 is a point), over ids in ascending order."""
    data, idx, dists = graph
    heads, tails, w = (torch.as_tensor(a) for a in _jax_edges(idx, dists))
    calls = {"plan": 0, "sum": []}
    real_plan, real_sum = segment_reduce.segment_plan, segment_reduce.segment_sum

    def plan(labels, num_segments):
        calls["plan"] += 1
        return real_plan(labels, num_segments)

    def seg_sum(values, labels, num_segments, plan=None, background=True):
        assert plan is not None and background and labels.dtype == torch.int32
        assert bool((labels[1:] >= labels[:-1]).all()) and values.shape[1] == 2
        calls["sum"].append(num_segments)
        return real_sum(values, labels, num_segments, plan, background)

    monkeypatch.setattr(segment_reduce, "segment_plan", plan)
    monkeypatch.setattr(segment_reduce, "segment_sum", seg_sum)
    emb0 = torch.as_tensor(np.random.default_rng(0).normal(size=(len(data), 2)),
                           dtype=torch.float32)
    TU._optimize(emb0, heads, tails, w, seed=1, n_epochs=4)
    assert calls == {"plan": 2, "sum": [len(data)] * 8}


@pytest.mark.parametrize("n,c,n_components", [(500, 10, 2), (2000, 20, 3), (30, 4, 2)])
def test_pca_matches_jax_up_to_sign(n, c, n_components):
    rng = np.random.default_rng(n)
    data = (rng.normal(size=(n, c)) * np.linspace(3.0, 0.5, c) + 5.0).astype(np.float32)
    want = np.asarray(JU.pca_transform(data, n_components))
    got = TU.pca_transform(data, n_components, device="cpu")
    assert got.shape == want.shape == (n, n_components) and got.dtype == np.float32
    for comp in range(n_components):
        sign = np.sign(np.dot(got[:, comp], want[:, comp]))
        np.testing.assert_allclose(got[:, comp], sign * want[:, comp], rtol=RTOL,
                                   atol=RTOL * np.abs(want).max())
    # the port's own convention: each axis' largest entry is positive, so a
    # flipped input column flips the scores and nothing else
    np.testing.assert_array_equal(TU.pca_transform(data, n_components, device="cpu"), got)


def test_pca_matches_sklearn_subspace():
    from sklearn.decomposition import PCA

    data, _ = _blobs(5, k=3, n_per=40, d=10)
    ours = TU.pca_transform(data, n_components=2, device="cpu")
    sk = PCA(n_components=2).fit_transform(data)
    for comp in range(2):
        assert abs(np.corrcoef(ours[:, comp], sk[:, comp])[0, 1]) > 0.99
    assert ours[:, 0].var() >= ours[:, 1].var()


def test_find_ab_params_equal():
    assert TU.find_ab_params() == JU.find_ab_params() == (TU._A, TU._B)
    np.testing.assert_allclose(TU.find_ab_params(1.5, 0.3), JU.find_ab_params(1.5, 0.3),
                               rtol=1e-12)


@pytest.mark.parametrize("seed,epoch,rate,n_edges,n", [(42, 0, 5, 300, 1000),
                                                       (7, 199, 5, 123, 101_932),
                                                       (2 ** 40 + 3, 3, 1, 64, 2 ** 31 - 1),
                                                       (0, 5, 0, 10, 4)])
def test_negatives_equal_the_integer_reference(seed, epoch, rate, n_edges, n):
    """The torch hash (wrapping int64 ops) against the same splitmix64 in
    Python integers: bit for bit, so every device that wraps mod 2^64 draws
    the same negatives."""
    got = TU.draw_negatives(seed, epoch, rate, n_edges, n, "cpu")
    assert got.shape == (rate, n_edges) and got.dtype == torch.int64
    key = TU._splitmix64(seed)
    want = [((TU._splitmix64(key + epoch * rate * n_edges + c) >> 32) * n) >> 32
            for c in range(rate * n_edges)]
    np.testing.assert_array_equal(got.reshape(-1).numpy(), np.array(want, np.int64))
    assert TU._splitmix64(0) == 0 and TU._splitmix64(1) == 0x5692161D100B05E5


def test_negatives_are_uniform_and_differ_by_epoch_and_seed():
    n, draws = 500, 5 * 200_000
    a = TU.draw_negatives(42, 0, 5, 200_000, n, "cpu").reshape(-1).numpy()
    assert a.min() >= 0 and a.max() == n - 1
    counts = np.bincount(a, minlength=n)
    chi2 = ((counts - draws / n) ** 2 / (draws / n)).sum()
    # chi-square with 499 degrees of freedom: mean 499, sd 31.6
    assert 350 < chi2 < 660, chi2
    b = TU.draw_negatives(42, 1, 5, 200_000, n, "cpu").reshape(-1).numpy()
    c = TU.draw_negatives(43, 0, 5, 200_000, n, "cpu").reshape(-1).numpy()
    for other in (b, c):
        assert 0.9 / n < (a == other).mean() < 1.1 / n + 1e-3
    # consecutive draws are uncorrelated
    assert abs(np.corrcoef(a[:-1], a[1:])[0, 1]) < 0.01
    with pytest.raises(ValueError):
        TU.draw_negatives(1, 0, 5, 10, 2 ** 31, "cpu")


def test_umap_embedding_preserves_cluster_structure():
    """The quality bars of tests/ops/test_umap_quality.py on the port."""
    from scipy.spatial.distance import cdist

    data, labels = _blobs(12345)
    timings = {}
    emb = TU.UMAP(n_neighbors=10, n_epochs=150, device="cpu",
                  timings=timings).fit_transform(data)
    assert emb.shape == (len(data), 2) and np.isfinite(emb).all()
    assert sorted(timings) == ["graph_s", "knn_s", "optimize_s", "pca_s"]
    d = cdist(emb, emb)
    np.fill_diagonal(d, np.inf)
    nn = d.argsort(1)[:, :5]
    assert (labels[nn] == labels[:, None]).mean() > 0.9
    cents = np.stack([emb[labels == i].mean(0) for i in range(4)])
    within = np.mean([emb[labels == i].std() for i in range(4)])
    assert cdist(cents, cents)[np.triu_indices(4, 1)].min() > 1.5 * within


def test_umap_deterministic_given_seed():
    data, _ = _blobs(1, k=2, n_per=30)
    a = TU.UMAP(random_state=7, n_epochs=50, device="cpu").fit_transform(data)
    b = TU.UMAP(random_state=7, n_epochs=50, device="cpu").fit_transform(data)
    np.testing.assert_array_equal(a, b)
    c = TU.UMAP(random_state=8, n_epochs=50, device="cpu").fit_transform(data)
    assert not np.allclose(a, c)


def test_umap_n_components_and_min_dist():
    data, _ = _blobs(2, k=2, n_per=25, d=6)
    emb3 = TU.UMAP(n_components=3, n_epochs=30, min_dist=0.3, device="cpu"
                   ).fit_transform(data)
    assert emb3.shape == (50, 3) and np.isfinite(emb3).all()
