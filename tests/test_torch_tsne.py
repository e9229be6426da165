"""The port's exact t-SNE (ark_tpu_torch.ops.tsne) against the JAX
package's, on the CPU, on the same seeded inputs.

Tolerances, each with its reason:

- ``_squared_dists``: the D > 4 expansion within 4 (D - 1) 2^-24 (|a|^2 +
  |b|^2), as ``ops/distances`` is held elsewhere; the D = 2 embedding
  distances bitwise (the port rounds XLA's fused sums exactly).
- ``_conditional_affinities``, given the same squared distances: rtol 1e-5
  (atol 1e-9): exp, log-sum-exp and 64 bisection steps whose row sums run in
  another order.
- ``_embed``, given the JAX package's own initial embedding, at the "auto"
  learning rate (50 for 120 points): the (N, N) sums run in another order
  and XLA's CPU backend fuses multiply-adds in the jitted step, so the first
  step differs by ~1e-9, and the descent multiplies a difference by ~5 every
  few steps while the coordinates grow from 1e-4 to ~20. Stated per length:
  atol 5e-6 after 3 steps (coordinates ~4; 9.5e-7 seen), 1e-3 after 10 (~5;
  1.8e-4 seen), 2e-2 after 30 (~22; 2.9e-3 seen).
- The seeded initial embedding is the port's own stream (``jax.random``
  cannot be replayed): held to its distribution, and the whole fit to the
  quality bars of tests/ops/test_tsne.py, never to a looser tolerance.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ark_tpu.ops import tsne as JT
from ark_tpu_torch.ops import tsne as TT

torch.set_num_threads(2)

F32_EPS = 2.0 ** -24
AFFINITY_RTOL = 1e-5


def _blobs(seed, n_per=60, n_blobs=4, d=10, sep=8.0):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_blobs, d)) * sep
    x = np.concatenate([centers[i] + rng.normal(size=(n_per, d)) for i in range(n_blobs)])
    return x.astype(np.float32), np.repeat(np.arange(n_blobs), n_per)


def _knn_label_purity(emb, labels, k=10):
    d2 = ((emb[:, None, :] - emb[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)
    nn = np.argsort(d2, axis=1)[:, :k]
    return float((labels[nn] == labels[:, None]).mean())


@pytest.mark.parametrize("n,d", [(200, 10), (333, 20), (150, 2), (64, 3)])
def test_squared_dists_match_jax(n, d):
    x = np.random.default_rng(n).normal(size=(n, d)).astype(np.float32) * 3
    want = np.asarray(jax.jit(JT._squared_dists)(jnp.asarray(x)))
    got = TT._squared_dists(torch.as_tensor(x)).numpy()
    assert (np.diag(got) == 0).all()
    if d <= 4:
        np.testing.assert_array_equal(got, want)
    else:
        sq = (x.astype(np.float64) ** 2).sum(1)
        bound = 4 * (d - 1) * F32_EPS * (sq[:, None] + sq[None, :])
        assert (np.abs(got - want) <= bound).all()


@pytest.mark.parametrize("n,perplexity", [(200, 25.0), (400, 30.0), (60, 5.0)])
def test_conditional_affinities_match_jax(n, perplexity):
    x = np.random.default_rng(n).normal(size=(n, 5)).astype(np.float32)
    d2 = np.asarray(JT._squared_dists(jnp.asarray(x)))
    want = np.asarray(JT._conditional_affinities(jnp.asarray(d2), perplexity))
    got = TT._conditional_affinities(torch.as_tensor(d2), perplexity).numpy()
    np.testing.assert_allclose(got, want, rtol=AFFINITY_RTOL, atol=1e-9)
    assert (np.diag(got) == 0).all() and np.isfinite(got).all()
    # the definition: each row sums to 1 and has the requested perplexity
    np.testing.assert_allclose(got.sum(axis=1), 1.0, atol=1e-4)
    h = -(np.where(got > 0, got * np.log(np.where(got > 0, got, 1.0)), 0.0)).sum(axis=1)
    np.testing.assert_allclose(np.exp(h), perplexity, rtol=1e-3)


@pytest.mark.parametrize("n_iter,n_components,atol", [(3, 2, 5e-6), (10, 3, 1e-3),
                                                      (30, 2, 2e-2)])
def test_embed_matches_jax_given_its_initial_embedding(n_iter, n_components, atol,
                                                       n_exaggeration=10):
    x, _ = _blobs(4, n_per=40, n_blobs=3)
    n = len(x)
    d2 = JT._squared_dists(jnp.asarray(x))
    p_cond = JT._conditional_affinities(d2, 30.0)
    p_sym = np.asarray(jnp.maximum((p_cond + p_cond.T) / (2.0 * n), 1e-12))
    key = jax.random.PRNGKey(3)
    y0 = np.asarray(1e-4 * jax.random.normal(key, (n, n_components), jnp.float32))
    want = np.asarray(JT._embed(jnp.asarray(p_sym), key, n_iter, n_exaggeration, 50.0,
                                n_components))
    got = TT._embed(torch.as_tensor(p_sym), 0, n_iter, n_exaggeration, 50.0, n_components,
                    y0=torch.as_tensor(y0)).numpy()
    assert np.abs(want).max() > 10 * np.abs(y0).max()        # the steps moved the points
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_initial_embedding_is_seeded_normal():
    a = TT.initial_embedding(20_000, 2, 5)
    assert a.shape == (20_000, 2) and a.dtype == torch.float32 and a.device.type == "cpu"
    assert torch.equal(a, TT.initial_embedding(20_000, 2, 5))
    assert not torch.equal(a, TT.initial_embedding(20_000, 2, 6))
    z = a.numpy().ravel() / 1e-4
    assert abs(z.mean()) < 0.02 and abs(z.std() - 1) < 0.02
    assert abs((np.abs(z) < 1).mean() - 0.6827) < 0.01


def test_planted_blobs_separate():
    x, labels = _blobs(12345)
    emb = TT.tsne(x, n_iter=500, seed=0, device="cpu")
    assert emb.shape == (len(x), 2) and np.isfinite(emb).all()
    assert _knn_label_purity(emb, labels) > 0.95


def test_trustworthiness_matches_sklearn_tsne():
    from sklearn.manifold import TSNE as SkTSNE
    from sklearn.manifold import trustworthiness

    x, _ = _blobs(12345, n_per=40, n_blobs=3)
    ours = TT.tsne(x, n_iter=500, seed=0, device="cpu")
    theirs = SkTSNE(n_components=2, init="random", random_state=0,
                    perplexity=30).fit_transform(x)
    t_ours = trustworthiness(x, ours, n_neighbors=10)
    assert t_ours > 0.9
    assert t_ours > trustworthiness(x, theirs, n_neighbors=10) - 0.05


def test_within_cluster_structure_not_collapsed():
    from scipy.spatial.distance import cdist
    from scipy.stats import spearmanr

    x, labels = _blobs(12345, n_per=40, n_blobs=3)
    emb = TT.tsne(x, n_iter=500, seed=0, device="cpu")
    cent = np.stack([emb[labels == k].mean(0) for k in range(3)])
    between = cdist(cent, cent)
    between = between[between > 0].mean()
    iu = np.triu_indices(40, 1)
    for k in range(3):
        e, xk = emb[labels == k], x[labels == k]
        within = cdist(e, e)[iu]
        assert within.mean() / between > 0.01, f"blob {k} collapsed"
        assert spearmanr(within, cdist(xk, xk)[iu]).statistic > 0.4, k


def test_deterministic_per_seed_and_facade():
    x, _ = _blobs(1, n_per=20, n_blobs=2)
    a = TT.tsne(x, n_iter=100, seed=7, device="cpu")
    np.testing.assert_array_equal(a, TT.tsne(x, n_iter=100, seed=7, device="cpu"))
    assert np.abs(a - TT.tsne(x, n_iter=100, seed=8, device="cpu")).max() > 0
    model = TT.TSNE(n_iter=100, random_state=7, device="cpu")
    emb = model.fit_transform(x)
    np.testing.assert_array_equal(emb, a)
    np.testing.assert_array_equal(model.embedding_, emb)
    y0 = np.random.default_rng(0).normal(size=(40, 2)).astype(np.float32) * 1e-4
    b = TT.tsne(x, n_iter=100, device="cpu", y0=y0)
    assert b.shape == (40, 2) and np.abs(a - b).max() > 0
    with pytest.raises(ValueError, match="at least 4"):
        TT.tsne(x[:3], device="cpu")
