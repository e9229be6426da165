"""ark_tpu_torch.ops.kmeans against ark_tpu.ops.kmeans, on the CPU.

The port cannot replay ``jax.random``, so Lloyd's iterations are held to
the JAX package's given its own k-means++ seeding
(``ark_tpu.ops.kmeans._plus_plus_init(jax.random.PRNGKey(seed + i), ...)``):
labels equal, inertia within rtol 1e-5. The JAX package sums f32 distances
that cancel in |x|^2 - 2 x.c + |c|^2, each off by up to an ulp of |x|^2,
where the port works in f64; so the parity data keep |x|^2 within ~50 times
a point's distance to its center (blobs of spread 4 around the origin),
where that error stays under 1e-5 of the inertia. The port's
own seeding is checked on its distribution's purpose: planted blobs are
recovered, and one seed gives one partition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_tpu.ops import kmeans as JK
from ark_tpu_torch.ops import kmeans as TK

torch.set_num_threads(1)


def _blobs(rng, n_per=60, k=4, dim=5, spread=4.0):
    centers = rng.normal(0, spread, (k, dim))
    truth = np.repeat(np.arange(k), n_per)
    data = (centers[truth] + rng.normal(0, 0.5, (len(truth), dim))).astype(np.float32)
    return data, truth


def _jax_seeding(data, k, seed, n_init):
    return np.stack([np.asarray(JK._plus_plus_init(
        jax.random.PRNGKey(seed + i), jnp.asarray(data), k)) for i in range(n_init)])


def _port_given(data, centers, n_iter=50):
    x = torch.from_numpy(data).double()
    c, labels, inertia = TK._best(*TK._lloyd(x, torch.from_numpy(centers).double(),
                                             n_iter))
    return c.numpy(), labels.numpy(), float(inertia)


@pytest.mark.parametrize("k,n_init", [(2, 1), (4, 1), (4, 5), (7, 3)])
def test_lloyd_given_the_jax_seeding(rng, k, n_init):
    data, _ = _blobs(rng)
    seed = 42
    if n_init == 1:
        want_c, want_labels, want_inertia = JK.kmeans_fit(jnp.asarray(data), k, seed=seed)
    else:
        want_c, want_labels, want_inertia = JK.kmeans_fit_multi(
            jnp.asarray(data), k, seed=seed, n_init=n_init)
    c, labels, inertia = _port_given(data, _jax_seeding(data, k, seed, n_init))
    np.testing.assert_array_equal(labels, np.asarray(want_labels))
    assert inertia == pytest.approx(float(want_inertia), rel=1e-5)
    np.testing.assert_allclose(c, np.asarray(want_c), rtol=1e-5, atol=1e-5)


def test_empty_cluster_reseeds_to_the_farthest_point(rng):
    """Two initial centers on one point: one cluster starts empty and is
    re-seeded to the farthest point, as in the JAX package."""
    data, _ = _blobs(rng, n_per=30, k=3)
    init = np.stack([data[0], data[0], data[40]])[None]
    _, labels, inertia = _port_given(data, init, n_iter=20)

    def jax_fit(x, c0):
        x2 = jnp.sum(x * x, axis=1)

        def assign(c):
            d2 = x2[:, None] - 2.0 * (x @ c.T) + jnp.sum(c * c, axis=1)[None, :]
            return jnp.argmin(d2, axis=1), jnp.maximum(jnp.min(d2, axis=1), 0.0)

        for _ in range(20):
            lab, d2 = assign(c0)
            h = jax.nn.one_hot(lab, 3)
            counts = h.sum(0)
            new = (h.T @ x) / jnp.maximum(counts, 1.0)[:, None]
            c0 = jnp.where((counts > 0)[:, None], new, x[jnp.argmax(d2)])
        lab, d2 = assign(c0)
        return np.asarray(lab), float(jnp.sum(d2))

    want_labels, want_inertia = jax_fit(jnp.asarray(data), jnp.asarray(init[0]))
    np.testing.assert_array_equal(labels, want_labels)
    assert inertia == pytest.approx(want_inertia, rel=1e-5)
    assert len(np.unique(labels)) == 3


def _same_partition(a, b):
    """Equal up to relabeling: the label pairs form a bijection."""
    pairs = set(zip(a.tolist(), b.tolist()))
    return len(pairs) == len(set(a.tolist())) == len(set(b.tolist()))


@pytest.mark.parametrize("n_init", [1, 10])
def test_own_seeding_recovers_planted_blobs(rng, n_init):
    data, truth = _blobs(rng, n_per=80, k=5)
    labels, inertia = TK.kmeans(data, 5, seed=3, n_init=n_init, device="cpu")
    assert labels.dtype == np.int32 and labels.shape == truth.shape
    if n_init > 1:
        assert _same_partition(labels, truth)
    within = sum(((data[labels == c] - data[labels == c].mean(0)) ** 2).sum()
                 for c in np.unique(labels))
    assert inertia == pytest.approx(within, rel=1e-4)
    again, inertia2 = TK.kmeans(data, 5, seed=3, n_init=n_init, device="cpu")
    np.testing.assert_array_equal(labels, again)
    assert inertia2 == inertia


def test_own_seeding_draws_by_seed(rng):
    """k-means++ picks distinct rows, the first uniformly from a seeded
    generator: another seed gives other initial centers, one seed the same."""
    data, _ = _blobs(rng, n_per=50, k=3)
    x = torch.from_numpy(data).double()
    a = TK._plus_plus_init(x, 6, [1, 2, 3])
    b = TK._plus_plus_init(x, 6, [1, 2, 3])
    assert torch.equal(a, b)
    assert not torch.equal(a[0], a[1])
    for r in range(3):
        rows = {tuple(v) for v in a[r].numpy().tolist()}
        assert len(rows) == 6                       # no row picked twice
    # every blob gets a center: a far row is far likelier than a near one
    _, labels, _ = TK.kmeans_fit(data, 3, seed=0, device="cpu")
    assert len(np.unique(labels.numpy())) == 3


def test_kmeans_matches_jax_on_separated_data(rng):
    """Both packages' own seedings find the same partition when the blobs
    are well apart."""
    data, truth = _blobs(rng, n_per=40, k=3, spread=20.0)
    want, want_inertia = JK.kmeans(data, 3, seed=42)
    got, inertia = TK.kmeans(data, 3, seed=42, device="cpu")
    assert _same_partition(got, want) and _same_partition(got, truth)
    assert inertia == pytest.approx(want_inertia, rel=1e-5)
