"""ark_tpu_torch.ops.distances against ark_tpu.ops.distances, on the CPU.

Tolerances:
- D <= 4: bitwise. The port rounds |a-b|^2 as XLA's jitted CPU code does
  (fused multiply-adds, reproduced through an exact f64 product) and takes
  a correctly rounded square root, as XLA does.
- D > 4: the |a|^2 + |b|^2 - 2ab decomposition, whose three f32 sums of D
  products run in another order in XLA (Eigen) and in torch (MKL). Each
  order's error is at most (D - 1) * 2^-24 * (|a|^2 + |b|^2) per sum, so
  two orders differ by at most 4 (D - 1) * 2^-24 * (|a|^2 + |b|^2) in d^2
  (scripts/port_spatial_numerics.py measures 7.8 units at D = 20).
- Neighbor counts: bitwise (0/1 products, exact integers in f32).
- knn_mean_distance: rtol 1e-6 (a mean of k values, summed in either order).
- silhouette_score: rtol 1e-5 (f32 distance sums of N terms).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ark_tpu.ops import distances as JD
from ark_tpu_torch.ops import distances as TD

torch.set_num_threads(1)
EPS = 2.0 ** -24


def _far_corner(rng, n, d, stage=5000.0):
    """`n` points of dimension `d` in the far quarter of a `stage`-px stage,
    with a pair 1.5 px apart at (stage, stage, ...)."""
    pts = (stage * (0.75 + 0.25 * rng.random((n, d)))).astype(np.float32)
    pts[0] = stage
    pts[1] = stage
    pts[1, 0] -= 1.5
    return pts


def _jax_sq(a, b, zero_diagonal=False):
    return np.asarray(jax.jit(JD.squared_distances, static_argnames="zero_diagonal")(
        jnp.asarray(a), jnp.asarray(b), zero_diagonal=zero_diagonal))


@pytest.mark.parametrize("d", [1, 2, 3, 4])
def test_direct_rule_is_bitwise_at_the_far_corner(rng, d):
    a = _far_corner(rng, 300, d)
    b = _far_corner(rng, 200, d)
    got_sq = TD.squared_distances(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got_sq, _jax_sq(a, b))
    for zero in (False, True):
        want = np.asarray(JD.pairwise_distances(jnp.asarray(a), jnp.asarray(a),
                                                zero_diagonal=zero))
        got = TD.pairwise_distances(torch.from_numpy(a), torch.from_numpy(a),
                                    zero_diagonal=zero).numpy()
        np.testing.assert_array_equal(got, want)
    self_d = TD.pairwise_distances(torch.from_numpy(a), torch.from_numpy(a),
                                   zero_diagonal=True).numpy()
    assert (np.diag(self_d) == 0).all()
    # the close pair at the far corner keeps its distance (the decomposition
    # rounds it to 0 and drops it from every `dist > 0` mask)
    assert self_d[0, 1] == self_d[1, 0] == np.float32(1.5)


@pytest.mark.parametrize("scale", [1.0, 30.0, 1000.0])
def test_decomposition_above_four_dims(rng, scale):
    a = (rng.random((300, 20)) * scale).astype(np.float32)
    b = (rng.random((250, 20)) * scale).astype(np.float32)
    b[:40] = a[:40] + rng.normal(0, 1e-3 * scale, (40, 20)).astype(np.float32)
    got = TD.squared_distances(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    want = _jax_sq(a, b)
    norms = (a.astype(np.float64) ** 2).sum(1)[:, None] + (b.astype(np.float64) ** 2).sum(1)
    assert (np.abs(got.astype(np.float64) - want) <= 4 * 19 * EPS * norms).all()
    assert (got >= 0).all()
    self_d = TD.pairwise_distances(torch.from_numpy(a), torch.from_numpy(a),
                                   zero_diagonal=True).numpy()
    assert (np.diag(self_d) == 0).all()


def test_decomposition_refuses_tf32():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            TD.squared_distances(torch.rand(5, 8), torch.rand(6, 8))
        with pytest.raises(RuntimeError, match="TF32"):
            TD.blocked_neighbor_counts(np.zeros((4, 2)), np.eye(4), 1.0, device="cpu")
    finally:
        torch.set_float32_matmul_precision(prev)


@pytest.mark.parametrize("block_rows", [7, 64, 8192])
def test_cdist_matches_in_blocks(rng, block_rows):
    a = _far_corner(rng, 150, 2, stage=1024.0)
    b = _far_corner(rng, 90, 2, stage=1024.0)
    np.testing.assert_array_equal(TD.cdist(a, block_rows=block_rows, device="cpu"),
                                  JD.cdist(a, block_rows=block_rows))
    np.testing.assert_array_equal(TD.cdist(a, b, block_rows=block_rows, device="cpu"),
                                  JD.cdist(a, b, block_rows=block_rows))
    assert (np.diag(TD.cdist(a, block_rows=block_rows, device="cpu")) == 0).all()


def test_knn_mean_distance(rng):
    d = rng.uniform(0, 300, (120, 40)).astype(np.float32)
    d[rng.random(d.shape) < 0.2] = 0.0            # self / coincident cells
    d[0, 3:] = 0.0                                 # fewer than k positives: inf
    for k in (1, 3, 5):
        want = np.asarray(JD.knn_mean_distance(jnp.asarray(d), k))
        got = TD.knn_mean_distance(torch.from_numpy(d), k).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6)
        assert np.isinf(got[0]) == np.isinf(want[0])
    assert np.isinf(TD.knn_mean_distance(torch.from_numpy(d), 5).numpy()[0])


@pytest.mark.parametrize("block_rows", [5, 37, 4096])
def test_blocked_neighbor_counts_bitwise(rng, block_rows):
    coords = _far_corner(rng, 200, 2)
    coords[5] = coords[6]                          # a coincident pair: d == 0
    onehot = np.eye(4, dtype=np.float32)[rng.integers(0, 4, 200)]
    lim = 400.0
    got = TD.blocked_neighbor_counts(coords, onehot, lim, block_rows=block_rows,
                                     device="cpu")
    want = JD.blocked_neighbor_counts(coords, onehot, lim, block_rows=block_rows)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.float32 and got.sum() > 0


def test_silhouette_matches(rng):
    centers = rng.normal(0, 6, (4, 20))
    labels = rng.integers(0, 4, 300)
    data = (centers[labels] + rng.normal(0, 1, (300, 20))).astype(np.float32)
    for block_rows in (64, 4096):
        want = JD.silhouette_score(data, labels, block_rows=block_rows)
        got = TD.silhouette_score(data, labels, block_rows=block_rows, device="cpu")
        assert got == pytest.approx(want, rel=1e-5)
    # a singleton cluster scores 0; 2-D data takes the direct rule
    lab2 = labels.copy()
    lab2[0] = 9
    flat = data[:, :2].copy()
    assert TD.silhouette_score(flat, lab2, device="cpu") == pytest.approx(
        JD.silhouette_score(flat, lab2), rel=1e-5)
    with pytest.raises(ValueError, match="Number of labels"):
        TD.silhouette_score(data, np.zeros(300), device="cpu")


@pytest.mark.parametrize("error", [0.0, 3.3e-4, -1e-3])
def test_sqrt_is_correctly_rounded_from_a_rough_estimate(monkeypatch, error):
    """torch's CPU f32 sqrt is at times off by up to 3.3e-4 on a process's
    first call; the port's square root is correctly rounded from any
    estimate that close (numpy's f32 sqrt is the IEEE one)."""
    rng = np.random.default_rng(7)
    x = np.concatenate([rng.random(200_000) * 1e7, rng.random(50_000),
                        [0.0, 1.0, 2.25, 4.0, 1e-40, 3.4e38]]).astype(np.float32)
    sqrt = torch.sqrt
    monkeypatch.setattr(torch, "sqrt", lambda t: sqrt(t) * np.float32(1 + error))
    got = TD._sqrt(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))
