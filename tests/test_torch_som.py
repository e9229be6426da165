"""ark_tpu_torch.ops.som against ark_tpu.ops.som on the same numpy inputs.

Both sides compute d = |w|^2 - 2 x.w in f32 and take the first minimum, but
torch and XLA sum x.w in other orders, so d differs in the last bits. BMU
indices are therefore equal except at near-ties (chip_smoke.py's rule: the
two smallest d closer than 1e-6 * max(|d|, 1)), which the tests count; the
uniform random inputs have none. Distances and trained weights carry a
tolerance for the order of the sums. A near-tie inside a training step sends
the two trainers down different, equally valid trajectories, so the training
cases are ones whose trajectories meet none.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ark_tpu.ops import som as jsom
from ark_tpu_torch.ops import som as tsom
from chip_smoke import near_ties, plain_d

torch.set_num_threads(1)

DIST_RTOL, DIST_ATOL = 1e-5, 1e-6
WEIGHTS_ATOL = 1e-5


def _clustered_data(rng, n_per=500, c=6, n_clusters=4, spread=0.05):
    centers = rng.uniform(0.2, 1.0, size=(n_clusters, c))
    data = np.concatenate([
        centers[i] + rng.normal(0, spread, size=(n_per, c))
        for i in range(n_clusters)
    ]).astype(np.float32)
    return data, np.repeat(np.arange(n_clusters), n_per)


def assert_labels_equal_except_near_ties(got, ref, weights, data):
    """Labels equal except at near-ties of the port's plain d; returns the
    number of near-tie rows where they differ."""
    ties = near_ties(plain_d(torch.as_tensor(weights),
                             torch.as_tensor(data))).numpy()
    differ = np.asarray(got) != np.asarray(ref)
    assert not (differ & ~ties).any(), \
        f"{int((differ & ~ties).sum())} labels differ outside near-ties"
    return int(differ.sum())


@pytest.mark.parametrize("k", [1, 7, 100, 144])
@pytest.mark.parametrize("c", [3, 7, 16, 40])
def test_bmu_plain_matches_jax(c, k):
    """bmu_plain == bmu_xla and the interpret-mode Pallas kernel (indices
    exact; N=1237 is a multiple of no block size)."""
    from jax.experimental.pallas import tpu as pltpu
    rng = np.random.default_rng(100 * c + k)
    x = rng.random((1237, c)).astype(np.float32)
    w = rng.random((k, c)).astype(np.float32)
    idx_x, dist_x = jsom.bmu_xla(jnp.asarray(w), jnp.asarray(x))
    with pltpu.force_tpu_interpret_mode():
        idx_p, dist_p = jsom.bmu_pallas(jnp.asarray(w), jnp.asarray(x),
                                        block_n=256)
    idx_t, dist_t = tsom.bmu_plain(torch.from_numpy(w), torch.from_numpy(x))
    assert idx_t.dtype == torch.int32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_x))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_p))
    for ref in (dist_x, dist_p):
        np.testing.assert_allclose(dist_t.numpy(), np.asarray(ref),
                                   rtol=DIST_RTOL, atol=DIST_ATOL)


def test_bmu_ties_go_to_lowest_index():
    rng = np.random.default_rng(3)
    a = rng.random((20, 5)).astype(np.float32)
    w = np.concatenate([a, a, a])
    x = np.concatenate([a, rng.random((300, 5)).astype(np.float32)])
    idx_t, _ = tsom.bmu(torch.from_numpy(w), torch.from_numpy(x),
                        return_dist=False)
    idx_j, _ = jsom.bmu_xla(jnp.asarray(w), jnp.asarray(x))
    assert (idx_t.numpy() < 20).all()
    np.testing.assert_array_equal(idx_t.numpy()[:20], np.arange(20))
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))


def test_som_map_one_indexed_and_empty():
    rng = np.random.default_rng(4)
    data = rng.random((50, 4)).astype(np.float32)
    w = rng.random((100, 4)).astype(np.float32)
    clusters, dists = tsom.som_map(w, data, device="cpu")
    ref_c, ref_d = jsom.som_map(w, data, impl="xla")
    np.testing.assert_array_equal(clusters, ref_c)
    np.testing.assert_allclose(dists, ref_d, rtol=DIST_RTOL, atol=DIST_ATOL)
    assert clusters.min() >= 1 and clusters.max() <= 100
    c0, d0 = tsom.som_map(w, np.empty((0, 4)), device="cpu")
    assert c0.shape == (0,) and d0.shape == (0,)
    c1, d1 = tsom.som_map(w, data, return_dist=False, device="cpu")
    np.testing.assert_array_equal(c1, ref_c)
    assert d1 is None


@pytest.mark.parametrize("kw", [
    dict(xdim=10, ydim=10, num_passes=1, seed=42, batch_size=None),
    dict(xdim=4, ydim=3, num_passes=2, seed=9, batch_size=64),
])
def test_prepare_train_bitwise(kw):
    """The same seeded init rows, visiting order and padding as the JAX
    package: the host RNG is copied verbatim."""
    data, _ = _clustered_data(np.random.default_rng(5), n_per=150)
    args = (kw["xdim"], kw["ydim"], kw["num_passes"], kw["seed"],
            kw["batch_size"], None, None)
    j = jsom._prepare_train(data, *args)
    t = tsom._prepare_train(data, *args, device="cpu")
    for a, b in zip(j[:4], t[:4]):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert j[4:] == t[4:]


@pytest.mark.parametrize("kw", [
    dict(seed=42),
    dict(num_passes=2, seed=3, batch_size=16),
    dict(xdim=4, ydim=3, num_passes=2, seed=9, batch_size=64),
])
def test_som_train_matches_jax(kw):
    data, _ = _clustered_data(np.random.default_rng(6), n_per=300)
    w_j = jsom.som_train(data, **kw)
    w_t = tsom.som_train(data, device="cpu", **kw)
    assert w_t.dtype == np.float32 and w_t.shape == w_j.shape
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=WEIGHTS_ATOL)


def test_som_train_and_map_matches_jax_and_two_call_path():
    data, _ = _clustered_data(np.random.default_rng(8), n_per=250, c=16)
    w_j, c_j, d_j = jsom.som_train_and_map(data, seed=3)
    w_t, c_t, d_t = tsom.som_train_and_map(data, seed=3, device="cpu")
    np.testing.assert_allclose(w_t, w_j, rtol=0, atol=WEIGHTS_ATOL)
    assert_labels_equal_except_near_ties(c_t, c_j, w_t, data)
    # the distances come from weights that agree to WEIGHTS_ATOL, through
    # the f32 cancellation of d + |x|^2 at |x|^2 ~ 6
    np.testing.assert_allclose(d_t, d_j, rtol=DIST_RTOL, atol=WEIGHTS_ATOL)
    # the port's own contract: train + map in one call == the two calls
    w_ref = tsom.som_train(data, seed=3, device="cpu")
    np.testing.assert_array_equal(w_t, w_ref)
    c_ref, d_ref = tsom.som_map(w_ref, data, device="cpu")
    np.testing.assert_array_equal(c_t, c_ref)
    np.testing.assert_array_equal(d_t, d_ref)


def test_jax_trained_weights_map_identically():
    """Weights trained by the JAX package, loaded with the port's loader,
    give JAX som_map's labels (exactly, but for near-ties)."""
    data, _ = _clustered_data(np.random.default_rng(9), n_per=400, c=8)
    w_j = jsom.som_train(data, seed=42)
    w_t = tsom.som_weights_from_numpy(w_j, "cpu")
    assert w_t.dtype == torch.float32 and w_t.is_contiguous()
    np.testing.assert_array_equal(w_t.numpy(), w_j)
    ref, _ = jsom.som_map(w_j, data, impl="xla")
    got, _ = tsom.som_map(w_t, data, return_dist=False, device="cpu")
    assert_labels_equal_except_near_ties(got, ref, w_j, data)


def test_train_refuses_tf32_matmuls():
    data, _ = _clustered_data(np.random.default_rng(10), n_per=20)
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="full f32"):
            tsom.som_train(data, device="cpu")
    finally:
        torch.set_float32_matmul_precision("highest")


@pytest.mark.cuda
def test_bmu_kernel_matches_plain_on_cuda():
    """The CUDA kernel against bmu_plain on the card (skips without one);
    indices may differ only where the plain version's two best nodes are
    closer than 1e-6 * max(|d|, 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the BMU kernel runs only on the card")
    rng = np.random.default_rng(11)
    for n, c, k in [(1, 3, 7), (1000, 7, 100), (70_001, 40, 144),
                    (5000, 16, 1), (3001, 80, 33)]:
        x = torch.as_tensor(rng.random((n, c), dtype=np.float32), device="cuda")
        w = torch.as_tensor(rng.random((k, c), dtype=np.float32), device="cuda")
        idx_k, dist_k = tsom.bmu(w, x, return_dist=True)
        idx_p, dist_p = tsom.bmu_plain(w, x, return_dist=True)
        d = (w * w).sum(1)[None, :] - 2.0 * (x @ w.T)
        if k > 1:
            two = torch.topk(d, 2, dim=1, largest=False).values
            ties = (two[:, 1] - two[:, 0]) < 1e-6 * two[:, 0].abs().clamp_min(1)
        else:
            ties = torch.zeros(n, dtype=torch.bool, device="cuda")
        assert not bool(((idx_k != idx_p) & ~ties).any())
        torch.testing.assert_close(dist_k, dist_p, rtol=DIST_RTOL,
                                   atol=DIST_ATOL)
