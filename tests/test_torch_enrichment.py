"""ark_tpu_torch.analysis.spatial_enrichment against the JAX package's.

With the JAX package's own permutations injected (replayed from
``jax.random.permutation`` as tests/analysis/test_enrichment_bucket.py
replays them) the observed counts and the null are bitwise equal, and so
are muhat, z and the adjusted p-values (the same numpy statistics on the
same f32 null). The port's own draws (``torch.randperm`` from a seeded CPU
generator) are held to the planted attraction, avoidance and calibration
checks of tests/analysis/test_enrichment_planted.py.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.analysis import spatial_enrichment as JE
from ark_tpu.ops.distances import shape_bucket
from ark_tpu_torch import settings
from ark_tpu_torch.analysis import spatial_enrichment as TE
from ark_tpu_torch.ops import distances as TD
from ark_tpu_torch.utils.labeled_array import DataArray
from tests import test_utils

torch.set_num_threads(1)


def jax_permutations(n, bootstrap_num, seed):
    """The JAX package's draw for the first n (real) cells: one permutation
    of the padded bucket per key, its real cells kept in the drawn order."""
    keys = jax.random.split(jax.random.PRNGKey(seed), bootstrap_num)
    nb = shape_bucket(n)
    perms = []
    for key in keys:
        perm_all = np.asarray(jax.random.permutation(key, nb))
        perms.append(perm_all[perm_all < n])
    return torch.as_tensor(np.stack(perms).astype(np.int64))


def _planted(rng, n=37, m=5):
    dist = rng.uniform(0, 100, (n, n)).astype(np.float32)
    dist = (dist + dist.T) / 2
    np.fill_diagonal(dist, 0.0)
    pos = (rng.uniform(size=(m, n)) < 0.3).astype(np.float32)
    return dist, pos


@pytest.mark.parametrize("n,m,b,seed", [(37, 5, 16, 7), (130, 3, 9, 1), (128, 6, 5, 2)])
def test_null_replays_the_jax_draw_bitwise(rng, n, m, b, seed):
    dist, pos = _planted(rng, n, m)
    want = JE.calculate_enrichment(dist, pos, dist_lim=30, bootstrap_num=b, seed=seed)
    got = TE._enrichment(dist, pos, 30, jax_permutations(n, b, seed), "cpu")
    for key in ("close_num", "close_num_rand", "muhat", "sigmahat", "z", "p_pos",
                "p_neg", "p_adj"):
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)


def test_null_chunks_give_the_same_null(rng, monkeypatch):
    dist, pos = _planted(rng, 50, 4)
    perms = TE.draw_permutations(50, 12, seed=3)
    whole = TE._enrichment(dist, pos, 30, perms, "cpu")
    monkeypatch.setattr(TE, "NULL_CHUNK_BYTES", 5 * 2 * 4 * 4 * 50)   # 5 a chunk
    chunked = TE._enrichment(dist, pos, 30, perms, "cpu")
    np.testing.assert_array_equal(whole["close_num_rand"], chunked["close_num_rand"])


def test_own_draws_are_seeded_uniform_permutations():
    perms = TE.draw_permutations(40, 200, seed=5)
    assert perms.dtype == torch.int64 and perms.shape == (200, 40)
    assert (torch.sort(perms, dim=1).values == torch.arange(40)).all()
    assert torch.equal(perms, TE.draw_permutations(40, 200, seed=5))
    assert not torch.equal(perms, TE.draw_permutations(40, 200, seed=6))
    # each cell lands in slot 0 about 200/40 = 5 times: a chi-square check
    counts = torch.bincount(perms[:, 0], minlength=40).numpy()
    chi2 = ((counts - 5.0) ** 2 / 5.0).sum()
    assert chi2 < 80           # 39 dof; p ~ 1e-4


def _dist_mat_from_centroids(centroids):
    d = TD.cdist(np.asarray(centroids, np.float32), device="cpu")
    labels = np.arange(1, len(d) + 1)
    return DataArray(d, coords={"dim_0": labels, "dim_1": labels})


def _cell_table(centroids, pops, fov="fov0"):
    return pd.DataFrame({settings.FOV_ID: fov,
                         settings.CELL_LABEL: np.arange(1, len(pops) + 1),
                         settings.CELL_TYPE: pops,
                         settings.CENTROID_0: centroids[:, 0],
                         settings.CENTROID_1: centroids[:, 1]})


def _cluster_enrichment(table, dist, **kw):
    return TE.calculate_cluster_spatial_enrichment("fov0", table, dist, device="cpu",
                                                   **kw)


def test_detects_planted_attraction(rng):
    centroids, pops = test_utils.make_planted_proximity_centroids(
        rng, n_a=20, n_b=20, n_bg=60, img_size=800, pair_dist=6)
    table = _cell_table(centroids, pops)
    names, res = _cluster_enrichment(table, _dist_mat_from_centroids(centroids),
                                     dist_lim=15, bootstrap_num=200, seed=1)
    ia, ib = names.index("A"), names.index("B")
    assert res["z"][ia, ib] > 3.0 and res["p_pos"][ia, ib] < 0.01
    assert res["p_adj"][ia, ib] < 0.05


def test_detects_avoidance(rng):
    n = 40
    a = np.stack([rng.uniform(0, 800, n), rng.uniform(0, 80, n)], axis=1)
    b = np.stack([rng.uniform(0, 800, n), rng.uniform(720, 800, n)], axis=1)
    centroids = np.concatenate([a, b, rng.uniform(0, 800, size=(80, 2))])
    pops = np.array(["A"] * n + ["B"] * n + ["BG"] * 80)
    names, res = _cluster_enrichment(_cell_table(centroids, pops),
                                     _dist_mat_from_centroids(centroids),
                                     dist_lim=100, bootstrap_num=200, seed=1)
    ia, ib = names.index("A"), names.index("B")
    assert res["z"][ia, ib] < -2.0 and res["p_neg"][ia, ib] < 0.05
    assert res["close_num"][ia, ib] == 0
    assert res["z"][ia, ia] > 2.0 and res["z"][ib, ib] > 2.0


def test_null_is_calibrated(rng):
    """Uniform phenotypes over 20 seeded FOVs: z centred, no pair
    significant after BH in at least 19 of them."""
    significant, zs = 0, []
    for seed in range(20):
        centroids = rng.uniform(0, 1000, size=(150, 2))
        pops = rng.choice(["A", "B", "C"], size=150)
        _, res = _cluster_enrichment(_cell_table(centroids, pops),
                                     _dist_mat_from_centroids(centroids),
                                     dist_lim=120, bootstrap_num=100, seed=seed)
        significant += int((res["p_adj"] <= 0.05).any())
        zs.append(res["z"].ravel())
    zs = np.concatenate(zs)
    assert significant <= 1
    assert abs(zs.mean()) < 0.3 and 0.6 < zs.std() < 1.4
    assert np.abs(zs).max() < 4.0


def test_symmetry_and_pvalue_resolution(rng):
    centroids, pops = test_utils.make_planted_proximity_centroids(
        rng, n_a=20, n_b=20, n_bg=20, img_size=600, pair_dist=5)
    table = _cell_table(centroids, pops)
    dist = _dist_mat_from_centroids(centroids)
    for b in (50, 200):
        names, res = _cluster_enrichment(table, dist, dist_lim=15, bootstrap_num=b,
                                         seed=5)
        ia, ib = names.index("A"), names.index("B")
        assert res["p_pos"][ia, ib] == pytest.approx(1.0 / (b + 1))
        np.testing.assert_array_equal(res["close_num"], res["close_num"].T)
        np.testing.assert_array_equal(res["close_num_rand"],
                                      res["close_num_rand"].transpose(0, 2, 1))


def test_dense_counts_do_not_wrap_and_missing_types_warn(rng):
    n = 600
    coords = rng.uniform(0, 50, size=(n, 2)).astype(np.float32)
    dm = _dist_mat_from_centroids(coords)
    res = TE.calculate_enrichment(dm, np.ones((1, n), np.float32), dist_lim=100,
                                  bootstrap_num=3, seed=1, device="cpu")
    assert res["close_num"].dtype == np.int64
    assert res["close_num"][0, 0] == int((dm.values > 0).sum()) > 65535
    table = _cell_table(coords[:40], np.array(["A"] * 20 + ["B"] * 20))
    with pytest.warns(UserWarning, match="Missing"):
        names, res = _cluster_enrichment(
            table, _dist_mat_from_centroids(coords[:40]),
            included_cell_types=["A", "B", "Missing"], dist_lim=50, bootstrap_num=10)
    assert list(names) == ["A", "B", "Missing"] and res["close_num"][2].sum() == 0
    assert np.isfinite(res["z"]).all()


def test_channel_enrichment_matches_jax_given_its_draw(rng, monkeypatch):
    centroids, pops = test_utils.make_planted_proximity_centroids(
        rng, n_a=15, n_b=15, n_bg=30, img_size=500, pair_dist=8)
    table = _cell_table(centroids, pops)
    table["m1"] = np.where(pops == "A", 0.9, 0.05) + rng.normal(0, 0.01, len(pops))
    table["m2"] = np.where(pops == "B", 0.8, 0.04) + rng.normal(0, 0.01, len(pops))
    dist = _dist_mat_from_centroids(centroids)
    from ark_tpu.utils.labeled_array import DataArray as JDataArray
    jdist = JDataArray(dist.values, coords=dist.coords)
    _, want = JE.calculate_channel_spatial_enrichment(
        "fov0", table, jdist, ["m1", "m2"], [0.5, 0.5], dist_lim=20,
        bootstrap_num=30, seed=4)
    monkeypatch.setattr(TE, "draw_permutations", jax_permutations)
    names, got = TE.calculate_channel_spatial_enrichment(
        "fov0", table, dist, ["m1", "m2"], [0.5, 0.5], dist_lim=20,
        bootstrap_num=30, seed=4, device="cpu")
    assert names == ["m1", "m2"]
    for key in ("close_num", "close_num_rand", "z", "p_adj"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    table_t = TE.generate_enrichment_stats_table(names, got)
    pd.testing.assert_frame_equal(table_t, JE.generate_enrichment_stats_table(names, want))
