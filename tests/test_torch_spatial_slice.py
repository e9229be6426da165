"""The port's spatial stage against the JAX package's, on the CPU.

The four spatial templates' flow on a small cohort (3 FOVs of well-apart
islands of cells, each island its own mix of phenotypes): distance matrices
written to netCDF, the neighborhood matrix, the k-means inertia and
silhouette sweeps, the cluster results, mixing scores, Shannon diversity,
mean k-NN distances and the enrichment table. Both packages run each step;
frames are equal (bitwise where the step is integer work, within 1e-5 where
it sums floats: inertia, silhouette, k-NN means within 1e-6). Where the JAX
package draws from ``jax.random`` (k-means++ seeding, the permutation null)
its draws are fed to the port; the k-means partitions of the port's own
seeding are compared up to relabeling.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.analysis import cell_neighborhood_stats as JC
from ark_tpu.analysis import neighborhood_analysis as JN
from ark_tpu.analysis import spatial_analysis_utils as JS
from ark_tpu.analysis import spatial_enrichment as JE
from ark_tpu.ops import kmeans as JK
from ark_tpu.utils.labeled_array import DataArray as JDataArray
from ark_tpu_torch import settings
from ark_tpu_torch.analysis import cell_neighborhood_stats as TC
from ark_tpu_torch.analysis import neighborhood_analysis as TN
from ark_tpu_torch.analysis import spatial_analysis_utils as TS
from ark_tpu_torch.analysis import spatial_enrichment as TE
from ark_tpu_torch.ops import kmeans as TK
from tests.test_torch_enrichment import jax_permutations

torch.set_num_threads(1)

TYPES = ["A", "B", "C", "D", "E", "F"]
CHANNELS = ["CD3", "CD8", "CD20"]
# three islands a FOV, farther apart than any radius used here; each holds
# two phenotypes
ISLANDS = [((200.0, 200.0), ("A", "B")), ((520.0, 780.0), ("C", "D")),
           ((850.0, 260.0), ("E", "F"))]


def islands_table(rng, fovs=("fov1", "fov2", "fov3"), per_island=50, radius=70.0):
    rows = []
    for fov in fovs:
        label = 0
        for (cy, cx), types in ISLANDS:
            for i in range(per_island):
                label += 1
                r, t = radius * np.sqrt(rng.random()), 2 * np.pi * rng.random()
                rows.append({settings.CELL_SIZE: float(rng.integers(80, 200)),
                             **{c: float(rng.gamma(1.0, 2.0)) for c in CHANNELS},
                             settings.CELL_LABEL: label,
                             settings.CENTROID_0: np.float32(cy + r * np.sin(t)),
                             settings.CENTROID_1: np.float32(cx + r * np.cos(t)),
                             settings.FOV_ID: fov,
                             settings.CELL_TYPE: types[i % 2]})
    return pd.DataFrame(rows)


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    rng = np.random.default_rng(2024)
    table = islands_table(rng)
    base = tmp_path_factory.mktemp("spatial")
    dirs = {"jax": str(base / "jax"), "port": str(base / "port")}
    for d in dirs.values():
        os.makedirs(d)
    JS.calc_dist_matrix(table, dirs["jax"])
    TS.calc_dist_matrix(table, dirs["port"], device="cpu")
    return table, dirs, base


_seed_restarts = jax.jit(
    jax.vmap(JK._plus_plus_init, in_axes=(0, None, None)), static_argnums=2)


def _jax_seeding(data, k, seeds):
    """The JAX package's k-means++ seeding (one PRNGKey(seed + i) a restart,
    as kmeans_fit_multi draws them), for the port's `_plus_plus_init`."""
    keys = jnp.stack([jax.random.PRNGKey(int(s)) for s in seeds])
    centers = _seed_restarts(keys, jnp.asarray(data.to(torch.float32).numpy()), k)
    return torch.tensor(np.asarray(centers), dtype=torch.float64)


def test_dist_matrix_files_cross_between_packages(cohort):
    table, dirs, _ = cohort
    for fov in table[settings.FOV_ID].unique():
        port = TS.load_dist_matrix(dirs["port"], fov)
        from_jax = TS.load_dist_matrix(dirs["jax"], fov)
        jax_reads_port = JS.load_dist_matrix(dirs["port"], fov)
        for got in (from_jax, jax_reads_port):
            assert got.dims == port.dims
            np.testing.assert_array_equal(got.values, port.values)
            for d in port.dims:
                np.testing.assert_array_equal(got.coords[d], port.coords[d])
        assert port.values.dtype == np.float32 and (np.diag(port.values) == 0).all()
    with open(os.path.join(dirs["port"], "fov1_dist_mat.xr"), "rb") as fh:
        assert fh.read(4) == b"CDF\x02"


def test_ensure_dist_matrices_fills_only_missing(cohort, tmp_path):
    table, dirs, _ = cohort
    out = str(tmp_path / "d")
    os.makedirs(out)
    sub = table[table[settings.FOV_ID] == "fov2"]
    TS.calc_dist_matrix(sub, out, device="cpu")
    before = os.path.getmtime(os.path.join(out, "fov2_dist_mat.xr"))
    TS.ensure_dist_matrices(table, out, device="cpu")
    assert sorted(os.listdir(out)) == [f"fov{i}_dist_mat.xr" for i in (1, 2, 3)]
    assert os.path.getmtime(os.path.join(out, "fov2_dist_mat.xr")) == before


@pytest.mark.parametrize("self_neighbor", [False, True])
def test_neighbor_counts_bitwise(cohort, self_neighbor):
    table, dirs, _ = cohort
    fov = table[table[settings.FOV_ID] == "fov2"]
    dm = TS.load_dist_matrix(dirs["port"], "fov2")
    jdm = JS.load_dist_matrix(dirs["port"], "fov2")
    got = TS.compute_neighbor_counts(fov, dm, 50, self_neighbor, device="cpu")
    want = JS.compute_neighbor_counts(fov, jdm, 50, self_neighbor)
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w, check_exact=True)


@pytest.mark.parametrize("analysis", ["cluster", "channel"])
def test_close_cell_num_bitwise(cohort, analysis):
    table, dirs, _ = cohort
    fov = table[table[settings.FOV_ID] == "fov1"].copy()
    fov[settings.CELL_TYPE_NUM] = fov[settings.CELL_TYPE].map(
        {t: i + 1 for i, t in enumerate(TYPES)})
    dm = TS.load_dist_matrix(dirs["port"], "fov1")
    jdm = JS.load_dist_matrix(dirs["port"], "fov1")
    if analysis == "cluster":
        kw = dict(current_fov_data=fov, cluster_ids=[1, 2, 3, 5])
    else:
        kw = dict(current_fov_data=fov, current_fov_channel_data=fov[CHANNELS],
                  thresh_vec=[1.0, 2.0, 0.5])
    got = TS.compute_close_cell_num(dm, 60, analysis, device="cpu", **kw)
    want = JS.compute_close_cell_num(jdm, 60, analysis, **kw)
    assert got[0].dtype == np.int64
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1] and got[0].sum() > 0


def test_append_distance_features_matches(cohort):
    table, dirs, _ = cohort
    t = table.copy()
    t["dist_to_vessel"] = np.float32(np.hypot(t[settings.CENTROID_0] - 500,
                                              t[settings.CENTROID_1] - 500))
    got_t, got_d = TS.append_distance_features_to_dataset(
        "fov1", TS.load_dist_matrix(dirs["port"], "fov1"), t, ["dist_to_vessel"])
    want_t, want_d = JS.append_distance_features_to_dataset(
        "fov1", JS.load_dist_matrix(dirs["port"], "fov1"), t, ["dist_to_vessel"])
    pd.testing.assert_frame_equal(got_t, want_t)
    np.testing.assert_array_equal(got_d.values, want_d.values)
    np.testing.assert_array_equal(got_d.coords["dim_0"], want_d.coords["dim_0"])


def _same_partition(a, b):
    pairs = set(zip(np.asarray(a).tolist(), np.asarray(b).tolist()))
    return len(pairs) == len(set(np.asarray(a).tolist())) == len(set(np.asarray(b).tolist()))


def test_templates_flow(cohort, monkeypatch):
    """neighborhood_analysis, mixing_scores, cell_neighbors_analysis and
    spatial_enrichment, step by step, on both packages' netCDF files."""
    table, dirs, base = cohort
    # 2. the neighborhood matrix
    counts, freqs = TN.create_neighborhood_matrix(table, dirs["jax"], distlim=50,
                                                  device="cpu")
    j_counts, j_freqs = JN.create_neighborhood_matrix(table, dirs["jax"], distlim=50)
    pd.testing.assert_frame_equal(counts, j_counts, check_exact=True)
    pd.testing.assert_frame_equal(freqs, j_freqs, check_exact=True)

    # 3. the sweeps and the cluster results, given the JAX package's seeding
    with monkeypatch.context() as m:
        m.setattr(TK, "_plus_plus_init", _jax_seeding)
        inertia = TN.compute_cluster_metrics_inertia(counts, max_k=5, device="cpu")
        sil = TN.compute_cluster_metrics_silhouette(counts, max_k=5, device="cpu")
        got = TN.generate_cluster_matrix_results(table, counts, cluster_num=3,
                                                 device="cpu")
    np.testing.assert_allclose(inertia.values, JN.compute_cluster_metrics_inertia(
        j_counts, max_k=5).values, rtol=1e-5)
    np.testing.assert_array_equal(inertia.coords["cluster_num"], np.arange(2, 6))
    np.testing.assert_allclose(sil.values, JN.compute_cluster_metrics_silhouette(
        j_counts, max_k=5).values, rtol=1e-5)
    want = JN.generate_cluster_matrix_results(table, j_counts, cluster_num=3)
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, w)

    # ... and with the port's own seeding: the islands, up to relabeling
    own = TN.generate_cluster_matrix_results(table, counts, cluster_num=3, device="cpu")
    col = settings.KMEANS_CLUSTER
    assert _same_partition(own[0][col], want[0][col])
    island = own[0][settings.CELL_TYPE].map({t: i // 2 for i, t in enumerate(TYPES)})
    assert _same_partition(own[0][col], island)

    # 4. mixing scores, both kinds
    for fov in table[settings.FOV_ID].unique():
        fov_counts = counts[counts[settings.FOV_ID] == fov]
        for kind in ("percent", "homogeneous"):
            args = (fov_counts.copy(), ["A", "C"], ["B", "D"], kind)
            got_s = TN.compute_mixing_score(*args, cell_count_thresh=20)
            want_s = JN.compute_mixing_score(*args, cell_count_thresh=20)
            assert got_s == want_s and np.isfinite(got_s[0])

    # 5. Shannon diversity from the saved frequencies
    nb_dir = base / "neighborhood_mats"
    os.makedirs(nb_dir, exist_ok=True)
    freqs.to_csv(nb_dir / "neighborhood_freqs-cell_meta_cluster_radius50.csv",
                 index=False)
    pd.testing.assert_frame_equal(
        TC.generate_neighborhood_diversity_analysis(str(nb_dir), 50,
                                                    ["cell_meta_cluster"]),
        JC.generate_neighborhood_diversity_analysis(str(nb_dir), 50,
                                                    ["cell_meta_cluster"]))

    # 6. mean k-NN distances to each cell type (k = 5, and one too large)
    for k in (5, 60):
        got_d = TC.generate_cell_distance_analysis(table, dirs["port"],
                                                   str(base / "t.csv"), k, device="cpu")
        want_d = JC.generate_cell_distance_analysis(table, dirs["port"],
                                                    str(base / "j.csv"), k)
        pd.testing.assert_frame_equal(got_d, want_d, rtol=1e-6)

    # 7. the enrichment table, given the JAX package's permutations
    monkeypatch.setattr(TE, "draw_permutations", jax_permutations)
    for fov in table[settings.FOV_ID].unique():
        dm = TS.load_dist_matrix(dirs["port"], fov)
        jdm = JDataArray(dm.values, coords=dm.coords)
        names, res = TE.calculate_cluster_spatial_enrichment(
            fov, table, dm, dist_lim=100, bootstrap_num=20, device="cpu")
        j_names, j_res = JE.calculate_cluster_spatial_enrichment(
            fov, table, jdm, dist_lim=100, bootstrap_num=20)
        assert names == j_names
        pd.testing.assert_frame_equal(TE.generate_enrichment_stats_table(names, res),
                                      JE.generate_enrichment_stats_table(j_names, j_res))
        ia, ib, ic = names.index("A"), names.index("B"), names.index("C")
        assert res["z"][ia, ib] > 2.0 and res["close_num"][ia, ic] == 0
