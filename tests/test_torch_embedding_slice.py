"""The cluster-mask and embedding slice of the port as a whole, on the CPU:
``analysis/dimensionality_reduction`` against the JAX package's, and
``chip_smoke.py``'s phases (h)-(j) rehearsed at a small size.

Tolerances: the column standardisation against sklearn's StandardScaler
within 1e-12 (the same f64 formula; sklearn's incremental mean may round
its last bit otherwise); the PCA scatter's scores against the JAX package's
up to a sign per component, rtol 1e-5 of the largest score. UMAP and t-SNE
draw from their own seeded streams, so the plotted embeddings are held to
the quality bars of the JAX package's tests (cluster separation), never to
its coordinates.
"""

import os

import matplotlib
matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.analysis import dimensionality_reduction as JDR
from ark_tpu_torch.analysis import dimensionality_reduction as TDR
from ark_tpu_torch.ops import segment_reduce

torch.set_num_threads(2)


def _cells(seed=0, k=3, n_per=60, d=6):
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(k, d)) * 8.0
    data = (centers[:, None, :] + rng.normal(0, 0.5, (k, n_per, d))).reshape(-1, d)
    table = pd.DataFrame(data.astype(np.float32), columns=[f"m{i}" for i in range(d)])
    table["cell_meta_cluster"] = np.repeat([f"type{i}" for i in range(k)], n_per)
    return table.sample(frac=1.0, random_state=seed).reset_index(drop=True)


@pytest.mark.parametrize("case", ["gamma", "constant_column", "large_offset", "one_row"])
def test_standardize_columns_matches_sklearn(case):
    from sklearn.preprocessing import StandardScaler

    rng = np.random.default_rng(1)
    x = rng.gamma(2.0, 3.0, (400, 7))
    if case == "constant_column":
        x[:, 2], x[:, 5] = 0.1, 0.0
    elif case == "large_offset":
        x[:, 1] += 1e8
        x[:, 3] *= 1e-9
    elif case == "one_row":
        x = x[:1]
    got = TDR.standardize_columns(x)
    np.testing.assert_allclose(got, StandardScaler().fit_transform(x), rtol=1e-12,
                               atol=1e-12)
    assert got.dtype == np.float64 and np.isfinite(got).all()


def _separated(emb, names):
    """Every cluster's centroid farther from the others than 1.5 times the
    mean spread within clusters (tests/ops/test_umap_quality.py's bar)."""
    from scipy.spatial.distance import cdist

    kinds = sorted(set(names))
    cents = np.stack([emb[names == k].mean(0) for k in kinds])
    within = np.mean([emb[names == k].std() for k in kinds])
    return cdist(cents, cents)[np.triu_indices(len(kinds), 1)].min() > 1.5 * within


@pytest.mark.parametrize("algorithm", ["UMAP", "PCA", "tSNE"])
def test_reduce_dimensions_separates_the_planted_types(algorithm):
    table = _cells()
    cols = [c for c in table.columns if c.startswith("m")]
    timings = {}
    emb = TDR.reduce_dimensions(table[cols].values, algorithm, device="cpu",
                                timings=timings)
    assert emb.shape == (len(table), 2) and np.isfinite(emb).all()
    assert _separated(emb, table["cell_meta_cluster"].to_numpy())
    assert bool(timings) == (algorithm == "UMAP")
    again = TDR.reduce_dimensions(table[cols].values, algorithm, device="cpu")
    np.testing.assert_array_equal(emb, again)                 # deterministic


def test_pca_scatter_scores_match_jax(monkeypatch):
    """The PCA branch plots the JAX package's scores, up to each axis' sign."""
    table = _cells(2)
    cols = [c for c in table.columns if c.startswith("m")]
    seen = {}
    for side, mod, kw in (("jax", JDR, {}), ("torch", TDR, {"device": "cpu"})):
        monkeypatch.setattr(mod, "plot_dim_reduced_data",
                            lambda a, b, side=side, **k: seen.update({side: (a, b, k)}))
        mod.visualize_dimensionality_reduction(table, cols, "cell_meta_cluster",
                                               algorithm="PCA", **kw)
    for comp in (0, 1):
        got, want = np.asarray(seen["torch"][comp]), np.asarray(seen["jax"][comp])
        sign = np.sign(np.dot(got, want))
        np.testing.assert_allclose(got, sign * want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())
    assert {k: v for k, v in seen["torch"][2].items() if k not in ("hue", "cell_data")} \
        == {k: v for k, v in seen["jax"][2].items() if k not in ("hue", "cell_data")}


@pytest.mark.parametrize("algorithm", ["UMAP", "PCA", "tSNE"])
def test_visualize_dimensionality_reduction_saves_its_figure(tmp_path, algorithm):
    table = _cells(3, k=2, n_per=30, d=5)
    table.loc[3, "m1"] = np.nan                             # dropped, as in the JAX package
    cols = [c for c in table.columns if c.startswith("m")]
    TDR.visualize_dimensionality_reduction(table, cols, "cell_meta_cluster",
                                           algorithm=algorithm, save_dir=str(tmp_path),
                                           device="cpu")
    assert os.listdir(tmp_path) == [f"{algorithm}Visualization.png"]
    plt.close("all")


def test_visualize_dimensionality_reduction_bad_algorithm():
    table = pd.DataFrame({"m0": [1.0, 2.0], "cell_meta_cluster": ["A", "B"]})
    for mod, kw in ((JDR, {}), (TDR, {"device": "cpu"})):
        with pytest.raises(ValueError):
            mod.visualize_dimensionality_reduction(table, ["m0"], "cell_meta_cluster",
                                                   algorithm="MDS", **kw)


def _counting(real):
    def counted(*a, **k):
        counted.launches += 1
        return real(*a, **k)

    counted.launches = 0
    return counted


@pytest.fixture
def smoke(monkeypatch):
    """chip_smoke with the CPU as its device and its card-only measurements
    stubbed; the segment sum and its plan count their calls, as their
    kernels' launches are counted on the card (a sum without a plan builds
    one and counts it too)."""
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "CARD", "no card (CPU rehearsal)")
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, reps=10: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "batch_ms", lambda fn, reps=20: (fn(), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "device_ms", lambda fn, reps=10: (fn(), None)[1])
    monkeypatch.setattr(chip_smoke, "device_profile", lambda fn: (fn(), (1.0, []))[1])
    monkeypatch.setattr(chip_smoke, "sm_clock_mhz", lambda fn, calls: (fn(), 1980.0)[1])
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    for name in ("segment_sum", "segment_plan"):
        monkeypatch.setattr(segment_reduce, name, _counting(getattr(segment_reduce, name)))
    return chip_smoke


def test_smoke_cluster_mask_phase_rehearses_on_cpu(smoke):
    masks = smoke.dense_masks(n_fovs=2, size=128, n_cells=60, cell_radius=9, nuc_radius=3,
                              nuc_shift=2)["whole_cell"]
    rng = np.random.default_rng(0)
    rows = [{"fov": f"fov{i}", "label": int(lab), "cell_meta_cluster": f"som{lab % 12}"}
            for i, m in enumerate(masks) for lab in np.unique(m)[1:-1]]
    flat = rng.permutation(128 * 128)[:9000]
    seconds = smoke.run_cluster_masks(masks, pd.DataFrame(rows),
                                      (flat, rng.integers(1, 101, len(flat))))
    assert set(seconds) == {"cluster_mask_data_s", "erode_s", "relabel_s", "color_s",
                            "pixel_mask_s", "overlay_s"}


def test_smoke_embedding_phases_rehearse_on_cpu(smoke, monkeypatch):
    """Phases (i) and (j) and the edge-shape check at 1500 cells x 8
    columns: every check they make holds, and the UMAP fit asks for 2 plans
    and 2 sums an epoch."""
    monkeypatch.setattr(smoke, "KNN_COMPARE_CELLS", 600)
    monkeypatch.setattr(smoke, "TSNE_CELLS", 300)
    monkeypatch.setattr(smoke, "CPU_UMAP_CELLS", 400)
    monkeypatch.setattr(smoke, "CPU_TSNE_CELLS", 200)
    rng = np.random.default_rng(1)
    labels = np.repeat(np.arange(10), 150)
    centers = rng.gamma(1.0, 2.0, (10, 8))
    data = (centers[labels] + rng.gamma(1.0, 0.1, (1500, 8))).astype(np.float32)
    order = rng.permutation(1500)
    data, labels = data[order], labels[order]
    err, timing = smoke.check_edge_sums(data)
    assert err == 0.0 and timing["bound_ms"] > 0 and timing["library_ms"] == 1.0
    launches, plan_launches = smoke.run_embeddings(data, labels)
    assert (launches, plan_launches) == (400, 2)
    smoke.compare_embedding_steps(data)
