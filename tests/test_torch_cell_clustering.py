"""Template 3 (Pixie cell clustering) in the port against the JAX package,
on the CPU.

Tolerances: the cells x pixel-cluster counts and their size-normalized
table, the cell SOM's column normalization, the SOM-cluster and meta-cluster
averages, the consensus labels and every remap file are equal (pandas'
exact comparison). SOM training is held to an absolute 1e-5 on the weights
(torch and XLA sum x.w in other orders) in a configuration whose minibatch
steps meet no near-tie; the assignments are then held exactly, given the
weights the JAX side trained, carried across. The weighted channel product
is one f32 matmul whose sums run in another order: rtol = 1e-6.
"""

import os
import shutil

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io import feather_utils as feather
from ark_tpu.phenotyping import cell_cluster_utils as JCU
from ark_tpu.phenotyping import cell_meta_clustering as JMC
from ark_tpu.phenotyping import cell_som_clustering as JSC
from ark_tpu.phenotyping import cluster_helpers as JCH
from ark_tpu.phenotyping import weighted_channel_comp as JW
from ark_tpu_torch.phenotyping import cell_cluster_utils as TCU
from ark_tpu_torch.phenotyping import cell_meta_clustering as TMC
from ark_tpu_torch.phenotyping import cell_som_clustering as TSC
from ark_tpu_torch.phenotyping import cluster_helpers as TCH
from ark_tpu_torch.phenotyping import weighted_channel_comp as TW

torch.set_num_threads(2)

FOVS = ["fov0", "fov1", "fov2"]
CHANNELS = ["chan0", "chan1", "chan2", "chan3"]
N_PIXEL_CLUSTERS = 6
WEIGHTS_ATOL = 1e-5
MATMUL_RTOL = 1e-6


def _write_cohort(base, rng):
    """Per-FOV pixel feathers (labels, SOM and meta clusters planted per
    cell from one of three profiles) and a matching cell table CSV."""
    pixel_dir = os.path.join(base, "pixel_mat_data")
    os.makedirs(pixel_dir)
    profiles = rng.dirichlet(np.full(N_PIXEL_CLUSTERS, 0.6), size=3)
    rows = []
    for fov in FOVS:
        n_cells, n_pixels = 70, 9000
        labels = rng.integers(0, n_cells + 1, n_pixels)
        kind = rng.integers(0, 3, n_cells + 1)
        clusters = np.array([rng.choice(N_PIXEL_CLUSTERS, p=profiles[kind[lab]])
                             for lab in labels]) + 1
        df = pd.DataFrame(rng.random((n_pixels, len(CHANNELS))), columns=CHANNELS)
        df["fov"] = fov
        df["label"] = labels
        df["pixel_som_cluster"] = clusters * 7 + rng.integers(0, 3, n_pixels)
        df["pixel_meta_cluster"] = clusters
        df["pixel_meta_cluster_rename"] = [f"pmc_{c}" for c in clusters]
        feather.write_dataframe(df, os.path.join(pixel_dir, f"{fov}.feather"))
        for lab in range(1, n_cells + 1):
            rows.append({"fov": fov, "label": lab,
                         "cell_size": float(max((labels == lab).sum(), 1))})
    table = pd.DataFrame(rows)
    for ch in CHANNELS:
        table[ch] = rng.random(len(table))
    table.to_csv(os.path.join(base, "cell_table.csv"), index=False)
    return pixel_dir, os.path.join(base, "cell_table.csv")


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """The same cohort in two base dirs, one for each package."""
    root = tmp_path_factory.mktemp("cellclust")
    _write_cohort(str(root / "jax"), np.random.default_rng(12345))
    shutil.copytree(root / "jax", root / "torch")
    return {side: str(root / side) for side in ("jax", "torch")}


def _c2pc(mod, base, col):
    return mod.create_c2pc_data(FOVS, os.path.join(base, "pixel_mat_data"),
                                os.path.join(base, "cell_table.csv"),
                                pixel_cluster_col=col)


@pytest.mark.parametrize("col", ["pixel_meta_cluster_rename", "pixel_som_cluster"])
def test_c2pc_counts_match_jax(dirs, col):
    for got, want in zip(_c2pc(TCU, dirs["torch"], col), _c2pc(JCU, dirs["jax"], col)):
        pd.testing.assert_frame_equal(got, want, check_exact=True)
    labels = np.array([3, 0, 3, 1, 5, 5, 5])
    clusters = np.array([0, 1, 1, 1, 0, 2, 2])
    pd.testing.assert_frame_equal(TCU._c2pc_counts(labels, clusters, ["a", "b", "c"]),
                                  JCU._c2pc_counts(labels, clusters, ["a", "b", "c"]))


def _som(mod, weights_path, count_cols, counts_norm, **kw):
    return mod.CellSOMCluster(counts_norm.copy(), str(weights_path), FOVS,
                              count_cols, seed=42, **kw)


def test_cell_som_normalization_and_training_match_jax(tmp_path, dirs):
    col = "pixel_meta_cluster_rename"
    _, counts_norm = _c2pc(JCU, dirs["jax"], col)
    count_cols = [c for c in counts_norm.columns if c.startswith(col)]
    jsom = _som(JCH, tmp_path / "j.feather", count_cols, counts_norm)
    tsom = _som(TCH, tmp_path / "t.feather", count_cols, counts_norm, device="cpu")
    pd.testing.assert_frame_equal(tsom.cell_data, jsom.cell_data, check_exact=True)
    jsom.train_som()
    tsom.train_som()
    np.testing.assert_allclose(tsom.weights.values, jsom.weights.values,
                               rtol=0, atol=WEIGHTS_ATOL)
    # the weights file round-trips, and a second train_som keeps it
    again = _som(TCH, tmp_path / "t.feather", count_cols, counts_norm, device="cpu")
    pd.testing.assert_frame_equal(again.weights, tsom.weights, check_exact=True)
    with pytest.warns(UserWarning, match="already trained"):
        again.train_som()


def _template3(side, mod, base, jax_weights=None):
    """Template 3's flow (templates/3_pixie_cluster_cells.py) on one side;
    the port's SOM takes `jax_weights` in place of its own when given."""
    cu, sc, mc, wc = mod
    dev = {} if side == "jax" else {"device": "cpu"}
    col = "pixel_meta_cluster_rename"
    counts, counts_norm = cu.create_c2pc_data(
        FOVS, os.path.join(base, "pixel_mat_data"),
        os.path.join(base, "cell_table.csv"), pixel_cluster_col=col)
    count_cols = [c for c in counts_norm.columns if c.startswith(col)]
    pysom = sc.train_cell_som(FOVS, base, os.path.join(base, "cell_table.csv"),
                              count_cols, counts_norm.copy(), seed=42, **dev)
    if jax_weights is not None:
        pysom.weights = jax_weights
    labeled = sc.cluster_cells(base, pysom, count_cols)
    sc.generate_som_avg_files(base, labeled, count_cols, "som_avg.csv")
    cell_cc, labeled = mc.cell_consensus_cluster(base, count_cols, labeled,
                                                 "som_avg.csv", max_k=4)
    mc.generate_meta_avg_files(base, cell_cc, count_cols, labeled, "som_avg.csv",
                               "meta_avg.csv")
    pixel_avg = pd.DataFrame(np.random.default_rng(0).random(
        (N_PIXEL_CLUSTERS, len(CHANNELS))), columns=CHANNELS)
    pixel_avg[col] = [f"pmc_{c}" for c in range(1, N_PIXEL_CLUSTERS + 1)]
    weighted = wc.compute_p2c_weighted_channel_avg(pixel_avg, CHANNELS, counts.copy(),
                                                   fovs=FOVS, pixel_cluster_col=col,
                                                   **dev)
    feather.write_dataframe(weighted, os.path.join(base, "weighted_cell_channel.feather"))
    wc.generate_wc_avg_files(FOVS, CHANNELS, base, cell_cc, labeled)
    remap = cell_cc.mapping.copy()
    remap["cell_meta_cluster"] = (remap["cell_meta_cluster"] % 2) + 1
    remap["cell_meta_cluster_rename"] = remap["cell_meta_cluster"].map(lambda m: f"ct_{m}")
    remap.to_csv(os.path.join(base, "remap.csv"), index=False)
    labeled = mc.apply_cell_meta_cluster_remapping(base, labeled, "remap.csv")
    mc.generate_remap_avg_count_files(base, labeled, "remap.csv", count_cols,
                                      "som_avg.csv", "meta_avg.csv")
    wc.generate_remap_avg_wc_files(FOVS, CHANNELS, base, labeled, "remap.csv",
                                   "weighted_cell_channel.feather",
                                   "cell_som_cluster_channel_avg.csv",
                                   "cell_meta_cluster_channel_avg.csv")
    cu.add_consensus_labels_cell_table(base, os.path.join(base, "cell_table.csv"),
                                       labeled)
    return pysom, labeled, weighted


def test_template3_matches_jax_given_the_jax_weights(dirs):
    jax_mods = (JCU, JSC, JMC, JW)
    torch_mods = (TCU, TSC, TMC, TW)
    jsom, jlab, jweighted = _template3("jax", jax_mods, dirs["jax"])
    tsom, tlab, tweighted = _template3("torch", torch_mods, dirs["torch"],
                                       jax_weights=jsom.weights)
    assert tlab["cell_som_cluster"].nunique() > 10
    pd.testing.assert_frame_equal(tlab, jlab, check_exact=True)
    pd.testing.assert_frame_equal(tsom.cell_data, jsom.cell_data, check_exact=True)
    pd.testing.assert_frame_equal(tweighted, jweighted, check_exact=False,
                                  rtol=MATMUL_RTOL, atol=0)
    for name in ("som_avg.csv", "meta_avg.csv", "cell_table_cell_labels.csv"):
        pd.testing.assert_frame_equal(
            pd.read_csv(os.path.join(dirs["torch"], name)),
            pd.read_csv(os.path.join(dirs["jax"], name)), check_exact=True)
    for name in ("cell_som_cluster_channel_avg.csv", "cell_meta_cluster_channel_avg.csv"):
        pd.testing.assert_frame_equal(
            pd.read_csv(os.path.join(dirs["torch"], name)),
            pd.read_csv(os.path.join(dirs["jax"], name)), check_exact=False,
            rtol=MATMUL_RTOL, atol=0)


def test_weighted_channel_product_refuses_tf32():
    counts = pd.DataFrame({"fov": ["f"], "label": [1], "cell_size": [2.0],
                           "pixel_som_cluster_1": [2.0]})
    avg = pd.DataFrame({"pixel_som_cluster": ["1"], "chan0": [0.5]})
    got = TW.compute_p2c_weighted_channel_avg(avg, ["chan0"], counts,
                                              pixel_cluster_col="pixel_som_cluster",
                                              device="cpu")
    assert got["chan0"].tolist() == [0.5]
    torch.set_float32_matmul_precision("high")
    try:
        with pytest.raises(RuntimeError, match="TF32"):
            TW.compute_p2c_weighted_channel_avg(avg, ["chan0"], counts,
                                                pixel_cluster_col="pixel_som_cluster",
                                                device="cpu")
    finally:
        torch.set_float32_matmul_precision("highest")
