"""ark_tpu_torch.analysis.visualize against ark_tpu.analysis.visualize, on
the CPU under Agg: each plot runs in both packages on the same inputs and
writes the same files; the data behind them (the sorted crosstab, the
drawn points and edges) are equal."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402

from ark_tpu.analysis import visualize as JV  # noqa: E402
from ark_tpu.utils.labeled_array import DataArray as JDataArray  # noqa: E402
from ark_tpu_torch.analysis import visualize as TV  # noqa: E402
from ark_tpu_torch.spLDA import processing as TP  # noqa: E402
from ark_tpu_torch.utils.labeled_array import DataArray as TDataArray  # noqa: E402
from tests import test_utils  # noqa: E402


@pytest.fixture()
def cell_data():
    return test_utils.make_cell_table(n_cells=200)


def _files_of(tmp_path, name, call):
    out = tmp_path / name
    out.mkdir()
    call(str(out))
    plt.close("all")
    return sorted(p.name for p in out.iterdir())


def _same_files(tmp_path, call_jax, call_port):
    want = _files_of(tmp_path, "jax", call_jax)
    got = _files_of(tmp_path, "port", call_port)
    assert got == want and got
    return got


def test_draw_boxplot(cell_data, tmp_path):
    for i, kwargs in enumerate(({}, {"col_split": "cell_meta_cluster"},
                                {"col_split": "cell_meta_cluster", "split_vals": ["A", "B"]})):
        case = tmp_path / f"case{i}"
        case.mkdir()
        _same_files(case,
                    lambda d: JV.draw_boxplot(cell_data, "marker0", save_dir=d,
                                              save_file="box.png", **kwargs),
                    lambda d: TV.draw_boxplot(cell_data, "marker0", save_dir=d,
                                              save_file="box.png", **kwargs))
    for bad in ({"col_name": "nope"}, {"col_name": "marker0", "split_vals": ["A"]},
                {"col_name": "marker0", "col_split": "nope"}):
        with pytest.raises(ValueError):
            TV.draw_boxplot(cell_data, **bad)


@pytest.mark.parametrize("normalized", [False, True])
def test_get_sorted_data_equal(cell_data, normalized):
    want = JV.get_sorted_data(cell_data, "PatientID", "cell_meta_cluster", normalized)
    got = TV.get_sorted_data(cell_data, "PatientID", "cell_meta_cluster", normalized)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_population_distribution_and_barchart(cell_data, tmp_path):
    files = _same_files(
        tmp_path,
        lambda d: JV.visualize_patient_population_distribution(
            cell_data, "PatientID", "cell_meta_cluster", save_dir=d),
        lambda d: TV.visualize_patient_population_distribution(
            cell_data, "PatientID", "cell_meta_cluster", save_dir=d))
    assert files == ["PopulationDistribution.png", "PopulationProportion.png",
                     "TotalPopulationDistribution.png"]
    TV.plot_barchart(cell_data["cell_meta_cluster"].value_counts(), "t", "x", "y",
                     is_legend=False)
    plt.close("all")


def test_neighbor_cluster_metrics(tmp_path):
    values, coords = np.array([10.0, 6.0, 4.0, 3.0]), {"cluster_num": [2, 3, 4, 5]}
    files = _same_files(
        tmp_path,
        lambda d: JV.visualize_neighbor_cluster_metrics(JDataArray(values, coords=coords),
                                                        "inertia", save_dir=d),
        lambda d: TV.visualize_neighbor_cluster_metrics(TDataArray(values, coords=coords),
                                                        "inertia", save_dir=d))
    assert files == ["neighborhood_inertia_scores.png"]


@pytest.fixture()
def eda():
    rng = np.random.default_rng(3)
    return {"inertia": {3: 10.0, 4: 8.0}, "silhouette": {3: 0.5, 4: 0.6},
            "gap_stat": {3: 0.1, 4: 0.2}, "gap_sds": {3: 0.01, 4: 0.02},
            "cell_counts": {3: pd.DataFrame(rng.random((4, 3))),
                            4: pd.DataFrame(rng.random((4, 4)))},
            "featurization": "cluster"}


@pytest.mark.parametrize("metric,kwargs", [
    ("gap_stat", {}), ("gap_stat", {"gap_sd": False}), ("inertia", {}),
    ("silhouette", {}), ("cell_counts", {"k": 3}), ("cell_counts", {"k": 4, "transpose": True})])
def test_visualize_topic_eda(eda, tmp_path, metric, kwargs):
    files = _same_files(tmp_path,
                        lambda d: JV.visualize_topic_eda(eda, metric=metric, save_dir=d,
                                                         **kwargs),
                        lambda d: TV.visualize_topic_eda(eda, metric=metric, save_dir=d,
                                                         **kwargs))
    suffix = f"_k_{kwargs['k']}" if metric == "cell_counts" else ""
    assert files == [f"topic_eda_{metric}{suffix}.png"]


def test_visualize_topic_eda_rejects(eda):
    with pytest.raises(ValueError):
        TV.visualize_topic_eda(eda, metric="cell_counts")
    with pytest.raises(ValueError):
        TV.visualize_topic_eda(eda, metric="bogus")


@pytest.mark.parametrize("metric", ["cellular_density", "average_area", "total_cells",
                                    "other"])
def test_visualize_fov_stats(tmp_path, metric):
    dens = {"cellular_density": {"fov0": 0.4, "fov1": 0.5},
            "average_area": {"fov0": 100, "fov1": 120},
            "total_cells": {"fov0": 300, "fov1": 250}}
    files = _same_files(tmp_path,
                        lambda d: JV.visualize_fov_stats(dens, metric=metric, save_dir=d),
                        lambda d: TV.visualize_fov_stats(dens, metric=metric, save_dir=d))
    assert files == [f"fov_metrics_{metric}.png"]


def test_visualize_fov_graphs_draws_the_mst(tmp_path):
    table = test_utils.make_cell_table(n_cells=160, fovs=["fov0", "fov1"])
    fmt = TP.format_cell_table(table, clusters=["A", "B", "C"])
    features = TP.featurize_cell_table(fmt, featurization="cluster", radius=100,
                                       device="cpu")
    diffs = TP.create_difference_matrices(fmt, features)

    def drawn(vis, d):
        vis.visualize_fov_graphs(fmt, features, diffs, fovs=["fov0", "fov1"], save_dir=d)
        axes = plt.gcf().axes
        return [(len(ax.lines), ax.collections[0].get_offsets().data.copy()) for ax in axes]

    want = drawn(JV, None)
    plt.close("all")
    got = drawn(TV, None)
    for (n_got, pts_got), (n_want, pts_want), fov in zip(got, want, ["fov0", "fov1"]):
        assert n_got == n_want == len(diffs["train_diff_mat"][fov])
        np.testing.assert_array_equal(pts_got, pts_want)
    plt.close("all")
    files = _same_files(
        tmp_path,
        lambda d: JV.visualize_fov_graphs(fmt, features, diffs, ["fov0"], save_dir=d),
        lambda d: TV.visualize_fov_graphs(fmt, features, diffs, ["fov0"], save_dir=d))
    assert files == ["adjacency_graph_fovs_fov0.png"]


def test_draw_heatmap_writes_its_file(tmp_path):
    data = np.random.default_rng(4).normal(size=(10, 6))
    data[0, 0], data[1, 1] = np.nan, np.inf
    files = _same_files(
        tmp_path,
        lambda d: JV.draw_heatmap(data, [f"r{i}" for i in range(10)],
                                  [f"c{j}" for j in range(6)], save_dir=d, save_file="h.png"),
        lambda d: TV.draw_heatmap(data, [f"r{i}" for i in range(10)],
                                  [f"c{j}" for j in range(6)], save_dir=d, save_file="h.png"))
    assert files == ["h.png"]
