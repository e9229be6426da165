"""ark_tpu_torch.utils.spatial_lda_utils against the JAX package's module,
on the CPU: the argument checks raise alike, ``within_cluster_sums`` (f64
pair sums on the device) meets scipy's ``pdist`` within rtol 1e-9, the
plots draw under Agg, the colour table is matplotlib's Set3, and pkl/csv
files round-trip."""

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ark_tpu.utils import spatial_lda_utils as JU  # noqa: E402
from ark_tpu_torch.spLDA import processing as TP  # noqa: E402
from ark_tpu_torch.utils import spatial_lda_utils as TU  # noqa: E402
from tests import test_utils  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture()
def formatted():
    ct = test_utils.make_cell_table(n_cells=150, fovs=["fov0", "fov1"])
    return TP.format_cell_table(ct, clusters=["A", "B", "C"])


def _raises_alike(fn_name, *args):
    with pytest.raises(Exception) as want:
        getattr(JU, fn_name)(*args)
    with pytest.raises(type(want.value), match=None) as got:
        getattr(TU, fn_name)(*args)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("markers,clusters", [
    (None, None), ([], None), (None, []), (["not_a_marker"], None),
    (None, ["NotACluster"])])
def test_format_checks_raise_alike(markers, clusters):
    ct = test_utils.make_cell_table(n_cells=30)
    _raises_alike("check_format_cell_table_args", ct, markers, clusters)
    TU.check_format_cell_table_args(ct, ["marker0"], ["A"])


@pytest.mark.parametrize("featurization,radius,cell_index", [
    ("cluster", 50.0, "is_index"), ("cluster", 10, "is_index"),
    ("bogus", 100, "is_index"), ("cluster", 100, "label"), ("marker", 100, "is_index")])
def test_featurize_checks_raise_alike(formatted, featurization, radius, cell_index):
    _raises_alike("check_featurize_cell_table_args", formatted, featurization, radius,
                  cell_index)
    TU.check_featurize_cell_table_args(formatted, "cluster", 100, "is_index")


@pytest.mark.parametrize("case", ["f64 normal", "f32 counts", "uniform", "singletons",
                                  "blocks"])
def test_within_cluster_sums_against_scipy(rng, monkeypatch, case):
    if case == "f32 counts":
        data = rng.poisson(4.0, (300, 20)).astype(np.float32)
    elif case == "uniform":
        data = rng.uniform(0.0, [3, 40, 7, 1, 12], (257, 5))
    else:
        data = rng.normal(size=(90, 3))
    labels = rng.integers(0, 4, len(data))
    if case == "singletons":
        labels = np.arange(len(data))
    if case == "blocks":
        # a few rows a block: the blocks' triangles and the rest of each row
        monkeypatch.setattr(TU, "PAIR_BLOCK_ELEMS", 64)
    want = JU.within_cluster_sums(data, labels)
    got = TU.within_cluster_sums(data, labels, device="cpu")
    assert got == pytest.approx(want, rel=1e-9, abs=0 if want else 1e-300)


def test_set3_is_matplotlibs():
    assert TU._SET3 == tuple(plt.get_cmap("Set3").colors) == tuple(JU._SET3)


@pytest.fixture()
def lda_outputs(formatted):
    features = TP.featurize_cell_table(formatted, featurization="cluster", radius=100,
                                       device="cpu")
    diff = TP.create_difference_matrices(formatted, features)
    rng = np.random.default_rng(0)
    feats = features["featurized_fovs"].loc[["fov0"]]
    weights = pd.DataFrame(rng.dirichlet(np.ones(3), len(feats)), index=feats.index)
    return features, diff, weights


def test_plots_draw(formatted, lda_outputs):
    features, diff, weights = lda_outputs
    TU.plot_topics_heatmap(np.random.default_rng(1).random((3, 3)), ["A", "B", "C"])
    TU.plot_topics_heatmap(np.ones((2, 3)), ["A", "B", "C"], normalizer=lambda t: t,
                           transpose=True)
    fig, axes = plt.subplots(1, 2)
    adjacency = TU.make_plot_fn("adjacency", difference_matrices=diff["train_diff_mat"])
    adjacency(axes[0], "fov0", None, formatted["fov0"])
    assert len(axes[0].lines) > 0
    topics = TU.make_plot_fn("topic_assignment", topic_weights=weights,
                             cell_table=formatted)
    topics(axes[1], "fov0")
    assert axes[1].get_title() == "FOV fov0"
    TU.plot_fovs_with_topics(axes[1], "fov0", weights, formatted, uncolor_subset="isimmune")
    for kwargs in ({"plot": "adjacency"}, {"plot": "topic_assignment"}, {"plot": "bogus"}):
        with pytest.raises(ValueError):
            TU.make_plot_fn(**kwargs)
    plt.close("all")


def test_save_and_read_files(tmp_path):
    d = {"a": 1, "b": [1, 2]}
    TU.save_spatial_lda_file(d, str(tmp_path), "obj", format="pkl")
    assert TU.read_spatial_lda_file(str(tmp_path), "obj", format="pkl") == d
    df = pd.DataFrame({"x": [1, 2], "y": [0.5, 1.5]})
    TU.save_spatial_lda_file(df, str(tmp_path), "frame", format="csv")
    back = TU.read_spatial_lda_file(str(tmp_path), "frame", format="csv")
    pd.testing.assert_frame_equal(back.drop(columns="Unnamed: 0"), df)
    # the JAX package reads what the port writes
    pd.testing.assert_frame_equal(JU.read_spatial_lda_file(str(tmp_path), "frame", "csv"),
                                  back)
    with pytest.raises(ValueError, match="dict"):
        TU.save_spatial_lda_file(d, str(tmp_path), "bad", format="csv")
    with pytest.raises(ValueError, match="model"):
        TU.save_spatial_lda_file(object(), str(tmp_path), "bad", format="csv")
    with pytest.raises(ValueError, match="format"):
        TU.save_spatial_lda_file(df, str(tmp_path), "bad", format="txt")
    with pytest.raises(ValueError, match="valid directory"):
        TU.save_spatial_lda_file(df, str(tmp_path / "missing"), "frame")
    with pytest.raises(FileNotFoundError):
        TU.read_spatial_lda_file(str(tmp_path), "missing")
    (tmp_path / "frame.txt").write_text("x")
    with pytest.raises(ValueError, match="format"):
        TU.read_spatial_lda_file(str(tmp_path), "frame", format="txt")
