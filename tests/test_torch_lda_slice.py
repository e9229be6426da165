"""The spatial-LDA slice end to end, the port against the JAX package, on
the CPU: the flow of templates/lda_preprocessing_training_inference.py on
tests/analysis/test_splda.py's two-environment cohort (2 FOVs x 300 cells:
types A/B on the left half, C/D on the right).

Frame by frame: the formatted tables, featurized counts, train split,
difference matrices and FOV statistics are equal; the topic EDA is equal
with both packages' k-means replaced by one labeler (the gap statistic
within 1e-9). Where the EM is involved the port is given the JAX
package's lambda_0: topics within 1e-5 and topic weights within 2e-4 after
30 outer iterations, inferred weights within 2e-4 (test_torch_splda.py
states why). With its own draw the port recovers the environments as
test_splda.py asserts it (purity > 1.5 of 2), and its files read back.
"""

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.ops import kmeans as JK
from ark_tpu.spLDA import model as JM
from ark_tpu.spLDA import processing as JP
from ark_tpu_torch.ops import kmeans as TK
from ark_tpu_torch.spLDA import model as TM
from ark_tpu_torch.spLDA import processing as TP
from ark_tpu_torch.utils import spatial_lda_utils as TU
from tests.analysis.test_splda import lda_cell_table  # noqa: F401  (fixture)
from tests.test_torch_splda import _SharedLabeler

torch.set_num_threads(1)

CLUSTERS = ["A", "B", "C", "D"]
TOPICS_ATOL, WEIGHTS_ATOL = 1e-5, 2e-4


@pytest.fixture(scope="module")
def flows(lda_cell_table):  # noqa: F811
    """Both packages' preprocessing of the cohort."""
    out = {}
    for name, pkg, kw in (("jax", JP, {}), ("port", TP, {"device": "cpu"})):
        fmt = pkg.format_cell_table(lda_cell_table, clusters=CLUSTERS)
        features = pkg.featurize_cell_table(fmt, featurization="cluster", radius=100, **kw)
        out[name] = (fmt, features, pkg.create_difference_matrices(fmt, features))
    return out


def test_preprocessing_frame_by_frame(flows):
    (jfmt, jfeat, jdiff), (tfmt, tfeat, tdiff) = flows["jax"], flows["port"]
    assert list(tfmt["fovs"]) == list(jfmt["fovs"]) == ["fov0", "fov1"]
    assert tfmt["clusters"] == jfmt["clusters"] and tfmt["markers"] is None
    for fov in jfmt["fovs"]:
        pd.testing.assert_frame_equal(tfmt[fov], jfmt[fov], check_exact=True)
    for key in ("featurized_fovs", "train_features"):
        pd.testing.assert_frame_equal(tfeat[key], jfeat[key], check_exact=True)
    assert len(tfeat["featurized_fovs"]) == 600 and len(tfeat["train_features"]) == 450
    for key in ("train_diff_mat", "inference_diff_mat"):
        for fov in jdiff[key]:
            np.testing.assert_array_equal(tdiff[key][fov], jdiff[key][fov])
    assert TP.fov_density(tfmt) == JP.fov_density(jfmt)


def test_topic_eda_with_one_labeler(flows, monkeypatch):
    labeler = _SharedLabeler()
    monkeypatch.setattr(JK, "kmeans", labeler)
    monkeypatch.setattr(TK, "kmeans", labeler)
    eda = {}
    for name, pkg, kw in (("jax", JP, {}), ("port", TP, {"device": "cpu"})):
        np.random.seed(9)
        eda[name] = pkg.compute_topic_eda(flows[name][1]["train_features"], "cluster",
                                          topics=[3, 4], num_boots=25, **kw)
    want, got = eda["jax"], eda["port"]
    assert got["inertia"] == want["inertia"]
    for k in (3, 4):
        pd.testing.assert_frame_equal(got["cell_counts"][k], want["cell_counts"][k])
        assert got["gap_stat"][k] == pytest.approx(want["gap_stat"][k], rel=1e-9)
        assert got["gap_sds"][k] == pytest.approx(want["gap_sds"][k], rel=1e-9)
    assert len(labeler.calls) == 2 * (2 + 2 * 25)


def _jax_draw(seed, k, v):
    return np.array(jax.random.gamma(jax.random.PRNGKey(seed), 100.0, (k, v)) * 0.01)


def test_train_and_infer_given_the_jax_draw(flows, monkeypatch):
    (_, jfeat, jdiff), (_, tfeat, tdiff) = flows["jax"], flows["port"]
    jmodel = JM.train(jfeat["train_features"], difference_matrices=jdiff["train_diff_mat"],
                      n_topics=2, n_iters=30, seed=42)
    monkeypatch.setattr(TM, "initial_topics", _jax_draw)
    tmodel = TM.train(tfeat["train_features"], difference_matrices=tdiff["train_diff_mat"],
                      n_topics=2, n_iters=30, seed=42, device="cpu")
    np.testing.assert_allclose(tmodel.components_, jmodel.components_, atol=TOPICS_ATOL)
    assert tmodel.topic_weights.index.equals(jmodel.topic_weights.index)
    assert list(tmodel.topic_weights.columns) == list(jmodel.topic_weights.columns)
    np.testing.assert_allclose(tmodel.topic_weights.values, jmodel.topic_weights.values,
                               atol=WEIGHTS_ATOL)
    want = JM.infer(jmodel, jfeat["featurized_fovs"],
                    difference_matrices=jdiff["inference_diff_mat"], n_iters=20)
    for model in (tmodel, TM.lda_from_reference(
            jmodel.components_, jmodel.topic_weights, jmodel.feature_names,
            jmodel.n_topics, jmodel.alpha, jmodel.eta)):
        got = TM.infer(model, tfeat["featurized_fovs"],
                       difference_matrices=tdiff["inference_diff_mat"], n_iters=20,
                       device="cpu")
        assert got.index.equals(want.index) and got.shape == (600, 2)
        np.testing.assert_allclose(got.values, want.values, atol=WEIGHTS_ATOL)


def test_port_recovers_the_environments_and_saves(flows, tmp_path):
    tfmt, tfeat, tdiff = flows["port"]
    model = TM.train(tfeat["train_features"], difference_matrices=tdiff["train_diff_mat"],
                     n_topics=2, n_iters=30, seed=42, device="cpu")
    np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-4)
    tw = model.topic_weights
    np.testing.assert_allclose(tw.values.sum(1), 1.0, rtol=1e-4)
    fov0 = tfeat["train_features"].loc["fov0"]
    ab_heavy = (fov0[["A", "B"]].sum(axis=1) > fov0[["C", "D"]].sum(axis=1)).values
    dom0 = tw.loc["fov0"].values.argmax(1)
    purity = max((dom0[ab_heavy] == 0).mean() + (dom0[~ab_heavy] == 1).mean(),
                 (dom0[ab_heavy] == 1).mean() + (dom0[~ab_heavy] == 0).mean())
    assert purity > 1.5
    inferred = TM.infer(model, tfeat["featurized_fovs"],
                        difference_matrices=tdiff["inference_diff_mat"], n_iters=20,
                        device="cpu")
    np.testing.assert_allclose(inferred.values.sum(1), 1.0, rtol=1e-4)
    TU.save_spatial_lda_file(model, str(tmp_path), "lda_model", format="pkl")
    TU.save_spatial_lda_file(inferred, str(tmp_path), "topic_weights", format="csv")
    back = TU.read_spatial_lda_file(str(tmp_path), "lda_model", format="pkl")
    assert isinstance(back, TM.LatentDirichletAllocation)
    np.testing.assert_array_equal(back.components_, model.components_)
    pd.testing.assert_frame_equal(back.topic_weights, model.topic_weights)
    csv = TU.read_spatial_lda_file(str(tmp_path), "topic_weights", format="csv")
    np.testing.assert_allclose(csv[["Topic-0", "Topic-1"]].values, inferred.values,
                               rtol=1e-6)
