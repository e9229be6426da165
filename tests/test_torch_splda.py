"""ark_tpu_torch.spLDA against ark_tpu.spLDA, on the CPU.

Tolerances, and why:

- ``_digamma`` is XLA's Lanczos formula op for op; XLA's and torch's log1p,
  cos and sin round differently, so it is held within 5e-7 of
  max(|digamma|, 1) over (1e-3, 1e4) (3.4e-7 seen). torch's own
  ``torch.digamma`` misses that bound (1.3e-6).
- Featurized counts, MST edges, difference matrices, the train split, the
  Laplacian (dense, and the port's blocks) and ``fov_density`` are equal;
  ``avg_marker`` sums floats in another order: rtol 1e-6.
- ``_lda_em`` given the JAX package's lambda_0 (``jax.random.gamma`` cannot
  be replayed): the two digammas' last-bit differences pass through exp and
  the fixed point, and grow while it moves, then shrink as it settles. So
  each length has its tolerance (``EM_TOL``: rtol of lambda and gamma, atol
  of the normalised topics and weights), about 5 times the largest
  difference seen on the planted counts with and without smoothing (length
  1: 6.0e-6, 1.7e-4, 3.6e-7, 5.7e-6; 5: 1.5e-5, 4.9e-4, 1.9e-6, 9.9e-6;
  50: 9.8e-7, 2.4e-5, 6.0e-8, 3.0e-7). ``infer`` from a carried model is
  held to 2e-4 on the weights.
- ``gap_stat`` and ``compute_topic_eda`` with both packages' k-means
  replaced by one labeler: equal labels, so cell counts are equal, the
  within-cluster sums within 1e-9 of scipy's and the gap within 1e-9.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.ops import kmeans as JK
from ark_tpu.spLDA import featurization as JF
from ark_tpu.spLDA import model as JM
from ark_tpu.spLDA import processing as JP
from ark_tpu_torch.ops import kmeans as TK
from ark_tpu_torch.spLDA import featurization as TF
from ark_tpu_torch.spLDA import model as TM
from ark_tpu_torch.spLDA import processing as TP
from tests import test_utils
from tests.analysis.test_splda_anchor import FIXTURES, _align_topics, _planted_counts

torch.set_num_threads(1)

DIGAMMA_TOL = 5e-7
# outer iterations: (lambda rtol, gamma rtol, topics atol, weights atol)
EM_TOL = {1: (3e-5, 1e-3, 2e-6, 3e-5), 5: (1e-4, 3e-3, 1e-5, 5e-5),
          50: (5e-6, 1.5e-4, 5e-7, 2e-6)}
WEIGHTS_ATOL = 2e-4


@pytest.fixture()
def fov_df(rng):
    n = 60
    df = pd.DataFrame({
        "x": rng.uniform(0, 300, n), "y": rng.uniform(0, 300, n),
        "cluster": rng.choice(["A", "B", "C"], n),
        "m1": rng.random(n), "m2": rng.random(n),
        "is_index": rng.random(n) < 0.6,
    })
    df.loc[0, "is_index"] = True
    return df


def test_digamma_matches_xla_lanczos_on_a_grid():
    x = np.geomspace(1e-3, 1e4, 200_001).astype(np.float32)
    want = np.asarray(jax.scipy.special.digamma(jnp.asarray(x)))
    got = TM._digamma(torch.from_numpy(x)).numpy()
    scale = np.maximum(np.abs(want), 1.0)
    assert np.max(np.abs(got - want) / scale) < DIGAMMA_TOL
    own = torch.digamma(torch.from_numpy(x)).numpy()
    assert np.max(np.abs(own - want) / scale) > DIGAMMA_TOL


def test_digamma_reflection_and_poles():
    x = np.array([-4.0, -1.0, 0.0, -2.5, -0.3, 0.2, 0.49, 0.5, 1.0, 2.0], np.float32)
    want = np.asarray(jax.scipy.special.digamma(jnp.asarray(x)))
    got = TM._digamma(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=DIGAMMA_TOL, atol=DIGAMMA_TOL)


@pytest.mark.parametrize("reducer,kwargs", [
    ("neighborhood_to_cluster", {}),
    ("neighborhood_to_marker", {"markers": ["m1", "m2"]}),
    ("neighborhood_to_count", {}),
])
def test_count_reducers_equal_the_jax_package(fov_df, reducer, kwargs):
    for radius in (25, 60, 100):
        want = getattr(JF, reducer)(fov_df, radius=radius, **kwargs)
        got = getattr(TF, reducer)(fov_df, radius=radius, device="cpu", **kwargs)
        pd.testing.assert_frame_equal(got, want, check_exact=True)


def test_avg_marker_within_rtol(fov_df):
    want = JF.neighborhood_to_avg_marker(fov_df, radius=60, markers=["m1", "m2"])
    got = TF.neighborhood_to_avg_marker(fov_df, radius=60, markers=["m1", "m2"],
                                        device="cpu")
    pd.testing.assert_frame_equal(got, want, rtol=1e-6)


def test_featurize_samples_fills_a_missing_cluster(fov_df):
    other = fov_df.copy()
    other["cluster"] = other["cluster"].replace("C", "A")
    samples = {"f0": fov_df, "f1": other}
    want = JF.featurize_samples(samples, JF.neighborhood_to_cluster, 60, "is_index",
                                "x", "y")
    got = TF.featurize_samples(
        samples, lambda df, **kw: TF.neighborhood_to_cluster(df, device="cpu", **kw),
        60, "is_index", "x", "y")
    pd.testing.assert_frame_equal(got, want, check_exact=True)
    assert (got.loc["f1", "C"] == 0).all()


def test_mst_edges_equal(rng):
    for n in (15, 200, 3000):
        coords = rng.uniform(0, 100, size=(n, 2))
        np.testing.assert_array_equal(TF._mst_edges(coords), JF._mst_edges(coords))
    coords = rng.uniform(0, 100, size=(5, 2))
    for n in (0, 1, 2):
        np.testing.assert_array_equal(TF._mst_edges(coords[:n]), JF._mst_edges(coords[:n]))
    line = np.stack([np.arange(6, dtype=float), np.zeros(6)], axis=1)
    np.testing.assert_array_equal(TF._mst_edges(line), JF._mst_edges(line))


@pytest.fixture(scope="module")
def formatted():
    table = test_utils.make_cell_table(n_cells=240, fovs=["fov0", "fov1", "fov2"])
    j = JP.format_cell_table(table, markers=["marker0", "marker1"], clusters=["A", "B", "C"])
    t = TP.format_cell_table(table, markers=["marker0", "marker1"], clusters=["A", "B", "C"])
    return j, t


@pytest.mark.parametrize("mode", ["cluster", "marker", "avg_marker", "count"])
def test_featurize_cell_table_split_and_difference_matrices(formatted, mode):
    j, t = formatted
    for fov in j["fovs"]:
        pd.testing.assert_frame_equal(t[fov], j[fov], check_exact=True)
    want = JP.featurize_cell_table(j, featurization=mode, radius=100)
    got = TP.featurize_cell_table(t, featurization=mode, radius=100, device="cpu")
    exact = mode != "avg_marker"
    for key in ("featurized_fovs", "train_features"):
        pd.testing.assert_frame_equal(got[key], want[key], check_exact=exact,
                                      **({} if exact else {"rtol": 1e-6}))
    assert got["featurization"] == mode
    want_d = JP.create_difference_matrices(j, want)
    got_d = TP.create_difference_matrices(t, got)
    for key in ("train_diff_mat", "inference_diff_mat"):
        assert list(got_d[key]) == list(want_d[key])
        for fov in want_d[key]:
            assert got_d[key][fov].dtype == want_d[key][fov].dtype
            np.testing.assert_array_equal(got_d[key][fov], want_d[key][fov])
    with pytest.raises(ValueError):
        TP.create_difference_matrices(t, got, training=False, inference=False)


def test_stratified_split_equal(rng):
    df = pd.DataFrame({"v": rng.random(101)})
    strata = rng.choice(["a", "b", "c"], 101)
    for frac in (0.1, 0.75, 1.0):
        pd.testing.assert_frame_equal(TP._stratified_train_split(df, frac, strata),
                                      JP._stratified_train_split(df, frac, strata))


def test_fov_density_equal(formatted):
    j, t = formatted
    assert TP.fov_density(t) == JP.fov_density(j)
    assert TP.fov_density(t, total_pix=512 ** 2) == JP.fov_density(j, total_pix=512 ** 2)


def _lda_inputs(formatted):
    j, t = formatted
    feats = TP.featurize_cell_table(t, featurization="cluster", radius=100, device="cpu")
    diffs = TP.create_difference_matrices(t, feats)
    return feats, diffs


def test_laplacian_blocks_equal_the_dense_laplacian(formatted):
    feats, diffs = _lda_inputs(formatted)
    for key, feat_key in (("train_diff_mat", "train_features"),
                          ("inference_diff_mat", "featurized_fovs")):
        frame = feats[feat_key]
        want = JM._build_laplacian(frame, diffs[key])
        np.testing.assert_array_equal(TM._build_laplacian(frame, diffs[key]), want)
        dense = np.zeros_like(want)
        blocks = TM.laplacian_blocks(frame, diffs[key], device="cpu")
        assert len(blocks) == len(diffs[key])
        for first, block in blocks:
            m = block.shape[0]
            dense[first:first + m, first:first + m] = block.numpy()
        np.testing.assert_array_equal(dense, want)
    assert TM.laplacian_blocks(feats["train_features"], None, device="cpu") == []
    assert not TM._build_laplacian(feats["train_features"], None).any()


def _jax_lam0(seed, k, v):
    return np.array(jax.random.gamma(jax.random.PRNGKey(seed), 100.0, (k, v)) * 0.01)


def _em_pair(X, L_dense, blocks, k, n_iter, seed=42, alpha=0.2, eta=0.2, penalty=0.25):
    lam_j, gamma_j = JM._lda_em(jnp.asarray(X), jnp.asarray(L_dense), jax.random.PRNGKey(seed),
                                k, alpha, eta, penalty, n_iter=n_iter)
    lam_t, gamma_t = TM._lda_em(torch.from_numpy(X), blocks,
                                torch.from_numpy(_jax_lam0(seed, k, X.shape[1])), k,
                                alpha, eta, penalty, n_iter=n_iter)
    return (np.asarray(lam_j), np.asarray(gamma_j)), (lam_t.numpy(), gamma_t.numpy())


def _normalised(a):
    return a / a.sum(1, keepdims=True)


@pytest.mark.parametrize("n_iter", [1, 5, 50])
@pytest.mark.parametrize("smoothing", [False, True])
def test_lda_em_given_the_jax_initial_topics(n_iter, smoothing):
    rng = np.random.default_rng(20260818)
    X, _ = _planted_counts(rng, n_cells=200)
    X = X.astype(np.float32)
    index = pd.MultiIndex.from_tuples([(f"fov{i // 100}", i % 100) for i in range(len(X))])
    frame = pd.DataFrame(X, index=index)
    coords = rng.uniform(0, 500, (100, 2))
    diffs = {}
    for fov in ("fov0", "fov1"):
        edges = TF._mst_edges(coords)
        d = np.zeros((len(edges), 100), np.float32)
        d[np.arange(len(edges)), edges[:, 0]], d[np.arange(len(edges)), edges[:, 1]] = 1, -1
        diffs[fov] = d
    L = JM._build_laplacian(frame, diffs if smoothing else None)
    blocks = TM.laplacian_blocks(frame, diffs, device="cpu") if smoothing else []
    (lam_j, gamma_j), (lam_t, gamma_t) = _em_pair(X, L, blocks, 3, n_iter)
    lam_rtol, gamma_rtol, topics_atol, weights_atol = EM_TOL[n_iter]
    np.testing.assert_allclose(lam_t, lam_j, rtol=lam_rtol)
    np.testing.assert_allclose(gamma_t, gamma_j, rtol=gamma_rtol)
    np.testing.assert_allclose(_normalised(lam_t), _normalised(lam_j), atol=topics_atol)
    np.testing.assert_allclose(_normalised(gamma_t), _normalised(gamma_j), atol=weights_atol)


def test_lda_em_rejects_a_misshapen_lam0():
    X = torch.ones(4, 3)
    with pytest.raises(ValueError, match="lam0"):
        TM._lda_em(X, [], torch.ones(2, 4), 2, 0.5, 0.5, 0.25, n_iter=1)


def test_infer_with_a_carried_model(formatted):
    feats, diffs = _lda_inputs(formatted)
    jmodel = JM.train(feats["train_features"], diffs["train_diff_mat"], n_topics=3,
                      n_iters=10)
    tmodel = TM.lda_from_reference(jmodel.components_, jmodel.topic_weights,
                                   jmodel.feature_names, jmodel.n_topics, jmodel.alpha,
                                   jmodel.eta)
    assert tmodel.feature_names == jmodel.feature_names
    pd.testing.assert_frame_equal(tmodel.topic_weights, jmodel.topic_weights)
    for n_iters, diff in ((5, None), (30, diffs["inference_diff_mat"])):
        want = JM.infer(jmodel, feats["featurized_fovs"], difference_matrices=diff,
                        n_iters=n_iters)
        got = TM.infer(tmodel, feats["featurized_fovs"], difference_matrices=diff,
                       n_iters=n_iters, device="cpu")
        assert list(got.columns) == list(want.columns)
        assert got.index.equals(want.index)
        np.testing.assert_allclose(got.values, want.values, atol=WEIGHTS_ATOL)
    weights = tmodel.topic_weights.values
    carried = TM.lda_from_reference(jmodel.components_, weights, jmodel.feature_names,
                                    3, jmodel.alpha, jmodel.eta)
    assert list(carried.topic_weights.columns) == ["Topic-0", "Topic-1", "Topic-2"]


def test_train_frames_and_initial_topics(formatted):
    feats, diffs = _lda_inputs(formatted)
    train = feats["train_features"]
    model = TM.train(train, diffs["train_diff_mat"], n_topics=4, n_iters=8, device="cpu")
    assert model.components_.shape == (4, train.shape[1])
    assert model.components_.dtype == np.float32
    np.testing.assert_allclose(model.components_.sum(1), 1.0, rtol=1e-5)
    np.testing.assert_allclose(model.topic_weights.values.sum(1), 1.0, rtol=1e-5)
    assert model.topic_weights.index.equals(train.index)
    assert model.feature_names == list(train.columns)
    assert (model.alpha, model.eta, model.n_topics) == (0.25, 0.25, 4)
    again = TM.train(train, diffs["train_diff_mat"], n_topics=4, n_iters=8, device="cpu")
    np.testing.assert_array_equal(again.components_, model.components_)
    lam0 = TM.initial_topics(42, 4, 7)
    assert lam0.dtype == np.float32 and lam0.shape == (4, 7)
    np.testing.assert_array_equal(lam0, TM.initial_topics(42, 4, 7))
    assert 0.7 < lam0.mean() < 1.3


def _train_components_port(X, lam0_fn, n_topics=3, seed=42, monkeypatch=None):
    df = pd.DataFrame(X.astype(np.float32),
                      index=pd.MultiIndex.from_tuples([("fov0", i) for i in range(len(X))]),
                      columns=[f"f{j}" for j in range(X.shape[1])])
    monkeypatch.setattr(TM, "initial_topics", lam0_fn)
    return TM.train(df, n_topics=n_topics, n_iters=80, seed=seed, device="cpu").components_


@pytest.mark.parametrize("draw", ["jax", "port"])
def test_frozen_topic_matrix_golden(monkeypatch, draw):
    """The committed golden of tests/analysis/test_splda_anchor.py: the port's
    train given the JAX package's lambda_0 (and given its own numpy draw)
    meets it at that test's atol 5e-3 after alignment."""
    X, _ = _planted_counts(np.random.default_rng(20260818))
    own = TM.initial_topics
    lam0_fn = (lambda seed, k, v: _jax_lam0(seed, k, v)) if draw == "jax" else own
    got = _train_components_port(X, lam0_fn, monkeypatch=monkeypatch)
    want = np.load(os.path.join(FIXTURES, "splda_topic_golden.npy"))
    np.testing.assert_allclose(_align_topics(got, want), want, atol=5e-3)


class _SharedLabeler:
    """One k-means for both packages: labels from the nearest of k rows
    picked by `seed`, inertia their f64 squared distances (the same arrays
    in, the same labels out)."""

    def __init__(self):
        self.calls = []

    def __call__(self, data, k, seed=42, **kwargs):
        data = np.asarray(data, np.float64)
        self.calls.append((data.shape, k, seed))
        rows = np.random.default_rng(seed).choice(len(data), k, replace=False)
        d2 = ((data[:, None, :] - data[rows][None]) ** 2).sum(-1)
        labels = np.argmin(d2, axis=1).astype(np.int32)
        return labels, float(d2.min(1).sum())


def test_gap_stat_and_topic_eda_with_one_labeler(monkeypatch, formatted):
    feats, _ = _lda_inputs(formatted)
    train = feats["train_features"]
    labeler = _SharedLabeler()
    monkeypatch.setattr(JK, "kmeans", labeler)
    monkeypatch.setattr(TK, "kmeans", labeler)
    np.random.seed(7)
    want_gap = JP.gap_stat(train, 3, 123.0, num_boots=25)
    np.random.seed(7)
    got_gap = TP.gap_stat(train, 3, 123.0, num_boots=25, device="cpu")
    np.testing.assert_allclose(got_gap, want_gap, rtol=1e-9)
    np.random.seed(3)
    want = JP.compute_topic_eda(train, "cluster", topics=[3, 4], silhouette=True,
                                num_boots=25)
    np.random.seed(3)
    got = TP.compute_topic_eda(train, "cluster", topics=[3, 4], silhouette=True,
                               num_boots=25, device="cpu")
    assert got["featurization"] == want["featurization"] == "cluster"
    assert got["inertia"] == want["inertia"]
    for k in (3, 4):
        pd.testing.assert_frame_equal(got["cell_counts"][k], want["cell_counts"][k],
                                      check_exact=True)
        assert got["silhouette"][k] == pytest.approx(want["silhouette"][k], rel=1e-5)
        assert got["gap_stat"][k] == pytest.approx(want["gap_stat"][k], rel=1e-9)
        assert got["gap_sds"][k] == pytest.approx(want["gap_sds"][k], rel=1e-9)
    with pytest.raises(ValueError, match="bootstrap"):
        TP.compute_topic_eda(train, "cluster", topics=[3], num_boots=10, device="cpu")
    with pytest.raises(ValueError, match="Number of topics"):
        TP.compute_topic_eda(train, "cluster", topics=[1, 3], device="cpu")


def test_topic_eda_real_kmeans_on_separated_features():
    rng = np.random.default_rng(5)
    centers = np.array([[30, 0, 0, 2], [0, 30, 2, 0], [0, 2, 30, 0]], np.float32)
    truth = np.repeat(np.arange(3), 40)
    values = np.round(centers[truth] + rng.uniform(0, 3, (120, 4))).astype(np.float32)
    frame = pd.DataFrame(values, columns=["A", "B", "C", "D"],
                         index=pd.MultiIndex.from_tuples([("f", i) for i in range(120)]))
    np.random.seed(11)
    got = TP.compute_topic_eda(frame, "cluster", topics=[2, 3, 4], num_boots=25,
                               device="cpu")
    np.random.seed(11)
    want = JP.compute_topic_eda(frame, "cluster", topics=[2, 3, 4], num_boots=25)
    counts = got["cell_counts"][3]
    # each planted group is one cluster: its own feature dominates one column
    assert sorted(counts.values.argmax(0)) == [0, 1, 2]
    # the same partition from either seeding; the bootstraps' k-means are
    # seeded differently, so each package's gap is checked on its own
    assert got["inertia"][3] == pytest.approx(want["inertia"][3], rel=1e-5)
    for gap in (got["gap_stat"], want["gap_stat"]):
        assert gap[3] > gap[2] + 0.5, gap
