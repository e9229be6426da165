"""The port's Pixie pixel stage (template 2) against itself and ark_tpu.

The cohort is tests/phenotyping/test_pixie_fused.py's: 3 FOVs of 48x48 x 4
channels, max_k=5, subset_proportion=0.5.

(a) The port's fused driver writes the port's multi-pass artifacts bit for
    bit: the JAX package's own contract, on device="cpu".
(b) The port against the JAX package's fused run: the channel norms and the
    threshold to rtol 1e-6 (blur tap sums and channel sums in another
    order); the subset feathers hold the same rows, with values to rtol
    1e-5 (that rounding through the row sums and the 99.9% norms); the SOM
    weights to atol 1e-5 (the order of the H^T X sums); SOM and meta labels
    equal but at near-ties (chip_smoke.py's rule), which are counted.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io import feather_utils as feather
from ark_tpu_torch.phenotyping import (pixel_meta_clustering,
                                       pixel_som_clustering, pixie_fused,
                                       pixie_preprocessing)
from tests.phenotyping.test_pixie_fused import (ARTIFACTS, CHANNELS, CSVS, FOVS,
                                                MAX_K, _build_cohort)
from tests.phenotyping.test_pixie_fused import _run_fused as _run_jax_fused
from tests.test_torch_som import assert_labels_equal_except_near_ties

torch.set_num_threads(1)

NORM_RTOL = 1e-6
SUBSET_RTOL = 1e-5
WEIGHTS_ATOL = 1e-5


def _run_port_fused(base, tiff_dir, seg_dir, **kw):
    return pixie_fused.run_pixel_clustering(
        FOVS, CHANNELS, base, tiff_dir, seg_dir=seg_dir, img_sub_folder=None,
        max_k=MAX_K, subset_proportion=0.5, device="cpu", **kw)


def _run_port_multipass(base, tiff_dir, seg_dir):
    pixie_preprocessing.create_pixel_matrix(
        FOVS, CHANNELS, base, tiff_dir, seg_dir, img_sub_folder=None,
        subset_proportion=0.5, device="cpu")
    pysom = pixel_som_clustering.train_pixel_som(
        FOVS, CHANNELS, base,
        norm_vals_name="channel_norm_post_rownorm.feather", device="cpu")
    pixel_som_clustering.cluster_pixels(FOVS, base, pysom)
    pixel_som_clustering.generate_som_avg_files(
        FOVS, CHANNELS, base, pysom, data_dir="pixel_mat_data")
    cc = pixel_meta_clustering.pixel_consensus_cluster(
        FOVS, CHANNELS, base, max_k=MAX_K)
    pixel_meta_clustering.generate_meta_avg_files(
        FOVS, CHANNELS, base, cc, data_dir="pixel_mat_data")


def _read(base, rel):
    path = os.path.join(base, rel)
    return pd.read_csv(path) if rel.endswith(".csv") \
        else feather.read_dataframe(path)


def _assert_same_artifacts(base_a, base_b):
    for rel in ARTIFACTS + CSVS:
        try:
            pd.testing.assert_frame_equal(_read(base_b, rel), _read(base_a, rel),
                                          check_exact=True)
        except AssertionError as e:
            raise AssertionError(f"artifact mismatch: {rel}\n{e}") from e


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's fused and multi-pass runs and the JAX package's fused run,
    each on its own copy of one cohort."""
    bases = {}
    for name in ("port_fused", "port_mp", "jax_fused"):
        bases[name] = _build_cohort(tmp_path_factory.mktemp(name))
    _run_port_fused(*bases["port_fused"])
    _run_port_multipass(*bases["port_mp"])
    _run_jax_fused(*bases["jax_fused"])
    return {name: b[0] for name, b in bases.items()}


def test_port_fused_equals_port_multipass(runs):
    _assert_same_artifacts(runs["port_mp"], runs["port_fused"])
    t = feather.read_table(os.path.join(runs["port_fused"], "pixel_mat_data",
                                        "fov0.feather"))
    assert {"pixel_som_cluster", "pixel_meta_cluster"} <= set(t.column_names)
    assert not os.path.exists(
        os.path.join(runs["port_fused"], "pixel_output_dir", "_fused_cache"))


@pytest.mark.parametrize("budget", [dict(hbm_cache_bytes=0),
                                    dict(host_cache_bytes=0)])
def test_port_fused_spill_paths_equal_multipass(runs, tmp_path, budget):
    """Device-cache and host-store spills take other code paths to the same
    artifacts."""
    base, tiff_dir, seg_dir = _build_cohort(tmp_path / "spill")
    _run_port_fused(base, tiff_dir, seg_dir, **budget)
    _assert_same_artifacts(runs["port_mp"], base)


@pytest.mark.parametrize("rel", [
    "pixel_output_dir/channel_norm_pre_rownorm.feather",
    "pixel_output_dir/pixel_thresh.feather",
    "channel_norm_post_rownorm.feather",
])
def test_port_norms_and_threshold_match_jax(runs, rel):
    port, ref = _read(runs["port_fused"], rel), _read(runs["jax_fused"], rel)
    assert list(port.columns) == list(ref.columns)
    np.testing.assert_allclose(port.values, ref.values, rtol=NORM_RTOL, atol=0)


@pytest.mark.parametrize("fov", FOVS)
def test_port_subsets_match_jax(runs, fov):
    rel = f"pixel_mat_subsetted/{fov}.feather"
    port, ref = _read(runs["port_fused"], rel), _read(runs["jax_fused"], rel)
    meta = ["fov", "row_index", "column_index", "label"]
    pd.testing.assert_index_equal(port.index, ref.index)
    pd.testing.assert_frame_equal(port[meta], ref[meta], check_exact=True)
    np.testing.assert_allclose(port[CHANNELS].values, ref[CHANNELS].values,
                               rtol=SUBSET_RTOL, atol=0)


def test_port_weights_and_labels_match_jax(runs):
    w_port = _read(runs["port_fused"], "pixel_som_weights.feather")
    w_ref = _read(runs["jax_fused"], "pixel_som_weights.feather")
    assert list(w_port.columns) == list(w_ref.columns) == CHANNELS
    np.testing.assert_allclose(w_port.values, w_ref.values, rtol=0,
                               atol=WEIGHTS_ATOL)
    weights = w_port.values.astype(np.float32)
    differ_som = differ_meta = 0
    for fov in FOVS:
        rel = f"pixel_mat_data/{fov}.feather"
        port, ref = _read(runs["port_fused"], rel), _read(runs["jax_fused"], rel)
        meta = ["fov", "row_index", "column_index", "label"]
        pd.testing.assert_frame_equal(port[meta], ref[meta], check_exact=True)
        data = port[CHANNELS].values.astype(np.float32)
        differ_som += assert_labels_equal_except_near_ties(
            port["pixel_som_cluster"], ref["pixel_som_cluster"], weights, data)
        # a meta label may differ only where the SOM label does
        som_same = (port["pixel_som_cluster"] == ref["pixel_som_cluster"]).values
        meta_same = (port["pixel_meta_cluster"] == ref["pixel_meta_cluster"]).values
        assert meta_same[som_same].all()
        differ_meta += int((~meta_same).sum())
    assert differ_meta <= differ_som
    print(f"labels differing at near-ties: som {differ_som}, meta {differ_meta}")


def test_pixel_consensus_without_sklearn_equals_jax(tmp_path):
    """pixel_consensus_cluster on one 100-row SOM-average CSV (the pixel
    SOM's) and its FOV feathers: the JAX package's (sklearn) mapping and
    meta labels equal the port's, run in a subprocess with sklearn and the
    other packages the card's machine lacks blocked."""
    import shutil

    from ark_tpu.phenotyping import pixel_meta_clustering as JPM
    from tests.test_torch_package import run_blocked

    rng = np.random.default_rng(91)
    base = tmp_path / "jax"
    (base / "pixel_mat_data").mkdir(parents=True)
    avg = pd.DataFrame(rng.gamma(0.8, 1.0, (100, len(CHANNELS))), columns=CHANNELS)
    avg["pixel_som_cluster"] = np.arange(1, 101)
    avg["count"] = rng.integers(100, 1000, 100)
    avg.to_csv(base / "pixel_channel_avg_som_cluster.csv", index=False)
    for fov in FOVS:
        pixels = pd.DataFrame(rng.random((400, len(CHANNELS))).astype(np.float32),
                              columns=CHANNELS)
        pixels["pixel_som_cluster"] = rng.integers(1, 101, 400)
        feather.write_dataframe(pixels, str(base / "pixel_mat_data" / f"{fov}.feather"))
    shutil.copytree(base, tmp_path / "port")
    cc = JPM.pixel_consensus_cluster(FOVS, CHANNELS, str(base), max_k=20)
    port = tmp_path / "port"
    run_blocked(
        "from ark_tpu_torch.phenotyping import pixel_meta_clustering as pm\n"
        f"cc = pm.pixel_consensus_cluster({FOVS!r}, {CHANNELS!r}, {str(port)!r}, max_k=20)\n"
        f"cc.mapping.to_csv({str(port / 'mapping.csv')!r}, index=False)\n")
    pd.testing.assert_frame_equal(pd.read_csv(port / "mapping.csv"),
                                  cc.mapping.reset_index(drop=True), check_exact=True)
    assert cc.mapping["pixel_meta_cluster"].nunique() == 20
    for fov in FOVS:
        pd.testing.assert_frame_equal(_read(str(port), f"pixel_mat_data/{fov}.feather"),
                                      _read(str(base), f"pixel_mat_data/{fov}.feather"),
                                      check_exact=True)
