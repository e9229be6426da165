"""The port's cohort data utilities (ark_tpu_torch.utils.data_utils) against
the JAX package's, on the CPU, on the same seeded inputs and files.

Everything here is integer work, table work or file IO, so every comparison
is exact: eroded masks, cluster masks (cell, pixel, neighborhood), mapped
statistics (f64 gather), stitched images, the cluster-id CSVs and the
``ClusterMaskData`` mapping. The AnnData stores are read back both ways: the
JAX package's ``AnnDataLite.read_h5ad`` reads the port's files and the
port's reads the JAX package's, with equal contents.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu import settings
from ark_tpu.io import feather_utils as feather
from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.utils import data_utils as JD
from ark_tpu.utils.labeled_array import DataArray as JDataArray
from ark_tpu_torch.utils import data_utils as TD
from ark_tpu_torch.utils.labeled_array import DataArray as TDataArray
from tests import test_utils

torch.set_num_threads(2)


def _labels(seed, shape=(96, 128), n_cells=60, radius=6):
    return test_utils.make_labels_image(np.random.default_rng(seed), shape=shape,
                                        n_cells=n_cells, radius=radius)


def _cell_data(fov_labels, n_types=4, drop_last=True, numeric=False):
    """A clustered cell table for {fov: labels}; the last cell of each FOV
    is left out (unassigned)."""
    rows = []
    for fov, lab in fov_labels.items():
        ids = np.unique(lab)[1:]
        for i in (ids[:-1] if drop_last else ids):
            kind = int(i) % n_types
            rows.append({"fov": fov, "label": int(i),
                         "cell_meta_cluster": kind + 1 if numeric else f"type{kind}",
                         "kmeans_neighborhood": kind + 1})
    return pd.DataFrame(rows)


def _same_tiffs(dir_a, dir_b):
    names = sorted(os.listdir(dir_a))
    assert names and names == sorted(os.listdir(dir_b))
    for name in names:
        a, b = read_image(os.path.join(dir_a, name)), read_image(os.path.join(dir_b, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


@pytest.mark.parametrize("kwargs", [{}, {"connectivity": 2}, {"mode": "inner"},
                                    {"connectivity": 2, "mode": "thick"},
                                    {"connectivity": 1, "mode": "outer"}])
@pytest.mark.parametrize("dtype", [np.int32, np.int16])
def test_erode_mask_equal(kwargs, dtype):
    lab = _labels(1).astype(dtype)
    want = JD.erode_mask(lab, **kwargs)
    got = TD.erode_mask(lab, device="cpu", **kwargs)
    assert got.dtype == want.dtype and (got != lab).any()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("numeric", [False, True])
def test_cluster_mask_data_mapping_equal(numeric):
    labs = {"fov1": _labels(2), "fov10": _labels(3), "fov2": _labels(4)}
    table = _cell_data(labs, numeric=numeric)
    want = JD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    got = TD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    pd.testing.assert_frame_equal(got.mapping, want.mapping)
    pd.testing.assert_frame_equal(got.cluster_name_id, want.cluster_name_id)
    assert got.unique_fovs == want.unique_fovs == ["fov1", "fov2", "fov10"]
    assert (got.unassigned_id, got.n_clusters, got.cluster_names) == \
        (want.unassigned_id, want.n_clusters, want.cluster_names)
    pd.testing.assert_frame_equal(got.fov_mapping("fov10"), want.fov_mapping("fov10"))


@pytest.mark.parametrize("shape", [(96, 128), (1024, 1024)])
def test_label_cells_by_cluster_equal(shape):
    """Exact on the host gather (small image) and on the gather that runs
    on the device (2^20 pixels)."""
    lab = _labels(5, shape=shape, n_cells=200, radius=9)
    table = _cell_data({"fov0": lab})
    want = JD.label_cells_by_cluster(
        "fov0", JD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster"), lab)
    cmd = TD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    got = TD.label_cells_by_cluster("fov0", cmd, lab, device="cpu")
    assert got.dtype == want.dtype == np.int16
    assert (got == cmd.unassigned_id).any() and len(np.unique(got)) == 6
    np.testing.assert_array_equal(got, want)
    as_array = TD.label_cells_by_cluster(
        "fov0", cmd, TDataArray(lab[None, :, :, None], coords={
            "fovs": ["fov0"], "rows": np.arange(shape[0]), "cols": np.arange(shape[1]),
            "compartments": ["whole_cell"]}), device="cpu")
    np.testing.assert_array_equal(as_array, want)


def test_label_cells_by_cluster_wraps_above_int16_like_jax():
    """33,000 clusters: ids above 32767 wrap in the int16 mask, as in the
    JAX package."""
    n = 33_000
    lab = np.arange(n + 1, dtype=np.int32).reshape(1, -1).repeat(2, axis=0)
    table = pd.DataFrame({"fov": "fov0", "label": np.arange(1, n + 1),
                          "cluster": np.arange(1, n + 1)})
    want = JD.label_cells_by_cluster(
        "fov0", JD.ClusterMaskData(table, "fov", "label", "cluster"), lab)
    got = TD.label_cells_by_cluster(
        "fov0", TD.ClusterMaskData(table, "fov", "label", "cluster"), lab, device="cpu")
    assert got.min() < 0
    np.testing.assert_array_equal(got, want)


def test_map_segmentation_labels_equal():
    lab = _labels(6)
    ids = np.unique(lab)[1:-2]
    values = np.random.default_rng(6).normal(size=len(ids)) * 1e3
    values[::7] = np.nan
    want = JD.map_segmentation_labels(ids, values, lab, unassigned_id=-2.5)
    got = TD.map_segmentation_labels(ids, values, lab, unassigned_id=-2.5, device="cpu")
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    assert TD.relabel_segmentation is not None


@pytest.fixture
def cohort(tmp_path):
    fovs = ["fov0", "fov1"]
    data = test_utils.create_image_cohort(str(tmp_path / "imgs"), fovs, ["chan0"],
                                          shape=(64, 80), n_cells=30)
    test_utils.save_label_dir(str(tmp_path / "segs"), data)
    return fovs, tmp_path, {f: data[f][0] for f in fovs}


@pytest.mark.parametrize("erode", [True, False])
def test_generate_cluster_mask_equal(cohort, erode):
    fovs, base, labs = cohort
    table = _cell_data(labs)
    want = JD.generate_cluster_mask(
        "fov1", str(base / "segs"),
        JD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster"), erode=erode)
    cmd = TD.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    got = TD.generate_cluster_mask("fov1", str(base / "segs"), cmd, erode=erode,
                                   device="cpu")
    np.testing.assert_array_equal(got, want)
    core = TD.cluster_mask_from_labels("fov1", labs["fov1"], cmd, erode, device="cpu")
    np.testing.assert_array_equal(core, want)


def test_generate_and_save_cell_cluster_masks_equal(cohort):
    fovs, base, labs = cohort
    table = _cell_data(labs)
    for side, mod, kw in (("jax", JD, {}), ("torch", TD, {"device": "cpu"})):
        (base / side).mkdir()
        csv = base / f"{side}_ids.csv"
        pd.DataFrame({"cell_meta_cluster": [f"type{i}" for i in range(4)],
                      "cell_meta_cluster_rename": list("abcd"),
                      "cluster_id": [9, 9, 9, 9]}).to_csv(csv, index=False)
        mod.generate_and_save_cell_cluster_masks(
            fovs, str(base / side), str(base / "segs"), table, str(csv),
            name_suffix="_cell_mask", **kw)
    _same_tiffs(base / "jax", base / "torch")
    pd.testing.assert_frame_equal(pd.read_csv(base / "torch_ids.csv"),
                                  pd.read_csv(base / "jax_ids.csv"))


def _pixel_feather(base, fov, shape, seed=9, share=0.8):
    """A FOV's pixel table: `share` of its pixels, each once, in random
    order, with a meta cluster in 1..5."""
    rng = np.random.default_rng(seed)
    flat = rng.permutation(shape[0] * shape[1])[:int(share * shape[0] * shape[1])]
    df = pd.DataFrame({"row_index": flat // shape[1], "column_index": flat % shape[1],
                       "pixel_meta_cluster": rng.integers(1, 6, len(flat)),
                       "pixel_som_cluster": rng.integers(1, 30, len(flat))})
    os.makedirs(base / "pixel_mat_data", exist_ok=True)
    feather.write_dataframe(df, base / "pixel_mat_data" / f"{fov}.feather")
    return df


def test_generate_pixel_cluster_mask_equal(cohort):
    fovs, base, labs = cohort
    shape = labs["fov0"].shape
    df = _pixel_feather(base, "fov0", shape)
    mapping = pd.DataFrame({"pixel_meta_cluster": [1, 2, 3, 4, 5],
                            "cluster_id": [3, 1, 4, 2, 5]})
    args = ("fov0", str(base), str(base / "imgs"), os.path.join("fov0", "chan0.tiff"),
            "pixel_mat_data", mapping)
    want = JD.generate_pixel_cluster_mask(*args)
    got = TD.generate_pixel_cluster_mask(*args, device="cpu")
    assert got.dtype == want.dtype == np.int16 and got.shape == shape
    assert (got == 0).any() and set(np.unique(got)) == {0, 1, 2, 3, 4, 5}
    np.testing.assert_array_equal(got, want)
    core = TD.scatter_pixel_clusters(
        shape, df["row_index"].values * shape[1] + df["column_index"].values,
        df["pixel_meta_cluster"].map(dict(zip(mapping["pixel_meta_cluster"],
                                              mapping["cluster_id"]))).values,
        device="cpu")
    np.testing.assert_array_equal(core, want)


def test_generate_and_save_pixel_cluster_masks_equal(cohort):
    fovs, base, labs = cohort
    for i, fov in enumerate(fovs):
        _pixel_feather(base, fov, labs[fov].shape, seed=20 + i)
    for side, mod, kw in (("jax", JD, {}), ("torch", TD, {"device": "cpu"})):
        (base / side).mkdir()
        csv = base / f"{side}_ids.csv"
        pd.DataFrame({"pixel_som_cluster": np.arange(1, 11),
                      "pixel_meta_cluster": [5, 4, 3, 2, 1, 1, 2, 3, 4, 5],
                      "pixel_meta_cluster_rename": list("edcbaabcde")}
                     ).to_csv(csv, index=False)
        mod.generate_and_save_pixel_cluster_masks(
            fovs, str(base), str(base / side), str(base / "imgs"), "chan0.tiff",
            "pixel_mat_data", str(csv), name_suffix="_pixel_mask", **kw)
    _same_tiffs(base / "jax", base / "torch")
    pd.testing.assert_frame_equal(pd.read_csv(base / "torch_ids.csv"),
                                  pd.read_csv(base / "jax_ids.csv"))


def test_generate_and_save_neighborhood_cluster_masks_equal(cohort):
    fovs, base, labs = cohort
    table = _cell_data(labs, drop_last=False)
    for side, mod, kw in (("jax", JD, {}), ("torch", TD, {"device": "cpu"})):
        (base / side).mkdir()
        mod.generate_and_save_neighborhood_cluster_masks(
            fovs, str(base / side), str(base / "segs"), table,
            name_suffix="_neighborhood_mask", **kw)
    _same_tiffs(base / "jax", base / "torch")


@pytest.mark.parametrize("n_fovs,num_cols", [(4, 2), (5, 3), (1, 1)])
def test_stitch_images_equal(n_fovs, num_cols):
    rng = np.random.default_rng(n_fovs)
    vals = rng.integers(0, 1000, (n_fovs, 12, 10, 2)).astype(np.uint16)
    coords = {"fovs": [f"f{i}" for i in range(n_fovs)], "rows": np.arange(12),
              "cols": np.arange(10), "channels": ["a", "b"]}
    want = JD.stitch_images(JDataArray(vals, coords=coords), num_cols)
    got = TD.stitch_images(TDataArray(vals, coords=coords), num_cols)
    assert got.values.dtype == want.values.dtype and got.dims == want.dims
    np.testing.assert_array_equal(got.values, want.values)
    assert list(got.coords["channels"]) == list(want.coords["channels"])


@pytest.mark.parametrize("mode", ["channels", "segmentation", "clustering"])
def test_stitch_images_by_shape_equal(tmp_path, mode):
    fovs = ["run_R1C1", "run_R1C2", "run_R2C2"]              # R2C1 is missing
    data = test_utils.create_image_cohort(str(tmp_path / "imgs"), fovs,
                                          ["chan0", "chan1"], shape=(16, 20), n_cells=5)
    if mode == "channels":
        src, kw = tmp_path / "imgs", {}
    else:
        src = tmp_path / "masks"
        suffix = "_whole_cell" if mode == "segmentation" else "_cell_mask"
        test_utils.save_label_dir(str(src), data, suffix=suffix)
        kw = {"segmentation": True} if mode == "segmentation" else {"clustering": "cell"}
    JD.stitch_images_by_shape(str(src), str(tmp_path / "jax"), **kw)
    TD.stitch_images_by_shape(str(src), str(tmp_path / "torch"), **kw)
    _same_tiffs(tmp_path / "jax" / "run", tmp_path / "torch" / "run")
    with pytest.raises(ValueError, match="already exists"):
        TD.stitch_images_by_shape(str(src), str(tmp_path / "torch"), **kw)


def test_stitch_images_by_shape_rejects_bad_names_like_jax(tmp_path):
    test_utils.create_image_cohort(str(tmp_path / "imgs"), ["R1C1_extra"], ["chan0"],
                                   shape=(16, 16), n_cells=2)
    for mod in (JD, TD):
        with pytest.raises(ValueError, match="RnCm"):
            mod.stitch_images_by_shape(str(tmp_path / "imgs"), str(tmp_path / "out"))
    with pytest.raises(ValueError, match="clustering arg"):
        TD.stitch_images_by_shape(str(tmp_path / "imgs"), str(tmp_path / "out"),
                                  clustering="fiber")


def test_split_img_stack_equal(tmp_path):
    rng = np.random.default_rng(3)
    (tmp_path / "stacks").mkdir()
    save_image(str(tmp_path / "stacks" / "s0.tiff"),
               rng.random((3, 16, 12)).astype(np.float32))
    for side, mod in (("jax", JD), ("torch", TD)):
        (tmp_path / side).mkdir()
        mod.split_img_stack(str(tmp_path / "stacks"), str(tmp_path / side), ["s0.tiff"],
                            [0, 2], ["a.tiff", "c.tiff"])
    _same_tiffs(tmp_path / "jax" / "s0", tmp_path / "torch" / "s0")


def _cell_table_csv(tmp_path):
    ct = test_utils.make_cell_table(n_cells=80, fovs=["fov0", "fov1", "fov10"])
    cols = ([settings.CELL_SIZE] + [c for c in ct.columns if c.startswith("marker")]
            + [settings.CELL_LABEL, settings.FOV_ID, settings.PATIENT_ID,
               settings.CELL_TYPE, settings.CENTROID_0, settings.CENTROID_1])
    path = tmp_path / "cell_table.csv"
    ct[cols].to_csv(path, index=False)
    return str(path)


def _same_adata(a, b):
    np.testing.assert_array_equal(a.X, b.X)
    assert a.X.dtype == b.X.dtype and a.var_names == b.var_names and a.n_obs == b.n_obs
    pd.testing.assert_frame_equal(a.obs, b.obs)
    assert sorted(a.obsm) == sorted(b.obsm) == ["spatial"]
    np.testing.assert_array_equal(a.obsm["spatial"], b.obsm["spatial"])


@pytest.mark.parametrize("extra", [None, [settings.CELL_TYPE]])
def test_h5ad_round_trip_both_ways(tmp_path, extra):
    """The port's stores read by the JAX package's reader, the JAX
    package's by the port's, and each by its own: the same contents."""
    path = _cell_table_csv(tmp_path)
    jconv = JD.ConvertToAnnData(path, extra_obs_parameters=extra)
    tconv = TD.ConvertToAnnData(path, extra_obs_parameters=extra)
    assert tconv.obs_names == jconv.obs_names and tconv.var_names == jconv.var_names
    jres = jconv.convert_to_adata(str(tmp_path / "jax"))
    tres = tconv.convert_to_adata(str(tmp_path / "torch"))
    assert sorted(tres) == sorted(jres) == ["fov0", "fov1", "fov10"]
    ours, theirs = TD.load_anndatas(str(tmp_path / "torch")), \
        JD.load_anndatas(str(tmp_path / "jax"))
    assert list(ours) == list(theirs) == ["fov0", "fov1", "fov10"]
    for fov in ours:
        _same_adata(ours[fov], theirs[fov])
        _same_adata(JD.AnnDataLite.read_h5ad(tres[fov]), theirs[fov])
        _same_adata(TD.AnnDataLite.read_h5ad(jres[fov]), theirs[fov])
        assert ours[fov].obs.index[0].startswith(f"{fov}_")


def test_h5ad_layout_equals_the_jax_packages(tmp_path):
    """Group names, element encodings and dataset dtypes of the two files."""
    import h5py

    path = _cell_table_csv(tmp_path)
    jres = JD.ConvertToAnnData(path).convert_to_adata(str(tmp_path / "jax"))
    tres = TD.ConvertToAnnData(path).convert_to_adata(str(tmp_path / "torch"))

    def layout(file):
        out = {}
        with h5py.File(file, "r") as f:
            out["/"] = dict(f.attrs)

            def visit(name, node):
                attrs = {k: (v.tolist() if isinstance(v, np.ndarray) else v)
                         for k, v in node.attrs.items()}
                out[name] = (attrs, getattr(node, "dtype", None),
                             getattr(node, "shape", None))
            f.visititems(visit)
        return out

    assert layout(tres["fov0"]) == layout(jres["fov0"])


def test_save_fov_mask_equal(tmp_path):
    mask = _labels(8).astype(np.int16)
    for side, mod in (("jax", JD), ("torch", TD)):
        (tmp_path / side).mkdir()
        mod.save_fov_mask("fov0", str(tmp_path / side), mask, sub_dir="sub",
                          name_suffix="_m")
    _same_tiffs(tmp_path / "jax" / "sub", tmp_path / "torch" / "sub")
