"""The port's copy of the host IO layer against the JAX package's, on the CPU.

Files written by one package are read back equal by the other: feathers
(pandas and arrow paths), TIFFs of every dtype the pipelines write, and the
cohort loaders' arrays and coordinates. Everything here is exact.
"""

import os

import numpy as np
import pandas as pd
import pytest

from ark_tpu.io import feather_utils as JF
from ark_tpu.io import image_utils as JI
from ark_tpu.io import io_utils as JIO
from ark_tpu.io import load_utils as JL
from ark_tpu.utils.labeled_array import DataArray as JDataArray
from ark_tpu_torch import settings as TS
from ark_tpu_torch.io import feather_utils as TF
from ark_tpu_torch.io import image_utils as TI
from ark_tpu_torch.io import io_utils as TIO
from ark_tpu_torch.io import load_utils as TL
from ark_tpu_torch.utils.labeled_array import DataArray

PACKAGES = {"jax": (JF, JI, JL), "port": (TF, TI, TL)}
DIRECTIONS = [("jax", "port"), ("port", "jax")]


def _frame(rng):
    return pd.DataFrame({"fov": ["fov1", "fov10", "fov2"] * 4,
                         "label": np.arange(12, dtype=np.int32),
                         "chan0": rng.random(12).astype(np.float32),
                         "chan1": rng.random(12),
                         "pixel_som_cluster": rng.integers(1, 101, 12)})


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_feather_round_trip(tmp_path, writer, reader):
    df = _frame(np.random.default_rng(0))
    wf, rf = PACKAGES[writer][0], PACKAGES[reader][0]
    wf.write_dataframe(df, tmp_path / "a.feather")
    pd.testing.assert_frame_equal(rf.read_dataframe(tmp_path / "a.feather"), df)
    pd.testing.assert_frame_equal(
        rf.read_dataframe(tmp_path / "a.feather", columns=["label", "chan1"]),
        df[["label", "chan1"]])
    assert rf.read_column_names(tmp_path / "a.feather") == list(df.columns)
    table = wf.table_set_columns(wf.read_table(tmp_path / "a.feather"),
                                 {"chan0": df["chan0"] * 2, "new": df["label"] + 1})
    wf.write_table(table, tmp_path / "b.feather")
    want = df.assign(chan0=df["chan0"] * 2, new=df["label"] + 1)
    pd.testing.assert_frame_equal(rf.read_dataframe(tmp_path / "b.feather"), want)


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.int32, np.int64,
                                   np.uint16, np.uint8, bool])
def test_tiff_round_trip(tmp_path, writer, reader, dtype):
    rng = np.random.default_rng(1)
    data = (rng.random((17, 23)) * 1000).astype(dtype)
    path = str(tmp_path / "sub" / "img.tiff")
    PACKAGES[writer][1].save_image(path, data)
    got = PACKAGES[reader][1].read_image(path)
    want = PACKAGES["jax"][1].read_image(path)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data.astype(want.dtype))


def _assert_same_array(got, want):
    assert isinstance(got, DataArray) and isinstance(want, JDataArray)
    assert got.dims == want.dims and got.dtype == want.dtype
    for d in want.dims:
        np.testing.assert_array_equal(got.coords[d], want.coords[d])
    np.testing.assert_array_equal(got.values, want.values)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cohort_loaders_match(tmp_path, writer):
    """A TIFF tree and a directory of masks written by either package load
    equal through both packages' loaders (ragged FOVs zero-padded)."""
    rng = np.random.default_rng(2)
    save = PACKAGES[writer][1].save_image
    for i, fov in enumerate(("fov2", "fov10", "fov1")):
        h = 20 + 4 * i
        for chan in ("CD3", "CD8", "dsDNA"):
            save(os.path.join(tmp_path, "tree", fov, "TIFs", f"{chan}.tiff"),
                 rng.random((h, 24)).astype(np.float32))
        save(os.path.join(tmp_path, "masks", f"{fov}_whole_cell.tiff"),
             rng.integers(0, 9, (32, 24)).astype(np.int32))
    tree = os.path.join(tmp_path, "tree")
    for kw in ({}, {"fovs": ["fov1", "fov10"], "channels": ["dsDNA", "CD3"]},
               {"dtype": np.int32}):
        _assert_same_array(TL.load_imgs_from_tree(tree, img_sub_folder="TIFs", **kw),
                           JL.load_imgs_from_tree(tree, img_sub_folder="TIFs", **kw))
    masks = os.path.join(tmp_path, "masks")
    kw = dict(trim_suffix="_whole_cell", xr_channel_names=["whole_cell"])
    _assert_same_array(TL.load_imgs_from_dir(masks, **kw),
                       JL.load_imgs_from_dir(masks, **kw))
    assert TIO.list_folders(tree) == JIO.list_folders(tree) == ["fov1", "fov2", "fov10"]
    files = TIO.list_files(masks, substrs=".tiff")
    assert files == JIO.list_files(masks, substrs=".tiff")
    assert TIO.remove_file_extensions(files) == JIO.remove_file_extensions(files)


def test_mibitiff_loader_matches(tmp_path):
    rng = np.random.default_rng(3)
    for fov in ("a", "b"):
        path = str(tmp_path / f"{fov}.tiff")
        JI.save_image(path, rng.random((3, 16, 16)).astype(np.float32))
        with open(path + ".channels.txt", "w") as f:
            f.write("\n".join(["CD3", "CD8", "dsDNA"]))
    for kw in ({}, {"channels": ["dsDNA", "CD3"]}):
        _assert_same_array(TL.load_imgs_from_mibitiff(str(tmp_path), **kw),
                           JL.load_imgs_from_mibitiff(str(tmp_path), **kw))


def test_labeled_array_selection_matches():
    rng = np.random.default_rng(4)
    values = rng.random((2, 5, 6, 3))
    coords = {"fovs": ["f0", "f1"], "rows": np.arange(5), "cols": np.arange(6),
              "channels": ["a", "b", "c"]}
    t, j = DataArray(values.copy(), coords=coords), JDataArray(values.copy(), coords=coords)
    for sel in ({"fovs": "f1"}, {"channels": ["c", "a"]},
                {"fovs": "f0", "channels": "b"}):
        _assert_same_array(t.sel(**sel), j.sel(**sel))
    _assert_same_array(t.isel(rows=[4, 0], cols=2), j.isel(rows=[4, 0], cols=2))
    _assert_same_array(t.loc["f1", :, :, ["b"]], j.loc["f1", :, :, ["b"]])
    t.loc[["f0", "f1"], :, :, ["a", "c"]] = -1.0
    j.loc[["f0", "f1"], :, :, ["a", "c"]] = -1.0
    _assert_same_array(t, j)
    with pytest.raises(KeyError):
        t.sel(fovs="missing")


def test_settings_match():
    from ark_tpu import settings as JS

    names = [n for n in dir(TS) if n.isupper()]
    assert names and all(getattr(TS, n) == getattr(JS, n) for n in names)


def test_io_misc_utils_names_match_jax():
    """The JAX package's io.misc_utils names exist under the same path; the
    argument checks are the port's one copy in utils.misc_utils."""
    from ark_tpu.io import misc_utils as JM
    from ark_tpu_torch.io import misc_utils as TM
    from ark_tpu_torch.utils import misc_utils as TU

    assert TM.verify_in_list is TU.verify_in_list
    assert TM.verify_same_elements is TU.verify_same_elements
    assert TM.make_iterable is TU.make_iterable
    for data in (range(3), [f"fov{i}" for i in range(25)], []):
        assert TM.create_invalid_data_str(data) == JM.create_invalid_data_str(data)


def test_settings_hold_every_jax_constant():
    """Every constant of the JAX package's settings but the example
    dataset's revision (its downloader is not ported), equal in value."""
    from ark_tpu import settings as JS

    want = {n for n in dir(JS) if n.isupper()} - {"EXAMPLE_DATASET_REVISION"}
    assert {n for n in dir(TS) if n.isupper()} == want
    assert TS.REGION_PARAM_FIELDS == JS.REGION_PARAM_FIELDS and TS.EDA_KEYS == JS.EDA_KEYS
    assert TS.STAGE_TO_PIXEL_Y_MULTIPLIER == JS.STAGE_TO_PIXEL_Y_MULTIPLIER == 1 / -0.06926


ARRAYS = {"jax": JDataArray, "port": DataArray}


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("layout", ["netcdf", "h5"])
def test_dist_matrix_round_trip(tmp_path, writer, reader, layout):
    """A `<fov>_dist_mat.xr` written by one package's DataArray reads equal
    through the other's `from_file` (netCDF-3, the reference's format) and
    `from_h5` (the legacy HDF5 layout); string coords too."""
    rng = np.random.default_rng(5)
    d = rng.random((6, 6)).astype(np.float32)
    np.fill_diagonal(d, 0.0)
    for coords in ({"dim_0": np.arange(1, 7), "dim_1": np.arange(1, 7)},
                   {"dim_0": [f"αSMA{i}" for i in range(6)], "dim_1": np.arange(6)}):
        path = str(tmp_path / f"fov1_dist_mat_{layout}.xr")
        arr = ARRAYS[writer](d, coords=coords)
        (arr.to_netcdf if layout == "netcdf" else arr.to_h5)(path)
        got = ARRAYS[reader].from_file(path)
        want = JDataArray.from_file(path)
        assert got.dims == want.dims == ("dim_0", "dim_1")
        np.testing.assert_array_equal(got.values, d)
        for dim in got.dims:
            np.testing.assert_array_equal(got.coords[dim], want.coords[dim])
            assert [str(v) for v in got.coords[dim]] == [str(v) for v in coords[dim]]
        assert ARRAYS[reader].from_h5(path).equals(got)
