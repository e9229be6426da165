"""The port's plotting utilities and post-clustering tools
(ark_tpu_torch.utils.plot_utils, ark_tpu_torch.phenotyping.post_cluster_utils)
against the JAX package's, on the CPU, on the same seeded files.

Exact comparisons throughout: the overlay is a uint8 image whose rescale
divides in f64 and truncates (one ulp would move a byte), coloured masks are
uint8 gathers of a colour table, cluster masks are integers, and the Mantis
project's CSVs are text. Figures are only checked to be drawn.
"""

import os

import matplotlib
matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.phenotyping import post_cluster_utils as JPC
from ark_tpu.utils import plot_utils as JP
from ark_tpu.utils.labeled_array import DataArray as JDataArray
from ark_tpu_torch.phenotyping import post_cluster_utils as TPC
from ark_tpu_torch.utils import plot_utils as TP
from ark_tpu_torch.utils.labeled_array import DataArray as TDataArray
from tests import test_utils

torch.set_num_threads(2)

OVERLAY_CHANS = ["nuclear_channel", "membrane_channel"]


def _same_tree(dir_a, dir_b, image_exts=(".tiff",)):
    """The same file names under both directories; images equal as arrays,
    CSVs as text."""
    def walk(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, files in os.walk(root) for f in files)

    names = walk(dir_a)
    assert names and names == walk(dir_b)
    for name in names:
        a, b = os.path.join(dir_a, name), os.path.join(dir_b, name)
        if name.endswith(image_exts):
            ia, ib = read_image(a), read_image(b)
            assert ia.dtype == ib.dtype, name
            np.testing.assert_array_equal(ia, ib, err_msg=name)
        elif name.endswith(".csv"):
            with open(a) as fa, open(b) as fb:
                assert fa.read() == fb.read(), name


@pytest.fixture
def cohort(tmp_path):
    fovs = ["fov1", "fov2", "fov10"]
    data = test_utils.create_image_cohort(str(tmp_path / "imgs"), fovs,
                                          ["chan0", "chan1"], shape=(64, 72), n_cells=25)
    test_utils.save_label_dir(str(tmp_path / "segs"), data)
    rows = [{"fov": fov, "label": int(lab), "cell_meta_cluster": f"ct{lab % 3}",
             "area": float(lab) * 2.5}
            for fov in fovs for lab in np.unique(data[fov][0])[1:-1]]
    return fovs, tmp_path, pd.DataFrame(rows), data


def _overlay_files(base, data, fov, dtype, channels_first):
    """A deepcell-input style two-channel file and a nuclear mask for `fov`;
    returns the alternate segmentation used by one case."""
    labels, imgs = data[fov]
    rng = np.random.default_rng(5)
    stack = (imgs * rng.gamma(2.0, 40.0, imgs.shape)).astype(np.float32)
    stack[rng.random(stack.shape) < 0.2] = 0
    stack = stack.astype(dtype)
    os.makedirs(base / "dc_input", exist_ok=True)
    save_image(str(base / "dc_input" / f"{fov}.tiff"),
               np.moveaxis(stack, -1, 0) if channels_first else stack)
    nuc = test_utils.make_labels_image(rng, shape=labels.shape, n_cells=20, radius=3)
    save_image(str(base / "segs" / f"{fov}_nuclear.tiff"), nuc.astype(np.int32))
    return np.roll(labels, 3, axis=1)


@pytest.mark.parametrize("dtype,channels_first,chans,comp,alternate", [
    (np.float32, False, OVERLAY_CHANS, "whole_cell", False),
    (np.float32, True, OVERLAY_CHANS, "nuclear", True),
    (np.uint16, True, OVERLAY_CHANS[::-1], "whole_cell", True),
    (np.float64, False, OVERLAY_CHANS[:1], "whole_cell", False),
    (np.int32, False, OVERLAY_CHANS[1:], "nuclear", False),
])
def test_create_overlay_bytes_equal(cohort, dtype, channels_first, chans, comp, alternate):
    fovs, base, _, data = cohort
    alt = _overlay_files(base, data, "fov2", dtype, channels_first)
    args = ("fov2", str(base / "segs"), str(base / "dc_input"), chans, comp,
            alt if alternate else None)
    want = JP.create_overlay(*args)
    got = TP.create_overlay(*args, device="cpu")
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert want.max() == 255 and len(np.unique(want)) > 50
    np.testing.assert_array_equal(got, want)
    if alternate:
        red = (want[..., 0] == 255) & (want[..., 1] == 0) & (want[..., 2] == 0)
        assert red.any()


def test_overlay_from_arrays_equals_the_file_function(cohort):
    fovs, base, _, data = cohort
    _overlay_files(base, data, "fov1", np.float32, False)
    want = JP.create_overlay("fov1", str(base / "segs"), str(base / "dc_input"),
                             OVERLAY_CHANS, "whole_cell")
    vals = read_image(str(base / "dc_input" / "fov1.tiff"))
    got = TP.overlay_from_arrays(vals, data["fov1"][0], device="cpu")
    np.testing.assert_array_equal(got, want)
    empty = np.zeros_like(vals)                       # no signal: only the borders
    out = TP.overlay_from_arrays(empty, data["fov1"][0], device="cpu")
    assert set(np.unique(out)) == {0, 255}
    with pytest.raises(ValueError, match="dimensions not equal"):
        TP.overlay_from_arrays(vals, data["fov1"][0], data["fov1"][0][:-1], device="cpu")


def test_tif_overlay_preprocess_equal():
    rng = np.random.default_rng(0)
    labels = np.zeros((8, 9), np.int32)
    for shape in ((8, 9), (8, 9, 1), (8, 9, 2), (8, 9, 3)):
        x = rng.random(shape).astype(np.float32)
        np.testing.assert_array_equal(TP.tif_overlay_preprocess(labels, x),
                                      JP.tif_overlay_preprocess(labels, x))
    for bad in (rng.random((8, 9, 4)), rng.random((7, 9)), rng.random((2, 8, 9, 1))):
        with pytest.raises(ValueError):
            TP.tif_overlay_preprocess(labels, bad)


@pytest.fixture
def remap_csv(tmp_path):
    df = pd.DataFrame({"pixel_som_cluster": [1, 2, 3, 4], "pixel_meta_cluster": [1, 1, 2, 3],
                       "pixel_meta_cluster_rename": ["immune", "immune", "tumor", "stroma"],
                       "cluster_id": [1, 1, 2, 3]})
    path = tmp_path / "remap.csv"
    df.to_csv(path, index=False)
    colors = {1: (1.0, 0.0, 0.0, 1.0), 2: (0.0, 0.5, 0.0, 1.0), 3: (0.1, 0.2, 1.0, 1.0)}
    return str(path), colors


def test_metacluster_colormap_equal(remap_csv):
    path, colors = remap_csv
    want = JP.MetaclusterColormap("pixel", path, dict(colors))
    got = TP.MetaclusterColormap("pixel", path, dict(colors))
    np.testing.assert_array_equal(got.mc_colors, want.mc_colors)
    pd.testing.assert_frame_equal(got.metacluster_id_to_name, want.metacluster_id_to_name)
    assert got.unassigned_id == want.unassigned_id == 4
    ids = np.arange(5)
    np.testing.assert_array_equal(got.cmap(got.norm(ids)), want.cmap(want.norm(ids)))
    bad = dict(colors)
    bad.pop(3)
    with pytest.raises(ValueError):
        TP.MetaclusterColormap("pixel", path, bad)


@pytest.mark.parametrize("cmap", ["viridis", ["red", "green", "blue", "#101010"],
                                  np.linspace(0, 1, 16).reshape(4, 4)])
def test_create_cmap_equal(cmap):
    got_map, got_norm = TP.create_cmap(cmap, 4)
    want_map, want_norm = JP.create_cmap(cmap, 4)
    ids = np.arange(6)
    assert got_map.N == want_map.N == 6
    np.testing.assert_array_equal(got_map(got_norm(ids)), want_map(want_norm(ids)))
    with pytest.raises(ValueError):      # a wrong type, or too few colours
        TP.create_cmap(3.5 if isinstance(cmap, str) else cmap[:2], 4)


def test_set_minimum_color_for_colormap_equal():
    from matplotlib import colormaps

    got = TP.set_minimum_color_for_colormap(colormaps["magma"], (0, 0, 1, 1))
    want = JP.set_minimum_color_for_colormap(colormaps["magma"], (0, 0, 1, 1))
    np.testing.assert_array_equal(got(np.arange(got.N)), want(np.arange(want.N)))


@pytest.mark.parametrize("kind", ["cluster_ids", "statistic"])
def test_save_colored_mask_bytes_equal(tmp_path, kind):
    """The id-by-id colour table gathered over the mask gives matplotlib's
    own rendering of the whole image; a continuous image goes to matplotlib."""
    from matplotlib import colormaps, colors

    rng = np.random.default_rng(2)
    if kind == "cluster_ids":
        data = rng.integers(0, 7, (40, 50)).astype(np.int16)
        cmap, norm = JP.create_cmap("tab20", 5)
    else:
        data = rng.gamma(2.0, 3.0, (40, 50))
        data[rng.random(data.shape) < 0.3] = 0.0
        cmap, norm = colormaps["viridis"], colors.Normalize(vmin=0.0, vmax=data.max())
    JP.save_colored_mask("f", str(tmp_path / "jax"), ".tiff", data, cmap, norm)
    TP.save_colored_mask("f", str(tmp_path / "torch"), ".tiff", data, cmap, norm,
                         device="cpu")
    _same_tree(tmp_path / "jax", tmp_path / "torch")
    out = read_image(str(tmp_path / "torch" / "f.tiff"))
    assert out.dtype == np.uint8 and out.shape == (40, 50, 4)


def test_save_colored_masks_bytes_equal(tmp_path, remap_csv):
    path, colors = remap_csv
    rng = np.random.default_rng(3)
    (tmp_path / "masks").mkdir()
    fovs = ["fov0", "fov1"]
    for fov in fovs:
        save_image(str(tmp_path / "masks" / f"{fov}_pixel_mask.tiff"),
                   rng.integers(0, 5, (30, 34)).astype(np.int16))
    JP.save_colored_masks(fovs, str(tmp_path / "masks"), str(tmp_path / "jax"), path,
                          dict(colors), "pixel")
    TP.save_colored_masks(fovs, str(tmp_path / "masks"), str(tmp_path / "torch"), path,
                          dict(colors), "pixel", device="cpu")
    _same_tree(tmp_path / "jax", tmp_path / "torch")
    table = (TP.MetaclusterColormap("pixel", path, dict(colors)).mc_colors * 255.999
             ).astype(np.uint8)
    mask = read_image(str(tmp_path / "masks" / "fov0_pixel_mask.tiff"))
    np.testing.assert_array_equal(TP.gather_colors(mask, table, device="cpu"), table[mask])


@pytest.mark.parametrize("erode,cmap", [(False, "tab20"), (True, "frame")])
def test_cohort_cluster_plot_masks_equal(cohort, erode, cmap):
    fovs, base, cell_data, _ = cohort
    if cmap == "frame":
        cmap = pd.DataFrame({"cell_meta_cluster": ["ct0", "ct1", "ct2"],
                             "color": ["red", "#00ff00", "navy"]})
    JP.cohort_cluster_plot(fovs, str(base / "segs"), str(base / "jax"), cell_data,
                           cmap=cmap, erode=erode, dpi=40)
    TP.cohort_cluster_plot(fovs, str(base / "segs"), str(base / "torch"), cell_data,
                           cmap=cmap, erode=erode, dpi=40, device="cpu")
    for sub in ("cluster_masks", "cluster_masks_colored"):
        _same_tree(base / "jax" / sub, base / "torch" / sub)
    assert sorted(os.listdir(base / "torch" / "cluster_plots")) == \
        sorted(f"{f}.png" for f in fovs)
    plt.close("all")


@pytest.mark.parametrize("erode,reverse", [(False, False), (True, True)])
def test_color_segmentation_by_stat_masks_equal(cohort, erode, reverse):
    fovs, base, cell_data, _ = cohort
    kw = dict(stat_name="area", erode=erode, reverse=reverse, dpi=40)
    JP.color_segmentation_by_stat(fovs[:2], cell_data, str(base / "segs"),
                                  str(base / "jax"), **kw)
    TP.color_segmentation_by_stat(fovs[:2], cell_data, str(base / "segs"),
                                  str(base / "torch"), device="cpu", **kw)
    _same_tree(base / "jax" / "colored", base / "torch" / "colored")
    assert sorted(os.listdir(base / "torch" / "continuous_plots")) == ["fov1.png", "fov2.png"]
    plt.close("all")


def _mantis_masks(base, fovs, extra=()):
    os.makedirs(base / "masks", exist_ok=True)
    rng = np.random.default_rng(4)
    for fov in list(fovs) + list(extra):
        save_image(str(base / "masks" / f"{fov}_cell_mask.tiff"),
                   rng.integers(0, 3, (64, 72)).astype(np.int16))


@pytest.mark.parametrize("mapping_as", ["frame", "path"])
def test_create_mantis_dir_equal(cohort, mapping_as):
    """Files, masks and CSVs of the two projects; fov1 is paired with its
    own mask though fov10's name starts with it."""
    fovs, base, _, _ = cohort
    _mantis_masks(base, fovs)
    mapping = pd.DataFrame({"cluster_id": [2, 1, 1], "cell_som_cluster": [1, 2, 3],
                            "cell_meta_cluster_rename": ["b", "a", "a"]})
    if mapping_as == "path":
        mapping.to_csv(base / "mapping.csv", index=False)
        mapping = str(base / "mapping.csv")
    for side, mod in (("jax", JP), ("torch", TP)):
        mod.create_mantis_dir(
            fovs=["fov10", "fov1"], mantis_project_path=str(base / side),
            img_data_path=str(base / "imgs"), mask_output_dir=str(base / "masks"),
            mapping=mapping, seg_dir=str(base / "segs"), cluster_type="cell",
            mask_suffix="_cell_mask", new_mask_suffix="_renamed")
    _same_tree(base / "jax", base / "torch")
    assert sorted(os.listdir(base / "torch")) == ["fov1", "fov10"]
    assert (base / "torch" / "fov1" / "population_renamed.csv").exists()
    with pytest.raises(ValueError, match="Mapping must"):
        TP.create_mantis_dir(["fov1"], str(base / "x"), str(base / "imgs"),
                             str(base / "masks"), 3, str(base / "segs"))


def test_create_mantis_project_and_new_resolution_equal(cohort):
    fovs, base, cell_data, _ = cohort
    for side, mod, kw in (("jax", JPC, {}), ("torch", TPC, {"device": "cpu"})):
        mod.create_mantis_project(
            cell_table=cell_data, fovs=fovs, seg_dir=str(base / "segs"),
            mask_dir=str(base / f"{side}_masks"), image_dir=str(base / "imgs"),
            mantis_dir=str(base / f"{side}_mantis"), **kw)
        mod.generate_new_cluster_resolution(
            cell_data.copy(), "cell_meta_cluster", "broad", {"x": ["ct0", "ct2"],
                                                             "y": ["ct1"]},
            str(base / f"{side}_broad.csv"))
    _same_tree(base / "jax_masks", base / "torch_masks")
    _same_tree(base / "jax_mantis", base / "torch_mantis")
    with open(base / "jax_broad.csv") as a, open(base / "torch_broad.csv") as b:
        assert a.read() == b.read()
    with pytest.raises(ValueError, match="already exists"):
        TPC.generate_new_cluster_resolution(cell_data.copy(), "cell_meta_cluster", "area",
                                            {"x": ["ct0"]}, str(base / "z.csv"))
    with pytest.raises(ValueError, match="specify a list"):
        TPC.generate_new_cluster_resolution(cell_data.copy(), "cell_meta_cluster", "b",
                                            {"x": "ct0"}, str(base / "z.csv"))


def test_plot_hist_thresholds_draws_and_validates(cohort):
    _, _, cell_data, _ = cohort
    TPC.plot_hist_thresholds(cell_data, ["ct0", "ct1"], "area",
                             pop_col="cell_meta_cluster", threshold=10.0)
    assert len(plt.gcf().axes) == 2
    plt.close("all")
    with pytest.raises(ValueError, match="Invalid population"):
        TPC.plot_hist_thresholds(cell_data, ["nope"], "area", pop_col="cell_meta_cluster")
    with pytest.raises(ValueError, match="Could not find"):
        TPC.plot_hist_thresholds(cell_data, ["ct0"], "nope", pop_col="cell_meta_cluster")


def test_cluster_plots_draw(cohort, tmp_path, remap_csv):
    """plot_cluster, the two per-FOV plot functions and the continuous plot
    draw their figures (one image axis and one colorbar axis) and save."""
    fovs, base, _, data = cohort
    path, colors = remap_csv
    rng = np.random.default_rng(6)
    masks = rng.integers(0, 4, (2, 32, 36, 1)).astype(np.int16)
    coords = {"fovs": ["a", "b"], "rows": np.arange(32), "cols": np.arange(36),
              "channels": ["mask"]}
    cmap, norm = TP.create_cmap("tab20", 3)
    fig = TP.plot_cluster(masks[0, ..., 0], "a", cmap, norm, dpi=40)
    assert len(fig.axes) == 2
    labels = [t.get_text() for t in fig.axes[1].get_yticklabels()]
    assert labels == ["Empty", "Cluster 1", "Cluster 2", "Cluster 3", "Unassigned"]
    (tmp_path / "nb").mkdir()
    TP.plot_neighborhood_cluster_result(TDataArray(masks, coords=coords), ["a", "b"], k=3,
                                        save_dir=str(tmp_path / "nb"), dpi=40)
    (tmp_path / "pc").mkdir()
    TP.plot_pixel_cell_cluster(TDataArray(masks, coords=coords), ["b"], path, dict(colors),
                               save_dir=str(tmp_path / "pc"), erode=True, dpi=40,
                               device="cpu")
    assert sorted(os.listdir(tmp_path / "nb")) == ["a.png", "b.png"]
    assert os.listdir(tmp_path / "pc") == ["b.png"]
    fig = TP.plot_continuous_variable(rng.random((20, 20)), "a", "stat", "viridis", dpi=40)
    assert len(fig.axes) == 2
    plt.close("all")
    with pytest.raises(ValueError):
        TP.plot_pixel_cell_cluster(JDataArray(masks, coords=coords), ["a"], path,
                                   dict(colors), cluster_type="fiber", device="cpu")
