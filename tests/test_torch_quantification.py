"""The port's cell table (template 1's quantification) against the JAX
package's, on the CPU.

Tolerances: every column that is a segment sum or built from them by the
same numpy arithmetic (cell size, channel sums and their size-normalized
and arcsinh forms, label, area, centroids, perimeter, convex area,
num_concavities, nc_ratio, the ratios of those) is bitwise equal. The
columns derived from the second moments (eccentricity, axis lengths,
equivalent diameter and their ratios) are held to rtol = atol = 1e-6: torch
and XLA round the eigenvalue arithmetic differently in the last bit.
Nucleus matching, nucleus splitting and relabeling are integer work,
bitwise. A checkpointed and resumed cell table equals a straight run bit
for bit. The port's inputs are the port's own DataArray, the JAX package's
its own, built from the same numpy arrays.
"""

import copy
import os

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu import settings
from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.segmentation import marker_quantification as JQ
from ark_tpu.segmentation import regionprops_extraction as JR
from ark_tpu.segmentation import segmentation_utils as JU
from ark_tpu.segmentation import signal_extraction as JE
from ark_tpu.utils.labeled_array import DataArray as JDataArray
from ark_tpu_torch.segmentation import marker_quantification as TQ
from ark_tpu_torch.segmentation import regionprops_extraction as TR
from ark_tpu_torch.segmentation import segmentation_utils as TU
from ark_tpu_torch.segmentation import signal_extraction as TE
from ark_tpu_torch.utils.labeled_array import DataArray
from tests import test_utils

torch.set_num_threads(2)

CHANNELS = ["chan0", "chan1", "chan2", "chan3"]
DERIVED = {"eccentricity", "major_axis_length", "minor_axis_length",
           "equivalent_diameter", "major_minor_axis_ratio",
           "major_axis_equiv_diam_ratio"}
DERIVED_TOL = 1e-6
EXTRACTIONS = [("total_intensity", {}), ("positive_pixel", {}),
               ("positive_pixel", {"signal_kwargs": {"threshold": 0.5}}),
               ("center_weighting", {}),
               ("total_intensity", {"regionprops_kwargs": {
                   "small_concavity_minimum": 3, "max_compactness": 80}})]


def _fov(seed, shape=(80, 80)):
    """Whole-cell masks (overlapping disks: concave unions, touching cells)
    and nuclei, some of which reach beyond their cell (split_large_nuclei
    work), plus channel images."""
    rng = np.random.default_rng(seed)
    cells = test_utils.make_labels_image(rng, shape=shape, n_cells=24, radius=7)
    nucs = test_utils.make_labels_image(rng, shape=shape, n_cells=30, radius=3)
    nucs[10:40, 20:24] = nucs.max() + 1                  # a long nucleus
    imgs = test_utils.make_channel_images(rng, cells, CHANNELS)
    return cells, nucs, imgs


def _arrays(cells, nucs, imgs, fov="fov0", cls=DataArray):
    """(image, segmentation) labeled arrays of class `cls`: the port's
    DataArray, or the JAX package's for its functions."""
    h, w = cells.shape
    img = cls(imgs[None], coords={"fovs": [fov], "rows": np.arange(h),
                                  "cols": np.arange(w), "channels": CHANNELS})
    seg = cls(np.stack([cells, nucs], -1)[None],
              coords={"fovs": [fov], "rows": np.arange(h), "cols": np.arange(w),
                      "compartments": ["whole_cell", "nuclear"]})
    return img, seg


def _as_jax(da):
    """The same labeled array as the JAX package's DataArray."""
    return JDataArray(da.values, coords=dict(da.coords), dims=da.dims)


def _as_port(da):
    """A copy of a JAX package DataArray as the port's DataArray."""
    return DataArray(da.values.copy(), coords=dict(da.coords), dims=da.dims)


def _base(col):
    return col[:-len("_nuclear")] if col.endswith("_nuclear") else col


def assert_tables_equal(got, want):
    """Same columns, order, dtypes and index; sums bitwise; DERIVED within
    DERIVED_TOL."""
    assert list(got.columns) == list(want.columns)
    assert list(got.dtypes) == list(want.dtypes)
    np.testing.assert_array_equal(got.index.values, want.index.values)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if _base(col) in DERIVED:
            np.testing.assert_allclose(g, w, rtol=DERIVED_TOL, atol=DERIVED_TOL,
                                       err_msg=col)
        else:
            np.testing.assert_array_equal(g, w, err_msg=col)


def assert_marker_counts_equal(got, want):
    assert list(got.coords["features"]) == list(want.coords["features"])
    assert list(got.coords["compartments"]) == list(want.coords["compartments"])
    np.testing.assert_array_equal(got.coords["cell_id"], want.coords["cell_id"])
    for j, feat in enumerate(want.coords["features"]):
        g, w = got.values[..., j], want.values[..., j]
        if feat in DERIVED:
            np.testing.assert_allclose(g, w, rtol=DERIVED_TOL, atol=DERIVED_TOL,
                                       err_msg=feat)
        else:
            np.testing.assert_array_equal(g, w, err_msg=feat)


@pytest.mark.parametrize("extraction,kwargs", EXTRACTIONS)
@pytest.mark.parametrize("nuclear", [False, True])
def test_compute_marker_counts_matches_jax(extraction, kwargs, nuclear):
    img, seg = _arrays(*_fov(1))
    if not nuclear:
        seg = DataArray(seg.values[..., :1], coords={
            **{k: seg.coords[k] for k in ("fovs", "rows", "cols")},
            "compartments": ["whole_cell"]})
    args = (img.sel(fovs="fov0"), seg.sel(fovs="fov0"))
    kw = dict(nuclear_counts=nuclear, split_large_nuclei=nuclear,
              extraction=extraction, **kwargs)
    timings = {}
    got = TQ.compute_marker_counts(*args, device="cpu", timings=timings, **kw)
    assert_marker_counts_equal(got, JQ.compute_marker_counts(*map(_as_jax, args), **kw))
    assert set(timings) == {"device_reductions_s", "convex_s", "assembly_s"}


@pytest.mark.parametrize("fast_extraction", [False, True])
def test_create_marker_count_matrices_matches_jax(fast_extraction):
    img, seg = _arrays(*_fov(2))
    kw = dict(nuclear_counts=True, split_large_nuclei=True,
              fast_extraction=fast_extraction)
    got = TQ.create_marker_count_matrices(seg, img, device="cpu", **kw)
    want = JQ.create_marker_count_matrices(_as_jax(seg), _as_jax(img), **kw)
    for g, w in zip(got, want):
        assert_tables_equal(g, w)
    with pytest.raises(ValueError, match="DataArray"):
        TQ.create_marker_count_matrices(seg.values, img, device="cpu")
    with pytest.raises(ValueError, match="DataArray"):           # the JAX package's class
        TQ.create_marker_count_matrices(_as_jax(seg), _as_jax(img), device="cpu")


def test_empty_fov_warns_and_returns_empty():
    cells, nucs, imgs = _fov(3)
    img, seg = _arrays(np.zeros_like(cells), np.zeros_like(nucs), imgs)
    with pytest.warns(UserWarning, match="No cells"):
        mc = TQ.compute_marker_counts(img.sel(fovs="fov0"), seg.sel(fovs="fov0"),
                                      nuclear_counts=True, device="cpu")
    assert mc.values.shape[1] == 0


@pytest.fixture
def cohort(tmp_path):
    """A tiny TIFF cohort: three FOVs with channel images, whole-cell and
    nuclear masks."""
    tiff_dir, seg_dir = tmp_path / "image_data", tmp_path / "deepcell_output"
    for i, fov in enumerate(("fov0", "fov1", "fov2")):
        cells, nucs, imgs = _fov(10 + i, shape=(48, 56))
        for ci, chan in enumerate(CHANNELS):
            save_image(str(tiff_dir / fov / f"{chan}.tiff"), imgs[..., ci])
        save_image(str(seg_dir / f"{fov}_whole_cell.tiff"), cells)
        save_image(str(seg_dir / f"{fov}_nuclear.tiff"), nucs)
    return dict(segmentation_dir=str(seg_dir), tiff_dir=str(tiff_dir),
                img_sub_folder=None), tmp_path


# the nuclear columns the hull gives
HULL_NUCLEAR = [c + "_nuclear" for c in ("convex_area", "convex_hull_resid", "centroid_dif",
                                         "num_concavities")]


def _hull_of_shared_nuclei(table):
    """`table` with a nucleus that is several cells' best match given, in
    every one of its rows, the hull columns of its last row. The JAX
    package's ``convex_features`` fills only the last row of an id asked
    for twice and leaves the others 0; the port rasters the nucleus once and
    repeats it."""
    table = table.copy()
    for fov, rows in table.groupby("fov").groups.items():
        nuc = table.loc[rows, "label_nuclear"]
        for nid in nuc[nuc.duplicated(keep=False) & (nuc > 0)].unique():
            same = nuc.index[nuc == nid]
            table.loc[same, HULL_NUCLEAR] = table.loc[same[-1], HULL_NUCLEAR].to_numpy()
    return table


@pytest.mark.parametrize("extraction,kwargs", EXTRACTIONS[:4])
def test_generate_cell_table_matches_jax(cohort, extraction, kwargs):
    """Equal but for the hull columns of a nucleus shared by two cells,
    which the port gives in each of their rows (``_hull_of_shared_nuclei``);
    the cohort has such nuclei."""
    dirs, _ = cohort
    kw = dict(dirs, extraction=extraction, nuclear_counts=True, **kwargs)
    got = TQ.generate_cell_table(device="cpu", **kw)
    want = JQ.generate_cell_table(**kw)
    shared = want[0]["label_nuclear"].groupby(want[0]["fov"]).apply(
        lambda n: bool((n[n > 0].duplicated()).any()))
    assert shared.any()
    for g, w in zip(got, want):
        assert_tables_equal(g, _hull_of_shared_nuclei(w.reset_index(drop=True))
                            .set_axis(w.index))


def test_generate_cell_table_fast_and_extra_mask_types_match_jax(cohort):
    dirs, _ = cohort
    seg_dir = dirs["segmentation_dir"]
    for fov in ("fov0", "fov1", "fov2"):
        save_image(os.path.join(seg_dir, f"{fov}_custom.tiff"),
                   read_image(os.path.join(seg_dir, f"{fov}_whole_cell.tiff")))
    kw = dict(dirs, nuclear_counts=True, fast_extraction=True,
              mask_types=["whole_cell", "custom"], fovs=["fov2", "fov0"])
    for g, w in zip(TQ.generate_cell_table(device="cpu", **kw),
                    JQ.generate_cell_table(**kw)):
        assert_tables_equal(g, w)


@pytest.mark.parametrize("mask_types", [["whole_cell"], ["whole_cell", "custom"]])
def test_cell_table_from_planes_equals_the_dataarray_entry(cohort, mask_types):
    """``generate_cell_table`` reads a FOV's channels into planes, uploads
    them once and interleaves them on the device for every mask type; its
    tables equal ``create_marker_count_matrices`` on ``load_imgs_from_tree``'s
    array, mask type by mask type, bit for bit."""
    from ark_tpu_torch.io import load_utils as TL

    dirs, _ = cohort
    seg_dir = dirs["segmentation_dir"]
    fovs = ["fov0", "fov1", "fov2"]
    for fov in fovs:
        save_image(os.path.join(seg_dir, f"{fov}_custom.tiff"),
                   read_image(os.path.join(seg_dir, f"{fov}_nuclear.tiff")))
    got = TQ.generate_cell_table(device="cpu", nuclear_counts=True,
                                 mask_types=mask_types, **dirs)
    want = ([], [])
    for fov in fovs:
        images = TL.load_imgs_from_tree(dirs["tiff_dir"], img_sub_folder=None, fovs=[fov])
        for mask_type in mask_types:
            _, labels = TQ._mask_labels(seg_dir, fov, mask_type, True, True)
            tables = TQ.create_marker_count_matrices(
                labels, images, device="cpu",
                nuclear_counts="nuclear" in labels.coords["compartments"])
            for side, table in zip(want, tables):
                table["mask_type"] = mask_type
                side.append(table)
    for g, w in zip(got, want):
        pd.testing.assert_frame_equal(g, pd.concat(w), check_exact=True)


def test_checkpoint_resume_is_bitwise_equal_to_a_straight_run(cohort, monkeypatch):
    dirs, tmp = cohort
    parts = str(tmp / "parts")
    straight = TQ.generate_cell_table(device="cpu", nuclear_counts=True, **dirs)
    first = TQ.generate_cell_table(device="cpu", nuclear_counts=True,
                                   checkpoint_dir=parts, **dirs)
    assert sorted(f for f in os.listdir(parts) if f.endswith(".pkl")) == [
        "fov0.quant.pkl", "fov1.quant.pkl", "fov2.quant.pkl"]
    with open(os.path.join(parts, "fov1.quant.pkl"), "wb") as f:
        f.write(b"truncated")                      # a corrupted part
    calls = []
    real = TQ._count_tables                        # one call a FOV and mask type

    def counting(*a, **k):
        calls.append(1)
        return real(*a, **k)

    monkeypatch.setattr(TQ, "_count_tables", counting)
    resumed = TQ.generate_cell_table(device="cpu", nuclear_counts=True,
                                     checkpoint_dir=parts, **dirs)
    assert len(calls) == 1                         # only fov1 extracted again
    for tables in (first, resumed):
        for g, w in zip(tables, straight):
            pd.testing.assert_frame_equal(g, w, check_exact=True)
    # other settings discard the parts
    TQ.generate_cell_table(device="cpu", nuclear_counts=False,
                           checkpoint_dir=parts, **dirs)
    assert len(calls) == 4


def test_nucleus_matching_and_splitting_match_jax():
    cells, nucs, _ = _fov(4)
    ids = np.unique(cells)[1:]
    assert TU.match_nuclei_to_cells(cells, nucs) == JU.match_nuclei_to_cells(cells, nucs)
    split = TU.split_large_nuclei(cells, nucs, ids)
    np.testing.assert_array_equal(split, JU.split_large_nuclei(cells, nucs, ids))
    assert split.max() > nucs.max()                # a nucleus was split
    assert TU.match_nuclei_to_cells(cells, np.zeros_like(nucs)) == {}
    coords = np.argwhere(cells == ids[0])
    assert TU.find_nuclear_label_id(nucs, coords) == \
        JU.find_nuclear_label_id(nucs, coords)


@pytest.mark.parametrize("transform,kwargs", [("size_norm", None), ("arcsinh", None),
                                              ("arcsinh", {"linear_factor": 7})])
def test_transform_expression_matrix_matches_jax(transform, kwargs):
    img, seg = _arrays(*_fov(5))
    mc = TQ.compute_marker_counts(img.sel(fovs="fov0"), seg.sel(fovs="fov0"),
                                  nuclear_counts=True, device="cpu")
    got = TU.transform_expression_matrix(mc, transform, kwargs)
    want = JU.transform_expression_matrix(mc, transform, kwargs)
    np.testing.assert_array_equal(got.values, want.values)
    with pytest.raises(ValueError, match="transform"):
        TU.transform_expression_matrix(mc, "log")


def test_single_and_multi_compartment_helpers_match_jax():
    cells, nucs, imgs = _fov(6)
    props = TQ.get_single_compartment_props(cells, device="cpu")
    want = JQ.get_single_compartment_props(cells)
    assert_tables_equal(props, want)
    img, seg = _arrays(cells, nucs, imgs, cls=JDataArray)
    mc = JQ.compute_marker_counts(img.sel(fovs="fov0"), seg.sel(fovs="fov0"),
                                  nuclear_counts=True)
    names = list(mc.coords["features"])[1 + len(CHANNELS):-1]
    blank_t, blank_j = _as_port(mc), copy.deepcopy(mc)
    blank_t.values[0] = 0
    blank_j.values[0] = 0
    got = TQ.assign_single_compartment_features(
        blank_t, "whole_cell", cells, imgs, names, settings.REGIONPROPS_SINGLE_COMP,
        device="cpu")
    want = JQ.assign_single_compartment_features(
        blank_j, "whole_cell", cells, imgs, names, settings.REGIONPROPS_SINGLE_COMP)
    assert_marker_counts_equal(got, want)
    got = TQ.assign_multi_compartment_features(got, ["nc_ratio"])
    want = JQ.assign_multi_compartment_features(want, ["nc_ratio"])
    assert_marker_counts_equal(got, want)


def test_extraction_and_regionprop_functions_match_jax():
    """The per-cell numpy registries are the JAX package's, and the batch
    reducers agree with the per-cell oracle."""
    cells, _, imgs = _fov(7)
    img_t = torch.as_tensor(imgs)
    s = int(cells.max()) + 1
    assert list(TE.EXTRACTION_FUNCTION) == list(JE.EXTRACTION_FUNCTION)
    for name, fn in TE.EXTRACTION_FUNCTION.items():
        batch = TE.EXTRACTION_FUNCTION_BATCH[name](img_t, torch.as_tensor(cells), s,
                                                   threshold=0.3).numpy()
        for cid in np.unique(cells)[1:4]:
            coords = np.argwhere(cells == cid)
            kw = dict(threshold=0.3, centroid=coords.mean(0))
            got = fn(coords, imgs, **kw)
            np.testing.assert_array_equal(got, JE.EXTRACTION_FUNCTION[name](
                coords, imgs, **kw))
            np.testing.assert_allclose(batch[cid], got, rtol=1e-5)
    mask = cells == np.unique(cells)[1]
    ys, xs = np.nonzero(mask)
    crop = mask[ys.min():ys.max() + 1, xs.min():xs.max() + 1]
    hull = np.ones_like(crop)
    fields = dict(label=1, area=float(crop.sum()), centroid=(3.0, 4.0),
                  major_axis_length=9.0, minor_axis_length=4.0, perimeter=20.0,
                  equivalent_diameter=7.0, convex_area=float(hull.sum()),
                  image=crop, convex_image=hull)
    assert set(TR.REGIONPROPS_FUNCTION) == set(JR.REGIONPROPS_FUNCTION)
    assert TR.CONVEX_PROPS == JR.CONVEX_PROPS
    for name in set(TR.REGIONPROPS_FUNCTION) - {"nc_ratio"}:
        assert TR.REGIONPROPS_FUNCTION[name](TR.RegionProp(**fields)) == \
            JR.REGIONPROPS_FUNCTION[name](JR.RegionProp(**fields)), name


def test_host_io_helpers_match_jax(tmp_path):
    fovs = ["R1C1", "TMA_R1C1"]
    masks = ["R1C1_whole_cell.tiff", "TMA_R1C1_whole_cell.tiff",
             "TMA_R1C1_nuclear.tiff", "R1C1_custom_mask.tiff"]
    assert TQ.get_existing_mask_types(fovs, masks) == \
        JQ.get_existing_mask_types(fovs, masks)
    for i in range(2):
        pd.DataFrame({"a": [i, i + 1]}).to_csv(tmp_path / f"t{i}.csv", index=False)
    TU.concatenate_csv(str(tmp_path), ["t0.csv", "t1.csv"])
    got = pd.read_csv(tmp_path / "combined_data.csv")
    JU.concatenate_csv(str(tmp_path), ["t0.csv", "t1.csv"])
    pd.testing.assert_frame_equal(got, pd.read_csv(tmp_path / "combined_data.csv"))


def test_save_segmentation_labels_matches_jax(tmp_path):
    cells, _, _ = _fov(8)
    save_image(str(tmp_path / "fov0_whole_cell.tiff"), cells)
    for out in ("jax", "torch"):
        (tmp_path / out).mkdir()
    JU.save_segmentation_labels(str(tmp_path), None, str(tmp_path / "jax"), ["fov0"])
    TU.save_segmentation_labels(str(tmp_path), None, str(tmp_path / "torch"), ["fov0"],
                                device="cpu")
    name = "fov0_segmentation_borders.tiff"
    got, want = read_image(str(tmp_path / "torch" / name)), \
        read_image(str(tmp_path / "jax" / name))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    # with channels: the overlay of the borders on the rescaled channel data,
    # the same uint8 bytes (the rescale truncates in f64, so exact)
    _, nucs, _ = _fov(8)
    save_image(str(tmp_path / "fov0_nuclear.tiff"), nucs)
    (tmp_path / "data").mkdir()
    rng = np.random.default_rng(8)
    save_image(str(tmp_path / "data" / "fov0.tiff"),
               rng.gamma(1.0, 3.0, cells.shape + (2,)).astype(np.float32))
    chans = ["nuclear_channel", "membrane_channel"]
    JU.save_segmentation_labels(str(tmp_path), str(tmp_path / "data"),
                                str(tmp_path / "jax"), ["fov0"], channels=chans)
    TU.save_segmentation_labels(str(tmp_path), str(tmp_path / "data"),
                                str(tmp_path / "torch"), ["fov0"], channels=chans,
                                device="cpu")
    name = "fov0_nuclear_channel_membrane_channel_overlay.tiff"
    got, want = read_image(str(tmp_path / "torch" / name)), \
        read_image(str(tmp_path / "jax" / name))
    assert got.dtype == want.dtype == np.uint8 and got.shape == cells.shape + (3,)
    assert want.max() == 255 and len(np.unique(want)) > 50
    np.testing.assert_array_equal(got, want)


def test_smoke_quantification_phases_rehearse_on_cpu(monkeypatch, tmp_path):
    """chip_smoke.py's segment-sum, cell-table and cell-clustering phases,
    driven on the CPU at a tiny size (the card's run is the same code at full
    size): every check they make holds, and the calls that the card would
    launch kernels for are counted."""
    import chip_smoke
    from ark_tpu_torch.ops import segment_reduce, som

    monkeypatch.setattr(chip_smoke, "DEVICE", "cpu")
    monkeypatch.setattr(chip_smoke, "MIN_CELLS", {"segmented": 10, "dense": 10})
    monkeypatch.setattr(chip_smoke, "COHORT_COPIES", 2)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    # the launch counts the phases read from the smoke's counter table
    seen = []
    real_since = chip_smoke.launches_since
    monkeypatch.setattr(chip_smoke, "launches_since",
                        lambda before: seen.append(real_since(before)) or seen[-1])
    def counting(real):
        def counted(*a, **k):
            counted.launches += 1
            return real(*a, **k)

        counted.launches = 0
        return counted

    for mod, name in ((segment_reduce, "segment_sum"), (segment_reduce, "segment_plan"),
                      (som, "bmu")):
        monkeypatch.setattr(mod, name, counting(getattr(mod, name)))
    masks = chip_smoke.dense_masks(n_fovs=2, size=96, n_cells=30, cell_radius=9,
                                   nuc_radius=3, nuc_shift=2)
    err, plan_err, checked = chip_smoke.check_segment_sum(masks)
    assert err == 0.0 and plan_err == 0
    # K = 3 and K = 44 on every FOV
    assert checked == 2 * len(masks["whole_cell"])
    assert len(chip_smoke.check_background_row(masks["whole_cell"])) == 6
    cohort = chip_smoke.quant_cohort(masks)
    tables = chip_smoke.run_cell_table(cohort, "dense")
    # the run with the default regionprops
    launches, plan_launches = seen[-1]["segment_sum"], seen[-1]["segment_plan"]
    assert launches == 4 * len(cohort) and plan_launches == 2 * len(cohort)
    assert len(tables) == 2 * len(cohort)
    chip_smoke.run_cell_clustering(cohort, tables, str(tmp_path))
    assert som.bmu.launches > 0
