"""The fiber-segmentation slice of the port against the JAX package, on the
CPU: ark_tpu_torch.segmentation.fiber_segmentation.

By stage, with the JAX package's intermediates injected: given its ridge
image, the port's foreground mask is equal and its squared EDT bitwise
equal; given its distance and elevation maps, the host tail (multi-Otsu,
markers, the native flood, scipy labels, the small-object filter) is bitwise
equal, and so is the property table of its labels, apart from the columns
derived through sqrt and atan2 (rtol = atol = 1e-6).

End to end from the raw image the floats differ in their last bits (rtol
1e-5, atol 1e-6 of each map's scale; the ridge image, Frangi's response x
10000, moves in steps of 6e-4), so the labels are held by the near-threshold
rule of ``chip_smoke.fiber_labels_differ``: a differing pixel is excused
only if its ridge value lies within RIDGE_TOL of the cutoff, or its distance
within DT_RTOL of a multi-Otsu cut, or its object (grown by FLIP_REACH
pixels) holds such a pixel; at most EXCUSED_SHARE of the image. The main
seeds excuse none: their labels are equal.
"""

import os
import warnings

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io.image_utils import save_image
from ark_tpu.ops import edt as JE
from ark_tpu.segmentation import fiber_segmentation as JF
from ark_tpu_torch import settings
from ark_tpu_torch.ops import edt as TE
from ark_tpu_torch.segmentation import fiber_segmentation as TF
from chip_smoke import (EXCUSED_SHARE, FIBER_DEFAULTS, FLIP_REACH, fiber_image,
                        fiber_labels_differ, near_threshold_pixels)

torch.set_num_threads(1)
SIZE = 256
# CLAHE tiles of 8 px, as the default divisor 128 gives a 1024-px FOV
ARGS = dict(FIBER_DEFAULTS, contrast_scaling_divisor=32)
DERIVED = {"major_axis_length", "minor_axis_length", "eccentricity", "orientation",
           "alignment_score"}
MAIN_SEEDS = [0, 9, 10]
BIN_EDGE_SEED = 2


def _image(seed, size=SIZE):
    return fiber_image(np.random.default_rng(seed), size=size, n_fibers=12)


def _steps(module, img, **kw):
    return module._fiber_steps(img, img.shape[0], *ARGS.values(), **kw)


@pytest.fixture(scope="module")
def jax_steps():
    return {seed: _steps(JF, _image(seed)) for seed in MAIN_SEEDS + [BIN_EDGE_SEED]}


def _tables_agree(got, want):
    assert list(got.columns) == list(want.columns)
    assert len(got) == len(want)
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if col in DERIVED:
            np.testing.assert_allclose(g.astype(float), w.astype(float), rtol=1e-6,
                                       atol=1e-6, equal_nan=True, err_msg=col)
        else:
            assert g.dtype == w.dtype, col
            np.testing.assert_array_equal(g, w, err_msg=col)


@pytest.mark.parametrize("seed", MAIN_SEEDS)
def test_given_the_ridges_the_mask_and_squared_edt_are_bitwise(jax_steps, seed):
    ridges = jax_steps[seed]["ridges"]
    fg = torch.as_tensor(ridges) > torch.tensor(ARGS["ridge_cutoff"], dtype=torch.float32)
    want_fg = np.asarray(jnp.asarray(ridges) > jnp.float32(ARGS["ridge_cutoff"]))
    np.testing.assert_array_equal(fg.numpy(), want_fg)
    np.testing.assert_array_equal(TE._edt2_int(fg).numpy(),
                                  np.asarray(JE._edt2_int(jnp.asarray(want_fg))))


@pytest.mark.parametrize("seed", MAIN_SEEDS)
def test_given_the_maps_the_host_tail_and_table_are_bitwise(jax_steps, seed):
    want = jax_steps[seed]
    threshed, labeled = TF._fiber_host_tail(want["distance_transformed"],
                                            want["elevation_map"],
                                            ARGS["min_fiber_size"])
    np.testing.assert_array_equal(threshed, want["threshed"])
    np.testing.assert_array_equal(labeled, want["labeled_filtered"])
    assert labeled.dtype == np.int32 and labeled.max() >= 4
    _tables_agree(
        TF._fiber_regionprops_table(labeled, settings.FIBER_OBJECT_PROPS, device="cpu"),
        JF._fiber_regionprops_table(labeled, settings.FIBER_OBJECT_PROPS))


@pytest.mark.parametrize("seed", MAIN_SEEDS)
def test_end_to_end_main_seeds_are_equal(jax_steps, seed):
    want = jax_steps[seed]
    timings = {}
    got = _steps(TF, _image(seed), device="cpu", timings=timings)
    assert set(got) == set(want)
    for key in ("blurred", "contrast_adjusted", "ridges", "distance_transformed",
                "elevation_map"):
        assert got[key].dtype == want[key].dtype and got[key].shape == want[key].shape
        scale = float(np.abs(want[key]).max())
        # the ridges are Frangi's response x 10000, whose atol is of order one
        atol = 1e-6 * (1e4 if key == "ridges" else scale)
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=atol, err_msg=key)
    differ, excused, left = fiber_labels_differ(got, want, ARGS["ridge_cutoff"])
    print(f"seed {seed}: {differ} label pixels differ, {excused} excused, {left} not")
    assert (differ, excused, left) == (0, 0, 0)
    np.testing.assert_array_equal(got["labeled_filtered"], want["labeled_filtered"])
    np.testing.assert_array_equal(got["threshed"], want["threshed"])
    assert {"blur_s", "clahe_s", "frangi_s", "edt_s", "sobel_s", "otsu_s", "flood_s",
            "labels_filter_s"} <= set(timings)


@pytest.mark.parametrize("seed", MAIN_SEEDS)
def test_end_to_end_under_the_near_threshold_rule(jax_steps, seed):
    """The port with its cutoff moved by a quarter of RIDGE_TOL flips every
    ridge pixel that close to the cutoff, as float noise may: the rule
    excuses what follows from them, and nothing else differs."""
    want = jax_steps[seed]
    moved = dict(ARGS, ridge_cutoff=ARGS["ridge_cutoff"] + 5e-4)
    img = _image(seed)
    got = TF._fiber_steps(img, img.shape[0], *moved.values(), device="cpu")
    flipped = int(((got["ridges"] > moved["ridge_cutoff"])
                   != (want["ridges"] > ARGS["ridge_cutoff"])).sum())
    differ, excused, left = fiber_labels_differ(got, want, ARGS["ridge_cutoff"])
    print(f"seed {seed}: {flipped} ridge pixels flipped; {differ} label pixels differ, "
          f"{excused} excused by the near-threshold rule, {left} not")
    assert flipped > 0 and left == 0
    assert excused <= EXCUSED_SHARE * want["labeled_filtered"].size


def test_a_clahe_bin_edge_moves_one_pixel_and_no_label(jax_steps):
    """CLAHE's bin index truncates norm * 255: a last-bit difference in the
    blur moves a pixel that sits on a bin edge into the next bin (here one
    pixel). The contrast image differs there alone, and the labels hold."""
    want = jax_steps[BIN_EDGE_SEED]
    got = _steps(TF, _image(BIN_EDGE_SEED), device="cpu")
    moved = np.abs(got["contrast_adjusted"] - want["contrast_adjusted"]) > 1e-5
    norm = want["blurred"].astype(np.float64) / want["blurred"].max() * 255
    assert 1 <= moved.sum() <= 3
    assert (np.abs(norm - np.rint(norm))[moved] < 1e-4).all()
    differ, excused, left = fiber_labels_differ(got, want, ARGS["ridge_cutoff"])
    print(f"seed {BIN_EDGE_SEED}: {int(moved.sum())} contrast pixels moved a bin; "
          f"{differ} label pixels differ, {excused} excused, {left} not")
    assert left == 0 and excused <= EXCUSED_SHARE * moved.size


def test_the_rule_does_not_excuse_a_far_difference(jax_steps):
    """Renumbering is no difference; a moved or dropped object away from
    every threshold is one and is not excused."""
    want = jax_steps[MAIN_SEEDS[0]]
    shifted = dict(want, labeled_filtered=np.where(want["labeled_filtered"] > 0,
                                                   want["labeled_filtered"] + 3, 0))
    assert fiber_labels_differ(shifted, want, ARGS["ridge_cutoff"]) == (0, 0, 0)
    # a 5 x 5 object dropped where no fiber and no near-threshold pixel is
    # within 3 * FLIP_REACH pixels
    import scipy.ndimage as ndi
    lab = want["labeled_filtered"].copy()
    busy = near_threshold_pixels(want, ARGS["ridge_cutoff"]) | (lab > 0)
    room = ndi.distance_transform_edt(~busy)
    room[:3], room[-3:], room[:, :3], room[:, -3:] = 0, 0, 0, 0
    y, x = np.unravel_index(np.argmax(room), room.shape)
    assert room[y, x] > 3 * FLIP_REACH
    lab[y - 2:y + 3, x - 2:x + 3] = lab.max() + 1
    differ, excused, left = fiber_labels_differ(dict(want, labeled_filtered=lab), want,
                                                ARGS["ridge_cutoff"])
    assert (differ, excused, left) == (25, 0, 25)


def test_all_foreground_fov_warns_and_is_empty():
    img = _image(9, size=64)
    args = dict(ARGS, ridge_cutoff=-1.0)
    for module, kw in ((JF, {}), (TF, {"device": "cpu"})):
        with pytest.warns(UserWarning, match="covers the entire FOV"):
            steps = module._fiber_steps(img, 64, *args.values(), **kw)
        assert not steps["labeled_filtered"].any()
        assert not steps["distance_transformed"].any()
    table = TF._fiber_regionprops_table(steps["labeled_filtered"],
                                        settings.FIBER_OBJECT_PROPS, device="cpu")
    want = JF._fiber_regionprops_table(steps["labeled_filtered"],
                                       settings.FIBER_OBJECT_PROPS)
    assert len(table) == 0 and list(table.columns) == list(want.columns)


def test_keep_intermediates_false_drops_the_debug_maps():
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        steps = _steps(TF, _image(9, size=128), keep_intermediates=False, device="cpu")
    assert set(steps) == {"distance_transformed", "threshed", "elevation_map",
                          "labeled_filtered"}


@pytest.fixture(scope="module")
def cohort(tmp_path_factory):
    """Two 256^2 FOVs as TIFF files, segmented by both packages."""
    base = tmp_path_factory.mktemp("fiber")
    data_dir = base / "imgs"
    for i, seed in enumerate(MAIN_SEEDS[:2]):
        fdir = data_dir / f"fov{i}"
        fdir.mkdir(parents=True)
        save_image(str(fdir / "Collagen1.tiff"), _image(seed))
        save_image(str(fdir / "Other.tiff"), _image(seed + 10))
    out = {}
    for name, module, kw in (("jax", JF, {}), ("torch", TF, {"device": "cpu"})):
        out_dir = base / name
        out_dir.mkdir()
        table = module.run_fiber_segmentation(
            str(data_dir), "Collagen1", str(out_dir), contrast_scaling_divisor=32,
            debug=True, **kw)
        out[name] = (str(out_dir), table)
    return str(data_dir), out


def test_run_fiber_segmentation_tables_and_files(cohort):
    _, out = cohort
    (jdir, jtab), (tdir, ttab) = out["jax"], out["torch"]
    assert len(ttab) >= 8 and set(ttab["fov"]) == {"fov0", "fov1"}
    _tables_agree(ttab.reset_index(drop=True), jtab.reset_index(drop=True))
    _tables_agree(pd.read_csv(os.path.join(tdir, "fiber_object_table.csv")),
                  pd.read_csv(os.path.join(jdir, "fiber_object_table.csv")))
    from ark_tpu_torch.io.image_utils import read_image
    for fov in ("fov0", "fov1"):
        np.testing.assert_array_equal(
            read_image(os.path.join(tdir, f"{fov}_fiber_labels.tiff")),
            read_image(os.path.join(jdir, f"{fov}_fiber_labels.tiff")))
        for name in ("thresholded", "ridges_thresholded", "frangi_filter",
                     "contrast_adjusted"):
            assert os.path.exists(os.path.join(tdir, "_debug", f"{fov}_{name}.tiff"))


def test_run_fiber_segmentation_rejects_a_missing_channel(cohort, tmp_path):
    data_dir, _ = cohort
    with pytest.raises(ValueError):
        TF.run_fiber_segmentation(data_dir, "NoSuchChannel", str(tmp_path), device="cpu")


@pytest.mark.parametrize("k,axis_thresh", [(4, 2), (2, 1.5)])
def test_calculate_fiber_alignment_matches(cohort, k, axis_thresh):
    _, out = cohort
    table = out["jax"][1].drop(columns="alignment_score").reset_index(drop=True)
    got = TF.calculate_fiber_alignment(table.copy(), k=k, axis_thresh=axis_thresh,
                                       device="cpu")
    want = JF.calculate_fiber_alignment(table.copy(), k=k, axis_thresh=axis_thresh)
    _tables_agree(got, want)
    assert got["alignment_score"].notna().any()
    none = TF.calculate_fiber_alignment(table.copy(), axis_thresh=1e9, device="cpu")
    assert none["alignment_score"].isna().all()


def test_calculate_density(cohort):
    _, out = cohort
    table = out["torch"][1]
    fov = table[table.fov == "fov0"]
    assert TF.calculate_density(fov, SIZE ** 2) == JF.calculate_density(fov, SIZE ** 2)


@pytest.mark.parametrize("tile_length,save_tiles", [(128, True), (256, False)])
def test_generate_summary_stats_matches(cohort, tile_length, save_tiles):
    _, out = cohort
    results = {}
    for name, module in (("jax", JF), ("torch", TF)):
        out_dir, table = out[name]
        results[name] = module.generate_summary_stats(
            table, out_dir, tile_length=tile_length, min_fiber_num=1, save_tiles=save_tiles)
    for got, want in zip(results["torch"], results["jax"]):
        assert list(got.columns) == list(want.columns) and len(got) == len(want)
        for col in want.columns:
            if want[col].dtype.kind == "f":
                np.testing.assert_allclose(got[col].to_numpy(), want[col].to_numpy(),
                                           rtol=1e-6, atol=1e-6, equal_nan=True, err_msg=col)
            else:
                np.testing.assert_array_equal(got[col].to_numpy(), want[col].to_numpy())
    tdir = out["torch"][0]
    assert os.path.exists(os.path.join(tdir, "fiber_stats_table.csv"))
    assert os.path.exists(os.path.join(
        tdir, f"tile_stats_{tile_length}", f"fiber_stats_table-tile_{tile_length}.csv"))
    if save_tiles:
        assert os.path.exists(os.path.join(tdir, f"tile_stats_{tile_length}", "fov0",
                                           "tile_0,0.tiff"))
    with pytest.raises(ValueError, match="factor"):
        TF.generate_summary_stats(out["torch"][1], tdir, tile_length=100)


def test_plot_fiber_segmentation_steps(cohort):
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    data_dir, _ = cohort
    fig = TF.plot_fiber_segmentation_steps(data_dir, "fov0", "Collagen1",
                                           contrast_scaling_divisor=32, device="cpu")
    assert len(fig.axes) == 8
    import matplotlib.pyplot as plt
    plt.close(fig)
