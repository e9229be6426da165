"""The port's ez_seg (ark_tpu_torch.segmentation.ez_seg) against the JAX
package's, on the CPU, on the same seeded inputs and files.

``_create_object_mask`` ends in a threshold and integer labels, so its masks
are held equal (every `thresh` and `hole_size` branch, both shapes); the
local threshold compares a pixel with a blurred mean, and the test images
keep their pixels away from that mean. Composites, merges, renumbering, CSV
filters and logs are host numpy and file IO: equal arrays and equal files.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.segmentation.ez_seg import composites as JCOMP
from ark_tpu.segmentation.ez_seg import ez_object_segmentation as JEZ
from ark_tpu.segmentation.ez_seg import ez_seg_display as JDISP
from ark_tpu.segmentation.ez_seg import ez_seg_utils as JUTIL
from ark_tpu.segmentation.ez_seg import merge_masks as JMERGE
from ark_tpu_torch.segmentation import ez_seg
from ark_tpu_torch.segmentation.ez_seg import composites as TCOMP
from ark_tpu_torch.segmentation.ez_seg import ez_object_segmentation as TEZ
from ark_tpu_torch.segmentation.ez_seg import ez_seg_utils as TUTIL
from ark_tpu_torch.segmentation.ez_seg import merge_masks as TMERGE
from tests import test_utils

torch.set_num_threads(1)


def _objects_image(rng, size=128):
    """Noise, two bright disks (blobs) and two bright line segments
    (projections)."""
    img = rng.uniform(0, 0.05, (size, size)).astype(np.float32)
    yy, xx = np.mgrid[:size, :size]
    img[(yy - 30) ** 2 + (xx - 30) ** 2 <= 100] += 5.0
    img[(yy - 90) ** 2 + (xx - 95) ** 2 <= 200] += 5.0
    for cy, cx, theta in ((40, 90, 0.4), (100, 35, 2.0)):
        d = np.abs((yy - cy) * np.cos(theta) - (xx - cx) * np.sin(theta))
        along = np.abs((yy - cy) * np.sin(theta) + (xx - cx) * np.cos(theta))
        img[(d < 1.5) & (along < 25)] += 3.0
    return img


def test_package_exposes_its_modules():
    assert {ez_seg.composites, ez_seg.ez_object_segmentation, ez_seg.ez_seg_display,
            ez_seg.ez_seg_utils, ez_seg.merge_masks}


@pytest.mark.parametrize("shape", ["blob", "projection"])
@pytest.mark.parametrize("thresh", [None, "auto", 95])
@pytest.mark.parametrize("hole_size", [None, "auto", 20])
def test_create_object_mask_is_equal(rng, shape, thresh, hole_size):
    img = _objects_image(rng)
    kw = dict(object_shape_type=shape, thresh=thresh, hole_size=hole_size, fov_dim=400,
              min_object_area=10)
    got = TEZ._create_object_mask(img, device="cpu", **kw)
    want = JEZ._create_object_mask(img, **kw)
    assert got.dtype == want.dtype and got.max() > 0
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sigma", [None, 1, 3])
def test_create_object_mask_sigma(rng, sigma):
    img = _objects_image(rng)
    kw = dict(sigma=sigma, thresh="auto", hole_size="auto", fov_dim=200)
    np.testing.assert_array_equal(TEZ._create_object_mask(img, device="cpu", **kw),
                                  JEZ._create_object_mask(img, **kw))


@pytest.mark.parametrize("kw", [{"thresh": 1.5}, {"hole_size": "big"},
                                {"object_shape_type": "star"}])
def test_create_object_mask_rejects_bad_arguments(rng, kw):
    with pytest.raises(ValueError):
        TEZ._create_object_mask(_objects_image(rng, 32), device="cpu", **kw)


@pytest.mark.parametrize("block_type", ["small_holes", "local_thresh"])
@pytest.mark.parametrize("fov_dim,img_shape", [(400, 1024), (800, 2048), (400, 128)])
def test_get_block_size(block_type, fov_dim, img_shape):
    assert TEZ.get_block_size(block_type, fov_dim, img_shape) == \
        JEZ.get_block_size(block_type, fov_dim, img_shape)


def test_create_object_masks_files(rng, tmp_path):
    img = _objects_image(rng)
    fdir = tmp_path / "imgs" / "fov0"
    fdir.mkdir(parents=True)
    save_image(str(fdir / "plaque.tiff"), img)
    out = {}
    for name, module, kw in (("jax", JEZ, {}), ("torch", TEZ, {"device": "cpu"})):
        masks_dir, log_dir = tmp_path / name / "masks", tmp_path / name / "logs"
        masks_dir.mkdir(parents=True)
        log_dir.mkdir()
        module.create_object_masks(
            str(tmp_path / "imgs"), None, ["fov0"], "plaque_mask", "plaque",
            str(masks_dir), str(log_dir), object_shape_type="blob", sigma=1,
            thresh=90, hole_size=None, min_object_area=50, max_object_area=5000, **kw)
        out[name] = read_image(str(masks_dir / "fov0_plaque_mask.tiff"))
        assert os.path.exists(str(log_dir / "plaque_mask_segmentation_log.txt"))
    np.testing.assert_array_equal(out["torch"], out["jax"])
    assert out["torch"][30, 30] > 0 and out["torch"][90, 95] > 0


@pytest.mark.parametrize("image_type,method", [("signal", "total"), ("signal", "binary"),
                                               ("pixel_cluster", "binary")])
def test_composite_builder(tmp_path, image_type, method):
    fovs, chans = ["fov0", "fov1"], ["a", "b", "c"]
    data_dir = tmp_path / "imgs"
    test_utils.create_image_cohort(str(data_dir), fovs, chans, shape=(32, 32))
    args = (str(data_dir), None, fovs, ["a", "b"], ["c"], image_type, method)
    got, want = TCOMP.composite_builder(*args), JCOMP.composite_builder(*args)
    assert set(got) == set(want) == set(fovs)
    for fov in fovs:
        assert got[fov].dtype == want[fov].dtype
        np.testing.assert_array_equal(got[fov], want[fov])
    only_add = TCOMP.composite_builder(str(data_dir), None, fovs, ["a"], [], image_type,
                                       method)
    np.testing.assert_array_equal(
        only_add["fov0"],
        JCOMP.composite_builder(str(data_dir), None, fovs, ["a"], [], image_type,
                                method)["fov0"])
    # the save path and log variant
    for name, module in (("jax", JCOMP), ("torch", TCOMP)):
        comp_dir, log_dir = tmp_path / name / "composites", tmp_path / name / "logs"
        comp_dir.mkdir(parents=True)
        log_dir.mkdir()
        assert module.composite_builder(
            *args, composite_directory=str(comp_dir), composite_name="comp1",
            log_dir=str(log_dir)) is None
        assert os.path.exists(str(log_dir / "comp1_composite_log.txt"))
    for fov in fovs:
        np.testing.assert_array_equal(
            read_image(str(tmp_path / "torch" / "composites" / fov / "comp1.tiff")),
            read_image(str(tmp_path / "jax" / "composites" / fov / "comp1.tiff")))
    with pytest.raises(ValueError):
        TCOMP.composite_builder(str(data_dir), None, fovs, ["nope"], [], image_type, method)


def _merge_inputs(rng, size=96):
    """Object blobs and cells: some cells inside objects, some grazing, some
    far."""
    yy, xx = np.mgrid[:size, :size]
    obj = np.zeros((size, size), np.int32)
    cell = np.zeros((size, size), np.int32)
    for i, (cy, cx) in enumerate(rng.uniform(12, size - 12, (6, 2))):
        obj[(yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(5, 11) ** 2] = i + 1
    for i, (cy, cx) in enumerate(rng.uniform(5, size - 5, (40, 2))):
        free = ((yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(2, 5) ** 2) & (cell == 0)
        cell[free] = i + 1
    return obj, cell


@pytest.mark.parametrize("thresh,expansion", [(50, 10), (10, 0), (90, 30)])
def test_merge_masks_single_is_equal(rng, tmp_path, thresh, expansion):
    obj, cell = _merge_inputs(rng)
    out = {}
    for name, module in (("jax", JMERGE), ("torch", TMERGE)):
        d = tmp_path / name
        d.mkdir()
        rest = module.merge_masks_single(obj.copy(), cell.copy(), thresh, "obj.tiff",
                                         str(d), expansion)
        out[name] = (rest, read_image(str(d / "obj_merged.tiff")))
    np.testing.assert_array_equal(out["torch"][0], out["jax"][0])
    np.testing.assert_array_equal(out["torch"][1], out["jax"][1])
    with pytest.raises(ValueError, match="same shape"):
        TMERGE.merge_masks_single(obj, cell[:-1], thresh, "obj.tiff", str(tmp_path), 0)


def test_merge_masks_seq_files(rng, tmp_path):
    fovs = ["fov0", "fov1"]
    obj_dir, cell_dir = tmp_path / "objs", tmp_path / "cells"
    obj_dir.mkdir()
    cell_dir.mkdir()
    for fov in fovs:
        obj, cell = _merge_inputs(rng)
        obj2, _ = _merge_inputs(rng)
        save_image(str(obj_dir / f"{fov}_plaque.tiff"), obj)
        save_image(str(obj_dir / f"{fov}_tangle.tiff"), obj2)
        save_image(str(cell_dir / f"{fov}_whole_cell.tiff"), cell)
    for name, module in (("jax", JMERGE), ("torch", TMERGE)):
        save, logs = tmp_path / name / "merged", tmp_path / name / "logs"
        save.mkdir(parents=True)
        logs.mkdir()
        module.merge_masks_seq(fovs, ["plaque", "tangle"], str(obj_dir), str(cell_dir),
                               "whole_cell", 30, 10, str(save), str(logs))
        assert os.path.exists(str(logs / "mask_merge_log.txt"))
    names = sorted(os.listdir(tmp_path / "jax" / "merged"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "merged")) and len(names) == 6
    for f in names:
        np.testing.assert_array_equal(read_image(str(tmp_path / "torch" / "merged" / f)),
                                      read_image(str(tmp_path / "jax" / "merged" / f)))


def test_bounding_boxes_and_bbox_filter(rng):
    obj, _ = _merge_inputs(rng)
    got, want = TMERGE.get_bounding_boxes(obj), JMERGE.get_bounding_boxes(obj)
    assert got == want and len(got) >= 4
    props = pd.DataFrame({"label": np.arange(1, 31),
                          "centroid-0": rng.uniform(0, 96, 30),
                          "centroid-1": rng.uniform(0, 96, 30)})
    for lab, box in want.items():
        assert TMERGE.filter_labels_in_bbox(box, props, 5) == \
            JMERGE.filter_labels_in_bbox(box, props, 5)


def _write_masks(base):
    base.mkdir()
    img = np.zeros((10, 10), np.int32)
    img[0:2, 0:2], img[0:2, 5:7], img[5:7, 0:2] = 1, 2, 3
    img[5:7, 5:7] = 7          # a gap: the label value exceeds the label count
    other = np.zeros((10, 10), np.int32)
    other[2:4, 2:4] = 1
    save_image(str(base / "fovA_obj.tiff"), img)
    save_image(str(base / "fovB_obj.tiff"), other)


def test_renumber_masks_is_equal(tmp_path):
    out = {}
    for name, module in (("jax", JUTIL), ("torch", TUTIL)):
        _write_masks(tmp_path / name)
        module.renumber_masks(str(tmp_path / name))
        out[name] = [read_image(str(tmp_path / name / f))
                     for f in ("fovA_obj.tiff", "fovB_obj.tiff")]
    for got, want in zip(out["torch"], out["jax"]):
        np.testing.assert_array_equal(got, want)
    labels = np.concatenate([np.unique(m[m > 0]) for m in out["torch"]])
    assert len(labels) == len(set(labels)) == 5


def test_filter_csvs_by_mask(tmp_path):
    df = pd.DataFrame({"x": [1, 2, 3, 4],
                       "mask_type": ["whole_cell", "plaque", "whole_cell", "plaque"]})
    for name, module in (("jax", JUTIL), ("torch", TUTIL)):
        d = tmp_path / name
        d.mkdir()
        df.to_csv(d / "table_size_normalized.csv", index=False)
        df.to_csv(d / "other.csv", index=False)
        module.filter_csvs_by_mask(str(d), "table")
    assert sorted(os.listdir(tmp_path / "torch")) == sorted(os.listdir(tmp_path / "jax"))
    for f in ("filtered_plaque_size_normalized.csv", "filtered_whole_cell_size_normalized.csv"):
        pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "torch" / f),
                                      pd.read_csv(tmp_path / "jax" / f))


def test_find_and_copy_files_and_log(tmp_path):
    src = tmp_path / "src" / "deep"
    src.mkdir(parents=True)
    for f in ("fov0_Plaque.tiff", "fov0_cell.tiff", "fov1_plaque.tiff"):
        (src / f).write_text(f)
    dst = tmp_path / "dst"
    TUTIL.find_and_copy_files(["plaque"], str(tmp_path / "src"), str(dst))
    assert sorted(os.listdir(dst)) == ["fov0_Plaque.tiff", "fov1_plaque.tiff"]
    TUTIL.log_creator({"a": 1, "b": [2, 3]}, str(tmp_path), "log.txt")
    JUTIL.log_creator({"a": 1, "b": [2, 3]}, str(tmp_path), "log_jax.txt")
    assert (tmp_path / "log.txt").read_text() == (tmp_path / "log_jax.txt").read_text()


def test_create_mantis_project(tmp_path):
    pytest.importorskip("tqdm")
    data_dir = tmp_path / "imgs"
    test_utils.create_image_cohort(str(data_dir), ["fov0", "fov1"], ["a"], shape=(16, 16))
    seg = tmp_path / "seg" / "objects"
    seg.mkdir(parents=True)
    save_image(str(seg / "fov0_plaque.tiff"), np.ones((16, 16), np.int32))
    TUTIL.create_mantis_project(["fov0"], str(data_dir), str(tmp_path / "seg"),
                                str(tmp_path / "mantis"))
    assert sorted(os.listdir(tmp_path / "mantis" / "fov0")) == ["a.tiff", "fov0_plaque.tiff"]


def test_ez_seg_display(rng, tmp_path):
    """The display functions; skipped where matplotlib is absent."""
    pytest.importorskip("matplotlib")
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ark_tpu_torch.segmentation.ez_seg import ez_seg_display as TDISP

    fov = "fov0"
    img_dir = tmp_path / "imgs"
    (img_dir / fov).mkdir(parents=True)
    save_image(str(img_dir / fov / "chan.tiff"),
               (rng.random((32, 32)) * 255).astype(np.float32))
    obj_dir, cell_dir, merged_dir = (tmp_path / d for d in ("objs", "cells", "merged"))
    for d in (obj_dir, cell_dir, merged_dir):
        d.mkdir()
    obj = np.zeros((32, 32), np.int32)
    obj[4:12, 4:12] = 1
    cell = np.zeros((32, 32), np.int32)
    cell[18:26, 18:26] = 1
    save_image(str(obj_dir / f"{fov}_plaque.tiff"), obj)
    save_image(str(cell_dir / f"{fov}_whole_cell.tiff"), cell)
    save_image(str(merged_dir / f"{fov}_plaque_merged.tiff"), obj + 2 * cell)

    TDISP.display_channel_image(str(img_dir), None, fov, "chan")
    TDISP.overlay_mask_outlines(fov, "chan", str(img_dir), None, "plaque", str(obj_dir),
                                device="cpu")
    args = (fov, "plaque", str(obj_dir), str(cell_dir), "whole_cell", str(merged_dir))
    visual = TDISP.create_overlap_and_merge_visual(*args, device="cpu")
    np.testing.assert_array_equal(visual, JDISP.create_overlap_and_merge_visual(*args))
    assert (visual[6, 6] == (225, 0, 0)).all() and visual[22, 22, 2] == 255
    assert (visual[..., 1] == 255).any()
    TDISP.multiple_mask_display(*args, device="cpu")
    plt.close("all")
