"""The port's signal and cell-type masks (ark_tpu_torch.utils.masking_utils)
against the JAX package's, on the CPU, on the same seeded files.

The masks end in a threshold and integer labels (ez_seg's
``_create_object_mask``), so they are held equal, as arrays and as files;
the test images keep their pixels away from the thresholds, as the ez_seg
tests do.
"""

import os

import numpy as np
import pandas as pd
import pytest
import torch

from ark_tpu.io.image_utils import read_image, save_image
from ark_tpu.utils import masking_utils as JM
from ark_tpu_torch.utils import masking_utils as TM

torch.set_num_threads(2)


def _segmentation(seed, size=96, n_cells=40):
    """Square cells on a grid with gaps, ids in random order."""
    rng = np.random.default_rng(seed)
    seg = np.zeros((size, size), np.int32)
    ids = rng.permutation(n_cells) + 1
    cells = [(r, c) for r in range(2, size - 10, 12) for c in range(2, size - 10, 12)]
    for i, (r, c) in zip(ids, cells):
        seg[r:r + rng.integers(6, 11), c:c + rng.integers(6, 11)] = i
    return seg, np.sort(ids[:len(cells)])


def _cell_table(fov_ids):
    types = ["tumor", "stroma", "immune"]
    rows = [{"fov": fov, "label": int(i), "cell_meta_cluster": types[i % 3]}
            for fov, ids in fov_ids.items() for i in ids]
    return pd.DataFrame(rows)


@pytest.mark.parametrize("cell_types,sigma,min_area,max_hole", [
    (["tumor"], 1, 0, 10), (["tumor", "immune"], 2, 30, 1000), (["stroma"], 10, 0, 1000),
    (["absent"], 1, 0, 10)])
def test_create_cell_mask_equal(cell_types, sigma, min_area, max_hole):
    seg, ids = _segmentation(1)
    table = _cell_table({"fov0": ids, "fov1": ids})
    args = (seg, table, "fov0", cell_types)
    kw = dict(sigma=sigma, min_object_area=min_area, max_hole_area=max_hole)
    want = JM.create_cell_mask(*args, **kw)
    got = TM.create_cell_mask(*args, device="cpu", **kw)
    assert got.dtype == want.dtype and set(np.unique(got)) <= {0, 1}
    assert bool(got.any()) == (cell_types != ["absent"])
    np.testing.assert_array_equal(got, want)


def test_generate_cell_masks_files_equal(tmp_path):
    fov_ids = {}
    (tmp_path / "segs").mkdir()
    for k, fov in enumerate(["fov0", "fov1"]):
        seg, fov_ids[fov] = _segmentation(10 + k)
        save_image(str(tmp_path / "segs" / f"{fov}_whole_cell.tiff"), seg)
    table = _cell_table(fov_ids)
    JM.generate_cell_masks(str(tmp_path / "segs"), str(tmp_path / "jax"), table,
                           ["tumor"], "tumor_mask", sigma=2, max_hole_area=20)
    TM.generate_cell_masks(str(tmp_path / "segs"), str(tmp_path / "torch"), table,
                           ["tumor"], "tumor_mask", sigma=2, max_hole_area=20,
                           device="cpu")
    for fov in fov_ids:
        got = read_image(str(tmp_path / "torch" / fov / "tumor_mask.tiff"))
        want = read_image(str(tmp_path / "jax" / fov / "tumor_mask.tiff"))
        assert got.dtype == want.dtype and got.any()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("thresh,channels", [(50, ["chan0", "chan1"]), ("auto", ["chan0"]),
                                             (None, ["chan1"])])
def test_generate_signal_masks_files_equal(tmp_path, thresh, channels):
    rng = np.random.default_rng(2)
    yy, xx = np.mgrid[:128, :128]
    for fov in ("fov0", "fov1"):
        os.makedirs(tmp_path / "imgs" / fov)
        img = rng.uniform(0, 0.05, (128, 128)).astype(np.float32)
        cy, cx = rng.integers(40, 90, 2)
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= 30 ** 2] += 5.0
        save_image(str(tmp_path / "imgs" / fov / "chan0.tiff"), img)
        save_image(str(tmp_path / "imgs" / fov / "chan1.tiff"), img * 0.5)
    kw = dict(intensity_thresh_perc=thresh, sigma=1, min_object_area=50, max_hole_area=10)
    JM.generate_signal_masks(str(tmp_path / "imgs"), str(tmp_path / "jax"), channels,
                             "signal", **kw)
    TM.generate_signal_masks(str(tmp_path / "imgs"), str(tmp_path / "torch"), channels,
                             "signal", device="cpu", **kw)
    for fov in ("fov0", "fov1"):
        got = read_image(str(tmp_path / "torch" / fov / "signal.tiff"))
        want = read_image(str(tmp_path / "jax" / fov / "signal.tiff"))
        assert got.dtype == want.dtype and got.any()
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        TM.generate_signal_masks(str(tmp_path / "imgs"), str(tmp_path / "x"), ["nope"],
                                 "signal", device="cpu")
