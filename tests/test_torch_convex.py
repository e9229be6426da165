"""The port's convex-hull geometry against the JAX package's, on the CPU.

Everything here is bitwise: the hull rasters, convex areas and hull
centroids (exact integer sums divided once, and the 1e-3 raster epsilon
keeps the interpolation's rounding out of every pixel decision), the
(mask, hull, origin) crops, and the concavity counts.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ark_tpu.ops import convex as JC
from ark_tpu.segmentation import synthetic
from ark_tpu_torch.ops import convex as TC

torch.set_num_threads(2)


def _cell_grid(rng, n_tiles=16, tile_hw=64, grid=4):
    """Label image with planted elliptical cells in a tile grid."""
    lab = np.zeros((grid * tile_hw, grid * tile_hw), np.int32)
    nxt = 0
    for t in range(n_tiles):
        r, c = divmod(t, grid)
        _, cl, _ = synthetic.synthetic_cells(rng, 1, hw=tile_hw)
        m = cl[0] > 0
        lab[r * tile_hw:(r + 1) * tile_hw,
            c * tile_hw:(c + 1) * tile_hw][m] = cl[0][m] + nxt
        nxt += int(cl[0].max())
    ids = np.unique(lab)
    return lab, ids[ids > 0]


def _concave_cells(rng):
    """Crescents and L-shapes (cells with concavities), one cell wider than
    the 128 tile (the host path), and degenerate cells."""
    lab = np.zeros((300, 300), np.int32)
    yy, xx = np.mgrid[0:40, 0:40]
    nid = 0
    for gy in range(5):
        for gx in range(5):
            r = rng.uniform(10, 16)
            cell = np.sqrt((yy - 20) ** 2 + (xx - 20) ** 2) <= r
            if rng.random() < 0.5:
                cell &= np.sqrt((yy - 20 - rng.uniform(3, 8)) ** 2
                                + (xx - 20 - rng.uniform(0, 6)) ** 2) > r * 0.75
            else:
                cell &= ~((yy > 20) & (xx > 20))
            nid += 1
            lab[gy * 42:gy * 42 + 40, gx * 42:gx * 42 + 40][cell] = nid
    lab[215:222, 5:295] = nid + 1               # bbox 290 > 128: host path
    lab[230:240, 5:15] = nid + 1
    lab[260, 10] = nid + 2                      # single pixel
    lab[270, 10:20] = nid + 3                   # horizontal line
    lab[275:290, 30] = nid + 4                  # vertical line
    ids = np.unique(lab)
    return lab, ids[ids > 0]


def _assert_features_equal(want, got):
    np.testing.assert_array_equal(got["convex_area"], want["convex_area"])
    np.testing.assert_array_equal(got["convex_centroid"], want["convex_centroid"])
    assert len(got["masks"]) == len(want["masks"])
    for wm, gm in zip(want["masks"], got["masks"]):
        if wm is None:
            assert gm is None
            continue
        np.testing.assert_array_equal(gm[0], wm[0])    # mask crop
        np.testing.assert_array_equal(gm[1], wm[1])    # hull raster
        assert gm[2] == wm[2]                           # origin


@pytest.mark.parametrize("impl", ["auto", "host"])
@pytest.mark.parametrize("with_masks", [True, False])
@pytest.mark.parametrize("cells", ["grid", "concave"])
def test_convex_features_match_jax(impl, with_masks, cells):
    rng = np.random.default_rng(3)
    lab, ids = _cell_grid(rng) if cells == "grid" else _concave_cells(rng)
    want = JC.convex_features(lab, ids, impl=impl, with_masks=with_masks)
    got = TC.convex_features(lab, ids, impl=impl, with_masks=with_masks,
                             device="cpu")
    _assert_features_equal(want, got)


def test_convex_features_subset_absent_ids_and_empty_fov():
    rng = np.random.default_rng(4)
    lab, ids = _cell_grid(rng, n_tiles=4, grid=2)
    subset = np.concatenate([ids[:3], [99999], ids[5:8]])
    want = JC.convex_features(lab, subset)
    got = TC.convex_features(lab, subset, device="cpu")
    _assert_features_equal(want, got)
    assert got["convex_area"][3] == 0.0 and got["masks"][3] is None
    empty = TC.convex_features(np.zeros((16, 16), np.int32), np.array([1, 2]),
                               device="cpu")
    assert empty["convex_area"].tolist() == [0.0, 0.0]


def test_hull_raster_matches_jax_per_tile():
    """The (B, T, T, T) envelope raster on row extremes, at every tile
    grade, including empty rows and a cell using the whole tile."""
    rng = np.random.default_rng(5)
    for tile in TC._TILE_GRADES:
        xlo = np.full((6, tile), np.inf, np.float32)
        xhi = np.full((6, tile), -np.inf, np.float32)
        for b in range(6):
            rows = rng.random(tile) < 0.7
            lo = rng.integers(0, tile, tile)
            hi = np.minimum(lo + rng.integers(0, tile, tile), tile - 1)
            xlo[b, rows], xhi[b, rows] = lo[rows], hi[rows]
        xlo[5], xhi[5] = 0, tile - 1
        want = JC._hull_raster_device(jnp.asarray(xlo), jnp.asarray(xhi), tile)
        got = TC._hull_raster_device(torch.as_tensor(xlo), torch.as_tensor(xhi), tile)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_concavity_counts_match_jax():
    lab, ids = _concave_cells(np.random.default_rng(6))
    masks = TC.convex_features(lab, ids, device="cpu")["masks"]
    kwargs = dict(small_concavity_minimum=5, max_compactness=40,
                  large_concavity_minimum=60)
    for kw in ({}, kwargs):
        got = TC.count_concavities_batch(masks, **kw)
        np.testing.assert_array_equal(got, JC.count_concavities_batch(masks, **kw))
        per_cell = [TC.count_concavities(m[0], m[1], **kw) if m else 0 for m in masks]
        assert per_cell == [JC.count_concavities(m[0], m[1], **kw) if m else 0
                            for m in masks]
        np.testing.assert_array_equal(got, per_cell)
    assert got.sum() > 0
    assert TC.count_concavities_batch([None, None]).tolist() == [0, 0]


def test_host_helpers_match_jax():
    lab, ids = _concave_cells(np.random.default_rng(8))
    want, got = JC.group_coords_by_label(lab), TC.group_coords_by_label(lab)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        for w, g in zip(JC.convex_image(want[k]), TC.convex_image(got[k])):
            np.testing.assert_array_equal(g, w)
        m = lab == k
        assert TC.crofton_perimeter_np(m) == JC.crofton_perimeter_np(m)
    assert TC.group_coords_by_label(np.zeros((4, 4), np.int32)) == {}
