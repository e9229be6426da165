"""Label images, flat ids and values for the segment sum's tests: the CPU
parity tests (tests/test_torch_segment_reduce.py) and their card twins
(tests/test_torch_cuda.py). Imports no jax."""

import numpy as np
import torch

import chip_smoke
from chip_smoke import dense_masks

# one group of 8 columns or fewer (1, 3, 8), across a group (9), the cell
# table's 44 (5.5 groups) and past the walk's 128-column tile (130)
K_VALUES = (1, 3, 8, 9, 44, 130)
IMAGE_KINDS = ("background_42pct", "all_background", "no_background")
FLAT_KINDS = ("heads", "sorted_hubs", "unsorted", "out_of_range")


def label_image(kind, size=96):
    """(size, size) int32 labels: touching Voronoi cells with ~42% of the
    pixels in the background (a dense FOV's share), no cell at all, or
    cells over every pixel."""
    if kind == "all_background":
        return np.zeros((size, size), np.int32)
    if kind == "background_42pct":
        lab = dense_masks(seed=5, n_fovs=1, size=size, n_cells=54, cell_radius=7)
    else:
        lab = dense_masks(seed=6, n_fovs=1, size=size, n_cells=40, cell_radius=4 * size)
    return lab["whole_cell"][0]


def flat_ids(kind, n_points=300, per=15, seed=0):
    """(ids (n_points * per,) int32, num_segments), as UMAP's epoch sums
    them: each point `per` times in order (the heads), ids drawn with hubs
    (a tenth of the points take half of them) and stably sorted, the same
    in no order, and in no order with 5% of them -1 or n_points (dropped)."""
    rng = np.random.default_rng(seed)
    if kind == "heads":
        return np.repeat(np.arange(n_points, dtype=np.int32), per), n_points
    hubs = rng.choice(n_points, size=n_points // 10, replace=False)
    n = n_points * per
    ids = np.where(rng.random(n) < 0.5, rng.choice(hubs, size=n),
                   rng.integers(0, n_points, n)).astype(np.int32)
    if kind == "sorted_hubs":
        return np.sort(ids, kind="stable"), n_points
    ids = rng.permutation(ids)
    if kind == "out_of_range":
        hit = rng.random(n) < 0.05
        ids[hit] = np.where(rng.random(int(hit.sum())) < 0.5, -1, n_points)
    return ids, n_points


def values(n, k, seed=0, special=False):
    """(n, k) float32 values; with `special`, 2% each of NaN, +inf and -inf,
    and a last column of -0.0 only (its sums are +0.0: the adds start from
    +0.0)."""
    rng = np.random.default_rng(seed)
    vals = rng.gamma(1.0, 3.0, (n, k)).astype(np.float32)
    if special:
        vals = rng.normal(size=(n, k)).astype(np.float32)
        for value in (np.nan, np.inf, -np.inf):
            vals[rng.random(vals.shape) < 0.02] = value
        vals[:, -1] = -0.0
    return vals


def same_bits(got, want):
    """chip_smoke.same_bits on arrays or tensors: bitwise equal, NaN where
    the other has NaN."""
    return bool(chip_smoke.same_bits(torch.as_tensor(np.asarray(got)),
                                     torch.as_tensor(np.asarray(want))))
