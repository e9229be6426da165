"""Per-cell convex-hull geometry: convex area, hull centroid, concavities.

Port of ``ark_tpu/ops/convex.py``. The hull raster of every cell whose
bounding box fits a 128 tile comes from the row-envelope identity, as torch
tensor ops on `device`: every hull vertex is a row-extreme point, so the
hull's x-interval at row y is the max (min) over occupied rows i <= y <= j
of the linear interpolation of the rows' right (left) extremes, a masked
(B, T, T, T) max. Interpolated values are multiples of 1/(j - i) >= 1/T, so
the 1e-3 epsilon makes the pixel-centre test exact and the rasters, areas
and hull centroids equal the JAX package's bit for bit. Cells with a bounding
box over 128 take the host path (scipy ``ConvexHull`` and a half-plane test,
``convex_image``); so does ``impl='host'``. The concavity counts are host
``scipy.ndimage`` labeling. The JAX package pads each chunk of cells to one
size so that XLA compiles one executable per tile; eager torch needs no
padding, and the port drops it.

``COUNTS`` holds cumulative counters, read as differences around a call:
``device_cells`` and ``host_cells``, the cells ``convex_features`` rastered
on the device and on the host (a box over 128, or ``impl='host'``), and
``crops``, the hull-minus-mask crops ``count_concavities_batch`` labeled.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

COUNTS = {"device_cells": 0, "host_cells": 0, "crops": 0}


def group_coords_by_label(labels: np.ndarray) -> Dict[int, np.ndarray]:
    """{label: (n_i, 2) pixel coords}, computed with one argsort."""
    flat = labels.reshape(-1)
    nz = np.flatnonzero(flat)
    if nz.size == 0:
        return {}
    order = nz[np.argsort(flat[nz], kind="stable")]
    sorted_labels = flat[order]
    boundaries = np.flatnonzero(np.diff(sorted_labels)) + 1
    groups = np.split(order, boundaries)
    w = labels.shape[1]
    out = {}
    for g in groups:
        lab = int(flat[g[0]])
        out[lab] = np.stack([g // w, g % w], axis=1)
    return out


def convex_image(coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray, Tuple[int, int]]:
    """(mask_image, hull_image, bbox_origin) for one cell's pixel coords:
    the hull rasterized over the cell's bounding box (pixel centres inside
    or on the hull), skimage's `convex_image` semantics."""
    rmin, cmin = coords.min(0)
    rmax, cmax = coords.max(0)
    h, w = rmax - rmin + 1, cmax - cmin + 1
    local = coords - np.array([rmin, cmin])
    mask = np.zeros((h, w), bool)
    mask[local[:, 0], local[:, 1]] = True

    hull_img = mask.copy()
    if len(coords) >= 3:
        from scipy.spatial import ConvexHull, QhullError
        try:
            hull = ConvexHull(local.astype(float))
        except QhullError:
            hull = None           # degenerate (collinear) cells: hull == mask
        if hull is not None:
            # half-plane test: a point is inside iff every eq . [p, 1] <= tol
            yy, xx = np.mgrid[:h, :w]
            pts = np.stack([yy.ravel(), xx.ravel(), np.ones(h * w)], axis=1)
            inside = (pts @ hull.equations.T <= 1e-9).all(axis=1)
            hull_img = inside.reshape(h, w) | mask
    return mask, hull_img, (int(rmin), int(cmin))


def _hull_raster_device(xlo: torch.Tensor, xhi: torch.Tensor, tile: int):
    """Batched hull rasters from per-row extremes, on the tensors' device.

    xlo/xhi: (B, T) f32 min/max pixel column per bbox-local row (+inf/-inf
    where the row has no pixels). Returns (raster (B, T, T) bool, area (B,),
    cy (B,), cx (B,)), the centroids in bbox-local coords."""
    t = tile
    idx = torch.arange(t, dtype=torch.float32, device=xlo.device)
    ii = idx[:, None, None]   # i: lower row of the pair
    jj = idx[None, :, None]   # j: upper row
    yy = idx[None, None, :]   # y: query row
    denom = torch.clamp_min(jj - ii, 1.0)
    # the degenerate pair i == j (valid only at y == i) must yield the row's
    # own extreme, not 0*x + 0*x
    ci = torch.where(ii == jj, 1.0, (jj - yy) / denom)
    cj = torch.where(ii == jj, 0.0, (yy - ii) / denom)
    span = (ii <= yy) & (yy <= jj)                                  # (T, T, T)

    valid = xhi > -torch.inf                                        # (B, T)
    ok = span[None] & valid[:, :, None, None] & valid[:, None, :, None]
    xl0 = torch.where(valid, xlo, 0.0)                              # keep inf out of *
    xh0 = torch.where(valid, xhi, 0.0)
    hi_cand = ci * xh0[:, :, None, None] + cj * xh0[:, None, :, None]
    hi = torch.where(ok, hi_cand, -torch.inf).amax(dim=(1, 2))      # (B, T)
    del hi_cand
    lo_cand = ci * xl0[:, :, None, None] + cj * xl0[:, None, :, None]
    lo = torch.where(ok, lo_cand, torch.inf).amin(dim=(1, 2))
    del lo_cand, ok
    cols = idx[None, None, :]
    raster = (cols >= lo[:, :, None] - 1e-3) & (cols <= hi[:, :, None] + 1e-3)
    area = raster.sum(dim=(1, 2)).to(torch.float32)
    safe = torch.clamp_min(area, 1.0)
    cy = (raster * idx[None, :, None]).sum(dim=(1, 2)) / safe
    cx = (raster * cols).sum(dim=(1, 2)) / safe
    return raster, area, cy, cx


_MAX_TILE = 128
# tile sizes graded finer than powers of two: the (T, T, T) envelope tensor
# makes a snug tile worth ~2x over the next pow2
_TILE_GRADES = (12, 16, 24, 32, 48, 64, 96, 128)


def convex_features(labels: np.ndarray, cell_ids: np.ndarray,
                    impl: str = "auto", with_masks: bool = True, *,
                    device) -> Dict[str, np.ndarray]:
    """Per-cell convex_area and convex centroid (global coords), aligned
    with `cell_ids`, plus the (mask, hull, origin) crops under `masks` for
    the concavity count.

    impl='auto' rasterizes cells with a bounding box up to 128 on `device`
    (bucketed by box size into graded tiles) and the rest on the host;
    'host' takes the per-cell scipy path for every cell. `with_masks=False`
    skips the per-cell crop assembly and returns masks=[None]*n."""
    if impl == "host":
        COUNTS["host_cells"] += len(cell_ids)
        return _convex_features_host(labels, cell_ids)
    uniq_ids, inverse = np.unique(cell_ids, return_inverse=True)
    if len(uniq_ids) < len(cell_ids):
        # an id asked for twice (a nucleus that is two cells' best match):
        # rastered once, its outputs repeated
        out = convex_features(labels, uniq_ids, impl, with_masks, device=device)
        return {"convex_area": out["convex_area"][inverse],
                "convex_centroid": out["convex_centroid"][inverse],
                "masks": [out["masks"][i] for i in inverse]}

    n = len(cell_ids)
    convex_area = np.zeros(n)
    conv_cent = np.zeros((n, 2))
    masks: List = [None] * n

    # one sort of the foreground pixels gives the per-cell bounding boxes
    # and the per-(cell, row) column extremes (reduceat over runs)
    hh, ww = labels.shape
    flat = labels.reshape(-1)
    nz = np.flatnonzero(flat)
    if nz.size == 0:
        return {"convex_area": convex_area, "convex_centroid": conv_cent,
                "masks": masks}
    order = np.argsort(flat[nz], kind="stable")
    snz = nz[order]
    slabs = flat[nz][order]
    ys = (snz // ww).astype(np.int64)
    xs = (snz % ww).astype(np.int64)
    starts = np.r_[0, np.flatnonzero(np.diff(slabs)) + 1]
    counts = np.diff(np.r_[starts, len(slabs)])
    uniq = np.asarray(slabs[starts])
    ymin = np.minimum.reduceat(ys, starts)
    ymax = np.maximum.reduceat(ys, starts)
    xmin = np.minimum.reduceat(xs, starts)
    xmax = np.maximum.reduceat(xs, starts)
    hs = ymax - ymin + 1
    ws = xmax - xmin + 1

    # per-(cell, row) column extremes: runs of the composite (cell, y) key
    inv = np.repeat(np.arange(len(uniq)), counts)
    comp = inv * hh + ys
    o2 = np.argsort(comp, kind="stable")
    comp_s = comp[o2]
    xs2 = xs[o2]
    rstarts = np.r_[0, np.flatnonzero(np.diff(comp_s)) + 1]
    run_cell = comp_s[rstarts] // hh           # dense cell index into uniq
    run_ly = comp_s[rstarts] % hh - ymin[run_cell]
    run_xmin = np.minimum.reduceat(xs2, rstarts) - xmin[run_cell]
    run_xmax = np.maximum.reduceat(xs2, rstarts) - xmin[run_cell]

    # requested cell_ids -> dense index (or -1 when absent)
    pos_of = np.searchsorted(uniq, cell_ids)
    pos_of = np.where(
        (pos_of < len(uniq)) & (uniq[np.minimum(pos_of, len(uniq) - 1)]
                                == cell_ids), pos_of, -1)
    out_of_dense = np.full(len(uniq), -1)      # dense idx -> output row
    sel = pos_of >= 0
    out_of_dense[pos_of[sel]] = np.flatnonzero(sel)

    def cell_coords(dense_idx):
        sl = slice(starts[dense_idx], starts[dense_idx] + counts[dense_idx])
        return np.stack([ys[sl], xs[sl]], axis=1)

    dims = np.maximum(hs, ws)
    for d_idx in np.flatnonzero(dims > _MAX_TILE):     # oversized: host path
        i = out_of_dense[d_idx]
        if i < 0:
            continue
        mask, hull, _ = convex_image(cell_coords(d_idx))
        _fill_outputs(i, mask, hull, (int(ymin[d_idx]), int(xmin[d_idx])),
                      convex_area, conv_cent, masks)
        COUNTS["host_cells"] += 1

    tile_of = np.full(len(uniq), 0)
    for t in _TILE_GRADES[::-1]:
        tile_of[dims <= t] = t
    tile_of[dims > _MAX_TILE] = 0
    tile_of[out_of_dense < 0] = 0              # not requested

    for tile in _TILE_GRADES:
        members = np.flatnonzero(tile_of == tile)
        if members.size == 0:
            continue
        b = len(members)
        COUNTS["device_cells"] += b
        bpos = np.full(len(uniq), -1)          # bucket-local position
        bpos[members] = np.arange(b)
        xlo = np.full((b, tile), np.inf, np.float32)
        xhi = np.full((b, tile), -np.inf, np.float32)
        rsel = bpos[run_cell] >= 0
        xlo[bpos[run_cell[rsel]], run_ly[rsel]] = run_xmin[rsel]
        xhi[bpos[run_cell[rsel]], run_ly[rsel]] = run_xmax[rsel]
        # chunks keep each (Bc, T, T, T) interpolation tensor near 32 MB
        chunk = max(1, (1 << 23) // (tile ** 3))
        for c0 in range(0, b, chunk):
            sl = slice(c0, min(c0 + chunk, b))
            raster, area, cy, cx = _hull_raster_device(
                torch.as_tensor(xlo[sl], device=device),
                torch.as_tensor(xhi[sl], device=device), tile)
            area = area.cpu().numpy()
            cy, cx = cy.cpu().numpy(), cx.cpu().numpy()
            mem = members[sl]
            out_rows = out_of_dense[mem]
            convex_area[out_rows] = area
            conv_cent[out_rows, 0] = cy + ymin[mem]
            conv_cent[out_rows, 1] = cx + xmin[mem]
            if with_masks:
                raster = raster.cpu().numpy()
                for j, d_idx in enumerate(mem):
                    coords = cell_coords(d_idx)
                    origin = (int(ymin[d_idx]), int(xmin[d_idx]))
                    local = coords - np.array(origin)
                    mask = np.zeros((int(hs[d_idx]), int(ws[d_idx])), bool)
                    mask[local[:, 0], local[:, 1]] = True
                    hull = raster[j, :hs[d_idx], :ws[d_idx]] | mask
                    masks[out_rows[j]] = (mask, hull, origin)
    return {"convex_area": convex_area, "convex_centroid": conv_cent,
            "masks": masks}


def _fill_outputs(i, mask, hull, origin, convex_area, conv_cent, masks):
    convex_area[i] = hull.sum()
    cy, cx = np.nonzero(hull)
    conv_cent[i] = [cy.mean() + origin[0], cx.mean() + origin[1]]
    masks[i] = (mask, hull, origin)


def _convex_features_host(labels: np.ndarray,
                          cell_ids: np.ndarray) -> Dict[str, np.ndarray]:
    """Host path: per-cell scipy ConvexHull and half-plane raster."""
    groups = group_coords_by_label(labels)
    n = len(cell_ids)
    convex_area = np.zeros(n)
    conv_cent = np.zeros((n, 2))
    masks: List = [None] * n
    for i, cid in enumerate(cell_ids):
        coords = groups.get(int(cid))
        if coords is None:
            continue
        mask, hull, origin = convex_image(coords)
        _fill_outputs(i, mask, hull, origin, convex_area, conv_cent, masks)
    return {"convex_area": convex_area, "convex_centroid": conv_cent,
            "masks": masks}


def crofton_perimeter_np(mask: np.ndarray) -> float:
    """Host Cauchy-Crofton perimeter of one binary mask (the estimator of
    ``segment_reduce.crofton_perimeter``)."""
    m = np.pad(mask.astype(np.int8), 1)
    n_h = np.count_nonzero(m[:, :-1] != m[:, 1:])
    n_v = np.count_nonzero(m[:-1, :] != m[1:, :])
    n_d1 = np.count_nonzero(m[:-1, :-1] != m[1:, 1:])
    n_d2 = np.count_nonzero(m[:-1, 1:] != m[1:, :-1])
    return float(np.pi / 4.0 * (n_h + n_v + (n_d1 + n_d2) / np.sqrt(2)) / 2.0)


def count_concavities_batch(masks: List, small_concavity_minimum: float = 10,
                            max_compactness: float = 60,
                            large_concavity_minimum: float = 150
                            ) -> np.ndarray:
    """`count_concavities` over a whole FOV in one pass: every cell's
    hull-minus-mask crop stacked into one zero-separated canvas, labeled by
    one ``scipy.ndimage.label`` call, with per-component area and Crofton
    perimeter from vectorized crossing counts (the per-cell loop's values).
    masks: list of (mask, hull, origin) or None, as `convex_features` gives."""
    import scipy.ndimage as ndi

    out = np.zeros(len(masks))
    crops = [(i, m[1] ^ m[0]) for i, m in enumerate(masks) if m is not None]
    crops = [(i, d) for i, d in crops if d.any()]
    COUNTS["crops"] += len(crops)
    if not crops:
        return out
    maxw = max(d.shape[1] for _, d in crops)
    heights = [d.shape[0] for _, d in crops]
    total_h = sum(heights) + len(crops) + 1
    canvas = np.zeros((total_h, maxw + 2), bool)
    row_cell = np.full(total_h, -1)            # canvas row -> cell index
    y = 1
    for (i, d), h in zip(crops, heights):
        canvas[y:y + h, 1:1 + d.shape[1]] = d
        row_cell[y:y + h] = i
        y += h + 1

    lab, n = ndi.label(canvas, structure=np.array([[0, 1, 0],
                                                   [1, 1, 1],
                                                   [0, 1, 0]]))
    if n == 0:
        return out
    areas = np.bincount(lab.ravel(), minlength=n + 1)[1:]

    # every adjacent pair with different labels is one crossing for each
    # nonzero side (the per-component counting of crofton_perimeter_np)
    def crossings(a, b):
        diff = a != b
        cnt = np.zeros(n + 1, np.int64)
        np.add.at(cnt, a[diff], 1)
        np.add.at(cnt, b[diff], 1)
        return cnt[1:]

    n_h = crossings(lab[:, :-1], lab[:, 1:])
    n_v = crossings(lab[:-1, :], lab[1:, :])
    n_d1 = crossings(lab[:-1, :-1], lab[1:, 1:])
    n_d2 = crossings(lab[:-1, 1:], lab[1:, :-1])
    perim = np.pi / 4.0 * (n_h + n_v + (n_d1 + n_d2) / np.sqrt(2)) / 2.0
    with np.errstate(divide="ignore", invalid="ignore"):
        compactness = perim ** 2 / areas
    keep = ((areas > small_concavity_minimum)
            & (compactness < max_compactness)) \
        | (areas > large_concavity_minimum)

    # component -> cell via the row of its first pixel
    first_row = np.full(n + 1, total_h, np.int64)
    rows = np.repeat(np.arange(total_h), canvas.shape[1])
    np.minimum.at(first_row, lab.ravel(), rows)
    comp_cell = row_cell[np.minimum(first_row[1:], total_h - 1)]
    for c in np.flatnonzero(keep):
        out[comp_cell[c]] += 1
    return out


def count_concavities(mask: np.ndarray, hull: np.ndarray,
                      small_concavity_minimum: float = 10,
                      max_compactness: float = 60,
                      large_concavity_minimum: float = 150) -> int:
    """Number of meaningful concavities of one cell: components of
    hull-minus-mask passing the (area, compactness) thresholds."""
    import scipy.ndimage as ndi

    diff = hull ^ mask
    if diff.sum() == 0:
        return 0
    lab, n = ndi.label(diff, structure=np.array([[0, 1, 0],
                                                 [1, 1, 1],
                                                 [0, 1, 0]]))
    count = 0
    for comp in range(1, n + 1):
        comp_mask = lab == comp
        area = comp_mask.sum()
        perim = crofton_perimeter_np(comp_mask)
        compactness = perim ** 2 / area
        if (area > small_concavity_minimum and compactness < max_compactness) \
                or area > large_concavity_minimum:
            count += 1
    return count
