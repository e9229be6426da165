"""Plain template-1 cell table (ark-analysis ``marker_quantification.
generate_cell_table`` with nuclear counts), and the judge that holds a job's
two CSVs to it.

Per FOV, from the in-memory channel counts (H, W, C) and the whole-cell and
nuclear label images, in float64 on the host:

1. cells: the whole-cell mask's nonzero labels, ascending. A cell's nucleus
   is the nucleus with the most pixels inside the cell, a tie going to the
   lowest nucleus id (ark's ``find_nuclear_label_id``: ``np.argmax`` over
   ``np.unique``'s ascending ids); a cell that no nucleus touches has none;
2. per compartment (the cell's pixels; all pixels of its nucleus, inside
   the cell or not): ``cell_size`` (pixels), each channel's total counts,
   and the regionprops: ``area``; ``centroid-0/1``, the mean pixel row and
   column; ``major_axis_length`` and ``minor_axis_length``, 4 sqrt of the
   eigenvalues of the central second moments over the area (skimage's
   inertia tensor), and ``eccentricity``, sqrt(1 - l2 / l1) (0 where
   l1 = 0); ``equivalent_diameter``, sqrt(4 area / pi); ``perimeter``;
   ``convex_area``; the derived ``major_minor_axis_ratio``,
   ``perim_square_over_area``, ``major_axis_equiv_diam_ratio``,
   ``convex_hull_resid`` ((convex area - area) / convex area),
   ``centroid_dif`` (the distance from the pixels' centroid to the hull's,
   over sqrt(area)) and ``num_concavities`` (components of hull minus mask,
   4-connected, counted where area > 10 and perimeter^2 / area < 60, or area
   > 150); ``nc_ratio``, the nucleus's area over the cell's (0 without a
   nucleus), in both compartments;
3. a row a cell: the whole-cell columns, the nuclear ones suffixed
   ``_nuclear`` (all 0 without a nucleus), ``fov`` and ``mask_type``. The
   size-normalized table divides the channel columns by ``cell_size``; the
   arcsinh table takes arcsinh(100 x) of those.

Departures from ark-analysis's definitions, where the program states one of
its own (``ark_tpu_torch/ops/segment_reduce.py``'s perimeter,
``ark_tpu_torch/ops/convex.py``'s hull raster); this file implements the
program's definition, independently of its code:

- ``perimeter`` is the 4-direction Cauchy-Crofton estimate: over every pixel
  of the region, (pi / 8)(s + d / sqrt 2), with s its 4 straight and d its 4
  diagonal neighbours outside the region, the image's border counting as
  outside; skimage's ``perimeter`` weighs boundary pixels by their
  4-neighbourhood configuration instead;
- the convex hull (``convex_area``, ``convex_hull_resid``, the hull's
  centroid in ``centroid_dif``, the crops of ``num_concavities``) is the set
  of pixels whose centres lie inside or on the convex hull of the region's
  pixel centres (here Andrew's monotone chain and exact integer cross
  products); skimage's ``convex_hull_image`` takes the hull of the pixels'
  corners, which holds more pixels;
- ``num_concavities`` measures each component's compactness with the
  Crofton perimeter above, not skimage's ``perimeter``;
- ``major_minor_axis_ratio`` is NaN where the minor axis is 0 (ark's
  division gives inf there).

``dtype="bfloat16"`` is the control one precision below the configuration's
float32: every channel sum, the centroids and the central moments and the
perimeter sums stored in bfloat16 (the inputs cast to it, each sum
accumulated in float32 and rounded), the rest as above.

Imports nothing of the program. What the judge reads of a job is its CSVs.
"""

from __future__ import annotations

import math
import os

import numpy as np
import pandas as pd
import scipy.ndimage as ndi
import torch

NORM_CSV = "cell_table_size_normalized.csv"
ARCSINH_CSV = "cell_table_arcsinh_transformed.csv"
PROPS = ["label", "area", "eccentricity", "major_axis_length", "minor_axis_length",
         "perimeter", "convex_area", "equivalent_diameter", "centroid-0", "centroid-1",
         "major_minor_axis_ratio", "perim_square_over_area", "major_axis_equiv_diam_ratio",
         "convex_hull_resid", "centroid_dif", "num_concavities", "nc_ratio"]
# every numeric column but the ids, the channels, cell_size and the counts
MORPH = [p for p in PROPS if p not in ("label", "num_concavities")]
SMALL_CONCAVITY, MAX_COMPACTNESS, LARGE_CONCAVITY = 10, 60, 150
CROSS = np.array([[0, 1, 0], [1, 1, 1], [0, 1, 0]])
STRAIGHT = ((0, 1), (0, -1), (1, 0), (-1, 0))
DIAGONAL = ((1, 1), (1, -1), (-1, 1), (-1, -1))


def columns(channels) -> list:
    """The tables' columns, in order."""
    one = ["cell_size", *channels, *PROPS]
    return one + [c + "_nuclear" for c in one] + ["fov", "mask_type"]


def _stored(x: np.ndarray, dtype) -> np.ndarray:
    """`x` as float64, after a round trip through `dtype` (None keeps it)."""
    if dtype is None:
        return np.asarray(x, np.float64)
    return torch.as_tensor(np.asarray(x, np.float32)).to(getattr(torch, dtype)) \
        .to(torch.float64).numpy()


def _sums(values: np.ndarray, labels: np.ndarray, n: int, dtype) -> np.ndarray:
    """(n, K) per-label sums of the (P, K) `values` over the P pixels with
    `labels`: float64, or the control's rounding (inputs in `dtype`, float32
    accumulation, the sums stored in `dtype`)."""
    idx = torch.as_tensor(labels, dtype=torch.int64)
    if dtype is None:
        v = torch.as_tensor(np.asarray(values, np.float64))
        return torch.zeros((n, v.shape[1]), dtype=torch.float64).index_add_(0, idx, v).numpy()
    v = torch.as_tensor(np.asarray(values, np.float32)).to(getattr(torch, dtype)) \
        .to(torch.float32)
    out = torch.zeros((n, v.shape[1]), dtype=torch.float32).index_add_(0, idx, v)
    return _stored(out.numpy(), dtype)


def crofton_weights(labels: np.ndarray) -> np.ndarray:
    """(H, W): (pi / 8)(s + d / sqrt 2) for each pixel, s and d its straight
    and diagonal neighbours with another label (0 beyond the border)."""
    h, w = labels.shape
    pad = np.pad(labels, 1)
    s = sum((pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] != labels).astype(np.float64)
            for dy, dx in STRAIGHT)
    d = sum((pad[1 + dy:h + 1 + dy, 1 + dx:w + 1 + dx] != labels).astype(np.float64)
            for dy, dx in DIAGONAL)
    return math.pi / 8.0 * (s + d / math.sqrt(2.0))


def _hull(points: list) -> list:
    """Andrew's monotone chain: the hull's vertices of integer (x, y) points,
    counter-clockwise, collinear points dropped."""
    pts = sorted(set(points))
    if len(pts) <= 2:
        return pts

    def cross(o, a, b):
        return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0])

    lower, upper = [], []
    for p in pts:
        while len(lower) >= 2 and cross(lower[-2], lower[-1], p) <= 0:
            lower.pop()
        lower.append(p)
    for p in reversed(pts):
        while len(upper) >= 2 and cross(upper[-2], upper[-1], p) <= 0:
            upper.pop()
        upper.append(p)
    return lower[:-1] + upper[:-1]


def hull_raster(mask: np.ndarray) -> np.ndarray:
    """The pixels of the box whose centres lie inside or on the convex hull
    of `mask`'s pixel centres, by exact integer cross products."""
    h, w = mask.shape
    rows = np.flatnonzero(mask.any(axis=1))
    left = mask[rows].argmax(axis=1)
    right = w - 1 - mask[rows, ::-1].argmax(axis=1)
    # only a row's two ends can be vertices
    verts = _hull([(int(x), int(y)) for y, x in zip(rows, left)]
                  + [(int(x), int(y)) for y, x in zip(rows, right)])
    yy, xx = np.mgrid[:h, :w]
    inside = np.ones((h, w), bool)
    for (x1, y1), (x2, y2) in zip(verts, verts[1:] + verts[:1]):
        if (x1, y1) != (x2, y2):
            inside &= (x2 - x1) * (yy - y1) - (y2 - y1) * (xx - x1) >= 0
    return inside | mask


def concavities(mask: np.ndarray, hull: np.ndarray) -> int:
    """Components of hull minus mask (4-connected) with area > 10 and
    Crofton perimeter^2 / area < 60, or area > 150."""
    diff = hull & ~mask
    if diff.sum() <= SMALL_CONCAVITY:       # no component can pass
        return 0
    lab, n = ndi.label(diff, structure=CROSS)
    area = np.bincount(lab.ravel(), minlength=n + 1)[1:].astype(np.float64)
    perim = np.bincount(lab.ravel(), weights=crofton_weights(lab).ravel(),
                        minlength=n + 1)[1:]
    compact = perim ** 2 / area
    keep = ((area > SMALL_CONCAVITY) & (compact < MAX_COMPACTNESS)) | (area > LARGE_CONCAVITY)
    return int(keep.sum())


def region_features(counts: np.ndarray, labels: np.ndarray, ids: np.ndarray,
                    dtype=None) -> dict:
    """{column: (len(ids),) float64} of the regions `ids` of `labels` ((H, W)
    ints) over `counts` ((H, W, C)): ``cell_size``, ``channels`` ((n, C)) and
    every prop but ``label`` and ``nc_ratio``."""
    h, w = labels.shape
    flat = labels.ravel().astype(np.int64)
    fg = np.flatnonzero(flat)
    lab = flat[fg]
    n = int(flat.max()) + 1 if flat.size else 1
    rr, cc = (fg // w).astype(np.float64), (fg % w).astype(np.float64)
    area = np.bincount(lab, minlength=n).astype(np.float64)
    safe = np.maximum(area, 1.0)
    chans = _sums(counts.reshape(-1, counts.shape[-1])[fg], lab, n, dtype)
    first = _sums(np.stack([rr, cc], 1), lab, n, dtype)
    cy, cx = _stored(first[:, 0] / safe, dtype), _stored(first[:, 1] / safe, dtype)
    dy, dx = rr - cy[lab], cc - cx[lab]
    second = _sums(np.stack([dy * dy, dx * dx, dy * dx,
                             crofton_weights(labels).ravel()[fg]], 1), lab, n, dtype)
    mu20, mu02, mu11 = (second[:, k] / safe for k in range(3))
    eig = np.linalg.eigvalsh(np.stack([np.stack([mu20, mu11], -1),
                                       np.stack([mu11, mu02], -1)], -2))
    l1, l2 = eig[:, 1], np.maximum(eig[:, 0], 0.0)
    with np.errstate(divide="ignore", invalid="ignore"):
        ecc = np.where(l1 > 0, np.sqrt(np.maximum(1.0 - l2 / l1, 0.0)), 0.0)
    f = {"cell_size": area, "area": area, "centroid-0": cy, "centroid-1": cx,
         "major_axis_length": 4.0 * np.sqrt(np.maximum(l1, 0.0)),
         "minor_axis_length": 4.0 * np.sqrt(l2), "eccentricity": ecc,
         "equivalent_diameter": np.sqrt(4.0 * area / math.pi), "perimeter": second[:, 3]}
    f = {k: v[ids] for k, v in f.items()}
    f["channels"] = chans[ids]

    # hulls, cell by cell over its box
    order = np.argsort(lab, kind="stable")
    starts = np.searchsorted(lab[order], ids)
    ends = np.searchsorted(lab[order], ids, side="right")
    conv_area = np.zeros(len(ids))
    hy, hx = np.zeros(len(ids)), np.zeros(len(ids))
    conc = np.zeros(len(ids))
    for i, (s, e) in enumerate(zip(starts, ends)):
        pix = fg[order[s:e]]
        y, x = pix // w, pix % w
        y0, x0 = y.min(), x.min()
        mask = np.zeros((y.max() - y0 + 1, x.max() - x0 + 1), bool)
        mask[y - y0, x - x0] = True
        hull = hull_raster(mask)
        hy_, hx_ = np.nonzero(hull)
        conv_area[i] = hull.sum()
        hy[i], hx[i] = hy_.mean() + y0, hx_.mean() + x0
        conc[i] = concavities(mask, hull)
    f["convex_area"] = conv_area
    f["num_concavities"] = conc
    with np.errstate(divide="ignore", invalid="ignore"):
        f["major_minor_axis_ratio"] = np.where(
            f["minor_axis_length"] == 0, np.nan,
            f["major_axis_length"] / f["minor_axis_length"])
        f["perim_square_over_area"] = f["perimeter"] ** 2 / f["area"]
        f["major_axis_equiv_diam_ratio"] = f["major_axis_length"] / f["equivalent_diameter"]
    f["convex_hull_resid"] = (conv_area - f["area"]) / conv_area
    f["centroid_dif"] = np.hypot(f["centroid-0"] - hy, f["centroid-1"] - hx) \
        / np.sqrt(f["area"])
    return f


def match_nuclei(cells: np.ndarray, nuclei: np.ndarray, cell_ids: np.ndarray) -> np.ndarray:
    """Each cell's nucleus (0 for none): the most pixels inside the cell,
    the lowest id on a tie, from the dense (cell, nucleus) overlap table."""
    nc, nn = int(cells.max()) + 1, int(nuclei.max()) + 1
    both = (cells > 0) & (nuclei > 0)
    table = np.bincount(cells[both].astype(np.int64) * nn + nuclei[both],
                        minlength=nc * nn).reshape(nc, nn)
    best = table.argmax(axis=1)               # the first, so the lowest id, of the largest
    return np.where(table.max(axis=1) > 0, best, 0)[cell_ids]


def fov_tables(fov: str, counts: np.ndarray, cells: np.ndarray, nuclei: np.ndarray,
               channels, dtype=None):
    """(size-normalized, arcsinh) DataFrames of one FOV, as `columns` lays
    them out."""
    cell_ids = np.unique(cells)
    cell_ids = cell_ids[cell_ids != 0]
    nuc_of = match_nuclei(cells, nuclei, cell_ids)
    has = nuc_of > 0
    parts = {}
    for comp, labels, ids in (("", cells, cell_ids), ("_nuclear", nuclei, nuc_of[has])):
        f = region_features(counts, labels, ids, dtype)
        rows = np.ones(len(cell_ids), bool) if comp == "" else has
        block = np.zeros((len(cell_ids), 2 + len(channels) + len(PROPS) - 1))
        vals = [f["cell_size"][:, None], f["channels"], ids[:, None].astype(np.float64)] \
            + [f[p][:, None] for p in PROPS[1:-1]]
        block[rows, :-1] = np.concatenate(vals, axis=1)
        parts[comp] = block
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(has, parts["_nuclear"][:, 0] / parts[""][:, 0], 0.0)
    norm = {}
    for comp, block in parts.items():
        block[:, -1] = ratio
        size = block[:, :1]
        ch = block[:, 1:1 + len(channels)]
        block[:, 1:1 + len(channels)] = np.divide(ch, size, out=np.zeros_like(ch),
                                                  where=size > 0)
        norm[comp] = block
    data = np.concatenate([norm[""], norm["_nuclear"]], axis=1)
    cols = columns(channels)
    normalized = pd.DataFrame(data, columns=cols[:-2])
    arcsinh = normalized.copy()
    for c in list(channels) + [c + "_nuclear" for c in channels]:
        arcsinh[c] = np.arcsinh(100.0 * normalized[c].to_numpy())
    for t in (normalized, arcsinh):
        t["label"] = t["label"].astype(np.int64)
        t["fov"] = fov
        t["mask_type"] = "whole_cell"
    return normalized, arcsinh


def tables(fovs, raws, cells, nuclei, channels, dtype=None):
    """The job's two tables: each FOV's rows, FOVs in sorted order."""
    parts = {fov: fov_tables(fov, raw, c, n, channels, dtype)
             for fov, raw, c, n in zip(fovs, raws, cells, nuclei)}
    order = sorted(fovs)
    return (pd.concat([parts[f][0] for f in order], ignore_index=True),
            pd.concat([parts[f][1] for f in order], ignore_index=True))


def read_job(table_dir: str):
    """The (size-normalized, arcsinh) CSVs a job wrote into `table_dir`."""
    return tuple(pd.read_csv(os.path.join(table_dir, name),
                             float_precision="round_trip")
                 for name in (NORM_CSV, ARCSINH_CSV))


KEY = ["fov", "label", "mask_type"]


def _keys(t: pd.DataFrame) -> list:
    """Each row's (fov, label, mask_type, nucleus)."""
    return list(zip(*(t[c].astype(str if c in ("fov", "mask_type") else np.int64)
                      for c in KEY + ["label_nuclear"])))


def _gap(got: np.ndarray, want: np.ndarray) -> float:
    """Largest column gap: each column's largest |got - want| over the
    larger of its largest |want| and 1, so that a column of values below 1
    (a ratio, a share, a distance over sqrt(area) that is 0 for a convex
    region) is held to an absolute gap; NaN where the other side has none
    counts as infinite."""
    worst = 0.0
    for j in range(want.shape[1]):
        g, w = got[:, j], want[:, j]
        if not np.array_equal(np.isnan(g), np.isnan(w)):
            return float("inf")
        ok = ~np.isnan(w)
        if ok.any():
            diff = float(np.max(np.abs(g[ok] - w[ok])))
            worst = max(worst, diff / max(float(np.max(np.abs(w[ok]))), 1.0)
                        if np.isfinite(diff) else float("inf"))
    return worst


def judge(got, want, channels) -> dict:
    """The numbers ``correct`` compares: `got` and `want` are (size-
    normalized, arcsinh) DataFrame pairs. Rows are paired by (fov, label,
    mask_type); each gap is over the paired rows."""
    cols = columns(channels)
    for t in got:
        if list(t.columns) != cols:
            raise ValueError(f"the table's columns differ from the template's: "
                             f"{sorted(set(t.columns) ^ set(cols))[:10]}")
    rows = 0
    for g, w in zip(got, want):
        gk, wk = _keys(g), _keys(w)
        rows += abs(len(gk) - len(wk)) + sum(a != b for a, b in zip(gk, wk))
    paired = []
    for g, w in zip(got, want):
        m = w[KEY].assign(_row=np.arange(len(w))).merge(
            g[KEY].assign(_row=np.arange(len(g))), on=KEY, suffixes=("_w", "_g"))
        paired.append((g.iloc[m["_row_g"].to_numpy()], w.iloc[m["_row_w"].to_numpy()]))
    (gn, wn), (ga, wa) = paired
    nuc = [c + "_nuclear" for c in channels]
    chan_cols = ["cell_size", *channels, "cell_size_nuclear", *nuc]
    morph_cols = MORPH + [c + "_nuclear" for c in MORPH]
    conc_cols = ["num_concavities", "num_concavities_nuclear"]

    def arr(t, cs):
        return t[cs].to_numpy(np.float64)
    return {
        "rows_mismatch": int(rows),
        "nucleus_mismatch": int((gn["label_nuclear"].to_numpy(np.int64)
                                 != wn["label_nuclear"].to_numpy(np.int64)).sum()),
        "concavity_mismatch": int((arr(gn, conc_cols) != arr(wn, conc_cols)).sum()),
        "channel_gap": _gap(arr(gn, chan_cols), arr(wn, chan_cols)),
        "morph_gap": _gap(arr(gn, morph_cols), arr(wn, morph_cols)),
        "arcsinh_gap": _gap(arr(ga, list(channels) + nuc), arr(wa, list(channels) + nuc)),
    }
