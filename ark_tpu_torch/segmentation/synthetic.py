"""Planted-cell images, Mesmer training targets and instance matching.

Port of ``ark_tpu/segmentation/synthetic.py``. ``synthetic_cells`` and
``match_instances`` are numpy copies: the same `rng` gives the same images
and labels. ``targets_from_labels`` builds the deep-watershed targets on a
device, through the port's exact EDT, bit for bit the JAX package's.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ark_tpu_torch.ops import edt as edt_ops


def synthetic_cells(rng: np.random.Generator, n_images: int, hw: int = 64,
                    n_cells: Tuple[int, int] = (4, 9),
                    radius: Tuple[float, float] = (6.0, 11.0),
                    noise: float = 0.05, crowding: float = 0.0
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Plant elliptical cells with concentric nuclei. With `crowding` in
    (0, 1], cell centres may sit closer than the sum of radii by that
    fraction, so neighbouring ellipses touch and a contested pixel goes to
    the cell of smallest normalized elliptical radius.

    Returns (images (N, H, W, 2) float32 [nuclear, membrane channels],
    cell_labels (N, H, W) int32, nuc_labels (N, H, W) int32)."""
    yy, xx = np.mgrid[0:hw, 0:hw].astype(np.float32)
    images = np.zeros((n_images, hw, hw, 2), np.float32)
    cell_labels = np.zeros((n_images, hw, hw), np.int32)
    nuc_labels = np.zeros((n_images, hw, hw), np.int32)

    for i in range(n_images):
        k = int(rng.integers(n_cells[0], n_cells[1] + 1))
        placed = []  # (cy, cx, ry, rx, theta)
        attempts = 0
        while len(placed) < k and attempts < 200:
            attempts += 1
            ry = rng.uniform(*radius)
            rx = rng.uniform(*radius)
            cy = rng.uniform(ry + 1, hw - ry - 1)
            cx = rng.uniform(rx + 1, hw - rx - 1)
            rmax = max(ry, rx)
            # the 0.55 floor keeps nuclei (0.45 r) disjoint
            too_close = False
            for p in placed:
                sep = (rmax + max(p[2], p[3]) + 1.0) * (1.0 - crowding)
                sep = max(sep, 0.55 * (rmax + max(p[2], p[3])))
                if (cy - p[0]) ** 2 + (cx - p[1]) ** 2 < sep ** 2:
                    too_close = True
                    break
            if too_close:
                continue
            placed.append((cy, cx, ry, rx, rng.uniform(0, np.pi)))

        r_all = np.full((len(placed), hw, hw), np.inf, np.float32)
        for j, (cy, cx, ry, rx, th) in enumerate(placed):
            ct, st = np.cos(th), np.sin(th)
            u = (yy - cy) * ct + (xx - cx) * st
            v = -(yy - cy) * st + (xx - cx) * ct
            r_all[j] = np.sqrt((u / ry) ** 2 + (v / rx) ** 2)
        if placed:
            owner = np.argmin(r_all, axis=0)
            r_own = np.min(r_all, axis=0)
            cell_labels[i] = np.where(r_own <= 1.0, owner + 1, 0)
            nuc_labels[i] = np.where(r_own <= 0.45, owner + 1, 0)
            for j in range(len(placed)):
                r = r_all[j]
                # nuclear channel: bright gaussian-falloff blob (own px only)
                images[i, :, :, 0] += np.where(
                    (r <= 0.6) & (owner == j), np.exp(-(r / 0.35) ** 2), 0.0)
                # membrane channel: ring at the cell's boundary, clipped to
                # its own territory so touching cells share one border wall
                ring = np.exp(-((r - 1.0) / 0.12) ** 2)
                images[i, :, :, 1] += np.where(
                    (owner == j) & (r <= 1.0), ring, 0.0)

        images[i] += rng.normal(0, noise, size=(hw, hw, 2)).astype(np.float32)
    return np.clip(images, 0, None), cell_labels, nuc_labels


def _inner_distance(lab: np.ndarray, device) -> torch.Tensor:
    """Per-cell EDT of one (H, W) label image on `device`: each pixel's
    distance to the nearest pixel not of its own label (deepcell's
    'inner-distance'), so touching cells each keep their own peak. Each cell
    is transformed in its bounding box grown by one pixel (clipped to the
    image): every pixel outside that box is farther from the cell than the
    box's own rim, which is not of the cell, so the distances are the whole
    image's."""
    import scipy.ndimage as ndi

    h, w = lab.shape
    out = torch.zeros((h, w), dtype=torch.float32, device=device)
    lab_dev = torch.from_numpy(np.ascontiguousarray(lab)).to(device)
    for lv, box in enumerate(ndi.find_objects(lab), start=1):
        if box is None:
            continue
        y0, y1 = max(box[0].start - 1, 0), min(box[0].stop + 1, h)
        x0, x1 = max(box[1].start - 1, 0), min(box[1].stop + 1, w)
        m = lab_dev[y0:y1, x0:x1] == lv
        d = edt_ops.distance_transform_edt(m, device=device)
        box = out[y0:y1, x0:x1]
        box.copy_(torch.where(m, d, box))
    return out


def _window3(lab: torch.Tensor, reduce) -> torch.Tensor:
    """3x3 grey erosion (`reduce` = torch.minimum) or dilation
    (torch.maximum) of (N, H, W) labels with scipy.ndimage's default
    'reflect' border, which for a 3x3 window repeats the edge pixel."""
    h, w = lab.shape[1:]
    rows = torch.arange(-1, h + 1, device=lab.device).clamp(0, h - 1)
    cols = torch.arange(-1, w + 1, device=lab.device).clamp(0, w - 1)
    pad = lab[:, rows][:, :, cols]
    out = pad[:, 1:h + 1, 1:w + 1]
    for dy in range(3):
        for dx in range(3):
            out = reduce(out, pad[:, dy:dy + h, dx:dx + w])
    return out


def targets_from_labels(labels: np.ndarray, *, device="cuda") -> Dict[str, torch.Tensor]:
    """Deep-watershed training targets from (N, H, W) instance labels, on
    `device`: {'inner_distance': (N, H, W) float32, each cell's EDT divided
    by its own maximum (peaks 1.0 at cell centres), 'pixelwise': (N, H, W, 3)
    float32 one-hot [interior, border, background]}. A border pixel is a
    foreground pixel whose 3x3 erosion or dilation differs from its label.
    The per-cell maxima divide in f64 and round to f32, as numpy does in the
    reference."""
    labels = np.asarray(labels)
    dev = torch.device(device)
    lab = torch.from_numpy(np.ascontiguousarray(labels)).to(dev).to(torch.int64)
    fg = lab > 0
    inner = torch.zeros(labels.shape, dtype=torch.float32, device=dev)
    for i in range(labels.shape[0]):
        if not labels[i].any():
            continue
        edt = _inner_distance(labels[i], dev)
        flat = lab[i].reshape(-1)
        maxima = torch.zeros(int(labels[i].max()) + 1, dtype=torch.float32, device=dev)
        maxima = maxima.scatter_reduce(0, flat, edt.reshape(-1), "amax")
        per_cell_max = torch.clamp_min(maxima.to(torch.float64), 1e-6)
        per_cell_max[0] = 1.0
        quotient = (edt.to(torch.float64) / per_cell_max[lab[i]]).to(torch.float32)
        inner[i] = torch.where(fg[i], quotient, 0.0)
    border = fg & ((_window3(lab, torch.minimum) != lab)
                   | (_window3(lab, torch.maximum) != lab))
    pixelwise = torch.stack([fg & ~border, border, ~fg], dim=-1).to(torch.float32)
    return {"inner_distance": inner, "pixelwise": pixelwise}


def match_instances(pred: np.ndarray, truth: np.ndarray,
                    iou_threshold: float = 0.5) -> Dict[str, float]:
    """Greedy IoU matching of predicted vs ground-truth instances. Returns
    {'recall', 'precision', 'mean_matched_iou', 'n_pred', 'n_true'}."""
    true_ids = [t for t in np.unique(truth) if t != 0]
    pred_ids = [p for p in np.unique(pred) if p != 0]
    used = set()
    ious = []
    for t in true_ids:
        tmask = truth == t
        best, best_iou = None, 0.0
        for p in np.unique(pred[tmask]):
            if p == 0 or p in used:
                continue
            pmask = pred == p
            iou = (tmask & pmask).sum() / (tmask | pmask).sum()
            if iou > best_iou:
                best, best_iou = p, iou
        if best is not None and best_iou >= iou_threshold:
            used.add(best)
            ious.append(best_iou)
    n_match = len(ious)
    return {
        "recall": n_match / max(len(true_ids), 1),
        "precision": n_match / max(len(pred_ids), 1),
        "mean_matched_iou": float(np.mean(ious)) if ious else 0.0,
        "n_pred": len(pred_ids),
        "n_true": len(true_ids),
    }
