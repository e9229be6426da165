"""Planted-cell images and instance matching (numpy only).

Copies of ``ark_tpu/segmentation/synthetic.py::synthetic_cells`` and
``::match_instances``: the same `rng` gives the same images and labels. The
JAX module imports ``ark_tpu.ops.edt``, which imports jax, so the port keeps
its own copy of these numpy functions.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np


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
