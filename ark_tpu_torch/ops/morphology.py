"""Label-image morphology: boundaries, erosion and the host area filters.

Port of ``ark_tpu/ops/morphology.py``: ``find_boundaries`` and
``binary_erosion`` in torch ops on the tensor's device, ``erode_mask`` over
them, and copies of the host functions ``remove_small_objects``,
``area_filter_np`` and ``remove_small_holes`` (numpy and scipy, as in the
JAX package: one host-resident mask is labeled faster there than through a
device round trip).
"""

from __future__ import annotations

import numpy as np
import torch


def find_boundaries(labels: torch.Tensor, connectivity: int = 1,
                    mode: str = "inner") -> torch.Tensor:
    """Boundary-pixel mask of an (H, W) label image (skimage semantics),
    on the tensor's device.

    mode='inner': object pixels adjacent to a different label;
    mode='outer': background pixels at object boundaries, plus the
    higher-label side where two objects touch; mode='thick': both sides.
    Neighbours beyond the image edge repeat the edge pixel."""
    lab = labels.to(torch.int32)
    h, w = lab.shape
    rows = torch.clamp(torch.arange(-1, h + 1, device=lab.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-1, w + 1, device=lab.device), 0, w - 1)
    pad = lab[rows][:, cols]                      # edge padding
    shifts = [pad[:-2, 1:-1], pad[2:, 1:-1], pad[1:-1, :-2], pad[1:-1, 2:]]
    if connectivity == 2:
        shifts += [pad[:-2, :-2], pad[:-2, 2:], pad[2:, :-2], pad[2:, 2:]]
    differs = torch.zeros((h, w), dtype=torch.bool, device=lab.device)
    for s in shifts:
        differs |= s != lab
    if mode == "inner":
        return differs & (lab > 0)
    if mode == "outer":
        # skimage marks, where two objects touch, the side whose smallest
        # neighbour (background counted as int32 max) is a smaller label
        inv = torch.where(lab == 0, torch.iinfo(torch.int32).max, lab)
        pad_inv = inv[rows][:, cols]
        eroded = inv
        offs = [(0, 1), (2, 1), (1, 0), (1, 2)]
        if connectivity == 2:
            offs += [(0, 0), (0, 2), (2, 0), (2, 2)]
        for dy, dx in offs:
            eroded = torch.minimum(eroded, pad_inv[dy:dy + h, dx:dx + w])
        return differs & ((lab == 0) | (eroded != inv))
    return differs  # thick


def binary_erosion(mask: torch.Tensor, iterations: int = 1) -> torch.Tensor:
    """4-connected binary erosion (cross structuring element) of an (H, W)
    mask, on its device; pixels beyond the edge count as False."""
    m = mask.to(torch.bool)
    for _ in range(iterations):
        pad = torch.nn.functional.pad(m, (1, 1, 1, 1), value=False)
        m = (pad[1:-1, 1:-1] & pad[:-2, 1:-1] & pad[2:, 1:-1]
             & pad[1:-1, :-2] & pad[1:-1, 2:])
    return m


def remove_small_objects(labels: np.ndarray, min_size: int = 5) -> np.ndarray:
    """Zero out labels with fewer than min_size pixels (host, bincount)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels.reshape(-1))
    small = np.flatnonzero(counts < min_size)
    out = labels.copy()
    out[np.isin(out, small)] = 0
    return out


def area_filter_np(labels: np.ndarray, min_area: int = 0,
                   max_area: int = 2 ** 31 - 1) -> np.ndarray:
    """Zero out labels whose pixel count falls outside [min_area, max_area];
    surviving labels keep their ids (host bincount LUT)."""
    labels = np.asarray(labels)
    counts = np.bincount(labels.reshape(-1))
    ids = np.arange(counts.size)
    keep = (counts >= min_area) & (counts <= max_area) & (ids > 0)
    lut = np.where(keep, ids, 0)
    return lut[labels]


def remove_small_holes(mask: np.ndarray, area_threshold: int = 64) -> np.ndarray:
    """Fill background components of area <= area_threshold (numpy in and
    out, scipy labeling). skimage semantics: remove_small_objects on the
    complement, so border-touching holes fill like any other, and the
    threshold is inclusive."""
    import scipy.ndimage as ndi

    fg = np.asarray(mask).astype(bool)
    bg_labels, _ = ndi.label(~fg)
    return fg | (area_filter_np(bg_labels, max_area=area_threshold) > 0)


def erode_mask(mask: np.ndarray, connectivity: int = 2, *, device="cuda") -> np.ndarray:
    """Erode each labeled object by its boundary (the label image minus its
    inner boundaries, found on `device`); numpy in and out."""
    mask = np.asarray(mask)
    boundaries = find_boundaries(torch.as_tensor(mask.astype(np.int32), device=device),
                                 connectivity=connectivity, mode="inner").cpu().numpy()
    out = mask.copy()
    out[boundaries] = 0
    return out
