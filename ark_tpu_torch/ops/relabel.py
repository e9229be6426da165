"""Label-image relabeling as a lookup-table gather.

Port of ``ark_tpu/ops/relabel.py``: build a dense (max_label + 1,) table
once, then gather it over the flattened image. The device gather runs on
`device` for f32 and narrower tables; f64 and int64 tables stay on the host
gather, as in the JAX package (whose device path has no 64-bit types), so
that the output's dtype and values never depend on the image size.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def build_lut(mapping: Dict[int, float], max_label: int, unassigned_id,
              dtype=np.float64) -> np.ndarray:
    """Dense (max_label+1,) lookup table from a {label: value} dict; labels
    absent from the mapping get `unassigned_id`."""
    lut = np.full(max_label + 1, unassigned_id, dtype=dtype)
    if mapping:
        keys = np.fromiter(mapping.keys(), dtype=np.int64, count=len(mapping))
        vals = np.fromiter(mapping.values(), dtype=dtype, count=len(mapping))
        in_range = (keys >= 0) & (keys <= max_label)
        lut[keys[in_range]] = vals[in_range]
    return lut


def _gather_lut(labeled_image: torch.Tensor, lut: torch.Tensor) -> torch.Tensor:
    idx = torch.clamp(labeled_image.to(torch.int64), 0, lut.shape[0] - 1)
    return lut[idx]


def relabel_segmentation(mapping: Dict, unassigned_id, labeled_image: np.ndarray,
                         _dtype=np.float64, use_device: bool = None, *,
                         device) -> np.ndarray:
    """Map every pixel of a label image through `mapping` (missing labels
    get `unassigned_id`). The gather runs on `device` when `use_device`
    (default: images of 2^20 pixels or more) and the table is narrower than
    64 bits; otherwise on the host."""
    labeled_image = np.asarray(labeled_image)
    max_label = int(labeled_image.max()) if labeled_image.size else 0
    lut = build_lut(mapping, max_label, unassigned_id, dtype=_dtype)
    if use_device is None:
        use_device = labeled_image.size >= 1 << 20
    if use_device and lut.dtype not in (np.float64, np.int64):
        return _gather_lut(torch.as_tensor(labeled_image.astype(np.int32), device=device),
                           torch.as_tensor(lut, device=device)).cpu().numpy()
    return lut[labeled_image]
