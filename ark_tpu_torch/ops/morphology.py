"""Host small-object filters for label images (numpy).

Copies of ``ark_tpu/ops/morphology.py::remove_small_objects`` and
``::area_filter_np``: Mesmer's host postprocess runs them per FOV. The JAX
module imports jax at its top, so the port keeps its own copy of these two
numpy functions.
"""

from __future__ import annotations

import numpy as np


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
