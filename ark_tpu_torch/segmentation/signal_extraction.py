"""Per-cell channel signal reducers.

Port of ``ark_tpu/segmentation/signal_extraction.py``, two tiers:

- ``EXTRACTION_FUNCTION``: per-cell numpy functions with the reference's
  signature (cell_coords, image_data, **kwargs), kept for API parity, for
  custom extractors and as the tests' per-cell oracle;
- ``EXTRACTION_FUNCTION_BATCH``: whole-FOV reducers over torch tensors
  (``ark_tpu_torch.ops.segment_reduce``), every cell at once on the tensors'
  device; the quantification engine uses these. It indexes them by cell id,
  so row 0 (the background) is not computed there: it is zero.
"""

from __future__ import annotations

import numpy as np

from ark_tpu_torch.ops import segment_reduce


def positive_pixels_extraction(cell_coords, image_data, **kwargs):
    """Count of positive (> threshold) pixels per channel for one cell."""
    values = np.asarray(image_data)[tuple(cell_coords.T)]
    return np.sum(values > kwargs.get("threshold", 0), axis=0)


def center_weighting_extraction(cell_coords, image_data, **kwargs):
    """Distance-from-center (inf-norm) weighted sum per channel for one cell."""
    weights = np.linalg.norm(cell_coords - kwargs.get("centroid"),
                             ord=np.inf, axis=1)
    weights = 1 - (weights / (np.max(weights) + 1))
    values = np.asarray(image_data)[tuple(cell_coords.T)]
    return weights.dot(values)


def total_intensity_extraction(cell_coords, image_data, **kwargs):
    """Plain per-channel intensity sum for one cell."""
    values = np.asarray(image_data)[tuple(cell_coords.T)]
    return np.sum(values, axis=0)


EXTRACTION_FUNCTION = {
    "positive_pixel": positive_pixels_extraction,
    "center_weighting": center_weighting_extraction,
    "total_intensity": total_intensity_extraction,
}


def _batch_positive(images, labels, num_segments, **kwargs):
    return segment_reduce.positive_pixel_counts(
        images, labels, num_segments, kwargs.get("threshold", 0), background=False)


def _batch_center_weighting(images, labels, num_segments, **kwargs):
    return segment_reduce.center_weighted_sums(images, labels, num_segments,
                                               background=False)


def _batch_total(images, labels, num_segments, **kwargs):
    return segment_reduce.channel_sums(images, labels, num_segments, background=False)


EXTRACTION_FUNCTION_BATCH = {
    "positive_pixel": _batch_positive,
    "center_weighting": _batch_center_weighting,
    "total_intensity": _batch_total,
}
