"""Gaussian blur and separable 1-D filters in torch ops.

Port of ``ark_tpu/ops/image_filters.py``: scipy.ndimage.gaussian_filter's
defaults (truncate=4.0 kernel radius, 'reflect' boundary, which is numpy's
'symmetric' padding, normalized order-0 taps), separable over rows then
columns. Each pass (``correlate1d``) is a tap-weighted sum of shifted slices
in f32, one multiply and one add per tap in tap order, on every device, and
not ``F.conv1d``: cuDNN convolutions run in TF32 by default and sum in an
order of their own, which would break the f32 contract between devices.
"""

from __future__ import annotations

import numpy as np
import torch


def gaussian_kernel1d(sigma: float, truncate: float = 4.0) -> np.ndarray:
    """scipy.ndimage._gaussian_kernel1d for order=0: normalized Gaussian taps.

    sigma <= 0 degenerates to the identity tap (scipy's gaussian_filter
    returns the input unchanged at sigma=0)."""
    if sigma <= 0:
        return np.ones(1, np.float32)
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    return (phi / phi.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int, device, after: int = None) -> torch.Tensor:
    """Source rows of numpy's 'symmetric' padding of `n` rows by `r` before
    and `after` (default `r`) behind (edge sample repeated; period 2n, so
    pads wider than n work too)."""
    i = torch.arange(-r, n + (r if after is None else after), device=device) % (2 * n)
    return torch.where(i >= n, 2 * n - 1 - i, i)


def correlate1d(x: torch.Tensor, taps: np.ndarray, axis: int) -> torch.Tensor:
    """Same-size 1-D correlation of `x` along `axis` with any odd number of
    taps and symmetric padding: out[i] = sum_t taps[t] * x[i + t - r]. The
    other axes (leading batch axes, trailing channels) ride along. A true
    convolution hands in the reversed taps (``classical._sep_conv``)."""
    r = (len(taps) - 1) // 2
    n = x.shape[axis]
    padded = torch.index_select(x, axis, _symmetric_index(n, r, x.device))
    out = padded.narrow(axis, 0, n) * float(taps[0])
    for t in range(1, len(taps)):
        out = out + padded.narrow(axis, t, n) * float(taps[t])
    return out


def gaussian_blur(img: torch.Tensor, sigma: float = 2.0,
                  truncate: float = 4.0) -> torch.Tensor:
    """Per-channel Gaussian blur of an (H, W, C) or (H, W) image, f32.

    Matches scipy.ndimage.gaussian_filter(img, sigma) (mode='reflect') to
    float32 rounding."""
    taps = gaussian_kernel1d(sigma, truncate)
    x = correlate1d(img.to(torch.float32), taps, axis=0)
    return correlate1d(x, taps, axis=1)


def gaussian_blur_batch(imgs: torch.Tensor, sigma: float = 2.0,
                        truncate: float = 4.0) -> torch.Tensor:
    """Blur a (B, H, W, C) FOV batch: each image as ``gaussian_blur`` would,
    in one pass per axis over the whole batch."""
    taps = gaussian_kernel1d(sigma, truncate)
    x = correlate1d(imgs.to(torch.float32), taps, axis=1)
    return correlate1d(x, taps, axis=2)
