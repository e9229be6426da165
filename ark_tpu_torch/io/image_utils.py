"""Image save/load built on imageio: the port's copy of
``ark_tpu/io/image_utils.py``. imageio is imported inside each function, so
that the modules which import this one load on a machine without it."""

from __future__ import annotations

import os

import numpy as np


def save_image(fname: str, data: np.ndarray, compression_level=None):
    """Save a 2-D (or HxWxC) image array to `fname` (TIFF/PNG by extension).

    float64 is saved as float32, int64 as int32, bool as uint8.
    """
    import imageio.v3 as iio

    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    iio.imwrite(fname, data)


def read_image(fname: str) -> np.ndarray:
    """Read an image file into a numpy array (dtype preserved for TIFF)."""
    import imageio.v3 as iio

    return np.asarray(iio.imread(fname))
