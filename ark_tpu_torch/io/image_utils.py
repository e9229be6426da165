"""Image save/load: the port's copy of ``ark_tpu/io/image_utils.py`` over
its own TIFF codec (``ark_tpu_torch.io.tiff``), which writes the bytes the
JAX package's imageio writer writes and reads the TIFF layouts its module
docstring lists as imageio reads them. TIFF is the only format: where the
JAX package's imageio also reads and writes PNG and JPEG, these raise."""

from __future__ import annotations

import os

import numpy as np

from ark_tpu_torch.io import tiff

TIFF_EXTENSIONS = (".tif", ".tiff")


def check_tiff_name(fname: str) -> None:
    """Raise a ValueError unless `fname` ends in .tif or .tiff (any case)."""
    ext = os.path.splitext(fname)[1]
    if ext.lower() not in TIFF_EXTENSIONS:
        raise ValueError(f"{fname}: the port reads and writes TIFF only (.tif, .tiff), "
                         f"not {ext or 'a name without an extension'}")


def save_image(fname: str, data: np.ndarray, compression_level=None):
    """Save a 2-D image or a channels-first stack to `fname`, a .tif or
    .tiff name, as TIFF.

    float64 is saved as float32, int64 as int32, bool as uint8.
    """
    check_tiff_name(fname)
    data = np.asarray(data)
    if data.dtype == np.float64:
        data = data.astype(np.float32)
    if data.dtype == np.int64:
        data = data.astype(np.int32)
    if data.dtype == bool:
        data = data.astype(np.uint8)
    os.makedirs(os.path.dirname(os.path.abspath(fname)), exist_ok=True)
    tiff.write(fname, data)


def read_image(fname: str) -> np.ndarray:
    """Read a TIFF into a numpy array (dtype preserved)."""
    return tiff.read(fname)
