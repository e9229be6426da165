"""Cohort image loading: TIFF channel trees -> (fov, row, col, channel) arrays.

The port's copy of ``ark_tpu/io/load_utils.py``: the three loaders its
pipelines call (``load_imgs_from_tree``, ``load_imgs_from_dir``,
``load_imgs_from_mibitiff``), returning the port's ``DataArray``. TIFFs are
read through ``image_utils.read_image``, which imports imageio inside, and
the header scan imports PIL inside ``load_imgs_from_tree``.

Expected tree layout:
    data_dir/
      fov0/  <img_sub_folder>/ chan0.tiff chan1.tiff ...
      fov1/  <img_sub_folder>/ ...
"""

from __future__ import annotations

import os
import re
import warnings
from typing import List, Optional

import numpy as np

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io.image_utils import read_image
from ark_tpu_torch.utils.labeled_array import DataArray


def _infer_dtype(arrs) -> np.dtype:
    return np.result_type(*[a.dtype for a in arrs])


def load_imgs_from_tree(data_dir: str, img_sub_folder: Optional[str] = None,
                        fovs: Optional[List[str]] = None,
                        channels: Optional[List[str]] = None,
                        dtype=None, max_image_size: Optional[int] = None) -> DataArray:
    """Load `data_dir/<fov>/<img_sub_folder>/<channel>.tiff` into a
    (fovs, rows, cols, channels) DataArray. Channels may be given with or
    without extensions; FOVs default to every subfolder, natural-sorted.
    Ragged FOVs are zero-padded to the cohort's largest."""
    io_utils.validate_paths([data_dir])
    if fovs is None:
        fovs = io_utils.list_folders(data_dir)
    if isinstance(fovs, str):
        fovs = [fovs]
    if len(fovs) == 0:
        raise ValueError(f"No FOV folders found in {data_dir}")
    if img_sub_folder is None:
        img_sub_folder = ""

    # channel file names from the first FOV
    first_dir = os.path.join(data_dir, fovs[0], img_sub_folder)
    io_utils.validate_paths([first_dir])
    all_files = io_utils.list_files(first_dir, substrs=[".tiff", ".tif"])
    if channels is None:
        channel_files = all_files
    else:
        channel_files = []
        for c in channels:
            if c.endswith((".tiff", ".tif")):
                channel_files.append(c)
            else:
                match = [f for f in all_files if os.path.splitext(f)[0] == c]
                if not match:
                    raise ValueError(f"channel {c} not found in {first_dir}")
                channel_files.append(match[0])
    channel_names = io_utils.remove_file_extensions(channel_files)
    if len(channel_files) == 0:
        raise ValueError(f"No channel images found in {first_dir}")

    # header-only size scan (PIL opens lazily), so the output is allocated
    # once and filled FOV by FOV
    from PIL import Image

    max_h = max_w = 0
    for fov in fovs:
        path = os.path.join(data_dir, fov, img_sub_folder, channel_files[0])
        with Image.open(path) as im:
            w, h = im.size
        max_h, max_w = max(max_h, h), max(max_w, w)
    if max_image_size is not None:
        max_h = max_w = max_image_size

    # dtype probe over the first FOV's channels (promotes mixed dtypes); the
    # probe fills row 0, so the first FOV is read once
    probe = [read_image(os.path.join(data_dir, fovs[0], img_sub_folder, cf))
             for cf in channel_files]
    native_dtype = _infer_dtype(probe)
    out_dtype = np.dtype(dtype) if dtype is not None else native_dtype
    if (dtype is not None and np.issubdtype(out_dtype, np.integer)
            and np.issubdtype(native_dtype, np.floating)):
        # float image data is never truncated into a requested integer dtype
        warnings.warn(
            f"supplied non-float dtype {out_dtype} would truncate float "
            f"image data; overwriting to {native_dtype}")
        out_dtype = native_dtype

    out = np.zeros((len(fovs), max_h, max_w, len(channel_files)), dtype=out_dtype)
    for j, img in enumerate(probe):
        out[0, :img.shape[0], :img.shape[1], j] = img
    del probe
    for i, fov in enumerate(fovs[1:], start=1):
        fdir = os.path.join(data_dir, fov, img_sub_folder)
        for j, cf in enumerate(channel_files):
            img = read_image(os.path.join(fdir, cf))
            out[i, :img.shape[0], :img.shape[1], j] = img

    return DataArray(out, coords={"fovs": fovs, "rows": np.arange(max_h),
                                  "cols": np.arange(max_w), "channels": channel_names})


def load_imgs_from_dir(data_dir: str, files: Optional[List[str]] = None,
                       match_substring: Optional[str] = None,
                       trim_suffix: Optional[str] = None,
                       xr_dim_name: str = "compartments",
                       xr_channel_names: Optional[List[str]] = None,
                       dtype=None) -> DataArray:
    """Load loose image files `data_dir/*.tiff` into a
    (fovs, rows, cols, <xr_dim_name>) DataArray. Each file is one FOV; a
    multi-page/HxWxC file populates the last axis."""
    io_utils.validate_paths([data_dir])
    if files is None:
        files = io_utils.list_files(data_dir, substrs=match_substring or [".tiff", ".tif"])
    if len(files) == 0:
        raise ValueError(f"No image files found in {data_dir}")
    names = io_utils.remove_file_extensions(files)
    if trim_suffix:
        names = [re.sub(re.escape(trim_suffix) + "$", "", n) for n in names]

    blocks = []
    for f in files:
        img = read_image(os.path.join(data_dir, f))
        if img.ndim == 2:
            img = img[..., None]
        elif img.ndim == 3:
            if (xr_channel_names
                    and img.shape[0] == len(xr_channel_names)
                    and img.shape[-1] != len(xr_channel_names)):
                # channels-first multi-page TIFF (deepcell 2-channel inputs)
                img = np.moveaxis(img, 0, -1)
            elif (xr_channel_names is None
                  and img.shape[0] == min(img.shape)
                  and img.shape[0] != img.shape[-1]):
                # channels first without channel names: pages would
                # otherwise load as rows
                img = np.moveaxis(img, 0, -1)
        blocks.append(img)
    shapes = {b.shape for b in blocks}
    if len(shapes) > 1:
        raise ValueError(f"Mixed image shapes in {data_dir}: {shapes}")
    out = np.stack(blocks, axis=0)
    if dtype is not None:
        out = out.astype(dtype)
    nch = out.shape[-1]
    ch_names = xr_channel_names if xr_channel_names is not None else list(range(nch))
    return DataArray(out, coords={"fovs": names, "rows": np.arange(out.shape[1]),
                                  "cols": np.arange(out.shape[2]), xr_dim_name: ch_names})


def _read_channel_names(ome_path: str, n_channels: int) -> List[str]:
    """A multi-page TIFF's channel names: its `.channels.txt` sidecar, else
    the Name attributes of its OME-XML description, else channel_<i>."""
    sidecar = ome_path + ".channels.txt"
    if os.path.exists(sidecar):
        with open(sidecar) as f:
            return f.read().splitlines()
    try:
        import imageio.v3 as iio

        desc = iio.immeta(ome_path).get("description", "") or ""
        names = re.findall(r'Name="([^"]+)"', desc)
        if len(names) == n_channels:
            return names
        reason = (f"found {len(names)} Name attributes in the OME-XML "
                  f"description for {n_channels} channels")
    except Exception as e:  # metadata recovery must never block the load
        reason = f"{type(e).__name__}: {e}"
    warnings.warn(
        f"could not recover channel names from {ome_path} ({reason}); "
        f"falling back to generic channel_N names")
    return [f"channel_{i}" for i in range(n_channels)]


def load_imgs_from_mibitiff(data_dir: str, mibitiff_files: Optional[List[str]] = None,
                            channels: Optional[List[str]] = None,
                            dtype=None) -> DataArray:
    """Load MIBItiff-style multi-channel single-file FOVs (channels-first
    multi-page TIFFs) into a (fovs, rows, cols, channels) DataArray."""
    io_utils.validate_paths([data_dir])
    if mibitiff_files is None:
        mibitiff_files = [
            f for f in io_utils.list_files(data_dir, substrs=[".tiff", ".tif"])
            if f.endswith((".tiff", ".tif"))]
    blocks, names = [], []
    channel_names = None
    for f in mibitiff_files:
        path = os.path.join(data_dir, f)
        img = read_image(path)
        if img.ndim == 2:
            img = img[None]
        file_channels = _read_channel_names(path, img.shape[0])
        if channels is not None:
            keep = [file_channels.index(c) for c in channels]
            img = img[keep]
            file_channels = list(channels)
        if channel_names is None:
            channel_names = file_channels
        blocks.append(np.moveaxis(img, 0, -1))
        name = f
        for suffix in (".ome.tiff", ".ome.tif", ".tiff", ".tif"):
            if name.endswith(suffix):
                name = name[: -len(suffix)]
                break
        names.append(name)
    out = np.stack(blocks, axis=0)
    if dtype is not None:
        out = out.astype(dtype)
    return DataArray(out, coords={"fovs": names,
                                  "rows": np.arange(out.shape[1]),
                                  "cols": np.arange(out.shape[2]),
                                  "channels": channel_names})
