"""Cohort image loading: TIFF channel trees -> (fov, row, col, channel) arrays.

The port's copy of ``ark_tpu/io/load_utils.py``: the three loaders its
pipelines call (``load_imgs_from_tree``, ``load_imgs_from_dir``,
``load_imgs_from_mibitiff``) and the tiled-grid loader of the stitcher
(``get_tiled_fov_names``, ``load_tiled_img_data``), returning the port's
``DataArray``; and ``load_fov_planes``, one FOV of a tree as a
channel-first stack, for callers whose next step is the card. TIFFs are
read through the port's codec (``image_utils.read_image``; the size scan of
``load_imgs_from_tree`` reads headers only, ``tiff.shape_dtype``).

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

from ark_tpu_torch.io import io_utils, tiff
from ark_tpu_torch.io.image_utils import read_image
from ark_tpu_torch.io.ome_utils import _read_channel_names
from ark_tpu_torch.utils.labeled_array import DataArray


def _infer_dtype(arrs) -> np.dtype:
    return np.result_type(*[a.dtype for a in arrs])


def _channel_files(fov_dir: str, channels: Optional[List[str]]):
    """(file names, channel names) of a tree's FOV folder `fov_dir`: every
    TIFF in it, natural-sorted, or `channels` in their order, each given
    with or without its extension."""
    io_utils.validate_paths([fov_dir])
    all_files = io_utils.list_files(fov_dir, substrs=[".tiff", ".tif"])
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
                    raise ValueError(f"channel {c} not found in {fov_dir}")
                channel_files.append(match[0])
    channel_names = io_utils.remove_file_extensions(channel_files)
    if len(channel_files) == 0:
        raise ValueError(f"No channel images found in {fov_dir}")
    return channel_files, channel_names


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
    channel_files, channel_names = _channel_files(
        os.path.join(data_dir, fovs[0], img_sub_folder), channels)

    # header-only size scan, so the output is allocated once and filled FOV
    # by FOV
    max_h = max_w = 0
    for fov in fovs:
        path = os.path.join(data_dir, fov, img_sub_folder, channel_files[0])
        h, w = tiff.shape_dtype(path)[0][:2]
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


def load_fov_planes(data_dir: str, fov: str, img_sub_folder: Optional[str] = None,
                    channels: Optional[List[str]] = None, empty=np.empty):
    """One FOV's channel images as a channel-first (channels, rows, cols)
    stack: ``load_imgs_from_tree(data_dir, img_sub_folder, [fov],
    channels).values[0]`` transposed, bit for bit, without its channel-last
    interleave. The files are resolved and ordered as there; the shape is
    the first channel's and the dtype the channels' promoted one, both from
    the IFDs alone (``tiff.shape_dtype``). Each file is read into its own
    contiguous plane (``tiff.read_into``: straight from the file where its
    layout allows). `empty(shape, dtype)` makes the stack; one of another
    dtype than the promoted one (the cell table's pinned float32) receives
    each value cast through the promoted dtype, as ``np.asarray`` of that
    array to the stack's dtype would.

    Returns (stack, channel names, direct, decoded): how many files went
    straight into their planes, and how many through the decode and a
    copy."""
    fov_dir = os.path.join(data_dir, fov, img_sub_folder or "")
    channel_files, channel_names = _channel_files(fov_dir, channels)
    paths = [os.path.join(fov_dir, cf) for cf in channel_files]
    probes = [tiff.shape_dtype(p) for p in paths]
    h, w = probes[0][0][:2]
    via = np.result_type(*[dt for _, dt in probes])
    stack = empty((len(paths), h, w), via)
    direct = sum(tiff.read_into(p, plane, via) for p, plane in zip(paths, stack))
    return stack, channel_names, direct, len(paths) - direct


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


def get_tiled_fov_names(fov_list: List[str], return_dims: bool = False):
    """From RnCm-style FOV names, compute the full expected tile grid
    (reference behavior: `alpineer.load_utils.get_tiled_fov_names`)."""
    prefixes, rows, cols = set(), 0, 0
    parsed = []
    for fov in fov_list:
        # fullmatch: an unanchored match silently drops suffixes after
        # RnCm ('R1C1_acquisition' -> 'R1C1'), and the tiled loader then
        # finds none of the real files and zero-fills every tile
        m = re.fullmatch(r"(?:(.*)_)?R(\d+)C(\d+)", fov)
        if not m:
            raise ValueError(f"FOV {fov} is not RnCm-tiled")
        prefix = m.group(1) or ""
        prefixes.add(prefix)
        parsed.append((prefix, int(m.group(2)), int(m.group(3))))
    expected = []
    dims = []
    for prefix in io_utils.natsorted(prefixes):
        rs = [r for p, r, c in parsed if p == prefix]
        cs = [c for p, r, c in parsed if p == prefix]
        rows, cols = max(rs), max(cs)
        names = [f"{prefix + '_' if prefix else ''}R{r}C{c}"
                 for r in range(1, rows + 1) for c in range(1, cols + 1)]
        expected.append(names)
        dims.append((prefix, rows, cols))
    flat = [n for group in expected for n in group]
    if return_dims:
        return flat, dims
    return flat


def load_tiled_img_data(data_dir: str, fovs: List[str], expected_fovs: List[str],
                        channel: str, single_dir: bool = False,
                        img_sub_folder: str = "") -> DataArray:
    """Load one channel for a tiled FOV grid, zero-filling missing tiles."""
    io_utils.validate_paths([data_dir])
    blocks, shape = {}, None
    for fov in fovs:
        if single_dir:
            path = os.path.join(data_dir, f"{fov}_{channel}.tiff")
        else:
            path = os.path.join(data_dir, fov, img_sub_folder, f"{channel}.tiff")
        img = read_image(path)
        blocks[fov] = img
        shape = img.shape
    if shape is None:
        raise ValueError("no tiles loaded")
    out = np.zeros((len(expected_fovs),) + shape + (1,), dtype=np.float32)
    for i, fov in enumerate(expected_fovs):
        if fov in blocks:
            out[i, ..., 0] = blocks[fov]
    return DataArray(out, coords={"fovs": expected_fovs, "rows": np.arange(shape[0]),
                                  "cols": np.arange(shape[1]), "channels": [channel]})
