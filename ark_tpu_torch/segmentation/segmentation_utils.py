"""Segmentation helpers: nucleus-to-cell matching, nuclei splitting,
expression transforms, CSV concatenation, boundary images.

Port of ``ark_tpu/segmentation/segmentation_utils.py``. Everything but
``save_segmentation_labels`` is numpy and pandas; the boundary image runs
``find_boundaries`` on `device`. Host IO is the port's ``ark_tpu_torch.io``.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, Optional

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io import load_utils
from ark_tpu_torch.io.image_utils import save_image
from ark_tpu_torch.ops import convex as convex_ops
from ark_tpu_torch.ops import morphology
from ark_tpu_torch.utils.misc_utils import verify_in_list


def find_nuclear_label_id(nuc_segmentation_labels: np.ndarray,
                          cell_coords: np.ndarray) -> Optional[int]:
    """ID of the nuclear mask with the greatest overlap with a cell."""
    ids, counts = np.unique(nuc_segmentation_labels[tuple(cell_coords.T)],
                            return_counts=True)
    if ids[ids != 0].size == 0:
        return None
    return int(ids[ids != 0][np.argmax(counts[ids != 0])])


def match_nuclei_to_cells(cell_labels: np.ndarray,
                          nuc_labels: np.ndarray) -> Dict[int, int]:
    """Max-overlap nucleus per cell, all cells in one pass (a joint
    histogram over (cell, nucleus) pixel pairs); an overlap tie goes to the
    lowest nucleus id, as the reference's per-cell argmax gives it."""
    cells = cell_labels.reshape(-1)
    nucs = nuc_labels.reshape(-1)
    both = (cells > 0) & (nucs > 0)
    if not both.any():
        return {}
    pairs = cells[both].astype(np.int64) * (int(nucs.max()) + 1) + nucs[both]
    uniq, counts = np.unique(pairs, return_counts=True)
    cell_of = uniq // (int(nucs.max()) + 1)
    nuc_of = uniq % (int(nucs.max()) + 1)
    # sort by (cell, count, -nuc) and take the last row of each cell
    order = np.lexsort((-nuc_of, counts, cell_of))
    cell_sorted, nuc_sorted = cell_of[order], nuc_of[order]
    last = np.r_[np.flatnonzero(np.diff(cell_sorted)), len(cell_sorted) - 1]
    return {int(c): int(n) for c, n in zip(cell_sorted[last], nuc_sorted[last])}


def split_large_nuclei(cell_segmentation_labels: np.ndarray,
                       nuc_segmentation_labels: np.ndarray,
                       cell_ids: np.ndarray, min_size: int = 15) -> np.ndarray:
    """Relabel the in-cell part of nuclei that extend beyond their cell by
    more than min_size pixels (new ids above the current maximum)."""
    nuc_labels_modified = np.copy(nuc_segmentation_labels)
    max_nuc_id = int(np.max(nuc_segmentation_labels))
    groups = convex_ops.group_coords_by_label(cell_segmentation_labels)
    nuc_sizes = np.bincount(nuc_segmentation_labels.reshape(-1))

    for cell in cell_ids:
        coords = groups.get(int(cell))
        if coords is None:
            continue
        nuc_id = find_nuclear_label_id(nuc_segmentation_labels, coords)
        if nuc_id is None:
            continue
        cell_vals = nuc_segmentation_labels[tuple(coords.T)]
        nuc_count = int(np.sum(cell_vals == nuc_id))
        if nuc_sizes[nuc_id] - nuc_count > min_size:
            in_cell = coords[cell_vals == nuc_id]
            max_nuc_id += 1
            nuc_labels_modified[in_cell[:, 0], in_cell[:, 1]] = max_nuc_id
    return morphology.remove_small_objects(nuc_labels_modified, min_size=5)


def transform_expression_matrix(cell_table, transform, transform_kwargs=None):
    """size_norm (divide by cell_size) or arcsinh (of x * linear_factor,
    default 100) of the channel columns of a (compartments x cells x
    features) DataArray."""
    valid_transforms = ["size_norm", "arcsinh"]
    verify_in_list(transform=transform, valid_transforms=valid_transforms)
    if transform_kwargs is None:
        transform_kwargs = {}

    cell_table_transformed = copy.deepcopy(cell_table)
    features = list(cell_table.coords["features"])
    channel_start = features.index(settings.PRE_CHANNEL_COL) + 1
    channel_end = features.index(settings.POST_CHANNEL_COL)

    if transform == "size_norm":
        size_index = features.index(settings.CELL_SIZE)
        cell_size = cell_table.values[:, :, size_index:size_index + 1]
        vals = cell_table_transformed.values[:, :, channel_start:channel_end]
        np.divide(vals, cell_size, out=vals, where=cell_size > 0)
    elif transform == "arcsinh":
        linear_factor = transform_kwargs.get("linear_factor", 100)
        vals = cell_table_transformed.values[:, :, channel_start:channel_end]
        cell_table_transformed.values[:, :, channel_start:channel_end] = \
            np.arcsinh(vals * linear_factor)
    return cell_table_transformed


def concatenate_csv(base_dir, csv_files, column_name="fov", column_values=None):
    """Concatenate CSVs, tagging each with a column value; saves
    combined_data.csv alongside."""
    if column_values is None:
        column_values = io_utils.remove_file_extensions(csv_files)
    if len(column_values) != len(csv_files):
        raise ValueError(
            "csv_files and column_values have different lengths: csv {}, "
            "column_values {}".format(len(csv_files), len(column_values)))
    frames = []
    for value, file in zip(column_values, csv_files):
        df = pd.read_csv(os.path.join(base_dir, file), header=0, sep=",")
        df[column_name] = value
        frames.append(df)
    combined = pd.concat(frames, axis=0, ignore_index=True)
    combined.to_csv(os.path.join(base_dir, "combined_data.csv"), index=False)


def save_segmentation_labels(segmentation_dir, data_dir, output_dir, fovs,
                             channels=None, *, device):
    """Save each FOV's segmentation-border image (inner boundaries of the
    whole-cell mask, 255 on a uint8 image), computed on `device`. The
    channel overlay (`channels`) needs ``ark_tpu.utils.plot_utils``, which
    the port has not ported yet, so it raises."""
    if channels is not None:
        raise NotImplementedError(
            "save_segmentation_labels(channels=...) draws overlays with "
            "plot_utils, which the port does not have yet")

    for fov in fovs:
        labels_da = load_utils.load_imgs_from_dir(
            data_dir=segmentation_dir, files=[fov + "_whole_cell.tiff"],
            xr_dim_name="compartments", xr_channel_names=["whole_cell"],
            trim_suffix="_whole_cell")
        labels = labels_da.sel(fovs=fov, compartments="whole_cell").values
        contour_mask = morphology.find_boundaries(
            torch.as_tensor(np.asarray(labels).astype(np.int32), device=device),
            connectivity=1, mode="inner").cpu().numpy().astype(np.uint8)
        contour_mask[contour_mask > 0] = 255
        save_image(os.path.join(output_dir, f"{fov}_segmentation_borders.tiff"),
                   contour_mask)
