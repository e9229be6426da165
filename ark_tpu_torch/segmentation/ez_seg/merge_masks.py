"""Object <-> cell mask merging. Port of
``ark_tpu/segmentation/ez_seg/merge_masks.py``; host numpy and scipy.

The overlap search is vectorized: a single joint bincount over
(object_label, cell_label) pixel pairs yields every intersection size at
once; the greedy best-overlap-above-threshold assignment then proceeds in
object-label order."""

from __future__ import annotations

import os
import pathlib
from typing import List

import numpy as np
import pandas as pd

from ark_tpu_torch.io.image_utils import read_image, save_image
from ark_tpu_torch.segmentation.ez_seg.ez_seg_utils import log_creator


def merge_masks_seq(fov_list: List[str], object_list: List[str],
                    object_mask_dir, cell_mask_dir, cell_mask_suffix: str,
                    overlap_percent_threshold: int, expansion_factor: int,
                    save_path, log_dir) -> None:
    """Sequentially merge each object-mask type with the (remaining) cell
    masks; save merged masks + final remaining cells per FOV."""
    object_mask_dir = pathlib.Path(object_mask_dir)
    cell_mask_dir = pathlib.Path(cell_mask_dir)
    save_path = pathlib.Path(save_path)

    for fov in fov_list:
        curr_cell_mask = read_image(os.path.join(
            cell_mask_dir, "_".join([f"{fov}", f"{cell_mask_suffix}.tiff"])))
        fov_object_names = [f"{fov}_" + obj + ".tiff" for obj in object_list]
        for obj in fov_object_names:
            curr_object_mask = read_image(str(object_mask_dir / obj))
            remaining_cells = merge_masks_single(
                object_mask=curr_object_mask, cell_mask=curr_cell_mask,
                overlap_thresh=overlap_percent_threshold, object_name=obj,
                mask_save_path=save_path,
                expansion_factor=expansion_factor)
            curr_cell_mask = remaining_cells
        save_image(str(save_path /
                       (fov + f"_final_{cell_mask_suffix}_remaining.tiff")),
                   curr_cell_mask.astype(np.int32))

    log_creator({
        "fov_list": fov_list, "object_list": object_list,
        "object_mask_dir": object_mask_dir, "cell_mask_dir": cell_mask_dir,
        "cell_mask_suffix": cell_mask_suffix,
        "overlap_percent_threshold": overlap_percent_threshold,
        "save_path": save_path,
    }, log_dir, "mask_merge_log.txt")
    print("Merged masks built and saved")


def merge_masks_single(object_mask: np.ndarray, cell_mask: np.ndarray,
                       overlap_thresh: int, object_name: str,
                       mask_save_path, expansion_factor: int) -> np.ndarray:
    """Merge cells into their best-overlapping object (overlap >= thresh% of
    the cell's area); returns the mask of unmerged cells."""
    import scipy.ndimage as ndi

    if cell_mask.shape != object_mask.shape:
        raise ValueError("Both masks must have the same shape")

    cell_labels, num_cell_labels = ndi.label(cell_mask,
                                             structure=np.ones((3, 3)))
    object_labels, num_object_labels = ndi.label(object_mask,
                                                 structure=np.ones((3, 3)))
    merged_mask = object_labels.copy()
    remove_cells_list = [0]

    # one joint histogram gives every (object, cell) intersection size
    obj_flat = object_labels.reshape(-1).astype(np.int64)
    cell_flat = cell_labels.reshape(-1).astype(np.int64)
    both = (obj_flat > 0) & (cell_flat > 0)
    cell_sizes = np.bincount(cell_flat, minlength=num_cell_labels + 1)
    overlaps = {}
    if both.any():
        pair = obj_flat[both] * (num_cell_labels + 1) + cell_flat[both]
        uniq, counts = np.unique(pair, return_counts=True)
        for u, c in zip(uniq, counts):
            overlaps.setdefault(int(u // (num_cell_labels + 1)), []).append(
                (int(u % (num_cell_labels + 1)), int(c)))

    # candidate gate (get_bounding_boxes + filter_labels_in_bbox): a cell
    # may merge into an object only if the cell's centroid falls inside the
    # object's bbox expanded by expansion_factor — without it a
    # long cell grazing a small object by >thresh% of its area merges from
    # far outside the object's neighborhood
    obj_slices = ndi.find_objects(object_labels)
    cy = np.zeros(num_cell_labels + 1)
    cx = np.zeros(num_cell_labels + 1)
    if num_cell_labels:
        yy, xx = np.indices(cell_labels.shape)
        sizes_safe = np.maximum(cell_sizes, 1)
        cy = np.bincount(cell_flat, weights=yy.reshape(-1),
                         minlength=num_cell_labels + 1) / sizes_safe
        cx = np.bincount(cell_flat, weights=xx.reshape(-1),
                         minlength=num_cell_labels + 1) / sizes_safe

    for obj_label in range(1, num_object_labels + 1):
        best_overlap = 0
        cell_to_merge_label = None
        sl = obj_slices[obj_label - 1]
        if sl is None:
            continue
        y0 = sl[0].start - expansion_factor
        y1 = sl[0].stop + expansion_factor
        x0 = sl[1].start - expansion_factor
        x1 = sl[1].stop + expansion_factor
        for cell_label, overlap in overlaps.get(obj_label, []):
            in_bbox = (y0 <= cy[cell_label] < y1
                       and x0 <= cx[cell_label] < x1)
            meets = overlap / cell_sizes[cell_label] > overlap_thresh / 100
            if overlap > best_overlap and meets and in_bbox:
                best_overlap = overlap
                cell_to_merge_label = cell_label
        if cell_to_merge_label is not None:
            merged_mask[cell_labels == cell_to_merge_label] = obj_label
            remove_cells_list.append(cell_to_merge_label)

    non_merged = np.isin(cell_labels, remove_cells_list, invert=True)
    cell_labels[~non_merged] = 0

    save_image(os.path.join(
        mask_save_path,
        object_name.removesuffix(".tiff") + "_merged.tiff"), merged_mask)
    return cell_labels


def get_bounding_boxes(object_labels: np.ndarray):
    """{label: ((min_row, min_col), (max_row, max_col))} via one coordinate
    pass."""
    from ark_tpu_torch.ops import convex as convex_ops
    out = {}
    for lab, coords in convex_ops.group_coords_by_label(object_labels).items():
        rmin, cmin = coords.min(0)
        rmax, cmax = coords.max(0)
        out[lab] = ((int(rmin), int(cmin)), (int(rmax), int(cmax)))
    return out


def filter_labels_in_bbox(bounding_box, cell_props: pd.DataFrame,
                          expansion_factor: int):
    """Cell labels whose centroid falls in the expanded bounding box."""
    (min_row, min_col), (max_row, max_col) = bounding_box
    filtered = cell_props[
        (cell_props["centroid-0"] >= min_row - expansion_factor)
        & (cell_props["centroid-0"] <= max_row + expansion_factor)
        & (cell_props["centroid-1"] >= min_col - expansion_factor)
        & (cell_props["centroid-1"] <= max_col + expansion_factor)]
    return filtered["label"].tolist()
