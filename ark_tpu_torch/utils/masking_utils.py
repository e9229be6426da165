"""Signal and cell-type mask generation.

Port of ``ark_tpu/utils/masking_utils.py`` over the port's ez_seg:
``composite_builder`` adds the channels up on the host, and
``_create_object_mask`` blurs and thresholds on `device`."""

from __future__ import annotations

import os

import numpy as np

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.segmentation.ez_seg.composites import composite_builder
from ark_tpu_torch.segmentation.ez_seg.ez_object_segmentation import \
    _create_object_mask
from ark_tpu_torch.utils import data_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list


def generate_signal_masks(img_dir, mask_dir, channels, mask_name,
                          intensity_thresh_perc="auto", sigma=2,
                          min_object_area=5000, max_hole_area=1000, *, device="cuda"):
    """One composite-signal mask per FOV from the given channels."""
    io_utils.validate_paths([img_dir])
    fovs = io_utils.list_folders(img_dir)
    channel_list = io_utils.remove_file_extensions(
        io_utils.list_files(os.path.join(img_dir, fovs[0])))
    verify_in_list(input_channels=channels, all_channels=channel_list)

    composite_imgs = composite_builder(
        img_dir, img_sub_folder="", fov_list=fovs, images_to_add=channels,
        images_to_subtract=[], image_type="total", composite_method="total")

    for fov in fovs:
        img = composite_imgs[fov]
        img_size = img.shape[0] * img.shape[1]
        mask = _create_object_mask(img, "blob", sigma, intensity_thresh_perc,
                                   max_hole_area, fov_dim=400,
                                   min_object_area=min_object_area,
                                   max_object_area=img_size, device=device)
        save_dir = os.path.join(mask_dir, fov)
        os.makedirs(save_dir, exist_ok=True)
        data_utils.save_fov_mask(mask_name, save_dir, mask)


def create_cell_mask(seg_mask, cell_table, fov_name, cell_types,
                     cluster_col=settings.CELL_TYPE, sigma=10,
                     min_object_area=0, max_hole_area=1000, *,
                     device="cuda") -> np.ndarray:
    """Binary mask of the cells of the given types, blurred + re-binarized."""
    cell_subset = cell_table[cell_table["fov"] == fov_name]
    cell_subset = cell_subset[cell_subset[cluster_col].isin(cell_types)]
    cell_labels = cell_subset["label"].values
    cell_mask = np.isin(seg_mask, cell_labels).astype(np.int32)
    img_size = cell_mask.shape[0] * cell_mask.shape[1]
    cell_mask = _create_object_mask(cell_mask, "blob", sigma, None,
                                    max_hole_area, fov_dim=0,
                                    min_object_area=min_object_area,
                                    max_object_area=img_size, device=device)
    cell_mask[cell_mask > 0] = 1
    return cell_mask


def generate_cell_masks(seg_dir, mask_dir, cell_table, cell_types, mask_name,
                        cluster_col=settings.CELL_TYPE, sigma=10,
                        min_object_area=0, max_hole_area=1000, *, device="cuda"):
    """One cell-type mask per FOV."""
    fovs = np.unique(cell_table.fov)
    for fov in fovs:
        seg_mask = load_utils.load_imgs_from_dir(
            data_dir=seg_dir, files=[fov + "_whole_cell.tiff"],
            xr_dim_name="compartments", xr_channel_names=["whole_cell"])
        mask = create_cell_mask(
            np.array(seg_mask.values[0, :, :, 0]), cell_table, fov,
            cell_types, cluster_col, sigma, min_object_area, max_hole_area,
            device=device)
        save_dir = os.path.join(mask_dir, fov)
        os.makedirs(save_dir, exist_ok=True)
        data_utils.save_fov_mask(mask_name, save_dir, mask)
