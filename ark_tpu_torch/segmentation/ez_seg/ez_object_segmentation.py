"""ez_seg object segmentation: masks for non-cell objects (plaques,
projections).

Port of ``ark_tpu/segmentation/ez_seg/ez_object_segmentation.py``: blur ->
percentile or local-adaptive threshold (block size from um/pixel) ->
remove-small-holes -> optional Meijering ridge filter -> connected-component
labeling -> area filtering. The blur, the local threshold's mean and the
ridge filter run on `device` (``ark_tpu_torch.ops.classical``); hole
filling, labeling and area filtering are host scipy and bincount, as in the
JAX package."""

from __future__ import annotations

import pathlib
from typing import Optional

import numpy as np
import torch

from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.io.image_utils import save_image
from ark_tpu_torch.ops import classical, image_filters, morphology
from ark_tpu_torch.segmentation.ez_seg.ez_seg_utils import log_creator
from ark_tpu_torch.utils.misc_utils import verify_in_list


def create_object_masks(image_data_dir, img_sub_folder: Optional[str],
                        fov_list, mask_name: str, channel_to_segment: str,
                        masks_dir, log_dir, object_shape_type: str = "blob",
                        sigma: int = 1, thresh=None, hole_size=None,
                        fov_dim: int = 400, min_object_area: int = 100,
                        max_object_area: int = 100000, *, device="cuda") -> None:
    """Segment object masks for each FOV on `device` and save
    `<fov>_<mask_name>.tiff`."""
    io_utils.validate_paths([image_data_dir, masks_dir, log_dir])
    verify_in_list(object_shape=[object_shape_type],
                   object_shape_options=["blob", "projection"])
    for fov in fov_list:
        fov_xr = load_utils.load_imgs_from_tree(
            data_dir=image_data_dir, img_sub_folder=img_sub_folder,
            fovs=[fov])
        channel = fov_xr.sel(fovs=fov, channels=channel_to_segment
                             ).values.astype(np.float32)
        object_masks = _create_object_mask(
            input_image=channel, object_shape_type=object_shape_type,
            sigma=sigma, thresh=thresh, hole_size=hole_size, fov_dim=fov_dim,
            min_object_area=min_object_area, max_object_area=max_object_area,
            device=device)
        save_image(str(pathlib.Path(masks_dir) / f"{fov}_{mask_name}.tiff"),
                   object_masks)

    log_creator({
        "image_data_dir": image_data_dir, "fov_list": fov_list,
        "mask_name": mask_name, "channel_to_segment": channel_to_segment,
        "masks_dir": masks_dir, "object_shape_type": object_shape_type,
        "sigma": sigma, "thresh": thresh, "hole_size": hole_size,
        "fov_dim": fov_dim, "min_object_area": min_object_area,
        "max_object_area": max_object_area,
    }, log_dir, f"{mask_name}_segmentation_log.txt")
    print("ez masks built and saved")


def _create_object_mask(input_image, object_shape_type="blob", sigma: int = 1,
                        thresh=None, hole_size="auto", fov_dim: int = 400,
                        min_object_area: int = 10,
                        max_object_area: int = 100000, *, device="cuda") -> np.ndarray:
    """Object mask for one image, its filters on `device` (see the module
    docstring for the step chain)."""
    verify_in_list(object_shape_type=[object_shape_type],
                   object_shape_options=["blob", "projection"])
    img2mask = np.asarray(input_image, np.float32)
    img_shape = img2mask.shape

    if sigma is None:
        img2mask_blur = img2mask
    else:
        img2mask_blur = image_filters.gaussian_blur(
            torch.as_tensor(img2mask, device=device), sigma=sigma).cpu().numpy()

    if isinstance(thresh, int):
        img_nonzero = img2mask_blur[img2mask_blur != 0]
        thresh_percentile = np.percentile(img_nonzero, thresh) \
            if img_nonzero.size else 0.0
        img2mask_thresh = np.where(img2mask_blur < thresh_percentile, 0,
                                   img2mask_blur)
    elif thresh == "auto":
        block = get_block_size("local_thresh", fov_dim=fov_dim,
                               img_shape=img_shape[0])
        img2mask_thresh = classical.local_adaptive_threshold(
            img2mask_blur, block_size=block, device=device).astype(np.float32)
    elif thresh is None:
        img2mask_thresh = img2mask_blur
    else:
        raise ValueError(f"Invalid `threshold` value: {thresh}. Must be "
                         "either `auto`, `None` or an integer.")

    img2mask_thresh = (img2mask_thresh > 0).astype(int)

    if isinstance(hole_size, int):
        img2mask_rm_holes = morphology.remove_small_holes(
            img2mask_thresh, area_threshold=hole_size)
    elif hole_size == "auto":
        block = get_block_size("small_holes", fov_dim=fov_dim,
                               img_shape=img_shape[0])
        img2mask_rm_holes = morphology.remove_small_holes(
            img2mask_thresh, area_threshold=block)
    elif hole_size is None:
        img2mask_rm_holes = img2mask_thresh.astype(bool)
    else:
        raise ValueError(f"Invalid `hole_size` value: {hole_size}. Must be "
                         "either `auto`, `None` or an integer.")

    if object_shape_type == "projection":
        img2mask_filtered = classical.meijering(
            img2mask_rm_holes.astype(np.float32), sigmas=range(1, 5, 1),
            black_ridges=False, device=device)
    else:
        img2mask_filtered = img2mask_rm_holes

    binary = np.asarray(img2mask_filtered) > 0
    # 8-connected host labeling + bincount area filter: surviving objects
    # keep their ids. Host scipy: this mask is host-resident, and the
    # numbering is scipy's either way
    import scipy.ndimage as ndi
    labeled, _ = ndi.label(binary, structure=np.ones((3, 3)))
    return morphology.area_filter_np(labeled, min_area=min_object_area,
                                     max_area=max_object_area)


def get_block_size(block_type: str, fov_dim: int, img_shape: int) -> int:
    """Block sizes derived from um/pixel resolution."""
    verify_in_list(block_type=[block_type],
                   block_types=["small_holes", "local_thresh"])
    pixel_size = fov_dim / img_shape
    if block_type == "small_holes":
        return round((np.pi * 5) ** 2 / pixel_size)
    area = round(10 / pixel_size)
    if area % 2 == 0:
        area += 1
    return area
