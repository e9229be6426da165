"""Channel compositing for ez_seg: add/subtract channel or pixel-cluster
images, binary or total modes. Port of
``ark_tpu/segmentation/ez_seg/composites.py``; host numpy and file IO."""

from __future__ import annotations

import pathlib
import numpy as np

from ark_tpu_torch.io import load_utils
from ark_tpu_torch.io.image_utils import save_image
from ark_tpu_torch.segmentation.ez_seg.ez_seg_utils import log_creator
from ark_tpu_torch.utils.misc_utils import verify_in_list


def composite_builder(image_data_dir, img_sub_folder, fov_list,
                      images_to_add, images_to_subtract, image_type,
                      composite_method, composite_directory=None,
                      composite_name=None, log_dir=None):
    """Build (and optionally save) a composite channel per FOV."""
    composite_images = {}
    for fov in fov_list:
        fov_data = load_utils.load_imgs_from_tree(
            data_dir=image_data_dir, img_sub_folder=img_sub_folder,
            fovs=[fov])
        image_shape = fov_data.shape[1:3]
        channel_names = list(fov_data.coords["channels"])
        # validate only non-empty selections: an empty add/subtract list
        # is a legitimate "nothing to do" here (the strict validator
        # raises on empty lists)
        if images_to_add:
            verify_in_list(images_to_add=images_to_add,
                           image_names=channel_names)
        if images_to_subtract:
            verify_in_list(images_to_subtract=images_to_subtract,
                           image_names=channel_names)
        verify_in_list(composite_method=composite_method,
                       options=["binary", "total"])

        composite_array = np.zeros(shape=image_shape, dtype=np.float32)
        fov_block = fov_data.sel(fovs=fov)
        if images_to_add:
            composite_array = add_to_composite(
                fov_block, composite_array, images_to_add, image_type,
                composite_method)
        if images_to_subtract:
            composite_array = subtract_from_composite(
                fov_block, composite_array, images_to_subtract, image_type,
                composite_method)

        if composite_directory:
            composite_fov_dir = pathlib.Path(composite_directory) / fov
            composite_fov_dir.mkdir(parents=True, exist_ok=True)
            save_image(str(pathlib.Path(composite_directory) / fov
                           / f"{composite_name}.tiff"),
                       composite_array.astype(np.uint32))
        composite_images[fov] = composite_array.astype(np.float32)

    if log_dir:
        log_creator({
            "image_data_dir": image_data_dir, "fov_list": fov_list,
            "images_to_add": images_to_add,
            "images_to_subtract": images_to_subtract,
            "image_type": image_type, "composite_method": composite_method,
            "composite_directory": composite_directory,
            "composite_name": composite_name,
        }, log_dir, f"{composite_name}_composite_log.txt")
        print("Composites built and saved")
    else:
        return composite_images


def add_to_composite(data, composite_array, images_to_add, image_type,
                     composite_method) -> np.ndarray:
    """Sum the listed channels into the composite (clipped to 1 for binary/
    pixel-cluster mode)."""
    vals = data.sel(channels=list(images_to_add)).values.astype(np.float32)
    composite_array = vals.sum(axis=-1)
    if image_type == "pixel_cluster" or composite_method == "binary":
        composite_array = composite_array.clip(min=None, max=1)
    return composite_array


def subtract_from_composite(data, composite_array, images_to_subtract,
                            image_type, composite_method) -> np.ndarray:
    """Subtract the listed channels (binary signal mode zeroes overlapping
    pixels instead)."""
    to_sub = data.sel(
        channels=list(images_to_subtract)).values.astype(np.float32).sum(-1)
    if image_type == "signal" and composite_method == "binary":
        composite_array = composite_array.copy()
        composite_array[to_sub > 0] = 0
        composite_array[composite_array > 1] = 1
    else:
        composite_array = (composite_array - to_sub).clip(min=0, max=None)
    return composite_array
