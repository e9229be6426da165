"""ez_seg display helpers: channel views, mask-outline overlays, merge
visuals. Port of ``ark_tpu/segmentation/ez_seg/ez_seg_display.py``. Mask
outlines come from the boundary op and the Sobel filter on `device`;
matplotlib is imported inside the functions that draw."""

from __future__ import annotations

import pathlib
import numpy as np
import torch

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io.image_utils import read_image
from ark_tpu_torch.ops import classical, morphology


def display_channel_image(base_image_path, sub_folder_name, test_fov_name,
                          channel_name, composite: bool = False) -> None:
    """Display one channel or composite image."""
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    if composite or (sub_folder_name is None):
        sub_folder_name = ""
    image_path = (pathlib.Path(base_image_path) / test_fov_name
                  / sub_folder_name / f"{channel_name}.tiff")
    io_utils.validate_paths(image_path)
    base_image = read_image(str(image_path)).astype(float)
    base_image_scaled = base_image / 255
    fig = plt.figure(dpi=300, figsize=(6, 6))
    fig.set_layout_engine(layout="constrained")
    gs = gridspec.GridSpec(1, 1, figure=fig)
    fig.suptitle(f"{image_path.name}")
    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(base_image_scaled)
    ax.axis("off")


def overlay_mask_outlines(fov, channel, image_dir, sub_folder_name, mask_name,
                          mask_dir, *, device="cuda") -> None:
    """Overlay red mask outlines (found on `device`) on a base channel
    image."""
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    if sub_folder_name is None:
        sub_folder_name = ""
    image_dir = pathlib.Path(image_dir)
    mask_dir = pathlib.Path(mask_dir)
    io_utils.validate_paths([image_dir, mask_dir])
    # cohort tree layout: image_dir/<fov>/<sub_folder>/<channel>.tiff
    # (the subfolder sits INSIDE each FOV folder, same as
    # load_imgs_from_tree and display_channel_image above)
    channel_image_path = image_dir / fov / sub_folder_name / f"{channel}.tiff"
    mask_image_path = mask_dir / f"{fov}_{mask_name}.tiff"
    io_utils.validate_paths(paths=[channel_image_path, mask_image_path])

    channel_image = read_image(str(channel_image_path)).astype(float)
    mask_image = read_image(str(mask_image_path))
    channel_image_scaled = channel_image / 255
    edges = morphology.find_boundaries(
        torch.as_tensor((mask_image > 0).astype(np.int32), device=device),
        mode="inner").cpu().numpy()
    rgb = np.stack([channel_image_scaled] * 3, axis=-1)
    rgb[edges] = (255, 0, 0)

    fig = plt.figure(dpi=300, figsize=(6, 6))
    fig.set_layout_engine(layout="constrained")
    gs = gridspec.GridSpec(1, 1, figure=fig)
    fig.suptitle(f"Mask: {mask_name}")
    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(channel_image)
    ax.imshow(rgb, alpha=0.3)
    ax.axis("off")


def multiple_mask_display(fov, mask_name, object_mask_dir, cell_mask_dir,
                          cell_mask_suffix, merged_mask_dir, *, device="cuda") -> None:
    """Grid display of object/cell/merged masks for one FOV."""
    import matplotlib.gridspec as gridspec
    import matplotlib.pyplot as plt

    object_mask_dir = pathlib.Path(object_mask_dir)
    cell_mask_dir = pathlib.Path(cell_mask_dir)
    merged_mask_dir = pathlib.Path(merged_mask_dir)
    io_utils.validate_paths([object_mask_dir, cell_mask_dir, merged_mask_dir])
    modified = create_overlap_and_merge_visual(
        fov, mask_name, object_mask_dir, cell_mask_dir, cell_mask_suffix,
        merged_mask_dir, device=device)
    fig = plt.figure(dpi=300, figsize=(6, 6))
    fig.set_layout_engine(layout="constrained")
    gs = gridspec.GridSpec(1, 1, figure=fig)
    fig.suptitle(f"Merged Mask: {mask_name}")
    ax = fig.add_subplot(gs[0, 0])
    ax.imshow(modified)
    ax.axis("off")


def create_overlap_and_merge_visual(fov, mask_name, object_mask_dir,
                                    cell_mask_dir, cell_mask_suffix,
                                    merged_mask_dir, *, device="cuda") -> np.ndarray:
    """RGB visual: objects red, cells blue, merged-mask edges (Sobel on
    `device`) green."""
    object_mask = read_image(str(pathlib.Path(object_mask_dir)
                                 / f"{fov}_{mask_name}.tiff"))
    cell_mask = read_image(str(pathlib.Path(cell_mask_dir)
                               / f"{fov}_{cell_mask_suffix}.tiff"))
    merged_mask = read_image(str(pathlib.Path(merged_mask_dir)
                                 / f"{fov}_{mask_name}_merged.tiff"))
    red = np.zeros(object_mask.shape, np.uint8)
    red[object_mask > 0] = 225
    blue = np.zeros(object_mask.shape, np.uint8)
    blue[cell_mask > 0] = 255
    edges = classical.sobel(torch.as_tensor(
        (merged_mask > 0).astype(np.float32), device=device)).cpu().numpy()
    green = np.zeros(object_mask.shape, np.uint8)
    green[edges > 0] = 255
    return np.stack([red, green, blue], axis=-1)
