"""Fiber (collagen) segmentation: the classical ridge-filter pipeline.

Port of ``ark_tpu/segmentation/fiber_segmentation.py``
(plot_fiber_segmentation_steps, run_fiber_segmentation,
calculate_fiber_alignment, segment_fibers, calculate_density,
generate_tile_stats, generate_summary_stats).

Pipeline per FOV: Gaussian blur -> CLAHE -> Frangi ridge filter -> EDT of
the thresholded ridges -> multi-Otsu 3-class markers -> Sobel elevation ->
watershed -> small-object removal. The device side (blur, CLAHE, Frangi,
EDT, Sobel) is ``_fiber_device_program``, torch ops on `device`; the
multi-Otsu search, the native C++ priority flood and the scipy labeling
after it stay on the host, as in the JAX package. The property table comes
from the port's segment sums on `device`, the alignment's distances from
``distances.cdist``.

Against the JAX package: the squared EDT is bitwise equal given the same
ridge mask, and the host tail given the same distance and elevation maps.
From the raw image the floats differ in their last bits (``ops/classical``),
so a pixel whose ridge value lies at ``ridge_cutoff``, or whose distance at
an Otsu cut, may fall on the other side; the tests state that rule.

Every function that does device work takes `device` (default "cuda");
``timings``, where a function takes it, is a dict that collects seconds per
step (each device step synchronised, so it slows the run it measures).
"""

from __future__ import annotations

import itertools
import os
import time
from typing import Dict, Optional

import numpy as np
import pandas as pd
import scipy.ndimage as ndi
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.io.image_utils import read_image, save_image
from ark_tpu_torch.ops import classical, distances as dist_ops, edt as edt_ops
from ark_tpu_torch.ops import image_filters
from ark_tpu_torch.ops import morphology, segment_reduce
from ark_tpu_torch.ops import watershed as watershed_ops
from ark_tpu_torch.ops.som import _as_f32_tensor
from ark_tpu_torch.utils.misc_utils import verify_in_list


class _StepClock:
    """Seconds per step into `timings` (None: does nothing), each step
    synchronised with `device` before it is read."""

    def __init__(self, timings, device):
        self.timings = timings
        self.cuda = torch.device(device).type == "cuda"
        self.last = time.perf_counter()

    def mark(self, name):
        if self.timings is None:
            return
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.timings[name] = self.timings.get(name, 0.0) + now - self.last
        self.last = now


def _fiber_regionprops_table(labeled: np.ndarray, properties, *,
                             device="cuda") -> pd.DataFrame:
    """regionprops_table over a fiber label image by segment reductions on
    `device` (area, axes, orientation, eccentricity, euler number,
    centroid). Only ids > 0 are read, so row 0 (the background) is not
    computed: the segment sums are asked for without it."""
    ids = np.unique(labeled)
    ids = ids[ids != 0]
    if len(ids) == 0:
        cols = []
        for p in properties:
            cols += ["centroid-0", "centroid-1"] if p == "centroid" else [p]
        return pd.DataFrame(columns=cols)
    n_seg = int(labeled.max()) + 1
    lab = torch.as_tensor(np.ascontiguousarray(labeled, np.int32), device=device)
    feats = {k: v.cpu().numpy()[ids]
             for k, v in segment_reduce.moment_features(
                 lab, n_seg, background=False).items()}
    feats["euler_number"] = segment_reduce.euler_numbers(lab, n_seg).cpu().numpy()[ids]
    feats["label"] = ids
    out = {}
    for p in properties:
        if p == "centroid":
            out["centroid-0"] = feats["centroid-0"]
            out["centroid-1"] = feats["centroid-1"]
        else:
            out[p] = feats[p]
    return pd.DataFrame(out)


def _fiber_device_program(img: torch.Tensor, ridge_cutoff, *, blur, th, tw,
                          n_tr, n_tc, fiber_widths, sobel_blur, clock=None):
    """The fiber pipeline's device side on `img`'s device: blur -> normalize
    -> CLAHE -> Frangi (all scales) -> EDT -> blur -> Sobel elevation.
    Returns tensors; `has_bg` is a 0-dim bool. The Sobel elevation map does
    not depend on the Otsu cuts, so nothing here waits on the host."""
    clock = clock or _StepClock(None, img.device)
    blurred = image_filters.gaussian_blur(img.to(torch.float32), sigma=blur)
    norm = blurred / torch.clamp_min(torch.max(blurred), 1e-12)
    clock.mark("blur_s")
    contrast = classical._clahe_device(norm, th, tw, n_tr, n_tc, 0.01, 256)
    clock.mark("clahe_s")
    ridges = classical._frangi_device(contrast, fiber_widths) * 10000
    clock.mark("frangi_s")
    fg = ridges > torch.tensor(ridge_cutoff, dtype=torch.float32, device=img.device)
    has_bg = torch.any(~fg)
    edt = edt_ops.distance_transform_edt(fg, device=img.device)
    edt = torch.where(has_bg, edt, 0.0)   # all-fg: EDT undefined (see caller)
    clock.mark("edt_s")
    dt = image_filters.gaussian_blur(edt, sigma=1)
    elevation = classical.sobel(image_filters.gaussian_blur(dt, sigma=sobel_blur))
    clock.mark("sobel_s")
    return {"blurred": blurred, "contrast_adjusted": contrast,
            "ridges": ridges, "distance_transformed": dt,
            "elevation_map": elevation, "has_bg": has_bg}


def _fiber_host_tail(distance_transformed: np.ndarray, elevation_map: np.ndarray,
                     min_fiber_size, clock=None):
    """The host side after the device program: multi-Otsu markers, the
    priority flood, scipy labeling and the small-object filter. Returns
    (threshed, labeled_filtered int32)."""
    clock = clock or _StepClock(None, "cpu")
    thresholds = classical.multi_otsu(distance_transformed, classes=3)
    threshed = np.zeros_like(distance_transformed)
    threshed[distance_transformed < thresholds[0]] = 1
    threshed[distance_transformed > thresholds[1]] = 2
    clock.mark("otsu_s")
    # markers: class 1 = background, class 2 = fiber; unreached pixels clamp
    # to background
    segmentation = np.maximum(
        watershed_ops.watershed(elevation_map, threshed.astype(np.int32)) - 1,
        0)
    clock.mark("flood_s")
    # host scipy labeling: `segmentation` is host-resident after the host
    # flood, and the numbering is scipy's either way (ops/cc is scipy-exact)
    labeled, _ = ndi.label(segmentation)
    labeled_filtered = morphology.remove_small_objects(
        labeled, min_size=min_fiber_size) * segmentation
    clock.mark("labels_filter_s")
    return threshed, labeled_filtered.astype(np.int32)


def _fiber_steps(fiber_channel_data, fov_len, blur, contrast_scaling_divisor,
                 fiber_widths, ridge_cutoff, sobel_blur, min_fiber_size,
                 keep_intermediates=True, *, device="cuda", timings=None):
    """Run the step chain on `device`; returns dict of intermediates + final
    labels (numpy).

    keep_intermediates=False skips the device->host readback of the
    blurred/contrast/ridge images (only the debug/plot paths consume
    them); the distance and elevation maps are always read back (the host
    otsu/watershed stages need them)."""
    h, w = np.asarray(fiber_channel_data).shape
    th, tw, n_tr, n_tc = classical._clahe_geometry(
        h, w, fov_len / contrast_scaling_divisor)
    clock = _StepClock(timings, device)
    img = _as_f32_tensor(fiber_channel_data, device)
    clock.mark("upload_s")
    dev = _fiber_device_program(
        img, float(ridge_cutoff), blur=blur, th=th, tw=tw, n_tr=n_tr,
        n_tc=n_tc, fiber_widths=tuple(fiber_widths), sobel_blur=sobel_blur,
        clock=clock)
    if not bool(dev["has_bg"]):
        # the whole FOV is above ridge_cutoff: distance-to-background is
        # undefined (ops/edt returns +inf). There are no fiber/background
        # boundaries to segment: warn; the program already zeroed the EDT,
        # so every downstream stage returns an empty segmentation
        import warnings
        warnings.warn(
            "fiber ridge mask covers the entire FOV (every frangi response "
            f"exceeds ridge_cutoff={ridge_cutoff}); no fiber boundaries "
            "exist at this cutoff — returning an empty segmentation. "
            "Raise ridge_cutoff for this FOV.")
    distance_transformed = dev["distance_transformed"].cpu().numpy()
    elevation_map = dev["elevation_map"].cpu().numpy()
    clock.mark("readback_s")
    threshed, labeled_filtered = _fiber_host_tail(
        distance_transformed, elevation_map, min_fiber_size, clock)
    steps = {"distance_transformed": distance_transformed,
             "threshed": threshed, "elevation_map": elevation_map,
             "labeled_filtered": labeled_filtered}
    if keep_intermediates:
        steps.update(
            blurred=dev["blurred"].cpu().numpy(),
            contrast_adjusted=dev["contrast_adjusted"].cpu().numpy().astype(np.float64),
            ridges=dev["ridges"].cpu().numpy())
    return steps

def plot_fiber_segmentation_steps(data_dir, fov_name, fiber_channel,
                                  img_sub_folder=None, blur=2,
                                  contrast_scaling_divisor=128,
                                  fiber_widths=range(1, 10, 2),
                                  ridge_cutoff=0.1, sobel_blur=1,
                                  min_fiber_size=15, img_cmap="bone",
                                  labels_cmap="cool", *, device="cuda"):
    """Debug plot of every preprocessing step for one FOV."""
    import matplotlib.pyplot as plt

    if img_sub_folder is None:
        img_sub_folder = ""
    data_xr = load_utils.load_imgs_from_tree(
        data_dir, img_sub_folder, fovs=[fov_name], channels=[fiber_channel])
    fiber_channel_data = data_xr.values[0, :, :, 0].astype(float)
    steps = _fiber_steps(fiber_channel_data, fiber_channel_data.shape[0],
                         blur, contrast_scaling_divisor, fiber_widths,
                         ridge_cutoff, sobel_blur, min_fiber_size, device=device)
    names = ["blurred", "contrast_adjusted", "ridges",
             "distance_transformed", "threshed", "elevation_map",
             "labeled_filtered"]
    fig, axes = plt.subplots(2, 4, figsize=(16, 8))
    axes.flat[0].imshow(fiber_channel_data, cmap=img_cmap)
    axes.flat[0].set_title("original")
    for ax, name in zip(axes.flat[1:], names):
        cmap = labels_cmap if name == "labeled_filtered" else img_cmap
        ax.imshow(steps[name], cmap=cmap)
        ax.set_title(name)
    plt.tight_layout()
    return fig


def segment_fibers(data_xr, fiber_channel, out_dir, fov, blur=2,
                   contrast_scaling_divisor=128,
                   fiber_widths=range(1, 10, 2), ridge_cutoff=0.1,
                   sobel_blur=1, min_fiber_size=15,
                   object_properties=settings.FIBER_OBJECT_PROPS,
                   save_csv=True, debug=False, *, device="cuda") -> pd.DataFrame:
    """Segment fiber objects in one FOV on `device` and save labels +
    property table."""
    channel_xr = data_xr.sel(channels=fiber_channel)
    fov_len = channel_xr.shape[1]
    fiber_channel_data = channel_xr.sel(fovs=fov).values.astype(float)

    steps = _fiber_steps(fiber_channel_data, fov_len, blur,
                         contrast_scaling_divisor, fiber_widths, ridge_cutoff,
                         sobel_blur, min_fiber_size,
                         keep_intermediates=debug, device=device)
    labeled_filtered = steps["labeled_filtered"]

    if debug:
        debug_path = os.path.join(out_dir, "_debug")
        os.makedirs(debug_path, exist_ok=True)
        save_image(os.path.join(debug_path, f"{fov}_thresholded.tiff"),
                   steps["threshed"])
        save_image(os.path.join(debug_path, f"{fov}_ridges_thresholded.tiff"),
                   steps["distance_transformed"])
        save_image(os.path.join(debug_path, f"{fov}_frangi_filter.tiff"),
                   steps["ridges"])
        save_image(os.path.join(debug_path, f"{fov}_contrast_adjusted.tiff"),
                   steps["contrast_adjusted"])
    save_image(os.path.join(out_dir, f"{fov}_fiber_labels.tiff"),
               labeled_filtered)

    fiber_object_table = _fiber_regionprops_table(labeled_filtered,
                                                  object_properties, device=device)
    fiber_object_table.insert(0, settings.FOV_ID, fov)
    if save_csv:
        fiber_object_table.to_csv(os.path.join(out_dir,
                                               "fiber_object_table.csv"))
    return fiber_object_table


def run_fiber_segmentation(data_dir, fiber_channel, out_dir,
                           img_sub_folder=None,
                           csv_compression: Optional[Dict[str, str]] = None,
                           *, device="cuda", **kwargs) -> pd.DataFrame:
    """Segment fibers across all FOVs on `device`; append kNN alignment;
    save table."""
    from tqdm import tqdm

    if img_sub_folder is None:
        img_sub_folder = ""
    io_utils.validate_paths([data_dir, out_dir])
    fovs = io_utils.natsorted(io_utils.list_folders(data_dir))
    verify_in_list(fiber_channel=[fiber_channel],
                   all_channels=io_utils.remove_file_extensions(
                       io_utils.list_files(os.path.join(data_dir, fovs[0],
                                                        img_sub_folder))))
    fiber_object_table = []
    for fov in tqdm(fovs, desc="Fiber Segmentation", unit="FOVs"):
        subset_xr = load_utils.load_imgs_from_tree(
            data_dir, img_sub_folder, fovs=[fov], channels=[fiber_channel])
        subtable = segment_fibers(subset_xr, fiber_channel, out_dir, fov,
                                  save_csv=False, device=device, **kwargs)
        fiber_object_table.append(subtable)
    fiber_object_table = pd.concat(fiber_object_table)
    if len(fiber_object_table) > 0:
        fiber_object_table = calculate_fiber_alignment(fiber_object_table,
                                                       device=device)
    fiber_object_table.to_csv(os.path.join(out_dir, "fiber_object_table.csv"),
                              index=False, compression=csv_compression)
    return fiber_object_table


def calculate_fiber_alignment(fiber_object_table, k=4, axis_thresh=2, *,
                              device="cuda"):
    """kNN angular-alignment score per sufficiently elongated fiber; the
    centroid distances come from `device`."""
    fovs = np.unique(fiber_object_table.fov)
    fov_data = []
    for fov in fovs:
        fov_table = fiber_object_table[fiber_object_table.fov == fov]
        filtered = fov_table[(fov_table["major_axis_length"].values
                              / np.maximum(fov_table["minor_axis_length"].values,
                                           1e-12)) >= axis_thresh]
        filtered = filtered.reset_index()
        if len(filtered) == 0:
            continue
        centroids = np.vstack((filtered["centroid-0"].values,
                               filtered["centroid-1"].values)).T
        fiber_dist_mat = dist_ops.cdist(centroids, device=device)
        scores = []
        kk = min(k, max(len(filtered) - 1, 1))
        for indx, angle in enumerate(filtered.orientation):
            indy = fiber_dist_mat[indx, :].argsort()[1:1 + kk]
            neighbor_angles = filtered.orientation[indy]
            scores.append(np.sqrt(np.sum((neighbor_angles - angle) ** 2)) / k)
        fov_data.append(pd.DataFrame(
            zip([fov] * len(scores), filtered.label, scores),
            columns=["fov", "label", "alignment_score"]))
    if not fov_data:
        fiber_object_table["alignment_score"] = np.nan
        return fiber_object_table
    alignment_data = pd.concat(fov_data)
    return fiber_object_table.merge(alignment_data, "left")


def calculate_density(fov_fiber_table, total_pixels):
    """Pixel-area and fiber-count densities (x 100)."""
    fiber_num = len(np.unique(fov_fiber_table.label))
    fiber_density = fiber_num / total_pixels
    pixel_density = np.sum(fov_fiber_table["area"].values) / total_pixels
    return pixel_density * 100, fiber_density * 100


def generate_tile_stats(fov_table, fov_fiber_img, fov_length, tile_length,
                        min_fiber_num, save_dir, save_tiles) -> pd.DataFrame:
    """Tile-level alignment/length/density statistics."""
    fov_table = fov_table.reset_index(drop=True)
    fov = fov_table.fov[0]
    alignment, pixel_density, fiber_density, tile_stats = [], [], [], []
    fov_list, tile_x, tile_y = [], [], []
    properties = ["major_axis_length", "minor_axis_length", "orientation",
                  "area", "eccentricity", "euler_number"]

    for i, j in itertools.product(range(int(fov_length / tile_length)),
                                  range(int(fov_length / tile_length))):
        y_range = (i * tile_length, (i + 1) * tile_length)
        x_range = (j * tile_length, (j + 1) * tile_length)
        fov_list.append(fov)
        tile_x.append(x_range[0])
        tile_y.append(y_range[0])
        if save_tiles:
            tile_img = fov_fiber_img[y_range[0]:y_range[1],
                                     x_range[0]:x_range[1]].copy()
            tile_img[tile_img > 0] = 1
            os.makedirs(os.path.join(save_dir, fov), exist_ok=True)
            save_image(os.path.join(save_dir, fov,
                                    f"tile_{y_range[0]},{x_range[0]}.tiff"),
                       tile_img)
        tile_table = fov_table[
            (fov_table["centroid-0"] >= y_range[0])
            & (fov_table["centroid-0"] < y_range[1])]
        tile_table = tile_table[
            (tile_table["centroid-1"] >= x_range[0])
            & (tile_table["centroid-1"] < x_range[1])]

        avg_alignment, p_density, f_density = [np.nan] * 3
        tile_avgs = np.array([np.nan] * len(properties))
        if len(tile_table) >= min_fiber_num:
            align_scores = tile_table["alignment_score"].values
            align_scores = align_scores[~np.isnan(align_scores)]
            avg_alignment = np.mean(align_scores) \
                if len(align_scores) >= min_fiber_num else np.nan
            tile_avgs = tile_table[properties].mean().array
            p_density, f_density = calculate_density(tile_table,
                                                     tile_length ** 2)
        alignment.append(avg_alignment)
        pixel_density.append(p_density)
        fiber_density.append(f_density)
        tile_stats.append(tile_avgs)

    tile_stats = np.vstack(tile_stats)
    fov_tile_stats = pd.DataFrame(
        zip(fov_list, tile_y, tile_x, pixel_density, fiber_density, alignment),
        columns=["fov", "tile_y", "tile_x", "pixel_density", "fiber_density",
                 "avg_alignment_score"])
    for i, metric in enumerate(properties):
        fov_tile_stats[f"avg_{metric}"] = tile_stats.T[i]
    return fov_tile_stats


def generate_summary_stats(fiber_object_table, fibseg_dir, tile_length=512,
                           min_fiber_num=5, save_tiles=False):
    """FOV-level + tile-level fiber statistics, saved to CSVs."""
    io_utils.validate_paths(fibseg_dir)
    if 1024 % tile_length != 0:
        raise ValueError("Tile length must be a factor of the minimum image "
                         "size.")
    save_dir = os.path.join(fibseg_dir, f"tile_stats_{tile_length}")
    os.makedirs(save_dir, exist_ok=True)
    fovs = np.unique(fiber_object_table.fov)
    tile_stats = []
    fov_pixel_density, fov_fiber_density, fov_avg_stats = [], [], []
    properties = ["major_axis_length", "minor_axis_length", "orientation",
                  "area", "eccentricity", "euler_number", "alignment_score"]

    for fov in fovs:
        fov_fiber_img = read_image(os.path.join(fibseg_dir,
                                                fov + "_fiber_labels.tiff"))
        fov_length = fov_fiber_img.shape[0]
        fov_table = fiber_object_table[fiber_object_table.fov == fov]
        fov_avg_stats.append(fov_table[properties].mean().array)
        p, f = calculate_density(fov_table, fov_length ** 2)
        fov_pixel_density.append(p)
        fov_fiber_density.append(f)
        tile_stats.append(generate_tile_stats(
            fov_table, fov_fiber_img, fov_length, tile_length, min_fiber_num,
            save_dir, save_tiles))

    fov_stats = pd.DataFrame({"fov": fovs,
                              "pixel_density": fov_pixel_density,
                              "fiber_density": fov_fiber_density})
    fov_prop_stats = np.vstack(fov_avg_stats)
    for i, metric in enumerate(properties):
        fov_stats[f"avg_{metric}"] = fov_prop_stats.T[i]
    fov_stats.to_csv(os.path.join(fibseg_dir, "fiber_stats_table.csv"),
                     index=False)
    tile_stats = pd.concat(tile_stats)
    tile_stats.to_csv(os.path.join(
        save_dir, f"fiber_stats_table-tile_{tile_length}.csv"), index=False)
    return fov_stats, tile_stats
