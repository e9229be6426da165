"""Pixie pixel-matrix preprocessing: blur -> threshold -> row-normalize -> subset.

Port of ``ark_tpu/phenotyping/pixie_preprocessing.py``. The per-FOV compute
(per-channel Gaussian blur, total-signal threshold mask, row-sum
normalization) runs in torch ops on an explicit ``device``; rows are compacted
on the host when the feather DataFrame is built. The channel-norm divide
stays on the host (``channel_norm_divide``): the artifact contract is
f32(f64 divide).

Host IO is the port's ``ark_tpu_torch.io``, with its own TIFF codec.

File/resume contract preserved: per-FOV `.feather` files in `data_dir` and
`subset_dir`, `channel_norm_pre_rownorm.feather`, `pixel_thresh.feather`, the
per-FOV post-rownorm quantile CSV, and the cohort-invalidated-on-channel-change
behavior (reference :281-297).
"""

from __future__ import annotations

import os
from shutil import rmtree

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.io import load_utils
from ark_tpu_torch.io.image_utils import read_image
from ark_tpu_torch.ops import image_filters
from ark_tpu_torch.utils.misc_utils import verify_in_list


def channel_norm_divide(img_f32: np.ndarray,
                        norm_vect_f64: np.ndarray) -> np.ndarray:
    """f32(img / norm) with the f64 intermediate the reference pipeline
    implies (f32 array / f64 row promotes to f64, then the cast to f32).
    ``np.divide`` straight into an f32 output is bitwise-equal to the naive
    ``(img / norm).astype(f32)`` without the f64 temporary."""
    out = np.empty(img_f32.shape, np.float32)
    np.divide(img_f32, norm_vect_f64, out=out, casting="unsafe")
    return out


def _prep_fov_parts_inner(img: torch.Tensor, blur_factor: int):
    """Threshold-independent preprocess: blur -> flatten -> row stats ->
    row-normalize. Shared by the multi-pass `_prep_fov_device` and the fused
    sweep's `pixie_fused._prep_fov_parts`, so the two pipelines produce
    bitwise-equal norm matrices. Returns (norm, rowsums, anynz)."""
    blurred = image_filters.gaussian_blur(img, sigma=blur_factor)
    h, w, c = blurred.shape
    mat = blurred.reshape(h * w, c)
    rowsums = torch.sum(mat, dim=1)
    anynz = torch.any(mat != 0, dim=1)
    norm = mat / torch.where(rowsums == 0, 1.0, rowsums)[:, None]
    return norm, rowsums, anynz


def _prep_fov_device(img: torch.Tensor, pixel_thresh_val: float,
                     blur_factor: int = 2):
    """Per-FOV preprocessing on img's device.

    img: (H, W, C) channel-normalized image.
    Returns (pixel_mat (H*W, C) row-normalized, valid (H*W,) bool) where
    valid = rowsum(blurred) > thresh AND any(channel != 0); the threshold
    compares in f32, as the JAX package's does.
    """
    norm, rowsums, anynz = _prep_fov_parts_inner(img, blur_factor)
    valid = (rowsums > float(np.float32(pixel_thresh_val))) & anynz
    return norm, valid


def create_fov_pixel_data(fov, channels, img_data, seg_labels,
                          pixel_thresh_val, blur_factor=2,
                          subset_proportion=0.1, device="cuda"):
    """Preprocess pixel data for one FOV on `device` (reference :18-80):
    Gaussian blur per channel, flatten to pixel x channel with row/column
    indices (+ seg label), drop below-threshold and all-zero rows,
    row-normalize, subset a fraction for SOM training. Returns (pixel_mat,
    pixel_mat_subset) DataFrames."""
    # reorder the DATA axis together with the names
    channels_sorted = io_utils.natsorted(channels)
    if list(channels_sorted) != list(channels):
        idx = [list(channels).index(c) for c in channels_sorted]
        img_data = np.asarray(img_data)[..., idx]
    channels = channels_sorted
    h, w = img_data.shape[:2]
    norm, valid = _prep_fov_device(
        torch.as_tensor(np.ascontiguousarray(img_data, dtype=np.float32),
                        device=device),
        pixel_thresh_val, blur_factor=blur_factor)
    norm = norm.cpu().numpy()
    keep = np.flatnonzero(valid.cpu().numpy())

    pixel_mat = pd.DataFrame(norm[keep], columns=channels)
    pixel_mat["fov"] = fov
    pixel_mat["row_index"] = keep // w
    pixel_mat["column_index"] = keep % w
    if seg_labels is not None:
        pixel_mat["label"] = np.asarray(seg_labels).ravel()[keep]

    pixel_mat_subset = pixel_mat.sample(frac=subset_proportion)
    return pixel_mat, pixel_mat_subset


def preprocess_fov(base_dir, tiff_dir, data_dir, subset_dir, seg_dir,
                   seg_suffix, img_sub_folder, is_mibitiff, channels,
                   blur_factor, subset_proportion, pixel_thresh_val, seed,
                   channel_norm_df, fov, device="cuda"):
    """Load one FOV, channel-normalize, run `create_fov_pixel_data`, and save
    the full + subsetted feathers (reference :83-185)."""
    if is_mibitiff:
        img_xr = load_utils.load_imgs_from_mibitiff(
            tiff_dir, mibitiff_files=[fov + ".tiff"])
    else:
        img_xr = load_utils.load_imgs_from_tree(
            tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov])
    verify_in_list(provided_chans=channels,
                   pixel_mat_chans=list(img_xr.coords["channels"]))
    seg_labels = None
    if seg_dir is not None:
        seg_labels = read_image(os.path.join(seg_dir, fov + seg_suffix))

    img_data = img_xr.sel(fovs=fov, channels=channels).values.astype(np.float32)
    norm_vect = channel_norm_df.iloc[0].values.reshape(1, 1, -1)
    img_data = channel_norm_divide(img_data, norm_vect)

    np.random.seed(seed)
    pixel_mat, pixel_mat_subset = create_fov_pixel_data(
        fov=fov, channels=channels, img_data=img_data, seg_labels=seg_labels,
        pixel_thresh_val=pixel_thresh_val, blur_factor=blur_factor,
        subset_proportion=subset_proportion, device=device)

    feather.write_dataframe(pixel_mat,
                            os.path.join(base_dir, data_dir, fov + ".feather"),
                            compression="uncompressed")
    feather.write_dataframe(pixel_mat_subset,
                            os.path.join(base_dir, subset_dir, fov + ".feather"),
                            compression="uncompressed")
    return pixel_mat


def create_pixel_matrix(fovs, channels, base_dir, tiff_dir, seg_dir,
                        img_sub_folder="TIFs", seg_suffix="_whole_cell.tiff",
                        pixel_output_dir="pixel_output_dir",
                        data_dir="pixel_mat_data",
                        subset_dir="pixel_mat_subsetted",
                        norm_vals_name_pre_rownorm="channel_norm_pre_rownorm.feather",
                        norm_vals_name_post_rownorm="channel_norm_post_rownorm.feather",
                        pixel_thresh_name="pixel_thresh.feather",
                        channel_percentile_pre_rownorm=0.99,
                        channel_percentile_post_rownorm=0.999,
                        is_mibitiff=False, blur_factor=2,
                        subset_proportion=0.1, seed=42, multiprocess=False,
                        batch_size=5, device="cuda"):
    """Cohort preprocessing driver (reference :188-456): computes cohort
    channel percentiles + pixel threshold (resumable), preprocesses each
    outstanding FOV on `device`, accumulates per-FOV 99.9% post-rownorm
    quantiles, and saves their cohort mean as the SOM normalization values."""
    from ark_tpu_torch.phenotyping import pixel_cluster_utils

    channels = io_utils.natsorted(channels)
    if subset_proportion <= 0 or subset_proportion > 1:
        raise ValueError("Invalid subset percentage entered: must be in (0, 1]")
    io_utils.validate_paths([base_dir, tiff_dir,
                             os.path.join(base_dir, pixel_output_dir)])
    os.makedirs(os.path.join(base_dir, data_dir), exist_ok=True)
    os.makedirs(os.path.join(base_dir, subset_dir), exist_ok=True)

    channel_norm_pre_path = os.path.join(base_dir, pixel_output_dir,
                                         norm_vals_name_pre_rownorm)
    pixel_thresh_path = os.path.join(base_dir, pixel_output_dir,
                                     pixel_thresh_name)

    # channel-set change invalidates the whole cohort (reference :281-297)
    if os.path.exists(channel_norm_pre_path):
        prev = feather.read_dataframe(channel_norm_pre_path)
        if set(prev.columns.values) != set(channels):
            print("New channels provided: overwriting whole cohort")
            rmtree(os.path.join(base_dir, data_dir))
            os.mkdir(os.path.join(base_dir, data_dir))
            rmtree(os.path.join(base_dir, subset_dir))
            os.mkdir(os.path.join(base_dir, subset_dir))
            os.remove(channel_norm_pre_path)
            if os.path.exists(pixel_thresh_path):
                os.remove(pixel_thresh_path)

    quantile_path = os.path.join(base_dir, data_dir,
                                 "channel_norm_post_rownorm_perfov.csv")

    # resume: only FOVs missing from either output dir (or the quantile CSV)
    fovs_sub = io_utils.list_files(os.path.join(base_dir, subset_dir),
                                   substrs=".feather")
    fovs_data = io_utils.list_files(os.path.join(base_dir, data_dir),
                                    substrs=".feather")
    fovs_full = io_utils.remove_file_extensions(
        list(set(fovs_sub).intersection(fovs_data)))
    # keep the caller's FOV order: the quantile ledger's column order sets
    # the f64 summation order of the cohort mean
    fovs_list = [f for f in fovs if f not in set(fovs_full)]
    quant_dat_all = pd.read_csv(quantile_path, index_col="channel") \
        if os.path.exists(quantile_path) else pd.DataFrame()
    norm_post_path = os.path.join(base_dir, norm_vals_name_post_rownorm)
    # the per-FOV quantile CSV gates resume only while the norm file is
    # still missing
    if not os.path.exists(norm_post_path):
        need = set(fovs_list).union(
            set(fovs).difference(quant_dat_all.columns))
        fovs_list = [f for f in fovs if f in need]
    # skip ONLY when the stage's final artifact exists too
    if len(fovs_list) == 0 and os.path.exists(norm_post_path):
        print("There are no more FOVs to preprocess, skipping")
        return
    if 0 < len(fovs_list) < len(fovs):
        print(f"Restarting preprocessing from FOV {fovs_list[0]}, "
              f"{len(fovs_list)} fovs left to process")

    pixel_cluster_utils.check_for_modified_channels(
        tiff_dir=tiff_dir, test_fov=fovs[0], img_sub_folder=img_sub_folder,
        channels=channels)

    if not os.path.exists(channel_norm_pre_path):
        channel_norm_df = pixel_cluster_utils.calculate_channel_percentiles(
            tiff_dir=tiff_dir, fovs=fovs, channels=channels,
            img_sub_folder=img_sub_folder,
            percentile=channel_percentile_pre_rownorm, device=device)
        feather.write_dataframe(channel_norm_df, channel_norm_pre_path,
                                compression="uncompressed")
    else:
        channel_norm_df = feather.read_dataframe(channel_norm_pre_path)

    if not os.path.exists(pixel_thresh_path):
        pixel_thresh_val = \
            pixel_cluster_utils.calculate_pixel_intensity_percentile(
                tiff_dir=tiff_dir, fovs=fovs, channels=channels,
                img_sub_folder=img_sub_folder,
                channel_percentiles=channel_norm_df, device=device)
        feather.write_dataframe(
            pd.DataFrame({"pixel_thresh_val": [pixel_thresh_val]}),
            pixel_thresh_path, compression="uncompressed")
    else:
        pixel_thresh_val = feather.read_dataframe(
            pixel_thresh_path)["pixel_thresh_val"].values[0]

    cols_to_drop = ["fov", "row_index", "column_index"]
    if seg_dir:
        cols_to_drop.append("label")

    fovs_processed = 0
    for fov in fovs_list:
        pixel_mat_data = preprocess_fov(
            base_dir, tiff_dir, data_dir, subset_dir, seg_dir, seg_suffix,
            img_sub_folder, is_mibitiff, channels, blur_factor,
            subset_proportion, pixel_thresh_val, seed, channel_norm_df, fov,
            device=device)

        fov_vals = pixel_mat_data.drop(columns=cols_to_drop)
        quant_fov = fov_vals.replace(0, np.nan).quantile(
            q=channel_percentile_post_rownorm, axis=0).rename(fov)
        quant_fov.index.name = "channel"
        # a reprocessed FOV must REPLACE its column, not collide
        if fov in quant_dat_all.columns:
            quant_dat_all = quant_dat_all.drop(columns=[fov])
        quant_dat_all = quant_dat_all.merge(quant_fov, how="outer",
                                            left_index=True, right_index=True)
        quant_dat_all.to_csv(quantile_path)

        fovs_processed += 1
        if fovs_processed % 10 == 0 or fovs_processed == len(fovs_list):
            print(f"Processed {fovs_processed} fovs")

    # cohort mean of per-FOV 99.9% quantiles = SOM normalization values
    mean_quant = pd.DataFrame(quant_dat_all.mean(axis=1))
    mean_quant = mean_quant.reindex(io_utils.natsorted(mean_quant.index))
    feather.write_dataframe(
        mean_quant.T, os.path.join(base_dir, norm_vals_name_post_rownorm),
        compression="uncompressed")
    # the per-FOV quantile CSV is KEPT as the cohort's normalization ledger
