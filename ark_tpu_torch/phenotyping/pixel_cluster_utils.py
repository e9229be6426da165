"""Pixel-clustering utilities: cohort percentiles, row normalization, channel
smoothing/filtering, cluster channel averages, resume detection.

Port of ``ark_tpu/phenotyping/pixel_cluster_utils.py``. The quantiles and the
blur run on an explicit ``device`` through ``ark_tpu_torch.ops``; the rest is
the same host code (pandas, feathers, the temp-dir stage commit).
"""

from __future__ import annotations

import os
import random
import warnings
from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils, load_utils
from ark_tpu_torch.io.image_utils import save_image, read_image
from ark_tpu_torch.utils.misc_utils import verify_in_list
from ark_tpu_torch.ops import image_filters, quantiles


def _to_device(img, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(img, dtype=np.float32),
                           device=device)


def calculate_channel_percentiles(tiff_dir, fovs, channels, img_sub_folder,
                                  percentile, device="cuda") -> pd.DataFrame:
    """Mean over FOVs of the per-FOV nonzero-pixel `percentile` per channel.

    Channel order in the returned frame is natural-sorted (reference
    `pixel_cluster_utils.py:16-60`).
    """
    percentile_means = []
    for channel in channels:
        vals = []
        for fov in fovs:
            img = load_utils.load_imgs_from_tree(
                tiff_dir, img_sub_folder=img_sub_folder, channels=[channel],
                fovs=[fov]).values[0, :, :, 0]
            if (img > 0).any():
                vals.append(float(quantiles.nonzero_quantile(
                    _to_device(img, device), percentile)))
        percentile_means.append(np.mean(vals))
    df = pd.DataFrame(np.expand_dims(percentile_means, 0), columns=channels)
    return df[io_utils.natsorted(df.columns)]


def calculate_pixel_intensity_percentile(tiff_dir, fovs, channels,
                                         img_sub_folder, channel_percentiles,
                                         percentile=0.05, device="cuda") -> float:
    """Mean over FOVs of the `percentile` of channel-normalized total pixel
    signal (reference :63-106)."""
    norm_vect = _to_device(channel_percentiles.iloc[0].values, device)
    vals = []
    for fov in fovs:
        img = load_utils.load_imgs_from_tree(
            tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov],
            channels=channels).values[0]
        summed = torch.sum(_to_device(img, device) / norm_vect, dim=-1)
        vals.append(float(quantiles.quantile(summed, percentile)))
    return float(np.mean(vals))


def normalize_rows(pixel_data: pd.DataFrame, channels: List[str],
                   include_seg_label: bool = True) -> pd.DataFrame:
    """Divide each row's channel values by the row sum, keeping meta columns
    (reference :109-142)."""
    sub = pixel_data[channels]
    sub = sub.div(sub.sum(axis=1), axis=0)
    meta_cols = ["fov", "row_index", "column_index"]
    if include_seg_label:
        meta_cols.append("label")
    sub[meta_cols] = pixel_data.loc[sub.index.values, meta_cols]
    return sub


def check_for_modified_channels(tiff_dir, test_fov, img_sub_folder, channels):
    """Warn if a base channel was selected but a modified variant exists
    (reference :145-180)."""
    if img_sub_folder is None:
        img_sub_folder = ""
    all_channels = io_utils.remove_file_extensions(
        io_utils.list_files(os.path.join(tiff_dir, test_fov, img_sub_folder)))
    for channel in channels:
        for mod in ["_smoothed", "_nuc_include", "_nuc_exclude"]:
            if channel + mod in all_channels:
                warnings.warn(
                    f"You selected {channel} as the channel to analyze, but "
                    f"there were potential modified channels found: "
                    f"{channel + mod}. Make sure you selected the correct "
                    f"version of the channel for inclusion in clustering")


def smooth_channels(fovs, tiff_dir, img_sub_folder, channels, smooth_vals,
                    device="cuda"):
    """Write extra-smoothed `<chan>_smoothed.tiff` variants (reference
    :183-227); the blur runs on device."""
    if channels is None or len(channels) == 0:
        return
    if img_sub_folder is None:
        img_sub_folder = ""
    if isinstance(smooth_vals, int):
        smooth_vals = [smooth_vals] * len(channels)
    elif isinstance(smooth_vals, list):
        if len(smooth_vals) != len(channels):
            raise ValueError(
                "A list was provided for variable smooth_vals, but it does "
                "not have the same length as the list of channels provided")
    else:
        raise ValueError("Variable smooth_vals must be either a single "
                         "integer or a list")
    for fov in fovs:
        for chan, sval in zip(channels, smooth_vals):
            img = load_utils.load_imgs_from_tree(
                tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov],
                channels=[chan]).values[0, :, :, 0]
            out = image_filters.gaussian_blur(
                _to_device(img, device), sigma=float(sval)).cpu().numpy()
            save_image(os.path.join(tiff_dir, fov, img_sub_folder,
                                    chan + "_smoothed.tiff"), out)


def filter_with_nuclear_mask(fovs: List, tiff_dir: str, seg_dir: str,
                             channel: str, nuc_seg_suffix: str = "_nuclear.tiff",
                             img_sub_folder: str = None, exclude: bool = True):
    """Zero out nuclear (or non-nuclear) signal using the nuclear mask and
    save `<chan>_nuc_exclude/_nuc_include.tiff` (reference :230-291)."""
    if seg_dir is None:
        print("No seg_dir provided, you must provide one to run nuclear filtering")
        return
    io_utils.validate_paths(seg_dir)
    if img_sub_folder is None:
        img_sub_folder = ""
    for fov in fovs:
        img = load_utils.load_imgs_from_tree(
            tiff_dir, img_sub_folder=img_sub_folder, fovs=[fov],
            channels=[channel]).values[0, :, :, 0].copy()
        seg_img = read_image(os.path.join(seg_dir, f"{fov}{nuc_seg_suffix}"))
        if seg_img.ndim == 3:
            seg_img = seg_img[0]
        if exclude:
            suffix, seg_mask = "_nuc_exclude.tiff", seg_img > 0
        else:
            suffix, seg_mask = "_nuc_include.tiff", seg_img == 0
        img[seg_mask] = 0
        save_image(os.path.join(tiff_dir, fov, img_sub_folder,
                                channel + suffix), img)


def compute_pixel_cluster_channel_avg(fovs, channels, base_dir,
                                      pixel_cluster_col: str,
                                      num_pixel_clusters: Optional[int],
                                      pixel_data_dir='pixel_mat_data',
                                      num_fovs_subset=100, seed=42,
                                      keep_count=False,
                                      table_source=None) -> pd.DataFrame:
    """Average channel expression per pixel SOM/meta cluster over a ≤
    `num_fovs_subset` random FOV subset (reference :294-416): per-FOV
    groupby sums+counts, cohort-level merge, mean = sum/count.

    ``table_source``: optional ``(fov, columns) -> DataFrame | None`` hook —
    the fused single-sweep driver serves RAM-resident per-FOV frames
    (identical content to a column-selected feather read) so the averaging
    pass costs zero disk IO; ``None`` falls back to the on-disk feather."""
    verify_in_list(provided_cluster_col=[pixel_cluster_col],
                   valid_cluster_cols=["pixel_som_cluster", "pixel_meta_cluster"])
    if num_pixel_clusters is not None and num_pixel_clusters <= 0:
        raise ValueError("If set, number of pixel clusters desired must be "
                         "a positive integer")
    if num_fovs_subset <= 0:
        raise ValueError("Number of fovs to subset must be a positive integer")
    if len(fovs) < num_fovs_subset:
        warnings.warn(
            f"Provided num_fovs_subset={num_fovs_subset} but only {len(fovs)} "
            f"FOVs in dataset, subsetting just the {len(fovs)} FOVs")
    random.seed(seed)
    fovs_sub = random.sample(list(fovs), num_fovs_subset) \
        if num_fovs_subset < len(fovs) else list(fovs)

    per_fov = []
    need_cols = list(channels) + [pixel_cluster_col]
    for fov in fovs_sub:
        if table_source is not None:
            fov_data = table_source(fov, need_cols)
            if fov_data is not None:
                g = fov_data.groupby(pixel_cluster_col)
                agg = g[channels].sum()
                agg["count"] = g.size()
                per_fov.append(agg.reset_index())
                continue
        fov_path = os.path.join(base_dir, pixel_data_dir, fov + ".feather")
        try:
            # column-selected read: the groupby needs channels + the
            # cluster col only; skipping fov/coordinate/label columns
            # avoids deserializing ~20% of every per-FOV frame. The schema
            # is checked FIRST: a column-selected read of a file missing a
            # column raises ArrowInvalid, which the corrupt-file catch
            # below would silently swallow — a missing cluster column is a
            # pipeline-order bug and must crash (as the pandas path's
            # KeyError did)
            present = feather.read_column_names(fov_path)
        except FEATHER_READ_ERRORS:
            print(f"The data for FOV {fov} has been corrupted, skipping")
            continue
        missing = [c for c in need_cols if c not in present]
        if missing:
            raise KeyError(
                f"FOV {fov} pixel data is missing columns {missing}; "
                f"run the preceding clustering stage first")
        try:
            fov_data = feather.read_dataframe(fov_path, columns=need_cols)
        except FEATHER_READ_ERRORS:
            print(f"The data for FOV {fov} has been corrupted, skipping")
            continue
        g = fov_data.groupby(pixel_cluster_col)
        agg = g[channels].sum()
        agg["count"] = g.size()
        per_fov.append(agg.reset_index())

    totals = pd.concat(per_fov).groupby(pixel_cluster_col)[
        channels + ["count"]].sum().reset_index()
    if num_pixel_clusters is not None and totals.shape[0] < num_pixel_clusters:
        raise ValueError(
            f"Averaged data contains just {totals.shape[0]} clusters out of "
            f"{num_pixel_clusters}. Average expression file not written. "
            f"Consider increasing your num_fovs_subset value.")
    totals[channels] = totals[channels].div(totals["count"], axis=0)
    totals[pixel_cluster_col] = totals[pixel_cluster_col].astype(int)
    totals = totals.sort_values(by=pixel_cluster_col)
    if not keep_count:
        totals = totals.drop("count", axis=1)
    return totals


def ignore_extended_attributes(func, filename, exc) -> None:
    """shutil.rmtree onexc handler: tolerate macOS extended-attribute
    ('._*') files (reference `pixel_som_clustering.py:292-305`)."""
    if not (func is os.unlink
            and os.path.basename(filename).startswith("._")):
        raise


# Errors a truncated/corrupted feather file can raise on a schema or data
# read. Caught by explicit class (ADVICE r2): pyarrow raises ArrowInvalid on
# bad magic, ArrowIOError/OSError on short reads, and ValueError from some
# footer-decode paths — an unrelated error class still propagates.
try:  # pyarrow is a hard dep of io.feather_utils, but guard anyway
    import pyarrow.lib as _pa_lib
    _ARROW_ERRORS = (_pa_lib.ArrowInvalid, _pa_lib.ArrowIOError)
except Exception:  # pragma: no cover - pyarrow always present in this env
    _ARROW_ERRORS = ()
FEATHER_READ_ERRORS = _ARROW_ERRORS + (OSError, IOError, ValueError)


def _readable_feather(path: str) -> bool:
    """True if the feather's schema is readable (a truncated file from a
    killed run is not)."""
    try:
        feather.read_column_names(path)
        return True
    except FEATHER_READ_ERRORS:
        return False


_STAGE_MARKER = ".stage"


def _temp_stage(data_path: str):
    """Stage tag recorded inside `<data_path>_temp`, or None if untagged."""
    try:
        with open(os.path.join(data_path + "_temp", _STAGE_MARKER)) as f:
            return f.read().strip()
    except OSError:
        return None


def claim_temp_dir(data_path: str, stage: str) -> bool:
    """Create (or adopt) `<data_path>_temp` for `stage`, returning True if
    the dir pre-existed for the SAME stage (resumable progress).

    The SOM-assignment, consensus, and remap stages all stage into the same
    `<data>_temp` path; a temp dir stranded by a DIFFERENT stage's crash
    must not count as this stage's progress (its files lack this stage's
    labels and would be committed unprocessed — ADVICE r2). Such a stranded
    dir is wiped: its originals are intact, because the lossless
    `commit_temp_dir` never removes originals before the swap."""
    import shutil

    temp_path = data_path + "_temp"
    resumable = False
    if os.path.exists(temp_path):
        if _temp_stage(data_path) == stage:
            resumable = True
        else:
            shutil.rmtree(temp_path, onexc=ignore_extended_attributes)
    if not os.path.exists(temp_path):
        os.mkdir(temp_path)
    with open(os.path.join(temp_path, _STAGE_MARKER), "w") as f:
        f.write(stage)
    return resumable


def valid_temp_files(data_path: str, stage: str = None) -> set:
    """Feather filenames in `<data_path>_temp` that are intact. Files a
    killed run truncated mid-write do NOT count as processed — they must be
    redone, and `commit_temp_dir` must not let them shadow the originals.
    With `stage` given, a temp dir tagged for a different stage counts as
    having no valid files (its progress belongs to that other stage)."""
    temp_path = data_path + "_temp"
    if not os.path.exists(temp_path):
        return set()
    if stage is not None and _temp_stage(data_path) != stage:
        return set()
    return {f for f in io_utils.list_files(temp_path, substrs=".feather")
            if _readable_feather(os.path.join(temp_path, f))}


def commit_temp_dir(data_path: str) -> None:
    """Atomically commit `<data_path>_temp` over `data_path`, losslessly.

    The reference's bare `rmtree(dir); move(temp, dir)`
    (`pixel_som_clustering.py:287-289`) silently DELETES any feather that
    never made it into the temp dir — unrequested FOVs when the caller
    passed a subset, and corrupted FOVs the stage skipped. Here those
    survivors are moved into the temp dir first (overwriting any truncated
    half-written temp file), so the swap can only add or update files,
    never drop them.
    """
    import shutil

    temp_path = data_path + "_temp"
    intact = valid_temp_files(data_path)
    # move EVERY file the stage didn't (re)produce, not just feathers: the
    # per-FOV quantile CSV (the cohort normalization ledger
    # create_pixel_matrix deliberately keeps) lives in the data dir and was
    # silently deleted by the feather-only sweep — after which an
    # incremental preprocess run would rebuild the cohort norm from only
    # the newly added FOVs
    for f in os.listdir(data_path):
        if f not in intact and os.path.isfile(os.path.join(data_path, f)):
            shutil.move(os.path.join(data_path, f),
                        os.path.join(temp_path, f))
    marker = os.path.join(temp_path, _STAGE_MARKER)
    if os.path.exists(marker):  # stage tag must not land in the data dir
        os.remove(marker)
    shutil.rmtree(data_path, onexc=ignore_extended_attributes)
    shutil.move(temp_path, data_path)


def _file_missing_col(path: str, missing_col: str) -> bool:
    """True if the feather at `path` lacks `missing_col` OR is unreadable
    (corrupted files are surfaced to the stage, which skips + reports)."""
    try:
        return missing_col not in feather.read_column_names(path)
    except FEATHER_READ_ERRORS:
        return True


def find_fovs_missing_col(base_dir, data_dir, missing_col) -> List[str]:
    """FOVs in `data_dir` still lacking `missing_col`; the `<data_dir>_temp`
    directory marks an in-progress stage (reference :419-478).

    Unlike the reference (which schema-samples ONE file and assumes the
    whole directory matches), every file is schema-checked — the lossless
    `commit_temp_dir` swap permits mixed per-file states, e.g. after a
    subset-of-FOVs run. Schema reads don't touch the data, so this stays
    O(cohort) in file opens, not bytes."""
    import shutil

    data_path = os.path.join(base_dir, data_dir)
    temp_path = os.path.join(base_dir, data_dir + "_temp")
    io_utils.validate_paths(data_path)

    in_progress = (os.path.exists(temp_path)
                   and _temp_stage(data_path) == missing_col)
    if not in_progress:
        if os.path.exists(temp_path):
            # stranded by a DIFFERENT stage's crash (stage tags differ) —
            # its partial work belongs to that stage and its originals are
            # intact; wipe it rather than counting it as progress here
            shutil.rmtree(temp_path, onexc=ignore_extended_attributes)
        fov_files = io_utils.list_files(data_path, substrs=".feather")
        missing = [f for f in fov_files
                   if _file_missing_col(os.path.join(data_path, f),
                                        missing_col)]
        if missing:
            claim_temp_dir(data_path, missing_col)
            return io_utils.remove_file_extensions(missing)
        return []
    # in-progress: redo files that still lack the col and are not ALREADY
    # validly processed into temp (a truncated temp feather from a killed
    # run does not count — it gets rewritten, never committed as-is)
    data_files = set(
        f for f in io_utils.list_files(data_path, substrs=".feather")
        if _file_missing_col(os.path.join(data_path, f), missing_col))
    temp_files = valid_temp_files(data_path, stage=missing_col)
    return io_utils.remove_file_extensions(list(data_files - temp_files))
