"""Pixel SOM training + cohort SOM-label assignment.

Port of ``ark_tpu/phenotyping/pixel_som_clustering.py`` (train_pixel_som,
cluster_pixels with the temp-dir atomic swap, generate_som_avg_files): host
code over the port's ``cluster_helpers``, whose SOM trains and maps on the
``device`` given to ``train_pixel_som`` (the BMU kernel on a CUDA device).
`multiprocess`/`batch_size` are API-compat no-ops."""

from __future__ import annotations

import os
from shutil import rmtree
from typing import Tuple

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list, verify_same_elements
from ark_tpu_torch.phenotyping import cluster_helpers, pixel_cluster_utils


def train_pixel_som(fovs, channels, base_dir,
                    subset_dir="pixel_mat_subsetted",
                    norm_vals_name="post_rowsum_chan_norm.feather",
                    som_weights_name="pixel_som_weights.feather",
                    xdim=10, ydim=10, lr_start=0.05, lr_end=0.01,
                    num_passes=1, seed=42, overwrite=False, device="cuda"):
    """Train the pixel SOM on `device` on the subsetted data; save weights
    feather."""
    subsetted_path = os.path.join(base_dir, subset_dir)
    norm_vals_path = os.path.join(base_dir, norm_vals_name)
    som_weights_path = os.path.join(base_dir, som_weights_name)
    io_utils.validate_paths([subsetted_path, norm_vals_path])

    files = io_utils.list_files(subsetted_path, substrs=".feather")
    verify_in_list(provided_fovs=fovs,
                   subsetted_fovs=io_utils.remove_file_extensions(files))
    sample_sub = feather.read_dataframe(os.path.join(subsetted_path, files[0]))
    verify_in_list(provided_channels=channels,
                   subsetted_channels=sample_sub.columns.values)

    pixel_pysom = cluster_helpers.PixelSOMCluster(
        subsetted_path, norm_vals_path, som_weights_path, fovs, channels,
        num_passes=num_passes, xdim=xdim, ydim=ydim, lr_start=lr_start,
        lr_end=lr_end, seed=seed, device=device)
    print("Training SOM")
    pixel_pysom.train_som(overwrite=overwrite)
    return pixel_pysom


def run_pixel_som_assignment(pixel_data_path, pixel_pysom_obj, overwrite,
                             num_parallel_pixels, fov) -> Tuple[str, int]:
    """Assign SOM labels to one FOV's pixel feather; write to the temp dir.
    Returns (fov, 0) on success or (fov, 1) for a corrupted file.

    Runs on arrow Tables end to end: only the channel columns are
    deserialized (they feed the BMU kernel and are rewritten normalized);
    fov/coordinate/label columns pass straight from the input buffers to
    the output file. The pandas round trip made this pass host-IO-bound at
    cohort scale (PERF.md 100-FOV endurance run); read-back parity with
    the DataFrame path is pinned by
    tests/phenotyping/test_arrow_pass_parity.py."""
    fov_path = os.path.join(pixel_data_path, fov + ".feather")
    try:
        fov_table = feather.read_table(fov_path)
    except pixel_cluster_utils.FEATHER_READ_ERRORS:
        return fov, 1
    if overwrite and "pixel_som_cluster" in fov_table.column_names:
        fov_table = fov_table.drop_columns(["pixel_som_cluster"])
    fov_table = pixel_pysom_obj.assign_som_clusters_table(
        fov_table, normalize_data=not overwrite,
        num_parallel_pixels=num_parallel_pixels)
    temp_path = os.path.join(pixel_data_path + "_temp", fov + ".feather")
    feather.write_table(fov_table, temp_path, compression="uncompressed")
    return fov, 0


def cluster_pixels(fovs, base_dir, pixel_pysom, data_dir="pixel_mat_data",
                   multiprocess=False, batch_size=5,
                   num_parallel_pixels=1_000_000, overwrite=False):
    """Assign SOM cluster labels to the full per-FOV pixel data; atomic
    temp-dir swap on completion (reference :287-289)."""
    data_path = os.path.join(base_dir, data_dir)
    io_utils.validate_paths([data_path])
    if pixel_pysom.weights is None:
        raise ValueError("Using untrained pixel_pysom object, please invoke "
                         "train_pixel_som first")

    data_files = io_utils.list_files(data_path, substrs=".feather")
    verify_in_list(provided_fovs=fovs,
                   subsetted_fovs=io_utils.remove_file_extensions(data_files))

    sample_fov = None
    for f in data_files:
        try:
            sample_fov = feather.read_dataframe(os.path.join(data_path, f))
            if "segmentation_label" in sample_fov.columns:
                sample_fov = sample_fov.rename(
                    columns={"segmentation_label": "label"})
            break
        except pixel_cluster_utils.FEATHER_READ_ERRORS:
            continue
    cols_to_drop = ["fov", "row_index", "column_index"]
    for col in ["label", "pixel_som_cluster", "pixel_meta_cluster",
                "pixel_meta_cluster_rename"]:
        if col in sample_fov.columns.values:
            cols_to_drop.append(col)
    sample_fov = sample_fov.drop(columns=cols_to_drop)
    verify_same_elements(enforce_order=True,
                         norm_vals_columns=list(pixel_pysom.norm_data.columns),
                         pixel_data_columns=list(sample_fov.columns))
    verify_same_elements(enforce_order=True,
                         pixel_som_weights_columns=list(pixel_pysom.weights.columns),
                         pixel_data_columns=list(sample_fov.columns))

    if overwrite:
        print("Overwrite flag set, reassigning SOM cluster labels to all FOVs")
        pixel_pysom.som_clusters_seen = set()
        # a stale _temp from a run killed mid-overwrite would make the
        # reference's bare mkdir crash (:223); wipe it — overwrite means a
        # fresh assignment, so partial results from the dead run are garbage
        if os.path.exists(data_path + "_temp"):
            rmtree(data_path + "_temp",
                   onexc=pixel_cluster_utils.ignore_extended_attributes)
        pixel_cluster_utils.claim_temp_dir(data_path, "pixel_som_cluster")
        fovs_list = io_utils.remove_file_extensions(
            io_utils.list_files(data_path, substrs=".feather"))
    else:
        fovs_list = pixel_cluster_utils.find_fovs_missing_col(
            base_dir, data_dir, "pixel_som_cluster")
    fovs_list = list(set(fovs_list).intersection(fovs))
    if len(fovs_list) == 0:
        print("There are no more FOVs to assign SOM labels to, skipping")
        # a run killed after its last FOV leaves finished work stranded in
        # the temp dir — commit it instead of leaving labels invisible
        if os.path.exists(data_path + "_temp"):
            pixel_cluster_utils.commit_temp_dir(data_path)
        return
    if len(fovs_list) < len(fovs):
        print(f"Restarting SOM label assignment from fov {fovs_list[0]}, "
              f"{len(fovs_list)} fovs left to process")

    print("Mapping pixel data to SOM cluster labels")
    fovs_processed = 0
    for fov in fovs_list:
        fov_status = run_pixel_som_assignment(
            data_path, pixel_pysom, overwrite, num_parallel_pixels, fov)
        if fov_status[1] == 1:
            print(f"The data for FOV {fov_status[0]} has been corrupted, skipping")
            fovs_processed -= 1
        fovs_processed += 1
        if fovs_processed % 10 == 0 or fovs_processed == len(fovs_list):
            print(f"Processed {fovs_processed} fovs")

    # atomic lossless stage commit (unprocessed/corrupted FOV files survive)
    pixel_cluster_utils.commit_temp_dir(data_path)


def generate_som_avg_files(fovs, channels, base_dir, pixel_pysom,
                           data_dir="pixel_data_dir",
                           pc_chan_avg_som_cluster_name="pixel_channel_avg_som_cluster.csv",
                           num_fovs_subset=100, require_all_som_clusters=True,
                           seed=42, overwrite=False, table_source=None):
    """Save average channel expression per pixel SOM cluster (+count).

    ``table_source``: optional per-FOV frame hook forwarded to
    ``compute_pixel_cluster_channel_avg`` (fused driver's zero-IO path)."""
    som_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_som_cluster_name)
    if pixel_pysom.weights is None:
        raise ValueError("Using untrained pixel_pysom object, please invoke "
                         "train_som first")
    if os.path.exists(som_cluster_avg_path):
        if not overwrite:
            print("Already generated SOM cluster channel average file, skipping")
            return
        print("Overwrite flag set, regenerating SOM cluster channel average file")

    print("Computing average channel expression across pixel SOM clusters")
    # the seen-set (reference `pixel_som_clustering.py:360`) is only
    # populated by assignments made in THIS process: in a resumed session
    # (cluster_pixels skipped everything) it is empty, and the reference
    # passes 0 and always raises — fall back to an unchecked average with
    # a warning instead of wedging the resume
    expected = None
    if require_all_som_clusters:
        if pixel_pysom.som_clusters_seen:
            expected = len(pixel_pysom.som_clusters_seen)
        else:
            import warnings
            warnings.warn(
                "no SOM assignments ran in this session (resumed run): "
                "skipping the all-clusters completeness check")
    avg = pixel_cluster_utils.compute_pixel_cluster_channel_avg(
        fovs, channels, base_dir, "pixel_som_cluster", expected,
        data_dir, num_fovs_subset=num_fovs_subset, seed=seed, keep_count=True,
        table_source=table_source)
    feather.write_csv(avg, som_cluster_avg_path, index=False)
