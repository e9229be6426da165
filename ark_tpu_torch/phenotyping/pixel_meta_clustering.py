"""Pixel consensus (meta) clustering + GUI remap application.

Port of ``ark_tpu/phenotyping/pixel_meta_clustering.py``: host code (numpy,
sklearn, pandas, feathers) over the port's ``cluster_helpers``. Per-FOV
label assignment writes to `<data_dir>_temp` then atomically swaps,
preserving the reference's resume semantics."""

from __future__ import annotations

import os
from shutil import rmtree
from typing import Tuple

import numpy as np
import pandas as pd

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list
from ark_tpu_torch.phenotyping import cluster_helpers, pixel_cluster_utils


def run_pixel_consensus_assignment(pixel_data_path, pixel_cc_obj,
                                   fov) -> Tuple[str, int]:
    """Assign meta-cluster labels to one FOV feather via the SOM→meta map.

    Arrow-Table passthrough: only the SOM-label column is deserialized; the
    ~20 untouched columns copy buffer-to-buffer (the pandas round trip made
    this pass host-IO-bound at cohort scale — PERF.md endurance run).
    Parity: tests/phenotyping/test_arrow_pass_parity.py."""
    fov_path = os.path.join(pixel_data_path, fov + ".feather")
    try:
        fov_table = feather.read_table(fov_path)
    except pixel_cluster_utils.FEATHER_READ_ERRORS:
        return fov, 1
    fov_table = pixel_cc_obj.assign_consensus_labels_table(fov_table)
    temp_path = os.path.join(pixel_data_path + "_temp", fov + ".feather")
    feather.write_table(fov_table, temp_path, compression="uncompressed")
    return fov, 0


def pixel_consensus_cluster(fovs, channels, base_dir, max_k=20, cap=3,
                            data_dir="pixel_mat_data",
                            pc_chan_avg_som_cluster_name="pixel_channel_avg_som_cluster.csv",
                            multiprocess=False, batch_size=5, seed=42,
                            overwrite=False):
    """Consensus-cluster the SOM-average table; fan meta labels out per FOV."""
    pixel_data_path = os.path.join(base_dir, data_dir)
    som_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_som_cluster_name)
    io_utils.validate_paths([pixel_data_path, som_cluster_avg_path])

    if overwrite:
        print("Overwrite flag set, reassigning meta cluster labels to all FOVs")
        # tolerate a stale _temp left by a run killed mid-overwrite (the
        # reference's bare mkdir crashes on it); overwrite restarts cleanly
        if os.path.exists(pixel_data_path + "_temp"):
            rmtree(pixel_data_path + "_temp",
                   onexc=pixel_cluster_utils.ignore_extended_attributes)
        pixel_cluster_utils.claim_temp_dir(pixel_data_path,
                                           "pixel_meta_cluster")
        fovs_list = io_utils.remove_file_extensions(
            io_utils.list_files(pixel_data_path, substrs=".feather"))
    else:
        fovs_list = pixel_cluster_utils.find_fovs_missing_col(
            base_dir, data_dir, "pixel_meta_cluster")
    fovs_list = list(set(fovs_list).intersection(fovs))

    # deterministic (seeded) consensus over the small SOM-average table;
    # built even when no FOVs are left so callers always receive the
    # PixieConsensusCluster the avg-file generators need (the reference
    # returns None on its skip path and the notebook crashes downstream)
    pixel_cc = cluster_helpers.PixieConsensusCluster(
        "pixel", som_cluster_avg_path, channels, max_k=max_k, cap=cap)
    print("z-score scaling and capping data")
    pixel_cc.scale_data()
    np.random.seed(seed)
    print("Running consensus clustering")
    pixel_cc.run_consensus_clustering()
    pixel_cc.generate_som_to_meta_map()

    if len(fovs_list) == 0:
        print("There are no more FOVs to assign meta labels to, skipping")
        # a run killed after its last FOV leaves finished work stranded in
        # the temp dir — commit it instead of leaving labels invisible
        if os.path.exists(pixel_data_path + "_temp"):
            pixel_cluster_utils.commit_temp_dir(pixel_data_path)
        return pixel_cc
    if len(fovs_list) < len(fovs):
        print(f"Restarting meta cluster label assignment from fov "
              f"{fovs_list[0]}, {len(fovs_list)} fovs left to process")

    print("Mapping pixel data to consensus cluster labels")
    fovs_processed = 0
    for fov in fovs_list:
        fov_status = run_pixel_consensus_assignment(pixel_data_path, pixel_cc, fov)
        if fov_status[1] == 1:
            print(f"The data for FOV {fov_status[0]} has been corrupted, skipping")
            fovs_processed -= 1
        fovs_processed += 1
        if fovs_processed % 10 == 0 or fovs_processed == len(fovs_list):
            print(f"Processed {fovs_processed} fovs")

    pixel_cluster_utils.commit_temp_dir(pixel_data_path)
    return pixel_cc


def generate_meta_avg_files(fovs, channels, base_dir, pixel_cc,
                            data_dir="pixel_mat_data",
                            pc_chan_avg_som_cluster_name="pixel_channel_avg_som_cluster.csv",
                            pc_chan_avg_meta_cluster_name="pixel_channel_avg_meta_cluster.csv",
                            num_fovs_subset=100, seed=42, overwrite=False,
                            table_source=None):
    """Save per-meta-cluster channel averages; merge meta labels into the
    SOM-average table.

    ``table_source``: optional per-FOV frame hook forwarded to
    ``compute_pixel_cluster_channel_avg`` (fused driver's zero-IO path)."""
    som_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_som_cluster_name)
    meta_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_meta_cluster_name)
    io_utils.validate_paths([som_cluster_avg_path])
    if os.path.exists(meta_cluster_avg_path):
        if not overwrite:
            print("Already generated meta cluster channel average file, skipping")
            return
        print("Overwrite flag set, regenerating meta cluster channel average file")

    print("Computing average channel expression across pixel meta clusters")
    avg = pixel_cluster_utils.compute_pixel_cluster_channel_avg(
        fovs, channels, base_dir, "pixel_meta_cluster", pixel_cc.max_k,
        data_dir, num_fovs_subset=num_fovs_subset, seed=seed, keep_count=True,
        table_source=table_source)
    avg.to_csv(meta_cluster_avg_path, index=False)

    print("Mapping meta cluster values onto average channel expression across "
          "pixel SOM clusters")
    som_avg = pd.read_csv(som_cluster_avg_path)
    if "pixel_meta_cluster" in som_avg.columns.values:
        som_avg = som_avg.drop(columns="pixel_meta_cluster")
    som_avg["pixel_som_cluster"] = som_avg["pixel_som_cluster"].astype(int)
    som_avg = som_avg.merge(pixel_cc.mapping, on="pixel_som_cluster", how="left")
    som_avg.to_csv(som_cluster_avg_path, index=False)


def update_pixel_meta_labels(pixel_data_path, pixel_remapped_dict,
                             pixel_renamed_meta_dict, fov) -> Tuple[str, int]:
    """Apply the GUI remap (SOM→meta + meta→name) to one FOV feather.

    Arrow-Table passthrough like `run_pixel_consensus_assignment`: the
    SOM-label column is the only one deserialized; the two remapped columns
    are computed with the same `Series.map`s as the DataFrame path and
    replace-or-append in the same positions.
    Parity: tests/phenotyping/test_arrow_pass_parity.py."""
    fov_path = os.path.join(pixel_data_path, fov + ".feather")
    try:
        fov_table = feather.read_table(fov_path)
    except pixel_cluster_utils.FEATHER_READ_ERRORS:
        return fov, 1
    som = fov_table.column("pixel_som_cluster").to_pandas()
    verify_in_list(fov_som_labels=som.unique(),
                   som_labels_in_mapping=list(pixel_remapped_dict.keys()))
    meta = som.map(pixel_remapped_dict)
    rename = meta.map(pixel_renamed_meta_dict)
    fov_table = feather.table_set_columns(
        fov_table, {"pixel_meta_cluster": meta,
                    "pixel_meta_cluster_rename": rename})
    temp_path = os.path.join(pixel_data_path + "_temp", fov + ".feather")
    feather.write_table(fov_table, temp_path, compression="uncompressed")
    return fov, 0


def apply_pixel_meta_cluster_remapping(fovs, channels, base_dir,
                                       pixel_data_dir, pixel_remapped_name,
                                       multiprocess=False, batch_size=5):
    """Apply the metacluster-GUI remap CSV to every FOV (re-entrant)."""
    pixel_data_path = os.path.join(base_dir, pixel_data_dir)
    pixel_remapped_path = os.path.join(base_dir, pixel_remapped_name)
    io_utils.validate_paths([pixel_data_path, pixel_remapped_path])

    remapped = pd.read_csv(pixel_remapped_path)
    verify_in_list(
        required_cols=["pixel_som_cluster", "pixel_meta_cluster",
                       "pixel_meta_cluster_rename"],
        remapped_data_cols=remapped.columns.values)
    remap_dict = dict(
        remapped[["pixel_som_cluster", "pixel_meta_cluster"]].values)
    cluster_helpers.verify_unique_meta_clusters(remapped,
                                                meta_cluster_type="pixel")
    rename_dict = dict(remapped[
        ["pixel_meta_cluster", "pixel_meta_cluster_rename"]
    ].drop_duplicates().values)

    # the stage tag ("remap") keeps a temp dir stranded by a crashed SOM or
    # consensus stage from masquerading as remap progress (ADVICE r2)
    if not pixel_cluster_utils.claim_temp_dir(pixel_data_path, "remap"):
        fov_list = fovs
    else:
        # resume after a crash: done-ness for a remap is "validly written
        # into temp", NOT "has the rename column" — a RE-remap with an
        # edited CSV rewrites files that already carry the column from the
        # previous mapping, so a column check would skip them all
        done = {os.path.splitext(f)[0] for f in
                pixel_cluster_utils.valid_temp_files(pixel_data_path,
                                                     stage="remap")}
        fov_list = [f for f in fovs if f not in done]
        if fov_list:
            print(f"Restarting meta cluster remapping assignment from "
                  f"{fov_list[0]}, {len(fov_list)} fovs left to process")

    print("Using re-mapping scheme to re-label pixel meta clusters")
    fovs_processed = 0
    for fov in fov_list:
        fov_status = update_pixel_meta_labels(
            pixel_data_path, remap_dict, rename_dict, fov)
        if fov_status[1] == 1:
            print(f"The data for FOV {fov_status[0]} has been corrupted, skipping")
            fovs_processed -= 1
        fovs_processed += 1
        if fovs_processed % 10 == 0 or fovs_processed == len(fov_list):
            print(f"Processed {fovs_processed} fovs")

    pixel_cluster_utils.commit_temp_dir(pixel_data_path)


def generate_remap_avg_files(fovs, channels, base_dir, pixel_data_dir,
                             pixel_remapped_name,
                             pc_chan_avg_som_cluster_name,
                             pc_chan_avg_meta_cluster_name,
                             num_fovs_subset=100, seed=42):
    """Recompute meta-cluster channel averages after a GUI remap and refresh
    the SOM-average table's meta columns."""
    pixel_remapped_path = os.path.join(base_dir, pixel_remapped_name)
    som_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_som_cluster_name)
    meta_cluster_avg_path = os.path.join(base_dir, pc_chan_avg_meta_cluster_name)
    io_utils.validate_paths([pixel_remapped_path, som_cluster_avg_path,
                             meta_cluster_avg_path])

    remapped = pd.read_csv(pixel_remapped_path)
    remap_dict = dict(
        remapped[["pixel_som_cluster", "pixel_meta_cluster"]].values)
    rename_dict = dict(remapped[
        ["pixel_meta_cluster", "pixel_meta_cluster_rename"]
    ].drop_duplicates().values)

    print("Re-computing average channel expression across pixel meta clusters")
    meta_avg = pixel_cluster_utils.compute_pixel_cluster_channel_avg(
        fovs, channels, base_dir, "pixel_meta_cluster",
        len(remapped["pixel_meta_cluster"].unique()), pixel_data_dir,
        num_fovs_subset=num_fovs_subset, seed=seed, keep_count=True)
    meta_avg["pixel_meta_cluster_rename"] = \
        meta_avg["pixel_meta_cluster"].map(rename_dict)
    meta_avg.to_csv(meta_cluster_avg_path, index=False)

    print("Re-assigning meta cluster column in pixel SOM cluster average "
          "channel expression table")
    som_avg = pd.read_csv(som_cluster_avg_path)
    som_avg["pixel_meta_cluster"] = \
        som_avg["pixel_som_cluster"].map(remap_dict)
    som_avg["pixel_meta_cluster_rename"] = \
        som_avg["pixel_meta_cluster"].map(rename_dict)
    som_avg.to_csv(som_cluster_avg_path, index=False)
