"""Cell consensus (meta) clustering and the metacluster-GUI remap.

Port of ``ark_tpu/phenotyping/cell_meta_clustering.py``: host pandas and the
port's ``PixieConsensusCluster`` (sklearn), fully in memory (cell tables are
small).
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.phenotyping import cell_cluster_utils, cluster_helpers
from ark_tpu_torch.utils.misc_utils import verify_in_list


def cell_consensus_cluster(base_dir, cell_som_cluster_cols,
                           cell_som_input_data, cell_som_expr_col_avg_name,
                           max_k=20, cap=3, seed=42, overwrite=False):
    """Consensus-cluster the cell SOM-average table; attach meta labels.
    Returns (PixieConsensusCluster, labeled input data)."""
    som_expr_col_avg_path = os.path.join(base_dir, cell_som_expr_col_avg_name)
    io_utils.validate_paths([som_expr_col_avg_path])
    cluster_count_sub = pd.read_csv(som_expr_col_avg_path, nrows=1)
    verify_in_list(provided_cluster_cols=cell_som_cluster_cols,
                   som_cluster_counts_cols=cluster_count_sub.columns.values)
    cell_cc = cluster_helpers.PixieConsensusCluster(
        "cell", som_expr_col_avg_path, cell_som_cluster_cols, max_k=max_k,
        cap=cap)
    if "cell_meta_cluster" in cell_som_input_data:
        if not overwrite:
            print("Meta clusters already assigned to each cell")
            return cell_cc, cell_som_input_data
        print("Overwrite flag set, reassigning meta cluster labels")
        cell_som_input_data = cell_som_input_data.drop(
            columns="cell_meta_cluster")
    print("z-score scaling and capping data")
    cell_cc.scale_data()
    np.random.seed(seed)
    print("Running consensus clustering")
    cell_cc.run_consensus_clustering()
    print("Mapping cell data to consensus cluster labels")
    cell_cc.generate_som_to_meta_map()
    cell_meta_assign = cell_cc.assign_consensus_labels(cell_som_input_data)
    return cell_cc, cell_meta_assign


def generate_meta_avg_files(base_dir, cell_cc, cell_som_cluster_cols,
                            cell_som_input_data, cell_som_expr_col_avg_name,
                            cell_meta_expr_col_avg_name, overwrite=False):
    """Save per-meta-cluster training-column averages; merge meta labels into
    the SOM-average table."""
    som_expr_col_avg_path = os.path.join(base_dir, cell_som_expr_col_avg_name)
    meta_expr_col_avg_path = os.path.join(base_dir, cell_meta_expr_col_avg_name)
    io_utils.validate_paths([som_expr_col_avg_path])
    if "cell_meta_cluster" not in cell_som_input_data.columns.values:
        raise ValueError("cell_som_input_data does not have meta labels assigned")
    if os.path.exists(meta_expr_col_avg_path):
        if not overwrite:
            print("Already generated average expression file for cell meta "
                  "clusters, skipping")
            return
        print("Overwrite flag set, regenerating average expression file for "
              "cell meta clusters")
    print("Computing the average value of each training column specified per "
          "cell meta cluster")
    meta_avgs = cell_cluster_utils.compute_cell_som_cluster_cols_avg(
        cell_som_input_data, cell_som_cluster_cols, "cell_meta_cluster",
        keep_count=True)
    meta_avgs.to_csv(meta_expr_col_avg_path, index=False)

    print("Mapping meta cluster values onto average expression values across "
          "cell SOM clusters")
    som_avgs = pd.read_csv(som_expr_col_avg_path)
    som_avgs["cell_som_cluster"] = som_avgs["cell_som_cluster"].astype(int)
    if "cell_meta_cluster" in som_avgs.columns.values:
        som_avgs = som_avgs.drop(columns="cell_meta_cluster")
    som_avgs = som_avgs.merge(cell_cc.mapping, on="cell_som_cluster", how="left")
    som_avgs.to_csv(som_expr_col_avg_path, index=False)


def apply_cell_meta_cluster_remapping(base_dir, cell_som_input_data,
                                      cell_remapped_name):
    """Apply the metacluster-GUI remap CSV to the cell data."""
    cell_remapped_path = os.path.join(base_dir, cell_remapped_name)
    io_utils.validate_paths([cell_remapped_path])
    remapped = pd.read_csv(cell_remapped_path)
    verify_in_list(
        required_cols=["cell_som_cluster", "cell_meta_cluster",
                       "cell_meta_cluster_rename"],
        remapped_data_cols=remapped.columns.values)
    remap_dict = dict(remapped[["cell_som_cluster", "cell_meta_cluster"]].values)
    cluster_helpers.verify_unique_meta_clusters(remapped,
                                                meta_cluster_type="cell")
    rename_dict = dict(remapped[
        ["cell_meta_cluster", "cell_meta_cluster_rename"]
    ].drop_duplicates().values)
    print("Using re-mapping scheme to re-label cell meta clusters")
    verify_in_list(fov_som_labels=cell_som_input_data["cell_som_cluster"],
                   som_labels_in_mapping=list(remap_dict.keys()))
    cell_som_input_data["cell_meta_cluster"] = \
        cell_som_input_data["cell_som_cluster"].map(remap_dict)
    cell_som_input_data["cell_meta_cluster_rename"] = \
        cell_som_input_data["cell_meta_cluster"].map(rename_dict)
    return cell_som_input_data


def generate_remap_avg_count_files(base_dir, cell_som_input_data,
                                   cell_remapped_name, cell_som_cluster_cols,
                                   cell_som_expr_col_avg_name,
                                   cell_meta_expr_col_avg_name):
    """Refresh the SOM/meta average-count tables after a GUI remap."""
    cell_remapped_path = os.path.join(base_dir, cell_remapped_name)
    som_expr_col_avg_path = os.path.join(base_dir, cell_som_expr_col_avg_name)
    meta_expr_col_avg_path = os.path.join(base_dir, cell_meta_expr_col_avg_name)
    io_utils.validate_paths([cell_remapped_path, som_expr_col_avg_path,
                             meta_expr_col_avg_path])
    remapped = pd.read_csv(cell_remapped_path)
    verify_in_list(
        required_cols=["cell_som_cluster", "cell_meta_cluster",
                       "cell_meta_cluster_rename"],
        remapped_data_cols=remapped.columns.values)
    remap_dict = dict(remapped[["cell_som_cluster", "cell_meta_cluster"]].values)
    rename_dict = dict(remapped[
        ["cell_meta_cluster", "cell_meta_cluster_rename"]
    ].drop_duplicates().values)

    print("Re-compute average value of each training column specified per "
          "cell meta cluster")
    meta_avgs = cell_cluster_utils.compute_cell_som_cluster_cols_avg(
        cell_som_input_data, cell_som_cluster_cols, "cell_meta_cluster",
        keep_count=True)
    meta_avgs["cell_meta_cluster_rename"] = \
        meta_avgs["cell_meta_cluster"].map(rename_dict)
    meta_avgs.to_csv(meta_expr_col_avg_path, index=False)

    print("Re-assigning meta cluster column in cell SOM cluster average pixel "
          "cluster counts data")
    som_avgs = pd.read_csv(som_expr_col_avg_path)
    som_avgs["cell_meta_cluster"] = \
        som_avgs["cell_som_cluster"].map(remap_dict)
    som_avgs["cell_meta_cluster_rename"] = \
        som_avgs["cell_meta_cluster"].map(rename_dict)
    som_avgs.to_csv(som_expr_col_avg_path, index=False)
