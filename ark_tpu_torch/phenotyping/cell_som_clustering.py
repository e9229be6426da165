"""Cell SOM training and assignment.

Port of ``ark_tpu/phenotyping/cell_som_clustering.py``. The SOM trains and
maps on `device` through ``cluster_helpers.CellSOMCluster``; on a CUDA
device the assignment runs the BMU kernel.
"""

from __future__ import annotations

import os

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.phenotyping import cell_cluster_utils, cluster_helpers
from ark_tpu_torch.utils.misc_utils import verify_in_list


def train_cell_som(fovs, base_dir, cell_table_path, cell_som_cluster_cols,
                   cell_som_input_data,
                   som_weights_name="cell_som_weights.feather", xdim=10,
                   ydim=10, lr_start=0.05, lr_end=0.01, num_passes=1, seed=42,
                   overwrite=False, normalize=True, *, device):
    """Train the cell SOM on `cell_som_cluster_cols` on `device`; save the
    weights feather under `base_dir`. Returns the CellSOMCluster."""
    som_weights_path = os.path.join(base_dir, som_weights_name)
    io_utils.validate_paths([cell_table_path])
    verify_in_list(provided_cluster_cols=cell_som_cluster_cols,
                   som_input_cluster_cols=cell_som_input_data.columns.values)
    cell_pysom = cluster_helpers.CellSOMCluster(
        cell_som_input_data, som_weights_path, fovs, cell_som_cluster_cols,
        num_passes=num_passes, xdim=xdim, ydim=ydim, lr_start=lr_start,
        lr_end=lr_end, seed=seed, normalize=normalize, device=device)
    print("Training SOM")
    cell_pysom.train_som(overwrite=overwrite)
    return cell_pysom


def cluster_cells(base_dir, cell_pysom, cell_som_cluster_cols,
                  num_parallel_cells=1_000_000, overwrite=False):
    """Assign SOM cluster labels to the full cell data (on the SOM's
    device)."""
    if cell_pysom.weights is None:
        raise ValueError("Using untrained cell_pysom object, please invoke "
                         "train_cell_som first")
    if "segmentation_label" in cell_pysom.cell_data.columns:
        cell_pysom.cell_data = cell_pysom.cell_data.rename(
            columns={"segmentation_label": "label"})

    cols_to_drop = ["fov", "label"]
    if "cell_size" in cell_pysom.cell_data.columns.values:
        cols_to_drop.append("cell_size")
    if "cell_som_cluster" in cell_pysom.cell_data.columns.values:
        if not overwrite:
            print("SOM clusters already assigned to each cell")
            return cell_pysom.cell_data
        print("Overwrite flag set, reassigning SOM cluster labels")
        cols_to_drop.append("cell_som_cluster")

    cell_som_input_data = cell_pysom.cell_data.drop(columns=cols_to_drop)
    verify_in_list(cell_weights_columns=list(cell_pysom.weights.columns),
                   cell_som_input_data_columns=cell_som_input_data.columns.values)
    print("Mapping cell data to SOM cluster labels")
    return cell_pysom.assign_som_clusters(num_parallel_cells)


def generate_som_avg_files(base_dir, cell_som_input_data,
                           cell_som_cluster_cols, cell_som_expr_col_avg_name,
                           overwrite=False):
    """Save the average of the training columns per cell SOM cluster, with
    counts."""
    som_expr_col_avg_path = os.path.join(base_dir, cell_som_expr_col_avg_name)
    if "cell_som_cluster" not in cell_som_input_data.columns.values:
        raise ValueError("cell_som_input_data does not have SOM labels assigned")
    if os.path.exists(som_expr_col_avg_path):
        if not overwrite:
            print("Already generated average expression file for each cell "
                  "SOM column, skipping")
            return
        print("Overwrite flag set, regenerating average expression file for "
              "cell SOM clusters")
    print("Computing the average value of each training column specified per "
          "cell SOM cluster")
    avgs = cell_cluster_utils.compute_cell_som_cluster_cols_avg(
        cell_som_input_data, cell_som_cluster_cols, "cell_som_cluster",
        keep_count=True)
    avgs.to_csv(som_expr_col_avg_path, index=False)
