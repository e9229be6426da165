"""Neighborhood diversity + mean distance to k-nearest cells of each type.

Port of ``ark_tpu/analysis/cell_neighborhood_stats.py`` (reference
`src/ark/analysis/cell_neighborhood_stats.py`: shannon_diversity :13-25,
compute_neighborhood_diversity :28-83,
generate_neighborhood_diversity_analysis :86-115,
calculate_mean_distance_to_cell_type :118-159 and cohort drivers
:162-245). Diversity is one vectorized numpy pass per FOV; the k-nearest
mean distances take a top-k on `device` (default "cuda"), with each FOV's
distance matrix uploaded once. No progress bars: tqdm is not on every
machine the port runs on."""

from __future__ import annotations

import os
from functools import reduce

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.analysis import spatial_analysis_utils
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.ops import distances as dist_ops
from ark_tpu_torch.ops.som import _as_f32_tensor
from ark_tpu_torch.utils.misc_utils import verify_in_list


def shannon_diversity(proportions) -> float:
    """Shannon index (log2) over a proportion vector."""
    proportions = np.asarray(proportions)
    pos = proportions[proportions > 0]
    return float(-np.sum(pos * np.log2(pos)))


def compute_neighborhood_diversity(neighborhood_mat, cell_type_col):
    """Per-cell Shannon diversity over neighbor frequencies."""
    verify_in_list(cell_type_column=cell_type_col,
                   neighbor_matrix_columns=neighborhood_mat.columns)
    meta_cols = [settings.FOV_ID, settings.CELL_LABEL, cell_type_col]
    values = np.asarray(neighborhood_mat.drop(columns=meta_cols),
                        dtype=np.float64)
    if (values > 1).any():
        raise ValueError("Input must be frequency values.")

    # vectorized Shannon index over all cells at once
    with np.errstate(divide="ignore", invalid="ignore"):
        logs = np.where(values > 0, np.log2(values, where=values > 0), 0.0)
    scores = -np.sum(values * logs, axis=1)

    diversity_data = neighborhood_mat[meta_cols].copy()
    diversity_data[f"diversity_{cell_type_col}"] = scores
    return diversity_data.reset_index(drop=True)


def generate_neighborhood_diversity_analysis(neighbors_mat_dir, pixel_radius,
                                             cell_type_columns):
    """Merge diversity scores computed at each cell-cluster resolution."""
    freqs_mat_paths = [
        os.path.join(neighbors_mat_dir,
                     f"neighborhood_freqs-{c}_radius{pixel_radius}.csv")
        for c in cell_type_columns]
    io_utils.validate_paths(freqs_mat_paths)
    diversity_data = []
    for cell_type_col, freqs_path in zip(cell_type_columns, freqs_mat_paths):
        neighbor_freqs = pd.read_csv(freqs_path)
        diversity_data.append(
            compute_neighborhood_diversity(neighbor_freqs, cell_type_col))
    return reduce(lambda left, right: pd.merge(
        left, right, on=[settings.FOV_ID, settings.CELL_LABEL]),
        diversity_data)


def _mean_distance_to_type(cell_table, dist, col_coords, cell_cluster, k,
                           cell_type_col, cell_label_col):
    """calculate_mean_distance_to_cell_type on a distance tensor already on
    its device, with the matrix's column labels."""
    cluster_labels = cell_table.loc[
        cell_table[cell_type_col] == cell_cluster, cell_label_col]
    col_mask = np.isin(col_coords, cluster_labels.values)
    if col_mask.sum() < k:
        return [np.nan] * dist.shape[0]
    cols = torch.as_tensor(np.flatnonzero(col_mask), device=dist.device)
    return dist_ops.knn_mean_distance(dist[:, cols], k).cpu().numpy()


def calculate_mean_distance_to_cell_type(cell_table, dist_xr, cell_cluster, k,
                                         cell_type_col=settings.CELL_TYPE,
                                         cell_label_col=settings.CELL_LABEL, *,
                                         device="cuda"):
    """Mean distance from every cell to its k nearest cells of one type."""
    return _mean_distance_to_type(
        cell_table, _as_f32_tensor(dist_xr.values, device),
        np.asarray(dist_xr.coords["dim_1"]), cell_cluster, k, cell_type_col,
        cell_label_col)


def calculate_mean_distance_to_all_cell_types(
        cell_table, dist_xr, k, cell_type_col=settings.CELL_TYPE,
        cell_label_col=settings.CELL_LABEL, *, device="cuda"):
    """Mean k-NN distance from every cell to every cell type."""
    all_clusters = np.unique(cell_table[cell_type_col])
    avg_dists = pd.DataFrame(index=cell_table.index.values,
                             columns=all_clusters, dtype=np.float64)
    dist = _as_f32_tensor(dist_xr.values, device)
    col_coords = np.asarray(dist_xr.coords["dim_1"])
    for cell_cluster in all_clusters:
        avg_dists.loc[:, cell_cluster] = _mean_distance_to_type(
            cell_table, dist, col_coords, cell_cluster, k, cell_type_col,
            cell_label_col)
    return avg_dists


def generate_cell_distance_analysis(cell_table, dist_mat_dir, save_path, k,
                                    cell_type_col=settings.CELL_TYPE,
                                    fov_col=settings.FOV_ID,
                                    cell_label_col=settings.CELL_LABEL, *,
                                    device="cuda"):
    """Cohort driver: per-FOV mean distances between all cell-type pairs."""
    io_utils.validate_paths(dist_mat_dir)
    fov_list = np.unique(cell_table[fov_col])
    cell_dists = []
    for fov in fov_list:
        fov_cell_table = cell_table[cell_table[fov_col] == fov]
        fov_dist_xr = spatial_analysis_utils.load_dist_matrix(dist_mat_dir, fov)
        fov_cell_dists = calculate_mean_distance_to_all_cell_types(
            fov_cell_table, fov_dist_xr, k, cell_type_col, cell_label_col,
            device=device)
        fov_cell_dists.insert(0, fov_col, fov)
        fov_cell_dists.insert(1, cell_label_col,
                              fov_cell_table[cell_label_col])
        fov_cell_dists.insert(2, cell_type_col, fov_cell_table[cell_type_col])
        cell_dists.append(fov_cell_dists)
    all_cell_dists = pd.concat(cell_dists)
    all_cell_dists.to_csv(save_path, index=False)
    return all_cell_dists
