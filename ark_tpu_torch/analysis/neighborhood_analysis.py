"""Neighborhood analysis drivers: neighbor matrices, k-means neighborhoods,
cell ratios, mixing scores.

Port of ``ark_tpu/analysis/neighborhood_analysis.py`` (reference
`src/ark/analysis/neighborhood_analysis.py`: create_neighborhood_matrix
:16-119, generate_cluster_matrix_results :122-237, metric sweeps :240-352,
compute_cell_ratios :355-429, compute_mixing_score :432-524). The neighbor
counts, k-means and silhouette scores run on `device` (default "cuda");
tables stay in pandas. No progress bars: tqdm is not on every machine the
port runs on. matplotlib and seaborn are imported only by
compute_cell_ratios, which plots."""

from __future__ import annotations

import warnings

import numpy as np
import pandas as pd
from ark_tpu_torch import settings
from ark_tpu_torch.analysis import spatial_analysis_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list


def create_neighborhood_matrix(all_data, dist_mat_dir, included_fovs=None,
                               distlim=50, self_neighbor=False,
                               fov_col=settings.FOV_ID,
                               cell_label_col=settings.CELL_LABEL,
                               cell_type_col=settings.CELL_TYPE, *, device="cuda"):
    """Per-cell neighbor phenotype counts and frequencies across FOVs;
    drops zero-neighbor cells (warns if >5% dropped)."""
    if included_fovs is None:
        included_fovs = all_data[fov_col].unique()
    verify_in_list(fov_names=included_fovs,
                   unique_fovs=all_data[fov_col].unique())

    all_neighborhood_data = all_data[
        [fov_col, cell_label_col, cell_type_col]].reset_index(drop=True)
    cluster_names = all_neighborhood_data[cell_type_col].drop_duplicates()
    included_columns = [fov_col, cell_label_col, cell_type_col]

    cell_neighbor_counts = pd.DataFrame(
        np.zeros((all_neighborhood_data.shape[0],
                  len(cluster_names) + len(included_columns))))
    cell_neighbor_counts[list(range(len(included_columns)))] = \
        all_neighborhood_data[included_columns]
    cell_neighbor_counts.columns = included_columns + list(cluster_names)
    cell_neighbor_freqs = cell_neighbor_counts.copy(deep=True)

    for fov in included_fovs:
        current_idx = all_neighborhood_data.loc[:, fov_col] == fov
        current_data = all_neighborhood_data[current_idx]
        fov_cluster_names = current_data[cell_type_col].drop_duplicates()
        dist_matrix = spatial_analysis_utils.load_dist_matrix(dist_mat_dir, fov)
        counts, freqs = spatial_analysis_utils.compute_neighbor_counts(
            current_data, dist_matrix, distlim, self_neighbor,
            cell_label_col=cell_label_col, cluster_name_col=cell_type_col,
            device=device)
        cell_neighbor_counts.loc[current_data.index, fov_cluster_names] = counts
        cell_neighbor_freqs.loc[current_data.index, fov_cluster_names] = freqs

    total_cell_count = cell_neighbor_counts.shape[0]
    keep_cells = cell_neighbor_counts.drop(included_columns,
                                           axis=1).sum(axis=1) != 0
    cell_neighbor_counts = cell_neighbor_counts.loc[keep_cells].reset_index(
        drop=True)
    cell_neighbor_freqs = cell_neighbor_freqs.loc[keep_cells].reset_index(
        drop=True)
    if (cell_neighbor_counts.shape[0] / total_cell_count) < 0.95:
        warnings.warn(UserWarning(
            "More than 5% of cells have no neighbor within the provided "
            "radius and have been omitted. We suggest increasing the distlim "
            "value to reduce the number of cells excluded from analysis."))
    return cell_neighbor_counts, cell_neighbor_freqs


def generate_cluster_matrix_results(all_data, neighbor_mat, cluster_num,
                                    seed=42, excluded_channels=None,
                                    included_fovs=None,
                                    cluster_label_col=settings.KMEANS_CLUSTER,
                                    fov_col=settings.FOV_ID,
                                    cell_type_col=settings.CELL_TYPE,
                                    label_col=settings.CELL_LABEL,
                                    pre_channel_col=settings.PRE_CHANNEL_COL,
                                    post_channel_col=settings.POST_CHANNEL_COL, *,
                                    device="cuda"):
    """k-means over the neighborhood matrix + cluster x cell-type counts and
    cluster x marker means."""
    if included_fovs is None:
        included_fovs = neighbor_mat[fov_col].unique()
    verify_in_list(fov_names=included_fovs,
                   unique_fovs=all_data[fov_col].unique())
    if excluded_channels is not None:
        verify_in_list(columns_to_exclude=excluded_channels,
                       column_names=all_data.columns)
    if cluster_num < 2:
        raise ValueError("Invalid k provided for clustering")

    neighbor_mat_data_all = neighbor_mat[
        neighbor_mat[fov_col].isin(included_fovs)].copy()
    neighbor_mat_data = neighbor_mat_data_all.drop(
        [fov_col, label_col, cell_type_col], axis=1)
    cluster_labels = spatial_analysis_utils.generate_cluster_labels(
        neighbor_mat_data, cluster_num, seed=seed, device=device)
    neighbor_mat_data_all[cluster_label_col] = cluster_labels

    all_data_clusters = all_data[all_data[fov_col].isin(included_fovs)]
    all_data_clusters = all_data_clusters.merge(
        neighbor_mat_data_all[[fov_col, label_col, cluster_label_col]],
        on=[fov_col, label_col])

    group_by_cell_type = all_data_clusters.groupby(
        [cluster_label_col, cell_type_col]).size().reset_index(name="count")
    num_cell_type_per_cluster = group_by_cell_type.pivot(
        index=cluster_label_col, columns=cell_type_col,
        values="count").fillna(0).astype(int)
    num_cell_type_per_cluster.index = [
        "Cluster" + str(c) for c in num_cell_type_per_cluster.index]

    cols = list(all_data_clusters.columns)
    channel_start = cols.index(pre_channel_col) + 1
    channel_end = cols.index(post_channel_col)
    cluster_col_idx = cols.index(cluster_label_col)
    all_data_markers_clusters = all_data_clusters.iloc[
        :, list(range(channel_start, channel_end)) + [cluster_col_idx]]
    if excluded_channels is not None:
        all_data_markers_clusters = all_data_markers_clusters.drop(
            excluded_channels, axis=1)
    mean_marker_exp_per_cluster = all_data_markers_clusters.groupby(
        [cluster_label_col]).mean()
    mean_marker_exp_per_cluster.index = [
        "Cluster" + str(c) for c in mean_marker_exp_per_cluster.index]
    return (all_data_clusters, num_cell_type_per_cluster,
            mean_marker_exp_per_cluster)


def compute_cluster_metrics_inertia(neighbor_mat, min_k=2, max_k=10, seed=42,
                                    included_fovs=None,
                                    fov_col=settings.FOV_ID,
                                    label_col=settings.CELL_LABEL,
                                    cell_col=settings.CELL_TYPE, *, device="cuda"):
    """Inertia sweep over k on the neighborhood matrix."""
    if included_fovs is None:
        included_fovs = neighbor_mat[fov_col].unique()
    if min_k < 2 or max_k < 2:
        raise ValueError("Invalid k provided for clustering")
    verify_in_list(fov_names=included_fovs,
                   unique_fovs=neighbor_mat[fov_col].unique())
    data = neighbor_mat[neighbor_mat[fov_col].isin(included_fovs)]
    data = data.drop([fov_col, label_col, cell_col], axis=1)
    return spatial_analysis_utils.compute_kmeans_inertia(
        data, min_k=min_k, max_k=max_k, seed=seed, device=device)


def compute_cluster_metrics_silhouette(neighbor_mat, min_k=2, max_k=10,
                                       seed=42, included_fovs=None,
                                       fov_col=settings.FOV_ID,
                                       label_col=settings.CELL_LABEL,
                                       cell_col=settings.CELL_TYPE,
                                       subsample=None, *, device="cuda"):
    """Silhouette sweep over k on the neighborhood matrix."""
    if included_fovs is None:
        included_fovs = neighbor_mat[fov_col].unique()
    if min_k < 2 or max_k < 2:
        raise ValueError("Invalid k provided for clustering")
    verify_in_list(fov_names=included_fovs,
                   unique_fovs=neighbor_mat[fov_col].unique())
    data = neighbor_mat[neighbor_mat[fov_col].isin(included_fovs)]
    data = data.drop([fov_col, label_col, cell_col], axis=1)
    return spatial_analysis_utils.compute_kmeans_silhouette(
        data, min_k=min_k, max_k=max_k, seed=seed, subsample=subsample,
        device=device)


def compute_cell_ratios(neighbors_mat, target_cells, reference_cells,
                        fov_list, bin_number=10, cell_col=settings.CELL_TYPE,
                        fov_col=settings.FOV_ID,
                        label_col=settings.CELL_LABEL):
    """Target/reference population ratios per FOV, with ratio plots."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    targ_ref_ratio, ref_targ_ratio = np.empty(0), np.empty(0)
    for fov in fov_list:
        fov_mat = neighbors_mat[neighbors_mat[fov_col] == fov]
        verify_in_list(provided_column_names=[cell_col, fov_col, label_col],
                       cell_neighbors_columns=neighbors_mat.columns)
        fov_mat = fov_mat.drop(columns=[fov_col, label_col])
        target_total = fov_mat[fov_mat[cell_col].isin(target_cells)].shape[0]
        reference_total = fov_mat[
            fov_mat[cell_col].isin(reference_cells)].shape[0]
        if target_total == 0 or reference_total == 0:
            targ_ref_ratio = np.append(targ_ref_ratio, np.nan)
            ref_targ_ratio = np.append(ref_targ_ratio, np.nan)
        else:
            targ_ref_ratio = np.append(targ_ref_ratio,
                                       target_total / reference_total)
            ref_targ_ratio = np.append(ref_targ_ratio,
                                       reference_total / target_total)

    targ_ref_filter = targ_ref_ratio[~np.isnan(targ_ref_ratio)]
    targ_ref_filter = targ_ref_filter[targ_ref_filter < 15]
    ref_targ_filter = ref_targ_ratio[~np.isnan(ref_targ_ratio)]
    ref_targ_filter = ref_targ_filter[ref_targ_filter < 15]

    sns.set(rc={"figure.figsize": (16, 4)})
    fig, (ax1, ax2) = plt.subplots(1, 2)
    fig.suptitle("Population 1 / Population 2 Ratios")
    ax1.boxplot(targ_ref_filter, vert=False)
    ax1.set(xlabel="Ratio")
    ax2.hist(targ_ref_filter, bins=bin_number)
    ax2.set(xlabel="Ratio", ylabel="Count")
    fig2, (ax3, ax4) = plt.subplots(1, 2)
    fig2.suptitle("Population 2 / Population 1 Ratios")
    ax3.boxplot(ref_targ_filter, vert=False)
    ax3.set(xlabel="Ratio")
    ax4.hist(ref_targ_filter, bins=bin_number)
    ax4.set(xlabel="Ratio", ylabel="Count")

    return pd.DataFrame(list(zip(fov_list, targ_ref_ratio)),
                        columns=["fov", "cell_ratio"])


def compute_mixing_score(fov_neighbors_mat, target_cells, reference_cells,
                         mixing_type, ratio_threshold=5,
                         cell_count_thresh=200, cell_col=settings.CELL_TYPE,
                         fov_col=settings.FOV_ID,
                         label_col=settings.CELL_LABEL):
    """Percent or homogeneous mixing score for one FOV (cold-image thresholds
    return NaN; reference :432-524)."""
    verify_in_list(provided_column_names=[cell_col, fov_col, label_col],
                   cell_neighbors_columns=fov_neighbors_mat.columns)
    fov_neighbors_mat = fov_neighbors_mat.drop(columns=[fov_col, label_col])

    overlap = [cell for cell in target_cells if cell in reference_cells]
    if overlap:
        raise ValueError(
            f"The following cell types were included in both the target and "
            f"reference populations: {overlap}")
    all_cells = fov_neighbors_mat[cell_col].unique()
    if mixing_type not in ["percent", "homogeneous"]:
        raise ValueError(
            'Please provide a valid mixing_type: "percent" or "homogeneous".')

    target_total = fov_neighbors_mat[
        fov_neighbors_mat[cell_col].isin(target_cells)].shape[0]
    ref_total = fov_neighbors_mat[
        fov_neighbors_mat[cell_col].isin(reference_cells)].shape[0]
    if (target_total + ref_total) < cell_count_thresh:
        return np.nan, (target_total + ref_total)
    if ref_total == 0 or target_total == 0:
        return np.nan, (target_total + ref_total)
    if ref_total / target_total > ratio_threshold \
            or target_total / ref_total > ratio_threshold:
        return np.nan, (target_total + ref_total)

    fov_neighbors_mat = fov_neighbors_mat.copy()
    fov_neighbors_mat[cell_col] = fov_neighbors_mat[cell_col].replace(
        dict.fromkeys(target_cells, "target"))
    fov_neighbors_mat[cell_col] = fov_neighbors_mat[cell_col].replace(
        dict.fromkeys(reference_cells, "reference"))
    interactions_mat = fov_neighbors_mat.groupby(
        by=[cell_col]).sum(numeric_only=True)

    interactions_mat["target"] = 0.0
    interactions_mat["reference"] = 0.0
    for target_cell in target_cells:
        if target_cell in all_cells:
            interactions_mat["target"] += interactions_mat[target_cell]
    for reference_cell in reference_cells:
        if reference_cell in all_cells:
            interactions_mat["reference"] += interactions_mat[reference_cell]

    reference_target = interactions_mat.loc["target", "reference"]
    target_target = interactions_mat.loc["target", "target"]
    reference_reference = interactions_mat.loc["reference", "reference"]
    if mixing_type == "percent":
        mixing_score = reference_target / (reference_target + target_target)
    else:
        mixing_score = reference_target / (target_target + reference_reference)
    return mixing_score, (target_total + ref_total)
