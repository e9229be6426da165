"""Spatial-analysis primitives: distance matrices, positive-label selection,
close-cell counting, neighbor counts, k-means sweeps.

Port of ``ark_tpu/analysis/spatial_analysis_utils.py`` (reference
`src/ark/analysis/spatial_analysis_utils.py`: calc_dist_matrix :17-64,
append_distance_features :67-116, positive-label selection :119-171,
compute_close_cell_num :174-274, compute_neighbor_counts :277-338, k-means
sweeps :341-454). Distance matrices, the marker x marker close-interaction
products, the neighbor-count products, k-means and the silhouette score run
on `device` (default "cuda"); table work stays in pandas on the host.

Distance matrices persist as `<fov>_dist_mat.xr` in the reference's on-disk
format, classic netCDF NETCDF3_64BIT, through the port's
``utils/netcdf3.py``: files cross between the port, the JAX package and
the reference in both directions.
"""

from __future__ import annotations

import os
import time

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.ops import distances as dist_ops
from ark_tpu_torch.ops import kmeans as kmeans_ops
from ark_tpu_torch.ops.som import _as_f32_tensor as _to_device
from ark_tpu_torch.ops.som import _check_full_f32_matmul
from ark_tpu_torch.utils.labeled_array import DataArray
from ark_tpu_torch.utils.misc_utils import verify_in_list


def calc_dist_matrix(cell_table, save_path, fov_id=settings.FOV_ID,
                     label_id=settings.CELL_LABEL,
                     centroid_ids=(settings.CENTROID_0, settings.CENTROID_1), *,
                     device="cuda", timings=None):
    """Per-FOV cell-centroid distance matrices on `device`, saved as
    `<fov>_dist_mat.xr` (reference :17-64).

    On a CUDA device the next FOV's distances are computed and copied into
    pinned host memory (non-blocking, behind an event) while the current
    FOV's netCDF is written. `timings`, a dict, gets the seconds spent
    waiting for the distances ("distances_s") and writing files
    ("netcdf_write_s")."""
    io_utils.validate_paths([save_path])
    fovs = list(cell_table[fov_id].unique())
    pinned = torch.device(device).type == "cuda"

    def dispatch(fov):
        fov_table = cell_table[cell_table[fov_id] == fov]
        centroids = _to_device(fov_table[list(centroid_ids)].values, device)
        dist = dist_ops.pairwise_distances(centroids, centroids, zero_diagonal=True)
        if not pinned:
            return dist, None, list(fov_table[label_id])
        # a non-blocking copy into pageable memory would be synchronous
        host = torch.empty(dist.shape, dtype=dist.dtype, pin_memory=True)
        host.copy_(dist, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        return host, done, list(fov_table[label_id])

    wait_s = write_s = 0.0
    pending = dispatch(fovs[0]) if fovs else None
    for i, fov in enumerate(fovs):
        host, done, labels = pending
        pending = dispatch(fovs[i + 1]) if i + 1 < len(fovs) else None
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        dist_matrix = host.numpy()
        t1 = time.perf_counter()
        DataArray(dist_matrix, coords={"dim_0": labels, "dim_1": labels}).to_netcdf(
            os.path.join(save_path, str(fov) + "_dist_mat.xr"))
        wait_s += t1 - t0
        write_s += time.perf_counter() - t1
    if timings is not None:
        timings["distances_s"] = wait_s
        timings["netcdf_write_s"] = write_s


def load_dist_matrix(dist_mat_dir, fov) -> DataArray:
    """Load one FOV's distance matrix saved by calc_dist_matrix."""
    return DataArray.from_h5(os.path.join(dist_mat_dir, str(fov) + "_dist_mat.xr"))


def ensure_dist_matrices(cell_table, dist_mat_dir, fov_id=settings.FOV_ID, *,
                         device="cuda", **calc_kwargs) -> None:
    """Create the `<fov>_dist_mat.xr` files the table's FOVs are missing
    (the templates' per-FOV resume guard: a directory left behind by a
    killed run is completed, not trusted)."""
    os.makedirs(dist_mat_dir, exist_ok=True)
    fovs = cell_table[fov_id].unique()
    missing = [f for f in fovs if not os.path.exists(
        os.path.join(dist_mat_dir, str(f) + "_dist_mat.xr"))]
    if missing:
        subset = cell_table[cell_table[fov_id].isin(missing)]
        calc_dist_matrix(subset, dist_mat_dir, fov_id=fov_id, device=device,
                         **calc_kwargs)


def append_distance_features_to_dataset(fov, dist_matrix, cell_table,
                                        distance_columns):
    """Append per-cell distance features as pseudo-cells in both the cell
    table and the distance matrix (reference :67-116)."""
    verify_in_list(distance_columns=distance_columns,
                   valid_columns=cell_table.columns)
    num_cell_types = max(
        cell_table[settings.CELL_TYPE].astype("category").cat.codes) + 1
    fov_cells = cell_table.loc[cell_table[settings.FOV_ID] == fov]
    num_labels = max(fov_cells[settings.CELL_LABEL])

    dist_rows = []
    vals = dist_matrix.values
    row_coords = list(dist_matrix.coords["dim_0"])
    col_coords = list(dist_matrix.coords["dim_1"])
    for i, dist_col in enumerate(distance_columns):
        dist_rows.append(pd.DataFrame([{
            settings.FOV_ID: fov,
            settings.CELL_LABEL: num_labels + i + 1,
            settings.CELL_TYPE: dist_col,
            settings.CELL_TYPE_NUM: num_cell_types + i + 1,
        }]))
        new_id = max(row_coords) + 1
        feat = fov_cells[dist_col].values.astype(np.float32)
        n = vals.shape[0]
        new_vals = np.zeros((n + 1, n + 1), np.float32)
        new_vals[:n, :n] = vals
        new_vals[n, :n] = feat
        new_vals[:n, n] = feat
        vals = new_vals
        row_coords = row_coords + [new_id]
        col_coords = col_coords + [new_id]
    dist_matrix = DataArray(vals, coords={"dim_0": row_coords, "dim_1": col_coords})
    cell_table = pd.concat([cell_table] + dist_rows)
    return cell_table, dist_matrix


def get_pos_cell_labels_channel(thresh, current_fov_channel_data, cell_labels,
                                current_marker):
    """Labels of cells whose `current_marker` expression exceeds thresh."""
    pos = current_fov_channel_data[current_marker] > thresh
    return cell_labels[pos]


def get_pos_cell_labels_cluster(pheno, current_fov_neighborhood_data,
                                cell_label_col, cell_type_col):
    """Labels of cells whose phenotype equals pheno."""
    pos = current_fov_neighborhood_data[cell_type_col] == pheno
    return current_fov_neighborhood_data.loc[:, cell_label_col][pos]


def compute_close_cell_num(dist_mat, dist_lim, analysis_type,
                           current_fov_data=None,
                           current_fov_channel_data=None, cluster_ids=None,
                           cell_types_analyze=None, thresh_vec=None,
                           cell_label_col=settings.CELL_LABEL,
                           cell_type_col=settings.CELL_TYPE_NUM, *, device="cuda"):
    """marker x marker counts of close-cell interactions: the product
    P . D_bin . P^T of the (markers x cells) positive-label indicator P and
    the thresholded distances, on `device` (reference :174-274). Counts are
    int64 (the reference's uint16 wraps above 65535 pairs)."""
    verify_in_list(analysis_type=analysis_type,
                   good_analyses=["cluster", "channel"])
    if analysis_type == "channel":
        cell_labels = current_fov_data[cell_label_col]
        num = len(thresh_vec)
    else:
        num = len(cluster_ids)

    mark1poslabels = []
    for j in range(num):
        if analysis_type == "cluster":
            mark1poslabels.append(get_pos_cell_labels_cluster(
                pheno=cluster_ids[j],
                current_fov_neighborhood_data=current_fov_data,
                cell_label_col=cell_label_col, cell_type_col=cell_type_col))
        else:
            mark1poslabels.append(get_pos_cell_labels_channel(
                thresh=thresh_vec[j],
                current_fov_channel_data=current_fov_channel_data,
                cell_labels=cell_labels,
                current_marker=current_fov_channel_data.columns[j]))
    mark1_num = [len(m) for m in mark1poslabels]

    row_labels = np.asarray(dist_mat.coords["dim_0"])
    label_to_idx = {lab: i for i, lab in enumerate(row_labels)}
    pos_matrix = np.zeros((num, len(row_labels)), np.float32)
    for j, labs in enumerate(mark1poslabels):
        pos_matrix[j, [label_to_idx[v] for v in labs.values]] = 1.0

    _check_full_f32_matmul()
    pos = _to_device(pos_matrix, device)
    dist_bin = dist_ops.close_pairs(_to_device(dist_mat.values, device), dist_lim)
    close = (pos @ dist_bin @ pos.T).cpu().numpy()
    close_num = np.round(close).astype(np.int64)
    return close_num, mark1_num, mark1poslabels


def compute_neighbor_counts(current_fov_neighborhood_data, dist_matrix,
                            distlim, self_neighbor=False,
                            cell_label_col=settings.CELL_LABEL,
                            cluster_name_col=settings.CELL_TYPE, *, device="cuda"):
    """Per-cell neighbor-phenotype (counts, freqs): the one-hot x
    thresholded-distance product of reference :277-338, on `device`."""
    cell_labels = current_fov_neighborhood_data[cell_label_col].values
    row_labels = list(dist_matrix.coords["dim_0"])
    label_to_idx = {lab: i for i, lab in enumerate(row_labels)}
    idx = torch.as_tensor(np.array([label_to_idx[v] for v in cell_labels],
                                   dtype=np.int64), device=device)
    dist = _to_device(dist_matrix.values, device)
    cell_dist = dist[idx][:, idx]

    dist_bin = (cell_dist < distlim).to(torch.float32)
    if not self_neighbor:
        dist_bin[cell_dist == 0] = 0.0

    pheno_dummies = pd.get_dummies(
        current_fov_neighborhood_data.loc[:, cluster_name_col])
    pheno_names = pheno_dummies.columns.values
    pheno_has_cell = _to_device(pheno_dummies.to_numpy().astype(np.float32).T, device)

    _check_full_f32_matmul()
    # column sums of 0/1 values: exact integers in any order
    num_neighbors = torch.sum(dist_bin, dim=0)
    counts = (pheno_has_cell @ dist_bin).T
    freqs = counts / num_neighbors[:, None]
    counts_pd = pd.DataFrame(counts.cpu().numpy(), columns=pheno_names,
                             index=current_fov_neighborhood_data.index.copy())
    freqs_pd = pd.DataFrame(freqs.cpu().numpy(), columns=pheno_names,
                            index=current_fov_neighborhood_data.index.copy())
    return counts_pd, freqs_pd.fillna(0)


def compute_kmeans_inertia(neighbor_mat_data, min_k=2, max_k=10, seed=42, *,
                           device="cuda"):
    """Inertia sweep k = min_k..max_k (reference :341-373)."""
    ks = np.arange(min_k, max_k + 1)
    data = _to_device(np.asarray(neighbor_mat_data, np.float32), device)
    stats = np.zeros(len(ks))
    for i, k in enumerate(ks):
        _, stats[i] = kmeans_ops.kmeans(data, int(k), seed=seed, device=device)
    return DataArray(stats, coords={"cluster_num": ks})


def compute_kmeans_silhouette(neighbor_mat_data, min_k=2, max_k=10, seed=42,
                              subsample=None, *, device="cuda"):
    """Silhouette-score sweep over k (reference :376-427): k-means labels,
    then the blocked silhouette score. `subsample` draws that many cells
    per cluster (with replacement from a smaller cluster), seeded, as the
    reference's groupby-sample."""
    ks = np.arange(min_k, max_k + 1)
    data = np.asarray(neighbor_mat_data, np.float32)
    data_dev = _to_device(data, device)
    stats = np.zeros(len(ks))
    for i, k in enumerate(ks):
        labels, _ = kmeans_ops.kmeans(data_dev, int(k), seed=seed, device=device)
        sub_dat = pd.DataFrame(data)
        sub_dat["cluster"] = labels
        if subsample is not None:
            # pandas 3.0 groupby.apply leaves the group column out of the
            # sampled frame; it comes back from the group-key index level
            sub_dat = sub_dat.groupby("cluster").apply(
                lambda x: x.sample(subsample, replace=len(x) < subsample,
                                   random_state=seed)
            ).reset_index(level=0).reset_index(drop=True)
        stats[i] = dist_ops.silhouette_score(
            sub_dat.drop("cluster", axis=1).to_numpy(np.float32),
            sub_dat["cluster"].to_numpy(), device=device)
    return DataArray(stats, coords={"cluster_num": ks})


def generate_cluster_labels(neighbor_mat_data, cluster_num, seed=42, *,
                            device="cuda"):
    """Final k-means labels, 1-indexed (reference :430-454)."""
    labels, _ = kmeans_ops.kmeans(np.asarray(neighbor_mat_data, np.float32),
                                  cluster_num, seed=seed, device=device)
    return labels + 1
