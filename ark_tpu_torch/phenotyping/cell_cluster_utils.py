"""Cell-clustering inputs: cells x pixel-cluster-count matrices.

Port of ``ark_tpu/phenotyping/cell_cluster_utils.py``: SOM-column averages
per cell cluster, the per-FOV (label x pixel-cluster) counts as one 2-D
bincount, and the merge of the meta labels into the cell table. Host numpy
and pandas, as in the JAX package. ``create_c2pc_data`` runs in a
``cells.c2pc`` span, its cell-table read in ``cells.read_table`` and each
FOV's read and counts in ``cells.fov_counts``.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import pandas as pd

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.utils import profiling
from ark_tpu_torch.utils.misc_utils import verify_in_list


def compute_cell_som_cluster_cols_avg(cell_cluster_data, cell_som_cluster_cols,
                                      cell_cluster_col, keep_count=False):
    """Average of each SOM-training column grouped by the cell cluster col."""
    verify_in_list(provided_cluster_col=cell_cluster_col,
                   valid_cluster_cols=["cell_som_cluster", "cell_meta_cluster"])
    verify_in_list(provided_cluster_col=cell_som_cluster_cols,
                   cluster_data_valid_cols=cell_cluster_data.columns.values)
    sub = cell_cluster_data.loc[:, list(cell_som_cluster_cols) + [cell_cluster_col]]
    means = sub.groupby(cell_cluster_col).mean().reset_index()
    means[cell_cluster_col] = means[cell_cluster_col].astype(np.int64)
    if keep_count:
        counts = sub.groupby(cell_cluster_col).size().to_frame("count")
        counts = counts.reset_index(drop=True)
        means["count"] = counts["count"]
    return means


def _c2pc_counts(labels: np.ndarray, clusters: np.ndarray, cluster_ids):
    """(cells x clusters) pixel counts via one 2-D bincount, as a DataFrame
    indexed by label (cells with no pixel dropped).

    labels: per-pixel segmentation label (> 0 for cells); clusters: per-pixel
    index into `cluster_ids`."""
    max_label = int(labels.max()) if labels.size else 0
    n_clusters = len(cluster_ids)
    flat = labels.astype(np.int64) * n_clusters + clusters.astype(np.int64)
    counts = np.bincount(flat, minlength=(max_label + 1) * n_clusters)
    counts = counts.reshape(max_label + 1, n_clusters)[1:]  # drop background 0
    df = pd.DataFrame(counts, index=np.arange(1, max_label + 1),
                      columns=cluster_ids)
    return df[df.sum(axis=1) > 0]


def c2pc_counts_table(fov_labels, pixel_cluster_col):
    """The count table of `create_c2pc_data`: `fov_labels` yields (fov,
    per-pixel labels, per-pixel cluster values) one FOV at a time, and each
    FOV's pixels are dropped once its (cells x local clusters) counts are
    taken. Returns (count table with columns `<pixel_cluster_col>_<id>`,
    fov and label; the count column names)."""
    per_fov = []
    all_clusters = set()
    for fov, lbl, raw in fov_labels:
        raw = pd.Series(raw)
        if raw.dtype == float:
            raw = raw.astype(int)
        local_ids = list(pd.unique(raw))
        local_map = {c: i for i, c in enumerate(local_ids)}
        counts = _c2pc_counts(np.asarray(lbl).astype(np.int64),
                              raw.map(local_map).values, local_ids)
        all_clusters.update(local_ids)
        per_fov.append((fov, counts))

    if all(isinstance(c, (int, np.integer, float, np.floating))
           for c in all_clusters):
        cluster_ids = sorted(int(c) for c in all_clusters)
    else:
        cluster_ids = io_utils.natsorted(all_clusters)
    count_cols = [f"{pixel_cluster_col}_{c}" for c in cluster_ids]

    blocks = []
    for fov, counts in per_fov:
        counts = counts.reindex(columns=cluster_ids, fill_value=0)
        counts.columns = count_cols
        counts["fov"] = fov
        counts["label"] = counts.index.values
        blocks.append(counts.reset_index(drop=True))
    return pd.concat(blocks, ignore_index=True), count_cols


def create_c2pc_data(fovs, pixel_data_path, cell_table_path,
                     pixel_cluster_col="pixel_meta_cluster_rename"):
    """Per-cell pixel SOM/meta cluster counts joined to the cell table.

    Returns (raw counts table, counts normalized by cell_size) with columns
    `<pixel_cluster_col>_<cluster>`. Reads each FOV's label and cluster
    columns only, one FOV at a time."""
    verify_in_list(provided_cluster_col=[pixel_cluster_col],
                   valid_cluster_cols=["pixel_som_cluster",
                                       "pixel_meta_cluster_rename"])
    with profiling.span("cells.c2pc"):
        with profiling.span("cells.read_table") as sp:
            cell_table = pd.read_csv(cell_table_path)
            if sp.recorded:
                sp.attrs["bytes"] = os.path.getsize(cell_table_path)
        verify_in_list(required_cell_table_cols=["fov", "label", "cell_size"],
                       provided_cell_table_cols=cell_table.columns.values)
        cell_table = cell_table[["fov", "label", "cell_size"]]
        cell_table["label"] = cell_table["label"].astype(int)
        cell_table = cell_table[cell_table["fov"].isin(fovs)].reset_index(drop=True)

        def read_fov(fov):
            fov_path = os.path.join(pixel_data_path, fov + ".feather")
            present = feather.read_column_names(fov_path)
            lbl_col = "segmentation_label" if "segmentation_label" in present \
                else "label"
            for c in (lbl_col, pixel_cluster_col):
                if c not in present:
                    raise KeyError(
                        f"FOV {fov} pixel data is missing column '{c}'")
            fov_pixel_data = feather.read_dataframe(
                fov_path, columns=[lbl_col, pixel_cluster_col])
            return (fov, fov_pixel_data[lbl_col].values.astype(np.int64),
                    fov_pixel_data[pixel_cluster_col])

        def fov_labels():
            # a FOV's counts are taken while its span is open: the consumer
            # counts between this yield and the next
            for fov in fovs:
                with profiling.span("cells.fov_counts", fov=fov) as sp:
                    got = read_fov(fov)
                    if sp.recorded:
                        sp.attrs["pixels"] = len(got[1])
                    yield got

        count_table, count_cols = c2pc_counts_table(fov_labels(), pixel_cluster_col)

        cell_table = cell_table.merge(count_table, on=["fov", "label"], how="left")
        cell_table[count_cols] = cell_table[count_cols].fillna(0)
        # drop cells with no pixel clusters expressed
        cell_table = cell_table[cell_table[count_cols].sum(axis=1) != 0]

        cell_table_norm = cell_table.copy()
        cell_table_norm[count_cols] = cell_table_norm[count_cols].div(
            cell_table_norm["cell_size"], axis=0)
        cell_table = cell_table.reset_index(drop=True)
        cell_table_norm = cell_table_norm.reset_index(drop=True)

        zero_cols = list(cell_table_norm[count_cols].columns[
            (cell_table_norm[count_cols] == 0).all()].values)
        if zero_cols:
            warnings.warn("Pixel clusters %s do not appear in any cells, removed "
                          "from analysis" % ",".join(zero_cols))
            cell_table = cell_table.drop(columns=zero_cols)
            cell_table_norm = cell_table_norm.drop(columns=zero_cols)
        return cell_table, cell_table_norm


def add_consensus_labels_cell_table(base_dir, cell_table_path,
                                    cell_som_input_data):
    """Merge the renamed cell meta clusters into the cohort cell table and
    save it as `<cell_table>_cell_labels.csv`; cells without one are
    'Unassigned'."""
    io_utils.validate_paths([cell_table_path])
    cell_table = pd.read_csv(cell_table_path)
    if "segmentation_label" in cell_som_input_data.columns:
        cell_som_input_data = cell_som_input_data.rename(
            columns={"segmentation_label": "label"})
    merged = cell_table.merge(cell_som_input_data, how="left",
                              on=["fov", "label"])
    if "cell_size_y" in merged.columns.values:
        merged = merged.drop(columns=["cell_size_y"])
        merged = merged.rename({"cell_size_x": "cell_size"}, axis=1)
    merged = merged[list(cell_table.columns.values) + ["cell_meta_cluster_rename"]]
    merged = merged.rename({"cell_meta_cluster_rename": "cell_meta_cluster"},
                           axis=1)
    merged["cell_meta_cluster"] = merged["cell_meta_cluster"].fillna("Unassigned")
    new_path = os.path.splitext(cell_table_path)[0] + "_cell_labels.csv"
    merged.to_csv(new_path, index=False)
