"""Spatial-LDA helpers of the port: argument checks, the within-cluster sums
of the gap statistic, topic plots and pkl/csv persistence; a port of
``ark_tpu/utils/spatial_lda_utils.py``.

``within_cluster_sums`` runs on `device`; everything else is host code.
matplotlib and seaborn are imported inside the plots, so the module imports
where they are absent.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.settings import BASE_COLS, CELL_TYPE, LDA_PLOT_TYPES
from ark_tpu_torch.utils.misc_utils import verify_in_list

# matplotlib's Set3 (which stands in for palettable's Set3_12), as a literal:
# the module may not import matplotlib
_SET3 = tuple(tuple(c / 255 for c in rgb) for rgb in (
    (141, 211, 199), (255, 255, 179), (190, 186, 218), (251, 128, 114),
    (128, 177, 211), (253, 180, 98), (179, 222, 105), (252, 205, 229),
    (217, 217, 217), (188, 128, 189), (204, 235, 197), (255, 237, 111)))

# f64 entries of one (rows, cells) block of pair distances: 256 MiB, and as
# much again for the column difference being added
PAIR_BLOCK_ELEMS = 1 << 25


def check_format_cell_table_args(cell_table, markers, clusters):
    """Validate format_cell_table inputs."""
    verify_in_list(required_columns=BASE_COLS,
                   cell_table_columns=cell_table.columns.to_list())
    if markers is None and clusters is None:
        raise ValueError("Markers and clusters cannot both be None.")
    if markers is not None:
        if len(markers) == 0:
            raise ValueError("The markers list is empty.")
        verify_in_list(markers=markers,
                       cell_table_columns=cell_table.columns.to_list())
    if clusters is not None:
        if len(clusters) == 0:
            raise ValueError("The clusters list is empty.")
        cell_table_clusters = cell_table[CELL_TYPE].unique().tolist()
        verify_in_list(clusters=clusters,
                       cell_table_clusters=cell_table_clusters)


def check_featurize_cell_table_args(cell_table, featurization, radius,
                                    cell_index):
    """Validate featurize_cell_table inputs."""
    if not isinstance(radius, int):
        raise TypeError("radius should be of type 'int'")
    if radius < 25:
        raise ValueError("radius must not be less than 25")
    verify_in_list(featurization=[featurization],
                   featurization_options=["cluster", "marker", "avg_marker",
                                          "count"])
    # format_cell_table inserts both keys, possibly None: check the value
    if featurization == "cluster" and cell_table.get("clusters") is None:
        raise ValueError("Cannot featurize clusters, because none were used "
                         "for cell table formatting")
    if featurization in ["marker", "avg_marker"] \
            and cell_table.get("markers") is None:
        raise ValueError("Cannot featurize markers, because none were used "
                         "for cell table formatting")
    key = list(cell_table.keys())[0]
    verify_in_list(cell_index=[cell_index],
                   cell_table_columns=cell_table[key].columns.to_list())


def _pair_distance_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over i < j of |x_i - x_j| for f64 rows `x`, as a 0-d f64 tensor on
    their device: scipy's ``pdist(x).sum()`` without the condensed matrix.
    Each squared distance adds the columns' exact f64 differences in column
    order (no |a|^2 - 2ab + |b|^2 cancellation); rows go in blocks against
    the rows from the block's first on, and the block's lower triangle and
    diagonal are dropped."""
    n, dim = x.shape
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    block = max(1, PAIR_BLOCK_ELEMS // max(n, 1))
    for r0 in range(0, n, block):
        rows, cols = x[r0:r0 + block], x[r0:]
        acc = torch.zeros((rows.shape[0], cols.shape[0]), dtype=torch.float64,
                          device=x.device)
        for k in range(dim):
            diff = rows[:, k, None] - cols[None, :, k]
            acc.addcmul_(diff, diff)
        total += torch.triu(acc.sqrt_(), diagonal=1).sum()
    return total


def within_cluster_sums(data, labels, *, device="cuda"):
    """Pooled within-cluster dispersion of the gap statistic: for each cluster
    the sum of its pairwise euclidean distances over twice its size, summed
    over the clusters; in f64 on `device`."""
    x = torch.as_tensor(np.asarray(data, np.float64), device=device)
    labels = np.asarray(labels)
    pair_sums, sizes = [], []
    for label in np.unique(labels):
        idx = np.flatnonzero(labels == label)
        pair_sums.append(_pair_distance_sum(x[torch.as_tensor(idx, device=device)]))
        sizes.append(len(idx))
    # one wait for the device; the divisions on the host, as scipy's caller
    cluster_sums = torch.stack(pair_sums).cpu().numpy() / (2 * np.asarray(sizes))
    return float(np.sum(cluster_sums))


def _standardize_topics(topics):
    topics = np.asarray(topics, float)
    mu = topics.mean(axis=0, keepdims=True)
    sd = topics.std(axis=0, keepdims=True)
    return (topics - mu) / np.where(sd == 0, 1, sd)


def plot_topics_heatmap(topics, features, normalizer=None, transpose=False,
                        scale=0.4):
    """Heatmap of topic x feature loadings."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    topics = np.asarray(topics)
    n_topics = topics.shape[0]
    topics = normalizer(topics) if normalizer is not None \
        else _standardize_topics(topics)
    topics = pd.DataFrame(np.asarray(topics).T, index=features,
                          columns=[f"Topic {x}" for x in range(n_topics)])
    if transpose:
        topics = topics.T
    plt.subplots(figsize=(scale * topics.shape[1], scale * topics.shape[0]))
    sns.heatmap(topics, square=True, cmap="RdBu")


def plot_fovs_with_topics(ax, fov_idx, topic_weights, cell_table,
                          uncolor_subset=None, color_palette=_SET3):
    """Scatter one FOV's cells colored by their dominant topic."""
    colors = np.array(color_palette[:topic_weights.shape[1]])
    cell_coords = cell_table[fov_idx]
    cell_indices = topic_weights.index.map(lambda x: x[1])
    coords = cell_table[fov_idx].loc[cell_indices]
    if uncolor_subset is not None:
        immune_coords = cell_coords[cell_coords[uncolor_subset]]
        ax.scatter(immune_coords["y"], -immune_coords["x"], s=5, c="k",
                   label=uncolor_subset, alpha=0.1)
    ax.scatter(coords["y"], -coords["x"], s=2,
               c=colors[np.argmax(np.array(topic_weights), axis=1), :])
    ax.set_title(f"FOV {fov_idx}")
    ax.axes.get_yaxis().set_visible(False)
    ax.axes.get_xaxis().set_visible(False)


def plot_adjacency_graph(ax, sample_idx, features_df, fov_df,
                         difference_matrices):
    """Draw the MST adjacency edges over a FOV's cell positions."""
    coords = fov_df[["y", "x"]].values
    ax.scatter(coords[:, 0], -coords[:, 1], s=4, c="k")
    dm = difference_matrices.get(sample_idx)
    if dm is not None:
        for row in np.asarray(dm):
            nz = np.nonzero(row)[0]
            if len(nz) == 2:
                a, b = nz
                ax.plot([coords[a, 0], coords[b, 0]],
                        [-coords[a, 1], -coords[b, 1]], c="tab:blue", lw=0.5)
    ax.set_title(f"FOV {sample_idx}")


def make_plot_fn(plot="adjacency", difference_matrices=None,
                 topic_weights=None, cell_table=None, color_palette=_SET3):
    """Factory for spatial-LDA plot callables."""
    verify_in_list(plot=[plot], plot_options=LDA_PLOT_TYPES)
    if plot == "adjacency":
        if difference_matrices is None:
            raise ValueError("Must provide difference_matrices")

        def plot_fn(ax, sample_idx, features_df, fov_df):
            plot_adjacency_graph(ax, sample_idx, features_df, fov_df,
                                 difference_matrices)
    else:
        if topic_weights is None or cell_table is None:
            raise ValueError("Must provide cell_table and topic_weights")

        def plot_fn(ax, sample_idx, features_df=topic_weights,
                    fov_df=cell_table):
            plot_fovs_with_topics(ax, sample_idx, features_df, fov_df,
                                  color_palette=color_palette)
    return plot_fn


def save_spatial_lda_file(data, dir, file_name, format="pkl"):
    """Persist spatial-LDA objects as pkl or csv."""
    if not os.path.exists(dir):
        raise ValueError("'dir' must be a valid directory.")
    file_path = os.path.join(dir, file_name + "." + format)
    if format == "pkl":
        with open(file_path, "wb") as f:
            pickle.dump(data, f)
    elif format == "csv":
        if isinstance(data, dict):
            raise ValueError("'data' is of type dict.  Use format='pkl' "
                             "instead.")
        if not hasattr(data, "to_csv"):
            raise ValueError("'data' is a spatial_lda model.  Use "
                             "format='pkl' instead.")
        data.to_csv(file_path)
    else:
        raise ValueError("format must be either 'csv' or 'pkl'.")


def read_spatial_lda_file(dir, file_name, format="pkl"):
    """Load spatial-LDA objects saved by save_spatial_lda_file."""
    file_path = os.path.join(dir, file_name + "." + format)
    io_utils.validate_paths(file_path)
    if format == "pkl":
        with open(file_path, "rb") as f:
            return pickle.load(f)
    if format == "csv":
        return pd.read_csv(file_path)
    raise ValueError("format must be either 'csv' or 'pkl'.")
