"""Spatial-LDA preprocessing and topic EDA: a port of
``ark_tpu/spLDA/processing.py``.

Featurization runs on `device` through ``spLDA.featurization``; the topic
EDA's k-means through ``ops.kmeans``, its silhouette through
``ops.distances.silhouette_score`` and its within-cluster sums through
``utils.spatial_lda_utils.within_cluster_sums``, each on `device`. The
train split, the difference matrices and the FOV statistics are host code.
``gap_stat`` draws its bootstrap arrays from numpy's global state, as the JAX
package does: given ``np.random.seed`` both packages draw the same arrays.
"""

from __future__ import annotations

import copy
import functools

import numpy as np
import pandas as pd

from ark_tpu_torch import settings
from ark_tpu_torch.ops import kmeans as kmeans_ops
from ark_tpu_torch.ops.distances import silhouette_score
from ark_tpu_torch.spLDA import featurization as ft
from ark_tpu_torch.utils import spatial_lda_utils as spu


def _stratified_train_split(df: pd.DataFrame, train_frac: float,
                            strata, seed: int = 42) -> pd.DataFrame:
    """Deterministic stratified train subset: within each stratum (FOV), a
    seeded permutation keeps `round(train_frac * n)` rows (at least 1), so
    every FOV stays represented in LDA training."""
    strata = np.asarray(strata)
    rng = np.random.default_rng(seed)
    keep = np.zeros(len(df), dtype=bool)
    for s in pd.unique(strata):
        idx = np.flatnonzero(strata == s)
        n_keep = max(int(round(train_frac * len(idx))), 1)
        keep[rng.permutation(idx)[:n_keep]] = True
    return df.iloc[np.flatnonzero(keep)]


def format_cell_table(cell_table, markers=None, clusters=None):
    """Cell table -> per-FOV dict with x/y/cluster columns."""
    spu.check_format_cell_table_args(cell_table=cell_table, markers=markers,
                                     clusters=clusters)
    keep_cols = copy.deepcopy(settings.BASE_COLS)
    if markers is not None:
        keep_cols += markers
    drop_columns = [c for c in cell_table.columns if c not in keep_cols]
    cell_table_drop = cell_table.drop(columns=drop_columns)
    cell_table_drop = cell_table_drop.rename(columns={
        settings.CENTROID_0: "x", settings.CENTROID_1: "y",
        settings.CELL_TYPE: "cluster"})
    fovs = np.unique(cell_table_drop[settings.FOV_ID])
    fov_dict = {}
    for i in fovs:
        df = cell_table_drop[cell_table_drop[settings.FOV_ID] == i].drop(
            columns=[settings.FOV_ID, settings.CELL_LABEL])
        if clusters is not None:
            df = df[df["cluster"].isin(clusters)]
        df["is_index"] = True
        df["isimmune"] = True
        fov_dict[i] = df.reset_index(drop=True)
    fov_dict["fovs"] = fovs
    fov_dict["markers"] = markers
    fov_dict["clusters"] = clusters
    return fov_dict


def featurize_cell_table(cell_table, featurization="cluster", radius=100,
                         cell_index="is_index", n_processes=None,
                         train_frac=0.75, *, device="cuda"):
    """Featurize local neighborhoods on `device`, then the train split."""
    spu.check_featurize_cell_table_args(cell_table=cell_table,
                                        featurization=featurization,
                                        radius=radius, cell_index=cell_index)
    func_type = {"marker": ft.neighborhood_to_marker,
                 "cluster": ft.neighborhood_to_cluster,
                 "avg_marker": ft.neighborhood_to_avg_marker,
                 "count": ft.neighborhood_to_count}
    if featurization in ["marker", "avg_marker"]:
        fn = functools.partial(func_type[featurization],
                               markers=cell_table["markers"], device=device)
    else:
        fn = functools.partial(func_type[featurization], device=device)

    feature_sample = {k: v for (k, v) in cell_table.items()
                      if k in cell_table["fovs"].tolist()}
    featurized_fovs = ft.featurize_samples(
        feature_sample, fn, radius=radius, is_anchor_col=cell_index,
        x_col="x", y_col="y", n_processes=n_processes, include_anchors=True)
    all_sample_idxs = featurized_fovs.index.map(lambda x: x[0])
    train_features = _stratified_train_split(
        featurized_fovs, train_frac, all_sample_idxs, seed=42)
    return {"featurized_fovs": featurized_fovs,
            "train_features": train_features,
            "featurization": featurization}


def create_difference_matrices(cell_table, features, training=True,
                               inference=True):
    """MST-reduced spatial-difference matrices for training/inference."""
    if not training and not inference:
        raise ValueError("One or both of 'training' or 'inference' must be "
                         "True")
    cell_table = {k: v for (k, v) in cell_table.items()
                  if k not in ["fovs", "markers", "clusters"]}
    train_diff_mat = ft.make_merged_difference_matrices(
        sample_features=features["train_features"], sample_dfs=cell_table,
        x_col="x", y_col="y", reduce_to_mst=True) if training else None
    inference_diff_mat = ft.make_merged_difference_matrices(
        sample_features=features["featurized_fovs"], sample_dfs=cell_table,
        x_col="x", y_col="y", reduce_to_mst=True) if inference else None
    return {"train_diff_mat": train_diff_mat,
            "inference_diff_mat": inference_diff_mat}


def gap_stat(features, k, clust_inertia, num_boots=25, *, device="cuda"):
    """Tibshirani gap statistic over bootstrapped uniform reference samples
    (k-means and within-cluster sums on `device`)."""
    mins = features.apply(min, axis=0)
    maxs = features.apply(max, axis=0)
    n, p = features.shape
    w_kb = []
    for b in range(num_boots):
        boot_array = np.random.uniform(low=mins, high=maxs, size=(n, p))
        labels, _ = kmeans_ops.kmeans(boot_array.astype(np.float32), k, seed=b,
                                      device=device)
        w_kb.append(spu.within_cluster_sums(data=boot_array, labels=labels,
                                            device=device))
    gap = np.log(w_kb).mean() - np.log(clust_inertia)
    s = np.log(w_kb).std() * np.sqrt(1 + 1 / num_boots)
    return gap, s


def compute_topic_eda(features, featurization, topics, silhouette=False,
                      num_boots=None, *, device="cuda"):
    """k-means EDA over candidate topic counts on `device`: inertia,
    silhouette, gap statistic, per-cluster feature counts."""
    from tqdm import tqdm

    if num_boots is not None and num_boots < 25:
        raise ValueError("Number of bootstrap samples must be at least 25")
    # inclusive bounds, as the error message states them
    if min(topics) < 2 or max(topics) > features.shape[0] - 1:
        raise ValueError("Number of topics must be in [2, %d]"
                         % (features.shape[0] - 1))
    stat_names = ["inertia", "silhouette", "gap_stat", "gap_sds",
                  "cell_counts"]
    stats = dict(zip(stat_names, [{} for _ in stat_names]))
    feat_values = features.values.astype(np.float32)
    for k in tqdm(topics):
        labels, inertia = kmeans_ops.kmeans(feat_values, int(k), seed=42, device=device)
        cell_count = {}
        for i in range(k):
            cell_count[i] = features[labels == i].sum(axis=0)
        stats["inertia"][k] = inertia
        if silhouette:
            stats["silhouette"][k] = silhouette_score(feat_values, labels, device=device)
        if num_boots is not None:
            pooled = spu.within_cluster_sums(data=features.values, labels=labels,
                                             device=device)
            stats["gap_stat"][k], stats["gap_sds"][k] = gap_stat(
                features, k, pooled, num_boots, device=device)
        stats["cell_counts"][k] = pd.DataFrame.from_dict(cell_count)
    stats["featurization"] = featurization
    return stats


def fov_density(cell_table, total_pix=1024 ** 2):
    """Per-FOV average cell size, cellular density, and cell counts."""
    average_area, cellular_density, total_cells = {}, {}, {}
    for i in cell_table["fovs"]:
        average_area[i] = cell_table[i].cell_size.mean()
        cellular_density[i] = np.sum(cell_table[i].cell_size) / total_pix
        total_cells[i] = cell_table[i].shape[0]
    return {"average_area": average_area,
            "cellular_density": cellular_density,
            "total_cells": total_cells}
