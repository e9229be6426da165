"""Neighborhood featurization for spatial LDA: a port of
``ark_tpu/spLDA/featurization.py``.

The four ``neighborhood_to_*`` reducers keep each FOV's (anchors, cells)
indicator of distance <= radius on `device`: distances by
``ops.distances.squared_distances`` and ``_sqrt`` (bitwise the JAX
package's ``cdist`` for D = 2), the threshold as f32 0/1, then one product
with the one-hot or marker matrix in full f32. Counts are sums of 0/1 terms,
exact integers below 2^24 in any order, so they are bitwise equal on every
device and to the JAX package's. ``featurize_samples``, ``_mst_edges``
(scipy's Delaunay and minimum spanning tree) and
``make_merged_difference_matrices`` are host code.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.ops import distances
from ark_tpu_torch.ops.som import _check_full_f32_matmul


def _neighbor_indicator(fov_df: pd.DataFrame, is_anchor_col: str, radius: float,
                        x_col: str, y_col: str, device):
    """(anchors, cells) f32 0/1 indicator of distance <= radius on `device`
    (each anchor included), and the host's boolean anchor mask."""
    coords = torch.as_tensor(fov_df[[x_col, y_col]].values.astype(np.float32),
                             device=device)
    anchors = fov_df[is_anchor_col].values.astype(bool)
    rows = coords[torch.as_tensor(np.flatnonzero(anchors), device=device)]
    d = distances._sqrt(distances.squared_distances(rows, coords))
    return (d <= radius).to(torch.float32), anchors


def _indicator_product(ind: torch.Tensor, values: np.ndarray) -> torch.Tensor:
    _check_full_f32_matmul()
    return ind @ torch.as_tensor(np.ascontiguousarray(values, np.float32),
                                 device=ind.device)


def neighborhood_to_cluster(fov_df, radius, is_anchor_col="is_index", x_col="x",
                            y_col="y", *, device="cuda", **kwargs) -> pd.DataFrame:
    """Counts of each cell cluster within `radius` of each anchor cell."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius, x_col, y_col,
                                       device)
    onehot = pd.get_dummies(fov_df["cluster"]).astype(np.float32)
    counts = _indicator_product(ind, onehot.values).cpu().numpy()
    return pd.DataFrame(counts, columns=list(onehot.columns),
                        index=fov_df.index[anchors])


def neighborhood_to_marker(fov_df, radius, markers, is_anchor_col="is_index", x_col="x",
                           y_col="y", *, device="cuda", **kwargs) -> pd.DataFrame:
    """Counts of marker-positive (> 0.5) cells within `radius`."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius, x_col, y_col,
                                       device)
    pos = (fov_df[list(markers)].values > 0.5).astype(np.float32)
    counts = _indicator_product(ind, pos).cpu().numpy()
    return pd.DataFrame(counts, columns=list(markers), index=fov_df.index[anchors])


def neighborhood_to_avg_marker(fov_df, radius, markers, is_anchor_col="is_index",
                               x_col="x", y_col="y", *, device="cuda",
                               **kwargs) -> pd.DataFrame:
    """Average marker expression of cells within `radius`: the product's f32
    sums run in another order than XLA's, so within a few ulps of the JAX
    package's."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius, x_col, y_col,
                                       device)
    sums = _indicator_product(ind, fov_df[list(markers)].values)
    n = ind.sum(dim=1, keepdim=True)
    avg = (sums / torch.clamp_min(n, 1.0)).cpu().numpy()
    return pd.DataFrame(avg, columns=list(markers), index=fov_df.index[anchors])


def neighborhood_to_count(fov_df, radius, is_anchor_col="is_index", x_col="x",
                          y_col="y", *, device="cuda", **kwargs) -> pd.DataFrame:
    """Total number of cells within `radius` of each anchor."""
    ind, anchors = _neighbor_indicator(fov_df, is_anchor_col, radius, x_col, y_col,
                                       device)
    return pd.DataFrame({"count": ind.sum(dim=1).cpu().numpy()},
                        index=fov_df.index[anchors])


def featurize_samples(sample_dfs: Dict, neighborhood_feature_fn: Callable,
                      radius: float, is_anchor_col: str, x_col: str,
                      y_col: str, n_processes=None,
                      include_anchors: bool = True) -> pd.DataFrame:
    """Featurize every FOV; returns one frame with a (fov, cell) MultiIndex.
    A cluster absent from a FOV gets its column there, filled with 0."""
    frames = []
    for fov, fov_df in sample_dfs.items():
        feats = neighborhood_feature_fn(fov_df, radius=radius,
                                        is_anchor_col=is_anchor_col,
                                        x_col=x_col, y_col=y_col)
        feats.index = pd.MultiIndex.from_product([[fov], feats.index])
        frames.append(feats)
    return pd.concat(frames).fillna(0)


def _mst_edges(coords: np.ndarray) -> np.ndarray:
    """(E, 2) edge list of the euclidean MST over Delaunay adjacency."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree
    from scipy.spatial import Delaunay, QhullError

    n = len(coords)
    if n < 2:
        return np.empty((0, 2), np.int64)
    if n == 2:
        return np.array([[0, 1]], np.int64)
    try:
        simplices = Delaunay(coords).simplices
        # each triangle's three sides as (low, high), in sorted order: the
        # JAX package's sorted set of pairs
        sides = np.sort(np.concatenate([simplices[:, [0, 1]], simplices[:, [1, 2]],
                                        simplices[:, [2, 0]]]).astype(np.int64), axis=1)
        keys = np.unique(sides[:, 0] * n + sides[:, 1])
        pairs = np.stack([keys // n, keys % n], axis=1)
    except QhullError:
        # degenerate geometry (collinear cells): the complete graph
        ii, jj = np.triu_indices(n, k=1)
        pairs = np.stack([ii, jj], axis=1)
    weights = np.linalg.norm(coords[pairs[:, 0]] - coords[pairs[:, 1]], axis=1)
    graph = coo_matrix((weights, (pairs[:, 0], pairs[:, 1])), shape=(n, n))
    mst = minimum_spanning_tree(graph).tocoo()
    return np.stack([mst.row, mst.col], axis=1).astype(np.int64)


def make_merged_difference_matrices(sample_features: pd.DataFrame,
                                    sample_dfs: Dict, x_col="x", y_col="y",
                                    reduce_to_mst: bool = True) -> Dict:
    """Per-FOV difference matrices over the featurized cells: each row has
    +1/-1 at the endpoints of one spatial-adjacency (MST) edge."""
    out = {}
    for fov in sample_features.index.get_level_values(0).unique():
        cell_idx = sample_features.loc[fov].index
        fov_df = sample_dfs[fov].loc[cell_idx]
        coords = fov_df[[x_col, y_col]].values.astype(np.float64)
        edges = _mst_edges(coords)
        diff = np.zeros((len(edges), len(coords)), np.float32)
        rows = np.arange(len(edges))
        diff[rows, edges[:, 0]] = 1.0
        diff[rows, edges[:, 1]] = -1.0
        out[fov] = diff
    return out
