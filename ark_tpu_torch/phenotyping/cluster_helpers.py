"""Pixie SOM / consensus-cluster orchestration classes.

Port of ``ark_tpu/phenotyping/cluster_helpers.py``: ``PixieSOMCluster``
(train/map), ``PixelSOMCluster`` (channel-norm-file division),
``CellSOMCluster`` (99.9% nonzero-quantile column normalization),
``ConsensusCluster`` (Monti et al. consensus clustering, numpy as in the JAX
package), ``WardClustering`` (sklearn's ``AgglomerativeClustering`` with Ward
linkage and no connectivity: scipy's ``ward`` tree cut as sklearn cuts it)
and ``PixieConsensusCluster`` (z-score/cap and the SOM->meta mapping,
1-indexed). The SOM trains and maps on the object's
``device`` through ``ark_tpu_torch.ops.som``; on a CUDA device the mapping
runs the hand-written BMU kernel. Files go through the port's own
``ark_tpu_torch.io``. ``CellSOMCluster``'s steps run in spans of their own
(``cells.normalize``; ``cells.som_train`` and ``cells.som_assign`` with the
device's events); the pixel SOM's do not.
"""

from __future__ import annotations

import heapq
import os
import pathlib
import warnings
from abc import ABC, abstractmethod
from typing import List, Literal, Optional, Protocol

import numpy as np
import pandas as pd
from scipy.stats import zscore

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io.io_utils import list_files, validate_paths
from ark_tpu_torch.ops import som as som_ops
from ark_tpu_torch.utils import profiling
from ark_tpu_torch.utils.misc_utils import verify_in_list


def verify_unique_meta_clusters(pixie_remapped_data: pd.DataFrame,
                                meta_cluster_type: Literal["pixel", "cell"]):
    """Require a unique renamed meta cluster per base meta cluster
    (reference `cluster_helpers.py:19-49` contract)."""
    verify_in_list(specified_meta_cluster=meta_cluster_type,
                   acceptable_meta_clusters=["pixel", "cell"])
    pairs = pixie_remapped_data[
        [f"{meta_cluster_type}_meta_cluster",
         f"{meta_cluster_type}_meta_cluster_rename"]].drop_duplicates()
    dups = pairs[pairs.duplicated(
        f"{meta_cluster_type}_meta_cluster_rename", keep=False)][
        f"{meta_cluster_type}_meta_cluster_rename"].unique().tolist()
    if dups:
        raise ValueError(
            f"Duplicate renamed {meta_cluster_type} meta cluster values found: "
            f"{dups}, please re-run remapping GUI to resolve naming conflicts")


class PixieSOMCluster(ABC):
    """Abstract SOM runner: train on a data matrix, assign BMU clusters, on
    `device`."""

    @abstractmethod
    def __init__(self, weights_path: pathlib.Path, columns: List[str],
                 num_passes: int = 1, xdim: int = 10, ydim: int = 10,
                 lr_start: float = 0.05, lr_end: float = 0.01, seed=42,
                 device="cuda"):
        self.weights_path = weights_path
        self.weights: Optional[pd.DataFrame] = (
            feather.read_dataframe(weights_path) if os.path.exists(weights_path) else None)
        self.columns = columns
        self.num_passes = num_passes
        self.xdim = xdim
        self.ydim = ydim
        self.lr_start = lr_start
        self.lr_end = lr_end
        self.seed = seed
        self.device = device

    @abstractmethod
    def normalize_data(self) -> pd.DataFrame:
        """Normalization applied to input data before train/map."""

    def train_som(self, data: pd.DataFrame):
        """Train on `data` and persist weights to `weights_path` (feather,
        columns = training columns; reference `cluster_helpers.py:98-116`)."""
        w = som_ops.som_train(
            data.values.astype(np.float32), xdim=self.xdim, ydim=self.ydim,
            num_passes=self.num_passes, lr_start=self.lr_start,
            lr_end=self.lr_end, seed=self.seed, device=self.device)
        self.weights = pd.DataFrame(w, columns=data.columns.values)
        feather.write_dataframe(self.weights, self.weights_path)

    def generate_som_clusters(self, external_data: pd.DataFrame,
                              num_parallel_obs: int = 1_000_000) -> np.ndarray:
        """Assign 1-indexed SOM clusters to `external_data` rows.

        `num_parallel_obs` is kept for API parity; the whole array is mapped
        in one kernel launch."""
        if num_parallel_obs <= 0:
            raise ValueError("num_parallel_obs specified needs to be greater than 0")
        weights_cols = list(self.weights.columns)
        verify_in_list(weights_cols=weights_cols,
                       external_data_cols=external_data.columns.values)
        if external_data.shape[0] == 0:
            return np.empty(0)
        clusters, _ = som_ops.som_map(
            self.weights.values.astype(np.float32),
            external_data[weights_cols].values.astype(np.float32),
            return_dist=False, device=self.device)
        return clusters


class PixelSOMCluster(PixieSOMCluster):
    def __init__(self, pixel_subset_folder: pathlib.Path,
                 norm_vals_path: pathlib.Path, weights_path: pathlib.Path,
                 fovs: List[str], columns: List[str], num_passes: int = 1,
                 xdim: int = 10, ydim: int = 10, lr_start: float = 0.05,
                 lr_end: float = 0.01, seed=42, device="cuda"):
        """Pixel-level SOM: training data = subsetted per-FOV feathers,
        normalization = divide by the 99.9% post-rownorm channel values
        (reference `cluster_helpers.py:166-301`)."""
        super().__init__(weights_path, columns, num_passes, xdim, ydim,
                         lr_start, lr_end, seed, device)
        validate_paths([norm_vals_path, pixel_subset_folder])
        self.norm_data = feather.read_dataframe(norm_vals_path)
        self.fovs = fovs
        fov_files = list_files(pixel_subset_folder, substrs=".feather")
        self.train_data = pd.concat(
            [feather.read_dataframe(os.path.join(pixel_subset_folder, f))
             for f in fov_files if os.path.splitext(f)[0] in fovs])
        self.train_data = self.normalize_data(self.train_data)
        self.som_clusters_seen = set()

    def normalize_data(self, external_data: pd.DataFrame) -> pd.DataFrame:
        verify_in_list(norm_data_cols=self.norm_data.columns.values,
                       external_data_cols=external_data.columns.values)
        cols = list(self.norm_data.columns)
        out = external_data.copy()
        out[cols] = out[cols].div(self.norm_data.iloc[0], axis=1)
        return out

    def train_som(self, overwrite=False):
        if overwrite:
            warnings.warn("Overwrite flag set, retraining SOM")
        elif self.weights is not None:
            if set(self.weights.columns.values) == set(self.columns):
                warnings.warn("Pixel SOM already trained on specified markers")
                return
            warnings.warn("New markers specified, retraining")
        super().train_som(self.train_data[self.columns])

    def assign_som_clusters(self, external_data: pd.DataFrame,
                            normalize_data: bool = True,
                            num_parallel_pixels: int = 1_000_000) -> pd.DataFrame:
        ext = self.normalize_data(external_data) if normalize_data \
            else external_data.copy()
        labels = super().generate_som_clusters(
            ext, num_parallel_obs=num_parallel_pixels)
        ext["pixel_som_cluster"] = labels
        self.som_clusters_seen.update(list(np.unique(labels)))
        return ext

    def assign_som_clusters_table(self, table, normalize_data: bool = True,
                                  num_parallel_pixels: int = 1_000_000):
        """Arrow-Table variant of `assign_som_clusters`: only the channel
        columns round-trip through pandas (they feed the BMU kernel and,
        when `normalize_data`, are rewritten normalized); fov / row_index /
        column_index / label pass through as arrow buffers."""
        cols = list(self.norm_data.columns)
        verify_in_list(norm_data_cols=cols,
                       external_data_cols=table.column_names)
        sub = table.select(cols).to_pandas()
        if normalize_data:
            sub = sub.div(self.norm_data.iloc[0], axis=1)
        labels = self.generate_som_clusters(
            sub, num_parallel_obs=num_parallel_pixels)
        self.som_clusters_seen.update(list(np.unique(labels)))
        updates = {}
        if normalize_data:
            updates.update({c: sub[c] for c in cols})
        updates["pixel_som_cluster"] = pd.Series(labels, index=sub.index)
        return feather.table_set_columns(table, updates)


class CellSOMCluster(PixieSOMCluster):
    def __init__(self, cell_data: pd.DataFrame, weights_path: pathlib.Path,
                 fovs: List[str], columns: List[str], num_passes: int = 1,
                 xdim: int = 10, ydim: int = 10, lr_start: float = 0.05,
                 lr_end: float = 0.01, seed=42, normalize=True, device="cuda"):
        """Cell-level SOM over the cells x pixel-cluster-count table, each
        column normalized by its 99.9% nonzero quantile (reference
        `cluster_helpers.py:304-416`)."""
        super().__init__(weights_path, columns, num_passes, xdim, ydim,
                         lr_start, lr_end, seed, device)
        self.cell_data = cell_data[cell_data["fov"].isin(fovs)].reset_index(drop=True)
        self.fovs = fovs
        if normalize:
            self.normalize_data()

    def normalize_data(self):
        with profiling.span("cells.normalize"):
            sub = self.cell_data[self.columns].copy()
            norm_vals = sub.replace(0, np.nan).quantile(q=0.999, axis=0)
            self.cell_data[self.columns] = sub.div(norm_vals)

    def train_som(self, overwrite=False):
        if overwrite:
            warnings.warn("Overwrite flag set, retraining SOM")
        elif self.weights is not None:
            if set(self.weights.columns.values) == set(self.columns):
                warnings.warn("Cell SOM already trained on specified columns")
                return
            warnings.warn("New columns specified, retraining")
        with profiling.span("cells.som_train", device=self.device,
                            rows=len(self.cell_data)):
            super().train_som(self.cell_data[self.columns])

    def assign_som_clusters(self, num_parallel_cells=1_000_000) -> pd.DataFrame:
        with profiling.span("cells.som_assign", device=self.device) as sp:
            launches = som_ops.bmu.launches
            labels = super().generate_som_clusters(
                self.cell_data[self.columns], num_parallel_obs=num_parallel_cells)
            if sp.recorded:
                sp.attrs["bmu"] = som_ops.bmu.launches - launches
        self.cell_data["cell_som_cluster"] = labels
        return self.cell_data


class ClusterClassTemplate(Protocol):
    """Structural type for the base clusterer handed to consensus clustering
    (reference `cluster_helpers.py:421-425`): anything exposing
    `fit_predict()` and `n_clusters` (e.g. ``WardClustering``, or sklearn's
    AgglomerativeClustering).
    """

    def fit_predict(self) -> None: ...

    @property
    def n_clusters(self) -> int: ...


class WardClustering:
    """Ward agglomerative clustering of the rows of X into `n_clusters`: the
    labels ``sklearn.cluster.AgglomerativeClustering(n_clusters)`` gives
    (Ward linkage, no connectivity matrix). sklearn builds the whole tree
    with ``scipy.cluster.hierarchy.ward`` and cuts it with ``_hc_cut``; so
    does this class, with its own copy of the cut."""

    def __init__(self, n_clusters: int = 2):
        self.n_clusters = n_clusters

    def fit(self, X, y=None) -> "WardClustering":
        from scipy.cluster import hierarchy

        if not isinstance(self.n_clusters, (int, np.integer)) or self.n_clusters < 1:
            raise ValueError(f"n_clusters must be an int >= 1, got {self.n_clusters!r}")
        X = np.asarray(X)
        if X.dtype not in (np.float32, np.float64):
            X = X.astype(np.float64)
        if X.ndim != 2 or X.shape[0] < 2 or X.shape[1] < 1:
            raise ValueError(f"Found array with shape {X.shape}: Ward clustering needs "
                             f"a 2-D array of at least 2 samples and 1 feature")
        if not np.isfinite(X).all():
            raise ValueError("Input X contains NaN or infinity.")
        tree = hierarchy.ward(np.require(X, requirements="W"))
        self.children_ = tree[:, :2].astype(np.intp)
        self.n_leaves_ = X.shape[0]
        self.labels_ = _hc_cut(self.n_clusters, self.children_, self.n_leaves_)
        return self

    def fit_predict(self, X, y=None) -> np.ndarray:
        return self.fit(X).labels_


def _hc_cut(n_clusters: int, children: np.ndarray, n_leaves: int) -> np.ndarray:
    """sklearn's cut of a merge tree: pop the largest node from a heap of
    negated ids `n_clusters` - 1 times, pushing its two children, then
    label each remaining node's leaves by its place in the heap."""
    if n_clusters > n_leaves:
        raise ValueError(f"Cannot extract more clusters than samples: {n_clusters} "
                         f"clusters were given for a tree with {n_leaves} leaves.")
    nodes = [-(max(children[-1]) + 1)]
    for _ in range(n_clusters - 1):
        pair = children[-nodes[0] - n_leaves]
        heapq.heappush(nodes, -pair[0])
        heapq.heappushpop(nodes, -pair[1])
    label = np.zeros(n_leaves, dtype=np.intp)
    for i, node in enumerate(nodes):
        stack, leaves = [-node], []
        while stack:
            top = stack.pop()
            if top < n_leaves:
                leaves.append(top)
            else:
                stack.extend(children[top - n_leaves])
        label[leaves] = i
    return label


class ConsensusCluster:
    """Monti et al. (2003) consensus clustering (numpy, as in the JAX
    package): for each k in [L, K) run H resamplings at
    `resample_proportion`, accumulate the co-cluster connectivity and
    co-sample counts with indicator outer products, form consensus matrices
    Mk, and pick bestK by the max change in area under the consensus CDF.
    """

    def __init__(self, cluster, L: int, K: int, H: int,
                 resample_proportion: float = 0.5, seed: int = 42):
        if not 0 <= resample_proportion <= 1:
            raise ValueError("proportion has to be between 0 and 1")
        self.cluster_ = cluster
        self.resample_proportion_ = resample_proportion
        self.L_ = L
        self.K_ = K
        self.H_ = H
        self.seed = seed
        self.Mk = None
        self.Ak = None
        self.deltaK = None
        self.bestK = None

    def fit(self, data, verbose: bool = False):
        data = np.asarray(data)
        n = data.shape[0]
        n_ks = self.K_ - self.L_
        Mk = np.zeros((n_ks, n, n))
        rng = np.random.default_rng(self.seed)
        for i_, k in enumerate(range(self.L_, self.K_)):
            if verbose:
                print(f"consensus: k={k}")
            conn = np.zeros((n, n))
            together = np.zeros((n, n))
            for _ in range(self.H_):
                idx = rng.choice(
                    n, size=int(n * self.resample_proportion_), replace=False)
                labels = self.cluster_(n_clusters=k).fit_predict(data[idx])
                picked = np.zeros(n, bool)
                picked[idx] = True
                together += np.outer(picked, picked)
                for lab in np.unique(labels):
                    ind = np.zeros(n, bool)
                    ind[idx[labels == lab]] = True
                    conn += np.outer(ind, ind)
            M = conn / (together + 1e-8)
            np.fill_diagonal(M, 1.0)
            Mk[i_] = M
        self.Mk = Mk
        # area under consensus CDF per k, then relative changes
        self.Ak = np.zeros(n_ks)
        for i, m in enumerate(Mk):
            hist, bins = np.histogram(m.ravel(), density=True)
            self.Ak[i] = float(np.sum(
                [(b - a) * h for b, a, h in
                 zip(bins[1:], bins[:-1], np.cumsum(hist))]))
        self.deltaK = np.array(
            [(ab - aa) / aa if i > 2 else aa
             for ab, aa, i in zip(self.Ak[1:], self.Ak[:-1],
                                  range(self.L_, self.K_ - 1))])
        self.bestK = (int(np.argmax(self.deltaK)) + self.L_
                      if self.deltaK.size > 0 else self.L_)

    def predict(self):
        if self.Mk is None:
            raise RuntimeError("First run fit")
        return self.cluster_(n_clusters=self.bestK).fit_predict(
            1 - self.Mk[self.bestK - self.L_])

    def predict_data(self, data):
        if self.Mk is None:
            raise RuntimeError("First run fit")
        return self.cluster_(n_clusters=self.bestK).fit_predict(data)


class PixieConsensusCluster:
    """z-score + cap -> consensus (agglomerative) clustering of SOM-average
    tables -> SOM->meta mapping (reference `cluster_helpers.py:575-682`)."""

    def __init__(self, cluster_type: str, input_file: pathlib.Path,
                 columns: List[str], max_k: int = 20, cap: float = 3):
        verify_in_list(provided_cluster_type=cluster_type,
                       supported_cluster_types=["pixel", "cell"])
        validate_paths([input_file])
        self.cluster_type = cluster_type
        self.som_col = f"{cluster_type}_som_cluster"
        self.meta_col = f"{cluster_type}_meta_cluster"
        self.input_file = input_file
        self.input_data = pd.read_csv(input_file)
        self.columns = columns
        self.max_k = max_k
        self.cap = cap
        # H=10 / 0.8 mirror ConsensusClusterPlus defaults (reference :615-623)
        self.cc = ConsensusCluster(cluster=WardClustering,
                                   L=max_k, K=max_k, H=10,
                                   resample_proportion=0.8)
        self.mapping = None

    def scale_data(self):
        self.input_data[self.columns] = self.input_data[self.columns].apply(zscore)
        self.input_data[self.columns] = self.input_data[self.columns].clip(
            lower=-self.cap, upper=self.cap)

    def run_consensus_clustering(self):
        self.cc.fit(self.input_data[self.columns])

    def generate_som_to_meta_map(self):
        self.input_data[self.meta_col] = self.cc.predict_data(
            self.input_data[self.columns])
        self.mapping = self.input_data[[self.som_col, self.meta_col]].copy()
        self.mapping = self.mapping.astype(int)
        # clusters are 1-indexed; correct for the 0-indexed labels
        self.mapping.loc[:, self.meta_col] += 1

    def save_som_to_meta_map(self, save_path: pathlib.Path):
        feather.write_dataframe(self.mapping, save_path)

    def assign_consensus_labels(self, external_data: pd.DataFrame) -> pd.DataFrame:
        external_data[self.meta_col] = external_data[self.som_col].map(
            self.mapping.set_index(self.som_col)[self.meta_col])
        return external_data

    def assign_consensus_labels_table(self, table):
        """Arrow-Table variant of `assign_consensus_labels`: reads only the
        SOM-label column into pandas, maps it through the SOM->meta table
        with the same `Series.map`, and passes every other column through
        as arrow buffers."""
        som = table.column(self.som_col).to_pandas()
        meta = som.map(self.mapping.set_index(self.som_col)[self.meta_col])
        return feather.table_set_columns(table, {self.meta_col: meta})
