"""State model for the metacluster remap GUI.

Holds the SOM-cluster expression table, the SOM→metacluster mapping, display
names, and pixel counts, and derives the weighted metacluster averages and
dendrogram linkage the GUI renders (behavioral parity with reference
`metacluster_remap_gui/metaclusterdata.py:7-152`)."""

from __future__ import annotations

from pathlib import Path

import numpy as np


def cosine_similarity(X) -> np.ndarray:
    """``sklearn.metrics.pairwise.cosine_similarity(X)`` in its order of
    operations: rows over their norms (norms under 10 eps taken as 1), then
    the product of the normalized rows with their transpose."""
    X = np.asarray(X)
    if X.dtype not in (np.float32, np.float64):
        X = X.astype(np.float64)
    norms = np.sqrt(np.einsum("ij,ij->i", X, X))
    norms[norms < 10 * np.finfo(norms.dtype).eps] = 1.0
    normalized = X / norms[:, None]
    return normalized @ normalized.T


class MetaClusterData:
    """Remapping session state: expression + mapping + names + persistence."""

    def __init__(self, cluster_type, raw_clusters_df, raw_pixelcounts_df):
        self.cluster_type = cluster_type
        by_cluster = raw_clusters_df.sort_values("cluster")
        counts = raw_pixelcounts_df.sort_values("cluster")
        self.cluster_pixelcounts = counts.set_index("cluster")
        self._clusters = by_cluster.set_index("cluster").drop(
            columns="metacluster")
        self.mapping = by_cluster.set_index("cluster")[["metacluster"]]

        # carry renames forward across sessions
        self._displaynames = {}
        if "metacluster_rename" in by_cluster.columns:
            for _, row in by_cluster[["metacluster", "metacluster_rename"]
                                     ].drop_duplicates().iterrows():
                self._displaynames[row["metacluster"]] = \
                    str(row["metacluster_rename"])

        self._marker_order = list(range(len(self._clusters.columns)))
        self._output_mapping_filename = None
        self._metacluster_cache = None

    # ---- persistence target -------------------------------------------
    @property
    def output_mapping_filename(self):
        return self._output_mapping_filename

    @output_mapping_filename.setter
    def output_mapping_filename(self, filepath):
        self._output_mapping_filename = Path(filepath)

    # ---- derived tables ------------------------------------------------
    @property
    def clusters_with_metaclusters(self):
        joined = self._clusters.join(self.mapping)
        joined = joined.sort_values(by="metacluster")
        tail = list(range(max(self._marker_order) + 1, joined.shape[1]))
        return joined.iloc[:, self._marker_order + tail]

    @property
    def clusters(self):
        table = self.clusters_with_metaclusters
        drop = [c for c in ("metacluster", "metacluster_rename")
                if c in table.columns]
        return table.drop(columns=drop)

    @property
    def metaclusters(self):
        """Pixel-count-weighted average expression per metacluster."""
        if self._metacluster_cache is None:
            weights = self.cluster_pixelcounts["count"]
            weighted = self.clusters.mul(weights, axis=0).join(self.mapping)
            sums = weighted.groupby("metacluster").sum()
            totals = self.cluster_pixelcounts.join(
                self.mapping).groupby("metacluster")["count"].sum()
            self._metacluster_cache = sums.div(totals, axis=0)
        return self._metacluster_cache

    @property
    def linkage_matrix(self):
        from scipy.cluster.hierarchy import ward
        return ward(cosine_similarity(self.clusters.T.values))

    # ---- names -----------------------------------------------------------
    @property
    def metacluster_displaynames(self):
        return [self.get_metacluster_displayname(mc)
                for mc in self.metaclusters.index]

    def get_metacluster_displayname(self, metacluster):
        return self._displaynames.get(metacluster, str(metacluster))

    def change_displayname(self, metacluster, displayname):
        self._displaynames[metacluster] = displayname
        self.save_output_mapping()

    # ---- mapping edits ---------------------------------------------------
    def cluster_in_metacluster(self, metacluster):
        rows = self.mapping["metacluster"] == metacluster
        return list(self.mapping.index[rows])

    def which_metacluster(self, cluster):
        return self.mapping.at[cluster, "metacluster"]

    def new_metacluster(self):
        return self.mapping["metacluster"].max() + 1

    def remap(self, cluster, metacluster):
        self.mapping.loc[cluster, "metacluster"] = metacluster
        self._metacluster_cache = None

    @property
    def marker_order(self):
        """Current marker display order as original column indexes."""
        return list(self._marker_order)

    def set_marker_order(self, new_indexes):
        self._marker_order = list(new_indexes)
        self._metacluster_cache = None

    def save_output_mapping(self):
        out = self.mapping.copy()
        out.index.names = [f"{self.cluster_type}_som_cluster"]
        renames = [self.get_metacluster_displayname(mc)
                   for mc in out["metacluster"]]
        out[f"{self.cluster_type}_meta_cluster_rename"] = renames
        out.columns = [f"{self.cluster_type}_meta_cluster",
                       f"{self.cluster_type}_meta_cluster_rename"]
        out.to_csv(self.output_mapping_filename)

    # ---- sizes -----------------------------------------------------------
    @property
    def cluster_count(self):
        return len(self.clusters)

    @property
    def metacluster_count(self):
        return self.mapping["metacluster"].nunique()

    @property
    def marker_count(self):
        return len(self.clusters.columns)

    @property
    def marker_names(self):
        return self.clusters.columns

    @property
    def fixed_width_marker_names(self):
        width = max(len(c) for c in self.marker_names)
        return [f"{c:^{width}}" for c in self.marker_names]
