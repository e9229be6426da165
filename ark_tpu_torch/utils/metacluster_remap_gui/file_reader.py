"""CSV reader/validator for metacluster remapping (reference
`src/ark/utils/metacluster_remap_gui/file_reader.py:8-75`)."""

from __future__ import annotations

import pandas as pd

from ark_tpu_torch.io import io_utils
from ark_tpu_torch.utils.misc_utils import verify_in_list

from .metaclusterdata import MetaClusterData


def metaclusterdata_from_files(cluster_path, cluster_type="pixel",
                               prefix_trim=None) -> MetaClusterData:
    """Read + validate a SOM-average CSV into a MetaClusterData."""
    if isinstance(cluster_path, str):
        io_utils.validate_paths(cluster_path)
    verify_in_list(provided_cluster_type=[cluster_type],
                   valid_cluster_types=["pixel", "cell"])
    cluster_data = pd.read_csv(cluster_path)
    if prefix_trim is not None:
        cluster_data = cluster_data.rename(columns={
            col: col.replace(prefix_trim, "")
            for col in cluster_data.columns.values})
    cluster_data = cluster_data.rename(columns={
        f"{cluster_type}_som_cluster": "cluster",
        f"{cluster_type}_meta_cluster": "metacluster",
        f"{cluster_type}_meta_cluster_rename": "metacluster_rename"})

    if "cluster" not in cluster_data.columns:
        raise ValueError('Cluster table must include column named "cluster"')
    if "metacluster" not in cluster_data.columns:
        raise ValueError(
            'Cluster table must include column named "metacluster"')
    if "count" not in cluster_data.columns:
        raise ValueError('Cluster table must include column named "count"')
    if len(set(cluster_data["cluster"].values)) != \
            len(list(cluster_data["cluster"].values)):
        raise ValueError("SOM cluster ids must be unique")
    if 1 not in cluster_data["cluster"].values:
        raise ValueError("SOM cluster ids must be int type, starting with 1.")
    if 0 in cluster_data["cluster"].values:
        raise ValueError("SOM cluster ids start with 1, but a zero was "
                         "detected.")
    som_counts = cluster_data[["cluster", "count"]].copy()
    som_expression = cluster_data.drop(columns="count")
    return MetaClusterData(cluster_type, som_expression, som_counts)
