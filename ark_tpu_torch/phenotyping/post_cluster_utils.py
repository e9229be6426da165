"""Post-clustering utilities: marker-threshold histograms, Mantis project
assembly from cell tables, coarser cluster resolutions.

Port of ``ark_tpu/phenotyping/post_cluster_utils.py``. The Mantis project's
per-FOV relabel runs on `device` (``data_utils.label_cells_by_cluster``);
the rest is pandas and file copies. matplotlib is imported inside
``plot_hist_thresholds``."""

from __future__ import annotations

import itertools
import os
from typing import List

import numpy as np
import pandas as pd

from ark_tpu_torch import settings
from ark_tpu_torch.io import load_utils
from ark_tpu_torch.utils import data_utils
from ark_tpu_torch.utils.misc_utils import (make_iterable, verify_in_list,
                                            verify_same_elements)


def plot_hist_thresholds(cell_table, populations, marker,
                         pop_col="cell_meta_cluster", threshold=None,
                         percentile=0.999):
    """Stacked histograms comparing marker distribution across populations."""
    import matplotlib.pyplot as plt

    all_populations = cell_table[pop_col].unique()
    populations = list(make_iterable(populations, ignore_str=True))
    for pop in populations:
        if pop not in all_populations:
            raise ValueError(
                "Invalid population name found in populations: {}".format(pop))
    if marker not in cell_table.columns:
        raise ValueError(
            "Could not find {} as a column in cell table".format(marker))

    vals = cell_table.loc[cell_table[pop_col] == populations[0], marker].values
    x_max = np.quantile(vals, percentile)
    pop_num = len(populations)
    fig, axes = plt.subplots(pop_num, 1, figsize=[6.4, 2.2 * pop_num],
                             squeeze=False)
    for ax, pop in zip(axes.flat, populations):
        plot_vals = cell_table.loc[cell_table[pop_col] == pop, marker].values
        ax.hist(plot_vals, 50, density=True, facecolor="g", alpha=0.75,
                range=(0, x_max))
        ax.set_title("Distribution of {} in {}".format(marker, pop))
        if threshold:
            ax.axvline(x=threshold)
    plt.tight_layout()


def create_mantis_project(cell_table: pd.DataFrame, fovs: List[str], seg_dir,
                          mask_dir, image_dir, mantis_dir,
                          pop_col: str = settings.CELL_TYPE,
                          fov_col: str = settings.FOV_ID,
                          label_col: str = settings.CELL_LABEL,
                          seg_suffix_name: str = "_whole_cell.tiff", *,
                          device="cuda") -> None:
    """Full Mantis project from a clustered cell table: per FOV the relabel
    (on `device`) and the mask file, then the project directory."""
    from ark_tpu_torch.utils import plot_utils

    seg_suffix_ext = seg_suffix_name.split(".")[-1]
    verify_in_list(seg_suffix_ext=seg_suffix_ext,
                   supported_image_extensions=["tiff", "tif", "png", "jpg",
                                               "jpeg"])
    seg_suffix_name_no_ext = seg_suffix_name.split(".")[0]
    os.makedirs(mask_dir, exist_ok=True)

    small_table = cell_table.loc[:, [pop_col, "label", "fov"]].copy()
    small_table["pop_vals"] = pd.factorize(small_table[pop_col])[0] + 1
    cmd_pop = data_utils.ClusterMaskData(
        data=small_table, fov_col=fov_col, label_col=label_col,
        cluster_col="pop_vals")

    for fov in fovs:
        label_map = load_utils.load_imgs_from_dir(
            data_dir=seg_dir, files=[fov + seg_suffix_name],
            xr_dim_name="compartments",
            xr_channel_names=[seg_suffix_name_no_ext],
            trim_suffix=seg_suffix_name_no_ext).sel(fovs=fov)
        mask_data = data_utils.label_cells_by_cluster(
            fov=fov, cmd=cmd_pop, label_map=label_map.values, device=device)
        data_utils.save_fov_mask(fov, mask_dir, mask_data, sub_dir=None,
                                 name_suffix="_post_clustering_cell_mask")

    mantis_df = small_table.rename(
        {"pop_vals": "cluster_id", pop_col: "cell_meta_cluster_rename"},
        axis=1)
    plot_utils.create_mantis_dir(
        fovs=fovs, mantis_project_path=mantis_dir, img_data_path=image_dir,
        mask_output_dir=mask_dir, mask_suffix="_post_clustering_cell_mask",
        mapping=mantis_df, seg_dir=seg_dir, cluster_type="cell",
        img_sub_folder="", seg_suffix_name=seg_suffix_name)


def generate_new_cluster_resolution(cell_table, cluster_col, new_cluster_col,
                                    cluster_mapping, save_path):
    """Add a coarser cluster column via a {new_name: [old names]} mapping."""
    verify_in_list(cluster_col=[cluster_col],
                   cell_table_columns=cell_table.columns)
    if new_cluster_col in cell_table.columns:
        raise ValueError(
            f"The column {new_cluster_col} already exists in the cell table. "
            f"Please specify a different name for the new column.")
    values = list(cluster_mapping.values())
    if any(not isinstance(group, list) for group in values):
        raise ValueError("Please make sure all values of the dictionary "
                         "specify a list.")
    cluster_list = list(itertools.chain.from_iterable(values))
    verify_same_elements(
        specified_cell_clusters=cluster_list,
        cell_clusters_in_table=list(cell_table[cluster_col].unique()))
    for new_cluster, pops in cluster_mapping.items():
        idx = np.isin(cell_table[cluster_col].values, pops)
        cell_table.loc[idx, new_cluster_col] = new_cluster
    cell_table.to_csv(os.path.join(save_path), index=False)
