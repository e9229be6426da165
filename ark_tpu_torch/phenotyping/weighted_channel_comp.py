"""Weighted channel expression: (cells x cluster counts) . (clusters x
channel averages).

Port of ``ark_tpu/phenotyping/weighted_channel_comp.py``. The one product
over the whole cohort is a ``torch.matmul`` on `device` in full f32 (the
JAX package leaves it to XLA, outside any Pallas kernel); it refuses to run
with TF32 matmuls enabled. The rest is host pandas. The product runs in a
``cells.weighted`` span with the device's events, the channel averages in
``cells.wc_avg``.
"""

from __future__ import annotations

import os

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.analysis import visualize
from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.io import io_utils
from ark_tpu_torch.ops.som import _check_full_f32_matmul
from ark_tpu_torch.utils import profiling
from ark_tpu_torch.utils.misc_utils import verify_in_list, verify_same_elements


def compute_p2c_weighted_channel_avg(pixel_channel_avg, channels, cell_counts,
                                     fovs=None,
                                     pixel_cluster_col="pixel_meta_cluster_rename",
                                     *, device):
    """Per-cell marker expression = sum_k count(cell, pixel-cluster k) x
    avg_expr(k, channel), divided by the cell size: one (cells x K) . (K x C)
    f32 matmul on `device`."""
    with profiling.span("cells.weighted", device=device):
        if "segmentation_label" in cell_counts.columns:
            cell_counts = cell_counts.rename(
                columns={"segmentation_label": "label"})
        if fovs is None:
            fovs = list(cell_counts["fov"].unique())
        else:
            verify_in_list(provided_fovs=fovs,
                           dataset_fovs=cell_counts["fov"].unique())
        verify_in_list(provided_cluster_col=pixel_cluster_col,
                       valid_cluster_cols=["pixel_som_cluster",
                                           "pixel_meta_cluster_rename"])
        cell_counts_sub = cell_counts[cell_counts["fov"].isin(fovs)].copy()
        cluster_cols = [c for c in cell_counts_sub.columns.values
                        if f"{pixel_cluster_col}" in c]
        cell_counts_clusters = cell_counts_sub[cluster_cols].copy()
        cell_counts_clusters = cell_counts_clusters.reindex(
            sorted(cell_counts_clusters.columns.values), axis=1)

        pixel_channel_avg = pixel_channel_avg.copy()
        if pd.api.types.is_integer_dtype(pixel_channel_avg[pixel_cluster_col]):
            pixel_channel_avg[pixel_cluster_col] = \
                pixel_channel_avg[pixel_cluster_col].astype(str)
        avg_sorted = pixel_channel_avg.sort_values(by=pixel_cluster_col)

        cell_cluster_ids = [c.replace(pixel_cluster_col + "_", "")
                            for c in cell_counts_clusters.columns.values]
        avg_sorted = avg_sorted[avg_sorted[pixel_cluster_col].isin(cell_cluster_ids)]
        verify_same_elements(
            enforce_order=True,
            cell_counts_cluster_ids=cell_cluster_ids,
            pixel_channel_cluster_ids=list(avg_sorted[pixel_cluster_col].values))
        verify_in_list(provided_channels=channels,
                       pixel_channel_avg_cols=avg_sorted.columns.values)

        _check_full_f32_matmul()
        weighted = torch.matmul(
            torch.as_tensor(cell_counts_clusters.values.astype(np.float32),
                            device=device),
            torch.as_tensor(avg_sorted[channels].values.astype(np.float32),
                            device=device)
        ).cpu().numpy()
        out = pd.DataFrame(weighted, columns=channels)
        meta_cols = ["cell_size", "fov", "label"]
        out[meta_cols] = cell_counts_sub.reset_index(drop=True)[meta_cols]
        out[channels] = out[channels].div(out["cell_size"], axis=0)
        return out


def compute_cell_cluster_weighted_channel_avg(fovs, channels, base_dir,
                                              weighted_cell_channel_name,
                                              cell_cluster_data,
                                              cell_cluster_col="cell_meta_cluster"):
    """Average weighted marker expression per cell SOM/meta cluster."""
    path = os.path.join(base_dir, weighted_cell_channel_name)
    io_utils.validate_paths([path])
    verify_in_list(provided_cluster_col=[cell_cluster_col],
                   valid_cluster_cols=["cell_som_cluster", "cell_meta_cluster"])
    cell_table = feather.read_dataframe(path)
    cell_table = cell_table[cell_table["fov"].isin(fovs)]
    cell_table = cell_table.sort_values(by=["fov", "label"]).reset_index(drop=True)
    cell_cluster_data = cell_cluster_data.sort_values(
        by=["fov", "label"]).reset_index(drop=True)
    verify_same_elements(enforce_order=True,
                         cell_table_fovs=list(cell_table["fov"]),
                         cluster_data_fovs=list(cell_cluster_data["fov"]))
    verify_same_elements(enforce_order=True,
                         cell_table_labels=list(cell_table["label"]),
                         cluster_data_labels=list(cell_cluster_data["label"]))
    cell_table[cell_cluster_col] = cell_cluster_data[cell_cluster_col]
    cell_table = cell_table[channels + [cell_cluster_col]]
    channel_avgs = cell_table.groupby(cell_cluster_col).mean().reset_index()
    channel_avgs[cell_cluster_col] = channel_avgs[cell_cluster_col].astype(int)
    return channel_avgs


def generate_wc_avg_files(fovs, channels, base_dir, cell_cc,
                          cell_som_input_data,
                          weighted_cell_channel_name="weighted_cell_channel.feather",
                          cell_som_cluster_channel_avg_name="cell_som_cluster_channel_avg.csv",
                          cell_meta_cluster_channel_avg_name="cell_meta_cluster_channel_avg.csv",
                          overwrite=False):
    """Save weighted channel averages per cell SOM + meta cluster."""
    weighted_channel_path = os.path.join(base_dir, weighted_cell_channel_name)
    som_avg_path = os.path.join(base_dir, cell_som_cluster_channel_avg_name)
    meta_avg_path = os.path.join(base_dir, cell_meta_cluster_channel_avg_name)
    io_utils.validate_paths([weighted_channel_path])
    if os.path.exists(som_avg_path) and os.path.exists(meta_avg_path):
        if not overwrite:
            print("Already generated average weighted channel expression "
                  "files, skipping")
            return
        print("Overwrite flag set, regenerating average weighted channel "
              "expression files")

    with profiling.span("cells.wc_avg"):
        print("Compute average weighted channel expression across cell SOM "
              "clusters")
        som_avg = compute_cell_cluster_weighted_channel_avg(
            fovs, channels, base_dir, weighted_cell_channel_name,
            cell_som_input_data, "cell_som_cluster")
        print("Mapping meta cluster values onto average weighted channel "
              "expression across cell SOM clusters")
        som_avg = som_avg.merge(cell_cc.mapping, on="cell_som_cluster", how="left")
        som_avg.to_csv(som_avg_path, index=False)

        print("Compute average weighted channel expression across cell meta "
              "clusters")
        meta_avg = compute_cell_cluster_weighted_channel_avg(
            fovs, channels, base_dir, weighted_cell_channel_name,
            cell_som_input_data, "cell_meta_cluster")
        meta_avg.to_csv(meta_avg_path, index=False)


def generate_remap_avg_wc_files(fovs, channels, base_dir, cell_som_input_data,
                                cell_remapped_name, weighted_cell_channel_name,
                                cell_som_cluster_channel_avg_name,
                                cell_meta_cluster_channel_avg_name):
    """Refresh weighted channel average files after a GUI remap."""
    cell_remapped_path = os.path.join(base_dir, cell_remapped_name)
    weighted_channel_path = os.path.join(base_dir, weighted_cell_channel_name)
    som_avg_path = os.path.join(base_dir, cell_som_cluster_channel_avg_name)
    meta_avg_path = os.path.join(base_dir, cell_meta_cluster_channel_avg_name)
    io_utils.validate_paths([cell_remapped_path, weighted_channel_path,
                             som_avg_path, meta_avg_path])
    remapped = pd.read_csv(cell_remapped_path)
    verify_in_list(
        required_cols=["cell_som_cluster", "cell_meta_cluster",
                       "cell_meta_cluster_rename"],
        remapped_data_cols=remapped.columns.values)
    remap_dict = dict(remapped[["cell_som_cluster", "cell_meta_cluster"]].values)
    rename_dict = dict(remapped[
        ["cell_meta_cluster", "cell_meta_cluster_rename"]
    ].drop_duplicates().values)

    print("Re-compute average weighted channel expression across cell meta clusters")
    meta_avg = compute_cell_cluster_weighted_channel_avg(
        fovs, channels, base_dir, weighted_cell_channel_name,
        cell_som_input_data, "cell_meta_cluster")
    meta_avg["cell_meta_cluster_rename"] = \
        meta_avg["cell_meta_cluster"].map(rename_dict)
    meta_avg.to_csv(meta_avg_path, index=False)

    print("Re-assigning meta cluster column in cell SOM cluster average "
          "weighted channel data")
    som_avg = pd.read_csv(som_avg_path)
    som_avg["cell_meta_cluster"] = \
        som_avg["cell_som_cluster"].map(remap_dict)
    som_avg["cell_meta_cluster_rename"] = \
        som_avg["cell_meta_cluster"].map(rename_dict)
    som_avg.to_csv(som_avg_path, index=False)


def generate_weighted_channel_avg_heatmap(cell_cluster_channel_avg_path,
                                          cell_cluster_col, channels, raw_cmap,
                                          renamed_cmap, center_val=0,
                                          min_val=-3, max_val=3):
    """z-scored heatmap of average weighted channel expression per cell
    cluster ."""
    import matplotlib.patches as patches
    import matplotlib.pyplot as plt
    import scipy.stats as stats

    io_utils.validate_paths([cell_cluster_channel_avg_path])
    verify_in_list(provided_cluster_col=[cell_cluster_col],
                   valid_cluster_cols=["cell_som_cluster",
                                       "cell_meta_cluster_rename"])
    avgs = pd.read_csv(cell_cluster_channel_avg_path)
    verify_in_list(provided_channels=channels,
                   channel_avg_cols=avgs.columns.values)
    avgs = avgs.sort_values(by="cell_meta_cluster_rename")
    meta_cluster_index = avgs[cell_cluster_col].values
    meta_cluster_mapping = pd.Series(
        avgs["cell_meta_cluster_rename"]).map(renamed_cmap)
    meta_cluster_mapping.index = meta_cluster_index

    visualize.draw_heatmap(
        data=stats.zscore(avgs[channels].values),
        x_labels=avgs[cell_cluster_col], y_labels=channels,
        center_val=center_val, min_val=min_val, max_val=max_val,
        cbar_ticks=np.arange(-3, 4), row_colors=meta_cluster_mapping,
        row_cluster=False, left_start=0.0, right_start=0.85, w_spacing=0.2,
        colormap="vlag")
    handles = [patches.Patch(facecolor=raw_cmap[mc]) for mc in raw_cmap]
    plt.legend(handles, renamed_cmap, title="Meta cluster",
               bbox_to_anchor=(1, 1), bbox_transform=plt.gcf().transFigure,
               loc="upper right")
