"""Plotting helpers of the port: a port of ``ark_tpu/analysis/visualize.py``
(reference ``src/ark/analysis/visualize.py``: draw_boxplot :11, draw_heatmap
:72, get_sorted_data :156, plot_barchart :198,
visualize_patient_population_distribution :245,
visualize_neighbor_cluster_metrics :302, visualize_topic_eda :333,
visualize_fov_stats :406, visualize_fov_graphs :442). Host code: matplotlib
and seaborn are imported inside the functions, so this module imports
where they are absent."""

from __future__ import annotations

import numpy as np
import pandas as pd

from ark_tpu_torch.io.misc_utils import save_figure
from ark_tpu_torch.utils.misc_utils import verify_in_list


def draw_boxplot(cell_data, col_name, col_split=None, split_vals=None,
                 dpi=None, save_dir=None, save_file=None):
    """Boxplot of a column, optionally faceted by a split column."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    verify_in_list(col_name=col_name, column_names=cell_data.columns.values)
    if col_split is not None and col_split not in cell_data.columns.values:
        verify_in_list(col_split=col_split,
                       column_names=cell_data.columns.values)
    if split_vals is not None:
        if col_split is None:
            raise ValueError("If split_vals is set, then col_split must also "
                             "be set")
        verify_in_list(split_vals=split_vals,
                       column_split_values=cell_data[col_split].unique())
    data_to_viz = cell_data.copy(deep=True)
    if split_vals:
        data_to_viz = data_to_viz[data_to_viz[col_split].isin(split_vals)]
    if col_split:
        sns.boxplot(x=col_split, y=col_name, data=data_to_viz)
        plt.title(f"Distribution of {col_name}, faceted by {col_split}")
    else:
        sns.boxplot(y=col_name, data=data_to_viz, orient="v")
        plt.title(f"Distribution of {col_name}")
    if save_dir is not None:
        save_figure(save_dir, save_file, dpi=dpi)


def draw_heatmap(data, x_labels, y_labels, dpi=None, center_val=None,
                 min_val=None, max_val=None, cbar_ticks=None, colormap="vlag",
                 row_colors=None, row_cluster=True, col_colors=None,
                 col_cluster=True, left_start=None, right_start=None,
                 w_spacing=None, h_spacing=None, save_dir=None,
                 save_file=None):
    """Clustermap heatmap (z-scores etc.) with optional cluster color bars;
    NaN and inf cells are drawn as 0."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    data = np.array(data, dtype=float)
    data[np.isnan(data)] = 0
    data[np.isinf(data)] = 0
    data_df = pd.DataFrame(data, index=x_labels, columns=y_labels)
    sns.set(font_scale=.7)
    heatmap = sns.clustermap(
        data_df, cmap=colormap, center=center_val, vmin=min_val,
        vmax=max_val, row_colors=row_colors, row_cluster=row_cluster,
        col_colors=col_colors, col_cluster=col_cluster,
        cbar_kws={"ticks": cbar_ticks})
    if row_colors is not None:
        heatmap.ax_row_colors.xaxis.set_visible(False)
    if col_colors is not None:
        heatmap.ax_col_colors.yaxis.set_visible(False)
    heatmap.gs.update(left=left_start, right=right_start, wspace=w_spacing,
                      hspace=h_spacing)
    plt.setp(heatmap.ax_heatmap.get_yticklabels(), rotation=0)
    plt.tight_layout()
    if save_dir is not None:
        save_figure(save_dir, save_file, dpi=dpi)


def get_sorted_data(cell_data, sort_by_first, sort_by_second,
                    is_normalized=False):
    """Patient x population crosstab sorted by marginal counts."""
    stacked = pd.crosstab(cell_data[sort_by_first], cell_data[sort_by_second],
                          normalize="index" if is_normalized else False)
    index_order = cell_data.groupby(sort_by_first).count().sort_values(
        by=sort_by_second, ascending=False).index.values
    column_order = cell_data.groupby(sort_by_second).count().sort_values(
        by=sort_by_first, ascending=False).index.values
    return stacked.reindex(index_order, axis="index").reindex(
        column_order, axis="columns")


def plot_barchart(data, title, x_label, y_label, color_map="jet",
                  is_stacked=True, is_legend=True, legend_loc="center left",
                  bbox_to_anchor=(1.0, 0.5), dpi=None, save_dir=None,
                  save_file=None):
    """Bar chart helper for population-distribution plots."""
    import matplotlib.pyplot as plt

    data.plot.bar(colormap=color_map, stacked=is_stacked, legend=is_legend)
    plt.title(title)
    plt.xlabel(x_label)
    plt.ylabel(y_label)
    if is_legend:
        plt.legend(loc=legend_loc, bbox_to_anchor=bbox_to_anchor)
    if save_dir is not None:
        save_figure(save_dir, save_file, dpi=dpi)


def visualize_patient_population_distribution(cell_data, patient_col_name,
                                              population_col_name,
                                              color_map="jet",
                                              show_total_count=True,
                                              show_distribution=True,
                                              show_proportion=True, dpi=None,
                                              save_dir=None):
    """Population distributions: total counts, per-patient counts,
    per-patient proportions."""
    cell_data = cell_data.dropna()
    if show_total_count:
        population_values = cell_data[population_col_name].value_counts()
        plot_barchart(population_values,
                      "Distribution of Population in all patients",
                      "Population Type", "Population Count", is_legend=False,
                      dpi=dpi, save_dir=save_dir,
                      save_file="PopulationDistribution.png")
    if show_distribution:
        sorted_data = get_sorted_data(cell_data, patient_col_name,
                                      population_col_name)
        plot_barchart(sorted_data,
                      "Distribution of Population Count in Patients",
                      patient_col_name, population_col_name, dpi=dpi,
                      save_dir=save_dir,
                      save_file="TotalPopulationDistribution.png")
    if show_proportion:
        sorted_data = get_sorted_data(cell_data, patient_col_name,
                                      population_col_name, is_normalized=True)
        plot_barchart(sorted_data,
                      "Distribution of Population Count Proportion in Patients",
                      patient_col_name, population_col_name, dpi=dpi,
                      save_dir=save_dir,
                      save_file="PopulationProportion.png")


def visualize_neighbor_cluster_metrics(neighbor_cluster_stats, metric_name,
                                       dpi=None, save_dir=None):
    """Line plot of a k-means sweep metric vs number of clusters."""
    import matplotlib.pyplot as plt

    x_coords = neighbor_cluster_stats.coords["cluster_num"]
    scores = neighbor_cluster_stats.values
    plt.plot(x_coords, scores)
    plt.title(metric_name + " vs number of clusters")
    plt.xlabel("Number of clusters")
    plt.ylabel(metric_name)
    if save_dir is not None:
        save_figure(save_dir, "neighborhood_" + metric_name + "_scores.png",
                    dpi=dpi)


def visualize_topic_eda(data, metric="gap_stat", gap_sd=True, k=None,
                        transpose=False, scale=0.5, dpi=None, save_dir=None):
    """Exploratory plots for spatial-LDA topic-count selection."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    valid_metrics = ["gap_stat", "inertia", "silhouette", "cell_counts"]
    verify_in_list(actual=[metric], expected=valid_metrics)
    featurization = data["featurization"]
    data_k = {key: v for key, v in data.items()
              if key not in ("featurization", "cell_counts")}
    df = pd.DataFrame.from_dict(data_k)
    df["num_clusters"] = df.index

    if metric == "gap_stat":
        if gap_sd:
            plt.plot()
            plt.errorbar(x=df["num_clusters"], y=df["gap_stat"],
                         yerr=df["gap_sds"])
        else:
            sns.relplot(data=df, x="num_clusters", y="gap_stat", kind="line")
        plt.xlabel("Number of Clusters")
        plt.ylabel("Gap")
    elif metric == "inertia":
        sns.relplot(data=df, x="num_clusters", y="inertia", kind="line")
        plt.xlabel("Number of Clusters")
        plt.ylabel("Inertia")
    elif metric == "silhouette":
        sns.relplot(data=df, x="num_clusters", y="silhouette", kind="line")
        plt.xlabel("Number of Clusters")
        plt.ylabel("Silhouette Score")
    elif metric == "cell_counts":
        if k is None:
            raise ValueError("Must provide number of clusters for k value.")
        cell_counts = data["cell_counts"][k]
        cell_counts = cell_counts / cell_counts.sum(axis=0)
        if transpose:
            cell_counts = cell_counts.T
        plt.subplots(figsize=(scale * cell_counts.shape[1],
                              scale * cell_counts.shape[0]))
        sns.heatmap(cell_counts, vmin=0, square=True, xticklabels=True,
                    yticklabels=True, cmap="mako")
        plt.xlabel("KMeans Cluster Label")
        if featurization == "cluster":
            plt.ylabel("Cell Cluster")
        elif featurization in ("marker", "avg_marker"):
            plt.ylabel("Channel Marker")
        else:
            plt.ylabel("Cell Counts")
    if save_dir is not None:
        clust_label = f"_k_{k}" if metric == "cell_counts" else ""
        save_figure(save_dir, "topic_eda_" + metric + clust_label + ".png",
                    dpi=dpi)


def visualize_fov_stats(data, metric="cellular_density", dpi=None,
                        save_dir=None):
    """Histogram of per-FOV density/area/cell-count stats."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    df = pd.DataFrame.from_dict(data)
    df["fov"] = df.index
    labels = {"cellular_density": "FOV Cellular Density",
              "average_area": "FOV Average Cell Area",
              "total_cells": "FOV Total Cell Count"}
    col = metric if metric in labels else "total_cells"
    sns.histplot(data=df, x=col)
    plt.xlabel(labels.get(metric, labels["total_cells"]))
    plt.ylabel("Count")
    if save_dir is not None:
        save_figure(save_dir, "fov_metrics_" + metric + ".png", dpi=dpi)


def visualize_fov_graphs(cell_table, features, diff_mats, fovs, dpi=None,
                         save_dir=None):
    """Plot the adjacency graphs defining neighboring environments per FOV
    (edges from the spatial-LDA difference matrices). `cell_table` is the
    formatted per-FOV dict from `spLDA.processing.format_cell_table`, whose
    coordinate columns are named x/y (reference `visualize.py:442-467`)."""
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, len(fovs), figsize=(6 * len(fovs), 6),
                             squeeze=False)
    train_dm = diff_mats["train_diff_mat"]
    for ax, fov in zip(axes[0], fovs):
        fov_table = cell_table[fov]
        coords = fov_table[["x", "y"]].values
        ax.scatter(coords[:, 0], coords[:, 1], s=4, c="k")
        dm = train_dm.get(fov) if isinstance(train_dm, dict) else None
        if dm is not None:
            dm = np.asarray(dm)
            # each difference-matrix row encodes one edge: +1/-1 entries
            for row in range(dm.shape[0]):
                nz = np.nonzero(dm[row])[0]
                if len(nz) == 2 and max(nz) < len(coords):
                    a, b = nz
                    ax.plot([coords[a, 0], coords[b, 0]],
                            [coords[a, 1], coords[b, 1]],
                            c="tab:blue", lw=0.5)
        ax.set_title(f"FOV {fov}")
        ax.invert_yaxis()
    if save_dir is not None:
        fovs_str = "_".join([str(x) for x in fovs])
        save_figure(save_dir, "adjacency_graph_fovs_" + fovs_str + ".png",
                    dpi=dpi)
