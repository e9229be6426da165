"""Dimensionality-reduction visualization: UMAP, PCA and t-SNE scatters.

Port of ``ark_tpu/analysis/dimensionality_reduction.py``. The embeddings run
on `device` (``ops/umap``, ``ops/tsne``). matplotlib and seaborn are
imported inside the plot function, and the UMAP branch standardises the
columns itself (mean 0, population standard deviation 1, what sklearn's
``StandardScaler`` does), so the module needs neither where they are
absent."""

from __future__ import annotations

import numpy as np

from ark_tpu_torch.io.misc_utils import save_figure
from ark_tpu_torch.ops import umap as umap_ops
from ark_tpu_torch.utils.misc_utils import verify_in_list


def standardize_columns(values) -> np.ndarray:
    """Each column minus its mean, over its population standard deviation,
    in f64, as sklearn's StandardScaler; a column that is constant up to
    rounding (sklearn's rule: var <= n eps var + (n mean eps)^2) is only
    centred."""
    x = np.asarray(values, dtype=np.float64)
    n = x.shape[0]
    mean, var = x.mean(axis=0), x.var(axis=0)
    eps = np.finfo(np.float64).eps
    scale = np.sqrt(var)
    scale[var <= n * eps * var + (n * mean * eps) ** 2] = 1.0
    return (x - mean) / scale


def plot_dim_reduced_data(component_one, component_two, fig_id, hue,
                          cell_data, title, title_fontsize=24,
                          palette="Spectral", alpha=0.3, legend_type="full",
                          bbox_to_anchor=(1.05, 1), legend_loc=2,
                          legend_borderaxespad=0., dpi=None, save_dir=None,
                          save_file=None):
    """Scatter a 2-D embedding colored by a category."""
    import matplotlib.pyplot as plt
    import seaborn as sns

    plt.figure(fig_id)
    sns.scatterplot(x=component_one, y=component_two, hue=hue,
                    palette=palette, data=cell_data, legend=legend_type,
                    alpha=alpha)
    plt.legend(bbox_to_anchor=bbox_to_anchor, loc=legend_loc,
               borderaxespad=legend_borderaxespad)
    plt.title(title, fontsize=title_fontsize)
    if save_dir is not None:
        save_figure(save_dir, save_file, dpi=dpi)


def reduce_dimensions(column_data, algorithm="UMAP", *, device="cuda",
                      timings=None) -> np.ndarray:
    """The (N, 2) embedding that ``visualize_dimensionality_reduction``
    plots, from the (N, C) column values: UMAP of the standardised columns
    (`timings`, if a dict, collects its seconds per step), the PCA
    projection, or exact t-SNE, on `device`."""
    verify_in_list(algorithm=algorithm,
                   dimensionality_reduction_algorithms=["UMAP", "PCA", "tSNE"])
    if algorithm == "UMAP":
        return umap_ops.UMAP(device=device, timings=timings).fit_transform(
            standardize_columns(column_data))
    if algorithm == "PCA":
        return umap_ops.pca_transform(column_data, device=device)
    from ark_tpu_torch.ops.tsne import TSNE
    return TSNE(device=device).fit_transform(column_data)


def visualize_dimensionality_reduction(cell_data, columns, category,
                                       color_map="Spectral",
                                       algorithm="UMAP", dpi=None,
                                       save_dir=None, *, device="cuda"):
    """UMAP / PCA / tSNE projection scatter of the specified columns."""
    cell_data = cell_data.dropna()
    embedding = reduce_dimensions(cell_data[columns].values, algorithm, device=device)
    fig_id = {"UMAP": 1, "PCA": 2, "tSNE": 3}[algorithm]
    plot_dim_reduced_data(embedding[:, 0], embedding[:, 1], fig_id=fig_id,
                          hue=cell_data[category], cell_data=cell_data,
                          title="%s projection of data" % algorithm, dpi=dpi,
                          save_dir=save_dir,
                          save_file="%sVisualization.png" % algorithm,
                          palette=color_map)
