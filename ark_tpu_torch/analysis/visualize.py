"""Plotting helpers of the port: ``draw_heatmap`` of
``ark_tpu/analysis/visualize.py``, which the cell-clustering heatmap calls.
matplotlib and seaborn are imported inside it, so this module imports
where they are absent."""

from __future__ import annotations

import numpy as np

from ark_tpu_torch.io.misc_utils import save_figure


def draw_heatmap(data, x_labels, y_labels, dpi=None, center_val=None,
                 min_val=None, max_val=None, cbar_ticks=None, colormap="vlag",
                 row_colors=None, row_cluster=True, col_colors=None,
                 col_cluster=True, left_start=None, right_start=None,
                 w_spacing=None, h_spacing=None, save_dir=None,
                 save_file=None):
    """Clustermap heatmap (z-scores etc.) with optional cluster color bars;
    NaN and inf cells are drawn as 0."""
    import matplotlib.pyplot as plt
    import pandas as pd
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
