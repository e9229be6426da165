"""Template 3, Pixie cell clustering, as one call on an explicit torch device.

``run_cell_clustering`` calls the port's template-3 functions in
``templates/3_pixie_cluster_cells.py``'s order: the cells' pixel-cluster
counts from template 2's per-pixel feathers and template 1's cell table
(``create_c2pc_data``), the cell SOM's training and assignment, the SOM
count averages, the consensus meta clusters and their averages, the
weighted channel product and its averages. It saves the counts and the
labelled per-cell table as template 3's notebook does, and holds no
arithmetic of its own. A job is one ``cells.run`` span; each step's span
sits in the function that does the step, so a notebook's calls record the
same tree without this runner.

Files under `base_dir`:
  in:  pixel_mat_data/<fov>.feather (template 2's pixel feathers with the
       ``pixel_cluster_col`` labels), pixel_channel_avg_meta_cluster.csv
       (or pixel_channel_avg_som_cluster.csv for SOM labels);
  out: cluster_counts.feather (each cell's pixel counts), cell_som_weights.
       feather, cell_som_cluster_count_avg.csv, cell_meta_cluster_count_avg.
       csv, weighted_cell_channel.feather, cell_som_cluster_channel_avg.csv,
       cell_meta_cluster_channel_avg.csv and cluster_counts_size_norm.feather
       (the cells the SOM saw, normalized, with ``cell_som_cluster`` and
       ``cell_meta_cluster``).
"""

from __future__ import annotations

import os

import pandas as pd

from ark_tpu_torch.io import feather_utils as feather
from ark_tpu_torch.phenotyping import (cell_cluster_utils, cell_meta_clustering,
                                       cell_som_clustering, weighted_channel_comp)
from ark_tpu_torch.utils import profiling

SOM_COUNT_AVG = "cell_som_cluster_count_avg.csv"
META_COUNT_AVG = "cell_meta_cluster_count_avg.csv"
COUNTS = "cluster_counts.feather"
CELL_DATA = "cluster_counts_size_norm.feather"
WEIGHTED = "weighted_cell_channel.feather"


def run_cell_clustering(base_dir, channels, cell_table_path, fovs,
                        pixel_cluster_col="pixel_meta_cluster_rename", xdim=10, ydim=10,
                        num_passes=1, lr_start=0.05, lr_end=0.01, max_k=20, cap=3,
                        seed=42, *, device) -> pd.DataFrame:
    """Template 3 over `fovs` on `device`; returns the per-cell table with
    its ``cell_som_cluster`` and ``cell_meta_cluster`` (the file
    ``cluster_counts_size_norm.feather``). The SOM and the weighted product
    need full float32 matmuls (``torch.set_float32_matmul_precision
    ('highest')``, torch's default) and refuse TF32."""
    with profiling.span("cells.run", fovs=len(fovs)) as run:
        counts, counts_norm = cell_cluster_utils.create_c2pc_data(
            fovs, os.path.join(base_dir, "pixel_mat_data"), cell_table_path,
            pixel_cluster_col=pixel_cluster_col)
        count_cols = [c for c in counts_norm.columns if c.startswith(pixel_cluster_col)]
        if run.recorded:
            run.attrs.update(cells=len(counts_norm), columns=len(count_cols))
        feather.write_dataframe(counts, os.path.join(base_dir, COUNTS))

        cell_pysom = cell_som_clustering.train_cell_som(
            fovs, base_dir, cell_table_path, count_cols, counts_norm.copy(), xdim=xdim,
            ydim=ydim, lr_start=lr_start, lr_end=lr_end, num_passes=num_passes, seed=seed,
            device=device)
        cell_data = cell_som_clustering.cluster_cells(base_dir, cell_pysom, count_cols)
        cell_som_clustering.generate_som_avg_files(base_dir, cell_data, count_cols,
                                                   SOM_COUNT_AVG)

        cell_cc, cell_data = cell_meta_clustering.cell_consensus_cluster(
            base_dir, count_cols, cell_data, SOM_COUNT_AVG, max_k=max_k, cap=cap,
            seed=seed)
        cell_meta_clustering.generate_meta_avg_files(base_dir, cell_cc, count_cols,
                                                     cell_data, SOM_COUNT_AVG,
                                                     META_COUNT_AVG)

        # the pixel averages keyed by the resolution the counts were taken at
        avg_name = ("pixel_channel_avg_som_cluster.csv"
                    if pixel_cluster_col == "pixel_som_cluster"
                    else "pixel_channel_avg_meta_cluster.csv")
        pixel_channel_avg = pd.read_csv(os.path.join(base_dir, avg_name))
        weighted = weighted_channel_comp.compute_p2c_weighted_channel_avg(
            pixel_channel_avg, channels, counts, fovs=fovs,
            pixel_cluster_col=pixel_cluster_col, device=device)
        feather.write_dataframe(weighted, os.path.join(base_dir, WEIGHTED))
        weighted_channel_comp.generate_wc_avg_files(fovs, channels, base_dir, cell_cc,
                                                    cell_data)
        feather.write_dataframe(cell_data, os.path.join(base_dir, CELL_DATA))
    return cell_data
