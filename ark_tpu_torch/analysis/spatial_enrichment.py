"""Pairwise spatial enrichment with a batched permutation null.

Port of ``ark_tpu/analysis/spatial_enrichment.py``: the observed marker x
marker close-interaction matrix `P . D_bin . P^T` and its null over B
permutations of the cells, `P_b . D_bin . P_b^T`, on `device` (default
"cuda"), then the statistics on the host (numpy, as the JAX package):
muhat, sigmahat (population std), z, add-one permutation p-values and
Benjamini-Hochberg adjustment.

The null's permutations are exactly uniform: `torch.randperm` over the N
cells, B draws from a CPU ``torch.Generator`` seeded with `seed`. They are
drawn on the host and uploaded in one (B, N) tensor, so a seed gives the
same null on every device (``jax.random`` cannot be replayed; the tests
inject the JAX package's permutations through ``_enrichment``). The products
are of 0/1 matrices, so every count is an exact integer in f32, on any
device and in any summation order.
"""

from __future__ import annotations

import warnings
from typing import List, Optional

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch import settings
from ark_tpu_torch.analysis import spatial_analysis_utils
from ark_tpu_torch.ops.distances import close_pairs
from ark_tpu_torch.ops.som import _as_f32_tensor, _check_full_f32_matmul
from ark_tpu_torch.utils.misc_utils import verify_in_list

# device bytes of one chunk of the null: the gathered (b, M, N) f32 indicator
# and its (b * M, N) product with D_bin
NULL_CHUNK_BYTES = 1 << 30


def benjamini_hochberg(pvals: np.ndarray) -> np.ndarray:
    """BH-adjusted p-values (statsmodels.multipletests 'fdr_bh' equivalent)."""
    p = np.asarray(pvals, float).ravel()
    n = len(p)
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.minimum(ranked, 1.0)
    return out.reshape(np.asarray(pvals).shape)


def draw_permutations(n: int, bootstrap_num: int, seed: int) -> torch.Tensor:
    """(B, n) int64 permutations of the cells, each exactly uniform, from a
    CPU generator seeded with `seed`: the same draws for every device."""
    g = torch.Generator().manual_seed(int(seed))
    perms = torch.empty((bootstrap_num, n), dtype=torch.int64)
    for b in range(bootstrap_num):
        perms[b] = torch.randperm(n, generator=g)
    return perms


def _permutation_null(dist_bin: torch.Tensor, pos: torch.Tensor,
                      perms: torch.Tensor) -> torch.Tensor:
    """(B, M, M) null close-counts: each permutation reorders the cell axis
    of the (M, N) positive-label matrix (keeping each marker's count of
    positive cells); all B products at once, in chunks of B that keep the
    gathered (b, M, N) indicator and its product within NULL_CHUNK_BYTES."""
    m, n = pos.shape
    b_total = perms.shape[0]
    chunk = max(1, NULL_CHUNK_BYTES // max(2 * 4 * m * n, 1))
    out = torch.empty((b_total, m, m), dtype=torch.float32, device=pos.device)
    for start in range(0, b_total, chunk):
        p = pos[:, perms[start:start + chunk]].transpose(0, 1)       # (b, M, N)
        b = p.shape[0]
        t = (p.reshape(b * m, n) @ dist_bin).reshape(b, m, n)
        out[start:start + b] = torch.bmm(t, p.transpose(1, 2))
    return out


def _enrichment(dist_mat, pos_matrix: np.ndarray, dist_lim: float,
                perms: torch.Tensor, device) -> dict:
    """calculate_enrichment given the (B, N) permutations of the null."""
    vals = dist_mat.values if hasattr(dist_mat, "values") else np.asarray(dist_mat)
    _check_full_f32_matmul()
    dist_bin = close_pairs(_as_f32_tensor(vals, device), dist_lim)
    pos = _as_f32_tensor(pos_matrix, device)
    close_num = (pos @ dist_bin @ pos.T).cpu().numpy()
    null = _permutation_null(dist_bin, pos, perms.to(device)).cpu().numpy()
    bootstrap_num = null.shape[0]

    muhat = null.mean(axis=0)
    sigmahat = null.std(axis=0)
    with np.errstate(divide="ignore", invalid="ignore"):
        z = np.where(sigmahat > 0, (close_num - muhat) / sigmahat, 0.0)
    # permutation p-values with add-one smoothing
    p_pos = (np.sum(null >= close_num[None], axis=0) + 1) / (bootstrap_num + 1)
    p_neg = (np.sum(null <= close_num[None], axis=0) + 1) / (bootstrap_num + 1)
    p_two = np.minimum(np.minimum(p_pos, p_neg) * 2, 1.0)
    return {
        # int64: a dense FOV passes 65535 close pairs on the diagonal
        "close_num": np.round(close_num).astype(np.int64),
        "close_num_rand": null,
        "muhat": muhat, "sigmahat": sigmahat, "z": z,
        "p_pos": p_pos, "p_neg": p_neg,
        "p_adj": benjamini_hochberg(p_two),
    }


def calculate_enrichment(dist_mat, pos_matrix: np.ndarray, dist_lim: float,
                         bootstrap_num: int = 100, seed: int = 42, *, device="cuda"):
    """Core enrichment computation for one FOV, on `device`.

    Args:
        dist_mat: (N, N) distances (DataArray or ndarray).
        pos_matrix: (M, N) 0/1 indicator of marker/phenotype positivity.
        dist_lim: proximity threshold in pixels.
        bootstrap_num: number of label permutations for the null.
        seed: seed of the permutations' generator.

    Returns:
        dict with close_num (M, M), close_num_rand (B, M, M), z, muhat,
        sigmahat, p_pos, p_neg, p_adj.
    """
    perms = draw_permutations(np.shape(pos_matrix)[1], bootstrap_num, seed)
    return _enrichment(dist_mat, pos_matrix, dist_lim, perms, device)


def _build_pos_matrix(labels_list, dist_mat) -> np.ndarray:
    row_labels = np.asarray(dist_mat.coords["dim_0"])
    label_to_idx = {lab: i for i, lab in enumerate(row_labels)}
    pos = np.zeros((len(labels_list), len(row_labels)), np.float32)
    for j, labs in enumerate(labels_list):
        pos[j, [label_to_idx[v] for v in np.asarray(labs)]] = 1.0
    return pos


def calculate_cluster_spatial_enrichment(fov, all_data, dist_mat,
                                         included_cell_types: Optional[List] = None,
                                         dist_lim: float = 100,
                                         bootstrap_num: int = 100, seed: int = 42,
                                         fov_col=settings.FOV_ID,
                                         cell_label_col=settings.CELL_LABEL,
                                         cell_type_col=settings.CELL_TYPE, *,
                                         device="cuda"):
    """Phenotype x phenotype spatial enrichment for one FOV.

    Returns (cluster_names, result dict from `calculate_enrichment`)."""
    fov_data = all_data[all_data[fov_col] == fov]
    cluster_names = included_cell_types if included_cell_types is not None \
        else sorted(fov_data[cell_type_col].unique())
    present = set(fov_data[cell_type_col].unique())
    absent = [c for c in cluster_names if c not in present]
    if absent:
        # a cohort-wide phenotype list works on FOVs that miss some types
        # (comparable row order across FOVs is why the list is passed)
        warnings.warn(f"FOV {fov} has no cells of type(s) {absent}; their "
                      f"enrichment rows will be zero")
    labels_list = [
        spatial_analysis_utils.get_pos_cell_labels_cluster(
            pheno, fov_data, cell_label_col, cell_type_col).values
        for pheno in cluster_names]
    pos = _build_pos_matrix(labels_list, dist_mat)
    res = calculate_enrichment(dist_mat, pos, dist_lim, bootstrap_num=bootstrap_num,
                               seed=seed, device=device)
    return cluster_names, res


def calculate_channel_spatial_enrichment(fov, all_data, dist_mat, marker_titles,
                                         thresh_vec, dist_lim: float = 100,
                                         bootstrap_num: int = 100, seed: int = 42,
                                         fov_col=settings.FOV_ID,
                                         cell_label_col=settings.CELL_LABEL, *,
                                         device="cuda"):
    """Marker x marker (threshold-positive) spatial enrichment for one FOV."""
    fov_data = all_data[all_data[fov_col] == fov]
    verify_in_list(marker_titles=list(marker_titles),
                   cell_table_columns=list(fov_data.columns))
    cell_labels = fov_data[cell_label_col]
    labels_list = [
        spatial_analysis_utils.get_pos_cell_labels_channel(
            thresh, fov_data[marker_titles], cell_labels, marker).values
        for marker, thresh in zip(marker_titles, thresh_vec)]
    pos = _build_pos_matrix(labels_list, dist_mat)
    res = calculate_enrichment(dist_mat, pos, dist_lim, bootstrap_num=bootstrap_num,
                               seed=seed, device=device)
    return list(marker_titles), res


def generate_enrichment_stats_table(names, result) -> pd.DataFrame:
    """Flatten an enrichment result into a tidy (pair, z, p) table."""
    rows = []
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            rows.append({"pheno1": a, "pheno2": b,
                         "close_num": int(result["close_num"][i, j]),
                         "z": float(result["z"][i, j]),
                         "muhat": float(result["muhat"][i, j]),
                         "sigmahat": float(result["sigmahat"][i, j]),
                         "p_pos": float(result["p_pos"][i, j]),
                         "p_neg": float(result["p_neg"][i, j]),
                         "p_adj": float(result["p_adj"][i, j])})
    return pd.DataFrame(rows)
