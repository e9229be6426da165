"""FOV-sharded cohort execution over a torch.distributed process group.

Port of ``ark_tpu/parallel/cohort.py``. The JAX package stacks a cohort's
FOVs into one (B, ...) block, shards its leading axis over the 'fov' mesh
and runs one jitted vmapped program. Here each rank runs the per-FOV torch
function on its own block of FOVs (``mesh.local_rows``: B padded with zero
FOVs to a multiple of the world size, contiguous blocks in rank order),
the per-FOV results are stacked, all-gathered in rank order and the padding
is dropped, so every rank returns the whole cohort's results as numpy
arrays. The per-FOV work is the port's single-card code, so each FOV's
result is bitwise the single-card result on the same device. torch runs
eagerly: nothing is compiled or cached per function.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from ark_tpu_torch.ops import quantiles, som as som_ops
from ark_tpu_torch.parallel import mesh
from ark_tpu_torch.phenotyping import pixie_fused


def _stack(outs):
    first = outs[0]
    if isinstance(first, dict):
        return {k: _stack([o[k] for o in outs]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack([o[i] for o in outs]) for i in range(len(first)))
    return torch.stack(outs)


def _gather(tree, n: int, group):
    """Every rank's stacked rows in rank order as numpy, the padding dropped."""
    if isinstance(tree, dict):
        return {k: _gather(v, n, group) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_gather(v, n, group) for v in tree)
    return mesh.all_gather_rows(tree, group).cpu().numpy()[:n]


def map_over_fovs(fn: Callable, fov_batch, *, device, group=None):
    """Apply the per-FOV torch function `fn` over a (B, ...) batch split
    across the ranks; B is padded with zero FOVs to a multiple of the world
    size (padding dropped). `fov_batch` is an array, or a tuple of arrays
    sharing their leading axis, whose FOVs `fn` takes as positional
    tensors on `device`. `fn` returns a tensor, or a dict or tuple of
    tensors of one shape per FOV; the result is the same structure of
    (B, ...) numpy arrays, on every rank."""
    arrays = fov_batch if isinstance(fov_batch, (tuple, list)) else (fov_batch,)
    arrays = [np.asarray(a) for a in arrays]
    n = arrays[0].shape[0]
    if n == 0 or any(a.shape[0] != n for a in arrays):
        raise ValueError(f"map_over_fovs: leading axes {[a.shape[0] for a in arrays]}; "
                         f"one nonzero FOV count expected")
    g = mesh.resolve_group(group)
    local = [mesh.local_rows(a, g) for a in arrays]
    outs = [fn(*(torch.as_tensor(np.ascontiguousarray(a[i]), device=device)
                 for a in local)) for i in range(local[0].shape[0])]
    return _gather(_stack(outs), n, g)


def _pixel_per_fov(img, channel_norms, pixel_thresh, post_norms, som_weights,
                   blur_factor):
    """The JAX package's ``_pixel_per_fov`` through the port's pixel stage:
    channel norms, then ``pixie_fused``'s blur, row sums, valid mask and
    row normalization, then the post norms and the BMU (the kernel on a
    CUDA tensor)."""
    x = img.to(torch.float32) / channel_norms
    norm, rowsums, anynz = pixie_fused._prep_fov_parts(x, blur_factor)
    valid = pixie_fused._valid_mask_device(rowsums, anynz, pixel_thresh)
    norm = (norm / post_norms).contiguous()
    idx, _ = som_ops.bmu(som_weights, norm, return_dist=False)
    clusters = torch.where(valid, idx + 1, 0).to(torch.int32)
    return {"pixel_mat": norm, "valid": valid, "som_clusters": clusters}


def run_pixel_cohort(fov_batches, channel_norms, pixel_thresh, post_norms,
                     som_weights, blur_factor: int = 2, *, device,
                     group=None) -> Dict[str, np.ndarray]:
    """Run the pixel pipeline (preprocess + SOM assignment) over a cohort
    batch, FOV-sharded across the ranks, on `device`.

    Args:
        fov_batches: (B, H, W, C) image block.
        channel_norms: (C,) pre-rownorm channel percentile norms.
        pixel_thresh: scalar total-signal threshold.
        post_norms: (C,) post-rownorm 99.9% channel norms.
        som_weights: (K, C) trained SOM weights.

    Returns dict with 'pixel_mat' (B, H*W, C), 'valid' (B, H*W) bool,
    'som_clusters' (B, H*W) int32 (0 = filtered out)."""
    norms = som_ops._as_f32_tensor(channel_norms, device)
    post = som_ops._as_f32_tensor(post_norms, device)
    weights = som_ops._as_f32_tensor(som_weights, device)

    def one(img):
        return _pixel_per_fov(img, norms, pixel_thresh, post, weights, blur_factor)

    return map_over_fovs(one, fov_batches, device=device, group=group)


def run_fiber_cohort(fov_batches, fov_len=None, blur=2, contrast_scaling_divisor=128,
                     fiber_widths=(1, 3, 5, 7, 9), ridge_cutoff=0.1, sobel_blur=1, *,
                     device, group=None) -> Dict[str, np.ndarray]:
    """Run the fiber device program (blur -> CLAHE -> Frangi -> EDT -> Sobel
    elevation; ``fiber_segmentation._fiber_device_program``) over a
    (B, H, W) FOV batch split across the ranks, on `device`. Returns the
    host tail's inputs: 'distance_transformed', 'elevation_map' (B, H, W)
    and 'has_bg' (B,)."""
    from ark_tpu_torch.ops import classical
    from ark_tpu_torch.segmentation.fiber_segmentation import _fiber_device_program

    fov_batches = np.asarray(fov_batches, np.float32)
    _, h, w = fov_batches.shape
    # segment_fibers derives fov_len from the row count
    fov_len = h if fov_len is None else fov_len
    th, tw, n_tr, n_tc = classical._clahe_geometry(h, w, fov_len / contrast_scaling_divisor)

    def one(img):
        out = _fiber_device_program(img, ridge_cutoff, blur=blur, th=th, tw=tw,
                                    n_tr=n_tr, n_tc=n_tc, fiber_widths=tuple(fiber_widths),
                                    sobel_blur=sobel_blur)
        return {k: out[k] for k in ("distance_transformed", "elevation_map", "has_bg")}

    return map_over_fovs(one, fov_batches, device=device, group=group)


def _percentile_per_fov(img, q):
    flat = img.reshape(-1, img.shape[-1]).to(torch.float32)
    return quantiles.nanquantile(torch.where(flat > 0, flat, float("nan")), q)


def cohort_channel_percentiles(fov_batches, q: float, *, device,
                               group=None) -> np.ndarray:
    """Mean over FOVs of per-FOV nonzero channel percentiles, FOV-sharded
    (the cohort normalization statistic of ``pixel_cluster_utils``)."""
    per_fov = map_over_fovs(lambda img: _percentile_per_fov(img, q), fov_batches,
                            device=device, group=group)
    return np.nanmean(per_fov, axis=0)
