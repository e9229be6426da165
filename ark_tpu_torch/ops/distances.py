"""Pairwise distances, neighbor counts and the silhouette score in torch ops.

Port of ``ark_tpu/ops/distances.py`` (reference: per-FOV `scipy.cdist`,
`spatial_analysis_utils.py:55`). ``shape_bucket`` is not ported: it only
kept XLA from compiling a program per cell count, and torch runs eagerly.

Numerics, as the JAX package's jitted functions round on the CPU:

- D <= 4 (centroids) computes |a-b|^2 directly, one (N, M) term per axis,
  never as |a|^2 - 2ab + |b|^2: that decomposition cancels in f32 (two cells
  1.5 px apart at the far corner of a 5000-px stage get d = 0 and drop out
  of every `dist > 0` mask). XLA's CPU backend contracts the sum into fused
  multiply-adds, s = fma(d0, d0, d1*d1), then s = fma(dk, dk, s); the port
  rounds the same way through an exact f64 product (as ``ops/quantiles``).
  ``torch.cdist`` is not used: it switches to the decomposition on large
  inputs.
- D > 4 (feature space) keeps the decomposition, floored at 0, in full f32
  (TF32 refused). Its sums of D products run in another order than XLA's,
  so squared distances agree within a few ulps of |a|^2 + |b|^2.
- The square root is correctly rounded, as XLA's is; torch's own f32 sqrt
  on the CPU is not always, nor the same from run to run, so the port
  refines it in f64 and settles the last bit by an exact test (``_sqrt``).
- Self-distances are forced to exact 0 by index, never with `eye * inf`.

Every function takes tensors on one device, or numpy arrays and a `device`
(default "cuda"); no function picks a device on its own. The thresholded
products are of 0/1 matrices, so their f32 sums are exact integers in any
order: counts are bitwise equal on every device.
"""

from __future__ import annotations

import numpy as np
import torch

from ark_tpu_torch.ops.som import _as_f32_tensor as _as_f32
from ark_tpu_torch.ops.som import _check_full_f32_matmul


def _diff(a: torch.Tensor, b: torch.Tensor, k: int) -> torch.Tensor:
    return a[:, k, None] - b[None, :, k]


def _fma_square(x: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """f32 fma(x, x, z): the f64 square of an f32 value is exact, and the f64
    sum rounded to f32 is the fused result (double rounding aside, which the
    parity tests have not met)."""
    p = x.to(torch.float64)
    return p.mul_(p).add_(z).to(torch.float32)


def _sqrt(d2: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, on every device and in every run.

    torch's f32 sqrt on the CPU is not always correctly rounded, and the
    first call of a process is at times off by up to 3e-4
    (scripts/port_spatial_numerics.py). So its result only starts two
    Newton steps in f64 (+, x, / are correctly rounded), which bring an
    estimate within 1e-2 to within 1e-8, and the f32 rounding r of that is
    moved to the neighbouring f32 where d2 lies beyond the midpoint between
    them. That test is exact in f64: the midpoint of two adjacent f32 values
    has at most 26 significant bits, its square 52."""
    x = d2.to(torch.float64)
    y = torch.sqrt(d2).to(torch.float64)
    finite = (y > 0) & (y < float("inf"))
    for _ in range(2):
        y = torch.where(finite, (x / y).add_(y).mul_(0.5), y)
    r = y.to(torch.float32)
    del x, y, finite
    for toward, beyond in ((float("inf"), torch.gt), (0.0, torch.lt)):
        step = torch.nextafter(r, torch.tensor(toward, device=r.device))
        mid = r.to(torch.float64).add_(step).mul_(0.5)
        r = torch.where(beyond(d2, mid.mul_(mid)), step, r)
    return r


def _force_zero_diagonal(d: torch.Tensor, col_offset: int = 0) -> torch.Tensor:
    """d[i, i + col_offset] = 0 in place, by index, where that is in d."""
    first = max(0, -col_offset)
    last = min(d.shape[0], d.shape[1] - col_offset)
    if last > first:
        i = torch.arange(first, last, device=d.device)
        d[i, i + col_offset] = 0.0
    return d


def squared_distances(a: torch.Tensor, b: torch.Tensor,
                      zero_diagonal: bool = False) -> torch.Tensor:
    """(N, M) squared euclidean distances between rows of `a` and `b`, on
    their device; see the module docstring for the D <= 4 rule and the
    rounding. `zero_diagonal=True` forces d2[i, i] to exact 0."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    d = a.shape[1]
    if d == 1:
        d2 = _diff(a, b, 0).square_()
    elif d <= 4:
        # s = fma(d0, d0, d1*d1), then s = fma(dk, dk, s): XLA's contraction
        d2 = _fma_square(_diff(a, b, 0), _diff(a, b, 1).square_())
        for k in range(2, d):
            d2 = _fma_square(_diff(a, b, k), d2)
    else:
        _check_full_f32_matmul()
        a2 = torch.sum(a * a, dim=1)[:, None]
        b2 = torch.sum(b * b, dim=1)[None, :]
        # (a2 + b2) - 2ab, the JAX package's order; 2ab is exact
        d2 = (a2 + b2).add_((a @ b.T).mul_(-2.0)).clamp_min_(0.0)
    if zero_diagonal:
        _force_zero_diagonal(d2)
    return d2


def pairwise_distances(a: torch.Tensor, b: torch.Tensor,
                       zero_diagonal: bool = False) -> torch.Tensor:
    """Euclidean distances between rows of a (N, D) and b (M, D); (N, M)."""
    return _sqrt(squared_distances(a, b, zero_diagonal=zero_diagonal))


def cdist(a, b=None, block_rows: int = 8192, *, device="cuda") -> np.ndarray:
    """scipy.spatial.distance.cdist on `device`; returns numpy. Rows go in
    blocks of `block_rows`, so the (N, M) host output is the only full-size
    buffer; with `b` None the self-distances are exact zeros."""
    a = np.asarray(a, np.float32)
    self_dist = b is None
    b_dev = _as_f32(a if self_dist else b, device)
    n = a.shape[0]
    out = np.empty((n, b_dev.shape[0]), np.float32)
    for i in range(0, n, block_rows):
        d = pairwise_distances(_as_f32(a[i:i + block_rows], device), b_dev)
        if self_dist:
            _force_zero_diagonal(d, col_offset=i)
        out[i:i + block_rows] = d.cpu().numpy()
    return out


def knn_mean_distance(dist_cols: torch.Tensor, k: int) -> torch.Tensor:
    """Mean of the k smallest positive entries of each row of (N, M)
    distances; inf for a row with fewer than k positive entries."""
    masked = torch.where(dist_cols > 0, dist_cols,
                         torch.tensor(float("inf"), device=dist_cols.device))
    smallest = torch.topk(masked, k, dim=1, largest=False).values
    return torch.mean(smallest, dim=1)


def close_pairs(dist: torch.Tensor, dist_lim) -> torch.Tensor:
    """The 0/1 f32 matrix of pairs at 0 < d < dist_lim (d == 0 is the cell
    itself, or a coincident cell, as in the reference)."""
    return ((dist < dist_lim) & (dist > 0)).to(torch.float32)


# the exact-rounding passes keep up to ~10 f32-sized (rows, columns)
# temporaries alive; a row block goes over the cells in this many column
# chunks, so that they stay within one (block_rows, N) f32 buffer
COLUMN_CHUNKS = 16


def _neighbor_count_block(block: torch.Tensor, all_coords: torch.Tensor,
                          onehot: torch.Tensor, dist_lim: float,
                          row_offset: int) -> torch.Tensor:
    """(B, P) neighbor-phenotype counts of one row block: distances from
    `block` to every cell, the cell itself excluded by index, thresholded
    (0 < d < dist_lim), times the one-hot phenotype matrix; over the cells
    in COLUMN_CHUNKS chunks (sums of exact integers, so in any grouping)."""
    n = all_coords.shape[0]
    step = max(1, -(-n // COLUMN_CHUNKS))
    counts = torch.zeros((block.shape[0], onehot.shape[1]), device=block.device)
    for c in range(0, n, step):
        d = _force_zero_diagonal(pairwise_distances(block, all_coords[c:c + step]),
                                 row_offset - c)
        counts += close_pairs(d, dist_lim) @ onehot[c:c + step]
    return counts


def blocked_neighbor_counts(coords, onehot, dist_lim: float,
                            block_rows: int = 4096, *, device="cuda") -> np.ndarray:
    """Per-cell neighbor-phenotype counts without the (N, N) distance matrix:
    peak device memory is one (block_rows, N) block and its temporaries.

    Args: coords (N, D) centroids; onehot (N, P) phenotype matrix; dist_lim
    the neighborhood radius. Returns (N, P) float32 counts."""
    _check_full_f32_matmul()
    all_dev = _as_f32(coords, device)
    onehot_dev = _as_f32(onehot, device)
    n = all_dev.shape[0]
    out = np.empty((n, onehot_dev.shape[1]), np.float32)
    for i in range(0, n, block_rows):
        blk = all_dev[i:i + block_rows]
        out[i:i + blk.shape[0]] = _neighbor_count_block(
            blk, all_dev, onehot_dev, dist_lim, i).cpu().numpy()
    return out


def _silhouette_block(block: torch.Tensor, row_labels: torch.Tensor,
                      data: torch.Tensor, onehot: torch.Tensor,
                      counts: torch.Tensor, row_offset: int) -> torch.Tensor:
    """Per-point silhouette values of one row block: distance sums to every
    cluster by one (B, N) x (N, K) product, then (b - a) / max(a, b)."""
    # a mean of N distances, held to 1e-5: torch's own sqrt is close enough
    d = _force_zero_diagonal(squared_distances(block, data).sqrt_(), row_offset)
    sums = d @ onehot                                             # (B, K)
    own_count = counts[row_labels]
    own_sum = torch.gather(sums, 1, row_labels[:, None])[:, 0]
    a = own_sum / torch.clamp_min(own_count - 1.0, 1.0)
    own = torch.nn.functional.one_hot(row_labels, onehot.shape[1]).to(torch.bool)
    inf = torch.tensor(float("inf"), device=d.device)
    mean_other = sums / torch.clamp_min(counts[None, :], 1.0)
    # an empty cluster never wins the min
    mean_other = torch.where(counts[None, :] > 0, mean_other, inf)
    b = torch.min(torch.where(own, inf, mean_other), dim=1).values
    s = (b - a) / torch.clamp_min(torch.maximum(a, b), 1e-30)
    # sklearn's convention: a singleton cluster scores 0
    return torch.where(own_count > 1.0, s, torch.zeros_like(s))


def silhouette_score(data, labels, block_rows: int = 4096, *, device="cuda") -> float:
    """Mean euclidean silhouette coefficient on `device`, in row blocks: the
    equivalent of `sklearn.metrics.silhouette_score(X, labels)` without the
    (N, N) distance matrix."""
    _check_full_f32_matmul()
    data = np.asarray(data, np.float32)
    uniq, inv = np.unique(np.asarray(labels), return_inverse=True)
    n = data.shape[0]
    if not 2 <= len(uniq) <= n - 1:
        raise ValueError(
            f"Number of labels is {len(uniq)}. Valid values are 2 "
            f"to n_samples - 1 (inclusive)")
    k = len(uniq)
    onehot = torch.as_tensor(np.eye(k, dtype=np.float32)[inv], device=device)
    counts = torch.as_tensor(np.bincount(inv, minlength=k).astype(np.float32),
                             device=device)
    data_dev = _as_f32(data, device)
    labels_dev = torch.as_tensor(inv.astype(np.int64), device=device)
    total = 0.0
    for i in range(0, n, block_rows):
        s = _silhouette_block(data_dev[i:i + block_rows], labels_dev[i:i + block_rows],
                              data_dev, onehot, counts, i)
        total += float(torch.sum(s))
    return total / n
