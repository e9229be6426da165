"""UMAP embedding in torch ops.

Port of ``ark_tpu/ops/umap.py`` (which replaces umap-learn), the same
recipe, each stage on the data's device:
  1. exact blocked k-NN: |r|^2 - 2 r.c + |c|^2 by a full-f32 matmul per
     block with a running top-k, O(block area + N k) memory;
  2. per-point bandwidth by 64 bisection steps, so that
     sum_j exp(-(d_ij - rho_i) / sigma_i) = log2(k);
  3. the fuzzy set's symmetrisation w + w^T - w.w^T, looked up in the
     (N, k) lists;
  4. PCA initialisation;
  5. SGD epochs of the UMAP cross-entropy over all edges at once:
     attraction along the k-NN edges, repulsion against
     `negative_sample_rate` random points per edge, both at the epoch-start
     embedding, accumulated by two sorted segment sums an epoch.

``_optimize_scatter`` (a test oracle of the JAX package) is not ported.
``umap_epoch_sharded`` is one epoch with the edges split over the ranks of
a torch.distributed process group (``ark_tpu_torch.parallel.mesh``).

Three choices make one seed give one embedding on every device:

- The epoch's sums go through ``segment_reduce.segment_sum`` over flat
  sorted point ids (`heads` is sorted as built; `tails` by one stable
  argsort, as ``jnp.argsort`` is), with the background row: point 0 is a
  row like any other. On a CUDA tensor that is the hand-written kernel,
  which adds each point's updates in ascending edge order; a float
  ``index_add_`` there uses atomics and has no fixed order. The two plans
  are built once a fit.
- The negatives cannot replay ``jax.random``. They come from a counter-based
  integer hash (the splitmix64 finalizer over seed key + epoch * draws +
  position, in wrapping int64 torch ops), which gives the same integers on
  the CPU and on CUDA with no upload; the tests inject the JAX package's
  own draws through `negatives=`.
- An eigenvector's sign is the solver's choice, and cuSOLVER's need not be
  LAPACK's. ``_pca`` forms the C x C covariance on the device in f64,
  decomposes it on the host, and turns each component so that its largest
  entry is positive.
"""

from __future__ import annotations

import functools
import math
import time
from typing import Callable, Optional, Tuple, Union

import numpy as np
import torch

from ark_tpu_torch.ops import segment_reduce
from ark_tpu_torch.ops.som import _as_f32_tensor, _check_full_f32_matmul
from ark_tpu_torch.parallel import mesh

# precomputed curve parameters for (spread=1.0, min_dist=0.1), the
# umap-learn defaults
_A, _B = 1.576943, 0.895061

_MASK64 = (1 << 64) - 1


def _knn_row_block(rows: torch.Tensor, row_idx: torch.Tensor, data: torch.Tensor,
                   d2_all: torch.Tensor, k: int, block_cols: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN of `rows` (B, C), whose positions in `data` are `row_idx`,
    against `data` (N, C) in column blocks with a running top-k merge: peak
    memory O(B block_cols + B k). The self-match is masked to +inf. Returns
    (idx (B, k) int64, squared distances (B, k), ascending)."""
    n = data.shape[0]
    b = rows.shape[0]
    inf = torch.tensor(math.inf, device=rows.device)
    r2 = torch.sum(rows * rows, dim=1)
    best_d = torch.full((b, k), math.inf, device=rows.device)
    best_i = torch.full((b, k), -1, dtype=torch.int64, device=rows.device)
    for c0 in range(0, n, block_cols):
        blk = data[c0:c0 + block_cols]
        col_idx = torch.arange(c0, c0 + blk.shape[0], device=rows.device)
        d = (r2[:, None] - 2.0 * (rows @ blk.T)) + d2_all[None, c0:c0 + blk.shape[0]]
        d = torch.where(col_idx[None, :] == row_idx[:, None], inf, d)
        dcat = torch.cat([best_d, d], dim=1)
        icat = torch.cat([best_i, col_idx[None, :].expand(b, -1)], dim=1)
        best_d, pos = torch.topk(dcat, k, dim=1, largest=False, sorted=True)
        best_i = torch.gather(icat, 1, pos)
    return best_i, torch.clamp_min(best_d, 0.0)


def _knn(data: torch.Tensor, k: int, block_rows: int = 4096,
         block_cols: int = 2048) -> Tuple[torch.Tensor, torch.Tensor]:
    """(indices (N, k) int64, distances (N, k)) of each point's k nearest
    euclidean neighbours (self excluded), exact, blocked: O(N k + block
    area) memory, never N^2. The products run in full f32 (TF32 flips
    neighbour ranks), so TF32 matmuls are refused."""
    _check_full_f32_matmul()
    n = data.shape[0]
    k = min(k, n - 1)
    d2_all = torch.sum(data * data, dim=1)
    idx_out, d_out = [], []
    for r0 in range(0, n, block_rows):
        rows = data[r0:r0 + block_rows]
        row_idx = torch.arange(r0, r0 + rows.shape[0], device=data.device)
        bi, bd = _knn_row_block(rows, row_idx, data, d2_all, k, block_cols)
        idx_out.append(bi)
        d_out.append(bd)
    return torch.cat(idx_out), torch.sqrt(torch.cat(d_out))


def _smooth_knn(dists: torch.Tensor, n_iter: int = 64
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-point (rho, sigma): rho is the nearest distance; sigma solves
    sum_j exp(-max(d_ij - rho, 0) / sigma) = log2(k) by bisection."""
    k = dists.shape[1]
    target = float(np.log2(np.float32(k)))
    rho = dists[:, 0]
    shifted = torch.clamp_min(dists - rho[:, None], 0.0)
    lo = torch.full((dists.shape[0],), 1e-6, device=dists.device)
    hi = torch.full((dists.shape[0],), 1e3, device=dists.device)
    for _ in range(n_iter):
        mid = (lo + hi) / 2.0
        val = torch.sum(torch.exp(-shifted / mid[:, None]), dim=1)
        too_big = val > target
        lo = torch.where(too_big, lo, mid)
        hi = torch.where(too_big, mid, hi)
    return rho, (lo + hi) / 2.0


@functools.lru_cache(maxsize=8)
def find_ab_params(spread: float = 1.0, min_dist: float = 0.1):
    """Least-squares fit of the low-dimensional similarity curve
    1 / (1 + a d^(2b)) to the target exponential falloff, as umap-learn's
    find_ab_params: what makes `min_dist` a real parameter."""
    if (spread, min_dist) == (1.0, 0.1):
        return _A, _B                      # precomputed default
    from scipy.optimize import curve_fit
    xv = np.linspace(0.0, spread * 3.0, 300)
    yv = np.where(xv < min_dist, 1.0, np.exp(-(xv - min_dist) / spread))

    def curve(x, a, b):
        return 1.0 / (1.0 + a * x ** (2.0 * b))

    (a, b), _ = curve_fit(curve, xv, yv, p0=(_A, _B), maxfev=10000)
    return float(a), float(b)


def _splitmix64(z: int) -> int:
    """The splitmix64 finalizer on a Python integer (mod 2^64)."""
    z &= _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def _signed64(z: int) -> int:
    return z - (1 << 64) if z >= 1 << 63 else z


def draw_negatives(seed: int, epoch: int, rate: int, n_edges: int, n: int,
                   device) -> torch.Tensor:
    """(rate, n_edges) int64 point ids in [0, n) for one epoch: draw number
    c = epoch * rate * n_edges + position is the high 32 bits h of
    splitmix64(key(seed) + c), reduced by (h * n) >> 32. Integer torch ops
    only (int64 products wrap mod 2^64 on the CPU and on CUDA alike), so a
    seed gives the same ids on every device with nothing uploaded; n < 2^31.
    The reduction favours no id by more than n / 2^32."""
    if not 0 < n < 1 << 31:
        raise ValueError(f"draw_negatives: n = {n} outside (0, 2^31)")
    draws = rate * n_edges
    start = _signed64((_splitmix64(seed) + epoch * draws) & _MASK64)
    z = torch.arange(draws, dtype=torch.int64, device=device).add_(start)
    # z >> s is arithmetic on int64; the mask makes it the logical shift
    z = z.bitwise_xor_((z >> 30).bitwise_and_((1 << 34) - 1)).mul_(
        _signed64(0xBF58476D1CE4E5B9))
    z = z.bitwise_xor_((z >> 27).bitwise_and_((1 << 37) - 1)).mul_(
        _signed64(0x94D049BB133111EB))
    z = z.bitwise_xor_((z >> 31).bitwise_and_((1 << 33) - 1))
    h = (z >> 32).bitwise_and_((1 << 32) - 1)
    return h.mul_(n).bitwise_right_shift_(32).reshape(rate, n_edges)


Negatives = Union[torch.Tensor, Callable[[int], torch.Tensor]]


def _optimize(emb0: torch.Tensor, heads: torch.Tensor, tails: torch.Tensor,
              weights: torch.Tensor, seed: int = 42, n_epochs: int = 200,
              negative_sample_rate: int = 5, initial_lr: float = 1.0,
              a: float = _A, b: float = _B, *,
              negatives: Optional[Negatives] = None) -> torch.Tensor:
    """SGD over the UMAP cross-entropy, all edges per epoch, on the tensors'
    device. Each epoch computes the attraction along the edges and the
    repulsion against `negative_sample_rate` negatives per edge at the
    epoch-start embedding, and adds them with two sorted segment sums (the
    head's update in edge order, the tail's in the stable order of the
    tails): the hand-written kernel on CUDA tensors, never a float
    ``index_add_`` there. `negatives` replaces the seeded draws: an
    (n_epochs, rate, n_edges) integer tensor, or a callable epoch ->
    (rate, n_edges)."""
    n = emb0.shape[0]
    n_edges = heads.shape[0]
    dev = emb0.device
    heads = heads.to(torch.int64)
    tails = tails.to(torch.int64)
    a32 = torch.tensor(a, dtype=torch.float32, device=dev)
    b32 = torch.tensor(b, dtype=torch.float32, device=dev)

    # loop-invariant: both endpoint lists sorted once, and their plans
    perm_h = torch.argsort(heads, stable=True)
    perm_t = torch.argsort(tails, stable=True)
    sorted_heads = heads[perm_h].to(torch.int32)
    sorted_tails = tails[perm_t].to(torch.int32)
    plan_h = segment_reduce.segment_plan(sorted_heads, n)
    plan_t = segment_reduce.segment_plan(sorted_tails, n)

    emb = emb0.to(torch.float32)
    w = weights.to(torch.float32)
    for epoch in range(n_epochs):
        lr = np.float32(initial_lr) * (np.float32(1.0) - np.float32(epoch)
                                       / np.float32(n_epochs))
        he = emb[heads]
        diff = he - emb[tails]
        d2 = torch.sum(diff * diff, dim=1)
        # attractive gradient: dCE/dd2 for w_ij ~ 1 / (1 + a d2^b); d2 is
        # kept away from 0 (d2^(b-1) diverges there) and the gradient zeroed
        d2s = torch.clamp_min(d2, 1e-8)
        grad_coef = torch.where(
            d2 > 0.0,
            (-2.0 * a32 * b32) * d2s ** (b32 - 1.0) / (1.0 + a32 * d2s ** b32),
            0.0)
        attract = torch.clamp(grad_coef[:, None] * diff, -4.0, 4.0) * w[:, None]

        # repulsion: every negative of every edge in one phase
        if negatives is None:
            negs = draw_negatives(seed, epoch, negative_sample_rate, n_edges, n, dev)
        elif callable(negatives):
            negs = negatives(epoch)
        else:
            negs = negatives[epoch]
        negs = negs.to(device=dev, dtype=torch.int64)
        ne = emb[negs.reshape(-1)].reshape(negative_sample_rate, n_edges, emb.shape[1])
        ndiff = he[None, :, :] - ne
        nd2 = torch.sum(ndiff * ndiff, dim=2)
        ncoef = (2.0 * b32) / ((0.001 + nd2) * (1.0 + a32 * nd2 ** b32))
        # each negative's contribution is clipped, then they are added up
        repel = torch.sum(
            torch.clamp(ncoef[:, :, None] * ndiff, -4.0, 4.0) * w[None, :, None], dim=0)

        lr32 = torch.tensor(float(lr), dtype=torch.float32, device=dev)
        up_heads = (lr32 * (attract + repel))[perm_h]
        up_tails = (-lr32 * attract)[perm_t]
        emb = emb + segment_reduce.segment_sum(up_heads, sorted_heads, n, plan_h)
        emb = emb + segment_reduce.segment_sum(up_tails, sorted_tails, n, plan_t)
    return emb


def umap_epoch_sharded(emb, heads, tails, weights, lr: float,
                       negative_sample_rate: int = 5, a: float = _A, b: float = _B, *,
                       seed: int = 0, negatives=None, device, group=None) -> torch.Tensor:
    """One UMAP epoch with the edge list split over the ranks (the port of
    ``umap_epoch_sharded``): each rank computes the attraction and the
    negative-sample repulsion of its edges at the epoch-start embedding
    into an (N, d) delta, the deltas are summed over the ranks in rank
    order, and the embedding moves once. The edges are padded to a multiple
    of the world size with (0, 0, weight 0) edges, which add nothing.

    Each rank's delta adds, per point, the JAX package's updates in its
    order: the attraction at the heads, minus it at the tails, then each
    negative round at the heads, into zeros. That is one
    ``segment_sum`` over the concatenated list [heads; tails; heads x rate]
    sorted stably: XLA's sequential scatter on the CPU, the hand-written
    kernel on CUDA (never a float ``index_add_`` there).

    `negatives` are (rate, E) or (rate, E padded) point ids by global edge
    position (the JAX package's per-shard ``fold_in(key, axis_index)``
    draws, concatenated in rank order); each rank takes its own columns.
    Without them each rank takes its columns of ``draw_negatives(seed, 0,
    rate, E, n)``, the same ids for an edge at every world size.
    `emb` (N, d), `heads`, `tails` and `weights` (E,) are numpy arrays or
    tensors, all of them on every rank. Returns the new (N, d) f32
    embedding on `device`, the same on every rank."""
    g = mesh.resolve_group(group)
    ws, r = mesh.world(g), mesh.rank(g)
    emb = _as_f32_tensor(emb, device)
    n = emb.shape[0]
    ids = [torch.as_tensor(np.asarray(e), device=device).to(torch.int64)
           for e in (heads, tails)]
    w = _as_f32_tensor(weights, device)
    n_edges = w.shape[0]
    e_pad = mesh.pad_to_multiple(n_edges, ws)
    lo, hi = mesh.shard_bounds(e_pad, ws, r)
    he, ta = (torch.nn.functional.pad(e, (0, e_pad - n_edges))[lo:hi] for e in ids)
    w = torch.nn.functional.pad(w, (0, e_pad - n_edges))[lo:hi]
    rate = negative_sample_rate
    if negatives is None:
        negatives = draw_negatives(seed, 0, rate, n_edges, n, device)
    negs = torch.as_tensor(np.asarray(negatives) if not isinstance(negatives, torch.Tensor)
                           else negatives).to(device=device, dtype=torch.int64)
    negs = torch.nn.functional.pad(negs, (0, e_pad - negs.shape[-1]))[:, lo:hi]

    # python floats enter the JAX shard as f32 weak types; a 0-d tensor
    # numerator keeps 2b / x a true division (torch's scalar / tensor
    # multiplies by the reciprocal)
    lr32 = torch.tensor(np.float32(lr), device=device)
    two_b = torch.tensor(np.float32(2.0 * b), device=device)
    hpos = emb[he]
    diff = hpos - emb[ta]
    d2 = torch.sum(diff * diff, dim=1)
    d2s = torch.clamp_min(d2, 1e-8)
    grad_coef = torch.where(
        d2 > 0.0, (-2.0 * a * b) * d2s ** (b - 1.0) / (1.0 + a * d2s ** b), 0.0)
    attract = torch.clamp(grad_coef[:, None] * diff, -4.0, 4.0) * w[:, None]
    values, labels = [lr32 * attract, -lr32 * attract], [he, ta]
    for j in range(rate):
        ndiff = hpos - emb[negs[j]]
        nd2 = torch.sum(ndiff * ndiff, dim=1)
        coef = two_b / ((0.001 + nd2) * (1.0 + a * nd2 ** b))
        values.append(lr32 * (torch.clamp(coef[:, None] * ndiff, -4.0, 4.0) * w[:, None]))
        labels.append(he)
    labels = torch.cat(labels)
    perm = torch.argsort(labels, stable=True)
    delta = segment_reduce.segment_sum(torch.cat(values)[perm],
                                       labels[perm].to(torch.int32), n)
    return emb + mesh.rank_order_sum(delta, g)


def _pca(data: torch.Tensor, n_components: int = 2) -> torch.Tensor:
    """The rows' projection on their first `n_components` principal axes,
    f32 on the data's device. Mean, covariance and projection are f64 on the
    device; the C x C covariance is decomposed on the host (LAPACK, for
    every device), and each axis is turned so that its entry of largest
    magnitude is positive."""
    x = data.to(torch.float64)
    x = x - x.mean(dim=0, keepdim=True)
    cov = (x.T @ x) / x.shape[0]
    _, vecs = np.linalg.eigh(cov.cpu().numpy())
    vecs = vecs[:, ::-1][:, :n_components]
    lead = vecs[np.argmax(np.abs(vecs), axis=0), np.arange(vecs.shape[1])]
    vecs = vecs * np.where(lead < 0, -1.0, 1.0)
    return (x @ torch.as_tensor(np.ascontiguousarray(vecs), device=x.device)
            ).to(torch.float32)


def fuzzy_graph(idx: torch.Tensor, dists: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(heads, tails, weights) of the symmetrised fuzzy simplicial set from
    the (N, k) neighbour lists: edge (i, j) for j in i's list, with weight
    w + w^T - w.w^T. The reverse weight w(j, i) is nonzero only if i is in
    j's list, so it is looked up there: O(N k^2) gathered compares, no
    N x N matrix."""
    n, k = idx.shape
    rho, sigma = _smooth_knn(dists)
    w = torch.exp(-torch.clamp_min(dists - rho[:, None], 0.0) / sigma[:, None])
    heads = torch.arange(n, device=idx.device).repeat_interleave(k)
    tails = idx.reshape(-1)
    wflat = w.reshape(-1)
    w_rev = torch.sum(w[tails] * (idx[tails] == heads[:, None]), dim=1)
    return heads, tails, wflat + w_rev - wflat * w_rev


class UMAP:
    """umap-learn-compatible front: UMAP(device=...).fit_transform(X) ->
    (N, 2) numpy. `timings`, if a dict, collects the seconds of each step
    (k-NN, bandwidths and graph, PCA, optimise)."""

    def __init__(self, n_neighbors: int = 15, n_components: int = 2,
                 min_dist: float = 0.1, spread: float = 1.0,
                 n_epochs: int = 200, negative_sample_rate: int = 5,
                 random_state: int = 42, *, device="cuda", timings=None):
        self.n_neighbors = n_neighbors
        self.n_components = n_components
        self.min_dist = float(min_dist)
        self.spread = float(spread)
        self.n_epochs = n_epochs
        self.negative_sample_rate = negative_sample_rate
        self.random_state = random_state
        self.device = device
        self.timings = timings

    def _mark(self, name, t0):
        if self.timings is not None:
            if torch.device(self.device).type == "cuda":
                torch.cuda.synchronize()
            self.timings[name] = self.timings.get(name, 0.0) + time.perf_counter() - t0
        return time.perf_counter()

    def fit_transform(self, data) -> np.ndarray:
        t0 = time.perf_counter()
        data = _as_f32_tensor(np.asarray(data), self.device)
        k = min(self.n_neighbors, data.shape[0] - 1)
        idx, dists = _knn(data, k)
        t0 = self._mark("knn_s", t0)
        heads, tails, w_edges = fuzzy_graph(idx, dists)
        t0 = self._mark("graph_s", t0)
        emb0 = _pca(data, self.n_components)
        emb0 = emb0 / (emb0.abs().max() + 1e-12) * 10.0
        t0 = self._mark("pca_s", t0)
        a, b = find_ab_params(self.spread, self.min_dist)
        emb = _optimize(emb0, heads, tails, w_edges, self.random_state,
                        n_epochs=self.n_epochs,
                        negative_sample_rate=self.negative_sample_rate, a=a, b=b)
        out = emb.cpu().numpy()
        self._mark("optimize_s", t0)
        return out


def pca_transform(data, n_components: int = 2, *, device="cuda") -> np.ndarray:
    """PCA projection on `device` (covariance eigendecomposition)."""
    return _pca(_as_f32_tensor(np.asarray(data), device), n_components).cpu().numpy()
