"""Spatial latent Dirichlet allocation in torch ops: a port of
``ark_tpu/spLDA/model.py``.

Batch variational EM (Blei et al.): the E-step's doc-topic fixed point and
the M-step's sufficient statistics are dense products over the (cells,
features) count matrix in full f32, and each outer iteration smooths the
cells' topic distributions with a proximal step on the graph Laplacian of
the FOVs' MST adjacency (the difference matrices), of strength
`difference_penalty`.

Numerics, as the JAX package computes them:

- ``_digamma`` is XLA's Lanczos digamma (the CHLO expansion the JAX package
  runs), op for op in torch: ``torch.digamma`` uses another formula and
  differs in 44-85% of f32 values, which the EM amplifies ~100-fold over 50
  iterations. Divisions by a constant are multiplications by its f32
  reciprocal, as XLA's simplifier rewrites them; every other division is a
  true one (a CPU scalar numerator, never a CUDA reciprocal multiply).
- The Laplacian L = D^T D / deg is block-diagonal, one block a FOV, so the
  device holds and applies it per block (10 FOVs of 3000 cells: 10 x 36 MB,
  not 3.6 GB dense). Each block's D^T D is exact small integers; `deg`, the
  largest absolute row sum over all blocks, divides as a tensor.
- ``+ 1e-100`` is kept: it is 0 in f32, in both packages.
- ``jax.random.gamma`` cannot be replayed: ``train`` draws the initial topics
  lambda_0 = Gamma(100) x 0.01 on the host from ``np.random.default_rng(seed)``,
  the same on every device; the tests inject the JAX package's draw into
  ``_lda_em``.

``em_step_sharded`` is one outer iteration with the cells split over the
ranks of a torch.distributed process group (``ark_tpu_torch.parallel.mesh``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import pandas as pd
import torch

from ark_tpu_torch.ops.som import _as_f32_tensor, _check_full_f32_matmul
from ark_tpu_torch.parallel import mesh

# XLA's Lanczos approximation (g = 7, 8 coefficients); its base coefficient,
# 0.99999999999980993, is 1 in f32
_LANCZOS_GAMMA = 7.0
_LANCZOS_COEFFICIENTS = (
    676.520368121885098567009190444019, -1259.13921672240287047156078755283,
    771.3234287776530788486528258894, -176.61502916214059906584551354,
    12.507343278686904814458936853, -0.13857109526572011689554706,
    9.984369578019570859563e-6, 1.50563273514931155834e-7)
_F32 = np.float32
# z / (g + 0.5) as XLA computes it: z * f32(1 / 7.5)
_INV_G_HALF = float(_F32(1.0) / _F32(_LANCZOS_GAMMA + 0.5))
_LOG_G_HALF = float(_F32(math.log(_LANCZOS_GAMMA + 0.5)))
_PI = float(_F32(math.pi))
# 0-d CPU tensors: as numerators they keep a CUDA division a true one
_COEFFICIENTS_F32 = tuple(torch.tensor(c, dtype=torch.float32)
                          for c in _LANCZOS_COEFFICIENTS)
_GAMMA_F32 = torch.tensor(_LANCZOS_GAMMA, dtype=torch.float32)

Blocks = List[Tuple[int, torch.Tensor]]


class LatentDirichletAllocation:
    """Fitted spatial-LDA model: components_ (topics x features) and
    topic_weights (cells x topics DataFrame, (fov, cell) MultiIndex)."""

    def __init__(self, components_: np.ndarray, topic_weights: pd.DataFrame,
                 feature_names, n_topics: int, alpha: float, eta: float):
        self.components_ = components_
        self.topic_weights = topic_weights
        self.feature_names = list(feature_names)
        self.n_topics = n_topics
        self.alpha = alpha
        self.eta = eta


def lda_from_reference(components_, topic_weights, feature_names, n_topics: int,
                       alpha: float, eta: float) -> LatentDirichletAllocation:
    """The port's model from a JAX model's fields (numpy arrays, the topic
    weights as a DataFrame or an array), so that ``infer`` runs on topics
    trained by the JAX package."""
    if not isinstance(topic_weights, pd.DataFrame):
        topic_weights = pd.DataFrame(np.asarray(topic_weights, np.float32),
                                     columns=[f"Topic-{i}" for i in range(n_topics)])
    return LatentDirichletAllocation(np.asarray(components_, np.float32),
                                     topic_weights.copy(), feature_names, int(n_topics),
                                     float(alpha), float(eta))


def _digamma(x: torch.Tensor) -> torch.Tensor:
    """Digamma of f32 `x` by XLA's Lanczos formula, op for op: reflection
    below 0.5, the coefficient sums added in sequence, log(t) as
    log(g + 0.5) + log1p(z / (g + 0.5)), NaN at the poles (0 and the
    negative integers)."""
    need_to_reflect = x < 0.5
    z = torch.where(need_to_reflect, -x, x - 1.0)
    num = None
    denom = None
    for i, c in enumerate(_COEFFICIENTS_F32):
        zi = z + float(i + 1)
        q = torch.div(c, zi * zi)
        num = -q if num is None else num - q
        r = torch.div(c, zi)
        denom = r + 1.0 if denom is None else denom + r
    log_t = torch.log1p(z * _INV_G_HALF) + _LOG_G_HALF
    y = (log_t + num / denom) - torch.div(_GAMMA_F32, z + (_LANCZOS_GAMMA + 0.5))
    # cot(pi x) with x moved into [-0.5, 0.5] first, where pi x keeps its bits
    reduced = x + torch.abs(torch.floor(x + 0.5))
    p = reduced * _PI
    reflection = y - (torch.cos(p) * _PI) / torch.sin(p)
    result = torch.where(need_to_reflect, reflection, y)
    pole = (x <= 0.0) & (x == torch.floor(x))
    return torch.where(pole, torch.full_like(x, float("nan")), result)


def _exp_elog(p: torch.Tensor) -> torch.Tensor:
    """exp(E[log Dirichlet(p)]) row by row."""
    return torch.exp(_digamma(p) - _digamma(p.sum(dim=1, keepdim=True)))


def _apply_laplacian(blocks: Blocks, theta: torch.Tensor) -> torch.Tensor:
    """L @ theta for the block-diagonal L given as [(first row, block)]; rows
    outside every block get 0."""
    out = torch.zeros_like(theta)
    for first, block in blocks:
        rows = slice(first, first + block.shape[0])
        out[rows] = block @ theta[rows]
    return out


def _smooth(gamma: torch.Tensor, blocks: Blocks, penalty: float) -> torch.Tensor:
    """The proximal step of the difference penalty on the cells' topic
    distributions, keeping each row's total."""
    total = gamma.sum(dim=1, keepdim=True)
    theta = gamma / total
    theta = torch.clamp_min(theta - penalty * _apply_laplacian(blocks, theta), 1e-8)
    theta = theta / theta.sum(dim=1, keepdim=True)
    return theta * total


def _e_step_parts(X, lam, gamma, alpha: float, e_steps: int):
    """The E-step's fixed point on X's rows. Returns (gamma, exp(E[log
    beta]) (K, V), the rows' statistics exp(E[log theta])^T (X / phinorm)
    (K, V)): the sufficient statistics are the last two multiplied, after
    a sharded step has summed the statistics over its ranks."""
    exp_elog_beta = _exp_elog(lam)                                   # (K, V)
    for _ in range(e_steps):
        exp_elog_theta = _exp_elog(gamma)                            # (N, K)
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-100            # (N, V)
        gamma = alpha + exp_elog_theta * ((X / phinorm) @ exp_elog_beta.T)
    exp_elog_theta = _exp_elog(gamma)
    phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
    return gamma, exp_elog_beta, exp_elog_theta.T @ (X / phinorm)


def _e_step(X, lam, gamma, alpha: float, e_steps: int):
    gamma, exp_elog_beta, stats = _e_step_parts(X, lam, gamma, alpha, e_steps)
    return gamma, exp_elog_beta * stats


def _lda_em(X: torch.Tensor, L: Blocks, lam0: torch.Tensor, n_topics: int,
            alpha: float, eta: float, penalty: float, n_iter: int = 50,
            e_steps: int = 20):
    """Batch variational EM with Laplacian smoothing, on X's device.

    X: (N, V) f32 counts; L: the Laplacian's blocks [(first row, block)],
    [] for no smoothing; lam0: (K, V) f32 initial topics. Returns (lambda
    (K, V), gamma (N, K))."""
    _check_full_f32_matmul()
    if lam0.shape != (n_topics, X.shape[1]):
        raise ValueError(f"lam0 has shape {tuple(lam0.shape)}, expected "
                         f"{(n_topics, X.shape[1])}")
    lam = lam0.to(device=X.device, dtype=torch.float32)
    gamma = torch.ones((X.shape[0], n_topics), dtype=torch.float32, device=X.device)
    for _ in range(n_iter):
        gamma, sstats = _e_step(X, lam, gamma, alpha, e_steps)
        lam = eta + sstats
        gamma = _smooth(gamma, L, penalty)
    gamma, _ = _e_step(X, lam, gamma, alpha, e_steps)
    return lam, gamma


def _laplacian_rows(L, lo: int, hi: int, theta_full: torch.Tensor) -> torch.Tensor:
    """Rows [lo, hi) of L @ theta_full (N_pad, K). `L` is a dense (N, N)
    matrix (rows and columns past N are zero) or the blocks
    [(first row, block)] of ``laplacian_blocks``; a block may straddle
    ranks, so each rank takes its rows of it against the block's columns."""
    n_pad, k = theta_full.shape
    if isinstance(L, list):
        out = torch.zeros((hi - lo, k), dtype=torch.float32, device=theta_full.device)
        for first, block in L:
            a, b = max(first, lo), min(first + block.shape[0], hi)
            if a < b:
                out[a - lo:b - lo] = (block[a - first:b - first]
                                      @ theta_full[first:first + block.shape[1]])
        return out
    L = _as_f32_tensor(L, theta_full.device)
    n = L.shape[0]
    rows = torch.zeros((hi - lo, n_pad), dtype=torch.float32, device=theta_full.device)
    if lo < n:
        rows[:min(hi, n) - lo, :n] = L[lo:min(hi, n)]
    return rows @ theta_full


def em_step_sharded(X, lam, gamma, L, alpha: float, eta: float, penalty: float,
                    e_steps: int = 20, *, device, group=None):
    """One EM outer iteration with the cells split over the ranks (the port
    of ``em_step_sharded``): each rank runs the E-step's fixed point on its
    block of cells (N padded with zero-count cells to a multiple of the
    world size), the M-step's statistics are summed over the ranks in rank
    order before the multiply by exp(E[log beta]), and the smoothing
    all-gathers the (N, K) topic matrix so that each rank's rows of the
    Laplacian couple cells of other ranks.

    Args: X (N, V) counts, lam (K, V), gamma (N, K) (numpy arrays or
    tensors; every rank passes all of them), L a dense (N, N) Laplacian or
    ``laplacian_blocks``' blocks on `device`. Returns (new lam (K, V), new
    gamma (N, K)), f32 tensors on `device`, the same on every rank."""
    _check_full_f32_matmul()
    g = mesh.resolve_group(group)
    ws, r = mesh.world(g), mesh.rank(g)
    X = _as_f32_tensor(X, device)
    gamma = _as_f32_tensor(gamma, device)
    n = X.shape[0]
    n_pad = mesh.pad_to_multiple(n, ws)
    lo, hi = mesh.shard_bounds(n_pad, ws, r)
    pad = (0, 0, 0, n_pad - n)
    X_l = torch.nn.functional.pad(X, pad)[lo:hi]
    gamma_l = torch.nn.functional.pad(gamma, pad, value=1.0)[lo:hi]
    gamma_l, exp_elog_beta, stats = _e_step_parts(
        X_l, _as_f32_tensor(lam, device), gamma_l, alpha, e_steps)
    lam_new = eta + exp_elog_beta * mesh.rank_order_sum(stats, g)
    total = gamma_l.sum(dim=1, keepdim=True)
    theta_l = gamma_l / total
    theta_full = mesh.all_gather_rows(theta_l, g)
    theta_l = torch.clamp_min(theta_l - penalty * _laplacian_rows(L, lo, hi, theta_full),
                              1e-8)
    theta_l = theta_l / theta_l.sum(dim=1, keepdim=True)
    return lam_new, mesh.all_gather_rows(theta_l * total, g)[:n]


def _fov_blocks(sample_features: pd.DataFrame, difference_matrices: Optional[Dict]):
    """(first row, difference matrix) of each FOV whose matrix spans its
    featurized cells, in the row order of sample_features."""
    out, first = [], 0
    if difference_matrices is None:
        return out
    for fov in sample_features.index.get_level_values(0).unique():
        n_fov = len(sample_features.loc[fov])
        D = difference_matrices.get(fov)
        if D is not None and D.shape[1] == n_fov:
            out.append((first, np.asarray(D, np.float32)))
        first += n_fov
    return out


def _build_laplacian(sample_features: pd.DataFrame,
                     difference_matrices: Optional[Dict]) -> np.ndarray:
    """Dense block-diagonal graph Laplacian D^T D over all FOVs on the host,
    aligned with the row order of sample_features, divided by its largest
    absolute row sum; zeros if no difference matrices."""
    n = len(sample_features)
    L = np.zeros((n, n), np.float32)
    for first, D in _fov_blocks(sample_features, difference_matrices):
        m = D.shape[1]
        L[first:first + m, first:first + m] = D.T @ D
    # normalize so `difference_penalty` has a scale-free meaning
    deg = np.abs(L).sum(1).max()
    if deg > 0:
        L /= deg
    return L


def laplacian_blocks(sample_features: pd.DataFrame, difference_matrices: Optional[Dict],
                     *, device="cuda") -> Blocks:
    """The blocks of ``_build_laplacian``'s matrix on `device`, one a FOV:
    [(first row, D^T D / deg)]; [] if no difference matrices."""
    _check_full_f32_matmul()
    blocks = []
    for first, D in _fov_blocks(sample_features, difference_matrices):
        d = torch.as_tensor(D, device=device)
        blocks.append((first, d.T @ d))
    if not blocks:
        return blocks
    deg = torch.stack([torch.abs(b).sum(dim=1).max() for _, b in blocks]).max()
    if float(deg) > 0:
        blocks = [(first, b / deg) for first, b in blocks]
    return blocks


def initial_topics(seed: int, n_topics: int, n_features: int) -> np.ndarray:
    """lambda_0 = Gamma(100) x 0.01 in f32, from ``np.random.default_rng(seed)``."""
    draw = np.random.default_rng(seed).gamma(100.0, 1.0, (n_topics, n_features))
    return draw.astype(np.float32) * np.float32(0.01)


def _topic_frame(gamma: np.ndarray, index) -> pd.DataFrame:
    weights = gamma / gamma.sum(1, keepdims=True)
    return pd.DataFrame(weights, index=index,
                        columns=[f"Topic-{i}" for i in range(gamma.shape[1])])


def train(sample_features: pd.DataFrame, difference_matrices: Optional[Dict] = None,
          difference_penalty: float = 0.25, n_topics: int = 5,
          n_parallel_processes: int = 1, n_iters: int = 50,
          admm_rho=None, primal_dual_mu=None, seed: int = 42,
          alpha: Optional[float] = None, eta: Optional[float] = None, *,
          device="cuda") -> LatentDirichletAllocation:
    """Train a spatial-LDA model on `device` (the API of
    ``spatial_lda.model.train``; `n_parallel_processes`, `admm_rho` and
    `primal_dual_mu` are accepted and unused)."""
    X = torch.as_tensor(sample_features.values.astype(np.float32), device=device)
    alpha = alpha if alpha is not None else 1.0 / n_topics
    eta = eta if eta is not None else 1.0 / n_topics
    blocks = laplacian_blocks(sample_features, difference_matrices, device=device)
    lam0 = torch.as_tensor(initial_topics(seed, n_topics, X.shape[1]), device=device)
    lam, gamma = _lda_em(X, blocks, lam0, n_topics, float(alpha), float(eta),
                         float(difference_penalty), n_iter=int(n_iters))
    lam = lam.cpu().numpy()
    components = lam / lam.sum(1, keepdims=True)
    return LatentDirichletAllocation(components,
                                     _topic_frame(gamma.cpu().numpy(), sample_features.index),
                                     sample_features.columns, n_topics, alpha, eta)


def infer(model: LatentDirichletAllocation, sample_features: pd.DataFrame,
          difference_matrices: Optional[Dict] = None,
          difference_penalty: float = 0.25, n_parallel_processes: int = 1,
          n_iters: int = 30, seed: int = 42, *, device="cuda") -> pd.DataFrame:
    """Topic weights of new cells under the model's fixed topics, on
    `device`: E-steps of one fixed-point update each, with the same spatial
    smoothing."""
    _check_full_f32_matmul()
    X = torch.as_tensor(sample_features.values.astype(np.float32), device=device)
    n, v = X.shape
    lam = torch.as_tensor(np.asarray(model.components_ * v, np.float32),
                          device=device) + 1e-6
    blocks = laplacian_blocks(sample_features, difference_matrices, device=device)
    exp_elog_beta = _exp_elog(lam)
    gamma = torch.ones((n, model.n_topics), dtype=torch.float32, device=device)
    for _ in range(n_iters):
        exp_elog_theta = _exp_elog(gamma)
        phinorm = exp_elog_theta @ exp_elog_beta + 1e-100
        gamma = model.alpha + exp_elog_theta * ((X / phinorm) @ exp_elog_beta.T)
        gamma = _smooth(gamma, blocks, difference_penalty)
    return _topic_frame(gamma.cpu().numpy(), sample_features.index)
