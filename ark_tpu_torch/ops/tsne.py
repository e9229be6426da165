"""t-SNE in torch ops: the exact (dense) gradient, on the data's device.

Port of ``ark_tpu/ops/tsne.py``. Exact t-SNE suits the sizes pipelines
embed (a sample of ~1e4 cells): the (N, N) affinity and gradient matrices
are dense products and elementwise passes (N = 10k: 400 MB an f32 matrix),
where Barnes-Hut trees chase pointers.

Algorithm (van der Maaten & Hinton 2008, sklearn's semantics):
  - per-point conditional affinities by a vectorised 64-step bisection of
    beta = 1 / (2 sigma^2) to the target perplexity;
  - symmetrise and normalise; early exaggeration (x 12) for the first
    quarter of the schedule;
  - Student-t kernel in the embedding, gradient descent with momentum
    (0.5, then 0.8) and sklearn's per-parameter gains;
  - learning_rate="auto" = max(N / 12 / 4, 50), sklearn's default since 1.1.

The squared distances are ``ops/distances.squared_distances`` (its D <= 4
rule serves the embedding, its full-f32 product the data). The diagonal is
masked with ``where``, never by ``eye * inf``. Deterministic per seed on
every device: the initial embedding is drawn from a CPU ``torch.Generator``
and uploaded ((N, 2) floats); the tests inject the JAX package's own draw
through `y0=`.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ark_tpu_torch.ops.distances import squared_distances
from ark_tpu_torch.ops.som import _as_f32_tensor, _check_full_f32_matmul


def _squared_dists(x: torch.Tensor) -> torch.Tensor:
    """(N, N) squared euclidean distances with an exact-zero diagonal."""
    return squared_distances(x, x, zero_diagonal=True)


def _eye(n: int, device) -> torch.Tensor:
    i = torch.arange(n, device=device)
    return i[:, None] == i[None, :]


def _conditional_affinities(d2: torch.Tensor, perplexity: float) -> torch.Tensor:
    """Row-stochastic P(j|i) at the target perplexity, by a per-row 64-step
    bisection on beta = 1 / (2 sigma^2)."""
    n = d2.shape[0]
    eye = _eye(n, d2.device)
    target = float(np.log(np.float32(perplexity)))
    neg_inf = torch.tensor(-math.inf, device=d2.device)

    def entropy_and_p(beta):
        logits = torch.where(eye, neg_inf, -d2 * beta[:, None])
        logp = torch.log_softmax(logits, dim=1)
        p = torch.exp(logp)
        h = -torch.sum(torch.where(p > 0, p * logp, 0.0), dim=1)
        return h, p

    lo = torch.full((n,), 1e-12, dtype=torch.float32, device=d2.device)
    hi = torch.full((n,), 1e12, dtype=torch.float32, device=d2.device)
    for _ in range(64):
        mid = torch.sqrt(lo * hi)           # geometric: beta spans decades
        h, _ = entropy_and_p(mid)
        too_smooth = h > target             # entropy too high: raise beta
        lo = torch.where(too_smooth, mid, lo)
        hi = torch.where(too_smooth, hi, mid)
    return entropy_and_p(torch.sqrt(lo * hi))[1]


def initial_embedding(n: int, n_components: int, seed: int) -> torch.Tensor:
    """The seeded start, 1e-4 * N(0, 1), (n, n_components) f32 on the CPU:
    one generator for every device."""
    gen = torch.Generator().manual_seed(int(seed))
    return 1e-4 * torch.randn((n, n_components), generator=gen, dtype=torch.float32)


def _embed(p_sym: torch.Tensor, seed: int, n_iter: int, n_exaggeration: int,
           learning_rate: float, n_components: int = 2, *,
           y0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """`n_iter` gradient steps from `y0` (default: ``initial_embedding`` of
    `seed`) on p_sym's device; the (N, N) x (N, d) product in full f32."""
    _check_full_f32_matmul()
    n = p_sym.shape[0]
    dev = p_sym.device
    if y0 is None:
        y0 = initial_embedding(n, n_components, seed)
    y = y0.to(device=dev, dtype=torch.float32)
    eye = _eye(n, dev)
    p_exaggerated = p_sym * 12.0
    vel = torch.zeros_like(y)
    gains = torch.ones_like(y)
    for it in range(n_iter):
        early = it < n_exaggeration
        p = p_exaggerated if early else p_sym
        momentum = 0.5 if early else 0.8
        w = 1.0 / (1.0 + _squared_dists(y))          # student-t kernel
        w = torch.where(eye, 0.0, w)
        q = w / torch.clamp_min(torch.sum(w), 1e-12)
        pq = (p - q) * w
        # 4 sum_j pq_ij (y_i - y_j) = 4 (rowsum(pq) y_i - pq @ y)
        g = 4.0 * (torch.sum(pq, dim=1)[:, None] * y - pq @ y)
        same_dir = torch.sign(g) == torch.sign(vel)
        gains = torch.clamp_min(torch.where(same_dir, gains * 0.8, gains + 0.2), 0.01)
        vel = momentum * vel - learning_rate * gains * g
        y = y + vel
        y = y - torch.mean(y, dim=0, keepdim=True)
    return y


def tsne(x, n_components: int = 2, perplexity: float = 30.0,
         n_iter: int = 1000, learning_rate="auto", seed: int = 42, *,
         device="cuda", y0=None) -> np.ndarray:
    """Embed (N, D) data to (N, n_components) by exact t-SNE on `device`."""
    x = _as_f32_tensor(np.asarray(x, np.float32), device)
    n = x.shape[0]
    if n < 4:
        raise ValueError("t-SNE needs at least 4 points")
    perplexity = float(min(perplexity, (n - 1) / 3.0))
    if learning_rate == "auto":
        learning_rate = max(n / 12.0 / 4.0, 50.0)
    p_cond = _conditional_affinities(_squared_dists(x), perplexity)
    p_sym = torch.clamp_min((p_cond + p_cond.T) / (2.0 * n), 1e-12)
    del p_cond
    y = _embed(p_sym, seed, int(n_iter), max(int(n_iter) // 4, 1),
               float(learning_rate), int(n_components),
               y0=None if y0 is None else torch.as_tensor(np.asarray(y0, np.float32)))
    return y.cpu().numpy()


class TSNE:
    """sklearn-compatible facade over ``tsne`` (drop-in for
    ``sklearn.manifold.TSNE().fit_transform``)."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 n_iter: int = 1000, learning_rate="auto",
                 random_state: int = 42, *, device="cuda"):
        self.n_components = n_components
        self.perplexity = perplexity
        self.n_iter = n_iter
        self.learning_rate = learning_rate
        self.random_state = random_state
        self.device = device

    def fit_transform(self, x) -> np.ndarray:
        self.embedding_ = tsne(
            x, n_components=self.n_components, perplexity=self.perplexity,
            n_iter=self.n_iter, learning_rate=self.learning_rate,
            seed=self.random_state if self.random_state is not None else 42,
            device=self.device)
        return self.embedding_
