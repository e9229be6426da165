"""k-means in torch ops: k-means++ seeding, then Lloyd's iterations.

Port of ``ark_tpu/ops/kmeans.py`` (the reference's sklearn KMeans calls:
neighborhood sweeps k = 2..10, `spatial_analysis_utils.py:341-454`).
Deterministic given a seed: k-means++ seeding, a fixed number of Lloyd
iterations with an empty cluster re-seeded to the farthest point, argmin
ties to the lowest index, and of `n_init` restarts the lowest inertia wins
(the first on a tie). The restarts run batched on the device.

Two choices differ from the JAX package, both so that a seed gives the same
partition on every device:

- The seeding's draws cannot replay ``jax.random``. Each restart i takes
  its uniforms from a CPU ``torch.Generator`` seeded with `seed + i` (the
  JAX package's `PRNGKey(seed + i)`), and picks the next center by inverse
  CDF on the device (searchsorted in the f64 cumulative sum of d^2): the
  same draws for CPU and CUDA tensors, no host round trip per center.
- The assignment and update run in f64: on integer data, such as neighbor
  counts, the center sums are exact and an argmin can flip between devices
  only at an exact tie. The JAX package works in f32, so the two agree
  where its f32 rounding does not decide an assignment; the tests hold the
  port to the JAX package given its own seeding (``_lloyd``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _as_f64(data, device) -> torch.Tensor:
    """The rows as f64 on `device`, after rounding to f32 as the JAX
    package's entry points do."""
    if isinstance(data, torch.Tensor):
        return data.to(device=device, dtype=torch.float32).to(torch.float64)
    return torch.as_tensor(np.array(data, dtype=np.float32), device=device
                           ).to(torch.float64)


def _sq_dists(data: torch.Tensor, x2: torch.Tensor,
              centers: torch.Tensor) -> torch.Tensor:
    """(R, N, k) squared distances, |x|^2 - 2 x.c + |c|^2 as the JAX
    package computes them; `centers` (R, k, D)."""
    c2 = torch.sum(centers * centers, dim=2)
    return x2[None, :, None] - 2.0 * torch.matmul(data, centers.transpose(1, 2)) \
        + c2[:, None, :]


def _plus_plus_init(data: torch.Tensor, k: int, seeds) -> torch.Tensor:
    """k-means++ seeding of one restart per seed: (R, k, D) centers on the
    data's device. Restart r draws from ``torch.Generator().manual_seed(
    seeds[r])``: one index uniform over the rows, then k - 1 uniforms in
    [0, 1) for the inverse-CDF picks."""
    n, dim = data.shape
    r = len(seeds)
    first = np.empty(r, np.int64)
    u = np.empty((r, max(k - 1, 0)), np.float64)
    for i, s in enumerate(seeds):
        g = torch.Generator().manual_seed(int(s))
        first[i] = int(torch.randint(n, (), generator=g))
        u[i] = torch.rand(k - 1, generator=g, dtype=torch.float64).numpy()
    dev = data.device
    centers = torch.zeros((r, k, dim), dtype=data.dtype, device=dev)
    centers[:, 0] = data[torch.as_tensor(first, device=dev)]
    u = torch.as_tensor(u, device=dev)
    x2 = torch.sum(data * data, dim=1)
    big = torch.tensor(float("inf"), dtype=data.dtype, device=dev)
    for i in range(1, k):
        pair = torch.clamp_min(_sq_dists(data, x2, centers), 0.0)
        unset = torch.arange(k, device=dev)[None, None, :] >= i
        d2 = torch.min(torch.where(unset, big, pair), dim=2).values     # (R, N)
        cum = torch.cumsum(d2, dim=1)
        # the first row whose cumulative weight passes u * total: a row of
        # zero weight is never picked (unless every weight is zero)
        pick = torch.searchsorted(cum, (u[:, i - 1] * cum[:, -1])[:, None],
                                  right=True)[:, 0]
        centers[:, i] = data[torch.clamp_max(pick, n - 1)]
    return centers


def _lloyd(data: torch.Tensor, centers: torch.Tensor, n_iter: int
           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """`n_iter` Lloyd iterations from (R, k, D) initial centers, batched over
    the R restarts (f64 `data` (N, D) and `centers` on one device). Returns
    (centers (R, k, D), labels (R, N) int64, inertia (R,))."""
    k = centers.shape[1]
    x2 = torch.sum(data * data, dim=1)

    def assign(c):
        d2 = _sq_dists(data, x2, c)
        best = torch.min(d2, dim=2)           # ties: the lowest index
        return best.indices, torch.clamp_min(best.values, 0.0)

    for _ in range(n_iter):
        labels, d2 = assign(centers)
        h = torch.nn.functional.one_hot(labels, k).to(data.dtype)     # (R, N, k)
        sums = torch.matmul(h.transpose(1, 2), data)                   # (R, k, D)
        counts = torch.sum(h, dim=1)                                   # (R, k)
        new = sums / torch.clamp_min(counts, 1.0)[:, :, None]
        # an empty cluster is re-seeded to the current farthest point
        far = data[torch.argmax(d2, dim=1)]                            # (R, D)
        centers = torch.where((counts > 0)[:, :, None], new, far[:, None, :])
    labels, d2 = assign(centers)
    return centers, labels, torch.sum(d2, dim=1)


def _best(centers, labels, inertia):
    """The restart of lowest inertia (the first on a tie)."""
    best = int(torch.argmin(inertia))
    return (centers[best].to(torch.float32), labels[best].to(torch.int32),
            inertia[best])


def kmeans_fit(data, k: int, seed: int = 42, n_iter: int = 50, *,
               device="cuda") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fit k-means on `device`; returns (centers (k, D) f32, labels (N,)
    int32, inertia f64 scalar), tensors on `device`."""
    return kmeans_fit_multi(data, k, seed=seed, n_iter=n_iter, n_init=1,
                            device=device)


def kmeans_fit_multi(data, k: int, seed: int = 42, n_iter: int = 50,
                     n_init: int = 10, *, device="cuda"
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Best of `n_init` k-means++ restarts (seeds seed .. seed + n_init - 1,
    sklearn's n_init semantics), batched on `device`."""
    x = _as_f64(data, device)
    centers = _plus_plus_init(x, k, [seed + i for i in range(max(n_init, 1))])
    return _best(*_lloyd(x, centers, n_iter))


def kmeans(data, k: int, seed: int = 42, n_iter: int = 50, n_init: int = 10, *,
           device="cuda"):
    """Host-friendly wrapper: returns (labels np.int32, inertia float)."""
    _, labels, inertia = kmeans_fit_multi(data, k, seed=seed, n_iter=n_iter,
                                          n_init=n_init, device=device)
    return labels.cpu().numpy(), float(inertia)
