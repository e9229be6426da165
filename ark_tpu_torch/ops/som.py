"""Self-organizing map on PyTorch: batch-Kohonen training and BMU mapping.

Port of ``ark_tpu/ops/som.py``. The best-matching-unit (BMU) search of a
CUDA tensor runs the hand-written kernel in ``ark_tpu_torch/csrc/bmu.cu``
(``bmu``); ``bmu_plain`` is the same function in torch ops, which CPU
tensors use and which the tests hold the kernel against. Training keeps the
JAX package's schedule exactly: the seeded host RNG for the initial nodes and
the visiting order, ``MAX_TRAIN_STEPS`` minibatch updates, pow2 row padding,
the bubble neighbourhood and the ``den > 0`` update mask, so that the port's
weights follow the JAX package's to f32 rounding (until a minibatch BMU falls
on a near-tie, where the order of the x.w sum picks the node). Every matrix
product is full f32: TF32 would flip BMUs well away from near-ties, so the
training loop refuses to run with TF32 matmuls enabled. ``device`` is a
required argument: nothing picks a device on its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ark_tpu_torch.ops import _kernels


def grid_coordinates(xdim: int, ydim: int) -> np.ndarray:
    """(K, 2) grid coordinates for a rectangular SOM, row-major like FlowSOM."""
    gx, gy = np.meshgrid(np.arange(xdim), np.arange(ydim), indexing="ij")
    return np.stack([gx.ravel(), gy.ravel()], axis=1).astype(np.float32)


def grid_distances(xdim: int, ydim: int) -> np.ndarray:
    """(K, K) euclidean distances between SOM grid nodes."""
    pts = grid_coordinates(xdim, ydim)
    d = pts[:, None, :] - pts[None, :, :]
    return np.sqrt((d ** 2).sum(-1)).astype(np.float32)


def default_radius_start(xdim: int, ydim: int) -> float:
    """FlowSOM's default starting radius: the 0.67 quantile of grid distances."""
    return float(np.quantile(grid_distances(xdim, ydim), 0.67))


# ---------------------------------------------------------------------------
# BMU mapping
# ---------------------------------------------------------------------------

def bmu_plain(weights: torch.Tensor, data: torch.Tensor, return_dist: bool = True
              ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """BMU search in torch ops: (argmin indices int32, squared distances).

    d = |w|^2 - 2 x.w; ties go to the lowest index (``torch.argmin`` returns
    the first minimum on CPU and CUDA). The distance adds |x|^2 back and
    clamps at 0, as ``ark_tpu.ops.som.bmu_xla`` does."""
    w2 = torch.sum(weights * weights, dim=1)
    d = w2[None, :] - 2.0 * (data @ weights.T)
    idx = torch.argmin(d, dim=1)
    if not return_dist:
        return idx.to(torch.int32), None
    x2 = torch.sum(data * data, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0] + x2
    return idx.to(torch.int32), torch.clamp_min(best, 0.0)


def _check_kernel_operands(weights: torch.Tensor, data: torch.Tensor) -> None:
    if data.device.type != "cuda" or weights.device != data.device:
        raise ValueError(f"bmu: weights on {weights.device} and data on "
                         f"{data.device}; the kernel takes both on one CUDA device")
    if weights.dtype != torch.float32 or data.dtype != torch.float32:
        raise TypeError(f"bmu: the kernel takes float32, got weights "
                        f"{weights.dtype} and data {data.dtype}")
    if data.ndim != 2 or weights.ndim != 2 or data.shape[1] != weights.shape[1]:
        raise ValueError(f"bmu: data (N, C) and weights (K, C) expected, got "
                         f"{tuple(data.shape)} and {tuple(weights.shape)}")
    if weights.shape[0] == 0:
        raise ValueError("bmu: the SOM has no nodes")
    if not (data.is_contiguous() and weights.is_contiguous()):
        raise ValueError("bmu: the kernel takes contiguous row-major tensors")


def bmu(weights: torch.Tensor, data: torch.Tensor, return_dist: bool = True
        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """BMU search: the CUDA kernel for CUDA tensors, ``bmu_plain`` for CPU ones.

    Port of ``ark_tpu.ops.som.bmu_pallas``. On CUDA tensors it launches
    ``ark_bmu_launch`` on the current stream and raises if the launch is
    refused; it never falls back. ``bmu.launches`` counts kernel launches.
    Returns (indices (N,) int32, distances (N,) f32 or None)."""
    if data.device.type == "cpu" and weights.device.type == "cpu":
        return bmu_plain(weights, data, return_dist)
    _check_kernel_operands(weights, data)
    n, c = data.shape
    k = weights.shape[0]
    idx = torch.empty(n, dtype=torch.int32, device=data.device)
    dist = torch.empty(n, dtype=torch.float32, device=data.device) \
        if return_dist else None
    if n == 0:
        return idx, dist
    w2 = torch.sum(weights * weights, dim=1)           # the same op as bmu_plain
    lib = _kernels.bmu_lib()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        err = lib.ark_bmu_launch(
            data.data_ptr(), weights.data_ptr(), w2.data_ptr(), n, c, k,
            idx.data_ptr(), dist.data_ptr() if return_dist else None,
            int(return_dist), stream)
    if err != 0:
        raise RuntimeError(f"bmu kernel launch failed: "
                           f"{lib.ark_bmu_error_string(err).decode()} ({err})")
    bmu.launches += 1
    return idx, dist


bmu.launches = 0


def _as_f32_tensor(a, device) -> torch.Tensor:
    """A numpy array or tensor as a contiguous f32 tensor on `device`."""
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32).contiguous()
    a = np.ascontiguousarray(a, dtype=np.float32)
    if not a.flags.writeable:       # torch tensors must own writable memory
        a = a.copy()
    return torch.as_tensor(a, device=device)


def som_weights_from_numpy(weights, device) -> torch.Tensor:
    """The (K, C) f32 weight table that ``cluster_helpers`` persists, as a
    contiguous tensor on `device`: the form ``bmu`` takes."""
    return _as_f32_tensor(weights, device)


def som_map_async(weights, data, *, device) -> torch.Tensor:
    """Upload and launch the BMU search; return the 0-indexed int32 labels
    as a tensor on `device` without waiting for them, so that a caller can
    overlap host work with the upload and the kernel. `weights` and `data`
    are numpy arrays or tensors."""
    w = _as_f32_tensor(weights, device)
    x = _as_f32_tensor(data, device)
    idx, _ = bmu(w, x, return_dist=False)
    return idx


def som_map(weights, data, return_dist: bool = True, *, device
            ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Map observations to their best-matching SOM node on `device`.

    Equivalent of ``pyFlowSOM.map_data_to_nodes``. Returns (clusters,
    1-indexed as pyFlowSOM's, distances or None)."""
    w = _as_f32_tensor(weights, device)
    x = _as_f32_tensor(data, device)
    idx, dist = bmu(w, x, return_dist=return_dist)
    return (idx.cpu().numpy() + 1,
            dist.cpu().numpy() if return_dist else None)


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

# The lr/radius schedule always spans MAX_TRAIN_STEPS minibatch updates; the
# batch size absorbs the data size (see `_schedule_batch`).
MAX_TRAIN_STEPS = 256


def _check_full_f32_matmul() -> None:
    if torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError(
            "the port's f32 products (SOM training, the weighted channel "
            "product) need full f32 matmuls, but torch's float32 matmul "
            f"precision is {torch.get_float32_matmul_precision()!r} (TF32); "
            "call torch.set_float32_matmul_precision('highest')")


def _schedule() -> np.ndarray:
    """Per-step fraction of the schedule, f32 as the JAX scan computes it."""
    t = np.arange(MAX_TRAIN_STEPS, dtype=np.float32)
    return t / np.float32(MAX_TRAIN_STEPS - 1)


def _train_steps(data: torch.Tensor, w0: torch.Tensor, order: torch.Tensor,
                 gdist: torch.Tensor, batch_size: int, lr_start: float,
                 lr_end: float, r_start: float) -> torch.Tensor:
    """Batch-Kohonen training: MAX_TRAIN_STEPS updates over `order`
    (MAX_TRAIN_STEPS * batch_size pre-shuffled row indices). The port of
    ``ark_tpu.ops.som._train_scan`` with every step active."""
    _check_full_f32_matmul()
    frac = _schedule()
    # python-float operands enter the JAX scan as f32 weak types
    alpha = np.float32(lr_start) + np.float32(lr_end - lr_start) * frac
    radius = np.float32(r_start) * (np.float32(1.0) - frac)
    alpha = torch.from_numpy(alpha).to(data.device)
    radius = torch.from_numpy(radius).to(data.device)
    w = w0
    for t in range(MAX_TRAIN_STEPS):
        x = data[order[t * batch_size:(t + 1) * batch_size]]        # (B, C)
        w2 = torch.sum(w * w, dim=1)
        d = w2[None, :] - 2.0 * (x @ w.T)
        bmu_t = torch.argmin(d, dim=1)
        # bubble neighbourhood membership (B, K)
        h = (gdist[bmu_t] <= radius[t]).to(torch.float32)
        num = h.T @ x                                                # (K, C)
        den = torch.sum(h, dim=0)                                    # (K,)
        target = num / torch.clamp_min(den, 1.0)[:, None]
        w = torch.where((den > 0)[:, None], w + alpha[t] * (target - w), w)
    return w


def _next_pow2(n: int) -> int:
    return 1 << max(n - 1, 1).bit_length()


def _schedule_batch(total: int, batch_size: Optional[int]) -> int:
    """Batch size so the full schedule (MAX_TRAIN_STEPS updates) runs for any
    data size: large inputs get total/256-row batches, small inputs wrap their
    permutation into extra passes. `batch_size` overrides (clamped to pow2
    bounds)."""
    if batch_size is not None:
        return int(np.clip(_next_pow2(batch_size) if batch_size & (batch_size - 1)
                           else batch_size, 8, 1 << 16))
    return int(np.clip(_next_pow2(max(total // MAX_TRAIN_STEPS, 1)),
                       8, 1 << 16))


def _prepare_train(data, xdim, ydim, num_passes, seed, batch_size,
                   radius_start, weights_init, device):
    """Host-side training prep shared by som_train / som_train_and_map: the
    JAX package's seeded init and visiting order (the same numpy draws, so
    the same rows), pow2 row padding, schedule constants.
    Returns (data_padded, w0, order, gdist, bs, r0, n), tensors on `device`."""
    data = _as_f32_tensor(data, device)
    if data.ndim != 2:
        raise ValueError(
            f"SOM training data must be 2-D (rows, channels); got shape "
            f"{tuple(data.shape)}")
    n = data.shape[0]
    if n == 0:
        raise ValueError("cannot train SOM on empty data")
    k = xdim * ydim
    host_rng = np.random.default_rng(seed)

    if weights_init is None:
        # FlowSOM initializes codes from a random sample of observations
        init_rows = host_rng.choice(n, size=k, replace=n < k)
        w0 = data[torch.from_numpy(init_rows.astype(np.int64)).to(device)]
    else:
        w0 = _as_f32_tensor(weights_init, device)

    total = int(num_passes) * n
    bs = _schedule_batch(total, batch_size)
    perm = host_rng.permutation(n)
    order_len = MAX_TRAIN_STEPS * bs
    reps = (order_len + n - 1) // n
    order = torch.from_numpy(np.tile(perm, reps)[:order_len].astype(np.int64)
                             ).to(device)
    data_padded = torch.nn.functional.pad(data, (0, 0, 0, _next_pow2(n) - n))

    r0 = radius_start if radius_start is not None \
        else default_radius_start(xdim, ydim)
    gdist = torch.from_numpy(grid_distances(xdim, ydim)).to(device)
    return data_padded, w0, order, gdist, bs, r0, n


def som_train(data, xdim: int = 10, ydim: int = 10, num_passes: int = 1,
              lr_start: float = 0.05, lr_end: float = 0.01, seed: int = 42,
              batch_size: Optional[int] = None,
              radius_start: Optional[float] = None,
              weights_init: Optional[np.ndarray] = None,
              *, device) -> np.ndarray:
    """Train a SOM on `device` (defaults mirror the reference: 10x10 grid,
    1 pass, lr .05 -> .01, seed 42). Returns (xdim*ydim, C) float32 weights."""
    data_padded, w0, order, gdist, bs, r0, _ = _prepare_train(
        data, xdim, ydim, num_passes, seed, batch_size, radius_start,
        weights_init, device)
    w = _train_steps(data_padded, w0, order, gdist, bs, float(lr_start),
                     float(lr_end), float(r0))
    return w.cpu().numpy()


def som_train_and_map(data, xdim: int = 10, ydim: int = 10,
                      num_passes: int = 1, lr_start: float = 0.05,
                      lr_end: float = 0.01, seed: int = 42,
                      batch_size: Optional[int] = None,
                      radius_start: Optional[float] = None,
                      weights_init: Optional[np.ndarray] = None,
                      *, device):
    """Train a SOM and assign every training row its BMU, on `device`.

    Equal to ``som_train(...)`` followed by ``som_map(weights, data)``.
    Returns (weights (K, C) f32, clusters (N,) 1-indexed, distances (N,))."""
    data_padded, w0, order, gdist, bs, r0, n = _prepare_train(
        data, xdim, ydim, num_passes, seed, batch_size, radius_start,
        weights_init, device)
    w = _train_steps(data_padded, w0, order, gdist, bs, float(lr_start),
                     float(lr_end), float(r0))
    idx, dist = bmu(w.contiguous(), data_padded, return_dist=True)
    return (w.cpu().numpy(), idx[:n].cpu().numpy() + 1,
            dist[:n].cpu().numpy())
