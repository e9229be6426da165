"""Mesmer PanopticNet training on PyTorch: the deep-watershed loss, optax's
Adam and the fit loop.

Port of ``ark_tpu/segmentation/train.py``. The dataset and its targets stay
on the device for the whole fit, step t trains on the rows the JAX package's
seeded numpy schedule gives it, and the per-step losses are read back once,
at the end. Batch norm runs in flax's train mode (``PanopticNet.train()``).
The optimizer is ``optax.adam`` written out in optax's order of operations.
On CUDA the fit runs with cuDNN's deterministic algorithms, and the
network's resizes take their product form under autograd, so no backward
scatters with float atomics: two runs give the same bits. Where the JAX
package runs the schedule as one jitted ``lax.scan``, the port captures one
step (row selection, forward, backward, Adam, the loss write) in a CUDA
graph after a few eager steps and replays it: the same kernels on the same
buffers, without the host's ~2,000 launches a step.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ark_tpu_torch.models import unet
from ark_tpu_torch.parallel import mesh
from ark_tpu_torch.segmentation import mesmer, synthetic

# eager steps before a CUDA fit captures its step (PyTorch warms a captured
# region up on a side stream first)
GRAPH_WARMUP = 3
# the architecture a mini checkpoint records (ark_tpu/segmentation/train.py:180)
MINI_CHECKPOINT_CONFIG = {"stage_sizes": [1, 1, 1, 1], "base_width": 16,
                          "fpn_channels": 64, "head_upsample_filters": 32,
                          "head_dense_features": 64, "inner_activation": "linear",
                          "dtype": "float32"}


def mesmer_loss(out: Dict[str, torch.Tensor], targets: Dict[str, torch.Tensor],
                pixelwise_weight: float = 1.0, inner_weight: float = 1.0):
    """MSE on the inner-distance heads plus cross-entropy on the pixelwise
    heads, summed over the compartments present in `targets`
    ('<comp>_inner_distance': (B, H, W), '<comp>_pixelwise': (B, H, W, 3)
    one-hot)."""
    loss = 0.0
    for comp in mesmer.COMPARTMENTS:
        t_inner = targets.get(f"{comp}_inner_distance")
        if t_inner is not None:
            pred = out[f"{comp}_inner_distance"][..., 0]
            loss = loss + inner_weight * torch.mean((pred - t_inner) ** 2)
        t_pix = targets.get(f"{comp}_pixelwise")
        if t_pix is not None:
            ce = -torch.sum(t_pix * torch.log(out[f"{comp}_pixelwise"] + 1e-7), dim=-1)
            loss = loss + pixelwise_weight * torch.mean(ce)
    return loss


class Adam:
    """``optax.adam(learning_rate)`` over a list of tensors, in optax's order
    (``scale_by_adam`` then ``scale(-lr)``): mu = (1 - b1) g + b1 mu,
    nu = (1 - b2) g^2 + b2 nu, each divided by 1 - b^t, mu_hat /
    (sqrt(nu_hat) + eps), times -lr, added to the parameter. Each step is a
    handful of ``torch._foreach_*`` launches, and the step count and the
    bias corrections live on the device, so a CUDA graph can replay a step.
    A gradient of None (a tensor the loss does not reach, as FPN's P4-P7)
    counts as zero, as JAX's gradient is there. The root is correctly
    rounded on every device: CUDA's f32 sqrt is, torch's CPU one is not, so
    on the CPU it is taken in f64 and rounded to f32 (exact for a root)."""

    def __init__(self, params: Sequence[torch.Tensor], learning_rate: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = list(params)
        self.lr, self.b1, self.b2, self.eps = learning_rate, b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.count = torch.zeros((), dtype=torch.float32, device=self.params[0].device)
        self._zeros: Dict[int, torch.Tensor] = {}

    def _dense(self, grads) -> List[torch.Tensor]:
        out = []
        for i, g in enumerate(grads):
            if g is None:
                if i not in self._zeros:
                    self._zeros[i] = torch.zeros_like(self.params[i])
                g = self._zeros[i]
            out.append(g)
        return out

    def update(self, grads) -> List[torch.Tensor]:
        """The updates for `grads` (one per parameter), advancing the state."""
        g = self._dense(grads)
        b1, b2 = self.b1, self.b2
        self.count.add_(1)
        torch._foreach_mul_(self.mu, b1)
        torch._foreach_add_(self.mu, torch._foreach_mul(g, 1 - b1))
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_add_(self.nu, torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2))
        # the bias corrections in f32, as optax computes 1 - b ** count
        mu_hat = torch._foreach_div(self.mu, 1 - torch.pow(b1, self.count))
        nu_hat = torch._foreach_div(self.nu, 1 - torch.pow(b2, self.count))
        if self.params[0].is_cuda:
            den = torch._foreach_sqrt(nu_hat)
        else:
            den = [torch.sqrt(v.to(torch.float64)).to(torch.float32) for v in nu_hat]
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(mu_hat, den)
        torch._foreach_mul_(upd, -self.lr)
        return upd

    @torch.no_grad()
    def step(self, grads) -> None:
        torch._foreach_add_(self.params, self.update(grads))


def minibatch_order(n: int, steps: int, batch_size: int, seed: int) -> np.ndarray:
    """(steps, batch_size) rows: a seeded reshuffle of the n rows with wrap,
    the JAX package's schedule (numpy ``default_rng(seed)``)."""
    host_rng = np.random.default_rng(seed)
    reps = (steps * batch_size + n - 1) // n
    order = np.concatenate([host_rng.permutation(n) for _ in range(reps)])
    return order[: steps * batch_size].reshape(steps, batch_size).astype(np.int64)


@contextlib.contextmanager
def training_precision(model):
    """The numerics a step runs under: an f32 model with TF32 off (the
    precision the CPU and the JAX package compute in), and cuDNN's
    deterministic algorithms with autotuning off."""
    cudnn = torch.backends.cudnn
    f32 = unet.full_f32() if model.dtype == torch.float32 else contextlib.nullcontext()
    with f32, cudnn.flags(enabled=cudnn.enabled, benchmark=False, deterministic=True,
                          allow_tf32=cudnn.allow_tf32):
        yield


def train_step(model, opt: Adam, x: torch.Tensor, targets: Dict[str, torch.Tensor],
               inner_weight: float = 10.0) -> torch.Tensor:
    """One step: the train-mode forward (which moves the batch-norm running
    averages), the loss, its gradients and Adam's update. Returns the loss,
    detached, on the device."""
    loss = mesmer_loss(model(x), targets, inner_weight=inner_weight)
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    opt.step(grads)
    return loss.detach()


# the JAX package's dry run steps with optax.sgd(1e-3)
DRYRUN_LEARNING_RATE = 1e-3


def _dryrun_loss_sums(out: Dict[str, torch.Tensor], y_dist: torch.Tensor,
                      y_pix: torch.Tensor) -> torch.Tensor:
    """This process's [sum of squared inner-distance errors, sum of
    y . log(p + 1e-7)] of the whole-cell heads: the two sums whose global
    means make the JAX package's ``dryrun_multichip`` loss."""
    sq = torch.sum((out["whole_cell_inner_distance"][..., 0] - y_dist) ** 2)
    ce = torch.sum(y_pix * torch.log(out["whole_cell_pixelwise"] + 1e-7))
    return torch.stack([sq, ce])


def sharded_train_step(model, x: torch.Tensor, y_dist: torch.Tensor, y_pix: torch.Tensor, *,
                       group=None):
    """One step of the JAX package's batch-sharded Mesmer step (its
    ``dryrun_multichip``: ``optax.sgd(1e-3)``, parameters replicated, the
    batch split over the ranks), with the semantics of one ``jax.jit`` over
    the global batch: every train-mode batch norm takes mean and E[x^2]
    over the global batch (rank-order sums, through autograd), and the loss
    is the global mean MSE of the whole-cell inner distance plus the global
    mean cross-entropy -sum(y log(p + 1e-7)) of its pixelwise head.

    Each rank passes its own rows of the batch (x (b, H, W, 2), y_dist
    (b, H, W), y_pix (b, H, W, 3), the same b on every rank, on the model's
    device). The gradients are summed with the backend's all-reduce: they
    are float sums whose order is the backend's, so they are held to the
    reference by a tolerance (the JAX package's own f32 gradients sit
    2.6e-4 from float64), and every rank gets the same sum. Then plain SGD:
    p + (-DRYRUN_LEARNING_RATE) g, as optax adds its update. Returns
    (global loss, 0-d tensor; {parameter name: global gradient, or None
    where the loss does not reach it}), the same on every rank; the
    parameters and running averages are updated in place."""
    g = mesh.resolve_group(group)
    ws = mesh.world(g)
    count = torch.tensor(float(x.shape[0] * ws * x.shape[1] * x.shape[2]), device=x.device)

    def reduce(sums, n):
        return mesh.rank_order_sum(sums, g), n * ws

    model.train()
    names, params = zip(*model.named_parameters())
    with training_precision(model), unet.global_batch_stats(model, reduce):
        sums = _dryrun_loss_sums(model(x), y_dist, y_pix)
        grads = torch.autograd.grad(sums[0] / count - sums[1] / count, params,
                                    allow_unused=True)
    live = [i for i, gr in enumerate(grads) if gr is not None]
    if ws > 1 and live:
        flat = mesh.all_reduce_sum(torch.cat([grads[i].reshape(-1) for i in live]), g)
        grads = list(grads)
        for i, part in zip(live, flat.split([grads[i].numel() for i in live])):
            grads[i] = part.view_as(grads[i])
    with torch.no_grad():
        torch._foreach_add_([params[i] for i in live], torch._foreach_mul(
            [grads[i] for i in live], -DRYRUN_LEARNING_RATE))
    total = mesh.rank_order_sum(sums.detach(), g)
    return total[0] / count - total[1] / count, dict(zip(names, grads))


def _on(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _run_schedule(model, opt: Adam, x_all, t_all, order, losses, inner_weight) -> None:
    """Every step of `order` (steps, batch) on the device. The step index
    lives on the device too, so one step is the same launches each time; on
    CUDA, after GRAPH_WARMUP eager steps on a side stream, the step is
    captured in a CUDA graph and replayed."""
    step = torch.zeros(1, dtype=torch.int64, device=x_all.device)

    def one_step():
        rows = order.index_select(0, step).view(-1)
        loss = train_step(model, opt, x_all.index_select(0, rows),
                          {k: v.index_select(0, rows) for k, v in t_all.items()},
                          inner_weight)
        losses.index_copy_(0, step, loss.view(1))
        step.add_(1)

    steps = order.shape[0]
    if x_all.device.type != "cuda" or steps <= GRAPH_WARMUP:
        for _ in range(steps):
            one_step()
        return
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(GRAPH_WARMUP):
            one_step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        one_step()
    for _ in range(steps - GRAPH_WARMUP):
        graph.replay()


def fit(model, images, targets: Dict, steps: int = 300, batch_size: int = 4,
        learning_rate: float = 1e-3, seed: int = 42, scan_chunk: Optional[int] = None,
        inner_weight: float = 10.0, *, device="cuda"):
    """Train `model` on (images, targets) on `device`; returns (model in
    eval mode, loss curve as numpy). Step t takes rows ``minibatch_order``[t].
    `scan_chunk` is accepted for the JAX package's signature and changes
    nothing: on CUDA every step after the warm-up is one graph replay, and
    only the loss curve is read back, once."""
    del scan_chunk
    dev = torch.device(device)
    order = torch.from_numpy(minibatch_order(images.shape[0], steps, batch_size,
                                             seed)).to(dev)
    x_all = _on(images, dev)
    t_all = {k: _on(v, dev) for k, v in targets.items()}
    model.to(dev).train()
    opt = Adam(model.parameters(), learning_rate)
    losses = torch.empty(steps, dtype=torch.float32, device=dev)
    with training_precision(model):
        _run_schedule(model, opt, x_all, t_all, order, losses, inner_weight)
    return model.eval(), losses.cpu().numpy()


def train_on_synthetic(steps: int = 400, n_images: int = 24, hw: int = 64,
                       seed: int = 42, mini: bool = True, learning_rate: float = 1e-3,
                       weights_out: Optional[str] = None, *, device="cuda"):
    """Train a PanopticNet on planted synthetic cells (half spaced, half
    crowded) on `device` until the deep-watershed postprocess recovers
    instances. Returns (a ready ``Mesmer``, the loss curve); saves `.npz`
    weights in the JAX package's format when `weights_out` is given.
    `mini=True` trains the mini configuration, `mini=False` the full
    published one in f32. The seeded init is torch's (flax's random streams
    cannot be drawn in torch); the images, targets and schedule are the JAX
    package's for the same seed."""
    rng = np.random.default_rng(seed)
    n_sp = n_images - n_images // 2
    imgs_a, cl_a, nl_a = synthetic.synthetic_cells(rng, n_sp, hw=hw)
    imgs_b, cl_b, nl_b = synthetic.synthetic_cells(rng, n_images // 2, hw=hw,
                                                   crowding=0.35)
    images = np.concatenate([imgs_a, imgs_b])
    cell_t = synthetic.targets_from_labels(np.concatenate([cl_a, cl_b]), device=device)
    nuc_t = synthetic.targets_from_labels(np.concatenate([nl_a, nl_b]), device=device)
    targets = {
        "whole_cell_inner_distance": cell_t["inner_distance"],
        "whole_cell_pixelwise": cell_t["pixelwise"],
        "nuclear_inner_distance": nuc_t["inner_distance"],
        "nuclear_pixelwise": nuc_t["pixelwise"],
    }
    if mini:
        model = unet.init_mesmer_mini(seed=seed, device=device)
    else:
        model = unet.init_mesmer(seed=seed, dtype=torch.float32, device=device)
    # train on the normalization predict applies
    x_norm = mesmer._percentile_normalize(_on(images, torch.device(device)))
    model, losses = fit(model, x_norm, targets, steps=steps,
                        learning_rate=learning_rate, seed=seed, device=device)
    if weights_out is not None:
        config = MINI_CHECKPOINT_CONFIG if mini else {"dtype": "float32"}
        unet.save_params_npz(weights_out, model, config=config)
    return mesmer.Mesmer(model=model, device=device), losses
