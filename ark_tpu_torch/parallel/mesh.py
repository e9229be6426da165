"""Process-group helpers for FOV-sharded data parallelism on torch.distributed.

Port of ``ark_tpu/parallel/mesh.py``. The JAX package shards the leading
(FOV, cell, edge or batch) axis over a 1-D ``"fov"`` device mesh; the port
runs one process a rank over a ``torch.distributed`` process group instead,
and never builds a mesh object. Every sharded function of the port takes
``group=None`` and ``device``:

- ``group=None`` is the default group when ``torch.distributed`` is
  initialized, and world size 1 otherwise. At world size 1 the same code
  runs with every collective skipped, so its results are the
  single-process results.
- Rank r owns rows ``[r * n_pad / ws, (r + 1) * n_pad / ws)`` of the
  leading axis padded to a multiple of the world size ws: the contiguous
  block order of ``P("fov")`` on a 1-D mesh. Results are all-gathered in
  rank order and the padding is dropped, so every rank returns the same
  result.
- Ranks that share one card pass the same `device`; no function derives
  ``cuda:{rank}`` itself. NCCL refuses two ranks on one card; gloo takes
  CUDA tensors (its collectives stage through host memory inside gloo).

Float partials that must not depend on the backend or the world size are
summed by ``rank_order_sum``: all-gathered, then added left to right over
the ranks. That is the order XLA's CPU ``psum`` adds the devices of a 1-D
mesh in (probed against a left-to-right sum at 2, 3, 4 and 8 devices), and
a ring or tree all-reduce of NCCL or gloo has no fixed order.
``all_reduce_sum`` is the backend's own all-reduce, for exact integers or
results held by a tolerance.

``COLLECTIVES`` counts the collectives that ran (world size > 1) and, while
its ``timed`` flag is set, their seconds on the host clock with the device
synchronised before and after each one.
"""

from __future__ import annotations

import multiprocessing
import os
import tempfile
import time
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# seconds a rank waits at init and in a collective
DEFAULT_TIMEOUT_S = 60.0


def resolve_group(group=None):
    """The process group a sharded function runs over: `group`, else the
    default group when torch.distributed is initialized, else None (world
    size 1, no collectives)."""
    if group is not None:
        return group
    if dist.is_available() and dist.is_initialized():
        return dist.group.WORLD
    return None


def world(group=None) -> int:
    """The world size of `group` (see ``resolve_group``)."""
    g = resolve_group(group)
    return 1 if g is None else dist.get_world_size(g)


def rank(group=None) -> int:
    """This process's rank in `group` (see ``resolve_group``)."""
    g = resolve_group(group)
    return 0 if g is None else dist.get_rank(g)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def shard_bounds(n: int, ws: int, r: int):
    """Rows [lo, hi) of rank `r` when `n` rows, a multiple of `ws`, split
    over `ws` ranks in contiguous blocks."""
    if n % ws:
        raise ValueError(f"shard_bounds: {n} rows do not split over {ws} ranks")
    per = n // ws
    return r * per, (r + 1) * per


def local_rows(a: np.ndarray, group=None) -> np.ndarray:
    """This rank's block of `a`'s leading axis, padded with zero rows to a
    multiple of the world size."""
    a = np.asarray(a)
    ws = world(group)
    n = a.shape[0]
    lo, hi = shard_bounds(pad_to_multiple(n, ws), ws, rank(group))
    if hi <= n:
        return a[lo:hi]
    pad = np.zeros((hi - max(lo, n),) + a.shape[1:], a.dtype)
    return np.concatenate([a[lo:n], pad])


def init_process_group(backend: str = "nccl", init_method: Optional[str] = None,
                       world_size: int = -1, rank: int = -1,
                       timeout: Optional[timedelta] = None) -> None:
    """``torch.distributed.init_process_group`` for a multi-process run (the
    port of ``initialize_multihost``): a no-op if the default group is
    already initialized; any other failure propagates."""
    try:
        dist.init_process_group(
            backend=backend, init_method=init_method, world_size=world_size,
            rank=rank, timeout=timeout or timedelta(seconds=DEFAULT_TIMEOUT_S))
    except (RuntimeError, ValueError) as e:
        # torch says "trying to initialize the default process group twice!"
        msg = str(e).lower()
        if "twice" not in msg and "already initialized" not in msg:
            raise


class CollectiveStats:
    """Collectives run (world size > 1), their payload bytes and, while
    `timed`, their host-clock seconds with the device synchronised around
    each one."""

    def __init__(self):
        self.timed = False
        self.reset()

    def reset(self) -> None:
        self.calls = 0
        self.bytes = 0
        self.seconds = 0.0

    def run(self, fn: Callable[[], None], t: torch.Tensor) -> None:
        self.calls += 1
        self.bytes += t.numel() * t.element_size()
        if not self.timed:
            fn()
            return
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        t0 = time.perf_counter()
        fn()
        if t.is_cuda:
            torch.cuda.synchronize(t.device)
        self.seconds += time.perf_counter() - t0


COLLECTIVES = CollectiveStats()


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every rank's `t` (the same shape and dtype on every rank), in rank
    order; ``[t]`` at world size 1."""
    g = resolve_group(group)
    ws = world(g)
    if ws == 1:
        return [t]
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(ws)]
    COLLECTIVES.run(lambda: dist.all_gather(parts, t, group=g), t)
    return parts


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's block of rows, concatenated in rank order."""
    parts = all_gather(t, group)
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _sum_in_rank_order(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


class _RankOrderSum(torch.autograd.Function):
    """``rank_order_sum`` under autograd. Each rank's partial reaches every
    rank's loss, so its gradient is the rank-order sum of every rank's
    gradient of the total: the same bits on every rank."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return _sum_in_rank_order(all_gather(t, group))

    @staticmethod
    def backward(ctx, grad):
        return _sum_in_rank_order(all_gather(grad, ctx.group)), None


def rank_order_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of every rank's `t`, added left to right over the ranks, the
    same bits on every rank and for every backend; `t` itself at world size
    1. Differentiable."""
    g = resolve_group(group)
    if world(g) == 1:
        return t
    if torch.is_grad_enabled() and t.requires_grad:
        return _RankOrderSum.apply(t, g)
    return _sum_in_rank_order(all_gather(t, g))


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """The backend's all-reduce (sum) of `t`, in place; its order of
    additions is the backend's (ring or tree), so the result is held by a
    tolerance unless the addends are exact integers."""
    g = resolve_group(group)
    if world(g) > 1:
        COLLECTIVES.run(lambda: dist.all_reduce(t, group=g), t)
    return t


def _rank_entry(fn, r, ws, backend, init_method, timeout_s, args):
    init_process_group(backend, init_method, ws, r, timedelta(seconds=timeout_s))
    try:
        fn(r, ws, *args)
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, world_size: int, args: tuple = (), *, backend: str,
           timeout_s: float = DEFAULT_TIMEOUT_S, join_timeout_s: Optional[float] = None,
           store_dir: Optional[str] = None) -> None:
    """Run ``fn(rank, world_size, *args)`` in `world_size` spawned processes,
    each joined to one process group (`backend`) through a FileStore in
    `store_dir` (a new temporary directory by default): no TCP port is
    taken. `fn` must be importable by name (a module-level function) and
    hands its results back through files or `args`. Each rank waits at most
    `timeout_s` at init and in a collective; the whole run gets
    `join_timeout_s` (default `timeout_s` plus a minute of start-up), after
    which every rank still running is killed. Raises RuntimeError if a rank
    hangs or exits non-zero."""
    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        init_method = f"file://{os.path.join(store_dir or tmp, 'store')}"
        procs = [ctx.Process(target=_rank_entry, args=(
            fn, r, world_size, backend, init_method, timeout_s, args))
            for r in range(world_size)]
        for p in procs:
            p.start()
        join_s = timeout_s + 60.0 if join_timeout_s is None else join_timeout_s
        deadline = time.monotonic() + join_s
        try:
            for p in procs:
                p.join(max(deadline - time.monotonic(), 0.0))
        finally:
            hung = [r for r, p in enumerate(procs) if p.is_alive()]
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        if hung:
            raise RuntimeError(f"launch: ranks {hung} of {world_size} did not finish "
                               f"within {join_s:.0f} s and were killed")
        failed = {r: p.exitcode for r, p in enumerate(procs) if p.exitcode != 0}
        if failed:
            raise RuntimeError(f"launch: ranks exited non-zero (rank: code) {failed}")
