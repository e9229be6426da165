"""The rank side of tests/test_torch_parallel.py: every sharded function of
the PyTorch port on one input set, in one process of a gloo group (or in
the test's own process, with no group, at world size 1).

This module imports torch and the port only, never jax: the spawned ranks
import it by name, and each reports whether jax was loaded.
"""

import os
import sys

import numpy as np
import torch

from ark_tpu_torch.models import unet
from ark_tpu_torch.ops import som
from ark_tpu_torch.ops import umap
from ark_tpu_torch.parallel import cohort, mesh
from ark_tpu_torch.segmentation import train
from ark_tpu_torch.spLDA import model as lda_model


def _np(t):
    return t.detach().cpu().numpy()


def compute(inp, group=None):
    """Every sharded function of the port on `inp` (the test's inputs), on
    the CPU, over `group`. Returns {name: numpy array or dict of them}."""
    g = mesh.resolve_group(group)
    ws, r = mesh.world(g), mesh.rank(g)
    dev = "cpu"
    out = {"world": np.array([ws, r])}
    out["pixel"] = cohort.run_pixel_cohort(
        inp["pixel_imgs"], inp["channel_norms"], inp["pixel_thresh"], inp["post_norms"],
        inp["pixel_weights"], device=dev, group=g)
    out["fiber"] = cohort.run_fiber_cohort(inp["fiber_imgs"], fiber_widths=(1, 2),
                                           device=dev, group=g)
    out["percentiles"] = cohort.cohort_channel_percentiles(inp["pct_imgs"], 0.99,
                                                           device=dev, group=g)
    out["map_pairs"] = cohort.map_over_fovs(
        lambda a, b: (a * b, a.sum()), (inp["fiber_imgs"], inp["fiber_imgs"] + 1),
        device=dev, group=g)
    calls = mesh.COLLECTIVES.calls
    out["som"] = som.som_train_sharded(inp["som_data"], seed=3, device=dev, group=g)
    out["som_collectives"] = np.array(mesh.COLLECTIVES.calls - calls)
    step = som.make_sharded_train_step(group=g)
    out["som_step"] = _np(step(
        torch.as_tensor(inp["step_w0"]), torch.as_tensor(mesh.local_rows(inp["step_x"], g)),
        0.05, 2.0, torch.from_numpy(som.grid_distances(10, 10))))
    k = inp["lda_lam"].shape[0]
    lda_kw = dict(alpha=1.0 / k, eta=1.0 / k, penalty=0.1, e_steps=5, device=dev, group=g)
    lam, gamma = lda_model.em_step_sharded(inp["lda_X"], inp["lda_lam"], inp["lda_gamma"],
                                           inp["lda_L"], **lda_kw)
    out["lda"] = {"lam": _np(lam), "gamma": _np(gamma)}
    blocks = [(int(first), torch.as_tensor(b)) for first, b in inp["lda_blocks"]]
    lam, gamma = lda_model.em_step_sharded(inp["lda_X"], inp["lda_lam"], inp["lda_gamma"],
                                           blocks, **lda_kw)
    out["lda_blocks"] = {"lam": _np(lam), "gamma": _np(gamma)}
    umap_args = (inp["umap_emb"], inp["umap_heads"], inp["umap_tails"], inp["umap_w"])
    out["umap"] = _np(umap.umap_epoch_sharded(
        *umap_args, lr=1.0, negative_sample_rate=inp["umap_negs"].shape[0],
        negatives=inp["umap_negs"], device=dev, group=g))
    out["umap_attract"] = _np(umap.umap_epoch_sharded(
        *umap_args, lr=0.7, negative_sample_rate=0, device=dev, group=g))
    out["umap_seeded"] = _np(umap.umap_epoch_sharded(*umap_args, lr=1.0, seed=5,
                                                     device=dev, group=g))
    for name in ("mesmer", "mesmer_halves"):
        if f"{name}_x" in inp:
            out[name] = mesmer_step(inp, name, g)
    return out


def mesmer_step(inp, name, group=None):
    """``sharded_train_step`` of the mini network from `inp`'s state on this
    rank's rows of the batch `inp`[name + '_x' etc.]."""
    model = unet.PanopticNet(dtype=torch.float32, **unet.MINI_CONFIG)
    model.load_state_dict(inp["mesmer_state"])
    x, y_dist, y_pix = (torch.as_tensor(mesh.local_rows(inp[f"{name}_{k}"], group))
                        for k in ("x", "y_dist", "y_pix"))
    loss, grads = train.sharded_train_step(model, x, y_dist, y_pix, group=group)
    return {"loss": _np(loss),
            "grads": {k: _np(v) for k, v in grads.items() if v is not None},
            "unreached": sorted(k for k, v in grads.items() if v is None),
            "params": {k: _np(v) for k, v in model.named_parameters()},
            "stats": {k: _np(v) for k, v in model.named_buffers()}}


def run_rank(r, ws, in_path, out_dir):
    """One rank: a second init must be a no-op, then ``compute``; the result
    and whether jax was loaded go to `out_dir`/rank<r>.pt."""
    torch.set_num_threads(1)
    mesh.init_process_group("gloo", world_size=ws, rank=r)   # already initialized
    inp = torch.load(in_path, weights_only=False)
    out = compute(inp)
    out["jax_loaded"] = "jax" in sys.modules
    torch.save(out, os.path.join(out_dir, f"rank{r}.pt"))


def hang(r, ws, seconds):
    """A rank that does not finish in time."""
    import time

    time.sleep(seconds)


def fail(r, ws):
    """A rank that raises on rank 1."""
    if r == 1:
        raise RuntimeError("rank 1 fails on purpose")
