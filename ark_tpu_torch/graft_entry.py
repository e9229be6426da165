"""The port's analog of ``__graft_entry__``: the flagship model's forward
step, and the multi-process dry run of every sharded stage.

``entry(device=...)`` returns ``(forward, (model, x))``: the published
Mesmer PanopticNet (ResNet50, 256-channel FPN, 64/128-wide heads) in f32
with seeded weights on `device`, a (1, 128, 128, 2) input, and a forward
that returns the whole-cell inner-distance and pixelwise heads, without
autograd and with TF32 off.

``dryrun_multigpu(world_size, backend=..., device=...)`` is the analog of
``dryrun_multichip``: it spawns `world_size` ranks joined in one
torch.distributed process group and runs, in the JAX package's order, the
batch-sharded Mesmer SGD step, the sharded SOM schedule and one sharded SOM
step, the FOV-sharded pixel cohort (world size + 1 FOVs, so one rank
pads), the per-FOV quantification (segment sums), the enrichment null and
observed product, the per-FOV deep-watershed flood under both engines, the
fiber cohort, one cell-sharded LDA EM step and one edge-sharded UMAP epoch.
Every rank's results must be equal; rank 0's come back, with each rank's
kernel launches, and one summary line is printed. ``dryrun_inputs`` makes
the JAX dry run's own tiny inputs from its seed; a caller may pass larger
ones of the same keys (``inputs=``, an ``.npz`` path). On one card NCCL
takes world size 1 only; gloo ranks may share it.
"""

from __future__ import annotations

import copy
import hashlib
import os
import tempfile
import time
from typing import Dict, Optional

import numpy as np
import torch

from ark_tpu_torch.models import unet
from ark_tpu_torch.parallel import mesh


def entry(*, device="cuda"):
    """Return (forward, (model, x)) for one Mesmer forward on `device`."""
    model = unet.init_mesmer(seed=0, dtype=torch.float32, device=device)

    def forward(model, x):
        with torch.inference_mode(), unet.full_f32():
            out = model(x)
        return out["whole_cell_inner_distance"], out["whole_cell_pixelwise"]

    x = torch.ones((1, 128, 128, 2), dtype=torch.float32, device=device)
    return forward, (model, x)


def dryrun_inputs(n: int) -> Dict[str, np.ndarray]:
    """The JAX dry run's inputs for `n` devices, drawn in its order from
    ``np.random.default_rng(0)``. Its UMAP key becomes the port's seed 0 and
    its permutation-null seed 42 the port's generator seed."""
    rng = np.random.default_rng(0)
    c = 8
    inp = {"x": np.ones((n, 64, 64, 2), np.float32),
           "y_dist": np.zeros((n, 64, 64), np.float32),
           "y_pix": np.tile(np.array([1.0, 0.0, 0.0], np.float32), (n, 64, 64, 1))}
    inp["som_data"] = rng.random((128 * n, 8)).astype(np.float32)
    inp["som_w0"] = rng.random((100, 8)).astype(np.float32)
    inp["pixel_imgs"] = rng.random((n + 1, 16, 16, c)).astype(np.float32)
    inp["channel_norms"] = np.full(c, 0.9, np.float32)
    inp["post_norms"] = np.full(c, 0.8, np.float32)
    inp["pixel_thresh"] = np.float32(0.05)
    inp["pixel_weights"] = rng.random((100, c)).astype(np.float32)
    inp["quant_labels"] = rng.integers(0, 6, (n, 16, 16)).astype(np.int32)
    inp["quant_imgs"] = rng.random((n, 16, 16, c)).astype(np.float32)
    inp["quant_segments"] = np.int64(6)
    inp["enrich_coords"] = rng.random((n, 24, 2)).astype(np.float32) * 100
    inp["enrich_pos"] = (rng.random((n, 5, 24)) < 0.3).astype(np.float32)
    inp["enrich_dist_lim"] = np.float32(30.0)
    inp["enrich_boots"] = np.int64(8)
    inp["flood_elev"] = rng.random((n, 16, 16)).astype(np.float32)
    markers = np.zeros((n, 16, 16), np.int32)
    markers[:, 4, 4] = 1
    markers[:, 12, 12] = 2
    inp["flood_markers"] = markers
    inp["flood_mask"] = np.ones((n, 16, 16), bool)
    inp["flood_levels"] = np.int64(16)
    inp["flood_rounds"] = np.int64(4)
    inp["fiber_imgs"] = rng.random((n + 1, 16, 16)).astype(np.float32)
    inp["fiber_widths"] = np.array([1, 2])
    n_cells, n_feats, n_topics = 8 * n, 6, 3
    inp["lda_X"] = rng.integers(0, 5, (n_cells, n_feats)).astype(np.float32)
    inp["lda_L"] = ((np.eye(n_cells) * 2 - np.eye(n_cells, k=1) - np.eye(n_cells, k=-1))
                    .astype(np.float32) / 4)
    inp["lda_lam"] = rng.random((n_topics, n_feats)).astype(np.float32) + 0.5
    inp["lda_gamma"] = np.ones((n_cells, n_topics), np.float32)
    n_pts, n_edges = 16, 8 * n
    inp["umap_emb"] = rng.random((n_pts, 2)).astype(np.float32)
    inp["umap_heads"] = rng.integers(0, n_pts, n_edges)
    inp["umap_tails"] = rng.integers(0, n_pts, n_edges)
    inp["umap_weights"] = rng.random(n_edges).astype(np.float32)
    return inp


def mesmer_model(mini: bool, device):
    """The dry run's seeded network on `device`: the published
    configuration in f32, or the mini one."""
    if mini:
        return unet.init_mesmer_mini(seed=0, device=device)
    return unet.init_mesmer(seed=0, dtype=torch.float32, device=device)


def mesmer_result(model, loss, grads) -> Dict[str, np.ndarray]:
    """A Mesmer step's (loss, {name: gradient or None}), as
    ``train.sharded_train_step`` returns them, and `model`'s running
    averages after it, as numpy: 'loss', 'grad/<name>' for every parameter
    the loss reaches, 'unreached' (the others' names) and 'stat/<name>'."""
    res = {"loss": loss.detach().cpu().numpy(),
           "unreached": np.array(sorted(k for k, v in grads.items() if v is None))}
    res.update({f"grad/{k}": v.cpu().numpy() for k, v in grads.items() if v is not None})
    res.update({f"stat/{k}": v.cpu().numpy() for k, v in model.named_buffers()})
    return res


def _synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def dryrun_stages(inp: Dict[str, np.ndarray], *, mini: bool, device, group=None
                  ) -> Dict[str, Dict[str, np.ndarray]]:
    """Every sharded stage of the dry run on `inp` (``dryrun_inputs``' keys;
    the LDA's Laplacian may come as FOV blocks 'lda_block/<first row>'
    instead of the dense 'lda_L') over `group` on `device`. Returns
    {stage: {name: numpy array}}, the same on every rank, with each stage's
    host seconds under 'seconds' and its collectives' under
    'collective_seconds' (``mesh.COLLECTIVES``, if timed). Mesmer's step
    runs once on a copy of the model first, so that its timed step does not
    pay cuDNN's first-call set-up; its seconds are the step's alone (its
    results are copied to the host after the timer stops)."""
    from ark_tpu_torch.analysis import spatial_enrichment as se
    from ark_tpu_torch.ops import distances, segment_reduce, som, umap, watershed
    from ark_tpu_torch.parallel import cohort
    from ark_tpu_torch.segmentation import train
    from ark_tpu_torch.spLDA import model as lda_model

    g = mesh.resolve_group(group)
    out, seconds, coll = {}, {}, {}

    def timed(name, fn):
        _synchronize(device)
        t0, c0 = time.perf_counter(), mesh.COLLECTIVES.seconds
        result = fn()
        _synchronize(device)
        seconds[name] = time.perf_counter() - t0
        coll[name] = mesh.COLLECTIVES.seconds - c0
        out[name] = result

    def as_np(t):
        return t.detach().cpu().numpy()

    # ---- Mesmer: the batch split over the ranks, parameters replicated
    model = mesmer_model(mini, device)
    batch = [torch.as_tensor(mesh.local_rows(inp[k], g), device=device)
             for k in ("x", "y_dist", "y_pix")]
    train.sharded_train_step(copy.deepcopy(model), *batch, group=g)      # warm-up
    timed("mesmer", lambda: train.sharded_train_step(model, *batch, group=g))
    out["mesmer"] = mesmer_result(model, *out["mesmer"])

    # ---- SOM: the sharded schedule, then one sharded step
    def som_stages():
        w_trained = som.som_train_sharded(inp["som_data"], xdim=10, ydim=10, seed=0,
                                          device=device, group=g)
        step = som.make_sharded_train_step(group=g)
        w0 = torch.as_tensor(inp["som_w0"], device=device)
        gdist = torch.from_numpy(som.grid_distances(10, 10)).to(device)
        x_local = torch.as_tensor(mesh.local_rows(inp["som_data"], g), device=device)
        w1 = step(w0, x_local, 0.05, 2.0, gdist)
        return {"w_trained": w_trained, "w0": inp["som_w0"], "w1": as_np(w1)}

    timed("som", som_stages)
    timed("pixel", lambda: cohort.run_pixel_cohort(
        inp["pixel_imgs"], inp["channel_norms"], float(inp["pixel_thresh"]),
        inp["post_norms"], inp["pixel_weights"], device=device, group=g))

    n_seg = int(inp["quant_segments"])

    def quant_one(img, lab):
        feats, sums = segment_reduce.moment_and_channel_features(img, lab, n_seg)
        return {"area": feats["area"], "channel_sums": sums}

    timed("quant", lambda: cohort.map_over_fovs(
        quant_one, (inp["quant_imgs"], inp["quant_labels"]), device=device, group=g))

    perms = se.draw_permutations(inp["enrich_pos"].shape[2], int(inp["enrich_boots"]), 42)

    def enrich_one(co, po):
        dist_bin = distances.close_pairs(distances.pairwise_distances(co, co),
                                         float(inp["enrich_dist_lim"]))
        null = se._permutation_null(dist_bin, po, perms.to(po.device))
        return {"observed": po @ dist_bin @ po.T, "null_mean": null.mean(0)}

    timed("enrichment", lambda: cohort.map_over_fovs(
        enrich_one, (inp["enrich_coords"], inp["enrich_pos"]), device=device, group=g))

    levels, rounds = int(inp["flood_levels"]), int(inp["flood_rounds"])

    def flood_one(e, m, mask):
        lab, done = watershed._quantize_and_flood(e[None], m[None], mask[None], levels,
                                                  rounds)
        return {"labels": lab[0], "done": torch.as_tensor(bool(done), device=e.device)}

    def floods():
        engine = watershed._ENGINE
        res = {}
        try:
            for name in ("levels", "minimax"):
                watershed._ENGINE = name
                for k, v in cohort.map_over_fovs(
                        flood_one, (inp["flood_elev"], inp["flood_markers"],
                                    inp["flood_mask"]), device=device, group=g).items():
                    res[f"{name}/{k}"] = v
        finally:
            watershed._ENGINE = engine
        return res

    timed("flood", floods)
    timed("fiber", lambda: cohort.run_fiber_cohort(
        inp["fiber_imgs"], fiber_widths=tuple(int(w) for w in inp["fiber_widths"]),
        device=device, group=g))

    def lda_step():
        k = inp["lda_lam"].shape[0]
        lap = inp.get("lda_L")
        if lap is None:
            lap = sorted(((int(key.split("/")[1]), torch.as_tensor(v, device=device))
                          for key, v in inp.items() if key.startswith("lda_block/")),
                         key=lambda block: block[0])
        lam, gamma = lda_model.em_step_sharded(
            inp["lda_X"], inp["lda_lam"], inp["lda_gamma"], lap,
            alpha=1.0 / k, eta=1.0 / k, penalty=0.1, device=device, group=g)
        return {"lam": as_np(lam), "gamma": as_np(gamma)}

    timed("lda", lda_step)
    timed("umap", lambda: {"emb": as_np(umap.umap_epoch_sharded(
        inp["umap_emb"], inp["umap_heads"], inp["umap_tails"], inp["umap_weights"],
        lr=1.0, seed=0, device=device, group=g))})
    out["seconds"] = {k: np.float64(v) for k, v in seconds.items()}
    out["collective_seconds"] = {k: np.float64(v) for k, v in coll.items()}
    return out


def summary(res) -> Dict[str, float]:
    """The JAX dry run's printed quantities of a ``dryrun_stages`` result."""
    pix, mes = res["pixel"], res["mesmer"]
    return {
        "mesmer loss": float(mes["loss"]),
        "som |dW|": float(np.abs(res["som"]["w1"] - res["som"]["w0"]).sum()),
        "sharded-train |W|": float(np.abs(res["som"]["w_trained"]).sum()),
        "pixel-cohort clusters": int(pix["som_clusters"].max()),
        "quant area_sum": float(res["quant"]["area"].sum()),
        "enrichment |obs-null|": float(np.abs(res["enrichment"]["observed"]
                                               - res["enrichment"]["null_mean"]).mean()),
        "watershed labels": int(res["flood"]["levels/labels"].max()),
        "fiber elev_sum": float(res["fiber"]["elevation_map"].sum()),
        "lda gamma_sum": float(res["lda"]["gamma"].sum()),
        "umap |demb|": float(np.abs(res["umap"]["emb"]).sum()),
    }


def _digest(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    return hashlib.sha256(str((a.dtype, a.shape)).encode() + a.tobytes()).hexdigest()


def _digests(res) -> Dict[str, str]:
    return {f"{stage}/{k}": _digest(np.asarray(v)) for stage, part in res.items()
            if stage not in ("seconds", "collective_seconds")
            for k, v in part.items()}


def _load_inputs(inputs, n: int) -> Dict[str, np.ndarray]:
    if inputs is None:
        return dryrun_inputs(n)
    with np.load(inputs) as f:
        return {k: f[k] for k in f.files}


def _dryrun_rank(r: int, ws: int, inputs, mini: bool, device, out_dir) -> None:
    """One rank of ``dryrun_multigpu``: every stage, then its results (rank
    0), its digests and its kernel launches, written to `out_dir`."""
    from ark_tpu_torch.ops import segment_reduce, som, watershed

    if torch.device(device).type == "cuda":
        torch.cuda.set_device(device)
    counters = {"bmu": som.bmu, "claim_round": watershed.claim_round,
                "claim_levels": watershed.claim_levels,
                "minimax_relabel": watershed.minimax_relabel,
                "minimax_relax": watershed.minimax_relax,
                "segment_sum": segment_reduce.segment_sum,
                "segment_plan": segment_reduce.segment_plan}
    for fn in counters.values():
        fn.launches = 0
    mesh.COLLECTIVES.reset()
    mesh.COLLECTIVES.timed = True
    res = dryrun_stages(_load_inputs(inputs, ws), mini=mini, device=device)
    report = {"digests": _digests(res), "seconds": res["seconds"],
              "collective_seconds": res["collective_seconds"],
              "launches": {k: fn.launches for k, fn in counters.items()},
              "collectives": {"calls": mesh.COLLECTIVES.calls,
                              "bytes": mesh.COLLECTIVES.bytes,
                              "seconds": mesh.COLLECTIVES.seconds}}
    if r == 0:
        report["results"] = res
    torch.save(report, os.path.join(out_dir, f"rank{r}.pt"))


def dryrun_multigpu(world_size: int, *, backend: str = "nccl", device="cuda",
                    mini: bool = False, inputs: Optional[str] = None,
                    timeout_s: float = 300.0):
    """Run every sharded stage in `world_size` spawned ranks over one
    process group (`backend`), each rank on `device` (ranks sharing a card
    pass the same one), and check that every rank's results are the same.

    `mini` runs Mesmer's mini configuration instead of the published
    network; `inputs` is an ``.npz`` of ``dryrun_inputs``' keys (default:
    the JAX dry run's own inputs for `world_size` devices). A rank that
    hangs is killed after `timeout_s` (plus a start-up allowance) and
    raises, as does a rank that fails. Each rank times its collectives
    (``mesh.COLLECTIVES.timed``), so the stage seconds include the device
    synchronisations around each collective.
    Returns rank 0's ``dryrun_stages`` result, with 'launches' (each rank's
    kernel launches), 'collectives' (each rank's count, bytes and seconds)
    and 'wall_s' (the spawn-to-join seconds)."""
    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        mesh.launch(_dryrun_rank, world_size,
                    (inputs, mini, device, out_dir), backend=backend,
                    timeout_s=timeout_s)
        wall = time.perf_counter() - t0
        reports = [torch.load(os.path.join(out_dir, f"rank{r}.pt"), weights_only=False)
                   for r in range(world_size)]
    res = reports[0]["results"]
    for r, rep in enumerate(reports):
        differ = sorted(k for k, v in reports[0]["digests"].items()
                        if rep["digests"].get(k) != v)
        if differ:
            raise RuntimeError(f"dryrun_multigpu: rank {r}'s results differ from rank "
                               f"0's in {differ}")
    res["launches"] = [rep["launches"] for rep in reports]
    res["collectives"] = [rep["collectives"] for rep in reports]
    res["rank_seconds"] = [rep["seconds"] for rep in reports]
    res["rank_collective_seconds"] = [rep["collective_seconds"] for rep in reports]
    res["wall_s"] = wall
    line = ", ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
                     for k, v in summary(res).items())
    print(f"dryrun_multigpu OK on {world_size} ranks ({backend}, {device}): {line}")
    return res
