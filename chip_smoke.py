"""Smoke run of the PyTorch port (ark_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels (ark_tpu_torch/csrc/*.cu, one nvcc each,
started together) and drives these paths on the card:

- the Pixie pixel clustering stage (template 2): the BMU kernel against its
  plain torch version at the stage's shapes, run_pixel_clustering (consensus
  included) from 4 x 1024^2 x 16 channel TIFFs written by the port's codec,
  then the pixel masks, held bitwise to the same device phases run in memory
  (``drive_slice``), and a small cohort's CPU and CUDA runs;
- Mesmer segmentation (template 1): the watershed claim kernel against its
  plain round, the published full-width network with seeded weights
  (forward in bf16 and in f32, then the host postprocess), the trained mini
  checkpoint with the device postprocess under both flood engines on the
  benchmark's 8 x 512^2 and 3 x 1024^2 cohorts, the level flood with the
  kernel against the same flood with the plain round, and a small cohort's
  CPU and CUDA runs;
- template 1's cell table and template 3's cell clustering: the segment
  plan and segment-sum kernels against their plain versions (the sums
  against index_add_ on a CPU copy) and against themselves, on dense
  3 x 1024^2 masks (~1000 cells a FOV) and on the planted cohort's
  segmented masks, the background row's kernel at K = 3 and K = 44 on both
  (timed beside index_add_ and its byte and chain bounds) and at K = 1, 9
  and 130, with NaN, +-inf and -0.0 values, on an all-background and a
  no-background image, and one FOV's four sums as the cell table makes them;
  the cell tables of the planted
  cohort's segmented masks and of the dense masks with 40 seeded channels
  through create_marker_count_matrices (nuclear counts, split nuclei, every
  default regionprop, and fast_extraction), held against the CPU port; and
  the cell SOM (normalization, 10x10 training, BMU assignment) and the
  weighted channel product on a ~100k-cell, 102-FOV cell cohort;
- spatial analysis (the four spatial templates), each step against the CPU
  port: (a) the distance rules (a far-corner pair, D = 20, 50,000 cells'
  blocked neighbor counts), (b) the enrichment null given the same
  permutations, (c) the templates' steps on 10 FOVs x 3000 planted cells
  (timed on all 10, held to the CPU port on the first 4),
  (d) the same steps on the main path's own cells (the dense cell tables
  typed by the cell SOM);
- the classical image ops with their two consumers, which launch no kernel
  of their own: (e) the squared EDT bitwise against the CPU port (the ridge
  mask, no background, all background, a ragged shape, 2048^2 with its peak
  memory) and CLAHE, Frangi, Sobel and Meijering within their tolerance,
  each timed with its launches; (f) the fiber stage with run_fiber_
  segmentation's defaults on a planted-ridge 1024^2 FOV (seconds per step,
  FOVs per second, the device's busy share, the segment-sum launches of its
  property table), its labels held to the CPU port's by the near-threshold
  rule, then calculate_fiber_alignment; (g) ez_seg's _create_object_mask at
  1024^2 as a blob and as a projection, equal to the CPU port's;
- cluster masks, overlays and the embeddings: (h) the dense masks with the
  cell SOM's types through ClusterMaskData, erode_mask and
  label_cells_by_cluster, the colour gather, one pixel-cluster mask from the
  pixel stage's assignments and one overlay, equal to the CPU port's;
  (i) UMAP and PCA on the ~100k cells of the cell-clustering cohort and
  t-SNE on a 10,000-cell sample through reduce_dimensions (seconds per
  step, the segment-sum launches of the fit, peak memory, k-NN purity of
  the cell SOM's clusters, beside a small CPU run); (j) the embeddings'
  steps on the card against the CPU port given the same inputs (k-NN,
  bandwidths, the seeded negatives, the PCA start, a few epochs of
  _optimize, the t-SNE affinities and a few descent steps); and the
  segment-sum kernel's flat path bitwise against its plain version at
  UMAP's edge shape (heads, sorted tails, unsorted tails, ids out of
  range), timed beside index_add_ and its byte and chain bounds;
- spatial LDA (the LDA_Preprocessing and LDA_Training_and_Inference
  templates), which launches no kernel of its own: (k) on phase (c)'s
  10 x 3000 cells, featurization (radius 100), the MST difference matrices,
  the topic EDA over 3..7 topics with 25 bootstraps, training (5 topics, 50
  iterations), inference (30) and the pkl and csv files (seconds per step,
  peak memory), again under the profiler with its EDA and training cut in
  depth (the device's busy share, the kernels and copies of each step, the
  EM's per fit); the niche purity of the inferred topics; and every step on
  the card held to the CPU port on the first 2 FOVs;
- Mesmer training and weight conversion, which launch no kernel of their
  own: (l1) the published network with seeded weights on 8 x 256^2 planted
  images and their targets, eager steps in f32 (TF32 off) and bf16 split by
  events into forward, backward and optimizer (peak memory, the device's
  busy share and launches of one profiled step), then train.fit's
  CUDA-graph-replayed steps (images per second), and two f32 steps under
  torch.use_deterministic_algorithms(True), bitwise equal; (l2) one f32
  step at 2 x 64^2 against the CPU port (loss, every gradient, the
  batch-norm averages); (l3) fit's graph replays bitwise against the same
  steps launched one by one, then train_on_synthetic with the shipped
  checkpoint's recipe (2000 steps), held to the planted test's floors on
  its held-out sets through the device postprocess under the level engine
  (the claim kernel's launches counted); (l4) a seeded manifest-shaped
  Keras layer dict through the converter into the full network, against
  the CPU port at 2 x 256^2, and graft_entry.entry on the card;
- the last single-card modules, which launch no kernel of their own (the
  port's kernel counters read 0 after them): (m1) the single-image labeling
  (label at both connectivities, area_filter, remove_small_objects,
  remove_small_holes) on seeded 1024^2 and 2048^2 masks, bitwise the CPU
  port's; (m2) both bisection quantiles against the sort path at the pixel
  stage's 4 x 1024^2 x 16 columns, q = 0.999, bitwise, each timed; (m3)
  PrefetchLoader(device="cuda") over 8 seeded FOV loads feeding the pixel
  stage's preprocessing, equal to a sequential loop and timed against it;
  (m4) the profiler's trace() around one such step, its Chrome trace
  holding CUDA kernel events;
- the templates' file entry points, from TIFFs: (o) phase 8's planted
  3 x 1024^2 cohort with phase 12's 40 marker channels written as a channel
  tree, through generate_deepcell_input, create_deepcell_output,
  generate_cell_table, the generic cell clustering template's SOM and
  consensus, the cell-cluster masks, calc_dist_matrix with the neighborhood
  matrix, run_fiber_segmentation on phase (f)'s FOV and an OME round trip
  (seconds per step and in the TIFF codec), every output held to the same
  calls on the same arrays in memory;
- the multi-process layer on torch.distributed: (n) graft_entry.
  dryrun_multigpu on full-width inputs of the phases above (the published
  network's SGD step on phase (l1)'s batch, the sharded SOM schedule and
  step on phase 4's rows, the pixel cohort of 5 x 1024^2 x 16, the dense
  masks' quantification, the enrichment of 10 x 3000 cells, both floods on
  the 8 x 512^2 planted relief, the fiber cohort, one LDA EM step at
  22,500 x 20 and one UMAP epoch on 1,528,980 edges), at NCCL world size 1
  and again at gloo world size 2 with both ranks on the one card (seconds
  by stage and in collectives); every rank must agree, 2 ranks agree with 1
  and 1 with the single-process port, and each kernel must launch.

It exits non-zero, without the final result line, when there is no CUDA
device or any phase fails. Its last line is one JSON object naming the
device; the line before it lists every kernel of the paths with its
launches in its path's run, its measured error and times, and the least
time the card could take for the same work.
"""

from __future__ import annotations

import importlib
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

CHANNELS = [f"chan{i}" for i in range(16)]
HOST_PACKAGES = ("pandas", "pyarrow", "sklearn", "imageio", "PIL", "tqdm", "h5py",
                 "matplotlib", "seaborn")
NEAR_TIE_RTOL = 1e-6
DIST_RTOL, DIST_ATOL = 1e-5, 1e-6
WEIGHTS_ATOL = 1e-4
# (N, C, K): the pixel stage's shape (four 1024^2 FOVs x 16 channels, a
# 10x10 SOM), then ragged shapes that cross every register path and the
# node chunking, and the wide path (C > 64)
KERNEL_SHAPES = [(4_194_304, 16, 100), (1, 3, 7), (1000, 7, 100),
                 (70_001, 40, 144), (5000, 16, 1), (3001, 80, 33)]
# (B, H, W) of the claim kernel's checks: the two e2e cohorts' batches, then
# ragged shapes (one pixel, a W just past a warp multiple, a wide one)
CLAIM_SHAPES = [(8, 512, 512), (3, 1024, 1024), (1, 1, 1), (2, 7, 129),
                (4, 33, 1000)]
CLAIM_TIMED = CLAIM_SHAPES[:2]
CKPT = os.path.join(REPO, "ark_tpu", "models", "checkpoints",
                    "mesmer_mini_synthetic.npz")
# heads of the mini checkpoint, CPU against CUDA (f32, TF32 off): the CPU
# tests' tolerance against the JAX package
HEADS_ATOL = 1e-5
ENGINES = ("minimax", "levels")
DEVICE = "cuda"          # the segmentation phases' device
# share of pixels whose e2e coverage may differ between the flood engines
# (tie pixels of cells at the small-object limit)
COVERAGE_TIE_SHARE = 1e-3
# the least time the card could take: published H100 SXM peaks (700 W)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# SM cycles of one dependent __fadd_rn on the H100 (scripts/port_kernel_ab.py
# measures it: one warp's chain of 2^20 adds, cycles by clock64): the segment
# sum's contract adds each segment's values one after another, so a chain of
# n adds takes at least n x this many cycles
FADD_LATENCY_CYCLES = 4.219


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def gpu_name_and_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def missing_host_packages():
    missing = []
    for name in HOST_PACKAGES:
        try:
            importlib.import_module(name)
        except ImportError:
            missing.append(name)
    return missing


def near_ties(d):
    """Rows whose two smallest d are closer than NEAR_TIE_RTOL * max(|d|, 1):
    there, another summation order may pick the other node."""
    import torch

    if d.shape[1] < 2:
        return torch.zeros(d.shape[0], dtype=torch.bool, device=d.device)
    two = torch.topk(d, 2, dim=1, largest=False).values
    scale = torch.clamp_min(torch.abs(two[:, 0]), 1.0)
    return (two[:, 1] - two[:, 0]) < NEAR_TIE_RTOL * scale


def plain_d(weights, data):
    w2 = (weights * weights).sum(1)
    return w2[None, :] - 2.0 * (data @ weights.T)


def bound_ms(nbytes=0.0, flop=0.0, chain=0, mhz=None):
    """(ms, "bytes", "operations" or "chain"): the largest of the bytes over
    the HBM rate, the f32 operations over the f32 peak and, given the
    longest chain of dependent adds and the SM clock `mhz`, that chain's
    cycles (FADD_LATENCY_CYCLES an add) at that clock."""
    times = [(nbytes / HBM_BYTES_PER_S * 1e3, "bytes"), (flop / F32_FLOP_PER_S * 1e3,
                                                         "operations")]
    if chain:
        times.append((chain * FADD_LATENCY_CYCLES / (mhz * 1e3), "chain"))
    return max(times, key=lambda t: t[0])


def sm_clock_mhz(fn, calls):
    """The SM clock (MHz) nvidia-smi reads while the card works through
    `calls` queued calls of `fn`: the clock a chain bound is reckoned at."""
    import torch

    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    torch.cuda.synchronize()
    return float(out.strip().splitlines()[0].split()[0])


def same_bits(got, want):
    """Bitwise equal, NaN where the other has NaN (a NaN's payload is not
    compared: the card's adds give the canonical NaN)."""
    import torch

    got, want = got.cpu(), want.cpu()
    nan = torch.isnan(want)
    return (got.shape == want.shape and torch.equal(torch.isnan(got), nan)
            and torch.equal(got[~nan].view(torch.int32), want[~nan].view(torch.int32)))


def share(bound, ms):
    """The bound's share of a measured time (NaN for a time of 0 or None,
    which only a rehearsal without a card, or a profiler that sees no device
    time, gives)."""
    return bound / ms if ms else float("nan")


def fmt_ms(ms):
    return "not measured" if ms is None else f"{ms:.4f} ms"


def time_ms(fn, reps=10):
    """Median of `reps` CUDA-event timings after one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def batch_ms(fn, reps=20):
    """ms per call from one pair of CUDA events around `reps` back-to-back
    calls after a warm-up: the launches queue up, so this is the kernels'
    own time without the host's gaps between single calls."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def pixel_rows(rng, n, c):
    """Rows like the pixel stage's BMU input: nonnegative, row-normalized
    (|x|^2 <= 1, as after the rownorm step). At |x|^2 >> 1 the f32
    cancellation in d + |x|^2 alone exceeds the distance tolerance."""
    x = rng.random((n, c), dtype=np.float32)
    return x / x.sum(axis=1, keepdims=True)


def check_kernel(rng):
    """Phase 3: the BMU kernel against bmu_plain on the card."""
    import torch

    from ark_tpu_torch.ops import som

    max_err = 0.0
    timing = {}
    for n, c, k in KERNEL_SHAPES:
        x = torch.as_tensor(pixel_rows(rng, n, c), device="cuda")
        # nodes drawn from the data rows, as the SOM's initial nodes are
        w = x[torch.as_tensor(rng.choice(n, size=k), device="cuda")].clone() \
            if n >= k else torch.as_tensor(pixel_rows(rng, k, c), device="cuda")
        idx_k, dist_k = som.bmu(w, x, return_dist=True)
        idx_k_only, _ = som.bmu(w, x, return_dist=False)
        idx_p, dist_p = som.bmu_plain(w, x, return_dist=True)
        torch.cuda.synchronize()
        ties = near_ties(plain_d(w, x))
        differ = idx_k != idx_p
        check(torch.equal(idx_k, idx_k_only),
              f"bmu {n}x{c}x{k}: with_dist changes the indices")
        check(not bool((differ & ~ties).any()),
              f"bmu {n}x{c}x{k}: {int((differ & ~ties).sum())} index "
              f"mismatches outside near-ties")
        check(torch.allclose(dist_k, dist_p, rtol=DIST_RTOL, atol=DIST_ATOL),
              f"bmu {n}x{c}x{k}: distances differ by "
              f"{float((dist_k - dist_p).abs().max())}")
        err = float((dist_k - dist_p).abs().max())
        max_err = max(max_err, err)
        print(f"bmu N={n} C={c} K={k}: index mismatches {int(differ.sum())}, "
              f"near-ties {int(ties.sum())}, max |dist err| {err:.3g}")
        if (n, c, k) == KERNEL_SHAPES[0]:
            timing["bound_ms"], timing["bound_by"] = bound_ms(
                nbytes=4.0 * (n * c + k * c + n), flop=2.0 * n * k * c)
            timing["ms"] = time_ms(lambda: som.bmu(w, x, return_dist=False))
            timing["device_ms"] = device_ms(lambda: som.bmu(w, x, return_dist=False))
            timing["plain_ms"] = time_ms(
                lambda: som.bmu_plain(w, x, return_dist=False))
            timing["dist_ms"] = time_ms(lambda: som.bmu(w, x, return_dist=True))
            timing["plain_dist_ms"] = time_ms(
                lambda: som.bmu_plain(w, x, return_dist=True))
        del x, w, idx_k, dist_k, idx_p, dist_p, ties, differ

    # duplicated nodes: the lowest index of an exact tie wins
    a = torch.as_tensor(pixel_rows(rng, 50, 16), device="cuda")
    x = torch.as_tensor(pixel_rows(rng, 20_000, 16), device="cuda")
    idx_dup, _ = som.bmu(torch.cat([a, a, a]), x, return_dist=False)
    idx_ref, _ = som.bmu_plain(a, x, return_dist=False)
    ties = near_ties(plain_d(a, x))
    check(bool((idx_dup < 50).all()), "bmu: a duplicated node lost its tie to "
          "a higher index")
    check(not bool(((idx_dup != idx_ref) & ~ties).any()),
          "bmu: duplicated-node table disagrees with the plain version")
    print(f"bmu duplicated nodes: lowest index wins on all {x.shape[0]} rows")
    print(f"bmu at N={KERNEL_SHAPES[0][0]} C=16 K=100 (median of 10): kernel "
          f"{timing['ms']:.4f} ms, plain {timing['plain_ms']:.4f} ms; with "
          f"distances: kernel {timing['dist_ms']:.4f} ms, plain "
          f"{timing['plain_dist_ms']:.4f} ms; kernel device time "
          f"{fmt_ms(timing['device_ms'])}; bound {timing['bound_ms']:.4f} ms (f32 "
          f"FMA), share {share(timing['bound_ms'], timing['ms']):.2f} of the kernel's "
          f"time, {share(timing['bound_ms'], timing['device_ms']):.2f} of its device "
          f"time")
    return max_err, timing


def claim_inputs(rng, shape, levels=256):
    """Mask-encoded labels (-1 outside a ~80% mask, 0 unlabeled, small
    labels and the largest legal label 2^31-2) and random levels."""
    lab = rng.integers(0, 6, size=shape).astype(np.int32)
    lab[rng.random(shape) < 0.05] = 2 ** 31 - 2
    lab[rng.random(shape) < 0.2] = -1
    q = rng.integers(0, levels, size=shape).astype(np.int32)
    return lab, q


def device_ms(fn, reps=10):
    """Device time per call of `fn` (every kernel and memset it launches),
    from torch.profiler over `reps` calls after one warm-up; None when the
    profiler sees no device time in two tries (a trace now and then comes
    back empty)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        # device-side events only: an operator's entry repeats its kernels' time
        total_us = sum(e.self_device_time_total for e in prof.key_averages()
                       if e.device_type == DeviceType.CUDA)
        if total_us > 0:
            return total_us / reps / 1e3
    return None


def check_claim_kernel(rng, levels=256):
    """Phase 6: the claim kernel against its plain round on the card,
    bitwise, then one round of each timed at the e2e cohorts' batch shapes.
    Returns (max |label difference| over every check, {shape: timings})."""
    import torch

    from ark_tpu_torch.ops import watershed

    def plain(lab, q, level):
        new = watershed._claim_round(lab, q, None, level)
        return new, torch.sum(new != lab, dtype=torch.int32)

    timing = {}
    max_err = 0
    for shape in CLAIM_SHAPES:
        lab_np, q_np = claim_inputs(rng, shape, levels)
        lab = torch.as_tensor(lab_np, device="cuda")
        q = torch.as_tensor(q_np, device="cuda")
        for level in (0, levels // 2, levels - 1):
            new_k, chg_k = watershed.claim_round(lab, q, level)
            new_p, chg_p = plain(lab, q, level)
            torch.cuda.synchronize()
            max_err = max(max_err, int((new_k.to(torch.int64)
                                        - new_p.to(torch.int64)).abs().max()))
            check(torch.equal(new_k, new_p),
                  f"claim {shape} level {level}: "
                  f"{int((new_k != new_p).sum())} labels differ")
            check(int(chg_k) == int(chg_p),
                  f"claim {shape} level {level}: changed {int(chg_k)} vs "
                  f"{int(chg_p)}")
            check(torch.equal(lab, torch.as_tensor(lab_np, device="cuda")),
                  f"claim {shape}: the kernel wrote into its input")
        print(f"claim {shape}: labels and changed counts equal at levels "
              f"0, {levels // 2}, {levels - 1} (last count {int(chg_k)})")
        if shape in CLAIM_TIMED:
            mid = levels // 2
            kernel = lambda: watershed.claim_round(lab, q, mid)   # noqa: E731
            base = lambda: plain(lab, q, mid)                     # noqa: E731
            # each pixel's label and level read once, its new label written once
            timing[shape] = {"ms": time_ms(kernel), "plain_ms": time_ms(base),
                             "device_ms": device_ms(kernel),
                             "plain_device_ms": device_ms(base),
                             "bound_ms": bound_ms(nbytes=12.0 * lab.numel())[0]}
            print(f"claim {shape} one round: per call (CUDA events, median of "
                  f"10) kernel {timing[shape]['ms']:.4f} ms, plain "
                  f"{timing[shape]['plain_ms']:.4f} ms; device time per call "
                  f"(profiler, 10 calls) kernel {timing[shape]['device_ms']} ms, "
                  f"plain {timing[shape]['plain_device_ms']} ms")
    return max_err, timing


def make_cohort(rng, n_fovs, size):
    """Synthetic MIBI-like counts: per channel, a smooth random intensity
    field (a coarse grid upsampled) with Poisson noise; ~a third of pixels
    of each channel carry no signal. (H, W, C) float32 per FOV."""
    raws = []
    cell = max(size // 32, 1)
    for _ in range(n_fovs):
        coarse = rng.gamma(0.6, 4.0, size=(size // cell, size // cell,
                                           len(CHANNELS)))
        lam = np.kron(coarse, np.ones((cell, cell, 1)))
        raws.append(rng.poisson(lam).astype(np.float32))
    return raws


def drive_slice(raws, device, seed=42, blur_factor=2, subset_proportion=0.1,
                xdim=10, ydim=10, q_pre=0.99, q_post=0.999):
    """The device phases of pixie_fused.run_pixel_clustering, in its order,
    on an in-memory cohort: channel percentiles, q05 threshold, blur and
    row-normalize, seeded subset and per-FOV 99.9% quantiles, SOM training,
    BMU assignment. Returns the weights, the 1-indexed labels, the flat
    indices of the pixels they belong to and the BMU input rows per FOV,
    and the per-phase seconds."""
    import pandas as pd
    import torch

    from ark_tpu_torch.ops import som
    from ark_tpu_torch.phenotyping import pixie_fused, pixie_preprocessing

    seconds = {}

    def mark(name, t0):
        if device != "cpu":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0

    t0 = time.perf_counter()
    devs = [torch.as_tensor(r, device=device) for r in raws]
    stats = [pixie_fused._channel_percentiles_device(d, q_pre) for d in devs]
    vals = np.stack([v.cpu().numpy() for v, _ in stats]).astype(np.float64)
    haspos = np.stack([h.cpu().numpy() for _, h in stats])
    norm_pre = np.array([np.mean(vals[haspos[:, c], c])
                         for c in range(raws[0].shape[-1])])
    mark("chan_percentiles_s", t0)

    t0 = time.perf_counter()
    norm_f32 = torch.as_tensor(norm_pre.astype(np.float32), device=device)
    q05s = [pixie_fused._intensity_q05_async(d / norm_f32) for d in devs]
    thresh = float(np.mean([float(q.numpy()) for q in q05s]))
    mark("q05_threshold_s", t0)

    t0 = time.perf_counter()
    parts = [pixie_fused._prep_fov_parts(
        torch.as_tensor(pixie_preprocessing.channel_norm_divide(
            r, norm_pre.reshape(1, 1, -1)), device=device), blur_factor)
        for r in raws]
    del devs
    mark("blur_rownorm_s", t0)

    t0 = time.perf_counter()
    kept, subsets, fov_q, kept_pixels = [], [], [], []
    for norm, rowsums, anynz in parts:
        keep = np.flatnonzero(pixie_fused._valid_mask_device(
            rowsums, anynz, thresh).cpu().numpy())
        kept_pixels.append(keep)
        norm_keep = norm[torch.as_tensor(keep, device=device)]
        np.random.seed(seed)
        locs = np.random.choice(len(keep), size=int(round(
            subset_proportion * len(keep))), replace=False)
        subsets.append(norm_keep[torch.as_tensor(locs, device=device)
                                 ].cpu().numpy())
        sorted_dev, counts = pixie_fused._quantile_stats_device(norm_keep)

        def sorted_cols(lo_rows, hi_rows, _s=sorted_dev):
            rows = torch.as_tensor(np.stack([lo_rows, hi_rows]), device=device)
            picked = torch.gather(_s, 0, rows).cpu().numpy()
            return picked[0], picked[1]

        fov_q.append(pixie_fused._fov_quantiles(
            sorted_cols, counts.cpu().numpy(), len(keep), q_post))
        kept.append(norm_keep)
    # pandas' mean of the per-FOV quantiles, as the driver takes it: its
    # dtype (f32 where a FOV's column holds zeros) sets the divide's
    norm_post = pd.DataFrame(dict(enumerate(fov_q))).mean(axis=1).to_numpy()
    del parts
    mark("subset_quantiles_s", t0)

    t0 = time.perf_counter()
    train = (np.concatenate(subsets) / norm_post).astype(np.float32)
    weights = som.som_train(train, xdim=xdim, ydim=ydim, seed=seed,
                            device=device)
    mark("som_train_s", t0)

    t0 = time.perf_counter()
    weights_dev = som.som_weights_from_numpy(weights, device)
    labels, mapped = [], []
    for norm_keep in kept:
        normalized = (pixie_fused._HostCopy(norm_keep).numpy()
                      .astype(np.float64) / norm_post).astype(np.float32)
        labels_dev = som.som_map_async(weights_dev, normalized, device=device)
        labels.append(pixie_fused._HostCopy(labels_dev).numpy() + 1)
        mapped.append(normalized)
    mark("bmu_assign_s", t0)
    return {"weights": weights, "labels": labels, "mapped": mapped,
            "kept_pixels": kept_pixels, "seconds": seconds, "thresh": thresh,
            "n_train": train.shape[0], "train": train, "norm_pre": norm_pre,
            "norm_post": norm_post}


def check_slice_outputs(out, n_nodes):
    w = out["weights"]
    check(w.shape == (n_nodes, len(CHANNELS)) and np.isfinite(w).all(),
          f"SOM weights: shape {w.shape}, all finite {np.isfinite(w).all()}")
    for lab in out["labels"]:
        check(lab.size > 0 and lab.min() >= 1 and lab.max() <= n_nodes,
              f"labels outside 1..{n_nodes}")


class TiffClock:
    """Seconds spent in the port's TIFF codec (``ark_tpu_torch.io.tiff``'s
    public functions, the outermost call only) while the clock is entered."""

    NAMES = ("read", "write", "decode", "encode", "shape_dtype", "description")

    def __init__(self):
        self.seconds = 0.0
        self._depth = 0
        self._saved = {}

    def _wrap(self, fn):
        def timed(*args, **kwargs):
            self._depth += 1
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self._depth -= 1
                if not self._depth:
                    self.seconds += time.perf_counter() - t0
        return timed

    def __enter__(self):
        from ark_tpu_torch.io import tiff

        for name in self.NAMES:
            self._saved[name] = getattr(tiff, name)
            setattr(tiff, name, self._wrap(self._saved[name]))
        return self

    def __exit__(self, *exc):
        from ark_tpu_torch.io import tiff

        for name, fn in self._saved.items():
            setattr(tiff, name, fn)


def timed_steps(device):
    """(run, seconds): run(name, fn) calls fn, synchronises `device`, and
    records the step's wall seconds and its seconds inside the TIFF codec in
    seconds[name] = (wall_s, tiff_s)."""
    import torch

    seconds = {}

    def run(name, fn):
        with TiffClock() as clock:
            t0 = time.perf_counter()
            result = fn()
            if device != "cpu":
                torch.cuda.synchronize()
            seconds[name] = (time.perf_counter() - t0, clock.seconds)
        return result
    return run, seconds


def fmt_steps(seconds):
    return ", ".join(f"{k} {wall:.3f} (TIFF {io_s:.3f})" for k, (wall, io_s)
                     in seconds.items())


def write_channel_tree(tiff_dir, images):
    """images: {fov: {channel: 2-D array}} -> tiff_dir/<fov>/<channel>.tiff,
    through the port's save_image."""
    from ark_tpu_torch.io.image_utils import save_image

    for fov, chans in images.items():
        for chan, img in chans.items():
            save_image(os.path.join(tiff_dir, fov, f"{chan}.tiff"), img)


def pixel_stage_from_files(raws, base, device, channels=CHANNELS, xdim=10, ydim=10,
                           max_k=20):
    """Template 2 from files: the cohort's channel TIFFs written with the
    port's codec, run_pixel_clustering (consensus included), then
    generate_and_save_pixel_cluster_masks. Returns its per-phase timings,
    seconds per step (wall, TIFF) and outputs: the SOM weights, and per FOV
    the clustered pixels' flat indices with their SOM and meta clusters and
    the mask read back."""
    import pandas as pd

    from ark_tpu_torch.io import feather_utils as feather
    from ark_tpu_torch.io.image_utils import read_image
    from ark_tpu_torch.phenotyping import pixie_fused
    from ark_tpu_torch.utils import data_utils

    fovs = [f"fov{i}" for i in range(len(raws))]
    tiff_dir = os.path.join(base, "image_data")
    run, seconds = timed_steps(device)
    run("write_tiffs", lambda: write_channel_tree(tiff_dir, {
        fov: {chan: raw[..., ci] for ci, chan in enumerate(channels)}
        for fov, raw in zip(fovs, raws)}))
    timings = {}
    run("run_pixel_clustering", lambda: pixie_fused.run_pixel_clustering(
        fovs, channels, base, tiff_dir, img_sub_folder=None, max_k=max_k, blur_factor=2,
        subset_proportion=0.1, seed=42, xdim=xdim, ydim=ydim, timings=timings,
        device=device))
    artifacts = ["pixel_output_dir/channel_norm_pre_rownorm.feather",
                 "pixel_output_dir/pixel_thresh.feather",
                 "channel_norm_post_rownorm.feather", "pixel_som_weights.feather",
                 "pixel_mat_data/channel_norm_post_rownorm_perfov.csv",
                 "pixel_channel_avg_som_cluster.csv", "pixel_channel_avg_meta_cluster.csv"]
    artifacts += [f"pixel_mat_subsetted/{f}.feather" for f in fovs]
    artifacts += [f"pixel_mat_data/{f}.feather" for f in fovs]
    for rel in artifacts:
        check(os.path.exists(os.path.join(base, rel)), f"missing {rel}")
    avg = pd.read_csv(os.path.join(base, "pixel_channel_avg_som_cluster.csv"))
    mapping = avg[["pixel_som_cluster", "pixel_meta_cluster"]].copy()
    mapping["pixel_meta_cluster_rename"] = [f"meta_{m}" for m in mapping["pixel_meta_cluster"]]
    id_csv = os.path.join(base, "pixel_meta_cluster_mapping.csv")
    mapping.to_csv(id_csv, index=False)
    mask_dir = os.path.join(base, "pixel_masks")
    os.makedirs(mask_dir)
    run("pixel_masks", lambda: data_utils.generate_and_save_pixel_cluster_masks(
        fovs, base, mask_dir, tiff_dir, f"{channels[0]}.tiff", "pixel_mat_data", id_csv,
        device=device))
    ids = pd.read_csv(id_csv)
    meta_to_id = dict(zip(ids["pixel_meta_cluster"], ids["cluster_id"]))
    width = raws[0].shape[1]
    out = {"weights": feather.read_dataframe(
        os.path.join(base, "pixel_som_weights.feather")).to_numpy(), "fovs": {},
           "n_meta": int(avg["pixel_meta_cluster"].nunique())}
    for fov in fovs:
        t = feather.read_dataframe(os.path.join(base, "pixel_mat_data", fov + ".feather"))
        flat = t["row_index"].to_numpy() * width + t["column_index"].to_numpy()
        order = np.argsort(flat, kind="stable")
        meta = t["pixel_meta_cluster"].to_numpy()[order]
        out["fovs"][fov] = {
            "flat": flat[order], "som": t["pixel_som_cluster"].to_numpy()[order],
            "meta": meta, "cluster_id": np.array([meta_to_id[m] for m in meta]),
            "mask": read_image(os.path.join(mask_dir, f"{fov}.tiff"))}
    return timings, seconds, out


def check_pixel_stage_from_files(got, want, shape, n_nodes, max_k):
    """Phase 4's outputs from files against ``drive_slice`` on the same
    cohort and device: weights and SOM labels bitwise; meta labels in
    1..max_k, every meta cluster used; each pixel mask carries its pixels'
    cluster ids and zero elsewhere."""
    check(got["weights"].shape == want["weights"].shape
          and np.array_equal(got["weights"], want["weights"]),
          "pixel stage: the entry point's SOM weights differ from drive_slice's")
    check(got["n_meta"] == max_k, f"pixel stage: {got['n_meta']} meta clusters, "
          f"expected {max_k}")
    for i, (fov, g) in enumerate(got["fovs"].items()):
        order = np.argsort(want["kept_pixels"][i], kind="stable")
        check(np.array_equal(g["flat"], want["kept_pixels"][i][order])
              and np.array_equal(g["som"], want["labels"][i][order]),
              f"pixel stage {fov}: the feather's pixels or SOM labels differ from "
              f"drive_slice's")
        check(g["som"].min() >= 1 and g["som"].max() <= n_nodes
              and g["meta"].min() >= 1 and g["meta"].max() <= max_k,
              f"pixel stage {fov}: labels outside their ranges")
        mask = np.zeros(shape, np.int64).ravel()
        mask[g["flat"]] = g["cluster_id"]
        check(g["mask"].shape == shape and np.array_equal(g["mask"].ravel(), mask),
              f"pixel stage {fov}: the pixel mask TIFF differs from its pixels' clusters")


def run_pixel_stage():
    """Phase 4: template 2 at real size from TIFFs through the port's entry
    point (run_pixel_clustering with consensus, then the pixel masks), held
    bitwise to ``drive_slice``'s device phases on the same cohort. Returns
    the BMU kernel's launches in the entry point's run, FOV 0's assignments
    (the flat indices of its clustered pixels, their 1-indexed SOM clusters)
    and ``drive_slice``'s outputs."""
    import torch

    from ark_tpu_torch.ops import som

    raws = make_cohort(np.random.default_rng(7), n_fovs=4, size=1024)
    with tempfile.TemporaryDirectory() as base:
        som.bmu.launches = 0
        t0 = time.perf_counter()
        timings, seconds, got = pixel_stage_from_files(raws, base, "cuda")
        total = time.perf_counter() - t0
        launches = som.bmu.launches
    check(launches > 0, "the pixel stage never launched the BMU kernel")
    out = drive_slice(raws, "cuda")
    torch.cuda.synchronize()
    check_slice_outputs(out, 100)
    check_pixel_stage_from_files(got, out, raws[0].shape[:2], 100, 20)
    print(f"pixel stage 4 x 1024^2 x 16ch from TIFFs on cuda [{CARD}]: {total:.3f} s; "
          f"steps (wall s, TIFF s): {fmt_steps(seconds)}; run_pixel_clustering's phases "
          + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))
    print(f"pixel stage: weights and SOM labels bitwise drive_slice's on the same "
          f"cohort ({sum(len(g['som']) for g in got['fovs'].values())} pixels), "
          f"{got['n_meta']} meta clusters, pixel masks equal to their pixels' clusters; "
          f"bmu kernel launches {launches}; drive_slice per phase "
          + ", ".join(f"{k} {v:.4f}" for k, v in out["seconds"].items()))
    first = got["fovs"]["fov0"]
    return launches, (first["flat"], first["som"]), out


def compare_pixel_cpu_cuda():
    """Phase 5: a small cohort through the pixel stage on the CPU and the
    card."""
    import torch

    small = make_cohort(np.random.default_rng(11), n_fovs=2, size=256)
    cpu = drive_slice(small, "cpu")
    gpu = drive_slice(small, "cuda")
    check_slice_outputs(gpu, 100)
    w_err = float(np.abs(cpu["weights"] - gpu["weights"]).max())
    check(w_err <= WEIGHTS_ATOL, f"CPU and CUDA SOM weights differ by {w_err}")
    w_cpu = torch.as_tensor(cpu["weights"])
    mismatches = ties_total = 0
    for lab_c, lab_g, x in zip(cpu["labels"], gpu["labels"], cpu["mapped"]):
        ties = near_ties(plain_d(w_cpu, torch.as_tensor(x))).numpy()
        differ = lab_c != lab_g
        check(not (differ & ~ties).any(),
              f"CPU and CUDA labels differ at {int((differ & ~ties).sum())} "
              f"pixels outside near-ties")
        mismatches += int(differ.sum())
        ties_total += int(ties.sum())
    print(f"cpu vs cuda (2 x 256^2 x 16ch): max |weight diff| {w_err:.3g}, "
          f"label mismatches {mismatches}, near-ties {ties_total}")


def wall_ms(fn, reps=5):
    """Median host-clock ms of `reps` synchronised calls after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


def run_full_width_template(size=1024, hw=512):
    """Phase 7: template 1's default, the published Mesmer network (ResNet50,
    256-channel FPN) with seeded random weights, at 4 x 1024^2 x 2 in bf16
    and in f32 (TF32 off), then Mesmer.predict's host postprocess on a
    planted 2 x 512^2 cohort through the same bf16 network."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import mesmer, synthetic

    x = torch.as_tensor(np.random.default_rng(5).random((4, size, size, 2),
                                                       dtype=np.float32),
                        device=DEVICE)
    models = {}
    for dtype in (torch.bfloat16, torch.float32):
        model = unet.init_mesmer(seed=0, dtype=dtype, device=DEVICE)
        app = mesmer.Mesmer(model=model, device=DEVICE)
        torch.cuda.reset_peak_memory_stats()
        ms = wall_ms(lambda: app._forward(x))
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out = app._forward(x)
        for k, v in out.items():
            check(v.dtype == torch.float32 and bool(torch.isfinite(v).all()),
                  f"full-width {dtype} head {k}: dtype {v.dtype} or not finite")
        check(tuple(out["whole_cell_pixelwise"].shape) == (4, size, size, 3),
              "full-width pixelwise head has the wrong shape")
        print(f"full-width forward {dtype} 4 x {size}^2 x 2: {ms:.2f} ms per batch "
              f"(median of 5, warm), peak memory {peak:.2f} GiB")
        models[dtype] = (app, ms, peak)
        del out
    app = models[torch.bfloat16][0]
    imgs = synthetic.synthetic_cells(np.random.default_rng(1), 2, hw=hw,
                                     n_cells=(250, 300), crowding=0.35)[0]
    t0 = time.perf_counter()
    labels = app.predict(imgs, postprocess="host")
    seconds = time.perf_counter() - t0
    for comp, lab in labels.items():
        check(lab.dtype == np.int32 and lab.shape == (2, hw, hw),
              f"host postprocess {comp}: {lab.dtype} {lab.shape}")
    print(f"full-width predict(postprocess='host') 2 x {hw}^2: {seconds:.3f} s, "
          f"instances " + ", ".join(f"{c} {int(sum(len(np.unique(l)) - 1 for l in lab))}"
                                    for c, lab in labels.items()))
    return {str(k).split(".")[-1]: (v[1], v[2]) for k, v in models.items()}


def run_device_postprocess(cohorts):
    """Phase 8: segment_fovs(postprocess='device') with the trained mini
    checkpoint on the benchmark's cohorts, under each flood engine. Returns
    the claim kernel's launches in the level engine's run of the first
    cohort, the Mesmer, and each cohort's masks under the default (minimax)
    engine."""
    import torch

    from ark_tpu_torch.ops import som, watershed
    from ark_tpu_torch.segmentation import mesmer

    app = mesmer.Mesmer(weights_path=CKPT, device=DEVICE)
    first = next(iter(cohorts))
    mesmer.segment_fovs(cohorts[first][0][:1], app=app, device=DEVICE,
                        postprocess="device")                        # warm-up
    claim_launches = None
    masks = {}
    for name, (fovs, batch) in cohorts.items():
        labels = {}
        for engine in ENGINES:
            watershed._ENGINE = engine
            app.host_fallbacks = 0
            som.bmu.launches = 0
            watershed.claim_round.launches = 0
            t0 = time.perf_counter()
            out = mesmer.segment_fovs(fovs, app=app, batch_size=batch,
                                      device=DEVICE, postprocess="device")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = watershed.claim_round.launches
            check(app.host_fallbacks == 0,
                  f"{name} {engine}: {app.host_fallbacks} host fallbacks")
            check((launches > 0) == (engine == "levels"),
                  f"{name} {engine}: claim kernel launches {launches}")
            if engine == "levels" and name == first:
                claim_launches = launches
            for comp, lab in out.items():
                counts = [len(np.unique(img)) - 1 for img in lab]
                check(lab.dtype == np.int32 and lab.shape == fovs.shape[:3],
                      f"{name} {engine} {comp}: {lab.dtype} {lab.shape}")
                check(min(counts) >= 1 and max(counts) <= mesmer._MARKER_TABLE,
                      f"{name} {engine} {comp}: label counts {counts}")
            labels[engine] = out
            app.timings = {}
            mesmer.segment_fovs(fovs, app=app, batch_size=batch, device=DEVICE,
                                postprocess="device")
            split = app.timings
            app.timings = None
            print(f"e2e {name} {engine}: {wall:.3f} s wall "
                  f"({len(fovs) / wall:.2f} FOV/s), claim launches {launches}, "
                  f"instances per FOV {counts}; phases (synchronised run, s): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in split.items()))
        # the floods' claim sets are equal (phase 9 checks it); after the
        # small-object filter, a tie pixel that one engine hands to a cell
        # under the size limit and the other to a larger one is covered by
        # one engine only, as in the JAX package
        for comp in labels["minimax"]:
            differ = float(np.mean((labels["minimax"][comp] > 0)
                                   != (labels["levels"][comp] > 0)))
            check(differ <= COVERAGE_TIE_SHARE,
                  f"{name} {comp}: the engines' coverage differs at a share "
                  f"{differ} of pixels")
            print(f"e2e {name} {comp}: coverage differs between the engines at "
                  f"a share {differ:.3g} of pixels (filtered tie cells)")
        masks[name] = labels["minimax"]
    watershed._ENGINE = "minimax"
    return claim_launches, app, masks


def compare_level_flood(app, fovs):
    """Phase 9: the level flood on the cohort's own relief and markers, with
    the kernel and with the plain round swapped in, bitwise; and its claim
    set equal to the minimax flood's."""
    import torch

    from ark_tpu_torch.ops import cc, watershed
    from ark_tpu_torch.segmentation import mesmer

    res = app._segment_device(app._upload(fovs), 0.1)

    def plain_round(lab, q, level):
        new = watershed._claim_round(lab, q, None, level)
        return new, torch.sum(new != lab, dtype=torch.int32)

    for comp in mesmer.COMPARTMENTS:
        markers, _, _ = cc.label_batched_small(res[comp]["maxima"])
        fgmask = res[comp]["foreground"] > 0.3
        q = watershed._quantize(-res[comp]["inner"], fgmask, 256)
        kernel = watershed._flood(q, markers, fgmask, 256, 32)
        real = watershed.claim_round
        watershed.claim_round = plain_round
        try:
            plain = watershed._flood(q, markers, fgmask, 256, 32)
        finally:
            watershed.claim_round = real
        check(torch.equal(kernel[0], plain[0]) and kernel[1] == plain[1],
              f"level flood {comp}: kernel and plain rounds disagree "
              f"({int((kernel[0] != plain[0]).sum())} labels, flags "
              f"{kernel[1]} {plain[1]})")
        h, w = q.shape[1:]
        minimax = watershed._flood_minimax(q, markers, fgmask, 256, 2 * (h + w))
        check(minimax[1] and torch.equal(minimax[0] > 0, kernel[0] > 0),
              f"{comp}: the minimax and level floods cover different pixels")
        print(f"level flood {comp} {tuple(q.shape)}: kernel == plain round, "
              f"labels and flag ({kernel[1]}); coverage == the minimax flood's")


def compare_segmentation_cpu_cuda():
    """Phase 10: the JAX tests' cohort size (4 x 64^2) on the CPU and the
    card: heads, the postprocess fed the same heads, planted truth."""
    import torch

    from ark_tpu_torch.ops import watershed
    from ark_tpu_torch.segmentation import mesmer, synthetic

    imgs, cells, nucs = synthetic.synthetic_cells(np.random.default_rng(3), 4, hw=64)
    apps = {d: mesmer.Mesmer(weights_path=CKPT, device=d) for d in ("cpu", DEVICE)}
    heads = {d: app._segment_device(app._upload(imgs), 0.1) for d, app in apps.items()}
    err = max(float((heads["cpu"][c][k] - heads[DEVICE][c][k].cpu()).abs().max())
              for c in mesmer.COMPARTMENTS for k in ("inner", "foreground"))
    check(err <= HEADS_ATOL, f"CPU and CUDA heads differ by {err}")
    for engine in ENGINES:
        watershed._ENGINE = engine
        fed = {d: {c: {k: v.to(d) for k, v in heads["cpu"][c].items()}
                   for c in mesmer.COMPARTMENTS} for d in apps}
        out = {d: apps[d]._device_post(fed[d], 0.3, 15) for d in apps}
        for comp in mesmer.COMPARTMENTS:
            check(torch.equal(out["cpu"][0][comp], out[DEVICE][0][comp].cpu()),
                  f"{engine} {comp}: CPU and CUDA postprocess labels differ")
        check(out["cpu"][1] and out[DEVICE][1], f"{engine}: not converged")
        seg = mesmer.segment_fovs(imgs, app=apps[DEVICE], device=DEVICE,
                                  postprocess="device")
        for comp, truth in (("whole_cell", cells), ("nuclear", nucs)):
            stats = [synthetic.match_instances(seg[comp][i], truth[i])
                     for i in range(4)]
            recall = float(np.mean([s["recall"] for s in stats]))
            precision = float(np.mean([s["precision"] for s in stats]))
            check(recall >= 0.9 and precision >= 0.9,
                  f"{engine} {comp}: planted recall {recall} precision {precision}")
            print(f"cpu vs cuda 4 x 64^2 {engine} {comp}: postprocess labels "
                  f"equal; planted recall {recall:.3f} precision {precision:.3f}")
    watershed._ENGINE = "minimax"
    print(f"cpu vs cuda 4 x 64^2: max |head diff| {err:.3g}")


# --- quantification (template 1's cell table) and cell clustering (template 3)

N_QUANT_CHANNELS = 40          # the top of the 16-40 channels users run
QUANT_CHANNELS = [f"marker{i}" for i in range(N_QUANT_CHANNELS)]
# cell-table columns derived from the second moments: their sqrt and atan2
# round differently on each device in the last bits, so CUDA is held to the
# CPU with the tolerance the CPU tests hold the port to the JAX package;
# every other column is bitwise
DERIVED_COLUMNS = {"eccentricity", "major_axis_length", "minor_axis_length",
                   "equivalent_diameter", "major_minor_axis_ratio",
                   "major_axis_equiv_diam_ratio"}
DERIVED_TOL = 1e-6
# the weighted channel product: an f32 matmul whose sums run in another
# order on the card
MATMUL_RTOL = 1e-5
N_PIXEL_CLUSTERS = 20
COHORT_COPIES = 34             # 3 FOVs x 34 = a 102-FOV cohort of cells
# the planted 3 x 1024^2 cohort holds ~190 cells a FOV, and the device
# postprocess finds them; the dense cohort holds ~1000 (users' FOVs hold
# 1000-3000)
MIN_CELLS = {"segmented": 150, "dense": 800}


def dense_masks(seed=47, n_fovs=3, size=1024, n_cells=1000, cell_radius=17,
                nuc_radius=6, nuc_shift=4):
    """Whole-cell and nuclear masks at users' density: `n_cells` seeds a
    FOV; a pixel within `cell_radius` of its nearest seed joins that seed's
    cell (touching Voronoi cells, background where seeds are sparse), and
    nuclei are the same around seeds shifted by `nuc_shift` columns, so some
    reach into a neighbour (split_large_nuclei's work)."""
    from scipy import ndimage as ndi

    rng = np.random.default_rng(seed)
    out = {"whole_cell": [], "nuclear": []}
    for _ in range(n_fovs):
        ys, xs = rng.integers(0, size, n_cells), rng.integers(0, size, n_cells)
        for comp, shift, radius in (("whole_cell", 0, cell_radius),
                                    ("nuclear", nuc_shift, nuc_radius)):
            seeds = np.zeros((size, size), np.int32)
            seeds[ys, np.minimum(xs + shift, size - 1)] = np.arange(1, n_cells + 1)
            dist, (iy, ix) = ndi.distance_transform_edt(seeds == 0,
                                                        return_indices=True)
            out[comp].append(np.where(dist <= radius, seeds[iy, ix], 0))
    return {comp: np.stack(m).astype(np.int32) for comp, m in out.items()}


def segment_inputs(rng, labels, k):
    """Values like the cell table's segment sums take: K = 3 is the centroid
    pass ([1, r, c]), K = 4 + C the central-moment pass with C channels.
    Returns the (H, W) labels and the (H*W, K) values, on the CPU."""
    import torch

    h, w = labels.shape
    if k == 3:
        rr, cc = np.mgrid[:h, :w].astype(np.float32)
        vals = np.stack([np.ones(h * w, np.float32), rr.ravel(), cc.ravel()], 1)
    else:
        vals = rng.gamma(1.0, 3.0, (h * w, k)).astype(np.float32)
    return torch.as_tensor(labels), torch.as_tensor(vals)


def check_segment_sum(masks_by_comp, name="dense"):
    """Phase 11, on 3 x 1024^2 masks (the dense ones, then the segmented
    ones, as `name` says): the plan kernel (each
    segment's bounding box, the background's included) against
    segment_boxes_plain, and the segment-sum kernel with the background row
    against index_add_ on a CPU copy, both bitwise, against a second CUDA
    run of itself with a fresh plan, and against itself without the
    background (row 0 zero, rows 1: the same bits), at K = 3 and K = 44 on
    the whole-cell masks; then, on FOV 0, per-call times of the plan, of the
    sum given its plan without the background row (what the cell table
    launches) and with it (events, a batch and device time), of both, of the
    plain version and of CUDA index_add_, each beside its bound (the
    background row's is the larger of its bytes and its chain: one
    dependent add a background pixel, at the SM clock nvidia-smi reads under
    its load); and one FOV's segment sums as the default cell
    table makes them (marker_quantification's _compartment_features ->
    moment_and_channel_features: per compartment one plan, the K = 3 and the
    K = 44 pass). Returns (max error of the sums, max error of the boxes,
    timings)."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr

    masks = masks_by_comp["whole_cell"]
    rng = np.random.default_rng(44)
    timing = {}
    max_err, plan_err = 0.0, 0
    for k in (3, 4 + N_QUANT_CHANNELS):
        for i, lab in enumerate(masks):
            n_seg = int(lab.max()) + 1
            lab_cpu, val_cpu = segment_inputs(rng, lab, k)
            lab_gpu, val_gpu = lab_cpu.to(DEVICE), val_cpu.to(DEVICE)
            plan = sr.segment_plan(lab_gpu, n_seg)
            if plan.boxes is not None:            # CUDA plans carry the boxes
                boxes = sr.segment_boxes_plain(lab_gpu, n_seg)
                plan_err = max(plan_err, int((plan.boxes - boxes).abs().max()))
                check(torch.equal(plan.boxes, boxes), f"segment_plan FOV {i}: boxes "
                      f"differ from segment_boxes_plain")
            got = sr.segment_sum(val_gpu, lab_gpu, n_seg, plan)
            again = sr.segment_sum(val_gpu, lab_gpu, n_seg)
            cells_only = sr.segment_sum(val_gpu, lab_gpu, n_seg, plan, background=False)
            want = sr.segment_sum_plain(val_cpu, lab_cpu, n_seg)
            torch.cuda.synchronize()
            err = float((got.cpu() - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got.cpu(), want),
                  f"segment_sum K={k} FOV {i}: {int((got.cpu() != want).sum())} "
                  f"sums differ from index_add_ on the CPU (max {err})")
            check(bool((want[0] != 0).all()) and torch.equal(got[0].cpu(), want[0]),
                  f"segment_sum K={k} FOV {i}: the background row differs")
            check(torch.equal(got, again), f"segment_sum K={k} FOV {i}: two "
                  f"CUDA runs differ")
            check(not bool(cells_only[0].any()) and torch.equal(cells_only[1:], got[1:]),
                  f"segment_sum K={k} FOV {i}: background=False changes rows 1:")
            if i == 0:
                fg = int((lab > 0).sum())
                flat = lab_gpu.reshape(-1).long()
                box = sr.segment_boxes_plain(lab_gpu, n_seg).to(torch.int64)[1:]
                box = box[box[:, 1] >= box[:, 0]]          # present cells only
                box_px = ((box[:, 1] - box[:, 0] + 1) * (box[:, 3] - box[:, 2] + 1)).sum()
                t = {"plan_ms": time_ms(lambda: sr.segment_plan(lab_gpu, n_seg)),
                     "plain_plan_ms": time_ms(lambda: sr.segment_boxes_plain(lab_gpu,
                                                                             n_seg)),
                     "plan_device_ms": device_ms(lambda: sr.segment_plan(lab_gpu, n_seg)),
                     "ms": time_ms(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg, plan,
                                                          background=False)),
                     "device_ms": device_ms(lambda: sr.segment_sum(
                         val_gpu, lab_gpu, n_seg, plan, background=False)),
                     "batch_ms": batch_ms(lambda: sr.segment_sum(
                         val_gpu, lab_gpu, n_seg, plan, background=False)),
                     "bg_ms": time_ms(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg, plan)),
                     "bg_batch_ms": batch_ms(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg,
                                                                    plan), reps=5),
                     "bg_device_ms": device_ms(lambda: sr.segment_sum(val_gpu, lab_gpu,
                                                                      n_seg, plan)),
                     "plan_and_sum_ms": time_ms(lambda: sr.segment_sum(
                         val_gpu, lab_gpu, n_seg, background=False)),
                     "plain_ms": time_ms(lambda: sr.segment_sum_plain(val_gpu, lab_gpu,
                                                                      n_seg)),
                     "library_ms": time_ms(lambda: torch.zeros(
                         (n_seg, k), device=DEVICE).index_add_(0, flat, val_gpu)),
                     "library_batch_ms": batch_ms(lambda: torch.zeros(
                         (n_seg, k), device=DEVICE).index_add_(0, flat, val_gpu), reps=5),
                     # the foreground's values and every label read once, the
                     # sums written once; the plan: labels in, boxes out
                     "bound_ms": bound_ms(nbytes=4.0 * (fg * k + lab.size + n_seg * k))[0],
                     "plan_bound_ms": bound_ms(nbytes=4.0 * lab.size + 16.0 * n_seg)[0],
                     # the walk's label reads per foreground pixel (its cost model)
                     "box_over_cell": float(box_px) / max(fg, 1),
                     "bg_chain": int((lab == 0).sum()),
                     "sm_mhz": sm_clock_mhz(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg,
                                                                   plan), calls=200)}
                # with the background row every pixel's values are read, and
                # each column of row 0 is one chain of (background pixels) adds
                bg_bytes = 4.0 * (lab.size * k + lab.size + n_seg * k)
                t["bg_byte_bound_ms"] = bound_ms(nbytes=bg_bytes)[0]
                t["bg_chain_bound_ms"] = bound_ms(chain=t["bg_chain"], mhz=t["sm_mhz"])[0]
                t["bg_bound_ms"], t["bg_bound_by"] = bound_ms(
                    nbytes=bg_bytes, chain=t["bg_chain"], mhz=t["sm_mhz"])
                timing[k] = t
        t = timing[k]
        print(f"segment_sum K={k} on {len(masks)} x {masks[0].shape} {name} masks "
              f"({[int(m.max()) for m in masks]} max labels): bitwise equal to "
              f"index_add_ on the CPU, the background row included, and across two "
              f"CUDA runs, boxes equal to the plain version's; FOV 0 per call (CUDA "
              f"events, median of 10): "
              f"plan {t['plan_ms']:.4f} ms (device {fmt_ms(t['plan_device_ms'])}; bound "
              f"{t['plan_bound_ms']:.4f}, share {share(t['plan_bound_ms'], t['plan_ms']):.2f},"
              f" {share(t['plan_bound_ms'], t['plan_device_ms']):.2f} of the device time; "
              f"plain {t['plain_plan_ms']:.4f}), sum given its plan {t['ms']:.4f} ms "
              f"(device {fmt_ms(t['device_ms'])}, {t['batch_ms']:.4f} ms a call in a "
              f"batch of 20; bound {t['bound_ms']:.4f}, share "
              f"{share(t['bound_ms'], t['ms']):.2f}, "
              f"{share(t['bound_ms'], t['device_ms']):.2f} of the device time), "
              f"plan and sum "
              f"{t['plan_and_sum_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, CUDA "
              f"index_add_ {t['library_ms']:.4f} ms; box area / cell area "
              f"{t['box_over_cell']:.3f}")
        print(f"segment_sum K={k} with the background row, FOV 0 of the {name} masks "
              f"({t['bg_chain']} background pixels) [{CARD}]: events {t['bg_ms']:.4f} ms, "
              f"batch of 5 {t['bg_batch_ms']:.4f} ms, device {fmt_ms(t['bg_device_ms'])} "
              f"(the walk's and the background kernel's launches); CUDA index_add_ "
              f"events {t['library_ms']:.4f} ms, batch {t['library_batch_ms']:.4f} ms; "
              f"byte bound {t['bg_byte_bound_ms']:.4f} ms, chain bound "
              f"{t['bg_chain_bound_ms']:.4f} ms ({t['bg_chain']} adds x "
              f"{FADD_LATENCY_CYCLES} cycles at {t['sm_mhz']:.0f} MHz), so bound "
              f"{t['bg_bound_ms']:.4f} ms by {t['bg_bound_by']}: share "
              f"{share(t['bg_bound_ms'], t['bg_batch_ms']):.3f} of the batch time, "
              f"{share(t['bg_bound_ms'], t['bg_device_ms']):.3f} of the device time")
    values = {}
    for comp in ("whole_cell", "nuclear"):
        lab = masks_by_comp[comp][0]
        values[comp] = (torch.as_tensor(lab, device=DEVICE), int(lab.max()) + 1,
                        *(segment_inputs(rng, lab, k)[1].to(DEVICE)
                          for k in (3, 4 + N_QUANT_CHANNELS)))

    def fov_sums():
        for lab, n_seg, v3, v44 in values.values():
            plan = sr.segment_plan(lab, n_seg)
            sr.segment_sum(v3, lab, n_seg, plan, background=False)
            sr.segment_sum(v44, lab, n_seg, plan, background=False)

    timing["fov_ms"] = time_ms(fov_sums)
    timing["fov_device_ms"] = device_ms(fov_sums)
    cols = 3 + 4 + N_QUANT_CHANNELS        # both passes' columns
    timing["fov_bound_ms"] = sum(
        bound_ms(nbytes=4.0 * (int((lab > 0).sum()) * cols + 2 * lab.numel()
                               + n_seg * cols) + 4.0 * lab.numel() + 16.0 * n_seg)[0]
        for lab, n_seg, _, _ in values.values())
    print(f"segment sums of one {name} FOV's default cell table (2 compartments x "
          f"(plan, K=3, K={4 + N_QUANT_CHANNELS})): {timing['fov_ms']:.4f} ms (CUDA "
          f"events, median of 10), device {fmt_ms(timing['fov_device_ms'])}, bound "
          f"{timing['fov_bound_ms']:.4f} ms, share "
          f"{share(timing['fov_bound_ms'], timing['fov_ms']):.2f}, "
          f"{share(timing['fov_bound_ms'], timing['fov_device_ms']):.2f} of the device "
          f"time")
    return max_err, plan_err, timing


def check_background_row(masks, seed=46):
    """The background row's kernel beyond the cell table's shapes, each sum
    bitwise against segment_sum_plain on a CPU copy (NaN where it has NaN),
    and background=False keeping rows 1:'s bits: FOV 0 of `masks` (H, W)
    at K = 1, 9 and 130 (the column groups of 8 and 4, and 17 blocks), and
    at K = 5 with NaN, +-inf and -0.0 (row 0 of an all -0.0 column is
    +0.0); an image that is all background (one segment); and an image
    with no background (Voronoi cells over every pixel). Returns the cases
    checked."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr

    rng = np.random.default_rng(seed)
    lab = masks[0]
    size = lab.shape[0]
    special = rng.normal(size=(lab.size, 5)).astype(np.float32)
    for value in (np.nan, np.inf, -np.inf):
        special[rng.random(special.shape) < 0.01] = value
    special[:, 4] = -0.0
    no_background = dense_masks(seed=seed, n_fovs=1, size=size,
                                cell_radius=4 * size)["whole_cell"][0]
    cases = [(f"K={k}", lab, rng.gamma(1.0, 3.0, (lab.size, k)).astype(np.float32))
             for k in (1, 9, 130)]
    cases += [("K=5, NaN, +-inf, -0.0", lab, special),
              ("all background, K=44", np.zeros_like(lab),
               rng.gamma(1.0, 3.0, (lab.size, 44)).astype(np.float32)),
              ("no background, K=44", no_background,
               rng.gamma(1.0, 3.0, (lab.size, 44)).astype(np.float32))]
    check(not (no_background == 0).any(), "the no-background image has background")
    for what, labels, vals in cases:
        n_seg = int(labels.max()) + 1
        lab_cpu, val_cpu = torch.as_tensor(labels), torch.as_tensor(vals)
        lab_gpu, val_gpu = lab_cpu.to(DEVICE), val_cpu.to(DEVICE)
        plan = sr.segment_plan(lab_gpu, n_seg)
        got = sr.segment_sum(val_gpu, lab_gpu, n_seg, plan)
        cells_only = sr.segment_sum(val_gpu, lab_gpu, n_seg, plan, background=False)
        want = sr.segment_sum_plain(val_cpu, lab_cpu, n_seg)
        check(same_bits(got, want), f"segment_sum {what}: "
              f"{int((got.cpu() != want).sum())} sums differ from index_add_ on the CPU")
        check(not bool(cells_only[0].any()) and same_bits(cells_only[1:], got[1:]),
              f"segment_sum {what}: background=False changes rows 1:")
    print(f"segment_sum with the background row on {lab.shape} images [{CARD}]: "
          f"{', '.join(c[0] for c in cases)}: bitwise equal to index_add_ on the CPU "
          f"(NaN where it has NaN), rows 1: unchanged without the background")
    return [c[0] for c in cases]


def quant_cohort(masks_by_comp, seed=45):
    """Per FOV: (segmentation DataArray (1, H, W, 2), image DataArray
    (1, H, W, 40)). Each cell gets a seeded expression per channel, times
    its whole-cell mask, plus Poisson-like noise; also each cell's type
    (0-4), which the cell-clustering phase plants pixel clusters from."""
    from ark_tpu_torch.utils.labeled_array import DataArray

    rng = np.random.default_rng(seed)
    out = []
    for fov, (cells, nucs) in enumerate(zip(masks_by_comp["whole_cell"],
                                            masks_by_comp["nuclear"])):
        h, w = cells.shape
        n = int(cells.max()) + 1
        cell_type = rng.integers(0, 5, n)
        profile = rng.gamma(0.7, 2.0, (5, N_QUANT_CHANNELS)).astype(np.float32)
        expr = profile[cell_type] * rng.uniform(0.5, 1.5, (n, 1)).astype(np.float32)
        expr[0] = 0.0
        imgs = expr[cells] + rng.gamma(0.3, 0.5, (h, w, N_QUANT_CHANNELS)
                                       ).astype(np.float32)
        coords = {"fovs": [f"fov{fov}"], "rows": np.arange(h), "cols": np.arange(w)}
        seg = DataArray(np.stack([cells, nucs], -1)[None].astype(np.int32),
                        coords={**coords, "compartments": ["whole_cell", "nuclear"]})
        img = DataArray(imgs[None], coords={**coords, "channels": QUANT_CHANNELS})
        out.append((seg, img, cell_type))
    return out


def tables_agree(got, want, what, derived=DERIVED_COLUMNS):
    """The CPU tests' rule: same schema; sums bitwise, the `derived` columns
    within DERIVED_TOL. Returns the largest difference in a derived column."""
    check(list(got.columns) == list(want.columns) and
          list(got.dtypes) == list(want.dtypes), f"{what}: schemas differ")
    worst = 0.0
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        base = col[:-len("_nuclear")] if col.endswith("_nuclear") else col
        if base in derived:
            check(np.allclose(g, w, rtol=DERIVED_TOL, atol=DERIVED_TOL,
                              equal_nan=True), f"{what} {col}: beyond {DERIVED_TOL}")
            both = np.isfinite(g) & np.isfinite(w)
            if both.any():
                worst = max(worst, float(np.abs(g[both] - w[both]).max()))
        else:
            check(np.array_equal(g, w) or (g.dtype.kind == "f" and np.array_equal(
                g, w, equal_nan=True)), f"{what} {col}: not bitwise equal")
    return worst


def run_cell_table(cohort, masks_name):
    """Phase 12: template 1's cell table for 3 x 1024^2 masks (`masks_name`:
    "segmented" by the device postprocess from the planted cohort, or
    "dense") with 40 channels, through create_marker_count_matrices on the
    card: nuclear counts and split_large_nuclei, the default regionprops
    (all convex features, num_concavities included), and fast_extraction;
    held against the CPU port. Returns the segment-sum launches of the CUDA
    run with the default regionprops, the plan kernel's launches in that
    run, and the CUDA tables."""
    import torch

    from ark_tpu_torch.ops import segment_reduce
    from ark_tpu_torch.segmentation import marker_quantification as mq

    kw = dict(nuclear_counts=True, split_large_nuclei=True)
    mq.create_marker_count_matrices(cohort[0][0], cohort[0][1], device=DEVICE,
                                    **kw)                            # warm-up
    torch.cuda.synchronize()
    tables, launches, plan_launches = {}, None, None
    for fast in (False, True):
        segment_reduce.segment_sum.launches = 0
        segment_reduce.segment_plan.launches = 0
        per_fov = []
        for seg, img, _ in cohort:
            timings = {}
            t0 = time.perf_counter()
            tables[fast, seg.coords["fovs"][0]] = mq.create_marker_count_matrices(
                seg, img, fast_extraction=fast, device=DEVICE, timings=timings, **kw)
            torch.cuda.synchronize()
            per_fov.append((time.perf_counter() - t0, timings))
        if not fast:
            launches = segment_reduce.segment_sum.launches
            plan_launches = segment_reduce.segment_plan.launches
            check(launches > 0 and plan_launches > 0, "the cell table never "
                  "launched the segment-sum and plan kernels")
        for wall, timings in per_fov:
            print(f"cell table {masks_name} masks, "
                  f"{'fast_extraction' if fast else 'default regionprops'}, "
                  f"1024^2 x {N_QUANT_CHANNELS}ch on cuda: {wall:.3f} s per FOV; "
                  + ", ".join(f"{k} {v:.4f}" for k, v in timings.items()))
    worst = 0.0
    for (fast, fov), (norm, arcsinh) in tables.items():
        seg, img, _ = next(c for c in cohort if c[0].coords["fovs"][0] == fov)
        t0 = time.perf_counter()
        cpu = mq.create_marker_count_matrices(seg, img, fast_extraction=fast,
                                              device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        n = len(norm)
        check(n > MIN_CELLS[masks_name] and np.isfinite(norm["cell_size"]).all(),
              f"cell table {masks_name} {fov}: {n} cells")
        for got, want, name in ((norm, cpu[0], "size-normalized"),
                                (arcsinh, cpu[1], "arcsinh")):
            worst = max(worst, tables_agree(got, want, f"{fov} {name}"))
        print(f"cell table {masks_name} {fov} fast_extraction={fast}: {n} cells, "
              f"{norm.shape[1]} columns, equal to the CPU port's (CPU run "
              f"{cpu_s:.3f} s)")
    print(f"cell table {masks_name} masks, CUDA vs CPU: sums bitwise, largest "
          f"derived-column difference {worst:.3g}")
    check(launches == 4 * len(cohort), f"segment_sum launches {launches}, "
          f"expected 4 per FOV (two passes per compartment)")
    check(plan_launches == 2 * len(cohort), f"segment_plan launches "
          f"{plan_launches}, expected 2 per FOV (one per compartment)")
    print(f"cell table {masks_name} masks: segment_sum launches {launches}, "
          f"segment_plan launches {plan_launches} for {len(cohort)} FOVs")
    return launches, plan_launches, tables


def run_cell_clustering(cohort, tables, tmp_dir):
    """Phase 13: template 3's device part on a ~100-FOV cell cohort: per-cell
    pixel-cluster counts from the masks and a seeded per-pixel cluster image,
    tiled to 102 FOVs; CellSOMCluster's normalization, 10x10 training and
    BMU assignment on the card, held against the CPU port given the same
    weights; the weighted channel product on the card against the CPU.
    Returns the cells (normalized counts) with their cell_som_cluster, and
    the names of the count columns."""
    import pandas as pd
    import torch

    from ark_tpu_torch.ops import som
    from ark_tpu_torch.phenotyping import (cell_cluster_utils, cluster_helpers,
                                           weighted_channel_comp)

    rng = np.random.default_rng(46)
    col = "pixel_som_cluster"
    per_fov = []
    for seg, _, cell_type in cohort:
        cells = seg.values[0, ..., 0]
        clusters = cell_type[cells] * 4 + rng.integers(0, 4, cells.shape) + 1
        per_fov.append((seg.coords["fovs"][0], cells.ravel(), clusters.ravel()))
    counts, count_cols = cell_cluster_utils.c2pc_counts_table(per_fov, col)
    sizes = pd.concat([table[["fov", "label", "cell_size"]]
                       for (fast, _), (table, _) in tables.items() if not fast])
    base = counts.merge(sizes, on=["fov", "label"])
    copies = []
    for i in range(COHORT_COPIES):
        c = base.copy()
        c["fov"] = [f"{f}_copy{i}" for f in c["fov"]]
        c[count_cols] = c[count_cols] + rng.integers(0, 2, c[count_cols].shape)
        copies.append(c)
    cells = pd.concat(copies, ignore_index=True)
    norm = cells.copy()
    norm[count_cols] = norm[count_cols].div(norm["cell_size"], axis=0)
    fovs = list(norm["fov"].unique())

    t0 = time.perf_counter()
    pysom = cluster_helpers.CellSOMCluster(
        norm, os.path.join(tmp_dir, "cell_som_weights.feather"), fovs, count_cols,
        device=DEVICE)
    norm_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pysom.train_som()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    som.bmu.launches = 0
    t0 = time.perf_counter()
    labeled = pysom.assign_som_clusters()
    torch.cuda.synchronize()
    assign_s = time.perf_counter() - t0
    launches = som.bmu.launches
    check(launches > 0, "the cell SOM's assignment never launched the BMU kernel")
    got = labeled["cell_som_cluster"].to_numpy()
    check(got.min() >= 1 and got.max() <= 100, "cell SOM labels outside 1..100")

    data = np.array(pysom.cell_data[count_cols], dtype=np.float32)
    weights = np.array(pysom.weights, dtype=np.float32)
    want, _ = som.som_map(weights, data, return_dist=False, device="cpu")
    ties = near_ties(plain_d(torch.as_tensor(weights), torch.as_tensor(data))).numpy()
    differ = got != want
    check(not (differ & ~ties).any(), f"cell SOM: {int((differ & ~ties).sum())} "
          f"assignments differ from the CPU port's outside near-ties")
    w_cpu = som.som_train(data, device="cpu")
    print(f"cell SOM {len(data)} cells x {len(count_cols)} columns, {len(fovs)} FOVs "
          f"on cuda: normalize {norm_s:.4f} s, 10x10 train {train_s:.4f} s, assign "
          f"{assign_s:.4f} s (BMU launches {launches}); assignments equal to the "
          f"CPU port's given the same weights ({int(differ.sum())} differ, "
          f"{int(ties.sum())} near-ties); CPU-trained weights differ by at most "
          f"{float(np.abs(w_cpu - weights).max()):.3g}")

    avg = pd.DataFrame(rng.random((N_PIXEL_CLUSTERS, N_QUANT_CHANNELS)),
                       columns=QUANT_CHANNELS)
    avg[col] = np.arange(1, N_PIXEL_CLUSTERS + 1)
    t0 = time.perf_counter()
    wc = weighted_channel_comp.compute_p2c_weighted_channel_avg(
        avg, QUANT_CHANNELS, cells, pixel_cluster_col=col, device=DEVICE)
    wc_s = time.perf_counter() - t0
    wc_cpu = weighted_channel_comp.compute_p2c_weighted_channel_avg(
        avg, QUANT_CHANNELS, cells, pixel_cluster_col=col, device="cpu")
    check(np.allclose(wc[QUANT_CHANNELS].to_numpy(), wc_cpu[QUANT_CHANNELS].to_numpy(),
                      rtol=MATMUL_RTOL, atol=0), "weighted channel product: CUDA "
          "and CPU differ")
    print(f"weighted channel product ({len(cells)} x {len(count_cols)}) . "
          f"({len(count_cols)} x {N_QUANT_CHANNELS}) on cuda: {wc_s:.4f} s with the "
          f"table around it, within rtol {MATMUL_RTOL} of the CPU")
    return labeled, count_cols


# --- spatial analysis (the neighborhood_analysis, mixing_scores,
# cell_neighbors_analysis and spatial_enrichment templates)

CARD = "no card"               # the card's name and power limit, set by main()
SPATIAL_TYPES = [f"pheno{i:02d}" for i in range(20)]
SPATIAL_CHANNELS = [f"chan{i}" for i in range(8)]
# BASELINE config 5: 50,000 cells on a 5000-px stage, in 4096-row blocks
BIG_CELLS, BIG_STAGE, BIG_BLOCK = 50_000, 5000.0, 4096
# squared distances above D = 4 sum D products in another order on each
# device: within 4 (D - 1) units of 2^-24 (|a|^2 + |b|^2), as in the CPU tests
F32_EPS = 2.0 ** -24
# float sums of the spatial steps run in another order on the card: k-NN
# means within 1e-6 (as the CPU tests hold them to the JAX package),
# inertia and silhouette within 1e-5
KNN_RTOL, SWEEP_RTOL = 1e-6, 1e-5
SPATIAL_TEMPLATE = dict(distlim=50, cluster_num=6, k=5, dist_lim=100,
                        bootstrap_num=100)
# phase (c) times the card on all 10 FOVs and holds it to the CPU port on
# the first 4 (12,000 cells): the CPU replay of all 10 took 104-141 s of the run
SPATIAL_REPLAY_FOVS = 4


def spatial_cohort(seed=48, n_fovs=10, n_cells=3000, size=1024, n_niches=6,
                   spread=60.0):
    """A cell table with spatial structure, the size of a users' cohort (the
    cohort benchmark's n_fovs=10, cells_per_fov=3000, 20 phenotypes): per
    FOV `n_niches` niche centres; cells of the first half of the phenotypes
    gather around their niche (type t around niche t mod n_niches, normal
    with sd `spread`), the rest lie uniform. Columns as a cell table's:
    cell_size, channels, label, centroids, fov, cell_meta_cluster."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    n_types = len(SPATIAL_TYPES)
    profile = rng.gamma(0.7, 2.0, (n_types, len(SPATIAL_CHANNELS)))
    frames = []
    for f in range(n_fovs):
        niches = rng.uniform(0.15 * size, 0.85 * size, (n_niches, 2))
        types = rng.integers(0, n_types, n_cells)
        pts = rng.uniform(0, size, (n_cells, 2))
        near = types < n_types // 2
        pts[near] = niches[types[near] % n_niches] + rng.normal(0, spread, (near.sum(), 2))
        pts = np.clip(pts, 0, size - 1)
        frame = pd.DataFrame(profile[types] * rng.uniform(0.5, 1.5, (n_cells, 1)),
                             columns=SPATIAL_CHANNELS)
        frame.insert(0, "cell_size", rng.integers(80, 400, n_cells).astype(float))
        frame["label"] = np.arange(1, n_cells + 1)
        frame["centroid-0"], frame["centroid-1"] = pts[:, 0], pts[:, 1]
        frame["fov"] = f"fov{f}"
        frame["cell_meta_cluster"] = [SPATIAL_TYPES[t] for t in types]
        frames.append(frame)
    return pd.concat(frames, ignore_index=True)


def check_distances(rng):
    """Spatial phase (a): the distance rules on the card against the CPU
    port. D = 2: 3000 cells on a 1024^2 stage and a pair 1.5 px apart at
    the far corner of a 5000-px stage, bitwise, exact-zero diagonal, the
    close pair kept; D = 20, within the summation-order bound; neighbor
    counts of 50,000 cells in 4096-row blocks, the first block bitwise
    against the CPU port. Returns the timings."""
    import torch

    from ark_tpu_torch.ops import distances as dist_ops

    t = {}
    pts = np.concatenate([rng.uniform(0, 1024, (3000, 2)),
                          [[5000.0, 5000.0], [5000.0, 4998.5]]]).astype(np.float32)
    on_cpu = dist_ops.pairwise_distances(torch.as_tensor(pts), torch.as_tensor(pts),
                                         zero_diagonal=True)
    dev = torch.as_tensor(pts, device=DEVICE)
    got = dist_ops.pairwise_distances(dev, dev, zero_diagonal=True)
    check(torch.equal(got.cpu(), on_cpu), f"D = 2 distances: "
          f"{int((got.cpu() != on_cpu).sum())} differ from the CPU port's")
    check(bool((torch.diagonal(got) == 0).all()), "D = 2: the diagonal is not 0")
    check(float(got[-2, -1]) == 1.5 == float(got[-1, -2]),
          f"the far-corner pair 1.5 px apart: d = {float(got[-2, -1])}")
    t["d2_ms"] = time_ms(lambda: dist_ops.pairwise_distances(dev, dev, zero_diagonal=True))
    n = len(pts)
    # the centroids read once, the (N, N) f32 matrix written once
    t["d2_bound_ms"] = bound_ms(nbytes=4.0 * (2 * n * 2 + n * n), flop=3.0 * 2 * n * n)[0]

    x = rng.poisson(3.0, (3000, 20)).astype(np.float32)
    sq_cpu = dist_ops.squared_distances(torch.as_tensor(x), torch.as_tensor(x),
                                        zero_diagonal=True).double()
    xd = torch.as_tensor(x, device=DEVICE)
    sq = dist_ops.squared_distances(xd, xd, zero_diagonal=True).cpu().double()
    norms = (torch.as_tensor(x).double() ** 2).sum(1)
    limit = 4 * 19 * F32_EPS * (norms[:, None] + norms[None, :])
    worst = float(((sq - sq_cpu).abs() / limit).max())
    check(worst <= 1.0, f"D = 20 squared distances beyond the summation-order "
          f"bound: {worst:.3g} of it")
    check(bool((torch.diagonal(sq) == 0).all()), "D = 20: the diagonal is not 0")
    t["d20_bound_share"] = worst

    coords = rng.uniform(0, BIG_STAGE, (BIG_CELLS, 2)).astype(np.float32)
    onehot = np.eye(len(SPATIAL_TYPES), dtype=np.float32)[
        rng.integers(0, len(SPATIAL_TYPES), BIG_CELLS)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counts = dist_ops.blocked_neighbor_counts(coords, onehot, 50.0,
                                              block_rows=BIG_BLOCK, device=DEVICE)
    t["big_s"] = time.perf_counter() - t0
    t["big_peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    first = dist_ops._neighbor_count_block(
        torch.as_tensor(coords[:BIG_BLOCK]), torch.as_tensor(coords),
        torch.as_tensor(onehot), 50.0, 0).numpy()
    check(np.array_equal(counts[:BIG_BLOCK], first), f"neighbor counts of "
          f"{BIG_CELLS} cells: the first block differs from the CPU port's at "
          f"{int((counts[:BIG_BLOCK] != first).sum())} entries")
    check(counts.sum() % 2 == 0 and counts.sum() > 0, "neighbor counts are not "
          "symmetric pair counts")
    print(f"spatial distances on {DEVICE} [{CARD}]: D=2 {n} cells bitwise equal to "
          f"the CPU port, exact-zero diagonal, far-corner pair d = 1.5; "
          f"{t['d2_ms']:.4f} ms per (N, N) matrix (CUDA events, median of 10; "
          f"bound {t['d2_bound_ms']:.4f} ms); D=20 within {worst:.3g} of the "
          f"summation-order bound; neighbor counts of {BIG_CELLS} cells in "
          f"{BIG_BLOCK}-row blocks {t['big_s']:.3f} s, peak device memory "
          f"{t['big_peak_gib']:.2f} GiB, first block bitwise equal to the CPU port, "
          f"{int(counts.sum())} neighbor pairs")
    return t


def check_enrichment_null(table):
    """Spatial phase (b): one FOV's enrichment (3000 cells, 20 phenotypes,
    dist_lim 100, B = 100) on the card and on the CPU port, given the same
    permutations: observed counts, the null and every statistic bitwise.
    Times the null's products on the card. Returns the timings."""
    import torch

    from ark_tpu_torch.analysis import spatial_enrichment as se
    from ark_tpu_torch.ops import distances as dist_ops

    fov = table[table["fov"] == "fov0"]
    pts = fov[["centroid-0", "centroid-1"]].to_numpy(np.float32)
    dist = dist_ops.cdist(pts, device="cpu")
    types = fov["cell_meta_cluster"].to_numpy()
    pos = np.stack([(types == t) for t in SPATIAL_TYPES]).astype(np.float32)
    b = SPATIAL_TEMPLATE["bootstrap_num"]
    perms = se.draw_permutations(len(pts), b, seed=42)
    got = se._enrichment(dist, pos, SPATIAL_TEMPLATE["dist_lim"], perms, DEVICE)
    want = se._enrichment(dist, pos, SPATIAL_TEMPLATE["dist_lim"], perms, "cpu")
    for key, val in want.items():
        check(np.array_equal(got[key], val), f"enrichment {key}: CUDA and CPU differ")
    dist_bin = dist_ops.close_pairs(torch.as_tensor(dist, device=DEVICE),
                                    SPATIAL_TEMPLATE["dist_lim"])
    pos_dev = torch.as_tensor(pos, device=DEVICE)
    perms_dev = perms.to(DEVICE)
    m, n = pos.shape
    t = {"null_ms": time_ms(lambda: se._permutation_null(dist_bin, pos_dev, perms_dev)),
         "null_device_ms": device_ms(lambda: se._permutation_null(dist_bin, pos_dev,
                                                                  perms_dev)),
         "null_bound_ms": bound_ms(nbytes=4.0 * (n * n + m * n + b * m * m) + 8.0 * b * n,
                                   flop=2.0 * b * m * n * (n + m))[0],
         "draw_ms": wall_ms(lambda: se.draw_permutations(n, b, seed=42))}
    t["null_perms_per_s"] = b / (t["null_ms"] / 1e3)
    print(f"enrichment null {n} cells x {m} phenotypes x B={b} on {DEVICE} [{CARD}]: "
          f"observed counts, null and statistics bitwise equal to the CPU port "
          f"given the same permutations; null products {t['null_ms']:.4f} ms "
          f"(CUDA events, median of 10; device {fmt_ms(t['null_device_ms'])}; f32 "
          f"bound {t['null_bound_ms']:.4f} ms), {t['null_perms_per_s']:.0f} "
          f"permutations/s; drawing the {b} permutations on the host "
          f"{t['draw_ms']:.4f} ms")
    return t


def spatial_steps(table, base, device, target, reference):
    """The spatial templates' steps with their defaults, on `device`:
    distance matrices to netCDF, the neighborhood matrix (distlim 50), the
    inertia and silhouette sweeps (k = 2..10), the cluster results
    (cluster_num 6), mixing scores, Shannon diversity, mean k-NN distances
    (k = 5) and the enrichment of every FOV (dist_lim 100, B = 100).
    Returns (outputs, seconds per step, calc_dist_matrix's split)."""
    import pandas as pd
    import torch

    from ark_tpu_torch.analysis import cell_neighborhood_stats as cns
    from ark_tpu_torch.analysis import neighborhood_analysis as na
    from ark_tpu_torch.analysis import spatial_analysis_utils as sau
    from ark_tpu_torch.analysis import spatial_enrichment as se

    cfg = SPATIAL_TEMPLATE
    dist_dir, nb_dir = os.path.join(base, "dist_mats"), os.path.join(base, "nb")
    os.makedirs(dist_dir)
    os.makedirs(nb_dir)
    fovs = list(table["fov"].unique())
    seconds, split, out = {}, {}, {"dist_dir": dist_dir}

    def step(name, fn):
        t0 = time.perf_counter()
        result = fn()
        if device != "cpu":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    step("calc_dist_matrix", lambda: sau.calc_dist_matrix(table, dist_dir, device=device,
                                                          timings=split))
    counts, freqs = step("neighborhood_matrix", lambda: na.create_neighborhood_matrix(
        table, dist_dir, distlim=cfg["distlim"], device=device))
    out["counts"], out["freqs"] = counts, freqs
    out["inertia"] = step("inertia_sweep", lambda: na.compute_cluster_metrics_inertia(
        counts, device=device)).values
    out["silhouette"] = step("silhouette_sweep", lambda: na.compute_cluster_metrics_silhouette(
        counts, device=device)).values
    out["clusters"] = step("cluster_results", lambda: na.generate_cluster_matrix_results(
        table, counts, cluster_num=cfg["cluster_num"], device=device))
    out["mixing"] = step("mixing_scores", lambda: [na.compute_mixing_score(
        counts[counts["fov"] == f].copy(), target, reference, "percent") for f in fovs])
    freqs.to_csv(os.path.join(
        nb_dir, f"neighborhood_freqs-cell_meta_cluster_radius{cfg['distlim']}.csv"),
        index=False)
    out["diversity"] = step("diversity", lambda: cns.generate_neighborhood_diversity_analysis(
        nb_dir, cfg["distlim"], ["cell_meta_cluster"]))
    out["knn"] = step("cell_distances", lambda: cns.generate_cell_distance_analysis(
        table, dist_dir, os.path.join(base, "cell_distances.csv"), cfg["k"], device=device))

    def enrichment():
        results, tables = {}, []
        for fov in fovs:
            names, res = se.calculate_cluster_spatial_enrichment(
                fov, table, sau.load_dist_matrix(dist_dir, fov), dist_lim=cfg["dist_lim"],
                bootstrap_num=cfg["bootstrap_num"], device=device)
            results[fov] = res
            stats = se.generate_enrichment_stats_table(names, res)
            stats.insert(0, "fov", fov)
            tables.append(stats)
        return results, pd.concat(tables, ignore_index=True)

    out["enrichment"], out["enrichment_table"] = step("enrichment", enrichment)
    return out, seconds, split


def spatial_outputs_agree(got, want, fovs, what):
    """Spatial steps on the card against the CPU port: distance files,
    neighborhood matrices, cluster results, mixing, diversity and the
    enrichment bitwise; k-NN means within KNN_RTOL; the sweeps within
    SWEEP_RTOL."""
    import pandas as pd

    from ark_tpu_torch.analysis import spatial_analysis_utils as sau

    for fov in fovs:
        a = sau.load_dist_matrix(got["dist_dir"], fov)
        b = sau.load_dist_matrix(want["dist_dir"], fov)
        check(np.array_equal(a.values, b.values) and all(
            np.array_equal(a.coords[d], b.coords[d]) for d in a.dims),
            f"{what} {fov}: distance files differ")
    for key in ("counts", "freqs", "diversity"):
        try:
            pd.testing.assert_frame_equal(got[key], want[key], check_exact=True)
        except AssertionError as e:
            raise SmokeFailure(f"{what} {key}: CUDA and CPU differ: {e}") from e
    for key in ("inertia", "silhouette"):
        check(np.allclose(got[key], want[key], rtol=SWEEP_RTOL, atol=0),
              f"{what} {key} sweep: {got[key]} vs {want[key]}")
    for g, w in zip(got["clusters"], want["clusters"]):
        try:
            pd.testing.assert_frame_equal(g, w, check_exact=True)
        except AssertionError as e:
            raise SmokeFailure(f"{what} k-means cluster results differ: {e}") from e
    check(all(a == b or (np.isnan(a[0]) and np.isnan(b[0]) and a[1] == b[1])
              for a, b in zip(got["mixing"], want["mixing"])),
          f"{what} mixing scores: {got['mixing']} vs {want['mixing']}")
    try:
        pd.testing.assert_frame_equal(got["knn"], want["knn"], rtol=KNN_RTOL)
        pd.testing.assert_frame_equal(got["enrichment_table"], want["enrichment_table"],
                                      check_exact=True)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: CUDA and CPU differ: {e}") from e
    for fov in fovs:
        for key in ("close_num", "close_num_rand", "z", "p_adj"):
            check(np.array_equal(got["enrichment"][fov][key], want["enrichment"][fov][key]),
                  f"{what} {fov} enrichment {key}: CUDA and CPU differ")


def device_totals(fn):
    """(fn's result, device seconds, kernels and copies) of one call of `fn`
    under torch.profiler, summed over its raw events: ``key_averages`` builds
    a Python object per event, minutes for the ~185,000 of an LDA fit."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        result = fn()
        torch.cuda.synchronize()
    device = [e for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    return result, sum(e.duration_ns() for e in device) / 1e9, len(device)


def device_events(fn):
    """torch.profiler's device-side entries (kernels and copies, summed by
    name) of one call of `fn`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def device_profile(fn):
    """(device seconds, the three entries with the most device time) of one
    call of `fn`."""
    events = device_events(fn)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    return (sum(e.self_device_time_total for e in events) / 1e6,
            [(e.key[:60], e.self_device_time_total / 1e6) for e in top])


def run_spatial_stage(table, name, target, reference, replay_fovs=None):
    """Spatial phases (c) and (d): the templates' steps on the card, then on
    the CPU port, held to each other; prints seconds per step,
    permutations per second, the share of calc_dist_matrix's wall spent
    writing netCDF, and the device's busy share (a second card run under
    the profiler). With `replay_fovs`, the card is timed on the whole table
    and held to the CPU port on the table's first `replay_fovs` FOVs (one
    more card run there): the CPU's silhouette sweep is quadratic in the
    cells. Returns the card's seconds per step."""
    from ark_tpu_torch.ops import segment_reduce, som, watershed

    counters = (som.bmu, watershed.claim_round, segment_reduce.segment_sum,
                segment_reduce.segment_plan)
    fovs = list(table["fov"].unique())
    with tempfile.TemporaryDirectory() as base:
        for fn in counters:
            fn.launches = 0
        os.makedirs(os.path.join(base, "cuda"))
        got, seconds, split = spatial_steps(table, os.path.join(base, "cuda"), DEVICE,
                                            target, reference)
        launches = [fn.launches for fn in counters]
        os.makedirs(os.path.join(base, "profiled"))
        busy_s, top = device_profile(lambda: spatial_steps(
            table, os.path.join(base, "profiled"), DEVICE, target, reference))
        held, held_fovs, held_got = table, fovs, got
        if replay_fovs is not None and replay_fovs < len(fovs):
            held_fovs = fovs[:replay_fovs]
            held = table[table["fov"].isin(held_fovs)].reset_index(drop=True)
            os.makedirs(os.path.join(base, "cuda_held"))
            held_got, _, _ = spatial_steps(held, os.path.join(base, "cuda_held"), DEVICE,
                                           target, reference)
        os.makedirs(os.path.join(base, "cpu"))
        t0 = time.perf_counter()
        want, _, _ = spatial_steps(held, os.path.join(base, "cpu"), "cpu", target,
                                   reference)
        cpu_s = time.perf_counter() - t0
        spatial_outputs_agree(held_got, want, held_fovs, name)
    total = sum(seconds.values())
    perms = len(fovs) * SPATIAL_TEMPLATE["bootstrap_num"]
    z = np.concatenate([r["z"].ravel() for r in got["enrichment"].values()])
    p_adj = np.concatenate([r["p_adj"].ravel() for r in got["enrichment"].values()])
    print(f"spatial stage {name} ({len(fovs)} FOVs, {len(table)} cells, "
          f"{table['cell_meta_cluster'].nunique()} phenotypes) on {DEVICE} [{CARD}]: "
          f"{total:.3f} s; per step " + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f"; enrichment {perms / seconds['enrichment']:.1f} permutations/s; "
          f"calc_dist_matrix: netCDF writes {split['netcdf_write_s']:.4f} s "
          f"({split['netcdf_write_s'] / seconds['calc_dist_matrix']:.1%} of its wall), "
          f"waiting for distances {split['distances_s']:.4f} s; every step equal to "
          f"the CPU port's on {len(held_fovs)} FOVs, {len(held)} cells (CPU run "
          f"{cpu_s:.3f} s); kernel launches (bmu, claim, "
          f"segment_sum, segment_plan) {launches}")
    print(f"spatial stage {name}: device busy {busy_s:.4f} s of the {total:.3f} s "
          f"stage ({busy_s / total:.1%}, profiled run); most device time: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in top))
    print(f"spatial stage {name}: {len(got['counts'])} cells with neighbors, "
          f"inertia k=2..10 {np.round(got['inertia'], 1).tolist()}, silhouette "
          f"{np.round(got['silhouette'], 3).tolist()}, enrichment |z| max "
          f"{np.abs(z).max():.2f}, pairs with p_adj < 0.05: {int((p_adj < 0.05).sum())} "
          f"of {p_adj.size}")
    return seconds


def main_path_spatial_table(tables, labeled):
    """Spatial phase (d)'s input: the dense cohort's cell tables (default
    regionprops: centroids, cell size, channels) typed by the cell SOM's
    cluster of each cell's first copy in the cell-clustering cohort."""
    import pandas as pd

    first = labeled[labeled["fov"].str.endswith("_copy0")].copy()
    first["fov"] = first["fov"].str[:-len("_copy0")]
    keep = ["cell_size", *QUANT_CHANNELS, "label", "centroid-0", "centroid-1", "fov"]
    table = pd.concat([t[keep] for (fast, _), (t, _) in tables.items() if not fast],
                      ignore_index=True)
    table = table.merge(first[["fov", "label", "cell_som_cluster"]], on=["fov", "label"])
    table["cell_meta_cluster"] = "som" + table.pop("cell_som_cluster").astype(str)
    return table


# --- the classical image ops, fiber segmentation and ez_seg

# run_fiber_segmentation's defaults
FIBER_DEFAULTS = dict(blur=2, contrast_scaling_divisor=128, fiber_widths=(1, 3, 5, 7, 9),
                      ridge_cutoff=0.1, sobel_blur=1, min_fiber_size=15)
# the classical ops' floats, the card against the CPU port: of each output's
# largest magnitude (the CPU tests hold the port to the JAX package by the same)
CLASSICAL_RTOL, CLASSICAL_ATOL = 1e-5, 1e-6
# the near-threshold rule of the fiber labels. The ridge image is Frangi's
# response x 10000, and the response's factor 1 - exp(-S^2 / 2 gamma^2) is a
# difference from 1, so it moves in steps of 2^-24 (6e-4 after the scaling):
# a ridge value within three steps of ridge_cutoff may fall on either side. A
# blurred distance within DT_RTOL |cut| + DT_ATOL of a multi-Otsu cut may too.
RIDGE_TOL = 2e-3
DT_RTOL, DT_ATOL = 1e-5, 1e-6
# a flipped mask pixel moves the distance map around it, and the two sigma-1
# blurs after the EDT carry that 4 px each: an object within this many pixels
# of a near-threshold pixel counts as that pixel's
FLIP_REACH = 8
# the most pixels the rule may excuse, as a share of the image
EXCUSED_SHARE = 2e-3


def fiber_image(rng, size=1024, n_fibers=60):
    """The fiber benchmark's relief: `n_fibers` planted ridges (Gaussian
    profile of sd 2 px, lengths 80-300 px, random angles) of height 0.6 on
    noise 0.05 +/- 0.02, clipped to [0, 1]. Noise alone gives Frangi nothing
    to enhance."""
    img = rng.normal(0.05, 0.02, size=(size, size)).astype(np.float32)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    for _ in range(n_fibers):
        x0, y0 = rng.uniform(0, size, 2)
        theta = rng.uniform(0, np.pi)
        length = rng.uniform(80, 300)
        nx, ny = -np.sin(theta), np.cos(theta)  # ridge normal
        tx, ty = np.cos(theta), np.sin(theta)
        t = (xx - x0) * tx + (yy - y0) * ty
        dist = np.abs((xx - x0) * nx + (yy - y0) * ny)
        prof = np.exp(-(dist ** 2) / (2 * 2.0 ** 2))
        prof *= ((t > 0) & (t < length))
        img += 0.6 * prof
    return np.clip(img, 0, 1)


def near_threshold_pixels(steps, ridge_cutoff):
    """The pixels of a ``_fiber_steps`` run that float noise may move across
    a threshold: ridge values within RIDGE_TOL of `ridge_cutoff`, distances
    within DT_RTOL |cut| + DT_ATOL of a multi-Otsu cut."""
    from ark_tpu_torch.ops import classical

    dt = steps["distance_transformed"]
    near = np.abs(steps["ridges"] - ridge_cutoff) <= RIDGE_TOL
    for cut in classical.multi_otsu(dt, classes=3):
        near |= np.abs(dt - cut) <= DT_RTOL * abs(cut) + DT_ATOL
    return near


def fiber_labels_differ(got, want, ridge_cutoff):
    """The near-threshold rule for two runs of ``_fiber_steps`` (with their
    intermediates) on one image. A pixel differs when its pair of labels is
    not the pairing most of its two objects' pixels have (so renumbering
    does not count, and background is a label). It is excused only if, in
    `want`, its ridge value lies within RIDGE_TOL of `ridge_cutoff`, or its
    distance within DT_RTOL |cut| + DT_ATOL of a multi-Otsu cut, or its
    object (an 8-connected component of either run's fibers, grown by
    FLIP_REACH pixels) holds such a pixel. Returns (differing, excused, not excused)
    pixel counts."""
    from scipy import ndimage as ndi

    a, b = got["labeled_filtered"], want["labeled_filtered"]
    joint = np.bincount(a.ravel().astype(np.int64) * (int(b.max()) + 1) + b.ravel(),
                        minlength=(int(a.max()) + 1) * (int(b.max()) + 1)
                        ).reshape(int(a.max()) + 1, int(b.max()) + 1)
    differ = (joint.argmax(1)[a] != b) | (joint.argmax(0)[b] != a)
    if not differ.any():
        return 0, 0, 0
    near = near_threshold_pixels(want, ridge_cutoff)
    eight = np.ones((3, 3), bool)
    objects, _ = ndi.label(ndi.binary_dilation((a > 0) | (b > 0), structure=eight,
                                               iterations=FLIP_REACH), structure=eight)
    touched = np.unique(objects[near])
    excused = near | np.isin(objects, touched[touched > 0])
    return int(differ.sum()), int((differ & excused).sum()), int((differ & ~excused).sum())


def check_fiber_labels(got, want, ridge_cutoff, what):
    """Hold two fiber runs to the near-threshold rule; returns the text to
    print."""
    differ, excused, left = fiber_labels_differ(got, want, ridge_cutoff)
    size = want["labeled_filtered"].size
    check(left == 0, f"{what}: {left} label pixels differ away from any threshold")
    check(excused <= EXCUSED_SHARE * size, f"{what}: the near-threshold rule excused "
          f"{excused} pixels, more than {EXCUSED_SHARE:g} of the image")
    return (f"{differ} label pixels differ, {excused} excused by the near-threshold "
            f"rule (limit {int(EXCUSED_SHARE * size)}), {left} not")


def kernels_per_call(fn):
    """(device ms, kernels and copies launched) of one call of `fn` after
    one warm-up call."""
    import torch

    fn()
    torch.cuda.synchronize()
    events = device_events(fn)
    return (sum(e.self_device_time_total for e in events) / 1e3,
            sum(e.count for e in events))


def floats_agree(got, want, what):
    """`got` (a tensor on the card) against `want` (the CPU port's) within
    CLASSICAL_RTOL and CLASSICAL_ATOL of want's largest magnitude; returns
    the largest difference."""
    import torch

    got = got.cpu()
    check(got.shape == want.shape and bool(torch.isfinite(got).all()),
          f"{what}: shape {tuple(got.shape)} or not finite")
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    check(torch.allclose(got, want, rtol=CLASSICAL_RTOL, atol=CLASSICAL_ATOL * scale),
          f"{what}: the card and the CPU port differ by {err} (scale {scale})")
    return err


def check_classical_ops(img):
    """Phase (e): the classical ops on the card against the CPU port. The
    squared EDT bitwise (int32 min-plus) and its root bitwise: the planted
    FOV's ridge mask at 1024^2, an image with no background, one that is all
    background, a ragged (257, 1000) mask that crosses the 256-column block,
    and a 2048^2 mask (held to scipy's transform too), with the peak device
    memory. CLAHE, Frangi, Sobel and Meijering at 1024^2 within
    CLASSICAL_RTOL; each timed (CUDA events and device time) with its
    launches. Returns the timings."""
    import torch
    from scipy import ndimage as ndi

    from ark_tpu_torch.ops import classical, edt

    rng = np.random.default_rng(51)
    h = img.shape[0]
    x_cpu = torch.as_tensor(img / img.max())
    x = x_cpu.to(DEVICE)
    geometry = classical._clahe_geometry(h, h, h / FIBER_DEFAULTS["contrast_scaling_divisor"])
    widths = FIBER_DEFAULTS["fiber_widths"]
    contrast_cpu = classical._clahe_device(x_cpu, *geometry, 0.01, 256)
    ridges_cpu = classical._frangi_device(contrast_cpu, widths)
    masks = {"ridge mask": (ridges_cpu * 10000 > FIBER_DEFAULTS["ridge_cutoff"]).numpy(),
             "no background": np.ones((h, h), bool),
             "all background": np.zeros((h, h), bool),
             "ragged (257, 1000)": rng.random((257, 1000)) < 0.99,
             "2048^2": rng.random((2048, 2048)) < 0.999}
    t = {}
    for name, fg in masks.items():
        fg_dev = torch.as_tensor(fg, device=DEVICE)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        d2 = edt._edt2_int(fg_dev)
        torch.cuda.synchronize()
        peak = (torch.cuda.max_memory_allocated() - before) / 2 ** 20
        d2_cpu = edt._edt2_int(torch.as_tensor(fg))
        check(torch.equal(d2.cpu(), d2_cpu), f"squared EDT {name}: "
              f"{int((d2.cpu() != d2_cpu).sum())} pixels differ from the CPU port's")
        dist = edt.distance_transform_edt(fg_dev, device=DEVICE)
        dist_cpu = edt.distance_transform_edt(fg, device="cpu")
        check(torch.equal(dist.cpu(), dist_cpu), f"EDT {name}: the root differs from "
              f"the CPU port's")
        if fg.all():
            check(bool(torch.isinf(dist).all()), "EDT with no background is not +inf")
        else:
            want = np.rint(ndi.distance_transform_edt(fg) ** 2).astype(np.int32)
            check(np.array_equal(d2_cpu.numpy(), want), f"squared EDT {name} differs "
                  f"from scipy's")
        ms = time_ms(lambda: edt._edt2_int(fg_dev), reps=5)
        t[name] = (ms, peak)
        print(f"EDT {name} {fg.shape} on {DEVICE} [{CARD}]: squared transform and root "
              f"bitwise equal to the CPU port's"
              + ("" if fg.all() else ", squared transform equal to scipy's")
              + f"; {ms:.3f} ms per squared transform (CUDA events, median of 5), peak "
              f"device memory above its input {peak:.1f} MiB (pass-2 block limit "
              f"{edt.PASS2_BYTES / 2 ** 20:.0f} MiB)")
        del fg_dev, d2, dist

    contrast = classical._clahe_device(x, *geometry, 0.01, 256)
    dt_cpu = edt.distance_transform_edt(masks["ridge mask"], device="cpu")
    dt = dt_cpu.to(DEVICE)
    ops = {
        "CLAHE": (lambda: classical._clahe_device(x, *geometry, 0.01, 256), contrast_cpu),
        "Frangi": (lambda: classical._frangi_device(contrast, widths), ridges_cpu),
        "Sobel": (lambda: classical.sobel(dt), classical.sobel(dt_cpu)),
    }
    for name, (fn, want) in ops.items():
        err = floats_agree(fn(), want, name)
        ms = time_ms(fn, reps=5)
        dev_ms, launches = kernels_per_call(fn)
        t[name] = (ms, dev_ms, launches)
        print(f"{name} {h}^2 on {DEVICE} [{CARD}]: max |card - CPU port| {err:.3g} (scale "
              f"{float(want.abs().max()):.3g}); {ms:.3f} ms per call (CUDA events, median "
              f"of 5), device {dev_ms:.3f} ms in {launches} launches")
    sigmas = range(1, 5)
    binary = (x_cpu > 0.3).to(torch.float32).numpy()
    want = torch.as_tensor(classical.meijering(binary, sigmas, device="cpu"))
    err = floats_agree(torch.as_tensor(classical.meijering(binary, sigmas, device=DEVICE)),
                       want, "Meijering")
    ms = wall_ms(lambda: classical.meijering(binary, sigmas, device=DEVICE), reps=3)
    dev_ms, launches = kernels_per_call(
        lambda: classical.meijering(binary, sigmas, device=DEVICE))
    t["Meijering"] = (ms, dev_ms, launches)
    print(f"Meijering {h}^2 sigmas 1-4 on {DEVICE} [{CARD}]: max |card - CPU port| "
          f"{err:.3g}; {ms:.3f} ms per call with its upload and readback (host clock, "
          f"median of 3), device {dev_ms:.3f} ms in {launches} launches")
    return t


def run_fiber_stage(img):
    """Phase (f): the fiber stage on the planted 1024^2 FOV on the card,
    through ``_fiber_steps(keep_intermediates=False)`` (what
    ``run_fiber_segmentation`` runs per FOV), ``_fiber_regionprops_table``
    and ``calculate_fiber_alignment``: FOVs per second over 3 timed calls
    after a warm one, seconds per step of a synchronised call, the device's
    busy share under the profiler, the segment-sum launches, and the labels
    held to the CPU port's by the near-threshold rule. Returns (segment-sum
    launches, plan launches, timings)."""
    import torch

    from ark_tpu_torch import settings
    from ark_tpu_torch.ops import segment_reduce
    from ark_tpu_torch.segmentation import fiber_segmentation as fs

    size = img.shape[0]
    cutoff = FIBER_DEFAULTS["ridge_cutoff"]

    def fov(x, device=DEVICE, **kw):
        steps = fs._fiber_steps(x, size, *FIBER_DEFAULTS.values(), device=device, **kw)
        table = fs._fiber_regionprops_table(steps["labeled_filtered"],
                                            settings.FIBER_OBJECT_PROPS, device=device)
        table.insert(0, settings.FOV_ID, "fov0")
        return steps, fs.calculate_fiber_alignment(table, device=device)

    fov(img, keep_intermediates=False)                                 # warm-up
    torch.cuda.synchronize()
    segment_reduce.segment_sum.launches = 0
    segment_reduce.segment_plan.launches = 0
    steps_only, walls = [], []
    for i in range(3):
        x = img * np.float32(1.0 + 1e-4 * (i + 1))
        t0 = time.perf_counter()
        fs._fiber_steps(x, size, *FIBER_DEFAULTS.values(), keep_intermediates=False,
                        device=DEVICE)
        steps_only.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        fov(x, keep_intermediates=False)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    launches = segment_reduce.segment_sum.launches
    plan_launches = segment_reduce.segment_plan.launches
    check(launches == 9 and plan_launches == 6, f"fiber property tables of 3 FOVs: "
          f"segment_sum launches {launches} (expected 9: two moment passes and the "
          f"Euler numbers), segment_plan launches {plan_launches} (expected 6)")
    split = {}
    steps = fs._fiber_steps(img, size, *FIBER_DEFAULTS.values(), keep_intermediates=False,
                            device=DEVICE, timings=split)
    t0 = time.perf_counter()
    table = fs._fiber_regionprops_table(steps["labeled_filtered"],
                                        settings.FIBER_OBJECT_PROPS, device=DEVICE)
    torch.cuda.synchronize()
    split["property_table_s"] = time.perf_counter() - t0
    table.insert(0, settings.FOV_ID, "fov0")
    t0 = time.perf_counter()
    fs.calculate_fiber_alignment(table, device=DEVICE)
    split["alignment_s"] = time.perf_counter() - t0
    busy_s, top = device_profile(lambda: fov(img, keep_intermediates=False))
    wall = float(np.median(walls))
    device_steps = ("blur_s", "clahe_s", "frangi_s", "edt_s", "sobel_s")
    t = {"fov_s": wall, "steps_s": float(np.median(steps_only)), "busy_s": busy_s,
         "split": split, "device_program_s": sum(split[k] for k in device_steps)}

    got, got_table = fov(img, keep_intermediates=True)
    t0 = time.perf_counter()
    want, want_table = fov(img, device="cpu", keep_intermediates=True)
    cpu_s = time.perf_counter() - t0
    n_fibers = len(got_table)
    check(n_fibers >= 10 and got["labeled_filtered"].dtype == np.int32
          and got["labeled_filtered"].shape == img.shape, f"fiber stage: {n_fibers} fibers")
    check(np.isfinite(got_table[["area", "major_axis_length", "orientation"]].to_numpy()
                      ).all() and got_table["alignment_score"].notna().any(),
          "fiber table: a property is not finite, or no fiber has an alignment score")
    excused = check_fiber_labels(got, want, cutoff, "fiber labels, card against CPU port")
    if np.array_equal(got["labeled_filtered"], want["labeled_filtered"]):
        worst = tables_agree(got_table, want_table, "fiber table",
                             DERIVED_COLUMNS | {"orientation", "alignment_score"})
        table_note = f"property tables equal (derived columns within {worst:.3g})"
    else:
        table_note = "property tables not compared (the labels differ)"
    print(f"fiber stage {size}^2 planted FOV on {DEVICE} [{CARD}]: {wall:.4f} s per FOV "
          f"with its property table and alignment ({1 / wall:.2f} FOVs/s; median of 3 "
          f"after a warm call, walls {[round(w, 4) for w in walls]}); _fiber_steps alone "
          f"{t['steps_s']:.4f} s ({1 / t['steps_s']:.2f} FOVs/s); {n_fibers} fibers, "
          f"{int(got_table['alignment_score'].notna().sum())} with an alignment score; "
          f"segment_sum launches {launches}, segment_plan launches {plan_launches} for 3 "
          f"FOVs; seconds per step (synchronised call): "
          + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
          + f"; device program {t['device_program_s']:.4f} s")
    print(f"fiber stage: device busy {busy_s:.4f} s of the {wall:.4f} s FOV "
          f"({busy_s / wall:.1%}, profiled run); most device time: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in top))
    print(f"fiber stage, card against CPU port (CPU run {cpu_s:.3f} s): {excused}; "
          f"{table_note}")
    return launches, plan_launches, t


def ez_seg_image(rng, img):
    """ez_seg's input at the fiber FOV's size: the planted ridges (the
    projections) plus 40 bright disks of radius 6-20 px (the blobs)."""
    size = img.shape[0]
    out = img.copy()
    yy, xx = np.mgrid[:size, :size]
    for _ in range(40):
        cy, cx = rng.uniform(0, size, 2)
        out[(yy - cy) ** 2 + (xx - cx) ** 2 <= rng.uniform(6, 20) ** 2] += 0.8
    return out


def run_ez_seg(img):
    """Phase (g): ez_seg's ``_create_object_mask`` at 1024^2 with
    thresh="auto", hole_size="auto", fov_dim=400, as a blob and as a
    projection, on the card against the CPU port (equal masks)."""
    from ark_tpu_torch.segmentation.ez_seg import ez_object_segmentation as ez

    x = ez_seg_image(np.random.default_rng(52), img)
    t = {}
    for shape in ("blob", "projection"):
        kw = dict(object_shape_type=shape, thresh="auto", hole_size="auto", fov_dim=400)
        ez._create_object_mask(x, device=DEVICE, **kw)                 # warm-up
        t0 = time.perf_counter()
        got = ez._create_object_mask(x, device=DEVICE, **kw)
        t[shape] = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = ez._create_object_mask(x, device="cpu", **kw)
        cpu_s = time.perf_counter() - t0
        n = len(np.unique(got)) - 1
        check(got.shape == x.shape and n >= 10, f"ez_seg {shape}: {n} objects")
        check(np.array_equal(got, want), f"ez_seg {shape}: {int((got != want).sum())} "
              f"pixels differ from the CPU port's mask")
        print(f"ez_seg _create_object_mask {shape} {x.shape[0]}^2 on {DEVICE} [{CARD}]: "
              f"{t[shape]:.4f} s, {n} objects, mask equal to the CPU port's (CPU run "
              f"{cpu_s:.3f} s)")
    return t


# --- cluster masks, overlays and the embeddings (UMAP, PCA, t-SNE)

# the embeddings, the card against the CPU port given the same inputs. k-NN:
# both expand |r|^2 - 2 r.c + |c|^2 in f32 with the D products summed in
# another order, so the squared distances agree within knn_bound = 4 (D - 1)
# 2^-24 (|r|^2 + max |c|^2), the rule ops/distances is held to (near-copies
# of a cell, which the tiled cohort holds, cancel to d^2 ~ 1e-6 and carry
# that as their whole value). A row's neighbour lists may differ at a rank
# whose squared distance is closer than that bound to the next or the
# previous rank's (the k + 1st included).
EMBED_RTOL = 1e-5
# UMAP's epochs are a chaotic map (a term near its +-4 clip, a negative that
# lands beside its point): pow differs in the last bits between the devices,
# and single coordinates part. After OPT_EPOCHS epochs all but OPT_OUTLIERS
# of the coordinates agree within OPT_ATOL, every one within OPT_WORST.
OPT_EPOCHS, OPT_ATOL, OPT_OUTLIERS, OPT_WORST = 3, 1e-4, 0.005, 5e-3
# t-SNE's descent multiplies a last-bit difference ~5x every few steps while
# the coordinates grow from 1e-4 to ~5 (the CPU tests' rule for 10 steps)
TSNE_STEPS, TSNE_ATOL = 10, 1e-3
KNN_COMPARE_CELLS = 20_000       # the k-NN of this many cells, card against CPU
TSNE_CELLS = 10_000              # the sample size ark_tpu/ops/tsne.py is written for
CPU_UMAP_CELLS, CPU_TSNE_CELLS = 2_500, 500


def cluster_mask_inputs(masks, table, pixel_assigned, seed=53):
    """Phase (h)'s inputs, as cluster_mask_steps takes them: the dense
    whole-cell masks by FOV name, the cells' types, a seeded colour table,
    two seeded channels for FOV 0's overlay and FOV 0's pixel assignments
    (flat indices, cluster ids)."""
    rng = np.random.default_rng(seed)
    by_fov = {f"fov{i}": m for i, m in enumerate(masks)}
    n_types = table["cell_meta_cluster"].nunique()
    colors = rng.integers(0, 256, (n_types + 2, 4)).astype(np.uint8)
    h, w = masks[0].shape
    channels = rng.gamma(1.0, 30.0, (h, w, 2)).astype(np.float32)
    channels[rng.random((h, w, 2)) < 0.3] = 0.0
    return by_fov, table, colors, channels, pixel_assigned


def cluster_mask_steps(by_fov, table, colors, channels, pixel_assigned, device):
    """The cluster-mask chain on `device`: ClusterMaskData, per FOV the
    eroded cell-cluster mask and its coloured image, FOV 0's pixel-cluster
    mask and overlay. Returns the outputs and the seconds per step."""
    import torch

    from ark_tpu_torch.utils import data_utils, plot_utils

    def mark(name, t0):
        if device != "cpu":
            torch.cuda.synchronize()
        seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    seconds, out = {}, {"cell_masks": {}, "colored": {}}
    t0 = time.perf_counter()
    cmd = data_utils.ClusterMaskData(table, "fov", "label", "cell_meta_cluster")
    mark("cluster_mask_data_s", t0)
    for fov, labels in by_fov.items():
        t0 = time.perf_counter()
        eroded = data_utils.erode_mask(labels, connectivity=2, mode="thick", device=device)
        mark("erode_s", t0)
        t0 = time.perf_counter()
        out["cell_masks"][fov] = data_utils.label_cells_by_cluster(fov, cmd, eroded,
                                                                   device=device)
        mark("relabel_s", t0)
        t0 = time.perf_counter()
        out["colored"][fov] = plot_utils.gather_colors(out["cell_masks"][fov], colors,
                                                       device=device)
        mark("color_s", t0)
    first = next(iter(by_fov.values()))
    t0 = time.perf_counter()
    out["pixel_mask"] = data_utils.scatter_pixel_clusters(first.shape, *pixel_assigned,
                                                          device=device)
    mark("pixel_mask_s", t0)
    t0 = time.perf_counter()
    out["overlay"] = plot_utils.overlay_from_arrays(channels, first, device=device)
    mark("overlay_s", t0)
    out["mapping"] = cmd.mapping
    return out, seconds


def run_cluster_masks(masks, table, pixel_assigned):
    """Phase (h): the dense 3 x 1024^2 masks with the cell SOM's types
    through ClusterMaskData, erode_mask and label_cells_by_cluster, the
    colour gather, one pixel-cluster mask from the pixel stage's
    assignments and one overlay with two seeded channels, on the card, held
    equal to the CPU port's (integers and uint8: exact). Prints seconds per
    FOV and per step, and the device's busy share."""
    inputs = cluster_mask_inputs(masks, table, pixel_assigned)
    cluster_mask_steps(*inputs, DEVICE)                                # warm-up
    got, seconds = cluster_mask_steps(*inputs, DEVICE)
    busy_s, top = device_profile(lambda: cluster_mask_steps(*inputs, DEVICE))
    t0 = time.perf_counter()
    want, _ = cluster_mask_steps(*inputs, "cpu")
    cpu_s = time.perf_counter() - t0
    n_fovs = len(masks)
    for fov in want["cell_masks"]:
        for key in ("cell_masks", "colored"):
            check(got[key][fov].dtype == want[key][fov].dtype
                  and np.array_equal(got[key][fov], want[key][fov]),
                  f"cluster masks {fov} {key}: the card and the CPU port differ")
        ids = np.unique(got["cell_masks"][fov])
        check(got["cell_masks"][fov].dtype == np.int16 and ids[0] == 0 and len(ids) > 10,
              f"cluster mask {fov}: {len(ids)} ids")
    for key in ("pixel_mask", "overlay"):
        check(got[key].dtype == want[key].dtype and np.array_equal(got[key], want[key]),
              f"{key}: the card and the CPU port differ")
    check(got["mapping"].equals(want["mapping"]), "ClusterMaskData.mapping differs")
    check(got["overlay"].dtype == np.uint8 and got["overlay"].max() == 255
          and len(np.unique(got["overlay"])) > 200, "overlay: not a rescaled uint8 image")
    check(got["pixel_mask"].dtype == np.int16 and got["pixel_mask"].max() <= 100
          and (got["pixel_mask"] > 0).mean() > 0.3, "pixel-cluster mask: too few pixels")
    total = sum(seconds.values())
    per_fov = (seconds["erode_s"] + seconds["relabel_s"] + seconds["color_s"]) / n_fovs
    print(f"cluster masks {n_fovs} x {masks[0].shape} dense masks, "
          f"{table['cell_meta_cluster'].nunique()} cell types on {DEVICE} [{CARD}]: "
          f"{per_fov:.4f} s per FOV (erode, relabel, colour gather); per step "
          + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f"; cell masks, coloured masks, the pixel-cluster mask "
          f"({int((got['pixel_mask'] > 0).sum())} pixels) and the overlay equal to the "
          f"CPU port's (CPU run {cpu_s:.3f} s)")
    print(f"cluster masks: device busy {busy_s:.4f} s of the {total:.4f} s chain "
          f"({busy_s / total:.1%}, profiled run); most device time: "
          + "; ".join(f"{k} {v:.4f} s" for k, v in top))
    return seconds


def knn_purity(emb, labels, k=10, sample=5000, seed=54, device="cpu"):
    """Share of the `k` nearest neighbours in the embedding (among all
    points) that carry their point's label, over a seeded sample of points."""
    import torch

    from ark_tpu_torch.ops import umap

    emb_t = torch.as_tensor(np.asarray(emb, np.float32), device=device)
    idx, _ = umap._knn(emb_t, k)
    rows = np.random.default_rng(seed).choice(len(emb), size=min(sample, len(emb)),
                                              replace=False)
    nn = idx.cpu().numpy()[rows]
    return float((labels[nn] == labels[rows][:, None]).mean())


def run_embeddings(data, labels):
    """Phase (i): the embeddings at full width through
    dimensionality_reduction.reduce_dimensions on the card: UMAP with its
    defaults (k = 15, 200 epochs, 5 negatives) and PCA on every cell of the
    cell-clustering cohort, t-SNE with its defaults (1000 iterations) on a
    TSNE_CELLS sample. Prints seconds per step, the segment-sum and plan
    launches of the UMAP fit, peak device memory, and the k-NN purity of
    the cell SOM's clusters in each embedding, for the card and for a CPU
    run at a size the CPU finishes in seconds. Returns (segment_sum
    launches, segment_plan launches) of the UMAP fit."""
    import torch

    from ark_tpu_torch.analysis import dimensionality_reduction as dr
    from ark_tpu_torch.ops import segment_reduce

    n, c = data.shape
    rng = np.random.default_rng(55)
    small = np.sort(rng.choice(n, size=min(2000, n), replace=False))
    dr.reduce_dimensions(data[small], "UMAP", device=DEVICE)              # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segment_reduce.segment_sum.launches = 0
    segment_reduce.segment_plan.launches = 0
    steps = {}
    t0 = time.perf_counter()
    emb = dr.reduce_dimensions(data, "UMAP", device=DEVICE, timings=steps)
    umap_s = time.perf_counter() - t0
    launches = segment_reduce.segment_sum.launches
    plan_launches = segment_reduce.segment_plan.launches
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(emb.shape == (n, 2) and np.isfinite(emb).all(), "UMAP: not a finite (N, 2) array")
    check(launches == 400 and plan_launches == 2, f"UMAP fit: segment_sum launches "
          f"{launches} (expected 2 x 200 epochs), segment_plan launches {plan_launches} "
          f"(expected 2)")
    purity = knn_purity(emb, labels, device=DEVICE)
    sub = np.sort(rng.choice(n, size=min(CPU_UMAP_CELLS, n), replace=False))
    t0 = time.perf_counter()
    emb_cpu = dr.reduce_dimensions(data[sub], "UMAP", device="cpu")
    cpu_s = time.perf_counter() - t0
    purity_cpu = knn_purity(emb_cpu, labels[sub])
    # chance: the share of pairs of cells with one label; an embedding that
    # keeps the clusters together puts most of a cell's neighbours in its own
    chance = float((np.bincount(labels) / n) @ (np.bincount(labels) / n))
    floor = max(0.5, 2 * chance)
    check(purity > floor and purity_cpu > floor, f"UMAP: k-NN purity "
          f"{purity:.3f} (card), {purity_cpu:.3f} (CPU) against chance {chance:.3f}")
    print(f"UMAP {n} cells x {c} columns (k=15, 200 epochs, 5 negatives) on {DEVICE} "
          f"[{CARD}]: {umap_s:.3f} s; per step "
          + ", ".join(f"{k} {v:.4f}" for k, v in steps.items())
          + f"; segment_sum launches {launches}, segment_plan launches {plan_launches}; "
          f"peak device memory {peak:.1f} MiB; 10-NN purity of the cell SOM's clusters "
          f"{purity:.3f} (chance {chance:.3f}); CPU port on {len(sub)} cells: "
          f"{cpu_s:.3f} s, purity {purity_cpu:.3f}")

    t0 = time.perf_counter()
    pca = dr.reduce_dimensions(data, "PCA", device=DEVICE)
    pca_s = time.perf_counter() - t0
    pca_cpu = dr.reduce_dimensions(data, "PCA", device="cpu")
    differ = int((pca != pca_cpu).sum())
    check(pca.shape == (n, 2) and np.allclose(pca, pca_cpu, rtol=EMBED_RTOL,
                                              atol=EMBED_RTOL * np.abs(pca_cpu).max()),
          "PCA: the card and the CPU port differ")
    print(f"PCA {n} cells x {c} columns on {DEVICE}: {pca_s:.4f} s; {differ} of "
          f"{pca.size} scores differ from the CPU port's in the last bit (f64 sums "
          f"rounded to f32), none beyond rtol {EMBED_RTOL}")

    sample = np.sort(rng.choice(n, size=min(TSNE_CELLS, n), replace=False))
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ts = dr.reduce_dimensions(data[sample], "tSNE", device=DEVICE)
    tsne_s = time.perf_counter() - t0
    tsne_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    check(ts.shape == (len(sample), 2) and np.isfinite(ts).all(), "t-SNE: not finite")
    tsne_purity = knn_purity(ts, labels[sample], device=DEVICE)
    tiny = sample[:CPU_TSNE_CELLS]
    t0 = time.perf_counter()
    ts_cpu = dr.reduce_dimensions(data[tiny], "tSNE", device="cpu")
    tsne_cpu_s = time.perf_counter() - t0
    tsne_purity_cpu = knn_purity(ts_cpu, labels[tiny])
    check(tsne_purity > floor and tsne_purity_cpu > floor, f"t-SNE: k-NN purity "
          f"{tsne_purity:.3f} (card), {tsne_purity_cpu:.3f} (CPU) against chance "
          f"{chance:.3f}")
    print(f"t-SNE {len(sample)} cells x {c} columns (perplexity 30, 1000 iterations) on "
          f"{DEVICE} [{CARD}]: {tsne_s:.3f} s with its affinities; peak device memory "
          f"{tsne_peak:.1f} MiB; 10-NN purity "
          f"{tsne_purity:.3f}; CPU port on {len(tiny)} cells: {tsne_cpu_s:.3f} s, purity "
          f"{tsne_purity_cpu:.3f}")
    return launches, plan_launches


def compare_embedding_steps(data):
    """Phase (j): the embeddings' steps on the card against the CPU port,
    given the same inputs: the k-NN of KNN_COMPARE_CELLS cells (distances
    within knn_bound, neighbours equal outside near-tie ranks),
    the bandwidths, the seeded negatives (equal), the PCA start, OPT_EPOCHS
    epochs of _optimize from the same graph, start and negatives, the
    t-SNE affinities and TSNE_STEPS descent steps from the same y0."""
    import torch

    from ark_tpu_torch.analysis import dimensionality_reduction as dr
    from ark_tpu_torch.ops import tsne, umap

    rng = np.random.default_rng(56)
    rows = np.sort(rng.choice(len(data), size=min(KNN_COMPARE_CELLS, len(data)),
                              replace=False))
    x = dr.standardize_columns(data[rows]).astype(np.float32)
    x_cpu, x_gpu = torch.as_tensor(x), torch.as_tensor(x, device=DEVICE)
    k = 15
    idx_g, d_g = umap._knn(x_gpu, k)
    idx_c, d_c = umap._knn(x_cpu, k)
    sq = (x_cpu * x_cpu).sum(1)
    knn_bound = 4 * (x.shape[1] - 1) * F32_EPS * (sq[:, None] + sq.max())
    d2_err = (d_g.cpu() ** 2 - d_c ** 2).abs()
    check(bool((d2_err <= knn_bound).all()), f"k-NN squared distances: the card and the "
          f"CPU port differ by {float(d2_err.max())}, beyond 4 (D - 1) 2^-24 (|r|^2 + "
          f"max |c|^2)")
    _, wider = umap._knn(x_cpu, k + 1)
    close = torch.diff(wider * wider, dim=1) < knn_bound
    ties = close.clone()                      # rank j against rank j + 1 ...
    ties[:, 1:] |= close[:, :-1]              # ... and against rank j - 1
    differ = idx_g.cpu() != idx_c
    check(not bool((differ & ~ties).any()),
          f"k-NN: {int((differ & ~ties).sum())} neighbours differ outside near-ties "
          f"({int(ties.sum())} near-tie ranks)")
    rho_g, sigma_g = umap._smooth_knn(d_c.to(DEVICE))
    rho_c, sigma_c = umap._smooth_knn(d_c)
    check(torch.equal(rho_g.cpu(), rho_c) and torch.allclose(
        sigma_g.cpu(), sigma_c, rtol=EMBED_RTOL), "_smooth_knn: the card and the CPU differ")
    print(f"k-NN {len(rows)} cells x {x.shape[1]} columns, k={k}, card against CPU port: "
          f"max |squared-distance difference| {float(d2_err.max()):.3g} (bound "
          f"{float(knn_bound.min()):.3g} and up), "
          f"{int(differ.sum())} of {differ.numel()} neighbours differ, all among the "
          f"{int(ties.sum())} near-tie ranks; bandwidths within rtol {EMBED_RTOL} (max relative "
          f"{float(((sigma_g.cpu() - sigma_c) / sigma_c).abs().max()):.3g})")

    heads, tails, w = umap.fuzzy_graph(idx_c, d_c)
    n, n_edges = len(rows), len(heads)
    for epoch in (0, 199):
        check(torch.equal(umap.draw_negatives(42, epoch, 5, n_edges, n, DEVICE).cpu(),
                          umap.draw_negatives(42, epoch, 5, n_edges, n, "cpu")),
              f"negatives of epoch {epoch}: the card and the CPU differ")
    negs = umap.draw_negatives(42, 0, 5, n_edges, n, "cpu")
    counts = torch.bincount(negs.reshape(-1), minlength=n).double()
    chi2 = float(((counts - counts.mean()) ** 2 / counts.mean()).sum())
    check(abs(chi2 - (n - 1)) < 6 * (2 * (n - 1)) ** 0.5, f"negatives: chi-square {chi2} "
          f"for {n - 1} degrees of freedom")
    emb0_g = umap._pca(x_gpu, 2)
    emb0_c = umap._pca(x_cpu, 2)
    pca_differ = int((emb0_g.cpu() != emb0_c).sum())
    check(torch.allclose(emb0_g.cpu(), emb0_c, rtol=EMBED_RTOL,
                         atol=EMBED_RTOL * float(emb0_c.abs().max())),
          "PCA start: the card and the CPU differ")
    xs = x_cpu[:2000]
    y0 = tsne.initial_embedding(len(xs), 2, 42)
    check(torch.equal(y0, tsne.initial_embedding(len(xs), 2, 42))
          and y0.device.type == "cpu",
          "t-SNE's seeded start is not one CPU draw")
    emb0 = emb0_c / (emb0_c.abs().max() + 1e-12) * 10.0
    opt_c = umap._optimize(emb0, heads, tails, w, 42, n_epochs=OPT_EPOCHS)
    opt_g = umap._optimize(emb0.to(DEVICE), heads.to(DEVICE), tails.to(DEVICE),
                           w.to(DEVICE), 42, n_epochs=OPT_EPOCHS).cpu()
    err = (opt_g - opt_c).abs()
    outliers = float((err > OPT_ATOL).float().mean())
    check(outliers <= OPT_OUTLIERS and float(err.max()) <= OPT_WORST,
          f"_optimize {OPT_EPOCHS} epochs: {outliers:.4%} of the coordinates beyond "
          f"{OPT_ATOL}, max {float(err.max()):.3g}")
    print(f"UMAP on {n} cells, card against CPU port: negatives of epochs 0 and 199 equal "
          f"({5 * n_edges} draws, chi-square {chi2:.0f} for {n - 1} degrees of freedom); "
          f"PCA start: {pca_differ} of {emb0_c.numel()} scores differ in the last bit; "
          f"{OPT_EPOCHS} epochs of _optimize from the same graph, start and negatives: "
          f"max |difference| {float(err.max()):.3g}, {outliers:.4%} beyond {OPT_ATOL}")

    d2 = tsne._squared_dists(xs)
    p_c = tsne._conditional_affinities(d2, 30.0)
    p_g = tsne._conditional_affinities(d2.to(DEVICE), 30.0).cpu()
    check(torch.allclose(p_g, p_c, rtol=EMBED_RTOL, atol=1e-9),
          f"_conditional_affinities: differ by {float((p_g - p_c).abs().max())}")
    p_sym = torch.clamp_min((p_c + p_c.T) / (2.0 * len(xs)), 1e-12)
    lr = max(len(xs) / 48.0, 50.0)
    y_c = tsne._embed(p_sym, 42, TSNE_STEPS, TSNE_STEPS, lr, y0=y0)
    y_g = tsne._embed(p_sym.to(DEVICE), 42, TSNE_STEPS, TSNE_STEPS, lr, y0=y0).cpu()
    check(torch.allclose(y_g, y_c, rtol=0, atol=TSNE_ATOL),
          f"_embed {TSNE_STEPS} steps: differ by {float((y_g - y_c).abs().max())}")
    print(f"t-SNE on {len(xs)} cells, card against CPU port: affinities within rtol "
          f"{EMBED_RTOL} (max |difference| {float((p_g - p_c).abs().max()):.3g}); "
          f"{TSNE_STEPS} steps of _embed from the same start: max |difference| "
          f"{float((y_g - y_c).abs().max()):.3g} on coordinates up to "
          f"{float(y_c.abs().max()):.3g} (atol {TSNE_ATOL})")


def check_edge_sums(data, window=64):
    """The segment-sum kernel's flat path at the shape UMAP's epoch gives it:
    the fuzzy graph's edges of every cell (N x 15 point ids, 2 columns, N
    segments, point 0 a real row): heads, stably sorted tails, the tails
    shuffled within runs of `window` entries (unsorted, each segment's span
    still short), the sorted tails with 1% of the ids set to -1 or N (out of
    range, dropped), and 20,000 ids drawn over 500 points in no order; each
    bitwise against segment_sum_plain on a CPU copy, and background=False
    keeping rows 1:'s bits. Timed on the sorted tails (events, a batch and
    device time) beside the plan, the plain version, CUDA index_add_, the
    byte bound and the chain bound (the longest segment's adds). Returns
    (max error, timings)."""
    import torch

    from ark_tpu_torch.analysis import dimensionality_reduction as dr
    from ark_tpu_torch.ops import segment_reduce as sr
    from ark_tpu_torch.ops import umap

    x = torch.as_tensor(dr.standardize_columns(data).astype(np.float32), device=DEVICE)
    n = x.shape[0]
    idx, _ = umap._knn(x, 15)
    heads = torch.arange(n, device=DEVICE).repeat_interleave(idx.shape[1]).to(torch.int32)
    tails = torch.sort(idx.reshape(-1), stable=True).values.to(torch.int32)
    rng = np.random.default_rng(57)
    vals = torch.as_tensor(rng.normal(size=(heads.numel(), 2)).astype(np.float32),
                           device=DEVICE)
    shuffled = tails.cpu().numpy().copy()
    for start in range(0, shuffled.size, window):
        rng.shuffle(shuffled[start:start + window])
    out_of_range = tails.cpu().numpy().copy()
    hit = rng.random(out_of_range.size) < 0.01
    out_of_range[hit] = np.where(rng.random(int(hit.sum())) < 0.5, -1, n)
    few = rng.integers(0, 500, 20_000).astype(np.int32)
    cases = [("heads", heads, n, vals), ("tails", tails, n, vals),
             ("tails unsorted", torch.as_tensor(shuffled, device=DEVICE), n, vals),
             ("tails out of range", torch.as_tensor(out_of_range, device=DEVICE), n, vals),
             ("20,000 unsorted ids", torch.as_tensor(few, device=DEVICE), 500,
              vals[:few.size])]
    max_err = 0.0
    for name, ids, n_seg, v in cases:
        plan = sr.segment_plan(ids, n_seg)
        got = sr.segment_sum(v, ids, n_seg, plan)
        cells_only = sr.segment_sum(v, ids, n_seg, plan, background=False)
        want = sr.segment_sum_plain(v.cpu(), ids.cpu(), n_seg)
        torch.cuda.synchronize()
        max_err = max(max_err, float((got.cpu() - want).abs().max()))
        check(same_bits(got, want) and bool((want[0] != 0).any()),
              f"segment_sum over UMAP's {name}: {int((got.cpu() != want).sum())} sums "
              f"differ from index_add_ on the CPU")
        check(not bool(cells_only[0].any()) and same_bits(cells_only[1:], got[1:]),
              f"segment_sum over UMAP's {name}: background=False changes rows 1:")
        if plan.boxes is not None:            # CUDA plans carry the boxes
            check(torch.equal(plan.boxes, sr.segment_boxes_plain(ids, n_seg)),
                  f"segment_plan over UMAP's {name}: boxes differ from the plain "
                  f"version's")
    plan = sr.segment_plan(tails, n)
    flat = tails.long()
    longest = int(torch.bincount(flat, minlength=n).max())
    t = {"ms": time_ms(lambda: sr.segment_sum(vals, tails, n, plan)),
         "device_ms": device_ms(lambda: sr.segment_sum(vals, tails, n, plan)),
         "batch_ms": batch_ms(lambda: sr.segment_sum(vals, tails, n, plan)),
         "library_batch_ms": batch_ms(lambda: torch.zeros((n, 2), device=DEVICE).index_add_(
             0, flat, vals)),
         "plan_ms": time_ms(lambda: sr.segment_plan(tails, n)),
         "plan_device_ms": device_ms(lambda: sr.segment_plan(tails, n)),
         "plain_ms": time_ms(lambda: sr.segment_sum_plain(vals, tails, n)),
         "library_ms": time_ms(lambda: torch.zeros((n, 2), device=DEVICE).index_add_(
             0, flat, vals)),
         "longest": longest,
         "sm_mhz": sm_clock_mhz(lambda: sr.segment_sum(vals, tails, n, plan), calls=2000),
         # every edge's two values and its label read once, the sums written once
         "byte_bound_ms": bound_ms(nbytes=4.0 * (3 * tails.numel() + 2 * n))[0],
         "plan_bound_ms": bound_ms(nbytes=4.0 * tails.numel() + 16.0 * n)[0]}
    t["chain_bound_ms"] = bound_ms(chain=longest, mhz=t["sm_mhz"])[0]
    t["bound_ms"], t["bound_by"] = bound_ms(nbytes=4.0 * (3 * tails.numel() + 2 * n),
                                            chain=longest, mhz=t["sm_mhz"])
    print(f"segment_sum at UMAP's edge shape ({tails.numel()} ids x 2 columns, {n} "
          f"segments, longest {longest}) on {DEVICE} [{CARD}]: {', '.join(c[0] for c in cases)} "
          f"bitwise equal to index_add_ on the CPU, row 0 included; sorted tails per call: "
          f"events {t['ms']:.4f} ms, batch of 20 {t['batch_ms']:.4f} ms, device "
          f"{fmt_ms(t['device_ms'])}; CUDA index_add_ events {t['library_ms']:.4f} ms, batch "
          f"{t['library_batch_ms']:.4f} ms; byte bound {t['byte_bound_ms']:.4f} ms, chain "
          f"bound {t['chain_bound_ms']:.6f} ms ({longest} adds x {FADD_LATENCY_CYCLES} cycles "
          f"at {t['sm_mhz']:.0f} MHz), so bound {t['bound_ms']:.4f} ms by {t['bound_by']}: "
          f"share {share(t['bound_ms'], t['batch_ms']):.3f} of the batch time, "
          f"{share(t['bound_ms'], t['device_ms']):.3f} of the device time; plan "
          f"{t['plan_ms']:.4f} ms (device {fmt_ms(t['plan_device_ms'])}; bound "
          f"{t['plan_bound_ms']:.4f}), plain {t['plain_ms']:.4f} ms")
    return max_err, t


# --- spatial LDA (the LDA_Preprocessing and LDA_Training_and_Inference
# templates, templates/lda_preprocessing_training_inference.py's flow)

# the templates' defaults: radius 100, train_frac 0.75, the EDA over 3..7
# topics with 25 bootstraps, 5 topics, penalty 0.25, 50 and 30 iterations
LDA_TOPICS, LDA_BOOTS, LDA_N_TOPICS, LDA_PENALTY = list(range(3, 8)), 25, 5, 0.25
LDA_TRAIN_ITERS, LDA_INFER_ITERS = 50, 30
LDA_SEED = 42                  # np.random.seed before each gap statistic's draws
# phase (k) times the card on all 10 FOVs and holds it to the CPU port on the
# first 2 (4,500 training cells). At 4,500 cells the CPU's k-means and pair
# sums take ~0.3 s a bootstrap, so the replay's EDA takes the gap statistic
# at LDA_N_TOPICS with 5 bootstraps (LDA_REPLAY_GAP). The profiled run pays
# the profiler ~45 us a launch (the EDA's bootstraps and the EM launch
# ~180,000 times each): its EDA takes the gap at LDA_N_TOPICS with all 25
# bootstraps (LDA_PROFILED_GAP), and it trains for 2 outer iterations, then
# for 1 apart. Every outer iteration launches the same kernels on the same
# shapes, so a fit of n launches L(1) + (n - 1) (L(2) - L(1)), and its
# device time is read the same way.
LDA_REPLAY_FOVS = 2
LDA_REPLAY_GAP, LDA_PROFILED_GAP = (LDA_N_TOPICS, 5), (LDA_N_TOPICS, LDA_BOOTS)
# card against CPU port: the bootstraps' k-means (f64) give equal labels and
# the pair sums are f64, so the gap agrees within LDA_GAP_RTOL; the EM's
# digamma, exp and products round differently on the two devices (the CPU
# tests see 6e-8 on topics and 9e-6 on weights against the JAX package at
# this cohort's shape), held to LDA_TOPICS_ATOL and LDA_WEIGHTS_ATOL
LDA_GAP_RTOL = 1e-6
LDA_TOPICS_ATOL, LDA_WEIGHTS_ATOL = 1e-5, 1e-3
LDA_ROW_SUM_ATOL = 1e-4
# niche-bound phenotypes of spatial_cohort: type t < 10 gathers around
# niche t mod 6 in every FOV
LDA_NICHES = 6


def lda_topic_eda(train, device, gap=None):
    """The template's compute_topic_eda (topics LDA_TOPICS, LDA_BOOTS
    bootstraps, numpy seeded with LDA_SEED); with `gap` = (topics,
    bootstraps), the EDA without bootstraps and the gap statistic at those
    topics only, through the calls compute_topic_eda makes for it."""
    from ark_tpu_torch.ops import kmeans
    from ark_tpu_torch.spLDA import processing as pros
    from ark_tpu_torch.utils import spatial_lda_utils as spu

    if gap is None:
        np.random.seed(LDA_SEED)
        return pros.compute_topic_eda(train, "cluster", topics=LDA_TOPICS,
                                      num_boots=LDA_BOOTS, device=device)
    eda = pros.compute_topic_eda(train, "cluster", topics=LDA_TOPICS, device=device)
    k, boots = gap
    labels, _ = kmeans.kmeans(train.values.astype(np.float32), k, seed=42, device=device)
    pooled = spu.within_cluster_sums(train.values, labels, device=device)
    np.random.seed(LDA_SEED)
    eda["gap_stat"][k], eda["gap_sds"][k] = pros.gap_stat(train, k, pooled, boots,
                                                          device=device)
    return eda


def lda_steps(table, base, device, gap=None, profile_steps=False,
              train_iters=LDA_TRAIN_ITERS):
    """The LDA templates' steps with their defaults on `device`:
    format_cell_table (every phenotype), featurize_cell_table (cluster
    counts), create_difference_matrices, the topic EDA (``lda_topic_eda``),
    train, infer, and the model's pkl and the weights' csv written to
    `base`. Returns (outputs, seconds by step, {step: (device seconds,
    kernels and copies)} when `profile_steps`)."""
    import torch

    from ark_tpu_torch.spLDA import model as lda_model
    from ark_tpu_torch.spLDA import processing as pros
    from ark_tpu_torch.utils import spatial_lda_utils as spu

    os.makedirs(base)
    seconds, device_use, out = {}, {}, {}

    def step(name, fn):
        t0 = time.perf_counter()
        if profile_steps:
            result, *device_use[name] = device_totals(fn)
        else:
            result = fn()
            if device != "cpu":
                torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    fmt = step("format_cell_table", lambda: pros.format_cell_table(
        table, clusters=sorted(table["cell_meta_cluster"].unique())))
    feats = step("featurize_cell_table", lambda: pros.featurize_cell_table(
        fmt, featurization="cluster", radius=100, train_frac=0.75, device=device))
    diffs = step("difference_matrices", lambda: pros.create_difference_matrices(fmt, feats))
    train = feats["train_features"]
    out["eda"] = step("topic_eda", lambda: lda_topic_eda(train, device, gap))
    model = step("train", lambda: lda_model.train(
        train, difference_matrices=diffs["train_diff_mat"], n_topics=LDA_N_TOPICS,
        difference_penalty=LDA_PENALTY, n_iters=train_iters, device=device))
    inferred = step("infer", lambda: lda_model.infer(
        model, feats["featurized_fovs"], difference_matrices=diffs["inference_diff_mat"],
        difference_penalty=LDA_PENALTY, n_iters=LDA_INFER_ITERS, device=device))

    def save():
        spu.save_spatial_lda_file(model, base, "lda_model", format="pkl")
        spu.save_spatial_lda_file(inferred, base, "topic_weights", format="csv")

    step("save", save)
    back = spu.read_spatial_lda_file(base, "lda_model", format="pkl")
    check(np.array_equal(back.components_, model.components_)
          and os.path.exists(os.path.join(base, "topic_weights.csv")),
          "spatial LDA: the saved model does not read back")
    out.update(fmt=fmt, feats=feats, diffs=diffs, model=model, inferred=inferred)
    return out, seconds, device_use


def lda_outputs_agree(got, want, what):
    """Phase (k)'s card outputs against the CPU port's: featurized counts,
    the train split and the difference matrices equal; the EDA's inertia
    within SWEEP_RTOL, its cell counts equal, its gap statistics within
    LDA_GAP_RTOL; topics and weights within LDA_TOPICS_ATOL and
    LDA_WEIGHTS_ATOL. Returns the largest differences."""
    import pandas as pd

    try:
        for key in ("featurized_fovs", "train_features"):
            pd.testing.assert_frame_equal(got["feats"][key], want["feats"][key],
                                          check_exact=True)
        for k in LDA_TOPICS:
            pd.testing.assert_frame_equal(got["eda"]["cell_counts"][k],
                                          want["eda"]["cell_counts"][k], check_exact=True)
    except AssertionError as e:
        raise SmokeFailure(f"{what}: CUDA and CPU differ: {e}") from e
    for key in ("train_diff_mat", "inference_diff_mat"):
        for fov, d in want["diffs"][key].items():
            check(np.array_equal(got["diffs"][key][fov], d),
                  f"{what} {key} {fov}: difference matrices differ")
    g_eda, w_eda = got["eda"], want["eda"]
    check(all(np.isclose(g_eda["inertia"][k], w_eda["inertia"][k], rtol=SWEEP_RTOL, atol=0)
              for k in LDA_TOPICS), f"{what} inertia {g_eda['inertia']} vs {w_eda['inertia']}")
    gap_err = max(abs(g_eda[s][k] - w_eda[s][k]) / abs(w_eda[s][k])
                  for s in ("gap_stat", "gap_sds") for k in w_eda["gap_stat"])
    check(set(g_eda["gap_stat"]) == set(w_eda["gap_stat"]) and gap_err <= LDA_GAP_RTOL,
          f"{what} gap statistics: {g_eda['gap_stat']} vs {w_eda['gap_stat']}")
    topics_err = float(np.abs(got["model"].components_ - want["model"].components_).max())
    weights_err = max(
        float(np.abs(got["model"].topic_weights.values
                     - want["model"].topic_weights.values).max()),
        float(np.abs(got["inferred"].values - want["inferred"].values).max()))
    check(topics_err <= LDA_TOPICS_ATOL and weights_err <= LDA_WEIGHTS_ATOL,
          f"{what}: topics differ by {topics_err}, weights by {weights_err}")
    return gap_err, topics_err, weights_err


def niche_purity(inferred, fmt):
    """(purity, chance) of the niche-bound cells' dominant topics: the share
    of those cells in their topic's commonest niche, and the largest niche's
    share (what topics blind to the niches would score)."""
    types = np.concatenate([fmt[fov]["cluster"].to_numpy()[inferred.loc[fov].index]
                            for fov in inferred.index.get_level_values(0).unique()])
    type_idx = np.array([SPATIAL_TYPES.index(t) for t in types])
    bound = type_idx < len(SPATIAL_TYPES) // 2
    niche = type_idx[bound] % LDA_NICHES
    topic = inferred.values.argmax(1)[bound]
    table = np.zeros((inferred.shape[1], LDA_NICHES), np.int64)
    np.add.at(table, (topic, niche), 1)
    return table.max(1).sum() / bound.sum(), np.bincount(niche).max() / bound.sum()


def run_spatial_lda(table):
    """Phase (k): the LDA templates' steps on the card at 10 FOVs x 3000
    cells (seconds per step, peak memory), again under the profiler with the
    EDA's gap statistic at LDA_PROFILED_GAP and 2 training iterations (the
    device's busy share, the kernels and copies each step launches, the EM's
    per fit), then on the first LDA_REPLAY_FOVS FOVs on the card and in the
    CPU port with the gap at LDA_REPLAY_GAP, held to each other; the topics
    must recover the cohort's niches. Returns the card's seconds per step
    and its outputs (``lda_steps``')."""
    import torch

    from ark_tpu_torch.spLDA import model as lda_model

    fovs = list(table["fov"].unique())
    with tempfile.TemporaryDirectory() as base:
        torch.cuda.reset_peak_memory_stats()
        got, seconds, _ = lda_steps(table, os.path.join(base, "card"), DEVICE)
        peak = torch.cuda.max_memory_allocated() / 2 ** 20
        prof, prof_seconds, device_use = lda_steps(
            table, os.path.join(base, "profiled"), DEVICE, gap=LDA_PROFILED_GAP,
            profile_steps=True, train_iters=2)
        _, em1_s, em1 = device_totals(lambda: lda_model.train(
            prof["feats"]["train_features"], difference_matrices=prof["diffs"]["train_diff_mat"],
            n_topics=LDA_N_TOPICS, difference_penalty=LDA_PENALTY, n_iters=1, device=DEVICE))
        held = table[table["fov"].isin(fovs[:LDA_REPLAY_FOVS])].reset_index(drop=True)
        held_got, _, _ = lda_steps(held, os.path.join(base, "card_held"), DEVICE,
                                   gap=LDA_REPLAY_GAP)
        t0 = time.perf_counter()
        want, _, _ = lda_steps(held, os.path.join(base, "cpu"), "cpu", gap=LDA_REPLAY_GAP)
        cpu_s = time.perf_counter() - t0
    gap_err, topics_err, weights_err = lda_outputs_agree(held_got, want, "spatial LDA")
    model, inferred = got["model"], got["inferred"]
    n_train, n_features = got["feats"]["train_features"].shape
    check(model.components_.shape == (LDA_N_TOPICS, n_features)
          and inferred.shape == (len(got["feats"]["featurized_fovs"]), LDA_N_TOPICS)
          and np.isfinite(model.components_).all() and np.isfinite(inferred.values).all(),
          "spatial LDA: topics or weights of the wrong shape or not finite")
    sums = [np.abs(model.components_.sum(1) - 1).max(),
            np.abs(model.topic_weights.values.sum(1) - 1).max(),
            np.abs(inferred.values.sum(1) - 1).max()]
    check(max(sums) <= LDA_ROW_SUM_ATOL, f"spatial LDA: rows sum to 1 only within {sums}")
    purity, chance = niche_purity(inferred, got["fmt"])
    bar = max(0.5, 2 * chance)
    check(purity > bar, f"spatial LDA: niche purity {purity:.3f} of the dominant topics "
          f"(chance {chance:.3f}, bar {bar:.3f})")
    total = sum(seconds.values())
    busy = sum(s for s, _ in device_use.values())
    prof_total = sum(prof_seconds.values())
    # the steps both runs share: device seconds over the unprofiled run's wall
    same = [k for k in seconds if k not in ("topic_eda", "train")]
    busy_same = sum(device_use[k][0] for k in same) / sum(seconds[k] for k in same)
    em2_s, em2 = device_use["train"]
    em_launches = em1 + (LDA_TRAIN_ITERS - 1) * (em2 - em1)
    em_s = em1_s + (LDA_TRAIN_ITERS - 1) * (em2_s - em1_s)
    print(f"spatial LDA ({len(fovs)} FOVs, {len(got['feats']['featurized_fovs'])} cells, "
          f"{table['cell_meta_cluster'].nunique()} phenotypes; {n_train} training cells x "
          f"{n_features} features) on {DEVICE} [{CARD}]: {total:.3f} s; per step "
          + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items())
          + f"; peak device memory {peak:.1f} MiB")
    print(f"spatial LDA: device busy {busy:.4f} s of the {prof_total:.3f} s profiled run "
          f"({busy / prof_total:.1%}; the EDA's gap statistic at (topics, bootstraps) "
          f"{LDA_PROFILED_GAP}, training 2 outer iterations); the steps both runs share "
          f"{busy_same:.1%} of their unprofiled wall; device s and kernels + copies by step: "
          + ", ".join(f"{k} {s:.4f} s {n}" for k, (s, n) in device_use.items())
          + f"; the EM ({LDA_N_TOPICS} topics, x 21 E-steps an outer iteration): {em1} and "
          f"{em2} launches at 1 and 2 outer iterations, so {em_launches} launches and "
          f"{em_s:.4f} s of device time a {LDA_TRAIN_ITERS}-iteration fit, "
          f"{em_s / seconds['train']:.1%} of its {seconds['train']:.3f} s")
    eda = got["eda"]
    print(f"spatial LDA: niche purity {purity:.3f} (chance {chance:.3f}, bar {bar:.3f}); "
          f"inertia k=3..7 {np.round([eda['inertia'][k] for k in LDA_TOPICS], 1).tolist()}, "
          f"gap {np.round([eda['gap_stat'][k] for k in LDA_TOPICS], 4).tolist()}; "
          f"held to the CPU port on {LDA_REPLAY_FOVS} FOVs ({len(held)} cells; counts, "
          f"split, difference matrices, cell counts equal; gap at (topics, bootstraps) "
          f"{LDA_REPLAY_GAP} within {gap_err:.2e}, topics {topics_err:.2e}, "
          f"weights {weights_err:.2e}; CPU run {cpu_s:.3f} s)")
    return seconds, got


# --- Mesmer training and weight conversion (phase (l))

MANIFEST = os.path.join(REPO, "tests", "models", "deepcell_layer_manifest.json")


def manifest_layers(rng):
    """A seeded Keras layer dict shaped as deepcell-tf's Mesmer (the
    manifest of tests/models), with values a forward can run on: kernels
    N(0, 1 / fan_in) (fan_in: every axis but the output's), biases, beta
    and moving means N(0, 0.1), gamma and moving variances U(0.5, 1.5)."""
    with open(MANIFEST) as f:
        manifest = json.load(f)["layers"]
    draws = {"bias": lambda s: rng.normal(0, 0.1, s),
             "beta": lambda s: rng.normal(0, 0.1, s),
             "moving_mean": lambda s: rng.normal(0, 0.1, s),
             "gamma": lambda s: rng.uniform(0.5, 1.5, s),
             "moving_variance": lambda s: rng.uniform(0.5, 1.5, s),
             "kernel": lambda s: rng.normal(0, 1, s) / np.sqrt(np.prod(s[:-1]))}
    return {name: {w: draws[w](tuple(shape)).astype(np.float32)
                   for w, shape in weights.items()}
            for name, weights in manifest.items()}


TRAIN_BATCH, TRAIN_HW = 8, 256          # the full-width training step's batch
TRAIN_WARMUP, TRAIN_TIMED = 2, 10
# card against the CPU port, one full-width f32 step at 2 x 64^2: the loss
# (relative), each gradient (of its tensor's largest entry) and the updated
# batch-norm averages (of max(|average|, 1))
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_BN_TOL = 1e-5, 1e-4, 1e-5
# the shipped checkpoint's recipe (ark_tpu/models/checkpoints/README.md)
RECIPE = dict(steps=2000, n_images=64, hw=64, seed=42, mini=True)
# tests/segmentation/test_mesmer_planted.py:62-71 and :101-103: recall,
# precision, matched IoU
PLANTED_FLOORS = {"whole_cell": (0.9, 0.9, 0.8), "nuclear": (0.9, 0.9, 0.75)}
CROWDED_FLOOR = (0.9, 0.9, 0.75)
CONVERT_SHAPE = (2, 256, 256, 2)
GRAPH_CHECK_STEPS = 8           # a fit's eager warm-up, then graph replays


def training_batch(seed, n, hw, device):
    """Planted cells (half spaced, half crowded, as train_on_synthetic
    draws them), normalized as predict normalizes, with their four targets,
    on `device`."""
    import torch

    from ark_tpu_torch.segmentation import mesmer, synthetic

    rng = np.random.default_rng(seed)
    spaced = synthetic.synthetic_cells(rng, n - n // 2, hw=hw)
    crowded = synthetic.synthetic_cells(rng, n // 2, hw=hw, crowding=0.35)
    imgs, cells, nucs = (np.concatenate(pair) for pair in zip(spaced, crowded))
    targets = {}
    for comp, labels in (("whole_cell", cells), ("nuclear", nucs)):
        t = synthetic.targets_from_labels(labels, device=device)
        targets[f"{comp}_inner_distance"] = t["inner_distance"]
        targets[f"{comp}_pixelwise"] = t["pixelwise"]
    return mesmer._percentile_normalize(torch.as_tensor(imgs, device=device)), targets


def fresh_model(state, dtype, device):
    """A full PanopticNet in train mode with the weights of `state`."""
    from ark_tpu_torch.models import unet

    model = unet.PanopticNet(dtype=dtype)
    model.load_state_dict(state)
    return model.to(device).train()


def step_with_events(model, opt, x, targets):
    """One training step with CUDA events after the forward and loss, the
    backward and the optimizer. Returns (loss, gradients, events)."""
    import torch

    from ark_tpu_torch.segmentation import train

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    loss = train.mesmer_loss(model(x), targets, inner_weight=10.0)
    ev[1].record()
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    ev[2].record()
    opt.step(grads)
    ev[3].record()
    return loss.detach(), grads, ev


def replayed_step_ms(model, opt, x, targets):
    """ms per step of `model`'s training step as a fit replays it on the
    card: GRAPH_WARMUP eager steps on a side stream, one step captured in a
    CUDA graph, then CUDA events around TRAIN_TIMED replays."""
    import torch

    from ark_tpu_torch.segmentation import train

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(train.GRAPH_WARMUP):
            train.train_step(model, opt, x, targets)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        loss = train.train_step(model, opt, x, targets)
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(TRAIN_TIMED):
        graph.replay()
    end.record()
    end.synchronize()
    check(bool(torch.isfinite(loss)), f"replayed step: loss {float(loss)}")
    return start.elapsed_time(end) / TRAIN_TIMED


def run_training_steps(x, targets):
    """Phase (l1): the published network, seeded, on TRAIN_BATCH x
    TRAIN_HW^2 planted images, in f32 (TF32 off) and in bf16: TRAIN_WARMUP
    then TRAIN_TIMED eager steps, split by events into forward, backward and
    optimizer, with peak memory and the device's busy share and launches of
    one profiled step; then the step as train.fit replays it on the card
    (one CUDA graph a step), with images per second; then the two forms of
    the heads' last resize, timed at this batch and at inference's."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import train

    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        model = unet.init_mesmer(seed=0, dtype=dtype, device=DEVICE).train()
        opt = train.Adam(model.parameters(), 1e-3)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        with train.training_precision(model):
            for _ in range(TRAIN_WARMUP):
                step_with_events(model, opt, x, targets)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            runs = [step_with_events(model, opt, x, targets) for _ in range(TRAIN_TIMED)]
            torch.cuda.synchronize()
            step_s = (time.perf_counter() - t0) / TRAIN_TIMED
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            _, busy_s, launches = device_totals(lambda: step_with_events(model, opt, x,
                                                                         targets))
            replay_ms = replayed_step_ms(model, opt, x, targets)
        split = np.median([[ev[i].elapsed_time(ev[i + 1]) for i in range(3)]
                           for _, _, ev in runs], axis=0)
        losses = [float(loss) for loss, _, _ in runs]
        check(all(np.isfinite(losses)), f"training {name}: losses {losses}")
        del model, opt, runs
        print(f"training step {name} {TRAIN_BATCH} x {TRAIN_HW}^2 (published network, "
              f"{CARD}): eager {step_s * 1e3:.2f} ms per step; events: forward+loss "
              f"{split[0]:.2f} ms, backward {split[1]:.2f} ms, optimizer {split[2]:.2f} ms; "
              f"peak memory {peak:.2f} GiB; one profiled step: {busy_s * 1e3:.2f} ms device "
              f"({busy_s / step_s:.1%} of the eager step), {launches} kernels and copies; "
              f"as fit replays it (one CUDA graph a step): {replay_ms:.2f} ms per step, "
              f"{TRAIN_BATCH / replay_ms * 1e3:.1f} images/s (device "
              f"{busy_s * 1e3 / replay_ms:.1%} busy); loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    # the heads' last upsample: training's 8 x 64 x 128^2 -> 256^2 in f32,
    # template 1's inference 4 x 64 x 512^2 -> 1024^2 in bf16
    for shape, dtype in (((TRAIN_BATCH, 64, TRAIN_HW // 2, TRAIN_HW // 2), torch.float32),
                         ((4, 64, 512, 512), torch.bfloat16)):
        src = torch.rand(shape, device=DEVICE).to(dtype)
        size = (2 * shape[2], 2 * shape[3])
        with unet.full_f32():
            products = time_ms(lambda: unet._resize_products(src, *size))
            interp = time_ms(lambda: torch.nn.functional.interpolate(
                src, size=size, mode="bilinear", align_corners=False))
        print(f"resize {shape} -> {size} {dtype}: product form {products:.4f} ms, "
              f"F.interpolate {interp:.4f} ms (events, median of 10)")


def check_deterministic_steps(x, targets):
    """Phase (l1): two identical f32 steps at full width under
    torch.use_deterministic_algorithms(True), which raises on an op with no
    deterministic CUDA algorithm (a float-atomic backward): gradients,
    parameters and batch-norm averages bitwise equal."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import train

    state = unet.init_mesmer(seed=1, dtype=torch.float32, device=DEVICE).state_dict()
    runs = []
    torch.use_deterministic_algorithms(True)
    try:
        for _ in range(2):
            model = fresh_model(state, torch.float32, DEVICE)
            opt = train.Adam(model.parameters(), 1e-3)
            with train.training_precision(model):
                _, grads, _ = step_with_events(model, opt, x, targets)
            runs.append((grads, model.state_dict()))
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    (g0, s0), (g1, s1) = runs
    check(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(g0, g1)),
          "deterministic steps: gradients differ")
    check(all(torch.equal(s0[k], s1[k]) for k in s0),
          "deterministic steps: parameters or batch-norm averages differ")
    print(f"deterministic f32 step {TRAIN_BATCH} x {TRAIN_HW}^2 under "
          f"use_deterministic_algorithms(True): ran; two steps give bitwise-equal "
          f"gradients ({sum(g is not None for g in g0)} tensors), parameters and "
          f"averages ({len(s0)} tensors)")


def gradient_errors(got, want):
    """Worst error of each gradient tensor against its largest entry, over
    the tensors `want` has; an all-zero reference must be matched exactly,
    and a bias feeding a train-mode batch norm (zero gradient in exact
    arithmetic) is held below STEP_GRAD_RTOL of its layer's kernel
    gradient on both sides."""
    worst = 0.0
    for name, ref in want.items():
        g = got[name]
        if ref is None:
            check(g is None, f"gradient {name}: None on one device only")
            continue
        scale = float(ref.abs().max())
        if scale == 0.0:
            check(not bool(g.any()), f"gradient {name}: zero on one device only")
        elif name.endswith("dense_0.bias"):
            kernel = float(want[name[:-len("bias")] + "weight"].abs().max())
            check(max(scale, float(g.abs().max())) <= STEP_GRAD_RTOL * kernel,
                  f"gradient {name}: not near zero")
        else:
            worst = max(worst, float((g - ref).abs().max()) / scale)
    return worst


def compare_training_step_cpu_cuda():
    """Phase (l2): one full-width f32 step at 2 x 64^2 from the same weights
    and batch on the CPU port and on the card: loss, every gradient, the
    updated batch-norm averages."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import train

    x, targets = training_batch(62, 2, 64, "cpu")
    state = unet.init_mesmer(seed=2, dtype=torch.float32, device="cpu").state_dict()
    res = {}
    for dev in ("cpu", DEVICE):
        model = fresh_model(state, torch.float32, dev)
        with train.training_precision(model):
            loss = train.mesmer_loss(model(x.to(dev)), {k: v.to(dev) for k, v in
                                                        targets.items()}, inner_weight=10.0)
            names, params = zip(*model.named_parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[dev] = (float(loss.detach()), {n: None if g is None else g.cpu()
                                  for n, g in zip(names, grads)},
                    {n: b.cpu() for n, b in model.named_buffers()})
    (l_cpu, g_cpu, b_cpu), (l_gpu, g_gpu, b_gpu) = res["cpu"], res[DEVICE]
    loss_err = abs(l_gpu - l_cpu) / abs(l_cpu)
    grad_err = gradient_errors(g_gpu, g_cpu)
    bn_err = max(float(((b_gpu[k] - v).abs() / v.abs().clamp_min(1.0)).max())
                 for k, v in b_cpu.items())
    check(loss_err <= STEP_LOSS_RTOL, f"training step: loss differs by {loss_err}")
    check(grad_err <= STEP_GRAD_RTOL, f"training step: gradients differ by {grad_err}")
    check(bn_err <= STEP_BN_TOL, f"training step: batch-norm averages differ by {bn_err}")
    print(f"cpu vs cuda full-width f32 step 2 x 64^2: loss {l_gpu:.6f} (relative "
          f"difference {loss_err:.3g}, limit {STEP_LOSS_RTOL}), gradients within "
          f"{grad_err:.3g} of each tensor's largest entry (limit {STEP_GRAD_RTOL}), "
          f"batch-norm averages within {bn_err:.3g} (limit {STEP_BN_TOL})")


def held_out_scores(app):
    """Mesmer.predict(postprocess='device') under the level engine on the
    planted test's held-out sets; returns ({set: {compartment: (recall,
    precision, IoU)}}, the claim kernel's launches)."""
    from ark_tpu_torch.ops import watershed
    from ark_tpu_torch.segmentation import synthetic

    sets = {"spaced": synthetic.synthetic_cells(np.random.default_rng(999), 4, hw=64),
            "crowded": synthetic.synthetic_cells(np.random.default_rng(555), 4, hw=64,
                                                 crowding=0.35)}
    watershed._ENGINE = "levels"
    watershed.claim_round.launches = 0
    scores = {}
    for name, (imgs, cells, nucs) in sets.items():
        out = app.predict(imgs, postprocess="device")
        scores[name] = {}
        for comp, truth in (("whole_cell", cells), ("nuclear", nucs)):
            stats = [synthetic.match_instances(out[comp][i], truth[i]) for i in range(4)]
            scores[name][comp] = tuple(float(np.mean([s[k] for s in stats])) for k in
                                       ("recall", "precision", "mean_matched_iou"))
    launches = watershed.claim_round.launches
    watershed._ENGINE = "minimax"
    return scores, launches


def check_graphed_fit(x, targets):
    """Phase (l3): fit's CUDA-graph replays against the same steps launched
    one by one through train_step: losses, parameters and batch-norm
    averages bitwise equal."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import train

    graphed = unet.init_mesmer_mini(seed=3, device=DEVICE)
    _, losses = train.fit(graphed, x, targets, steps=GRAPH_CHECK_STEPS, batch_size=2,
                          seed=5, device=DEVICE)
    eager = unet.init_mesmer_mini(seed=3, device=DEVICE).train()
    opt = train.Adam(eager.parameters(), 1e-3)
    rows = torch.as_tensor(train.minibatch_order(x.shape[0], GRAPH_CHECK_STEPS, 2, 5),
                           device=DEVICE)
    with train.training_precision(eager):
        ref = torch.stack([train.train_step(eager, opt, x[r], {k: v[r] for k, v in
                                                              targets.items()})
                           for r in rows]).cpu().numpy()
    check(np.array_equal(losses, ref), f"graphed fit: losses {losses} != eager {ref}")
    got, want = graphed.state_dict(), eager.eval().state_dict()
    check(all(torch.equal(got[k], want[k]) for k in want),
          "graphed fit: parameters or averages differ from the eager steps")
    print(f"fit with CUDA-graph replays ({train.GRAPH_WARMUP} eager steps, "
          f"{GRAPH_CHECK_STEPS - train.GRAPH_WARMUP} replays) == the same steps launched "
          f"one by one: losses, parameters and averages bitwise")


def run_training_e2e():
    """Phase (l3): train_on_synthetic on the card with the shipped
    checkpoint's recipe, then the planted test's floors on the held-out
    sets. Returns the claim kernel's launches in that evaluation."""
    import torch

    from ark_tpu_torch.models import unet
    from ark_tpu_torch.segmentation import train

    # launches and device time of one step of the recipe's mini fit
    x, targets = training_batch(63, 4, RECIPE["hw"], DEVICE)
    check_graphed_fit(x, targets)
    model = unet.init_mesmer_mini(seed=0, device=DEVICE).train()
    opt = train.Adam(model.parameters(), 1e-3)
    with train.training_precision(model):
        train.train_step(model, opt, x, targets)
        _, step_dev_s, step_launches = device_totals(
            lambda: train.train_step(model, opt, x, targets))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    app, losses = train.train_on_synthetic(**RECIPE, device=DEVICE)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    check(losses.shape == (RECIPE["steps"],) and bool(np.isfinite(losses).all()),
          "train_on_synthetic: loss curve not finite")
    scores, claim_launches = held_out_scores(app)
    check(claim_launches > 0, "held-out evaluation: the claim kernel never launched")
    for comp, floor in PLANTED_FLOORS.items():
        got = scores["spaced"][comp]
        check(all(g >= f for g, f in zip(got, floor)),
              f"held-out {comp}: recall, precision, IoU {got} under {floor}")
    got = scores["crowded"]["whole_cell"]
    check(all(g >= f for g, f in zip(got, CROWDED_FLOOR)),
          f"crowded whole_cell: recall, precision, IoU {got} under {CROWDED_FLOOR}")
    print(f"train_on_synthetic {RECIPE} on the card ({CARD}): {fit_s:.2f} s "
          f"({fit_s / RECIPE['steps'] * 1e3:.2f} ms a step with the data set-up; one "
          f"CUDA-graph replay a step after {train.GRAPH_WARMUP} eager ones); one eager "
          f"step: {step_launches} kernels and copies, {step_dev_s * 1e3:.3f} ms device; "
          f"loss first 10 {losses[:10].mean():.4f}, last 10 {losses[-10:].mean():.4f}")
    for name, comps in scores.items():
        print(f"held-out {name} (recall, precision, matched IoU; level engine): "
              + ", ".join(f"{c} {tuple(round(v, 3) for v in r)}" for c, r in comps.items()))
    print(f"held-out evaluation: claim kernel launches {claim_launches}")
    return claim_launches


def run_conversion():
    """Phase (l4): a seeded manifest-shaped layer dict through the
    converter and params_from_flax into the full network, on the card
    against the CPU port (f32, TF32 off), then graft_entry.entry once."""
    import torch

    from ark_tpu_torch import graft_entry
    from ark_tpu_torch.models import convert_deepcell, unet

    t0 = time.perf_counter()
    state = unet.params_from_flax(convert_deepcell.convert(
        manifest_layers(np.random.default_rng(64)), convert_deepcell.template_variables()))
    convert_s = time.perf_counter() - t0
    x = np.random.default_rng(65).random(CONVERT_SHAPE, dtype=np.float32)
    heads = {}
    for dev in ("cpu", DEVICE):
        net = unet.PanopticNet(dtype=torch.float32)
        net.load_state_dict(state)
        with torch.inference_mode(), unet.full_f32():
            heads[dev] = {k: v.cpu() for k, v in net.to(dev).eval()(
                torch.as_tensor(x, device=dev)).items()}
    err = 0.0
    for k, ref in heads["cpu"].items():
        scale = float(ref.abs().max())
        check(bool(torch.isfinite(ref).all()) and scale > 1e-3,
              f"converted forward {k}: not finite or all zero")
        err = max(err, float((heads[DEVICE][k] - ref).abs().max()) / max(scale, 1.0))
    check(err <= HEADS_ATOL, f"converted forward: card and CPU differ by {err}")
    forward, args = graft_entry.entry(device=DEVICE)
    inner, pixelwise = forward(*args)
    check(tuple(inner.shape) == (1, 128, 128, 1) and tuple(pixelwise.shape)
          == (1, 128, 128, 3) and bool(torch.isfinite(pixelwise).all()),
          "graft_entry.entry: wrong or non-finite heads")
    print(f"conversion: manifest layers -> convert -> params_from_flax in {convert_s:.2f} s; "
          f"forward {CONVERT_SHAPE} f32 card vs CPU port within {err:.3g} of max(|head|, 1) "
          f"(limit {HEADS_ATOL}); graft_entry.entry(device='cuda') ran")


def run_training_phase():
    """Phase (l): training and conversion. Returns the claim kernel's
    launches in the held-out evaluation of (l3)."""
    x, targets = training_batch(61, TRAIN_BATCH, TRAIN_HW, DEVICE)
    run_training_steps(x, targets)
    check_deterministic_steps(x, targets)
    del x, targets
    compare_training_step_cpu_cuda()
    claim_launches = run_training_e2e()
    run_conversion()
    return claim_launches

# ---------------------------------------------------------------------------
# Phase (m): the last single-card modules (no kernel of their own)
# ---------------------------------------------------------------------------

CC_SIZES = (1024, 2048)
CC_DENSITY = 0.55              # near 4-connected percolation: many components, long rounds
CC_MIN_SIZE = 64
QUANT_SHAPE = (4 * 1024 ** 2, len(CHANNELS))   # the pixel stage's 4 FOVs x 16 columns
QUANT_Q = 0.999
QUANT_CPU_ROWS = 100_000       # the card held to the CPU port on this many rows
PREFETCH_FOVS = 8
PREFETCH_SIZE = 1024


def check_single_image_cc(rng):
    """Phase (m1): label, area_filter, remove_small_objects and
    remove_small_holes on seeded masks at 1024^2 and 2048^2 (label at both
    connectivities), each bitwise the CPU port's, timed with its launches.
    Returns {(function, size): (ms, device ms, launches)}."""
    import torch

    from ark_tpu_torch.ops import cc

    out = {}
    for size in CC_SIZES:
        mask = rng.random((size, size)) < CC_DENSITY
        mask_dev = torch.as_tensor(mask, device=DEVICE)
        for conn in (1, 2):
            labels, count, _, done = cc._label_full(mask_dev, conn)
            want, want_count = cc.label(mask, conn, device="cpu")
            check(done and torch.equal(labels.cpu(), want) and int(count) == int(want_count),
                  f"label {size}^2 connectivity {conn}: the card and the CPU port differ")
            fns = {"label": (lambda: cc.label(mask_dev, conn, device=DEVICE), None)}
            if conn == 1:
                fns.update({
                    "area_filter": (lambda: cc.area_filter(labels, min_area=CC_MIN_SIZE),
                                    cc.area_filter(want, min_area=CC_MIN_SIZE)),
                    "remove_small_objects": (
                        lambda: cc.remove_small_objects(mask_dev, CC_MIN_SIZE, conn,
                                                        device=DEVICE),
                        cc.remove_small_objects(mask, CC_MIN_SIZE, conn, device="cpu")),
                    "remove_small_holes": (
                        lambda: cc.remove_small_holes(mask_dev, CC_MIN_SIZE, conn,
                                                      device=DEVICE),
                        cc.remove_small_holes(mask, CC_MIN_SIZE, conn, device="cpu"))})
            for name, (fn, cpu) in fns.items():
                if cpu is not None:
                    check(torch.equal(fn().cpu(), cpu), f"{name} {size}^2: the card and "
                          f"the CPU port differ")
                ms = time_ms(fn, reps=5)
                # the profiler's launches at the larger size only (each session
                # costs seconds of set-up)
                dev_ms, launches = kernels_per_call(fn) if size == CC_SIZES[-1] \
                    else (None, None)
                key = f"{name}" + (f" (connectivity {conn})" if name == "label" else "")
                out[(key, size)] = (ms, dev_ms, launches)
                print(f"cc.{key} {size}^2 (density {CC_DENSITY}, {int(want_count)} "
                      f"components) on {DEVICE} [{CARD}]: bitwise the CPU port's; "
                      f"{ms:.3f} ms per call (CUDA events, median of 5)"
                      + ("" if launches is None else
                         f", device {dev_ms:.3f} ms in {launches} kernels and copies"))
        del mask_dev, labels
    return out


def quantile_columns(rng, shape):
    """Pixel-stage-like columns: row-normalized nonnegative values with a
    third zeros, and a valid-row mask (the kept pixels)."""
    x = pixel_rows(rng, *shape)
    x[rng.random(shape) < 1 / 3] = 0
    return x, rng.random(shape[0]) < 0.85


def check_bisection_quantiles(rng):
    """Phase (m2): both bisection quantiles against the sort path on the card
    at the pixel stage's 4 x 1024^2 x 16 columns, q = 0.999, bitwise, each
    timed with its launches; the card held to the CPU port on the first
    QUANT_CPU_ROWS rows. Returns {form: (ms, device ms, launches) of
    bisection and of sort}."""
    import torch

    from ark_tpu_torch.ops import quantiles as Q

    x_host, valid_host = quantile_columns(rng, QUANT_SHAPE)
    x, valid = torch.as_tensor(x_host, device=DEVICE), torch.as_tensor(valid_host,
                                                                       device=DEVICE)
    forms = {
        "nonzero_quantile_per_column": (
            lambda a, v: Q.nonzero_quantile_per_column_bisect(a, QUANT_Q),
            lambda a, v: Q.nonzero_quantile_per_column(a, QUANT_Q)),
        "masked_quantile_per_column": (
            lambda a, v: Q.masked_quantile_per_column_bisect(a, v, QUANT_Q),
            lambda a, v: Q.masked_quantile_per_column(a, v, QUANT_Q))}
    out = {}
    for name, (bisect, by_sort) in forms.items():
        got = bisect(x, valid)
        check(torch.equal(got, by_sort(x, valid)), f"{name}: bisection and sort differ "
              f"on the card")
        rows = slice(0, QUANT_CPU_ROWS)
        small = bisect(x[rows], valid[rows]).cpu()
        check(torch.equal(small, bisect(torch.as_tensor(x_host[rows]),
                                        torch.as_tensor(valid_host[rows]))),
              f"{name}: the card's bisection differs from the CPU port's")
        timing = {}
        for form, fn in (("bisect", bisect), ("sort", by_sort)):
            ms = time_ms(lambda: fn(x, valid), reps=5)
            # the two forms launch alike: the profiler reads the first only
            timing[form] = (ms,) + (kernels_per_call(lambda: fn(x, valid)) if not out
                                    else (None, None))
        out[name] = timing
        print(f"{name} {QUANT_SHAPE[0]} x {QUANT_SHAPE[1]} q={QUANT_Q} on {DEVICE} "
              f"[{CARD}]: bisection bitwise the sort path (and the CPU port on "
              f"{QUANT_CPU_ROWS} rows); bisection {timing['bisect'][0]:.3f} ms, sort "
              f"{timing['sort'][0]:.3f} ms (CUDA events, median of 5)"
              + ("" if timing["sort"][2] is None else
                 f"; device {timing['bisect'][1]:.3f} and {timing['sort'][1]:.3f} ms in "
                 f"{timing['bisect'][2]} and {timing['sort'][2]} launches"))
    return out


def prefetch_pool():
    """Phase (m3)'s in-memory source: one seeded 1024^2 x 16 FOV of phase
    4's kind, made once (set-up), and a fixed channel normalization (the
    channel percentiles' role in the pixel stage)."""
    raw = make_cohort(np.random.default_rng(1000), 1, PREFETCH_SIZE)[0]
    return raw, np.linspace(2.0, 6.0, len(CHANNELS)).reshape(1, 1, -1)


def load_fov(pool, index):
    """FOV `index` of the in-memory cohort: the pool's FOV shifted by a
    seeded offset, channel-normalized on the host as the pixel stage does
    before its upload; a copy and a divide of 64 MB, the host work a TIFF
    read stands for."""
    from ark_tpu_torch.phenotyping import pixie_preprocessing

    raw, norm = pool
    shift = tuple(np.random.default_rng(index).integers(0, PREFETCH_SIZE, 2))
    return pixie_preprocessing.channel_norm_divide(np.roll(raw, shift, axis=(0, 1)), norm)


def prefetch_step(img):
    """Phase 4's per-FOV preprocessing: blur and row-normalize."""
    from ark_tpu_torch.phenotyping import pixie_fused

    return pixie_fused._prep_fov_parts(img, 2)


def run_prefetch(pool):
    """Phase (m3): PREFETCH_FOVS seeded in-memory FOV loads feeding phase
    4's preprocessing, through PrefetchLoader(device=DEVICE) against a
    sequential load-upload-compute loop: equal outputs, wall seconds of
    each and the loads' own host seconds. Returns (sequential s, prefetched
    s, the loads' s a pass)."""
    import torch

    from ark_tpu_torch.parallel.prefetch import PrefetchLoader

    load_s = []

    def timed_load(i):
        t0 = time.perf_counter()
        fov = load_fov(pool, i)
        load_s.append(time.perf_counter() - t0)
        return fov

    prefetch_step(torch.as_tensor(load_fov(pool, 0), device=DEVICE))       # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sequential = [prefetch_step(torch.as_tensor(timed_load(i), device=DEVICE))
                  for i in range(PREFETCH_FOVS)]
    torch.cuda.synchronize()
    seq_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prefetched = [prefetch_step(img) for _, img in
                  PrefetchLoader(range(PREFETCH_FOVS), timed_load, device=DEVICE)]
    torch.cuda.synchronize()
    pre_s = time.perf_counter() - t0
    for i, (a, b) in enumerate(zip(sequential, prefetched)):
        check(all(torch.equal(x, y) for x, y in zip(a, b)),
              f"prefetched FOV {i}: preprocessing differs from the sequential loop's")
    loads = sum(load_s) / 2
    print(f"prefetch: {PREFETCH_FOVS} FOVs of {PREFETCH_SIZE}^2 x {len(CHANNELS)} "
          f"(seeded in-memory loads, blur + row-normalize on {DEVICE}) [{CARD}]: "
          f"outputs equal; "
          f"sequential {seq_s:.3f} s, PrefetchLoader(device={DEVICE!r}) {pre_s:.3f} s "
          f"({seq_s / pre_s:.2f}x); the loads alone {loads:.3f} s of host time a pass")
    return seq_s, pre_s, loads


def check_trace(pool):
    """Phase (m4): trace() around one preprocessing step: its Chrome trace
    exists and holds CUDA kernel events. Returns their count."""
    import torch

    from ark_tpu_torch.utils import profiling

    img = torch.as_tensor(load_fov(pool, 1), device=DEVICE)
    with tempfile.TemporaryDirectory() as log_dir:
        with profiling.trace(log_dir, device=DEVICE):
            prefetch_step(img)
            torch.cuda.synchronize()
        files = os.listdir(log_dir)
        check(len(files) == 1, f"trace(): {len(files)} files in its log_dir")
        with open(os.path.join(log_dir, files[0])) as f:
            events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    check(kernels > 0, "trace(): the Chrome trace holds no CUDA kernel event")
    print(f"trace(): one preprocessing step's Chrome trace holds {len(events)} events, "
          f"{kernels} of them CUDA kernels [{CARD}]")
    return kernels


def run_single_card_modules():
    """Phase (m), which launches none of the port's kernels (checked).
    Returns the timings of (m1)-(m3), (m4)'s kernel events and the kernel
    counts it read: [bmu, claim round, segment sum, segment plan]."""
    from ark_tpu_torch.ops import segment_reduce, som, watershed

    counters = (som.bmu, watershed.claim_round, segment_reduce.segment_sum,
                segment_reduce.segment_plan)
    for fn in counters:
        fn.launches = 0
    parts = {}
    t0 = time.perf_counter()
    cc_t = check_single_image_cc(np.random.default_rng(57))
    parts["m1 cc"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    quant_t = check_bisection_quantiles(np.random.default_rng(58))
    parts["m2 quantiles"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = prefetch_pool()
    prefetch_t = run_prefetch(pool)
    parts["m3 prefetch"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    trace_kernels = check_trace(pool)
    parts["m4 trace"] = time.perf_counter() - t0
    print("phase (m) seconds by part (host clock, CPU references included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in parts.items()))
    launches = [fn.launches for fn in counters]
    check(launches == [0, 0, 0, 0], f"phase (m) launched the port's kernels: {launches}")
    return cc_t, quant_t, prefetch_t, trace_kernels, launches


# phase (o): the templates' file entry points on the card, templates 1 -> 3
# -> spatial, fiber and OME, on phase 8's planted 3 x 1024^2 cohort written
# as per-channel TIFFs with phase 12's 40 marker channels
MESMER_CHANNELS = ("nuclear", "membrane")
NEIGHBOR_DISTLIM = 50
FILE_DIRS = ("image_data", "deepcell_input", "deepcell_output", "cell_masks", "dist_mats",
             "fiber_data", "fiber_out", "ome", "ome_back")


def templates_from_files(base, images, fiber_img, device, ckpt=CKPT, xdim=10, ydim=10,
                         max_k=20):
    """The templates' steps from files, each through the port's entry point
    on `device`: generate_deepcell_input, create_deepcell_output (the device
    postprocess), generate_cell_table (nuclear counts), the generic cell
    clustering template's SOM and consensus over the marker columns, the
    cell-cluster masks, calc_dist_matrix with create_neighborhood_matrix,
    run_fiber_segmentation on `fiber_img` and an OME round trip of the first
    FOV. images: {fov: {channel: 2-D array}}, with the MESMER_CHANNELS.
    Returns the outputs and seconds[step] = (wall s, TIFF codec s)."""
    from ark_tpu_torch.analysis import neighborhood_analysis, spatial_analysis_utils
    from ark_tpu_torch.io import ome_utils
    from ark_tpu_torch.phenotyping import cell_meta_clustering, cell_som_clustering
    from ark_tpu_torch.segmentation import fiber_segmentation, marker_quantification
    from ark_tpu_torch.utils import data_utils
    from ark_tpu_torch.utils import deepcell_service_utils as dcs

    fovs = list(images)
    d = {name: os.path.join(base, name) for name in FILE_DIRS}
    for name in ("deepcell_input", "cell_masks", "dist_mats", "fiber_out"):
        os.makedirs(d[name])
    markers = [c for c in images[fovs[0]] if c not in MESMER_CHANNELS]
    run, seconds = timed_steps(device)
    out = {"dirs": d, "fovs": fovs, "markers": markers}

    run("write_tiffs", lambda: (write_channel_tree(d["image_data"], images),
                                write_channel_tree(d["fiber_data"],
                                                   {"fov0": {"fiber": fiber_img}})))
    run("generate_deepcell_input", lambda: dcs.generate_deepcell_input(
        d["deepcell_input"], d["image_data"], ["nuclear"], ["membrane"], fovs,
        img_sub_folder=None))
    run("create_deepcell_output", lambda: dcs.create_deepcell_output(
        d["deepcell_input"], d["deepcell_output"], fovs, weights_path=ckpt, device=device,
        postprocess="device"))
    out["table"], _ = run("generate_cell_table", lambda: marker_quantification.
                          generate_cell_table(d["deepcell_output"], d["image_data"],
                                              img_sub_folder=None, fovs=fovs,
                                              nuclear_counts=True, device=device))
    table_path = os.path.join(base, "cell_table_size_normalized.csv")
    out["table"].to_csv(table_path, index=False)

    def cell_clustering():
        pysom = cell_som_clustering.train_cell_som(
            fovs, base, table_path, markers, out["table"].copy(), xdim=xdim, ydim=ydim,
            device=device)
        labeled = cell_som_clustering.cluster_cells(base, pysom, markers)
        cell_som_clustering.generate_som_avg_files(base, labeled, markers, "cell_som_avg.csv")
        return cell_meta_clustering.cell_consensus_cluster(base, markers, labeled,
                                                           "cell_som_avg.csv", max_k=max_k)
    out["cell_cc"], out["labeled"] = run("cell_som_and_consensus", cell_clustering)
    mapping = out["cell_cc"].mapping.copy()
    mapping["cell_meta_cluster_rename"] = [f"type_{m}" for m in mapping["cell_meta_cluster"]]
    id_csv = os.path.join(base, "cell_meta_cluster_mapping.csv")
    mapping.to_csv(id_csv, index=False)
    run("cell_cluster_masks", lambda: data_utils.generate_and_save_cell_cluster_masks(
        fovs, d["cell_masks"], d["deepcell_output"], out["labeled"], id_csv,
        cell_cluster_col="cell_meta_cluster", device=device))
    run("calc_dist_matrix", lambda: spatial_analysis_utils.calc_dist_matrix(
        out["labeled"], d["dist_mats"], device=device))
    out["neighborhood"] = run("create_neighborhood_matrix", lambda: neighborhood_analysis.
                              create_neighborhood_matrix(
                                  out["labeled"], d["dist_mats"], distlim=NEIGHBOR_DISTLIM,
                                  cell_type_col="cell_meta_cluster", device=device))
    out["fibers"] = run("run_fiber_segmentation", lambda: fiber_segmentation.
                        run_fiber_segmentation(d["fiber_data"], "fiber", d["fiber_out"],
                                               device=device))
    out["ome"] = run("fov_to_ome", lambda: ome_utils.fov_to_ome(
        os.path.join(d["image_data"], fovs[0]), d["ome"]))
    out["ome_back"] = run("ome_to_fov", lambda: ome_utils.ome_to_fov(out["ome"],
                                                                     d["ome_back"]))
    return out, seconds


def check_templates_from_files(out, images, fiber_img, device, ckpt=CKPT, xdim=10,
                               ydim=10, max_k=20):
    """Phase (o)'s outputs held to the same functions on the same arrays in
    memory on the same device: every TIFF read back by the codec equals the
    array written; the masks equal Mesmer.predict's, the cell table
    create_marker_count_matrices', the SOM labels CellSOMCluster's, the Ward
    mapping maps every SOM cluster into 1..max_k and labels the table, the
    cluster masks cluster_mask_from_labels', the distance files
    pairwise_distances', the neighborhood matrix the counts over those
    distances, the fiber labels and table those of _fiber_steps with its table and
    alignment; the OME round trip gives the channels back. Returns the
    number of cells and meta clusters."""
    import pandas as pd

    from ark_tpu_torch import settings
    from ark_tpu_torch.analysis import spatial_analysis_utils as sau
    from ark_tpu_torch.io import io_utils, tiff
    from ark_tpu_torch.ops import distances
    from ark_tpu_torch.phenotyping import cluster_helpers
    from ark_tpu_torch.segmentation import fiber_segmentation as fs
    from ark_tpu_torch.segmentation import marker_quantification, mesmer
    from ark_tpu_torch.utils import data_utils
    from ark_tpu_torch.utils.labeled_array import DataArray

    d, fovs, markers = out["dirs"], out["fovs"], out["markers"]

    def same(path, want, what):
        got = tiff.read(path)
        want = np.asarray(want)
        check(got.shape == want.shape and np.array_equal(got, want),
              f"{what}: {os.path.basename(path)} read back {got.dtype} {got.shape} differs "
              f"from the array {want.dtype} {want.shape}")

    chans = io_utils.remove_file_extensions(io_utils.list_files(
        os.path.join(d["image_data"], fovs[0]), substrs=[".tiff", ".tif"]))
    for fov in fovs:
        for chan in chans:
            same(os.path.join(d["image_data"], fov, f"{chan}.tiff"),
                 images[fov][chan].astype(np.float32), "input channel")
    stack = np.stack([np.stack([images[f][c].astype(np.float32) for c in MESMER_CHANNELS],
                               -1) for f in fovs])
    for i, fov in enumerate(fovs):
        same(os.path.join(d["deepcell_input"], f"{fov}.tiff"),
             np.moveaxis(stack[i], -1, 0), "deepcell input")
    masks = mesmer.Mesmer(weights_path=ckpt, device=device).predict(stack,
                                                                    postprocess="device")
    for i, fov in enumerate(fovs):
        for comp in ("whole_cell", "nuclear"):
            same(os.path.join(d["deepcell_output"], f"{fov}_{comp}.tiff"),
                 masks[comp][i].astype(np.int32), f"{comp} mask")

    table = out["table"]
    for i, fov in enumerate(fovs):
        coords = {"fovs": [fov], "rows": np.arange(stack.shape[1]),
                  "cols": np.arange(stack.shape[2])}
        seg = DataArray(np.stack([masks["whole_cell"][i], masks["nuclear"][i]], -1)[None]
                        .astype(np.int32),
                        coords={**coords, "compartments": ["whole_cell", "nuclear"]})
        img = DataArray(np.stack([images[fov][c].astype(np.float32) for c in chans], -1)[None],
                        coords={**coords, "channels": chans})
        want, _ = marker_quantification.create_marker_count_matrices(
            seg, img, nuclear_counts=True, device=device)
        want["mask_type"] = "whole_cell"
        got = table[table[settings.FOV_ID] == fov].reset_index(drop=True)
        pd.testing.assert_frame_equal(got, want.reset_index(drop=True), check_exact=True)

    labeled = out["labeled"]
    with tempfile.TemporaryDirectory() as tmp:
        pysom = cluster_helpers.CellSOMCluster(
            table.copy(), os.path.join(tmp, "w.feather"), fovs, markers, xdim=xdim,
            ydim=ydim, device=device)
        pysom.train_som()
        want = pysom.assign_som_clusters()["cell_som_cluster"].to_numpy()
    check(np.array_equal(labeled["cell_som_cluster"].to_numpy(), want),
          "cell SOM labels from files differ from CellSOMCluster's in memory")
    # the Ward mapping's properties (its parity with sklearn's is held by the
    # CPU tests): every SOM cluster with cells mapped once, max_k meta
    # clusters 1..max_k, and the labeled table labeled through it
    mapping = out["cell_cc"].mapping
    som_ids = mapping["cell_som_cluster"]
    check(som_ids.is_unique and set(labeled["cell_som_cluster"]) <= set(som_ids),
          "the Ward mapping does not map every SOM cluster once")
    check(set(mapping["cell_meta_cluster"]) == set(range(1, max_k + 1)),
          f"the Ward mapping's meta clusters are not 1..{max_k}")
    mapped = labeled["cell_som_cluster"].map(mapping.set_index("cell_som_cluster")
                                             ["cell_meta_cluster"])
    check(np.array_equal(mapped.to_numpy(), labeled["cell_meta_cluster"].to_numpy()),
          "the labeled table's meta clusters are not its SOM clusters mapped")
    n_meta = int(labeled["cell_meta_cluster"].nunique())
    check(n_meta == max_k, f"{n_meta} cell meta clusters, expected {max_k}")

    cmd = data_utils.ClusterMaskData(labeled, settings.FOV_ID, settings.CELL_LABEL,
                                     "cell_meta_cluster")
    # neighbor counts from the in-memory distances: other cells nearer than
    # distlim (a distance of 0 is no neighbor), by meta cluster
    types = labeled["cell_meta_cluster"].to_numpy()
    type_names = labeled["cell_meta_cluster"].drop_duplicates().tolist()
    near_counts = np.zeros((len(labeled), len(type_names)), np.int64)
    for i, fov in enumerate(fovs):
        same(os.path.join(d["cell_masks"], f"{fov}.tiff"),
             data_utils.cluster_mask_from_labels(fov, masks["whole_cell"][i], cmd,
                                                 device=device), "cell cluster mask")
        rows = labeled[labeled[settings.FOV_ID] == fov]
        xy = sau._to_device(rows[[settings.CENTROID_0, settings.CENTROID_1]].values, device)
        want = distances.pairwise_distances(xy, xy, zero_diagonal=True).cpu().numpy()
        got = sau.load_dist_matrix(d["dist_mats"], fov)
        check(np.array_equal(got.values, want)
              and list(got.coords["dim_0"]) == list(rows[settings.CELL_LABEL]),
              f"{fov}: the distance file differs from pairwise_distances in memory")
        at = np.flatnonzero((labeled[settings.FOV_ID] == fov).to_numpy())
        near = ((want < NEIGHBOR_DISTLIM) & (want != 0)).astype(np.int64)
        near_counts[at] = near.T @ (types[at, None] == np.array(type_names)[None])
    keep = near_counts.sum(1) != 0
    counts = out["neighborhood"][0]
    check(len(counts) > 0 and np.array_equal(counts[type_names].to_numpy(), near_counts[keep])
          and counts[settings.FOV_ID].tolist() == labeled[settings.FOV_ID][keep].tolist(),
          "neighborhood matrix differs from the counts over the in-memory distances")

    x = fiber_img.astype(np.float32).astype(float)
    steps = fs._fiber_steps(x, x.shape[0], *FIBER_DEFAULTS.values(), keep_intermediates=False,
                            device=device)
    same(os.path.join(d["fiber_out"], "fov0_fiber_labels.tiff"), steps["labeled_filtered"],
         "fiber labels")
    want = fs._fiber_regionprops_table(steps["labeled_filtered"], settings.FIBER_OBJECT_PROPS,
                                       device=device)
    want.insert(0, settings.FOV_ID, "fov0")
    want = fs.calculate_fiber_alignment(want, device=device)
    pd.testing.assert_frame_equal(out["fibers"].reset_index(drop=True),
                                  want.reset_index(drop=True), check_exact=True)

    ome_chans = io_utils.remove_file_extensions(io_utils.list_files(
        os.path.join(d["image_data"], fovs[0]), substrs=[".tiff", ".tif"]))
    same(out["ome"], np.stack([images[fovs[0]][c].astype(np.float32) for c in ome_chans]),
         "OME stack")
    for chan in ome_chans:
        same(os.path.join(out["ome_back"], f"{chan}.tiff"),
             images[fovs[0]][chan].astype(np.float32), "OME round trip")
    return len(table), n_meta


def run_templates_from_files(planted, quant, fiber_fov):
    """Phase (o) on the card: `planted` (3, H, W, 2) Mesmer channels and
    phase 12's 40 marker channels (`quant`) as one channel tree, phase (f)'s
    fiber FOV beside it. Prints seconds per step with the TIFF codec's
    share; returns the launches of the BMU, segment-sum and plan kernels in
    the entry points' run."""
    from ark_tpu_torch.ops import segment_reduce, som

    images = {}
    for i, (_, img, _) in enumerate(quant):
        fov = f"fov{i}"
        images[fov] = {"nuclear": planted[i, ..., 0], "membrane": planted[i, ..., 1]}
        images[fov].update({c: img.values[0, ..., j] for j, c in enumerate(QUANT_CHANNELS)})
    counters = (som.bmu, segment_reduce.segment_sum, segment_reduce.segment_plan)
    with tempfile.TemporaryDirectory() as base:
        for fn in counters:
            fn.launches = 0
        t0 = time.perf_counter()
        out, seconds = templates_from_files(base, images, fiber_fov, DEVICE)
        total = time.perf_counter() - t0
        launches = [fn.launches for fn in counters]
        t0 = time.perf_counter()
        n_cells, n_meta = check_templates_from_files(out, images, fiber_fov, DEVICE)
        check_s = time.perf_counter() - t0
    n_chan = len(images["fov0"])
    tiff_s = sum(io_s for _, io_s in seconds.values())
    print(f"templates from files, {len(images)} x {planted.shape[1]}^2 x {n_chan} channel "
          f"TIFFs and one {fiber_fov.shape[0]}^2 fiber FOV on {DEVICE} [{CARD}]: {total:.3f} s, "
          f"{tiff_s:.3f} s in the TIFF codec; per step (wall s, TIFF s): {fmt_steps(seconds)}")
    print(f"templates from files: {n_cells} cells, {n_meta} meta clusters; every TIFF read "
          f"back equal to its array, masks, cell table, SOM labels, cluster masks, distance "
          f"files, neighbor counts, fiber labels and table equal to the in-memory calls, the "
          f"Ward mapping's labels consistent (its parity with sklearn is held in the CPU "
          f"tests) ({check_s:.1f} s); launches bmu {launches[0]}, segment_sum {launches[1]}, "
          f"segment_plan {launches[2]}")
    check(all(n > 0 for n in launches), f"phase (o) launches {launches}: a kernel of the "
          f"file path never ran")
    return launches


# phase (n): graft_entry.dryrun_multigpu at full width. The machine has one
# card: NCCL takes one rank on it, gloo ranks share it (NCCL refuses two)
MULTI_GPU_RUNS = ((1, "nccl"), (2, "gloo"))
MULTI_GPU_DEVICE = "cuda:0"
MULTI_GPU_MINI = False              # the published network, as phase (l1)
MULTI_GPU_TIMEOUT_S = 300.0
MULTI_GPU_PIXEL_FOVS = 5            # one padding FOV at 2 ranks
# 2 ranks against 1 (the same updates summed in other splits): one SOM step
# and the LDA step's statistics to a few f32 roundings; UMAP's coordinates
# to 64 ulps of the largest: a point's epoch delta sums up to ~100 updates
# clipped at +-4, whose partial sums reach ~8x the coordinates, and the split
# reorders those additions (8 ulps of the coordinate measured at the
# 1,528,980-edge graph on an H100); the SOM schedule's minibatches
# depend on the world size, so its quantization error is held to 5%
SOM_STEP_ATOL, LDA_SPLIT_RTOL, UMAP_SPLIT_ULPS, SOM_QE_RTOL = 1e-5, 1e-5, 64, 0.05
# the UMAP epoch at 1 and 2 ranks against the same updates in float64 (the
# plain path: index_add_ from the f32 start): f32 rounds each update's
# powers and quotients and the sums of up to ~100 of them, so UMAP_F64_ULPS
# ulps of the largest coordinate
UMAP_F64_ULPS = 64
# Mesmer's step at 8 x 256^2, at 1 and 2 ranks against the plain train-mode
# step (one process, each batch norm's own mean, the dry run's loss,
# autograd) and 2 ranks against 1: phase (l2)'s loss and averages
# tolerances, but the gradients within MESMER_GRAD_RTOL of each tensor's
# largest entry. The batch-norm biases' gradients are near-cancelling sums
# over 524,288 pixels, which any other f32 order of the same sums moves
# above STEP_GRAD_RTOL: on an H100 one process against itself on the batch
# reversed read 4.74e-4, 2 ranks against 1 read 4.82e-4. The CPU tests
# hold the split exactly (equal halves on 2 ranks, bitwise 1 rank on one)
MESMER_GRAD_RTOL = 1e-3
BITWISE_STAGES = ("pixel", "quant", "enrichment", "flood", "fiber")
COUNTED_KERNELS = ("bmu", "claim_round", "segment_sum", "segment_plan")


def multi_gpu_inputs(pixel, app, flood_fovs, dense, quant, spatial, lda_out, fiber_fov,
                     cell_counts):
    """Phase (n)'s inputs at full width, under ``graft_entry.dryrun_inputs``'
    keys: phase (l1)'s 8 x 256^2 training batch; phase 4's SOM training
    rows, channel norms, threshold and weights with 5 of its 1024^2 x 16
    FOVs; the dense 3 x 1024^2 masks with 40 channels; phase (c)'s 10 x 3000
    cells (20 phenotypes, B = 100); the whole-cell relief, maxima and
    foreground of the 8 x 512^2 planted cohort; phase (f)'s fiber FOV and
    its two mirror images; phase (k)'s training features with their
    Laplacian blocks (5 topics); the k = 15 graph and PCA start of the
    cell-clustering cohort's cells."""
    import torch

    from ark_tpu_torch.ops import cc, umap
    from ark_tpu_torch.spLDA import model as lda_model

    inp = {}
    x, targets = training_batch(61, TRAIN_BATCH, TRAIN_HW, DEVICE)
    inp["x"] = x.cpu().numpy()
    inp["y_dist"] = targets["whole_cell_inner_distance"].cpu().numpy()
    inp["y_pix"] = targets["whole_cell_pixelwise"].cpu().numpy()
    inp["som_data"] = pixel["train"]
    inp["som_w0"] = np.random.default_rng(60).random((100, len(CHANNELS))).astype(np.float32)
    inp["pixel_imgs"] = np.stack(make_cohort(np.random.default_rng(7), MULTI_GPU_PIXEL_FOVS,
                                             1024))
    inp["channel_norms"] = pixel["norm_pre"].astype(np.float32)
    inp["post_norms"] = pixel["norm_post"].astype(np.float32)
    inp["pixel_thresh"] = np.float32(pixel["thresh"])
    inp["pixel_weights"] = pixel["weights"]
    inp["quant_imgs"] = np.stack([img.values[0] for _, img, _ in quant])
    inp["quant_labels"] = np.stack(dense["whole_cell"]).astype(np.int32)
    inp["quant_segments"] = np.int64(inp["quant_labels"].max() + 1)
    by_fov = [spatial[spatial["fov"] == f] for f in spatial["fov"].unique()]
    inp["enrich_coords"] = np.stack([f[["centroid-0", "centroid-1"]].to_numpy(np.float32)
                                     for f in by_fov])
    inp["enrich_pos"] = np.stack([(f["cell_meta_cluster"].to_numpy()[None, :]
                                   == np.array(SPATIAL_TYPES)[:, None]).astype(np.float32)
                                  for f in by_fov])
    inp["enrich_dist_lim"] = np.float32(SPATIAL_TEMPLATE["dist_lim"])
    inp["enrich_boots"] = np.int64(SPATIAL_TEMPLATE["bootstrap_num"])
    res = app._segment_device(app._upload(flood_fovs), 0.1)["whole_cell"]
    inp["flood_elev"] = (-res["inner"]).cpu().numpy()
    inp["flood_markers"] = cc.label_batched_small(res["maxima"])[0].cpu().numpy()
    inp["flood_mask"] = (res["foreground"] > 0.3).cpu().numpy()
    inp["flood_levels"], inp["flood_rounds"] = np.int64(256), np.int64(32)
    inp["fiber_imgs"] = np.stack([fiber_fov, fiber_fov[::-1], fiber_fov[:, ::-1]])
    inp["fiber_widths"] = np.array(FIBER_DEFAULTS["fiber_widths"])
    train = lda_out["feats"]["train_features"]
    inp["lda_X"] = train.to_numpy(np.float32)
    inp["lda_lam"] = lda_model.initial_topics(42, LDA_N_TOPICS, train.shape[1])
    inp["lda_gamma"] = np.ones((len(train), LDA_N_TOPICS), np.float32)
    for first, block in lda_model.laplacian_blocks(
            train, lda_out["diffs"]["train_diff_mat"], device=DEVICE):
        inp[f"lda_block/{first}"] = block.cpu().numpy()
    data = torch.as_tensor(cell_counts, device=DEVICE)
    heads, tails, w = umap.fuzzy_graph(*umap._knn(data, 15))
    emb0 = umap._pca(data, 2)
    inp["umap_emb"] = (emb0 / (emb0.abs().max() + 1e-12) * 10.0).cpu().numpy()
    inp["umap_heads"], inp["umap_tails"] = heads.cpu().numpy(), tails.cpu().numpy()
    inp["umap_weights"] = w.cpu().numpy()
    return inp


def multi_gpu_references(inp, one):
    """World size 1 (NCCL) against the single-process port on the card:
    the pieces of each stage called directly, with no process group.
    Returns the LDA step's worst relative difference (the rest are
    bitwise)."""
    import torch

    from ark_tpu_torch.analysis import spatial_enrichment as se
    from ark_tpu_torch.ops import distances, segment_reduce, som, watershed
    from ark_tpu_torch.phenotyping import pixie_preprocessing
    from ark_tpu_torch.segmentation.fiber_segmentation import _fiber_device_program
    from ark_tpu_torch.ops import classical
    from ark_tpu_torch.spLDA import model as lda_model

    dev = MULTI_GPU_DEVICE

    def same(got, want, what):
        check(np.array_equal(np.asarray(got), np.asarray(want)),
              f"multi-GPU {what}: world size 1 differs from the single-process port")

    weights = torch.as_tensor(inp["pixel_weights"], device=dev)
    for i, img in enumerate(inp["pixel_imgs"]):
        x = torch.as_tensor(img, device=dev) / torch.as_tensor(inp["channel_norms"], device=dev)
        norm, valid = pixie_preprocessing._prep_fov_device(x, float(inp["pixel_thresh"]))
        norm = (norm / torch.as_tensor(inp["post_norms"], device=dev)).contiguous()
        idx, _ = som.bmu(weights, norm, return_dist=False)
        same(one["pixel"]["pixel_mat"][i], norm.cpu().numpy(), f"pixel_mat FOV {i}")
        same(one["pixel"]["som_clusters"][i],
             torch.where(valid, idx + 1, 0).cpu().numpy(), f"som_clusters FOV {i}")
    data = inp["som_data"]
    init_rows, rows, orders, bs_local = som._sharded_schedule(
        data.shape[0], 100, 1, 1, 0, None, True)
    gdist = torch.from_numpy(som.grid_distances(10, 10)).to(dev)
    w = som._train_steps(torch.as_tensor(data[rows], device=dev),
                         torch.as_tensor(data[init_rows], device=dev),
                         torch.from_numpy(orders[0]).to(dev), gdist, bs_local, 0.05, 0.01,
                         som.default_radius_start(10, 10))
    same(one["som"]["w_trained"], w.cpu().numpy(), "SOM schedule")
    f32 = lambda v: torch.tensor(np.float32(v), device=dev)  # noqa: E731
    w1 = som._train_step(torch.as_tensor(inp["som_w0"], device=dev),
                         torch.as_tensor(data, device=dev), f32(0.05), f32(2.0), gdist)
    same(one["som"]["w1"], w1.cpu().numpy(), "SOM step")
    img = torch.as_tensor(inp["quant_imgs"][0], device=dev)
    feats, sums = segment_reduce.moment_and_channel_features(
        img, torch.as_tensor(inp["quant_labels"][0], device=dev), int(inp["quant_segments"]))
    same(one["quant"]["area"][0], feats["area"].cpu().numpy(), "quantification areas")
    same(one["quant"]["channel_sums"][0], sums.cpu().numpy(), "quantification sums")
    co = torch.as_tensor(inp["enrich_coords"][0], device=dev)
    po = torch.as_tensor(inp["enrich_pos"][0], device=dev)
    dist_bin = distances.close_pairs(distances.pairwise_distances(co, co),
                                     float(inp["enrich_dist_lim"]))
    perms = se.draw_permutations(po.shape[1], int(inp["enrich_boots"]), 42).to(dev)
    same(one["enrichment"]["null_mean"][0],
         se._permutation_null(dist_bin, po, perms).mean(0).cpu().numpy(), "enrichment null")
    engine = watershed._ENGINE
    try:
        for name in ("levels", "minimax"):
            watershed._ENGINE = name
            lab, done = watershed._quantize_and_flood(
                *(torch.as_tensor(inp[k], device=dev)
                  for k in ("flood_elev", "flood_markers", "flood_mask")),
                int(inp["flood_levels"]), int(inp["flood_rounds"]))
            check(bool(done), f"multi-GPU {name} flood: not converged")
            same(one["flood"][f"{name}/labels"], lab.cpu().numpy(), f"{name} flood")
    finally:
        watershed._ENGINE = engine
    h, w_ = inp["fiber_imgs"].shape[1:]
    th, tw, n_tr, n_tc = classical._clahe_geometry(h, w_, h / 128)
    fib = _fiber_device_program(torch.as_tensor(inp["fiber_imgs"][0], device=dev), 0.1,
                                blur=2, th=th, tw=tw, n_tr=n_tr, n_tc=n_tc,
                                fiber_widths=tuple(int(v) for v in inp["fiber_widths"]),
                                sobel_blur=1)
    same(one["fiber"]["elevation_map"][0], fib["elevation_map"].cpu().numpy(), "fiber")
    blocks = sorted(((int(k.split("/")[1]), torch.as_tensor(v, device=dev))
                     for k, v in inp.items() if k.startswith("lda_block/")),
                    key=lambda b: b[0])
    k = LDA_N_TOPICS
    x = torch.as_tensor(np.array(inp["lda_X"]), device=dev)
    gamma, sstats = lda_model._e_step(x, torch.as_tensor(inp["lda_lam"], device=dev),
                                      torch.as_tensor(inp["lda_gamma"], device=dev),
                                      1.0 / k, 20)
    lda_err = max(float(np.max(np.abs(one["lda"]["lam"] - (1.0 / k + sstats).cpu().numpy())
                               / np.abs(one["lda"]["lam"]))),
                  float(np.max(np.abs(one["lda"]["gamma"] - lda_model._smooth(
                      gamma, blocks, 0.1).cpu().numpy()) / np.abs(one["lda"]["gamma"]))))
    check(lda_err <= LDA_SPLIT_RTOL, f"multi-GPU LDA: world size 1 differs from the "
                                     f"single-process E-step and smoothing by {lda_err}")
    return lda_err


def plain_umap_epoch(inp):
    """The dry run's UMAP epoch (lr 1, seed 0, 5 negatives an edge) by the
    plain path in float64 on the card: the same updates from the f32 start
    embedding, each negative round at ``draw_negatives``' points, summed by
    index_add_. Returns the (N, 2) float64 embedding."""
    import torch

    from ark_tpu_torch.ops import umap

    dev, rate = MULTI_GPU_DEVICE, 5
    emb = torch.as_tensor(inp["umap_emb"], device=dev).double()
    he, ta = (torch.as_tensor(inp[k], device=dev).long() for k in ("umap_heads", "umap_tails"))
    w = torch.as_tensor(inp["umap_weights"], device=dev).double()[:, None]
    negs = umap.draw_negatives(0, 0, rate, len(w), len(emb), dev)
    a, b = umap._A, umap._B
    diff = emb[he] - emb[ta]
    d2 = (diff * diff).sum(1)
    d2s = d2.clamp_min(1e-8)
    coef = torch.where(d2 > 0, -2.0 * a * b * d2s ** (b - 1.0) / (1.0 + a * d2s ** b), 0.0)
    attract = (coef[:, None] * diff).clamp(-4.0, 4.0) * w
    delta = torch.zeros_like(emb).index_add_(0, he, attract).index_add_(0, ta, -attract)
    for j in range(rate):
        ndiff = emb[he] - emb[negs[j]]
        nd2 = (ndiff * ndiff).sum(1)
        coef = 2.0 * b / ((0.001 + nd2) * (1.0 + a * nd2 ** b))
        delta.index_add_(0, he, (coef[:, None] * ndiff).clamp(-4.0, 4.0) * w)
    return (emb + delta).cpu().numpy()


def plain_mesmer(inp):
    """The plain single-process Mesmer step on phase (n)'s batch, from the
    dry run's seeded weights, on the card: ``model.train()``, one forward
    (each batch norm takes this batch's statistics through its own mean),
    the JAX dry run's loss as it writes it, ``torch.autograd.grad``. Run on
    the batch in its order and reversed; ``graft_entry.mesmer_result``'s
    form."""
    import copy

    import torch

    from ark_tpu_torch import graft_entry
    from ark_tpu_torch.segmentation import train

    def step(model, x, y_dist, y_pix):
        model.train()
        names, params = zip(*model.named_parameters())
        with train.training_precision(model):
            out = model(x)
            loss = torch.mean((out["whole_cell_inner_distance"][..., 0] - y_dist) ** 2) \
                - torch.mean(torch.sum(y_pix * torch.log(out["whole_cell_pixelwise"] + 1e-7),
                                       -1))
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        return graft_entry.mesmer_result(model, loss, dict(zip(names, grads)))

    model = graft_entry.mesmer_model(MULTI_GPU_MINI, MULTI_GPU_DEVICE)
    batch = [torch.as_tensor(inp[k], device=MULTI_GPU_DEVICE) for k in ("x", "y_dist", "y_pix")]
    return [step(copy.deepcopy(model), *batch),
            step(copy.deepcopy(model), *(torch.flip(v, [0]) for v in batch))]


def mesmer_differences(got, want):
    """(loss, gradients, batch-norm averages) of two ``mesmer_result``
    results, as phase (l2) measures them."""
    import torch

    check(np.array_equal(got["unreached"], want["unreached"]),
          "multi-GPU Mesmer: the unreached parameters differ")

    def grads(m):
        out = {k[len("grad/"):]: torch.as_tensor(v) for k, v in m.items()
               if k.startswith("grad/")}
        out.update({k: None for k in m["unreached"]})
        return out

    loss = abs(float(got["loss"]) - float(want["loss"])) / abs(float(want["loss"]))
    stats = max(float(np.max(np.abs(got[k] - v) / np.maximum(np.abs(v), 1.0)))
                for k, v in want.items() if k.startswith("stat/"))
    return loss, gradient_errors(grads(got), grads(want)), stats


def check_mesmer(got, want, what):
    loss, grad, stats = mesmer_differences(got, want)
    check(loss <= STEP_LOSS_RTOL, f"multi-GPU Mesmer {what}: loss {loss}")
    check(grad <= MESMER_GRAD_RTOL, f"multi-GPU Mesmer {what}: gradients {grad}")
    check(stats <= STEP_BN_TOL, f"multi-GPU Mesmer {what}: batch-norm averages {stats}")
    return loss, grad, stats


def compare_world_sizes(one, two, som_rows):
    """Two gloo ranks sharing the card against one NCCL rank: the per-FOV
    stages bitwise, the rest by the tolerances above (Mesmer's step in
    ``run_multi_gpu``). Returns the measured differences."""
    import torch

    for stage in BITWISE_STAGES:
        for k, v in one[stage].items():
            check(np.array_equal(two[stage][k], v),
                  f"multi-GPU {stage} {k}: 2 ranks differ from 1")
    errs = {}
    errs["som step"] = float(np.abs(two["som"]["w1"] - one["som"]["w1"]).max())
    check(errs["som step"] <= SOM_STEP_ATOL, f"multi-GPU SOM step: {errs['som step']}")

    def quantization_error(w):
        x = torch.as_tensor(som_rows)
        d2 = plain_d(torch.as_tensor(w), x).min(dim=1).values + (x * x).sum(1)
        return float(torch.sqrt(torch.clamp_min(d2, 0)).mean())

    qe1, qe2 = quantization_error(one["som"]["w_trained"]), quantization_error(
        two["som"]["w_trained"])
    errs["som qe"] = abs(qe2 - qe1) / qe1
    check(errs["som qe"] <= SOM_QE_RTOL, f"multi-GPU SOM schedule: quantization error "
                                         f"{qe2} at 2 ranks against {qe1} at 1")
    errs["lda"] = max(float(np.max(np.abs(two["lda"][k] - v) / np.abs(v)))
                      for k, v in one["lda"].items())
    check(errs["lda"] <= LDA_SPLIT_RTOL, f"multi-GPU LDA step: {errs['lda']}")
    emb1, emb2 = one["umap"]["emb"], two["umap"]["emb"]
    limit = UMAP_SPLIT_ULPS * float(np.spacing(np.abs(emb1).max()))
    errs["umap"] = float(np.abs(emb2 - emb1).max())
    check(errs["umap"] <= limit, f"multi-GPU UMAP epoch: {errs['umap']} > {limit}")
    return errs


def run_multi_gpu(inp):
    """Phase (n): graft_entry.dryrun_multigpu on `inp` at NCCL world size 1,
    then at gloo world size 2 with both ranks on the card; every rank must
    agree, 2 ranks must agree with 1 and 1 with the single-process port,
    and both UMAP epochs and Mesmer steps with their plain versions.
    Prints each run's seconds by stage and in collectives. Returns the
    kernels' launches in both runs, summed over the ranks."""
    import torch

    from ark_tpu_torch import graft_entry

    torch.cuda.empty_cache()
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "inputs.npz")
        t0 = time.perf_counter()
        np.savez(path, **inp)
        write_s = time.perf_counter() - t0
        for ws, backend in MULTI_GPU_RUNS:
            runs[ws] = graft_entry.dryrun_multigpu(
                ws, backend=backend, device=MULTI_GPU_DEVICE, mini=MULTI_GPU_MINI,
                inputs=path, timeout_s=MULTI_GPU_TIMEOUT_S)
    one, two = runs[1], runs[2]
    lda_ref_err = multi_gpu_references(inp, one)
    n_rows = len(inp["som_data"])
    sample = np.random.default_rng(62).choice(n_rows, min(n_rows, 20_000), replace=False)
    errs = compare_world_sizes(one, two, inp["som_data"][sample])
    emb64 = plain_umap_epoch(inp)
    umap_limit = UMAP_F64_ULPS * float(np.spacing(np.float32(np.abs(emb64).max())))
    umap_errs = {ws: float(np.abs(runs[ws]["umap"]["emb"] - emb64).max()) for ws in runs}
    for ws, err in umap_errs.items():
        check(err <= umap_limit, f"multi-GPU UMAP epoch: {ws} rank(s) differ from the "
                                 f"float64 plain epoch by {err} > {umap_limit}")
    plain, reversed_ = plain_mesmer(inp)
    noise = mesmer_differences(reversed_, plain)
    mesmer_errs = {"1 rank vs plain": check_mesmer(one["mesmer"], plain, "1 rank vs plain"),
                   "2 ranks vs plain": check_mesmer(two["mesmer"], plain, "2 ranks vs plain"),
                   "2 ranks vs 1": check_mesmer(two["mesmer"], one["mesmer"], "2 ranks vs 1")}
    n_pix = len(inp["pixel_imgs"])
    for ws, backend in MULTI_GPU_RUNS:
        res = runs[ws]
        stage_s = res["rank_seconds"][0]
        coll_s = res["rank_collective_seconds"][0]
        print(f"multi-GPU {backend} world size {ws} on {MULTI_GPU_DEVICE} [{CARD}]: "
              f"{res['wall_s']:.2f} s spawn to join; rank 0 seconds by stage "
              + ", ".join(f"{k} {v:.4f} (collectives {coll_s[k]:.4f})"
                          for k, v in stage_s.items())
              + f"; pixel cohort {n_pix / stage_s['pixel']:.2f} FOVs/s; Mesmer step "
              f"{stage_s['mesmer'] * 1e3:.1f} ms; collectives per rank "
              f"{[c['calls'] for c in res['collectives']]} calls, "
              f"{[round(c['bytes'] / 2 ** 20, 1) for c in res['collectives']]} MiB, "
              f"{[round(c['seconds'], 4) for c in res['collectives']]} s; launches per rank "
              f"{res['launches']}")
    print(f"multi-GPU checks [{CARD}]: every rank agrees; {', '.join(BITWISE_STAGES)} "
          f"bitwise at 2 ranks and 1; at 1 rank against the single-process port: the "
          f"pixel cohort (every FOV), the SOM schedule and step, FOV 0's quantification, "
          f"enrichment null and fiber and both floods bitwise, LDA within "
          f"{lda_ref_err:.3g}; 2 ranks against 1: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + "; UMAP epoch against the float64 plain epoch "
          + ", ".join(f"{ws} rank(s) {v:.3g}" for ws, v in umap_errs.items())
          + f" (limit {umap_limit:.3g}); Mesmer step (loss, gradients, averages) "
          + ", ".join(f"{k} ({', '.join(f'{v:.3g}' for v in e)})"
                      for k, e in mesmer_errs.items())
          + f", gradient limit {MESMER_GRAD_RTOL}; diagnostic: the plain step against "
          f"itself on the batch reversed (" + ", ".join(f"{v:.3g}" for v in noise) + ")"
          + f"; inputs written in {write_s:.2f} s "
          f"({sum(v.nbytes for v in inp.values()) / 2 ** 30:.2f} GiB)")
    totals = {k: sum(r[k] for res in runs.values() for r in res["launches"])
              for k in COUNTED_KERNELS}
    check(all(v > 0 for v in totals.values()),
          f"multi-GPU: a kernel of the sharded paths never launched: {totals}")
    return totals


def main() -> int:
    # cuBLAS reads its workspace setting when its handle is made; phase (l)
    # runs a step under torch.use_deterministic_algorithms, which needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    from ark_tpu_torch.ops import _kernels
    from ark_tpu_torch.segmentation import synthetic

    global CARD
    CARD = gpu_name_and_power()
    print(CARD)                            # the card's name and power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    missing = missing_host_packages()
    print(f"host packages importable: "
          f"{[p for p in HOST_PACKAGES if p not in missing]}, missing: {missing}")

    t0 = time.perf_counter()
    built = _kernels.build_all()
    print(f"kernel builds (nvcc sm_90a, {sorted(built)}, in parallel): "
          f"{time.perf_counter() - t0:.2f} s")
    sections = {}                    # the run's wall seconds by section
    clock = time.perf_counter()

    def section_done(name):
        nonlocal clock
        sections[name] = time.perf_counter() - clock
        clock = time.perf_counter()

    # the pixel stage (template 2)
    rng = np.random.default_rng(42)
    max_err, timing = check_kernel(rng)
    bmu_launches, pixel_assigned, pixel_out = run_pixel_stage()
    compare_pixel_cpu_cuda()

    section_done("pixel stage")

    # segmentation (template 1)
    claim_err, claim_timing = check_claim_kernel(np.random.default_rng(43))
    run_full_width_template()
    t0 = time.perf_counter()
    cohorts = {
        "8x512": (synthetic.synthetic_cells(
            np.random.default_rng(0), 8, hw=512, n_cells=(250, 300),
            crowding=0.35)[0], 8),
        "3x1024": (synthetic.synthetic_cells(
            np.random.default_rng(0), 3, hw=1024, n_cells=(900, 1000),
            crowding=0.35)[0], 3),
    }
    print(f"planted cohorts generated on the host: "
          f"{time.perf_counter() - t0:.1f} s")
    claim_launches, app, masks = run_device_postprocess(cohorts)
    compare_level_flood(app, cohorts["8x512"][0])
    compare_segmentation_cpu_cuda()

    section_done("segmentation")

    # quantification (template 1's cell table) and cell clustering (template 3)
    dense = dense_masks()
    seg_err, plan_err, seg_timing = check_segment_sum(dense)
    errs = check_segment_sum(masks["3x1024"], "segmented")[:2]
    seg_err, plan_err = max(seg_err, errs[0]), max(plan_err, errs[1])
    check_background_row(dense["whole_cell"])
    segmented = quant_cohort(masks["3x1024"])
    seg_launches, plan_launches, _ = run_cell_table(segmented, "segmented")
    cohort = quant_cohort(dense)
    _, _, tables = run_cell_table(cohort, "dense")
    with tempfile.TemporaryDirectory() as tmp_dir:
        labeled, count_cols = run_cell_clustering(cohort, tables, tmp_dir)

    section_done("cell table and cell clustering")

    # spatial analysis (the four spatial templates), then the main path's
    # cells from masks to enrichment z-scores
    check_distances(np.random.default_rng(49))
    spatial = spatial_cohort()
    check_enrichment_null(spatial)
    run_spatial_stage(spatial, "10 x 3000 planted", SPATIAL_TYPES[:2],
                      SPATIAL_TYPES[2:4], replay_fovs=SPATIAL_REPLAY_FOVS)
    main_table = main_path_spatial_table(tables, labeled)
    by_size = main_table["cell_meta_cluster"].value_counts().index.tolist()
    run_spatial_stage(main_table, "main path (dense cell tables, cell SOM types)",
                      by_size[:10], by_size[10:20])

    section_done("spatial analysis")

    # the classical image ops, fiber segmentation and ez_seg
    fiber_fov = fiber_image(np.random.default_rng(3))
    check_classical_ops(fiber_fov)
    fiber_launches, fiber_plan_launches, _ = run_fiber_stage(fiber_fov)
    run_ez_seg(fiber_fov)

    section_done("classical ops, fiber, ez_seg")

    # cluster masks and overlays, then the embeddings of the cell-clustering
    # cohort's cells (UMAP, PCA, t-SNE)
    run_cluster_masks(dense["whole_cell"], main_table, pixel_assigned)
    cell_counts = labeled[count_cols].to_numpy(np.float32)
    edge_err, edge_timing = check_edge_sums(cell_counts)
    umap_launches, umap_plan_launches = run_embeddings(
        cell_counts, labeled["cell_som_cluster"].to_numpy())
    compare_embedding_steps(cell_counts)
    section_done("cluster masks and embeddings")

    # spatial LDA on phase (c)'s cohort
    lda_got = run_spatial_lda(spatial)[1]
    section_done("spatial LDA")

    # Mesmer training and weight conversion
    claim_train_launches = run_training_phase()
    section_done("training and conversion")

    # the last single-card modules: single-image labeling, the bisection
    # quantiles, the prefetch loader and the profiler's trace
    (bmu_m_launches, claim_m_launches, seg_m_launches,
     plan_m_launches) = run_single_card_modules()[-1]
    section_done("single-card modules")

    # the templates' file entry points: templates 1 -> 3 -> spatial, fiber and
    # OME from TIFFs written by the port's codec
    files_launches = run_templates_from_files(cohorts["3x1024"][0], segmented, fiber_fov)
    section_done("templates from files")

    # the multi-process layer: dryrun_multigpu at full width, 1 NCCL rank and
    # 2 gloo ranks sharing the card
    multi = run_multi_gpu(multi_gpu_inputs(
        pixel_out, app, cohorts["8x512"][0], dense, cohort, spatial, lda_got, fiber_fov,
        cell_counts))
    section_done("multi-GPU")
    print("smoke run seconds by section (host clock, CPU replays included): "
          + ", ".join(f"{k} {v:.1f}" for k, v in sections.items()))

    claim_ms = claim_timing[CLAIM_TIMED[0]]
    seg_ms = seg_timing[4 + N_QUANT_CHANNELS]
    print(json.dumps({"kernels": [{
        "name": "bmu", "route": "cuda", "source": "ark_tpu_torch/csrc/bmu.cu",
        "replaces": "ark_tpu/ops/som.py:132", "launches": bmu_launches,
        "launches_by_path": {"pixel": bmu_launches,
                             "single_card_modules": bmu_m_launches,
                             "files": files_launches[0],
                             "multi_gpu": multi["bmu"]},
        "max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "watershed_claim", "route": "cuda",
        "source": "ark_tpu_torch/csrc/watershed_claim.cu",
        "replaces": "ark_tpu/ops/watershed.py:173", "launches": claim_launches,
        "launches_by_path": {"segmentation": claim_launches,
                             "training_held_out": claim_train_launches,
                             "single_card_modules": claim_m_launches,
                             "multi_gpu": multi["claim_round"]},
        "max_abs_err": claim_err, "ms": claim_ms["ms"],
        "plain_ms": claim_ms["plain_ms"], "bound_ms": claim_ms["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "segment_sum", "route": "cuda",
        "source": "ark_tpu_torch/csrc/segment_sum.cu",
        "replaces": "ark_tpu/ops/segment_reduce.py:44", "launches": seg_launches,
        "launches_by_path": {"cell_table": seg_launches, "fiber": fiber_launches,
                             "umap": umap_launches, "single_card_modules": seg_m_launches,
                             "files": files_launches[1],
                             "multi_gpu": multi["segment_sum"]},
        "max_abs_err": max(seg_err, edge_err), "ms": seg_ms["ms"],
        "plain_ms": seg_ms["plain_ms"], "bound_ms": seg_ms["bound_ms"],
        "bound_by": "bytes", "library_ms": seg_ms["library_ms"],
        "by_shape": {
            **{f"k{k}_with_background": {
                "ms": seg_timing[k]["bg_ms"], "batch_ms": seg_timing[k]["bg_batch_ms"],
                "library_ms": seg_timing[k]["library_ms"],
                "library_batch_ms": seg_timing[k]["library_batch_ms"],
                "bound_ms": seg_timing[k]["bg_bound_ms"],
                "bound_by": seg_timing[k]["bg_bound_by"]}
               for k in (4 + N_QUANT_CHANNELS, 3)},
            "umap_edges": {key: edge_timing[key] for key in
                           ("ms", "batch_ms", "plain_ms", "bound_ms", "bound_by",
                            "library_ms", "library_batch_ms")}}}, {
        "name": "segment_plan", "route": "cuda",
        "source": "ark_tpu_torch/csrc/segment_sum.cu",
        "replaces": "ark_tpu/ops/segment_reduce.py:44", "launches": plan_launches,
        "launches_by_path": {"cell_table": plan_launches, "fiber": fiber_plan_launches,
                             "umap": umap_plan_launches,
                             "single_card_modules": plan_m_launches,
                             "files": files_launches[2],
                             "multi_gpu": multi["segment_plan"]},
        "max_abs_err": plan_err, "ms": seg_ms["plan_ms"],
        "plain_ms": seg_ms["plain_plan_ms"], "bound_ms": seg_ms["plan_bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
