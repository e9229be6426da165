"""Smoke run of the PyTorch port (ark_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

It builds the port's CUDA kernels (ark_tpu_torch/csrc/*.cu, one nvcc each,
started together) and drives three paths on the card:

- the Pixie pixel clustering stage (template 2): the BMU kernel against its
  plain torch version at the stage's shapes, the stage at 4 x 1024^2 x 16,
  and a small cohort's CPU and CUDA runs;
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
  segmented masks, and one FOV's four sums as the cell table makes them;
  the cell tables of the planted
  cohort's segmented masks and of the dense masks with 40 seeded channels
  through create_marker_count_matrices (nuclear counts, split nuclei, every
  default regionprop, and fast_extraction), held against the CPU port; and
  the cell SOM (normalization, 10x10 training, BMU assignment) and the
  weighted channel product on a ~100k-cell, 102-FOV cell cohort.

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


def bound_ms(nbytes=0.0, flop=0.0):
    """(ms, "bytes" or "operations"): the larger of the bytes over the HBM
    rate and the f32 operations over the f32 peak."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flop / F32_FLOP_PER_S * 1e3
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes, "bytes")


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
    BMU assignment. Returns the weights, the 1-indexed labels and the BMU
    input rows per FOV, and the per-phase seconds."""
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
                         for c in range(len(CHANNELS))])
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
    kept, subsets, fov_q = [], [], []
    for norm, rowsums, anynz in parts:
        keep = np.flatnonzero(pixie_fused._valid_mask_device(
            rowsums, anynz, thresh).cpu().numpy())
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
    norm_post = np.mean(np.stack(fov_q).astype(np.float64), axis=0)
    del parts
    mark("subset_quantiles_s", t0)

    t0 = time.perf_counter()
    train = (np.concatenate(subsets).astype(np.float64) / norm_post
             ).astype(np.float32)
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
            "seconds": seconds, "thresh": thresh, "n_train": train.shape[0]}


def check_slice_outputs(out, n_nodes):
    w = out["weights"]
    check(w.shape == (n_nodes, len(CHANNELS)) and np.isfinite(w).all(),
          f"SOM weights: shape {w.shape}, all finite {np.isfinite(w).all()}")
    for lab in out["labels"]:
        check(lab.size > 0 and lab.min() >= 1 and lab.max() <= n_nodes,
              f"labels outside 1..{n_nodes}")


def run_full_driver(raws, device):
    """All host packages present: run_pixel_clustering on a TIFF cohort in a
    temp dir and check its artifacts."""
    from ark_tpu_torch.io import feather_utils as feather
    from ark_tpu_torch.io.image_utils import save_image
    from ark_tpu_torch.phenotyping import pixie_fused

    fovs = [f"fov{i}" for i in range(len(raws))]
    with tempfile.TemporaryDirectory() as base:
        tiff_dir = os.path.join(base, "image_data")
        for fov, raw in zip(fovs, raws):
            for ci, chan in enumerate(CHANNELS):
                save_image(os.path.join(tiff_dir, fov, f"{chan}.tiff"),
                           raw[..., ci])
        timings = {}
        pixie_fused.run_pixel_clustering(
            fovs, CHANNELS, base, tiff_dir, img_sub_folder=None, max_k=20,
            blur_factor=2, subset_proportion=0.1, seed=42, timings=timings,
            device=device)
        artifacts = ["pixel_output_dir/channel_norm_pre_rownorm.feather",
                     "pixel_output_dir/pixel_thresh.feather",
                     "channel_norm_post_rownorm.feather",
                     "pixel_som_weights.feather",
                     "pixel_mat_data/channel_norm_post_rownorm_perfov.csv",
                     "pixel_channel_avg_som_cluster.csv",
                     "pixel_channel_avg_meta_cluster.csv"]
        artifacts += [f"pixel_mat_subsetted/{f}.feather" for f in fovs]
        artifacts += [f"pixel_mat_data/{f}.feather" for f in fovs]
        for rel in artifacts:
            check(os.path.exists(os.path.join(base, rel)), f"missing {rel}")
        for fov in fovs:
            t = feather.read_dataframe(
                os.path.join(base, "pixel_mat_data", fov + ".feather"))
            check(t["pixel_som_cluster"].between(1, 100).all(),
                  f"{fov}: SOM labels outside 1..100")
            check(t["pixel_meta_cluster"].between(1, 20).all(),
                  f"{fov}: meta labels outside 1..20")
        w = feather.read_dataframe(
            os.path.join(base, "pixel_som_weights.feather"))
        check(np.isfinite(w.values).all(), "SOM weights not finite")
    return timings


def run_pixel_stage(missing):
    """Phase 4: the pixel stage at real size through the port's entry
    points; returns the BMU kernel's launches in that run."""
    import torch

    from ark_tpu_torch.ops import som

    raws = make_cohort(np.random.default_rng(7), n_fovs=4, size=1024)
    som.bmu.launches = 0
    t0 = time.perf_counter()
    if missing:
        print(f"pixel stage: {missing} missing, so run_pixel_clustering's "
              f"device phases run on the in-memory cohort (consensus and file "
              f"writes are host code, covered by the CPU tests)")
        out = drive_slice(raws, "cuda")
        torch.cuda.synchronize()
        launches = som.bmu.launches
        check_slice_outputs(out, 100)
        seconds = out["seconds"]
        print(f"pixel stage: threshold {out['thresh']:.6g}, "
              f"{out['n_train']} training rows, "
              f"{sum(lab.size for lab in out['labels'])} pixels assigned")
    else:
        seconds = run_full_driver(raws, "cuda")
        torch.cuda.synchronize()
        launches = som.bmu.launches
    total = time.perf_counter() - t0
    check(launches > 0, "the pixel stage never launched the BMU kernel")
    print(f"pixel stage 4 x 1024^2 x 16ch on cuda: {total:.3f} s; per phase "
          + ", ".join(f"{k} {v:.4f}" for k, v in seconds.items()))
    print(f"pixel stage bmu kernel launches: {launches}")
    return launches


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
    segment's bounding box) against segment_boxes_plain, and the segment-sum
    kernel against index_add_ on a CPU copy, both bitwise, and against a
    second CUDA run of itself with a fresh plan, at K = 3 and K = 44 on the
    whole-cell masks; then, on FOV 0, per-call times of the plan, of the sum
    given its plan, of both, of the plain version and of CUDA index_add_,
    each beside its bound; and one FOV's segment sums as the default cell
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
            want = sr.segment_sum_plain(val_cpu, lab_cpu, n_seg)
            torch.cuda.synchronize()
            err = float((got.cpu() - want).abs().max())
            max_err = max(max_err, err)
            check(torch.equal(got.cpu(), want),
                  f"segment_sum K={k} FOV {i}: {int((got.cpu() != want).sum())} "
                  f"sums differ from index_add_ on the CPU (max {err})")
            check(torch.equal(got, again), f"segment_sum K={k} FOV {i}: two "
                  f"CUDA runs differ")
            if i == 0:
                fg = int((lab > 0).sum())
                flat = lab_gpu.reshape(-1).long()
                box = sr.segment_boxes_plain(lab_gpu, n_seg).to(torch.int64)
                box = box[box[:, 1] >= box[:, 0]]          # present labels only
                box_px = ((box[:, 1] - box[:, 0] + 1) * (box[:, 3] - box[:, 2] + 1)).sum()
                t = {"plan_ms": time_ms(lambda: sr.segment_plan(lab_gpu, n_seg)),
                     "plain_plan_ms": time_ms(lambda: sr.segment_boxes_plain(lab_gpu,
                                                                             n_seg)),
                     "plan_device_ms": device_ms(lambda: sr.segment_plan(lab_gpu, n_seg)),
                     "ms": time_ms(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg, plan)),
                     "device_ms": device_ms(lambda: sr.segment_sum(val_gpu, lab_gpu, n_seg,
                                                                   plan)),
                     "plan_and_sum_ms": time_ms(lambda: sr.segment_sum(val_gpu, lab_gpu,
                                                                       n_seg)),
                     "plain_ms": time_ms(lambda: sr.segment_sum_plain(val_gpu, lab_gpu,
                                                                      n_seg)),
                     "library_ms": time_ms(lambda: torch.zeros(
                         (n_seg, k), device=DEVICE).index_add_(0, flat, val_gpu)),
                     # the foreground's values and every label read once, the
                     # sums written once; the plan: labels in, boxes out
                     "bound_ms": bound_ms(nbytes=4.0 * (fg * k + lab.size + n_seg * k))[0],
                     "plan_bound_ms": bound_ms(nbytes=4.0 * lab.size + 16.0 * n_seg)[0],
                     # the walk's label reads per foreground pixel (its cost model)
                     "box_over_cell": float(box_px) / max(fg, 1)}
                timing[k] = t
        t = timing[k]
        print(f"segment_sum K={k} on {len(masks)} x {masks[0].shape} {name} masks "
              f"({[int(m.max()) for m in masks]} max labels): bitwise equal to "
              f"index_add_ on the CPU and across two CUDA runs, boxes equal to "
              f"the plain version's; FOV 0 per call (CUDA events, median of 10): "
              f"plan {t['plan_ms']:.4f} ms (device {fmt_ms(t['plan_device_ms'])}; bound "
              f"{t['plan_bound_ms']:.4f}, share {share(t['plan_bound_ms'], t['plan_ms']):.2f},"
              f" {share(t['plan_bound_ms'], t['plan_device_ms']):.2f} of the device time; "
              f"plain {t['plain_plan_ms']:.4f}), sum given its plan {t['ms']:.4f} ms "
              f"(device {fmt_ms(t['device_ms'])}; bound {t['bound_ms']:.4f}, share "
              f"{share(t['bound_ms'], t['ms']):.2f}, "
              f"{share(t['bound_ms'], t['device_ms']):.2f} of the device time), both "
              f"{t['plan_and_sum_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, CUDA "
              f"index_add_ {t['library_ms']:.4f} ms; box area / cell area "
              f"{t['box_over_cell']:.3f}")
    values = {}
    for comp in ("whole_cell", "nuclear"):
        lab = masks_by_comp[comp][0]
        values[comp] = (torch.as_tensor(lab, device=DEVICE), int(lab.max()) + 1,
                        *(segment_inputs(rng, lab, k)[1].to(DEVICE)
                          for k in (3, 4 + N_QUANT_CHANNELS)))

    def fov_sums():
        for lab, n_seg, v3, v44 in values.values():
            plan = sr.segment_plan(lab, n_seg)
            sr.segment_sum(v3, lab, n_seg, plan)
            sr.segment_sum(v44, lab, n_seg, plan)

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


def tables_agree(got, want, what):
    """The CPU tests' rule: same schema; sums bitwise, DERIVED_COLUMNS within
    DERIVED_TOL. Returns the largest difference in a derived column."""
    check(list(got.columns) == list(want.columns) and
          list(got.dtypes) == list(want.dtypes), f"{what}: schemas differ")
    worst = 0.0
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        base = col[:-len("_nuclear")] if col.endswith("_nuclear") else col
        if base in DERIVED_COLUMNS:
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
    Returns the cells with their cell_som_cluster."""
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
    return labeled


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


def device_profile(fn):
    """(device seconds, the three entries with the most device time) of one
    call of `fn`, from torch.profiler (kernels and copies)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:3]
    return (sum(e.self_device_time_total for e in events) / 1e6,
            [(e.key[:60], e.self_device_time_total / 1e6) for e in top])


def run_spatial_stage(table, name, target, reference):
    """Spatial phases (c) and (d): the templates' steps on the card, then on
    the CPU port, held to each other; prints seconds per step,
    permutations per second, the share of calc_dist_matrix's wall spent
    writing netCDF, and the device's busy share (a second card run under
    the profiler). Returns the card's seconds per step."""
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
        os.makedirs(os.path.join(base, "cpu"))
        t0 = time.perf_counter()
        want, _, _ = spatial_steps(table, os.path.join(base, "cpu"), "cpu", target,
                                   reference)
        cpu_s = time.perf_counter() - t0
        spatial_outputs_agree(got, want, fovs, name)
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
          f"the CPU port's (CPU run {cpu_s:.3f} s); kernel launches (bmu, claim, "
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


def main() -> int:
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

    # the pixel stage (template 2)
    rng = np.random.default_rng(42)
    max_err, timing = check_kernel(rng)
    bmu_launches = run_pixel_stage(missing)
    compare_pixel_cpu_cuda()

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

    # quantification (template 1's cell table) and cell clustering (template 3)
    dense = dense_masks()
    seg_err, plan_err, seg_timing = check_segment_sum(dense)
    errs = check_segment_sum(masks["3x1024"], "segmented")[:2]
    seg_err, plan_err = max(seg_err, errs[0]), max(plan_err, errs[1])
    seg_launches, plan_launches, _ = run_cell_table(quant_cohort(masks["3x1024"]),
                                                    "segmented")
    cohort = quant_cohort(dense)
    _, _, tables = run_cell_table(cohort, "dense")
    with tempfile.TemporaryDirectory() as tmp_dir:
        labeled = run_cell_clustering(cohort, tables, tmp_dir)

    # spatial analysis (the four spatial templates), then the main path's
    # cells from masks to enrichment z-scores
    check_distances(np.random.default_rng(49))
    spatial = spatial_cohort()
    check_enrichment_null(spatial)
    run_spatial_stage(spatial, "10 x 3000 planted", SPATIAL_TYPES[:2],
                      SPATIAL_TYPES[2:4])
    main_table = main_path_spatial_table(tables, labeled)
    by_size = main_table["cell_meta_cluster"].value_counts().index.tolist()
    run_spatial_stage(main_table, "main path (dense cell tables, cell SOM types)",
                      by_size[:10], by_size[10:20])

    claim_ms = claim_timing[CLAIM_TIMED[0]]
    seg_ms = seg_timing[4 + N_QUANT_CHANNELS]
    print(json.dumps({"kernels": [{
        "name": "bmu", "route": "cuda", "source": "ark_tpu_torch/csrc/bmu.cu",
        "replaces": "ark_tpu/ops/som.py:132", "launches": bmu_launches,
        "max_abs_err": max_err, "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}, {
        "name": "watershed_claim", "route": "cuda",
        "source": "ark_tpu_torch/csrc/watershed_claim.cu",
        "replaces": "ark_tpu/ops/watershed.py:173", "launches": claim_launches,
        "max_abs_err": claim_err, "ms": claim_ms["ms"],
        "plain_ms": claim_ms["plain_ms"], "bound_ms": claim_ms["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        "name": "segment_sum", "route": "cuda",
        "source": "ark_tpu_torch/csrc/segment_sum.cu",
        "replaces": "ark_tpu/ops/segment_reduce.py:44", "launches": seg_launches,
        "max_abs_err": seg_err, "ms": seg_ms["ms"], "plain_ms": seg_ms["plain_ms"],
        "bound_ms": seg_ms["bound_ms"], "bound_by": "bytes",
        "library_ms": seg_ms["library_ms"]}, {
        "name": "segment_plan", "route": "cuda",
        "source": "ark_tpu_torch/csrc/segment_sum.cu",
        "replaces": "ark_tpu/ops/segment_reduce.py:44", "launches": plan_launches,
        "max_abs_err": plan_err, "ms": seg_ms["plan_ms"],
        "plain_ms": seg_ms["plain_plan_ms"], "bound_ms": seg_ms["plan_bound_ms"],
        "bound_by": "bytes", "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
