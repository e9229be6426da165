"""Smoke run of the PyTorch port (ark_tpu_torch) on one CUDA card.

Run from the repository root on a machine with an NVIDIA H100 and nvcc:

    python3 chip_smoke.py

It builds the BMU kernel from ark_tpu_torch/csrc/bmu.cu, holds it against
its plain torch version at the pixel stage's shapes, drives the Pixie pixel
clustering stage (template 2) at real size on the card, and compares a small
cohort's CPU and CUDA runs. It exits non-zero, without the final result
line, when there is no CUDA device or any phase fails. Its last line is one
JSON object naming the device; the line before it lists every kernel of the
path with its launches in the main-path run and its measured error and times.
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
HOST_PACKAGES = ("pandas", "pyarrow", "sklearn", "imageio", "PIL")
NEAR_TIE_RTOL = 1e-6
DIST_RTOL, DIST_ATOL = 1e-5, 1e-6
WEIGHTS_ATOL = 1e-4
# (N, C, K): the pixel stage's shape (four 1024^2 FOVs x 16 channels, a
# 10x10 SOM), then ragged shapes that cross every register path and the
# node chunking, and the wide path (C > 64)
KERNEL_SHAPES = [(4_194_304, 16, 100), (1, 3, 7), (1000, 7, 100),
                 (70_001, 40, 144), (5000, 16, 1), (3001, 80, 33)]


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
            timing["ms"] = time_ms(lambda: som.bmu(w, x, return_dist=False))
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
          f"{timing['plain_dist_ms']:.4f} ms")
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
    from ark_tpu.io import feather_utils as feather
    from ark_tpu.io.image_utils import save_image
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is False: this smoke "
                           "run needs a CUDA card")
    from ark_tpu_torch.ops import _kernels, som

    print(gpu_name_and_power())            # the card's name and power limit
    print(f"torch {torch.__version__} cuda {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    missing = missing_host_packages()
    print(f"host packages importable: "
          f"{[p for p in HOST_PACKAGES if p not in missing]}, missing: {missing}")

    t0 = time.perf_counter()
    _kernels.build_bmu()
    print(f"kernel build (nvcc sm_90a, csrc/bmu.cu): "
          f"{time.perf_counter() - t0:.2f} s")

    rng = np.random.default_rng(42)
    max_err, timing = check_kernel(rng)

    # phase 4: the pixel stage at real size through the port's entry points
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

    # phase 5: a small cohort through the same slice on the CPU and the card
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

    print(json.dumps({"kernels": [{
        "name": "bmu", "route": "cuda", "source": "ark_tpu_torch/csrc/bmu.cu",
        "replaces": "ark_tpu/ops/som.py:132", "launches": launches,
        "max_abs_err": max_err, "ms": timing["ms"],
        "plain_ms": timing["plain_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
