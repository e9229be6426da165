"""A/B timing of the port's segment-sum and BMU kernels against an earlier
design of the same kernels, on one CUDA card.

    python3 scripts/port_kernel_ab.py --old-csrc DIR [--out FILE]

DIR holds the earlier ``bmu.cu`` and ``segment_sum.cu`` (for example
``git archive <commit> ark_tpu_torch/csrc | tar -x -C DIR``). They are built
with the port's nvcc flags into a temporary directory and bound with ctypes;
their C interfaces are the ones of the port's first designs (the BMU's is
unchanged; the segment sum took an int64 CSR view, built per call by a
stable sort and a binary search). Every comparison runs in turns (old, new,
new, old), CUDA events, median of 10 calls each:

- BMU at the pixel stage's shapes (4 x 1024^2 and 1024^2 rows x 16, K = 100)
  and the cell SOM's (101,932 x 20, K = 100): indices and distances of the
  two designs must be bitwise equal;
- segment sum on FOV 0 of two 1024^2 cohorts (chip_smoke.dense_masks, ~1000
  cells, and the planted cohort's truth masks, ~190 cells) at K = 3 and
  K = 44: the plan alone (the kept bounding-box plan, and the build of the
  other candidate, an int32 CSR by a stable sort and a binary search), the
  sum given its plan, and both, against the old call and CUDA index_add_;
  then one FOV's four sums as the default cell table makes them (two
  compartments x two passes). All sums must be bitwise equal to index_add_
  on a CPU copy.

Kernel times are also taken as device time (torch.profiler, every kernel a
call launches), which leaves out the host's launch work that CUDA events
around a single call include.

It prints one line per measurement and writes them all as JSON to FILE.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM, published
F32_FLOP_PER_S = 67e12             # H100 SXM f32 outside the tensor cores, published


def build_old(src_dir, out_dir):
    from ark_tpu_torch.ops import _kernels

    libs = {}
    procs = {}
    for name in ("bmu", "segment_sum"):
        path = os.path.join(out_dir, f"libold_{name}.so")
        procs[name] = (path, subprocess.Popen(
            [_kernels._nvcc(), *_kernels.NVCC_FLAGS, "-o", path,
             os.path.join(src_dir, f"{name}.cu")], stderr=subprocess.PIPE, text=True))
    for name, (path, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on the old {name}.cu:\n{err}")
        libs[name] = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["bmu"].ark_bmu_launch.argtypes = [p, p, p, ctypes.c_longlong, i, i, p, p, i, p]
    libs["bmu"].ark_bmu_launch.restype = i
    libs["segment_sum"].ark_segment_sum_launch.argtypes = [p, p, p, i, i, p, p]
    libs["segment_sum"].ark_segment_sum_launch.restype = i
    return libs


def csr_plan(labels, num_segments):
    """The CSR candidate's plan, built on the device with int32 outputs: a
    stable order of the pixels by label and each segment's first position."""
    import torch

    flat = labels.reshape(-1)
    sorted_labels, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(sorted_labels, torch.arange(
        num_segments + 1, dtype=flat.dtype, device=flat.device))
    return order.to(torch.int32), offsets.to(torch.int32)


def sm_clock_under_load(fn, calls=2000):
    """The SM clock (MHz) and its maximum, as nvidia-smi reads them while the
    card works through `calls` queued calls of `fn`: what the f32 peak was
    during the BMU's timings."""
    import torch

    for _ in range(calls):
        fn()
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()[0]
    torch.cuda.synchronize()
    return out


def in_turns(old, new, reps=10):
    """(old ms, new ms): medians of old, new, new, old runs, each the median
    of `reps` CUDA-event timings."""
    from chip_smoke import time_ms

    t = [time_ms(old, reps), time_ms(new, reps), time_ms(new, reps), time_ms(old, reps)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def old_bmu(lib, w, x, with_dist):
    import torch

    n, c = x.shape
    idx = torch.empty(n, dtype=torch.int32, device=x.device)
    dist = torch.empty(n, dtype=torch.float32, device=x.device) if with_dist else None
    w2 = torch.sum(w * w, dim=1)
    err = lib.ark_bmu_launch(x.data_ptr(), w.data_ptr(), w2.data_ptr(), n, c, w.shape[0],
                             idx.data_ptr(), dist.data_ptr() if with_dist else None,
                             int(with_dist), torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return idx, dist


def old_segment_sum(lib, values, labels, num_segments):
    import torch

    flat = labels.reshape(-1)
    n, k = values.shape
    out = torch.empty((num_segments, k), dtype=torch.float32, device=values.device)
    sorted_labels, order = torch.sort(flat, stable=True)
    offsets = torch.searchsorted(sorted_labels, torch.arange(
        num_segments + 1, dtype=flat.dtype, device=flat.device))
    err = lib.ark_segment_sum_launch(values.data_ptr(), order.data_ptr(),
                                     offsets.data_ptr(), num_segments, k, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def bmu_ab(lib, rows):
    import torch

    from ark_tpu_torch.ops import som
    from chip_smoke import device_ms, pixel_rows

    rng = np.random.default_rng(42)
    for n, c, k in ((4_194_304, 16, 100), (1_048_576, 16, 100), (101_932, 20, 100)):
        x = torch.as_tensor(pixel_rows(rng, n, c), device="cuda")
        w = x[torch.as_tensor(rng.choice(n, size=k), device="cuda")].clone()
        for with_dist in (False, True):
            i_old, d_old = old_bmu(lib, w, x, with_dist)
            i_new, d_new = som.bmu(w, x, return_dist=with_dist)
            torch.cuda.synchronize()
            same = torch.equal(i_old, i_new) and (
                not with_dist or torch.equal(d_old.view(torch.int32), d_new.view(torch.int32)))
            old_ms, new_ms, turns = in_turns(lambda: old_bmu(lib, w, x, with_dist),
                                             lambda: som.bmu(w, x, return_dist=with_dist))
            dev_old = device_ms(lambda: old_bmu(lib, w, x, with_dist))
            dev_new = device_ms(lambda: som.bmu(w, x, return_dist=with_dist))
            flop = 2.0 * n * k * c
            nbytes = 4.0 * (n * c + k * c + n * (2 if with_dist else 1))
            bound = max(flop / F32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
            rows.append({"kernel": "bmu", "n": n, "c": c, "k": k, "with_dist": with_dist,
                         "old_ms": old_ms, "new_ms": new_ms, "turns_ms": turns,
                         "old_device_ms": dev_old, "new_device_ms": dev_new,
                         "bound_ms": bound, "share": bound / dev_new,
                         "bitwise_equal_to_old": bool(same)})
            print(f"bmu N={n} C={c} K={k} dist={with_dist}: old {old_ms:.4f} ms, new "
                  f"{new_ms:.4f} ms (turns {[round(t, 4) for t in turns]}); device "
                  f"time old {dev_old:.4f}, new {dev_new:.4f} ms; bound {bound:.4f} ms "
                  f"(f32 FMA), share of the new device time {bound / dev_new:.2f}; "
                  f"indices and distances bitwise equal to the old design: {same}")
            if not same:
                raise SystemExit("bmu: the new design differs from the old one")
        if n == 4_194_304:
            clock = sm_clock_under_load(lambda: som.bmu(w, x, return_dist=False))
            rows.append({"kernel": "bmu", "n": n, "sm_clock_under_load": clock})
            print(f"bmu N={n}: SM clock, max SM clock under load: {clock}")


def segment_inputs(labels, k, seed):
    import torch

    rng = np.random.default_rng(seed)
    h, w = labels.shape
    if k == 3:
        rr, cc = np.mgrid[:h, :w].astype(np.float32)
        vals = np.stack([np.ones(h * w, np.float32), rr.ravel(), cc.ravel()], 1)
    else:
        vals = rng.gamma(1.0, 3.0, (h * w, k)).astype(np.float32)
    return torch.as_tensor(vals, device="cuda")


def segment_ab(lib, cohorts, rows):
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr
    from chip_smoke import device_ms, time_ms

    for name, masks in cohorts.items():
        cells, nucs = (torch.as_tensor(m[0], device="cuda") for m in masks)
        n_seg = int(cells.max()) + 1
        fg = int((cells > 0).sum())
        for k in (3, 44):
            vals = segment_inputs(masks[0][0], k, k)
            want = sr.segment_sum_plain(vals.cpu(), cells.cpu(), n_seg)
            plan = sr.segment_plan(cells, n_seg)
            got = sr.segment_sum(vals, cells, n_seg, plan)
            torch.cuda.synchronize()
            if not torch.equal(got.cpu(), want):
                raise SystemExit(f"segment_sum {name} K={k}: not bitwise")
            if not torch.equal(old_segment_sum(lib, vals, cells, n_seg).cpu(), want):
                raise SystemExit(f"old segment_sum {name} K={k}: not bitwise")
            nbytes = 4.0 * (fg * k + cells.numel() + n_seg * k)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            walk = lambda: sr.segment_sum(vals, cells, n_seg, plan)     # noqa: E731
            row = {"kernel": "segment_sum", "cohort": name, "k": k, "segments": n_seg,
                   "foreground": fg, "bound_ms": bound,
                   "library_ms": time_ms(lambda: torch.zeros(
                       (n_seg, k), device="cuda").index_add_(0, cells.reshape(-1).long(),
                                                             vals)),
                   "box_plan_ms": time_ms(lambda: sr.segment_plan(cells, n_seg)),
                   "box_plan_device_ms": device_ms(lambda: sr.segment_plan(cells, n_seg)),
                   "csr_plan_ms": time_ms(lambda: csr_plan(cells, n_seg)),
                   "csr_plan_device_ms": device_ms(lambda: csr_plan(cells, n_seg)),
                   "walk_ms": time_ms(walk), "walk_device_ms": device_ms(walk),
                   "old_device_ms": device_ms(lambda: old_segment_sum(lib, vals, cells,
                                                                      n_seg))}
            old_ms, new_ms, turns = in_turns(
                lambda: old_segment_sum(lib, vals, cells, n_seg),
                lambda: sr.segment_sum(vals, cells, n_seg))
            row.update(old_ms=old_ms, new_ms=new_ms, turns_ms=turns,
                       share=bound / row["walk_device_ms"])
            rows.append(row)
            print(f"segment_sum {name} FOV 0 ({n_seg - 1} labels, {fg} foreground px) "
                  f"K={k}: old (CSR build + walk) {old_ms:.4f} ms, new (plan + walk) "
                  f"{new_ms:.4f} ms (turns {[round(t, 4) for t in turns]}); box plan "
                  f"{row['box_plan_ms']:.4f} ms (device {row['box_plan_device_ms']:.4f}); "
                  f"CSR build {row['csr_plan_ms']:.4f} ms (device "
                  f"{row['csr_plan_device_ms']:.4f}); walk {row['walk_ms']:.4f} ms "
                  f"(device {row['walk_device_ms']:.4f}; old design's whole call, device "
                  f"{row['old_device_ms']:.4f}); CUDA index_add_ {row['library_ms']:.4f} "
                  f"ms; bound {bound:.4f} ms (HBM), walk device share "
                  f"{row['share']:.2f}; bitwise equal")
        # one FOV's default cell table: per compartment the centroid pass
        # (K = 3) and the central-moment pass (K = 4 + 40 channels)
        inputs = [(lab, segment_inputs(lab.cpu().numpy(), 3, 3),
                   segment_inputs(lab.cpu().numpy(), 44, 44)) for lab in (cells, nucs)]

        def four_new():
            for lab, v3, v44 in inputs:
                s = masks_max[id(lab)] + 1
                plan = sr.segment_plan(lab, s)
                sr.segment_sum(v3, lab, s, plan)
                sr.segment_sum(v44, lab, s, plan)

        def four_old():
            for lab, v3, v44 in inputs:
                s = masks_max[id(lab)] + 1
                old_segment_sum(lib, v3, lab, s)
                old_segment_sum(lib, v44, lab, s)

        masks_max = {id(lab): int(lab.max()) for lab, _, _ in inputs}
        old_ms, new_ms, turns = in_turns(four_old, four_new)
        dev_old, dev_new = device_ms(four_old), device_ms(four_new)
        rows.append({"kernel": "segment_sum_fov", "cohort": name, "old_ms": old_ms,
                     "new_ms": new_ms, "turns_ms": turns, "old_device_ms": dev_old,
                     "new_device_ms": dev_new})
        print(f"segment sums of one {name} FOV's default cell table (2 compartments x "
              f"(plan, K=3, K=44)): old {old_ms:.4f} ms, new {new_ms:.4f} ms (turns "
              f"{[round(t, 4) for t in turns]}); device time old {dev_old:.4f}, new "
              f"{dev_new:.4f} ms")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-csrc", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    from ark_tpu_torch.ops import _kernels
    from ark_tpu_torch.segmentation import synthetic
    from chip_smoke import dense_masks, gpu_name_and_power

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        libs = build_old(args.old_csrc, tmp)
        bmu_ab(libs["bmu"], rows)
        dense = dense_masks()
        _, cells, nucs = synthetic.synthetic_cells(
            np.random.default_rng(0), 1, hw=1024, n_cells=(900, 1000), crowding=0.35)
        cohorts = {"dense": (dense["whole_cell"], dense["nuclear"]),
                   "planted": (cells.astype(np.int32), nucs.astype(np.int32))}
        segment_ab(libs["segment_sum"], cohorts, rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
