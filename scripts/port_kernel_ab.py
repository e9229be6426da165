"""A/B timing of the port's segment-sum kernel against an earlier design of
the same kernel on one CUDA card, and the card's dependent f32 add latency.

    python3 scripts/port_kernel_ab.py --old-csrc DIR [--out FILE]

DIR holds the earlier ``segment_sum.cu`` (for example ``git archive d83bac8
ark_tpu_torch/csrc | tar -x -C DIR``: the design in which one warp walked the
background row and every flat segment). It is built with the port's nvcc
flags into a temporary directory and bound with ctypes. Its C interface is
the plan's, unchanged, and a sum launch without the new ``flat`` argument:
``ark_segment_sum_launch(values, labels, w, boxes, num_segments, k,
background, out, stream)``; both designs take the same plan. Every
comparison runs in turns (old, new, new, old); "ev" is the median of 10
single calls between CUDA events, "batch" one pair of events around 20
queued calls, "dev" torch.profiler's device time per call:

- L, the latency of a dependent ``__fadd_rn`` in SM cycles: one warp adds
  2^20 times into one register (a tool kernel of this script, built beside
  the old design); cycles from ``clock64()``, milliseconds from events. And
  f, the SM clock nvidia-smi reads while the background row runs.
- the background row (segment 0 of FOV 0 of ``chip_smoke.dense_masks``,
  1024^2, 42% background) at K = 3 and K = 44: beside CUDA ``index_add_``,
  the byte bound and the chain bound (background pixels x L / f);
- UMAP's edge sums: the heads and the sorted tails (101,932 points x 15
  ids, hubs) x 2 columns, beside ``index_add_`` and the byte bound;
- the cell table's sums without the background row (K = 3 and K = 44
  given a plan, and one FOV's four sums with their plans) on the dense and
  the planted masks: the cell walk should not move.

Every sum of both designs is checked bitwise against ``index_add_`` on a
CPU copy (the old design's flat sums too). It prints one line per
measurement and writes them all as JSON to FILE.
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

CHAIN_ADDS = 1 << 20

FADD_CHAIN_CU = r"""
#include <cuda_runtime.h>

// One warp: out[lane] = x + step + step + ... (n dependent adds, n a
// multiple of 8); cycles[lane] the SM cycles of the chain.
__global__ void fadd_chain(float* out, long long* cycles, float step, int n) {
  float a = out[threadIdx.x];
  const long long t0 = clock64();
  for (int i = 0; i < n; i += 8) {
#pragma unroll
    for (int u = 0; u < 8; ++u) a = __fadd_rn(a, step);
  }
  const long long t1 = clock64();
  out[threadIdx.x] = a;
  cycles[threadIdx.x] = t1 - t0;
}

extern "C" int ark_fadd_chain_launch(float* out, long long* cycles, float step, int n,
                                     void* stream) {
  fadd_chain<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(out, cycles, step, n);
  return (int)cudaGetLastError();
}
"""


def build(out_dir, old_src):
    """(old segment-sum library, FADD chain library), built in parallel."""
    from ark_tpu_torch.ops import _kernels

    chain_src = os.path.join(out_dir, "fadd_chain.cu")
    with open(chain_src, "w") as f:
        f.write(FADD_CHAIN_CU)
    jobs = {}
    for name, src in (("old_segment_sum", old_src), ("fadd_chain", chain_src)):
        path = os.path.join(out_dir, f"lib{name}.so")
        jobs[name] = (path, subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                                              "-o", path, src],
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(path)
    p, i = ctypes.c_void_p, ctypes.c_int
    libs["old_segment_sum"].ark_segment_sum_launch.argtypes = [p, p, i, p, i, i, i, p, p]
    libs["old_segment_sum"].ark_segment_sum_launch.restype = i
    libs["fadd_chain"].ark_fadd_chain_launch.argtypes = [p, p, ctypes.c_float, i, p]
    libs["fadd_chain"].ark_fadd_chain_launch.restype = i
    return libs["old_segment_sum"], libs["fadd_chain"]


def fadd_latency(lib):
    """(cycles per dependent add, ms of the chain, the clock the two imply
    in MHz): the median of 10 timed chains after a warm-up."""
    import torch

    from chip_smoke import time_ms

    out = torch.zeros(32, device="cuda")
    cycles = torch.zeros(32, dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run():
        err = lib.ark_fadd_chain_launch(out.data_ptr(), cycles.data_ptr(), 1.0e-7,
                                        CHAIN_ADDS, stream)
        assert err == 0, err

    ms = time_ms(run)
    per_add = int(cycles.max()) / CHAIN_ADDS
    return per_add, ms, int(cycles.max()) / ms / 1e3


def in_turns(old, new, timer):
    """(old, new, the four readings): old, new, new, old."""
    t = [timer(old), timer(new), timer(new), timer(old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def old_sum(lib, values, labels, plan, background):
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr

    k = values.shape[1]
    out = torch.empty((plan.num_segments, k), dtype=torch.float32, device=values.device)
    err = lib.ark_segment_sum_launch(values.data_ptr(), plan.labels.data_ptr(),
                                     sr._row_width(labels), plan.boxes.data_ptr(),
                                     plan.num_segments, k,
                                     int(background), out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
    assert err == 0, err
    return out


def segment_inputs(labels, k, seed):
    """The cell table's values: [1, r, c] at K = 3 (the centroid pass),
    gamma intensities at other K; on the card."""
    import torch

    rng = np.random.default_rng(seed)
    h, w = labels.shape
    if k == 3:
        rr, cc = np.mgrid[:h, :w].astype(np.float32)
        vals = np.stack([np.ones(h * w, np.float32), rr.ravel(), cc.ravel()], 1)
    else:
        vals = rng.gamma(1.0, 3.0, (h * w, k)).astype(np.float32)
    return torch.as_tensor(vals, device="cuda")


def edge_ids(n=101_932, k=15, seed=58):
    """UMAP's two id lists at the cell cohort's size: each point id `k`
    times (the heads), and as many ids drawn with hubs (a tenth of the
    points take half the edges) and sorted (the tails)."""
    rng = np.random.default_rng(seed)
    heads = np.repeat(np.arange(n, dtype=np.int32), k)
    hubs = rng.choice(n, size=n // 10, replace=False)
    tails = np.where(rng.random(n * k) < 0.5, rng.choice(hubs, size=n * k),
                     rng.integers(0, n, n * k)).astype(np.int32)
    return {"umap_heads": heads, "umap_tails": np.sort(tails, kind="stable")}, n


def compare(lib, name, lab, vals, n_seg, background, latency, rows, clock_calls=0):
    """One shape in turns, both designs bitwise against index_add_ on a CPU
    copy; appends its row and prints it."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr
    from chip_smoke import batch_ms, bound_ms, device_ms, sm_clock_mhz, time_ms

    k = vals.shape[1]
    plan = sr.segment_plan(lab, n_seg)
    want = sr.segment_sum_plain(vals.cpu(), lab.cpu(), n_seg, background)
    new = lambda: sr.segment_sum(vals, lab, n_seg, plan, background)     # noqa: E731
    old = lambda: old_sum(lib, vals, lab, plan, background)                   # noqa: E731
    for what, fn in (("new", new), ("old", old)):
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got.cpu(), want):
            raise SystemExit(f"{name}: the {what} design is not bitwise")
    flat = lab.reshape(-1).long()
    library = lambda: torch.zeros((n_seg, k), device="cuda").index_add_(  # noqa: E731
        0, flat, vals)
    old_ev, new_ev, turns_ev = in_turns(old, new, time_ms)
    old_b, new_b, turns_b = in_turns(old, new, batch_ms)
    fg = int((flat > 0).sum()) if not background else lab.numel()
    nbytes = 4.0 * (fg * k + lab.numel() + n_seg * k)
    row = {"shape": name, "k": k, "segments": n_seg, "entries": lab.numel(),
           "background": background, "old_ms": old_ev, "new_ms": new_ev,
           "turns_ms": turns_ev, "old_batch_ms": old_b, "new_batch_ms": new_b,
           "turns_batch_ms": turns_b, "old_device_ms": device_ms(old),
           "new_device_ms": device_ms(new), "library_ms": time_ms(library),
           "library_batch_ms": batch_ms(library), "byte_bound_ms": bound_ms(nbytes)[0]}
    if background and lab.ndim == 2:
        chain = int((flat == 0).sum())
        clock = sm_clock_mhz(new, clock_calls)
        row.update(chain=chain, sm_mhz=clock,
                   chain_bound_ms=chain * latency / (clock * 1e3))
    else:
        chain = int(torch.bincount(flat[(flat >= 0) & (flat < n_seg)],
                                   minlength=n_seg).max())
        row.update(chain=chain)
    rows.append(row)
    extra = (f", chain bound {row['chain_bound_ms']:.4f} ms ({chain} adds x {latency:.3f} "
             f"cycles at {row['sm_mhz']:.0f} MHz)" if "chain_bound_ms" in row else
             f", longest chain {chain}")
    print(f"segment_sum {name} ({lab.numel()} entries, {n_seg} segments, K={k}, "
          f"background={background}): old ev {old_ev:.4f} ms, batch {old_b:.4f}, dev "
          f"{row['old_device_ms']}; new ev {new_ev:.4f} ms, batch {new_b:.4f}, dev "
          f"{row['new_device_ms']} (turns ev {[round(t, 4) for t in turns_ev]}, batch "
          f"{[round(t, 4) for t in turns_b]}); CUDA index_add_ ev "
          f"{row['library_ms']:.4f}, batch {row['library_batch_ms']:.4f}; byte bound "
          f"{row['byte_bound_ms']:.4f} ms{extra}; both bitwise equal to index_add_ on "
          f"the CPU")


def four_sums(lib, name, masks, rows):
    """One FOV's four sums as the default cell table makes them (two
    compartments x (plan, K = 3, K = 44), without the background row)."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr
    from chip_smoke import device_ms, time_ms

    inputs = []
    for m in masks:
        lab = torch.as_tensor(m, device="cuda")
        inputs.append((lab, int(lab.max()) + 1, segment_inputs(m, 3, 3),
                       segment_inputs(m, 44, 44)))

    def four(new):
        for lab, s, v3, v44 in inputs:
            plan = sr.segment_plan(lab, s)
            for v in (v3, v44):
                if new:
                    sr.segment_sum(v, lab, s, plan, background=False)
                else:
                    old_sum(lib, v, lab, plan, False)

    old_ms, new_ms, turns = in_turns(lambda: four(False), lambda: four(True), time_ms)
    dev_old, dev_new = device_ms(lambda: four(False)), device_ms(lambda: four(True))
    rows.append({"shape": f"{name}_fov_four_sums", "old_ms": old_ms, "new_ms": new_ms,
                 "turns_ms": turns, "old_device_ms": dev_old, "new_device_ms": dev_new})
    print(f"segment sums of one {name} FOV's default cell table (2 compartments x "
          f"(plan, K=3, K=44)): old ev {old_ms:.4f} ms, new ev {new_ms:.4f} ms (turns "
          f"{[round(t, 4) for t in turns]}); dev old {dev_old}, new {dev_new}")


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
        lib, chain_lib = build(tmp, os.path.join(args.old_csrc, "segment_sum.cu"))
        latency, chain_ms, chain_mhz = fadd_latency(chain_lib)
        rows.append({"shape": "fadd_chain", "adds": CHAIN_ADDS, "cycles_per_add": latency,
                     "ms": chain_ms, "implied_mhz": chain_mhz})
        print(f"dependent __fadd_rn: {latency:.4f} SM cycles an add (one warp, "
              f"{CHAIN_ADDS} adds, clock64), {chain_ms:.4f} ms by events: "
              f"{chain_mhz:.0f} MHz")
        dense = dense_masks()
        cells = torch.as_tensor(dense["whole_cell"][0], device="cuda")
        n_seg = int(cells.max()) + 1
        for k in (3, 44):
            compare(lib, f"dense_background_k{k}", cells,
                    segment_inputs(dense["whole_cell"][0], k, k), n_seg, True, latency,
                    rows, clock_calls=300)
        ids, n_points = edge_ids()
        rng = np.random.default_rng(59)
        for name, lab in ids.items():
            vals = torch.as_tensor(rng.normal(size=(lab.size, 2)).astype(np.float32),
                                   device="cuda")
            compare(lib, name, torch.as_tensor(lab, device="cuda"), vals, n_points, True,
                    latency, rows)
        _, pcells, pnucs = synthetic.synthetic_cells(
            np.random.default_rng(0), 1, hw=1024, n_cells=(900, 1000), crowding=0.35)
        cohorts = {"dense": (dense["whole_cell"][0], dense["nuclear"][0]),
                   "planted": (pcells[0].astype(np.int32), pnucs[0].astype(np.int32))}
        for name, masks in cohorts.items():
            lab = torch.as_tensor(masks[0], device="cuda")
            for k in (3, 44):
                compare(lib, f"{name}_cells_k{k}", lab, segment_inputs(masks[0], k, k),
                        int(lab.max()) + 1, False, latency, rows)
            four_sums(lib, name, masks, rows)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
