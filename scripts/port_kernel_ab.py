"""The one timer of the port's kernels: each timed on one CUDA card beside
its plain version, ``index_add_`` where it has one, and its bound, with the
card constants the bound rests on. ``chip_smoke.py`` checks the kernels and
times none.

    python3 scripts/port_kernel_ab.py --kernel bmu [--out FILE]
    python3 scripts/port_kernel_ab.py --kernel claim [--out FILE]
    python3 scripts/port_kernel_ab.py --kernel relabel [--out FILE]
    python3 scripts/port_kernel_ab.py --kernel relax [--out FILE]
    python3 scripts/port_kernel_ab.py [--kernel segment_sum] [--out FILE]

To time a kernel against an earlier design of it, run the same mode in a
checkout of the earlier commit on the same card, in the same call.

Every comparison runs in turns (plain, kernel, kernel, plain); "ev" is the
median of single calls between CUDA events, "batch" one pair of events
around queued calls, "dev" torch.profiler's device time per call. Every
result of the kernel is checked against the plain version first.

``--kernel bmu``: ``som.bmu`` at the pixel stage's shape (4,194,304 rows x
16 channels, K = 100: ``chip_smoke.KERNEL_SHAPES[0]``), without and with
distances, beside ``som.bmu_plain`` (indices equal but at near-ties), with
the f32-FMA bound of ``bmu_bound_ms``.

``--kernel relabel``: the minimax flood's re-labeling as one launch of the
kernel in ``csrc/minimax_relabel.cu`` against the loop of ``_refine_round``
blocks that ran before it (``watershed._relabel_plain`` on the same CUDA
tensors: ~20 launches a round and a synchronising comparison every 16
rounds). Its operands are the smoke's phase 9b's (``chip_smoke``): the
floods of phase 8's planted 3 x 1024^2 cohort (``cohort_relief``, the mini
checkpoint's relief of each compartment, ~10-25 rounds a flood) and a
4 x 1024^2 cell-like relief whose labels cross a plateau in as many rounds
as the benchmark's segmentation floods run (``cell_relief(crossing=True)``,
over 1,000 rounds), each flood captured after its relaxation
(``relabel_operands``). Each is timed by events around a call and by the
profiler's device time, with the bound of the kernel's own per-round
traffic (``relabel_bound_ms``); and the whole flood (``_flood_minimax``,
host clock with a synchronise) with each, beside the level engine's flood
(``_flood``, 32 rounds a level) on the same relief. Both are checked
bitwise against the plain loop: labels, flag and blocks.

``--kernel relax``: the minimax flood's relaxation as one launch of the
kernel in ``csrc/minimax_relax.cu`` against the loop of sweep-and-round
blocks that ran before it (``watershed._relax_plain`` on the same CUDA
tensors: ~1,700 dispatched ops a block and a synchronising comparison), at
the segmentation cell's shape: 4 x 1024^2 cell-like reliefs
(``chip_smoke.cell_relief``, plain and crossing) and phase 8's planted
3 x 1024^2 cohort's floods (``cohort_relief``), each captured as
``_flood_minimax`` hands them over (``relax_operands``). Each is timed by
events around a call and by the profiler's device time, beside the bound
of ``relax_bound_ms`` and the kernel's share of it; and the whole flood
(host clock with a synchronise) with each. Both are checked bitwise
against the plain loop: keys, flag and blocks.

``--kernel claim``: on phase 8's planted cohorts (8 x 512^2 and 3 x 1024^2,
the mini checkpoint's relief of each compartment) phase A from level 0 (32
rounds a level) as one launch of the level-scan kernel against the plain
scan (``watershed._claim_levels``), with ``scan_bound_ms``; the whole level
flood (``watershed._flood``) with each; and one round of the one-round
kernel against its plain round, with the bytes of ``claim_bytes``. It
measures the two constants of ``scan_bound_ms``: the read rate of an
L2-resident working set (16-byte ``ld.global.cg`` loads over 16 MiB and
over each cohort's state) and one round's grid barrier at the level-scan kernel's grid (block
atomics into a ring of counters, the barrier, the read after it), with
tool kernels of this script built beside today's source.

``--kernel segment_sum`` (the default), each sum beside the plain version
(``segment_sum_plain``) on the card:

- L, the latency of a dependent ``__fadd_rn`` in SM cycles: one warp adds
  2^20 times into one register (a tool kernel of this script); cycles from
  ``clock64()``, milliseconds from events. And f, the SM clock nvidia-smi
  reads while the background row runs.
- the background row (segment 0 of FOV 0 of ``chip_smoke.dense_masks``,
  1024^2, 42% background) at K = 3 and K = 44: beside CUDA ``index_add_``,
  the byte bound and the chain bound (background pixels x L / f);
- UMAP's edge sums: the heads and the sorted tails (101,932 points x 15
  ids, hubs) x 2 columns, beside ``index_add_`` and the byte bound;
- the cell table's sums without the background row (K = 3 and K = 44
  given a plan, and one FOV's four sums with their plans, with their
  bound) and the plan kernel against ``segment_boxes_plain`` with its byte
  bound, on the dense and the planted masks.

Every sum of the kernel is checked bitwise against ``index_add_`` on a CPU
copy, every plan against ``segment_boxes_plain``. It prints one line per
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

from chip_smoke import (CKPT, KERNEL_SHAPES, RELABEL_CELL_LIKE, bound_ms,  # noqa: E402
                        cell_relief, claim_inputs, cohort_relief, dense_masks, device_ms,
                        gpu_name_and_power, near_ties, pixel_rows, plain_d,
                        planted_cohorts, relabel_operands, relax_operands, same_scan,
                        time_ms, wall_ms)


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


def bmu_bound_ms(n, c, k):
    """(ms, the binding term) of one BMU call over `n` rows of `c` columns
    and `k` nodes: the rows, the nodes and the indices once at HBM speed,
    and 2 n k c f32 operations (one FMA a product)."""
    return bound_ms(nbytes=4.0 * (n * c + k * c + n), flop=2.0 * n * k * c)


def claim_bytes(n, labelled):
    """Bytes a claim round over `n` pixels must move when `labelled` of
    them carry a label > 0: every label read and written (8 B a pixel), and
    the level of a labelled pixel only (4 B), since no other pixel can be a
    source."""
    return 8.0 * n + 4.0 * labelled


def scan_bound_ms(n, labelled, rounds):
    """(ms, the binding term) of a level scan of `rounds` claim rounds over
    `n` pixels, `labelled` of them labelled when it ends (labels only
    spread, so no round has more): the state read and written once at HBM
    speed, every round's ``claim_bytes`` at the L2 rate, and a grid barrier
    a round."""
    nbytes = claim_bytes(n, labelled)
    return bound_ms(nbytes=nbytes, l2_bytes=nbytes * rounds, barriers=rounds)


def relax_chunks(claimable):
    """Chunks of 4 consecutive pixels of the flat stack (a round's unit of
    work in the relaxation kernel) that hold a claimable pixel. Only those
    are written in a round."""
    import torch

    bits = claimable.reshape(-1)
    pad = -bits.numel() % 4
    bits = torch.cat([bits, bits.new_zeros(pad)]) if pad else bits
    return int(bits.reshape(-1, 4).any(1).sum())


def relax_bound_ms(n, blocks, chunks, packed_bytes=2):
    """(ms, the binding term) of the relaxation kernel's own traffic over
    `n` pixels in `blocks` blocks, `chunks` of its 4-pixel chunks holding a
    claimable pixel, with a packed word of `packed_bytes` a pixel (2, or 4
    above 2^14 levels): the first phase's reads (keys, heights, mask: 9 B a
    pixel) and writes (the packed word and both key buffers) once at HBM
    speed; in each of a block's four scan passes and 17 rounds, every
    pixel's key and packed word read, and in each round every chunk with a
    claimable pixel written (16 B), at the L2 rate; 21 grid barriers a
    block. This is a lower bound of the design's traffic, not the
    relaxation's need: a scan pass's writes (only the keys that fall) and
    the re-reads of a neighbour's key are not counted."""
    passes = 21 * blocks
    l2 = passes * (4.0 + packed_bytes) * n + 17 * blocks * 16.0 * chunks
    return bound_ms(nbytes=(17.0 + packed_bytes) * n, l2_bytes=l2, barriers=passes)


def relabel_chunks(pk, qs, lb, labm, claimable):
    """Chunks of 4 consecutive pixels of the flat stack (the kernel's unit
    of work) that hold a pixel with a bit: a claimable pixel with a key and
    a neighbour whose exit value equals its value. Only those chunks are
    written in a round."""
    import torch
    import torch.nn.functional as F

    from ark_tpu_torch.ops import watershed

    h, w = pk.shape[1:]
    v = pk >> lb
    exitv = F.pad(watershed._lift(pk, qs, labm) >> lb, (1, 1, 1, 1), value=-1)
    hit = ((exitv[:, :h, 1:w + 1] == v) | (exitv[:, 2:, 1:w + 1] == v)
           | (exitv[:, 1:h + 1, :w] == v) | (exitv[:, 1:h + 1, 2:] == v))
    bits = (hit & claimable & (pk != watershed._LAB_SENTINEL)).reshape(-1)
    pad = -bits.numel() % 4
    bits = torch.cat([bits, bits.new_zeros(pad)]) if pad else bits
    return int(bits.reshape(-1, 4).any(1).sum())


def relabel_bound_ms(n, chunks, rounds):
    """(ms, the binding term) of the re-labeling kernel's own traffic over
    `n` pixels in `rounds` rounds, `chunks` of its 4-pixel chunks holding
    bits: the first phase's reads (labels, keys, heights, mask: 13 B a
    pixel) and writes (bits and both label buffers: 9 B) once at HBM speed;
    every round's reads of every pixel's bits and labels (5 B) and writes
    of every chunk with bits (16 B) at the L2 rate; a grid barrier a round.
    This is the design's traffic, not what the re-labeling needs: after the
    first rounds only a thin frontier still waits for a label."""
    return bound_ms(nbytes=22.0 * n, l2_bytes=rounds * (5.0 * n + 16.0 * chunks),
                    barriers=rounds)


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


def build_libs(out_dir, sources):
    """{name: its ctypes library} of `sources` ({name: (a .cu file, extra
    nvcc flags)}), built in parallel with the port's nvcc flags."""
    from ark_tpu_torch.ops import _kernels

    jobs = {}
    for name, (src, extra) in sources.items():
        path = os.path.join(out_dir, f"lib{name}.so")
        jobs[name] = (path, subprocess.Popen([_kernels._nvcc(), *_kernels.NVCC_FLAGS,
                                              *extra, "-o", path, src],
                                             stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (path, proc) in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        libs[name] = ctypes.CDLL(path)
    return libs


def write_cu(out_dir, name, text):
    path = os.path.join(out_dir, f"{name}.cu")
    with open(path, "w") as f:
        f.write(text)
    return path


def build_chain(out_dir):
    """The FADD chain's library."""
    lib = build_libs(out_dir, {"fadd_chain": (write_cu(out_dir, "fadd_chain",
                                                        FADD_CHAIN_CU), [])})["fadd_chain"]
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ark_fadd_chain_launch.argtypes = [p, p, ctypes.c_float, i, p]
    lib.ark_fadd_chain_launch.restype = i
    return lib


def fadd_latency(lib):
    """(cycles per dependent add, ms of the chain, the clock the two imply
    in MHz): the median of 10 timed chains after a warm-up."""
    import torch

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


def share(bound, ms):
    """The bound's share of a measured time, "not measured" where the
    profiler saw no device time."""
    return f"{bound / ms:.2f}" if ms else "not measured"


def in_turns(old, new, timer):
    """(old, new, the four readings): old, new, new, old."""
    t = [timer(old), timer(new), timer(new), timer(old)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


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


def compare(name, lab, vals, n_seg, background, latency, rows, clock_calls=0):
    """One shape in turns, the kernel against the plain version on the
    card, the kernel bitwise against index_add_ on a CPU copy (the plain
    version on the card adds in any order and is not held to it); appends
    its row and prints it."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr

    k = vals.shape[1]
    plan = sr.segment_plan(lab, n_seg)
    want = sr.segment_sum_plain(vals.cpu(), lab.cpu(), n_seg, background)
    new = lambda: sr.segment_sum(vals, lab, n_seg, plan, background)     # noqa: E731
    old = lambda: sr.segment_sum_plain(vals, lab, n_seg, background)   # noqa: E731
    if not torch.equal(new().cpu(), want):
        raise SystemExit(f"{name}: the kernel is not bitwise")
    flat = lab.reshape(-1).long()
    library = lambda: torch.zeros((n_seg, k), device="cuda").index_add_(  # noqa: E731
        0, flat, vals)
    old_ev, new_ev, turns_ev = in_turns(old, new, time_ms)
    old_b, new_b, turns_b = in_turns(old, new, batch_ms)
    fg = int((flat > 0).sum()) if not background else lab.numel()
    nbytes = 4.0 * (fg * k + lab.numel() + n_seg * k)
    row = {"shape": name, "k": k, "segments": n_seg, "entries": lab.numel(),
           "background": background, "plain_ms": old_ev, "new_ms": new_ev,
           "turns_ms": turns_ev, "plain_batch_ms": old_b, "new_batch_ms": new_b,
           "turns_batch_ms": turns_b, "plain_device_ms": device_ms(old),
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
          f"background={background}): plain ev {old_ev:.4f} ms, batch {old_b:.4f}, dev "
          f"{row['plain_device_ms']}; new ev {new_ev:.4f} ms, batch {new_b:.4f}, dev "
          f"{row['new_device_ms']} (turns ev {[round(t, 4) for t in turns_ev]}, batch "
          f"{[round(t, 4) for t in turns_b]}); CUDA index_add_ ev "
          f"{row['library_ms']:.4f}, batch {row['library_batch_ms']:.4f}; byte bound "
          f"{row['byte_bound_ms']:.4f} ms{extra}; bitwise equal to index_add_ on the CPU")


def four_sums(name, masks, rows):
    """One FOV's four sums as the default cell table makes them (two
    compartments x (plan, K = 3, K = 44), without the background row),
    beside the plain version and their byte bound; then the plan kernel alone
    on each compartment against ``segment_boxes_plain``."""
    import torch

    from ark_tpu_torch.ops import segment_reduce as sr

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
                    sr.segment_sum_plain(v, lab, s, background=False)

    old_ms, new_ms, turns = in_turns(lambda: four(False), lambda: four(True), time_ms)
    dev_old, dev_new = device_ms(lambda: four(False)), device_ms(lambda: four(True))
    # per compartment: both passes' foreground values and labels read, the
    # sums written; the plan's labels in, boxes out
    cols = 3 + 44
    bound = sum(bound_ms(nbytes=4.0 * (int((lab > 0).sum()) * cols + 2 * lab.numel()
                                       + s * cols) + 4.0 * lab.numel() + 16.0 * s)[0]
                for lab, s, _, _ in inputs)
    rows.append({"shape": f"{name}_fov_four_sums", "plain_ms": old_ms, "new_ms": new_ms,
                 "turns_ms": turns, "plain_device_ms": dev_old, "new_device_ms": dev_new,
                 "bound_ms": bound})
    print(f"segment sums of one {name} FOV's default cell table (2 compartments x "
          f"(plan, K=3, K=44)): plain ev {old_ms:.4f} ms, new ev {new_ms:.4f} ms (turns "
          f"{[round(t, 4) for t in turns]}); dev plain {dev_old}, new {dev_new}; bound "
          f"{bound:.4f} ms")
    for comp, (lab, s, _, _) in zip(("whole_cell", "nuclear"), inputs):
        if not torch.equal(sr.segment_plan(lab, s).boxes, sr.segment_boxes_plain(lab, s)):
            raise SystemExit(f"plan {name} {comp}: boxes differ from the plain version's")
        kernel = lambda: sr.segment_plan(lab, s)             # noqa: E731
        plain = lambda: sr.segment_boxes_plain(lab, s)       # noqa: E731
        plain_ms, plan_ms, turns = in_turns(plain, kernel, time_ms)
        # the labels read once, the boxes written once
        bound = bound_ms(nbytes=4.0 * lab.numel() + 16.0 * s)[0]
        row = {"shape": f"{name}_{comp}_plan", "segments": s, "plain_ms": plain_ms,
               "new_ms": plan_ms, "turns_ms": turns, "new_device_ms": device_ms(kernel),
               "bound_ms": bound}
        rows.append(row)
        print(f"segment_plan {name} {comp} {tuple(lab.shape)}, {s} segments: plain ev "
              f"{plain_ms:.4f} ms, kernel ev {plan_ms:.4f} ms (turns "
              f"{[round(t, 4) for t in turns]}), dev {row['new_device_ms']}; byte bound "
              f"{bound:.4f} ms; boxes equal to the plain version's")


CLAIM_TOOLS_CU = r"""
// today's claim kernels, for the level-scan kernel's grid (levels_grid)
#include "watershed_claim.cu"

// The level-scan kernel's grid over b x h x w labels (fewer than 2^31) on
// the current device, as ark_claim_levels_launch sizes it, or minus the
// error that would refuse the launch.
extern "C" int ark_claim_levels_grid(int b, int h, int w) {
  const uint32_t n = (uint32_t)((long long)b * h * w);
  unsigned grid = 0;
  const cudaError_t err = w % kVec == 0 ? levels_grid<true>(n, &grid)
                                        : levels_grid<false>(n, &grid);
  return err == cudaSuccess ? (int)grid : -(int)err;
}

// Reads n16 16-byte words `passes` times through L2 only (ld.global.cg, as
// the claim kernels read labels), four loads in flight a thread.
__global__ void __launch_bounds__(256) l2_read(const int4* buf, long long n16, int passes,
                                               int* sink) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  int acc = 0;
  for (int p = 0; p < passes; ++p) {
    for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n16;
         i += 4 * stride) {
      int4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        v[u] = i + u * stride < n16 ? __ldcg(buf + i + u * stride) : make_int4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) acc ^= v[u].x ^ v[u].y ^ v[u].z ^ v[u].w;
    }
  }
  if (acc == 0x7fffffff) sink[0] = acc;   // keeps the loads
}

// The level-scan kernel's round without its pixels, in its 512-thread
// blocks: each block adds 1 into counts[r % 3] (a warp reduction, a shared
// and a global atomic), block 0 clears counts[(r + 1) % 3], a grid barrier,
// one thread a block reads the count and shares it. Runs `rounds` rounds
// while every block's count arrives; out[0] = rounds.
__global__ void __launch_bounds__(512) barrier_rounds(int* counts, int rounds, int* out) {
  __shared__ int block_sum;
  __shared__ int round_count;
  cg::grid_group grid = cg::this_grid();
  int r = 0;
  for (;;) {
    if (threadIdx.x == 0) block_sum = 0;
    __syncthreads();
    const int mine = __reduce_add_sync(0xffffffffu, threadIdx.x == 0 ? 1 : 0);
    if ((threadIdx.x & 31) == 0 && mine != 0) atomicAdd(&block_sum, mine);
    __syncthreads();
    int* const count = counts + r % 3;
    if (threadIdx.x == 0 && block_sum != 0) atomicAdd(count, block_sum);
    if (blockIdx.x == 0 && threadIdx.x == 0) counts[(r + 1) % 3] = 0;
    grid.sync();
    if (threadIdx.x == 0) round_count = __ldcg(count);
    __syncthreads();
    const int c = round_count;
    ++r;
    if (c != (int)gridDim.x || r == rounds) break;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[0] = r;
}

extern "C" int ark_l2_read_launch(const void* buf, long long n16, int passes, int* sink,
                                  void* stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, l2_read, 256, 0);
  l2_read<<<per_sm * sms, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int4*>(buf), n16, passes, sink);
  return (int)cudaGetLastError();
}

extern "C" int ark_barrier_rounds_launch(int blocks, int* counts, int rounds, int* out,
                                         void* stream) {
  void* args[] = {&counts, &rounds, &out};
  return (int)cudaLaunchCooperativeKernel((const void*)barrier_rounds, dim3(blocks),
                                          dim3(512), args, 0,
                                          static_cast<cudaStream_t>(stream));
}
"""

BARRIER_ROUNDS = 2000
L2_PASSES = 50


def build_claim(out_dir):
    """The tool kernels' library."""
    from ark_tpu_torch.ops import _kernels

    today = ["-I", os.path.dirname(_kernels.source("watershed_claim"))]
    tools = build_libs(out_dir, {"claim_tools": (write_cu(out_dir, "claim_tools",
                                                          CLAIM_TOOLS_CU), today)})["claim_tools"]
    p, i = ctypes.c_void_p, ctypes.c_int
    tools.ark_l2_read_launch.argtypes = [p, ctypes.c_longlong, i, p, p]
    tools.ark_barrier_rounds_launch.argtypes = [i, p, i, p, p]
    tools.ark_claim_levels_grid.argtypes = [i, i, i]
    tools.ark_l2_read_launch.restype = tools.ark_barrier_rounds_launch.restype = i
    tools.ark_claim_levels_grid.restype = i
    return tools


def l2_read_rate(tools, nbytes):
    """Bytes per second of L2_PASSES passes of 16-byte L2-only reads over a
    working set of `nbytes` (warmed first), by events."""
    import torch

    buf = torch.ones(nbytes // 4, dtype=torch.int32, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(passes):
        err = tools.ark_l2_read_launch(buf.data_ptr(), nbytes // 16, passes,
                                       sink.data_ptr(), stream)
        assert err == 0, err

    one, many = time_ms(lambda: run(1)), time_ms(lambda: run(L2_PASSES))
    return nbytes * (L2_PASSES - 1) / ((many - one) * 1e-3)


def barrier_ms(tools, blocks):
    """ms of one round of ``barrier_rounds`` at `blocks` blocks: the
    difference of BARRIER_ROUNDS rounds and one, over BARRIER_ROUNDS - 1."""
    import torch

    counts = torch.zeros(3, dtype=torch.int32, device="cuda")
    out = torch.zeros(1, dtype=torch.int32, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def run(rounds):
        counts.zero_()
        err = tools.ark_barrier_rounds_launch(blocks, counts.data_ptr(), rounds,
                                              out.data_ptr(), stream)
        assert err == 0, err

    one, many = time_ms(lambda: run(1)), time_ms(lambda: run(BARRIER_ROUNDS))
    if int(out) != BARRIER_ROUNDS:
        raise SystemExit(f"barrier_rounds stopped after {int(out)} rounds: a count "
                         f"went missing")
    return (many - one) / (BARRIER_ROUNDS - 1)


def claim_ab():
    import torch

    from ark_tpu_torch.ops import _kernels, watershed
    from ark_tpu_torch.segmentation import mesmer

    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    rows = []
    app = mesmer.Mesmer(weights_path=CKPT, device="cuda")
    reliefs = {name: cohort_relief(app, fovs)
               for name, (fovs, _) in planted_cohorts().items()}
    del app
    with tempfile.TemporaryDirectory() as tmp:
        tools = build_claim(tmp)
        sizes = {"16MiB": 16 << 20}
        for name, relief in reliefs.items():
            n = relief["whole_cell"][0].numel()
            sizes[f"{name}_state"] = -(-3 * 4 * n // 16) * 16   # two label buffers, levels
        for name, nbytes in sizes.items():
            rate = l2_read_rate(tools, nbytes)
            rows.append({"shape": f"l2_read_{name}", "bytes": nbytes, "bytes_per_s": rate})
            print(f"L2-only 16-byte reads over {nbytes} bytes ({name}), {L2_PASSES} passes: "
                  f"{rate / 1e12:.3f} TB/s")
        for name, relief in reliefs.items():
            b, h, w = relief["whole_cell"][0].shape
            blocks = tools.ark_claim_levels_grid(b, h, w)
            assert blocks > 0, blocks
            ms = barrier_ms(tools, blocks)
            rows.append({"shape": f"barrier_{name}", "blocks": blocks, "ms": ms})
            print(f"one round's grid barrier at the level-scan kernel's grid for {name} "
                  f"({blocks} blocks of 512): {ms * 1e3:.3f} us")
        plain_scan, plain_round = watershed._claim_levels, watershed._claim_round_plain
        for name, relief in reliefs.items():
            for comp, (q, markers, fgmask) in relief.items():
                q = q.contiguous()
                lab = watershed._start_labels(markers, fgmask)
                want = watershed._claim_levels(lab, q, 0, 256, 32)
                new = lambda: watershed.claim_levels(lab, q, 0, 256, 32)   # noqa: E731
                old = lambda: plain_scan(lab, q, 0, 256, 32)               # noqa: E731
                if not same_scan(new(), want):
                    raise SystemExit(f"phase A {name} {comp}: the kernel differs from "
                                     f"the plain scan")
                old_ev, new_ev, turns_ev = in_turns(old, new, time_ms)
                old_dev, new_dev, turns_dev = in_turns(old, new, device_ms)
                # the profiler sees part of the cooperative kernel's device time
                # at most: events around the launch alone are its time
                launch_ms = time_ms(lambda: watershed._launch_levels(lab, q, 0, 256, 32))
                labelled = int((want[0] > 0).sum())
                bound, bound_by = scan_bound_ms(lab.numel(), labelled, want[2])
                row = {"shape": f"phase_a_{name}_{comp}", "pixels": lab.numel(),
                       "rounds": want[2], "stop_level": want[1], "labelled": labelled,
                       "plain_ms": old_ev, "new_ms": new_ev, "turns_ms": turns_ev,
                       "plain_device_ms": old_dev, "new_device_ms": new_dev,
                       "turns_device_ms": turns_dev, "new_launch_ms": launch_ms,
                       "round_bytes": claim_bytes(lab.numel(), labelled),
                       "bound_ms": bound, "bound_by": bound_by}
                rows.append(row)
                print(f"phase A {name} {comp} {tuple(lab.shape)} from level 0, 32 rounds a "
                      f"level ({want[2]} rounds, stop {want[1]}, {labelled} pixels labelled "
                      f"at the end): plain loop of rounds ev {old_ev:.4f} ms, dev "
                      f"{old_dev}; level-scan launch ev {new_ev:.4f} ms, dev {new_dev}, "
                      f"events around the launch alone {launch_ms:.4f} (turns ev "
                      f"{[round(t, 4) for t in turns_ev]}); bound {bound:.4f} ms "
                      f"({bound_by}), share of the launch alone {share(bound, launch_ms)}; "
                      f"equal to the plain scan [{card}]")
                want_flood = watershed._flood(q, markers, fgmask, 256, 32)
                real = watershed.claim_levels, watershed.claim_round

                def old_flood():
                    watershed.claim_levels, watershed.claim_round = plain_scan, plain_round
                    try:
                        return watershed._flood(q, markers, fgmask, 256, 32)
                    finally:
                        watershed.claim_levels, watershed.claim_round = real

                new_flood = lambda: watershed._flood(q, markers, fgmask, 256, 32)  # noqa: E731
                got = old_flood()
                if not (torch.equal(got[0], want_flood[0]) and got[1] == want_flood[1]):
                    raise SystemExit(f"flood {name} {comp}: the kernels' flood differs")
                old_w, new_w, turns_w = in_turns(old_flood, new_flood, wall_ms)
                rows.append({"shape": f"flood_{name}_{comp}", "plain_wall_ms": old_w,
                             "new_wall_ms": new_w, "turns_wall_ms": turns_w})
                print(f"level flood {name} {comp} (host clock with a synchronise, median "
                      f"of 5): plain {old_w:.4f} ms, new {new_w:.4f} ms (turns "
                      f"{[round(t, 4) for t in turns_w]}); equal labels and flag")
            q = relief["whole_cell"][0].contiguous()
            lab = torch.as_tensor(claim_like(q), device="cuda")
            if not torch.equal(watershed.claim_round(lab, q, 128)[0],
                               watershed._claim_round(lab, q, None, 128)):
                raise SystemExit(f"one round {name}: the kernel differs")
            old = lambda: plain_round(lab, q, 128)                   # noqa: E731
            new = lambda: watershed.claim_round(lab, q, 128)         # noqa: E731
            old_ev, new_ev, turns_ev = in_turns(old, new, time_ms)
            old_b, new_b, turns_b = in_turns(old, new, batch_ms)
            old_dev, new_dev, turns_dev = in_turns(old, new, device_ms)
            # each pixel's label read and written once, a labelled one's level once
            bound = bound_ms(nbytes=claim_bytes(lab.numel(), int((lab > 0).sum())))[0]
            rows.append({"shape": f"round_{name}", "plain_ms": old_ev, "new_ms": new_ev,
                         "plain_batch_ms": old_b, "new_batch_ms": new_b,
                         "plain_device_ms": old_dev, "new_device_ms": new_dev,
                         "turns_device_ms": turns_dev, "bound_ms": bound})
            print(f"one claim round {name} {tuple(lab.shape)} (level 128): plain ev "
                  f"{old_ev:.4f} ms, batch {old_b:.4f}, dev {old_dev}; new ev "
                  f"{new_ev:.4f}, batch {new_b:.4f}, dev {new_dev}; byte bound "
                  f"{bound:.4f} ms, share of dev {share(bound, new_dev)}; equal to the "
                  f"plain round")
    return card, rows


def claim_like(q):
    """Labels like ``chip_smoke.claim_inputs``' on `q`'s shape, seeded."""
    return claim_inputs(np.random.default_rng(60), tuple(q.shape))[0]


def relabel_ab():
    import torch

    from ark_tpu_torch.ops import _kernels, watershed
    from ark_tpu_torch.segmentation import mesmer

    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    app = mesmer.Mesmer(weights_path=CKPT, device="cuda")
    floods = {f"3x1024 {comp}": r for comp, r in
              cohort_relief(app, planted_cohorts()["3x1024"][0]).items()}
    floods["4x1024 crossing"] = cell_relief(*RELABEL_CELL_LIKE, seed=7, device="cuda",
                                            crossing=True)
    del app
    rows = []
    for comp, (q, markers, mask) in floods.items():
        (*ops, n_blocks), _ = relabel_operands(q, markers, mask)
        want = watershed._relabel_plain(*ops, n_blocks)
        got = watershed.minimax_relabel(*ops, n_blocks)
        if not (torch.equal(got[0], want[0]) and got[1:3] == want[1:3]):
            raise SystemExit(f"re-labeling {comp}: the kernel differs from the plain loop "
                             f"(flag, blocks {got[1:3]} against {want[1:3]})")
        new = lambda: watershed.minimax_relabel(*ops, n_blocks)        # noqa: E731
        old = lambda: watershed._relabel_plain(*ops, n_blocks)         # noqa: E731
        old_ev, new_ev, turns_ev = in_turns(old, new, lambda fn: time_ms(fn, reps=3))
        old_dev, new_dev = device_ms(old, reps=2), device_ms(new)
        n, rounds = q.numel(), got[3]
        chunks = relabel_chunks(*ops[1:6])
        bound, bound_by = relabel_bound_ms(n, chunks, rounds)
        real = watershed.minimax_relabel
        h, w = q.shape[1:]

        def old_flood():
            watershed.minimax_relabel = watershed._relabel_plain
            try:
                return watershed._flood_minimax(q, markers, mask, 256, 2 * (h + w))
            finally:
                watershed.minimax_relabel = real

        new_flood = lambda: watershed._flood_minimax(q, markers, mask, 256,  # noqa: E731
                                                     2 * (h + w))
        a, b = old_flood(), new_flood()
        if not (torch.equal(a[0], b[0]) and a[1] == b[1]):
            raise SystemExit(f"flood {comp}: the kernel's flood differs from the plain one")
        old_w, new_w, turns_w = in_turns(old_flood, new_flood, lambda fn: wall_ms(fn, reps=3))
        levels_w = wall_ms(lambda: watershed._flood(q, markers, mask, 256, 32), reps=3)
        row = {"shape": f"relabel_{comp}", "pixels": n, "chunks_with_bits": chunks,
               "blocks": got[2], "rounds": rounds, "converged": got[1], "old_ms": old_ev,
               "new_ms": new_ev, "turns_ms": turns_ev, "old_device_ms": old_dev,
               "new_device_ms": new_dev, "bound_ms": bound, "bound_by": bound_by,
               "share_of_device": bound / new_dev if new_dev else None,
               "flood_old_wall_ms": old_w, "flood_new_wall_ms": new_w,
               "flood_turns_wall_ms": turns_w, "level_flood_wall_ms": levels_w}
        rows.append(row)
        print(f"re-labeling {comp} {tuple(q.shape)} ({got[2]} blocks, {rounds} kernel rounds, "
              f"{chunks} of {-(-n // 4)} chunks with bits, converged {got[1]}): plain loop "
              f"ev {old_ev:.4f} ms, dev {old_dev}; kernel ev {new_ev:.4f} ms, dev {new_dev} "
              f"(turns ev {[round(t, 4) for t in turns_ev]}); bound of the design's traffic "
              f"{bound:.4f} ms ({bound_by}), share of dev {share(bound, new_dev)}; whole flood "
              f"(host clock) plain {old_w:.2f} ms, kernel {new_w:.2f} ms (turns "
              f"{[round(t, 2) for t in turns_w]}), the level engine's flood {levels_w:.2f} ms; "
              f"both equal to the plain loop")
    return card, rows


def relax_ab():
    import torch

    from ark_tpu_torch.ops import _kernels, watershed
    from ark_tpu_torch.segmentation import mesmer

    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    app = mesmer.Mesmer(weights_path=CKPT, device="cuda")
    floods = {f"3x1024 {comp}": r for comp, r in
              cohort_relief(app, planted_cohorts()["3x1024"][0]).items()}
    for crossing in (False, True):
        floods[f"4x1024 {'crossing' if crossing else 'cell-like'}"] = cell_relief(
            *RELABEL_CELL_LIKE, seed=7, device="cuda", crossing=crossing)
    del app
    rows = []
    for name, (q, markers, mask) in floods.items():
        *ops, n_blocks = relax_operands(q, markers, mask)
        want = watershed._relax_plain(*ops, n_blocks)
        got = watershed.minimax_relax(*ops, n_blocks)
        if not (torch.equal(got[0], want[0]) and got[1:] == want[1:]):
            raise SystemExit(f"relaxation {name}: the kernel differs from the plain loop "
                             f"(flag, blocks {got[1:]} against {want[1:]})")
        new = lambda: watershed.minimax_relax(*ops, n_blocks)        # noqa: E731
        old = lambda: watershed._relax_plain(*ops, n_blocks)         # noqa: E731
        old_ev, new_ev, turns_ev = in_turns(old, new, lambda fn: time_ms(fn, reps=3))
        old_dev, new_dev = device_ms(old, reps=2), device_ms(new)
        n, blocks = q.numel(), got[2]
        chunks = relax_chunks(ops[3])
        bound, bound_by = relax_bound_ms(n, blocks, chunks)
        real = watershed.minimax_relax
        h, w = q.shape[1:]

        def old_flood():
            watershed.minimax_relax = watershed._relax_plain
            try:
                return watershed._flood_minimax(q, markers, mask, 256, 2 * (h + w))
            finally:
                watershed.minimax_relax = real

        new_flood = lambda: watershed._flood_minimax(q, markers, mask, 256,  # noqa: E731
                                                     2 * (h + w))
        a, b = old_flood(), new_flood()
        if not (torch.equal(a[0], b[0]) and a[1] == b[1]):
            raise SystemExit(f"flood {name}: the kernel's flood differs from the plain one")
        old_w, new_w, turns_w = in_turns(old_flood, new_flood, lambda fn: wall_ms(fn, reps=3))
        row = {"shape": f"relax_{name}", "pixels": n, "blocks": blocks, "converged": got[1],
               "claimable_chunks": chunks,
               "old_ms": old_ev, "new_ms": new_ev, "turns_ms": turns_ev,
               "old_device_ms": old_dev, "new_device_ms": new_dev, "bound_ms": bound,
               "bound_by": bound_by, "share_of_device": bound / new_dev if new_dev else None,
               "share_of_event": bound / new_ev, "flood_old_wall_ms": old_w,
               "flood_new_wall_ms": new_w, "flood_turns_wall_ms": turns_w}
        rows.append(row)
        print(f"relaxation {name} {tuple(q.shape)} ({blocks} blocks, converged {got[1]}): "
              f"plain loop ev {old_ev:.4f} ms, dev {old_dev}; kernel ev {new_ev:.4f} ms, dev "
              f"{new_dev} (turns ev {[round(t, 4) for t in turns_ev]}); bound {bound:.4f} ms "
              f"({bound_by}), share of dev {share(bound, new_dev)}, of ev "
              f"{share(bound, new_ev)}; whole flood "
              f"(host clock) plain {old_w:.2f} ms, kernel {new_w:.2f} ms (turns "
              f"{[round(t, 2) for t in turns_w]}); equal to the plain loop")
    return card, rows


def segment_sum_ab():
    import torch

    from ark_tpu_torch.ops import _kernels
    from ark_tpu_torch.segmentation import synthetic

    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        latency, chain_ms, chain_mhz = fadd_latency(build_chain(tmp))
        rows.append({"shape": "fadd_chain", "adds": CHAIN_ADDS, "cycles_per_add": latency,
                     "ms": chain_ms, "implied_mhz": chain_mhz})
        print(f"dependent __fadd_rn: {latency:.4f} SM cycles an add (one warp, "
              f"{CHAIN_ADDS} adds, clock64), {chain_ms:.4f} ms by events: "
              f"{chain_mhz:.0f} MHz")
        dense = dense_masks()
        cells = torch.as_tensor(dense["whole_cell"][0], device="cuda")
        n_seg = int(cells.max()) + 1
        for k in (3, 44):
            compare(f"dense_background_k{k}", cells,
                    segment_inputs(dense["whole_cell"][0], k, k), n_seg, True, latency,
                    rows, clock_calls=300)
        ids, n_points = edge_ids()
        rng = np.random.default_rng(59)
        for name, lab in ids.items():
            vals = torch.as_tensor(rng.normal(size=(lab.size, 2)).astype(np.float32),
                                   device="cuda")
            compare(name, torch.as_tensor(lab, device="cuda"), vals, n_points, True,
                    latency, rows)
        _, pcells, pnucs = synthetic.synthetic_cells(
            np.random.default_rng(0), 1, hw=1024, n_cells=(900, 1000), crowding=0.35)
        cohorts = {"dense": (dense["whole_cell"][0], dense["nuclear"][0]),
                   "planted": (pcells[0].astype(np.int32), pnucs[0].astype(np.int32))}
        for name, masks in cohorts.items():
            lab = torch.as_tensor(masks[0], device="cuda")
            for k in (3, 44):
                compare(f"{name}_cells_k{k}", lab, segment_inputs(masks[0], k, k),
                        int(lab.max()) + 1, False, latency, rows)
            four_sums(name, masks, rows)
    return card, rows


def bmu_ab():
    import torch

    from ark_tpu_torch.ops import _kernels, som

    card = gpu_name_and_power()
    print(card)
    _kernels.build_all()
    n, c, k = KERNEL_SHAPES[0]
    rng = np.random.default_rng(42)
    x = torch.as_tensor(pixel_rows(rng, n, c), device="cuda")
    # nodes drawn from the data rows, as the SOM's initial nodes are
    w = x[torch.as_tensor(rng.choice(n, size=k), device="cuda")].clone()
    ties = near_ties(plain_d(w, x))
    bound, bound_by = bmu_bound_ms(n, c, k)
    rows = []
    for dist in (False, True):
        new = lambda: som.bmu(w, x, return_dist=dist)             # noqa: E731
        old = lambda: som.bmu_plain(w, x, return_dist=dist)       # noqa: E731
        if bool(((new()[0] != old()[0]) & ~ties).any()):
            raise SystemExit(f"bmu with_dist={dist}: indices differ outside near-ties")
        old_ev, new_ev, turns_ev = in_turns(old, new, time_ms)
        old_dev, new_dev = device_ms(old), device_ms(new)
        rows.append({"shape": f"bmu_{n}x{c}x{k}", "with_dist": dist, "plain_ms": old_ev,
                     "new_ms": new_ev, "turns_ms": turns_ev, "plain_device_ms": old_dev,
                     "new_device_ms": new_dev, "bound_ms": bound, "bound_by": bound_by})
        print(f"bmu N={n} C={c} K={k} with_dist={dist}: plain ev {old_ev:.4f} ms, dev "
              f"{old_dev}; kernel ev {new_ev:.4f} ms, dev {new_dev} (turns ev "
              f"{[round(t, 4) for t in turns_ev]}); bound {bound:.4f} ms ({bound_by}), share "
              f"of dev {share(bound, new_dev)}, of ev {share(bound, new_ev)}; indices equal "
              f"but at near-ties [{card}]")
    return card, rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel", choices=("segment_sum", "bmu", "claim", "relabel", "relax"),
                    default="segment_sum")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    card, rows = {"bmu": bmu_ab, "claim": claim_ab, "segment_sum": segment_sum_ab,
                  "relabel": relabel_ab, "relax": relax_ab}[args.kernel]()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "rows": rows}, f, indent=1)


if __name__ == "__main__":
    main()
