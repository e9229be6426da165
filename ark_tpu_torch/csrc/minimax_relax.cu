// The minimax flood's relaxation, written by hand for sm_90a: every block of
// it, four directional scans, 16 rounds and a probe round, in one cooperative
// launch (relax_kernel).
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA code in a
// lax.scan (ark_tpu/ops/watershed.py::_flood_minimax), which XLA fuses. The
// port's plain version, ark_tpu_torch/ops/watershed.py::_relax_plain, runs a
// block as ~1,700 dispatched torch ops (the sweep's four recursions of
// _associative_scan alone ~1,400, of which ~900 launch strided elementwise
// kernels), and a synchronising comparison; a flood of a 4 x 1024^2 batch
// runs ~17 blocks, so the host's dispatch, not the blocks' integer work, set
// its time.
//
// What a block computes (bit for bit the plain loop's). Every pixel holds a
// packed key pk = value << lb | label (INT32_MAX: none) and a shifted height
// qs = q << lb; lift(k, s) = k >= s ? k : s | (k & labm).
// - The sweep: four directional scans, W forward, W reverse, H forward, H
//   reverse, each reading the keys the previous one wrote. A line is scanned
//   with the comb (c1, g1) + (c2, g2) = (min(c2, lift(c1, g2)), max(g1, g2))
//   over (key, gate of the position before; the first position takes the
//   absorbing gate `absorb`), keys that come out >= absorb become INT32_MAX,
//   and a claimable pixel takes the min of its key and the scan's. The gate
//   is qs where the pixel is claimable or its key holds a bare label, else
//   absorb; claimable keys are the only ones that change, so the gate is
//   fixed for the whole flood and is computed once, in the first phase.
// - The scan replays jax.lax.associative_scan's tree, as _associative_scan
//   does: the comb is not associative on equal-value ties, so only the same
//   pairs combined in the same order give the reference's keys. Level l + 1
//   of a line holds the combs of level l's pairs (2i, 2i + 1), floor(n / 2^l)
//   elements (element i of level l covers positions [i 2^l, (i + 1) 2^l)).
//   Going down, the scan S of level l is S[0] = A[0], S[2k + 1] = S'[k] and
//   S[2k + 2] = comb(S'[k], A[2k + 2]), S' the scan of level l + 1. All
//   arithmetic is int32, so any schedule of the same tree gives the same
//   bits. Only the key of S is ever read, so it is written over A's key.
// - 16 synchronous rounds, then a probe round: a claimable pixel takes
//   min(its key, min over its 4-neighbours u of lift(pk(u), qs(u))). The
//   rounds are Jacobi rounds, ping-ponging between two key buffers with a
//   grid barrier a round, as in the plain loop. After the probe the keys are
//   the probe's; the loop stops at the first block whose probe changed
//   nothing, or after n_blocks blocks.
//
// What bounds it on an H100, at 4 x 1024^2 (chip_smoke.relax_bound_ms, a
// lower bound of this design's own traffic): each of a block's four scan
// passes and 17 rounds reads every pixel's key (4 B) and packed word (2 B),
// and each round writes every 4-pixel chunk that holds a claimable pixel
// (16 B); with every chunk claimable that is ~0.81 GB a block, 0.10 ms at
// the L2's 7.98 TB/s (0.24 ms at HBM speed), beside 21 grid barriers of
// 2.02 us (0.042 ms). The working set is two key planes (33.6 MB) and the
// packed plane (8.4 MB), which a 50 MB L2 holds: the first phase packs each
// pixel's height bucket, its claimable bit and its gate bit into 16 bits (32
// where levels > 2^14).
//
// The design. Every block resident (a grid from the occupancy query; a grid
// the card cannot hold is refused, never hung); one decision in every block
// after a grid barrier; the probe's changed flag in a ring of three, each
// cleared a block ahead (watershed_claim.cu's and minimax_relabel.cu's
// rule). A scan pass takes tiles of up to 8 lines (rows, or columns side by
// side, so a column tile reads 32 contiguous bytes a row) and runs each
// tile's tree in shared memory: the levels above the first, about 8 B a
// position, 64 KB for 8 lines of 1024; level 0 is read from the keys. A
// line too long for 64 KB at one line a tile keeps its levels in a global
// scratch of the block's own, which the wrapper allocates (the plan says how
// much). A pass writes its keys in place: its lines are disjoint, and a
// tile reads every key of its lines before it writes one. A round takes 4
// consecutive pixels a thread, as the re-labeling's rounds do: 16-byte loads
// of keys, the rows above and below as 16-byte loads where W % 4 == 0 (on
// an H100 at 700 W, 27 blocks at 4 x 1024^2 take 13.1 ms of device time
// with them and 20.1 ms with a pixel's loads instead), the pixels beside the
// chunk from the neighbouring lanes by warp shuffle. Keys
// and packed heights written in this launch are read through L2 only
// (ld.global.cg). A chunk with no claimable pixel never changes: the first
// phase copies the keys into both buffers, and no round writes it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;                     // pixels a thread takes in a round
constexpr int kRounds = 16;                 // rounds a block before the probe
constexpr int kMaxLog2Lines = 3;            // a scan tile: at most 8 lines
constexpr long long kTreeShared = 64 * 1024;  // bytes of a tile's tree in shared memory
constexpr int32_t kSentinel = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kClaim = 1, kOpen = 2;   // packed: q << 2 | gate open << 1 | claimable
constexpr int32_t kNarrowLevels = 1 << 14;  // 16-bit packing up to this many levels

__device__ __forceinline__ int32_t lift(int32_t k, int32_t s, int32_t labm) {
  return k >= s ? k : (s | (k & labm));
}

__device__ __forceinline__ int32_t height(uint32_t packed, int lb) {
  return (int32_t)(packed >> 2) << lb;
}

// The gate a pixel passes on to the next position of a scan.
__device__ __forceinline__ int32_t gate(uint32_t packed, int lb, int32_t absorb) {
  return (packed & kOpen) ? height(packed, lb) : absorb;
}

// A line's levels above the first: sum of floor(n / 2^l), l >= 1.
__host__ __device__ __forceinline__ long long tree_len(long long n) {
  long long s = 0;
  for (long long m = n >> 1; m > 0; m >>= 1) s += m;
  return s;
}

// One directional scan pass over the keys `pk` of b images of h x w, in
// place: along W (rows) or H (columns), forward or reverse. `tree`: the
// block's levels, room for 2^log2v lines of the longer dimension.
template <typename I, typename P>
__device__ void scan_pass(int32_t* __restrict__ pk, const P* __restrict__ packed, int2* tree,
                          bool along_w, bool reverse, I b, I h, I w, int log2v, int lb,
                          int32_t labm, int32_t absorb) {
  const I n = along_w ? w : h;
  const int lines = 1 << log2v;
  const I per_image = (w + lines - 1) >> log2v;
  const I tiles = along_w ? (b * h + lines - 1) >> log2v : b * per_image;
  // a thread keeps one line of a tile and every span-th position on it:
  // along W consecutive threads take consecutive positions of one row,
  // along H consecutive columns of one row
  const int span = kThreads >> log2v;
  const int v = along_w ? (int)threadIdx.x / span : (int)threadIdx.x & (lines - 1);
  const I i0 = along_w ? (I)(threadIdx.x % span) : (I)(threadIdx.x >> log2v);
  const I s_line = (I)tree_len(n);
  const I ps = along_w ? 1 : (I)lines;        // tree[pos * ps + v * vs]
  int2* const mine = tree + (along_w ? (I)v * s_line : (I)v);
  for (I t = blockIdx.x; t < tiles; t += gridDim.x) {
    I line0, kstride, nv;
    if (along_w) {
      const I r0 = t << log2v;
      line0 = (r0 + v) * w;
      kstride = 1;
      nv = b * h - r0;
    } else {
      const I img = t / per_image, x0 = (t - img * per_image) << log2v;
      line0 = img * h * w + x0 + v;
      kstride = w;
      nv = w - x0;
    }
    const bool live = (I)v < nv;
    auto pix = [&](I k) { return line0 + (reverse ? n - 1 - k : k) * kstride; };
    // the gate entering position k: the absorbing one at the first position
    auto gate_in = [&](I k) {
      return k == 0 ? absorb : gate(__ldcg(packed + pix(k - 1)), lb, absorb);
    };
    // up: level 1 from the keys, then each level from the one below
    const I m = n >> 1;
    if (live) {
      for (I i = i0; i < m; i += span) {
        const int32_t ca = __ldcg(pk + pix(2 * i)), cb = __ldcg(pk + pix(2 * i + 1));
        const int32_t ga = gate_in(2 * i), gb = gate_in(2 * i + 1);
        mine[i * ps] = make_int2(min(cb, lift(ca, gb, labm)), max(ga, gb));
      }
    }
    __syncthreads();
    int top = m > 0 ? 1 : 0;                  // the highest level
    I lo = 0;                                 // its offset
    for (I len = m; len >= 2; len >>= 1) {
      const I hi = lo + len, half = len >> 1;
      if (live) {
        for (I i = i0; i < half; i += span) {
          const int2 a = mine[(lo + 2 * i) * ps], c = mine[(lo + 2 * i + 1) * ps];
          mine[(hi + i) * ps] = make_int2(min(c.x, lift(a.x, c.y, labm)), max(a.y, c.y));
        }
      }
      __syncthreads();
      lo = hi;
      ++top;
    }
    // down: level l's scan from level l + 1's, over level l's keys
    for (int l = top - 1; l >= 1; --l) {
      const I len = n >> l, up = lo;
      lo -= len;
      if (live) {
        for (I j = i0; j < len; j += span) {
          if (j == 0) continue;
          int32_t c;
          if (j & 1) {
            c = mine[(up + (j >> 1)) * ps].x;
          } else {
            const int2 a = mine[(lo + j) * ps];
            c = min(a.x, lift(mine[(up + (j >> 1) - 1) * ps].x, a.y, labm));
          }
          mine[(lo + j) * ps].x = c;
        }
      }
      __syncthreads();
    }
    // level 0: the scan's key at every position, into the claimable pixels
    if (live) {
      for (I j = i0; j < n; j += span) {
        const I p = pix(j);
        const int32_t own = __ldcg(pk + p);
        int32_t c = own;
        if (j & 1) {
          c = mine[(j >> 1) * ps].x;
        } else if (j > 0) {
          c = min(own, lift(mine[((j >> 1) - 1) * ps].x, gate_in(j), labm));
        }
        const int32_t cand = c >= absorb ? kSentinel : c;
        if ((__ldcg(packed + p) & kClaim) && cand < own) __stcg(pk + p, cand);
      }
    }
    __syncthreads();                          // the next tile writes the tree
  }
}

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return __ldcg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ void load_packed4(const uint16_t* p, uint32_t* o) {
  const uint2 v = __ldcg(reinterpret_cast<const uint2*>(p));
  o[0] = v.x & 0xffffu;
  o[1] = v.x >> 16;
  o[2] = v.y & 0xffffu;
  o[3] = v.y >> 16;
}

__device__ __forceinline__ void load_packed4(const uint32_t* p, uint32_t* o) {
  const uint4 v = __ldcg(reinterpret_cast<const uint4*>(p));
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

// One round on the chunk of kVec pixels from p0 = kVec * chunk of the stack
// of n = B * H * W pixels (fewer at its end, none past it): keys from `in`,
// the chunk written to `out` where one of its pixels is claimable; returns
// whether a key changed. Every lane of a warp calls it at once, on
// consecutive chunks (lanes past the end too): the pixels beside a chunk
// come from the neighbouring lanes. kAligned: W % kVec == 0, so a chunk lies
// in one row, as do the chunks above and below it.
template <bool kAligned, typename I, typename P>
__device__ __forceinline__ bool round_chunk(const int32_t* __restrict__ in,
                                            const P* __restrict__ packed,
                                            int32_t* __restrict__ out, I chunk, I n, I h, I w,
                                            int lb, int32_t labm) {
  const int lane = threadIdx.x & 31;
  const I p0 = chunk * kVec;
  const bool full = p0 + kVec <= n;
  int32_t own[kVec];
  uint32_t pv[kVec];
  if (full) {
    const int4 k = load4(in + p0);
    own[0] = k.x;
    own[1] = k.y;
    own[2] = k.z;
    own[3] = k.w;
    load_packed4(packed + p0, pv);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool inside = p0 + j < n;
      own[j] = inside ? __ldcg(in + p0 + j) : kSentinel;
      pv[j] = inside ? (uint32_t)__ldcg(packed + p0 + j) : 0u;
    }
  }
  // the pixels just left and right of the chunk: the neighbouring lanes'
  int32_t left_k = __shfl_up_sync(kFull, own[kVec - 1], 1);
  uint32_t left_p = __shfl_up_sync(kFull, pv[kVec - 1], 1);
  int32_t right_k = __shfl_down_sync(kFull, own[0], 1);
  uint32_t right_p = __shfl_down_sync(kFull, pv[0], 1);
  uint32_t claim = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) claim |= (pv[j] & kClaim) << j;
  if (claim == 0) return false;

  int32_t next[kVec];
  bool changed = false;
  if (kAligned) {
    const I row = p0 / w;
    const I x0 = p0 - row * w, y = row % h;
    const bool has_up = y > 0, has_down = y + 1 < h;
    const bool has_left = x0 > 0, has_right = x0 + kVec < w;
    int32_t up_k[kVec], down_k[kVec];
    uint32_t up_p[kVec], down_p[kVec];
    if (has_up) {
      const int4 k = load4(in + (p0 - w));
      up_k[0] = k.x;
      up_k[1] = k.y;
      up_k[2] = k.z;
      up_k[3] = k.w;
      load_packed4(packed + (p0 - w), up_p);
    }
    if (has_down) {
      const int4 k = load4(in + (p0 + w));
      down_k[0] = k.x;
      down_k[1] = k.y;
      down_k[2] = k.z;
      down_k[3] = k.w;
      load_packed4(packed + (p0 + w), down_p);
    }
    if (lane == 0 && has_left && (claim & 1u)) {
      left_k = __ldcg(in + (p0 - 1));
      left_p = __ldcg(packed + (p0 - 1));
    }
    if (lane == 31 && has_right && (claim & (1u << (kVec - 1)))) {
      right_k = __ldcg(in + (p0 + kVec));
      right_p = __ldcg(packed + (p0 + kVec));
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      next[j] = own[j];
      if (!((claim >> j) & 1u)) continue;
      int32_t c = kSentinel;
      if (has_up) c = min(c, lift(up_k[j], height(up_p[j], lb), labm));
      if (has_down) c = min(c, lift(down_k[j], height(down_p[j], lb), labm));
      if (j > 0) {
        c = min(c, lift(own[j - 1], height(pv[j - 1], lb), labm));
      } else if (has_left) {
        c = min(c, lift(left_k, height(left_p, lb), labm));
      }
      if (j < kVec - 1) {
        c = min(c, lift(own[j + 1], height(pv[j + 1], lb), labm));
      } else if (has_right) {
        c = min(c, lift(right_k, height(right_p, lb), labm));
      }
      next[j] = min(own[j], c);
      changed |= next[j] != own[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      next[j] = own[j];
      if (!((claim >> j) & 1u)) continue;
      const I p = p0 + j, row = p / w;
      const I x = p - row * w, y = row % h;
      int32_t c = kSentinel;
      if (y > 0) {
        c = min(c, lift(__ldcg(in + (p - w)), height(__ldcg(packed + (p - w)), lb), labm));
      }
      if (y + 1 < h) {
        c = min(c, lift(__ldcg(in + (p + w)), height(__ldcg(packed + (p + w)), lb), labm));
      }
      if (x > 0) {
        int32_t k = left_k;
        uint32_t s = left_p;
        if (j > 0) {
          k = own[j - 1];
          s = pv[j - 1];
        } else if (lane == 0) {
          k = __ldcg(in + (p - 1));
          s = __ldcg(packed + (p - 1));
        }
        c = min(c, lift(k, height(s, lb), labm));
      }
      if (x + 1 < w) {
        int32_t k = right_k;
        uint32_t s = right_p;
        if (j < kVec - 1) {
          k = own[j + 1];
          s = pv[j + 1];
        } else if (lane == 31) {
          k = __ldcg(in + (p + 1));
          s = __ldcg(packed + (p + 1));
        }
        c = min(c, lift(k, height(s, lb), labm));
      }
      next[j] = min(own[j], c);
      changed |= next[j] != own[j];
    }
  }
  if (full) {
    __stcg(reinterpret_cast<int4*>(out + p0), make_int4(next[0], next[1], next[2], next[3]));
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (p0 + j < n) __stcg(out + p0 + j, next[j]);
    }
  }
  return changed;
}

// flags: 4 int32, zero at launch (three for the probe's ring, one for a
// height out of range); status: 4 int32, the blocks run, which buffer holds
// the keys, 1 if the last probe changed nothing, 1 if a height was refused.
template <bool kAligned, typename I, typename P>
__global__ void __launch_bounds__(kThreads)
relax_kernel(const int32_t* __restrict__ pk0, const int32_t* __restrict__ qs,
             const uint8_t* __restrict__ claimable, int lb, int32_t labm, int32_t absorb,
             int32_t n_blocks, I b, I h, I w, int log2v, P* packed, int2* tree_global,
             long long tree_stride, int32_t* buf0, int32_t* buf1, int32_t* flags,
             int32_t* status) {
  extern __shared__ int2 tree_shared[];
  __shared__ int32_t block_flag;
  cg::grid_group grid = cg::this_grid();
  int2* const tree = tree_global ? tree_global + blockIdx.x * tree_stride : tree_shared;
  const I n = b * h * w;
  const I all = (I)gridDim.x * kThreads;
  // the first phase: packed heights and bits, the keys into both buffers
  bool bad = false;
  for (I p = (I)blockIdx.x * kThreads + threadIdx.x; p < n; p += all) {
    const int32_t s = __ldg(qs + p), k = __ldg(pk0 + p);
    const bool c = __ldg(claimable + p) != 0;
    bad |= s < 0 || s >= absorb || (s & labm) != 0;
    packed[p] = (P)(((uint32_t)(s >> lb) << 2) | ((c || k <= labm) ? kOpen : 0u) |
                    (c ? kClaim : 0u));
    buf0[p] = k;
    buf1[p] = k;
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicOr(flags + 3, 1);
  grid.sync();
  if (threadIdx.x == 0) block_flag = __ldcg(flags + 3);
  __syncthreads();
  if (block_flag != 0) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      status[0] = 0;
      status[1] = 0;
      status[2] = 0;
      status[3] = 1;
    }
    return;
  }
  const I chunks = (n + kVec - 1) / kVec;
  const I first = (I)blockIdx.x * kThreads + (threadIdx.x & ~31u);
  const I lane = threadIdx.x & 31;
  int32_t* cur = buf0;
  int32_t* nxt = buf1;
  int blocks = 0, done = 0;
  while (blocks < n_blocks) {
    ++blocks;
    for (int d = 0; d < 4; ++d) {             // W forward, W reverse, H forward, H reverse
      scan_pass<I, P>(cur, packed, tree, d < 2, d & 1, b, h, w, log2v, lb, labm, absorb);
      grid.sync();
    }
    for (int r = 0; r <= kRounds; ++r) {      // the block's rounds, then the probe
      bool mine = false;
      // the loop's bound is the warp's, so its lanes stay together for the shuffles
      for (I base = first; base < chunks; base += all) {
        mine |= round_chunk<kAligned, I, P>(cur, packed, nxt, base + lane, n, h, w, lb, labm);
      }
      if (r == kRounds) {
        int32_t* const flag = flags + blocks % 3;
        if (__syncthreads_or(mine) && threadIdx.x == 0) atomicOr(flag, 1);
        if (blockIdx.x == 0 && threadIdx.x == 0) flags[(blocks + 1) % 3] = 0;
        grid.sync();
        // one read of the flag a block, not a thread
        if (threadIdx.x == 0) block_flag = __ldcg(flag);
        __syncthreads();
      } else {
        grid.sync();
      }
      int32_t* const t = cur;
      cur = nxt;
      nxt = t;
    }
    if (block_flag == 0) {
      done = 1;
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = blocks;
    status[1] = cur == buf0 ? 0 : 1;
    status[2] = done;
    status[3] = 0;
  }
}

struct Args {
  const int32_t* pk0;
  const int32_t* qs;
  const uint8_t* claimable;
  int lb;
  int32_t labm, absorb, n_blocks;
  long long b, h, w;
  void* packed;
  void* tree;
  long long tree_bytes;
  int32_t *buf0, *buf1, *flags, *status;
};

// The launch's plan: [grid, log2 of the lines a scan tile, dynamic shared
// bytes, global tree bytes (0: the tree is in shared memory), packed bytes a
// pixel].
template <bool kAligned, typename I, typename P>
cudaError_t plan(const Args& a, long long* out) {
  const void* kernel = (const void*)relax_kernel<kAligned, I, P>;
  const long long s = tree_len(a.w) > tree_len(a.h) ? tree_len(a.w) : tree_len(a.h);
  int log2v = kMaxLog2Lines;
  bool in_shared = false;
  for (int l = kMaxLog2Lines; l >= 0 && !in_shared; --l) {
    if ((s << l) * (long long)sizeof(int2) <= kTreeShared) {
      log2v = l;
      in_shared = true;
    }
  }
  const long long smem = in_shared ? (s << log2v) * (long long)sizeof(int2) : 0;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (size_t)smem);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long lines = 1LL << log2v;
  const long long chunks = (a.b * a.h * a.w + kVec - 1) / kVec;
  long long need = (chunks + kThreads - 1) / kThreads;
  const long long row_tiles = (a.b * a.h + lines - 1) / lines;
  const long long col_tiles = a.b * ((a.w + lines - 1) / lines);
  need = need > row_tiles ? need : row_tiles;
  need = need > col_tiles ? need : col_tiles;
  const long long most = (long long)per_sm * sms;
  const long long grid = need < 1 ? 1 : (need < most ? need : most);
  out[0] = grid;
  out[1] = log2v;
  out[2] = smem;
  out[3] = in_shared ? 0 : grid * (s << log2v) * (long long)sizeof(int2);
  out[4] = sizeof(P);
  return cudaSuccess;
}

template <bool kAligned, typename I, typename P>
int run(const Args& a, long long* plan_out, cudaStream_t stream) {
  long long p[5];
  cudaError_t err = plan<kAligned, I, P>(a, p);
  if (err != cudaSuccess) return (int)err;
  if (plan_out) {
    for (int i = 0; i < 5; ++i) plan_out[i] = p[i];
    return 0;
  }
  if (a.tree_bytes < p[3] || (p[3] > 0 && a.tree == nullptr)) return (int)cudaErrorInvalidValue;
  const int32_t* pk0 = a.pk0;
  const int32_t* qs = a.qs;
  const uint8_t* claimable = a.claimable;
  int lb = a.lb, log2v = (int)p[1];
  int32_t labm = a.labm, absorb = a.absorb, n_blocks = a.n_blocks;
  I b = (I)a.b, h = (I)a.h, w = (I)a.w;
  P* packed = static_cast<P*>(a.packed);
  int2* tree = p[3] > 0 ? static_cast<int2*>(a.tree) : nullptr;
  long long tree_stride = p[3] > 0 ? p[3] / (long long)sizeof(int2) / p[0] : 0;
  int32_t *buf0 = a.buf0, *buf1 = a.buf1, *flags = a.flags, *status = a.status;
  void* args[] = {&pk0,  &qs,      &claimable, &lb,   &labm,        &absorb, &n_blocks,
                  &b,    &h,       &w,         &log2v, &packed,     &tree,   &tree_stride,
                  &buf0, &buf1,    &flags,     &status};
  return (int)cudaLaunchCooperativeKernel((const void*)relax_kernel<kAligned, I, P>,
                                          dim3((unsigned)p[0]), dim3(kThreads), args,
                                          (size_t)p[2], stream);
}

// The kernel for these operands: 32-bit indices where the stack has fewer
// than 2^31 pixels, the aligned round where W % 4 == 0, 16-bit packing up to
// 2^14 levels.
int dispatch(const Args& a, long long* plan_out, cudaStream_t stream) {
  if (a.b < 0 || a.h < 0 || a.w < 0 || a.lb < 1 || a.lb > 30 ||
      a.labm != (int32_t)((1u << a.lb) - 1) || a.absorb <= 0 || (a.absorb & a.labm) != 0 ||
      a.n_blocks < 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = a.b * a.h * a.w;
  const bool aligned = a.w % kVec == 0, narrow = (a.absorb >> a.lb) <= kNarrowLevels;
  if (n < (1LL << 31)) {
    if (aligned)
      return narrow ? run<true, uint32_t, uint16_t>(a, plan_out, stream)
                    : run<true, uint32_t, uint32_t>(a, plan_out, stream);
    return narrow ? run<false, uint32_t, uint16_t>(a, plan_out, stream)
                  : run<false, uint32_t, uint32_t>(a, plan_out, stream);
  }
  if (aligned)
    return narrow ? run<true, unsigned long long, uint16_t>(a, plan_out, stream)
                  : run<true, unsigned long long, uint32_t>(a, plan_out, stream);
  return narrow ? run<false, unsigned long long, uint16_t>(a, plan_out, stream)
                : run<false, unsigned long long, uint32_t>(a, plan_out, stream);
}

}  // namespace

// The launch's plan for b images of h x w at label bits `lb`, label mask
// `labm` and absorbing gate `absorb` on the current device, into out[5]: the
// grid, log2 of the lines a scan tile, the dynamic shared bytes, the bytes
// of global scratch the tree needs (0 when it fits in shared memory) and the
// packed bytes a pixel. Returns an error code (0 on success).
extern "C" int ark_minimax_relax_plan(int lb, int32_t labm, int32_t absorb, int b, int h, int w,
                                      long long* out) {
  Args a = {};
  a.lb = lb;
  a.labm = labm;
  a.absorb = absorb;
  a.b = b;
  a.h = h;
  a.w = w;
  return dispatch(a, out, nullptr);
}

// Launches the relaxation on `stream` as one cooperative kernel over b images
// of h x w pixels (contiguous device pointers): first keys `pk0` and shifted
// heights `qs` (int32, each a multiple of 2^lb below `absorb`), `claimable`
// (bool, one byte a pixel), the label bits `lb`, label mask `labm`, absorbing
// gate `absorb`; at most `n_blocks` blocks. Writes the packed heights to
// `packed` (b x h x w of the plan's width), keys to `buf0` and `buf1` (b x h x
// w int32 each, none aliasing an input), the tree to `tree` where the plan
// asks for `tree_bytes` of it; `flags`: 4 int32 the caller zeroes; `status`:
// 4 int32, the blocks run, which buffer holds the keys, 1 if the last probe
// changed nothing, 1 if a height was out of range (then nothing ran).
// Returns the launch's error code (0 when it was accepted; a grid the card
// cannot hold resident is refused). Does not synchronise.
extern "C" int ark_minimax_relax_launch(const int32_t* pk0, const int32_t* qs,
                                        const uint8_t* claimable, int lb, int32_t labm,
                                        int32_t absorb, int32_t n_blocks, int b, int h, int w,
                                        void* packed, void* tree, long long tree_bytes,
                                        int32_t* buf0, int32_t* buf1, int32_t* flags,
                                        int32_t* status, void* stream) {
  if (buf0 == buf1 || buf0 == pk0 || buf1 == pk0) return (int)cudaErrorInvalidValue;
  const Args a = {pk0,  qs,   claimable, lb,         labm, absorb, n_blocks, b,     h,
                  w,    packed, tree,    tree_bytes, buf0, buf1,   flags,    status};
  return dispatch(a, nullptr, static_cast<cudaStream_t>(stream));
}

extern "C" const char* ark_minimax_relax_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
