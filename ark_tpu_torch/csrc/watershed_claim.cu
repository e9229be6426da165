// Claim rounds of the level-scan watershed flood, written by hand for sm_90a:
// one synchronous round (claim_round_kernel), and every phase-A round of a
// run of levels in one cooperative launch (claim_levels_kernel).
//
// Replaces the TPU kernel ark_tpu/ops/watershed.py::_claim_band_kernel (and
// its launcher _claim_round_pallas), and the loop of rounds that
// ark_tpu/ops/watershed.py::_flood drives around it (its bfs_round scan).
// Labels are mask-encoded int32: -1 lies outside the mask, 0 is unlabeled,
// > 0 is a basin label. For a level l, a SOURCE is a pixel with lab > 0 and
// q <= l. Every unlabeled pixel (lab == 0) takes the minimum source label
// among its 4 neighbours; everything else keeps its label. -1 is never a
// source (-1 > 0 fails) and never claimed (-1 == 0 fails). A label of
// 2^31 - 1 counts as "no source", as the sentinel of the reference does.
// Both kernels count the pixels whose label changed.
//
// A round is synchronous: each output reads only the round's INPUT labels,
// so a round writes a separate array. Updating in place would turn a
// breadth-first round into a Gauss-Seidel sweep and hand ties to other
// owners.
//
// What bounds it on an H100: a round reads 8 bytes (lab, q) and writes 4
// bytes a pixel, with a few integer operations, so a round alone is
// memory-bound. The level scan runs ~600 rounds a flood: as one launch a
// round with the changed count read back by the host, the host's loop (a
// memset, a launch, a synchronising read each round) took several times the
// rounds' device time. claim_levels_kernel keeps the whole loop on the card:
// every block is resident (a cooperative launch sized by the occupancy
// query; a grid the card cannot hold is refused, never hung), rounds are
// separated by grid barriers, and after each barrier every thread reads the
// same changed count (one read a block, through shared memory) and takes the
// same decision: the next round, the next level, or exit (a level whose
// budget of rounds ran out, every round changing labels, is left to the
// caller's phase B). Labels ping-pong between two buffers (the first round
// reads the caller's labels, which are never written); with the levels, the
// state of the main path's cohorts (24-36 MiB) stays in the 50 MB L2 across
// rounds. The changed counts live in a ring of three device counters: round
// r adds into c[r % 3], and block 0 clears c[(r + 1) % 3] before the
// barrier, which every thread last read before it reached the previous
// barrier; one memset a launch, not a round. A round then costs its pass
// over the L2-resident state plus one grid barrier (of the same order on
// this card), and the pass's loads depend on one another (a label, then its
// level, then the neighbours of an unlabeled pixel). 512-thread blocks keep
// the barrier's block count at half of 256-thread ones with the same threads
// in flight.
//
// The round body (claim_chunk) is shared by both kernels. A thread takes 4
// consecutive pixels of the flat (B, H, W) stack: one 16-byte load of the
// labels (and of the levels, only where a label is > 0), the pixels left
// and right of its chunk from the neighbouring lanes by warp shuffle, the
// rows above and below as 16-byte loads where W % 4 == 0 (else one pixel
// at a time), and nothing of the neighbours where the chunk holds no
// unlabeled pixel. Labels are read through L2 only (ld.global.cg): the
// persistent kernel reads labels that other blocks wrote in the same launch,
// which a stale L1 line could hide. The changed count is summed per warp
// (__reduce_add_sync) and per block in shared memory, then one atomicAdd a
// block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;               // pixels a thread takes at once: 16 bytes
constexpr int32_t kSentinel = 2147483647;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int32_t source(int32_t lab, int32_t q, int32_t level) {
  return (lab > 0 && q <= level) ? lab : kSentinel;
}

// The source label of pixel i (kSentinel if it is none); its level is read
// only for a labeled pixel.
template <typename I>
__device__ __forceinline__ int32_t source_at(const int32_t* lab, const int32_t* q,
                                             I i, int32_t level) {
  const int32_t l = __ldcg(lab + i);
  return (l > 0 && __ldg(q + i) <= level) ? l : kSentinel;
}

// The labels of 4 pixels from a 16-byte aligned address, and their source
// labels in s.
__device__ __forceinline__ int4 sources4(const int32_t* lab, const int32_t* q,
                                         int32_t level, int32_t s[kVec]) {
  const int4 l = __ldcg(reinterpret_cast<const int4*>(lab));
  if (l.x > 0 || l.y > 0 || l.z > 0 || l.w > 0) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(q));
    s[0] = source(l.x, v.x, level);
    s[1] = source(l.y, v.y, level);
    s[2] = source(l.z, v.z, level);
    s[3] = source(l.w, v.w, level);
  } else {
    s[0] = s[1] = s[2] = s[3] = kSentinel;
  }
  return l;
}

// A pixel's claim from its own label and its neighbours' source labels
// (kSentinel past an edge).
__device__ __forceinline__ int32_t claim(int32_t own, int32_t up, int32_t down,
                                         int32_t left, int32_t right) {
  const int32_t cand = min(min(up, down), min(left, right));
  return (own == 0 && cand < kSentinel) ? cand : own;
}

// Claims the chunk of kVec pixels from p0 = kVec * chunk of the stack of n
// = B * H * W pixels (fewer at its end, none past it), writes their labels
// to out and returns how many changed. Every lane of a warp calls it at
// once, on consecutive chunks (lanes past the end too): the pixels beside a
// chunk come from the neighbouring lanes. kAligned: W % kVec == 0, so a
// chunk lies in one row, as do the chunks above and below it. I: the index
// type (32 bits where n < 2^31).
template <bool kAligned, typename I>
__device__ __forceinline__ int claim_chunk(const int32_t* __restrict__ lab,
                                           const int32_t* __restrict__ q,
                                           int32_t* __restrict__ out, int32_t level,
                                           I chunk, I n, I h, I w) {
  const int lane = threadIdx.x & 31;
  const I p0 = chunk * kVec;
  const bool full = p0 + kVec <= n;
  int32_t own[kVec], src[kVec];
  if (full) {
    const int4 l = sources4(lab + p0, q + p0, level, src);
    own[0] = l.x;
    own[1] = l.y;
    own[2] = l.z;
    own[3] = l.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      own[j] = p0 + j < n ? __ldcg(lab + p0 + j) : -1;
      src[j] = (own[j] > 0 && __ldg(q + p0 + j) <= level) ? own[j] : kSentinel;
    }
  }
  // the pixels just left and right of the chunk: the neighbouring lanes'
  int32_t left_end = __shfl_up_sync(kFull, src[kVec - 1], 1);
  int32_t right_end = __shfl_down_sync(kFull, src[0], 1);

  int32_t next[kVec] = {own[0], own[1], own[2], own[3]};
  if (own[0] == 0 || own[1] == 0 || own[2] == 0 || own[3] == 0) {
    const I row = p0 / w;
    const I x0 = p0 - row * w;
    if (lane == 0 && x0 > 0) left_end = source_at(lab, q, p0 - 1, level);
    if (lane == 31 && p0 + kVec < n) right_end = source_at(lab, q, p0 + kVec, level);
    int32_t up[kVec], down[kVec];
    if (kAligned) {
      const I y = row % h;
      if (y > 0) {
        sources4(lab + (p0 - w), q + (p0 - w), level, up);
      } else {
        up[0] = up[1] = up[2] = up[3] = kSentinel;
      }
      if (y + 1 < h) {
        sources4(lab + (p0 + w), q + (p0 + w), level, down);
      } else {
        down[0] = down[1] = down[2] = down[3] = kSentinel;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        up[j] = down[j] = kSentinel;
        const I p = p0 + j;
        if (p < n && own[j] == 0) {
          const I y = (p / w) % h;
          if (y > 0) up[j] = source_at(lab, q, p - w, level);
          if (y + 1 < h) down[j] = source_at(lab, q, p + w, level);
        }
      }
    }
    I x = x0;                           // column of pixel j
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int32_t left = x > 0 ? (j == 0 ? left_end : src[j - 1]) : kSentinel;
      const int32_t right =
          x + 1 < w ? (j == kVec - 1 ? right_end : src[j + 1]) : kSentinel;
      next[j] = claim(own[j], up[j], down[j], left, right);
      x = x + 1 == w ? 0 : x + 1;
    }
  }
  if (full) {
    *reinterpret_cast<int4*>(out + p0) = make_int4(next[0], next[1], next[2], next[3]);
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (p0 + j < n) out[p0 + j] = next[j];
    }
  }
  int changed = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) changed += next[j] != own[j];
  return changed;
}

// Adds the block's changed pixels (each thread's `mine`) into *counter:
// one shared atomic a warp, one global atomic a block. Leaves the block
// synchronised.
__device__ __forceinline__ void add_block_count(int mine, int* block_sum,
                                                int32_t* counter) {
  mine = __reduce_add_sync(kFull, mine);
  if ((threadIdx.x & 31) == 0 && mine != 0) atomicAdd(block_sum, mine);
  __syncthreads();
  if (threadIdx.x == 0 && *block_sum != 0) atomicAdd(counter, *block_sum);
}

template <bool kAligned, typename I>
__global__ void __launch_bounds__(kThreads)
claim_round_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ q,
                   int32_t level, I n, I h, I w, int32_t* __restrict__ out,
                   int32_t* __restrict__ changed) {
  __shared__ int block_sum;
  if (threadIdx.x == 0) block_sum = 0;
  __syncthreads();
  const I chunks = (n + kVec - 1) / kVec;
  const I stride = (I)gridDim.x * kThreads;
  const I lane = threadIdx.x & 31;
  int mine = 0;
  // the loop's bound is the warp's, so its lanes stay together for the shuffles
  for (I base = (I)blockIdx.x * kThreads + (threadIdx.x & ~31u); base < chunks;
       base += stride) {
    mine += claim_chunk<kAligned, I>(lab, q, out, level, base + lane, n, h, w);
  }
  add_block_count(mine, &block_sum, changed);
}

// status[0]: the level it stopped at (`levels` when every level converged,
// else the first level whose `bfs_rounds` rounds all changed labels);
// status[1]: the rounds it ran; status[2]: which buffer holds the labels
// (-1: the input, when no round ran). counts: 3 counters, zero at launch.
template <bool kAligned, typename I>
__global__ void __launch_bounds__(kThreads)
claim_levels_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ q,
                    int32_t level, int32_t levels, int32_t bfs_rounds, I n, I h, I w,
                    int32_t* buf0, int32_t* buf1, int32_t* counts, int32_t* status) {
  __shared__ int block_sum;
  __shared__ int32_t round_changed;
  cg::grid_group grid = cg::this_grid();
  const I chunks = (n + kVec - 1) / kVec;
  const I stride = (I)gridDim.x * kThreads;
  const I first = (I)blockIdx.x * kThreads + (threadIdx.x & ~31u);
  const I lane = threadIdx.x & 31;
  const int32_t* in = lab;
  int32_t* dst = buf0;
  int rounds = 0, in_level = 0, result = -1;
  while (bfs_rounds > 0 && level < levels) {
    if (threadIdx.x == 0) block_sum = 0;
    __syncthreads();
    int mine = 0;
    for (I base = first; base < chunks; base += stride) {
      mine += claim_chunk<kAligned, I>(in, q, dst, level, base + lane, n, h, w);
    }
    int32_t* const count = counts + rounds % 3;
    add_block_count(mine, &block_sum, count);
    if (blockIdx.x == 0 && threadIdx.x == 0) counts[(rounds + 1) % 3] = 0;
    grid.sync();
    // one read of the count a block, not a thread
    if (threadIdx.x == 0) round_changed = __ldcg(count);
    __syncthreads();
    const int32_t changed = round_changed;
    result = dst == buf0 ? 0 : 1;
    in = dst;
    dst = dst == buf0 ? buf1 : buf0;
    ++rounds;
    if (changed == 0) {
      ++level;
      in_level = 0;
    } else if (++in_level == bfs_rounds) {
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = level;
    status[1] = rounds;
    status[2] = result;
  }
}

template <bool kAligned, typename I>
int launch_round(const int32_t* lab, const int32_t* q, int32_t level, I n, I h, I w,
                 int32_t* out, int32_t* changed, cudaStream_t stream) {
  const long long chunks = ((long long)n + kVec - 1) / kVec;
  const long long blocks = (chunks + kThreads - 1) / kThreads;
  const unsigned grid = (unsigned)(blocks < (1 << 20) ? blocks : (1 << 20));
  claim_round_kernel<kAligned, I><<<grid, kThreads, 0, stream>>>(lab, q, level, n, h, w,
                                                                  out, changed);
  return (int)cudaGetLastError();
}

// The level-scan kernel's grid over n pixels: every block resident on the
// current device (the occupancy query), and no more blocks than the pixels
// need.
template <bool kAligned, typename I>
cudaError_t levels_grid(I n, unsigned* grid) {
  const void* kernel = (const void*)claim_levels_kernel<kAligned, I>;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const long long chunks = ((long long)n + kVec - 1) / kVec;
  const long long need = (chunks + kThreads - 1) / kThreads;
  const long long most = (long long)per_sm * sms;
  *grid = (unsigned)(need < 1 ? 1 : (need < most ? need : most));
  return cudaSuccess;
}

template <bool kAligned, typename I>
int launch_levels(const int32_t* lab, const int32_t* q, int32_t level, int32_t levels,
                  int32_t bfs_rounds, I n, I h, I w, int32_t* buf0, int32_t* buf1,
                  int32_t* counts, int32_t* status, cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = levels_grid<kAligned, I>(n, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&lab, &q,  &level, &levels, &bfs_rounds, &n,     &h,
                  &w,   &buf0, &buf1, &counts, &status};
  return (int)cudaLaunchCooperativeKernel((const void*)claim_levels_kernel<kAligned, I>,
                                          dim3(grid), dim3(kThreads), args, 0, stream);
}

bool bad_shape(int b, int h, int w) { return b < 0 || h < 0 || w < 0; }

}  // namespace

// Launches one claim round on `stream` over b images of h x w int32 labels
// `lab` and levels `q` (contiguous, 16-byte aligned device pointers),
// writing the new labels to `out` (not aliasing `lab`) and ADDING the
// number of changed pixels to `*changed` (the caller zeroes it). Returns
// cudaGetLastError() of the launch (0 when it was accepted). Does not
// synchronise.
extern "C" int ark_claim_round_launch(const int32_t* lab, const int32_t* q,
                                      int32_t level, int b, int h, int w,
                                      int32_t* out, int32_t* changed,
                                      void* stream) {
  if (bad_shape(b, h, w) || out == lab) return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || w == 0) return 0;
  const long long n = (long long)b * h * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < (1LL << 31)) {
    const uint32_t n32 = (uint32_t)n, h32 = (uint32_t)h, w32 = (uint32_t)w;
    return w % kVec == 0 ? launch_round<true>(lab, q, level, n32, h32, w32, out, changed, s)
                         : launch_round<false>(lab, q, level, n32, h32, w32, out, changed, s);
  }
  const unsigned long long n64 = n, h64 = h, w64 = w;
  return w % kVec == 0 ? launch_round<true>(lab, q, level, n64, h64, w64, out, changed, s)
                       : launch_round<false>(lab, q, level, n64, h64, w64, out, changed, s);
}

// Launches the claim rounds of levels `level`, `level` + 1, ... on `stream`
// as one cooperative kernel over b images of h x w labels `lab` and levels
// `q` (contiguous, 16-byte aligned device pointers; `lab` is only read).
// Each level runs rounds until a round changes nothing or `bfs_rounds`
// rounds have run; the launch ends at the first level whose rounds all
// changed labels, or after the last level. `buf0` and `buf1` hold b x h x w
// labels each; `counts` 3 int32 counters the caller zeroes; `status` 3
// int32: the stop level, the rounds run and which buffer holds the labels
// (-1: `lab`, when no round ran). Returns the launch's error code (0 when it
// was accepted; a grid the card cannot hold resident is refused). Does not
// synchronise.
extern "C" int ark_claim_levels_launch(const int32_t* lab, const int32_t* q,
                                       int32_t level, int32_t levels,
                                       int32_t bfs_rounds, int b, int h, int w,
                                       int32_t* buf0, int32_t* buf1, int32_t* counts,
                                       int32_t* status, void* stream) {
  if (bad_shape(b, h, w) || buf0 == lab || buf1 == lab || buf0 == buf1) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)b * h * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < (1LL << 31)) {
    const uint32_t n32 = (uint32_t)n, h32 = (uint32_t)h, w32 = (uint32_t)w;
    return w % kVec == 0
               ? launch_levels<true>(lab, q, level, levels, bfs_rounds, n32, h32, w32, buf0,
                                     buf1, counts, status, s)
               : launch_levels<false>(lab, q, level, levels, bfs_rounds, n32, h32, w32, buf0,
                                      buf1, counts, status, s);
  }
  const unsigned long long n64 = n, h64 = h, w64 = w;
  return w % kVec == 0
             ? launch_levels<true>(lab, q, level, levels, bfs_rounds, n64, h64, w64, buf0,
                                   buf1, counts, status, s)
             : launch_levels<false>(lab, q, level, levels, bfs_rounds, n64, h64, w64, buf0,
                                    buf1, counts, status, s);
}

extern "C" const char* ark_claim_round_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
