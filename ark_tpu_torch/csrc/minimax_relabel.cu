// The minimax flood's breadth-first re-labeling, written by hand for sm_90a:
// every round of it in one cooperative launch (relabel_kernel).
//
// Replaces no TPU kernel: the JAX package runs this loop as XLA code in a
// lax.scan / lax.cond (ark_tpu/ops/watershed.py::_flood_minimax), which XLA
// fuses. The port's plain version, ark_tpu_torch/ops/watershed.py::
// _refine_round, makes about twenty elementwise launches a round and a
// synchronising comparison every 16 rounds; a flood of a 4 x 1024^2 batch
// runs ~1,180 rounds, so the host's launches, not the rounds' few integer
// operations a pixel, set its time.
//
// What a round computes. After the relaxation every pixel p has a packed key
// pk(p) = value << lb | label (INT32_MAX: none) and a shifted height qs(p).
// An unlabeled claimable pixel with a key takes the minimum label > 0 among
// its 4-neighbours u whose exit value (u's key lifted to at least its height,
// value bits) equals p's value. Keys and heights do not change during the
// re-labeling, so which neighbours qualify is fixed: a first phase reduces a
// pixel's four tests to four bits of one byte (up 1, down 2, left 4, right 8;
// none past the image's edge, none for a pixel that cannot take a label), and
// a round reads only those bytes and the labels.
//
// The rounds stay synchronous, as the plain loop's: each reads only the labels
// its previous round wrote, ping-ponging between two buffers. Updating in
// place would let a pixel labelled in a round hand its label on in the same
// round (a Gauss-Seidel sweep), and ties would go to other owners.
//
// The stopping rule is the plain loop's: blocks of 16 rounds until a block
// changes nothing, at most n_blocks of them. Labels only go from 0 to a label,
// so once a round changes nothing every later round changes nothing too: the
// kernel stops at the first such round, or after 16 * n_blocks rounds, and
// reports the rounds it ran and whether the last one changed nothing; the
// wrapper (watershed._relabel_blocks) derives from them the block count and
// the flag the plain loop reports. When the budget runs out, the labels are
// those after exactly 16 * n_blocks rounds.
//
// What bounds it on an H100: a round reads 1 byte of bits and 4 of labels a
// pixel and writes 4 for a pixel with bits, ~38 MB at 4 x 1024^2, which stays
// in the 50 MB L2 across rounds; and a grid barrier a round. The design is
// claim_levels_kernel's (watershed_claim.cu): every block resident (a grid
// from the occupancy query; a grid the card cannot hold is refused, never
// hung), a grid barrier between rounds, after it one read of the round's
// changed flag a block and the same decision in every block, a ring of three
// flags each cleared a round ahead (one memset a launch). A thread takes 4
// consecutive pixels of the flat (B, H, W) stack: a 4-byte load of their bits,
// a 16-byte load of their labels, the pixels left and right of the chunk from
// the neighbouring lanes by warp shuffle, the rows above and below as 16-byte
// loads where W % 4 == 0 (else a pixel at a time), and those only where a
// pixel of the chunk still waits for a label and has a bit towards them.
// Labels are read through L2 only (ld.global.cg): other blocks wrote them in
// this launch. The bits of a chunk are written in the first phase by the
// thread that reads them in every round (both phases walk the same chunks),
// so they may come through L1. A chunk without bits never changes: the first
// phase copies its labels into both buffers, and no round writes it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kVec = 4;               // pixels a thread takes at once: 16 bytes
constexpr int32_t kSentinel = 2147483647;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kUp = 1, kDown = 2, kLeft = 4, kRight = 8;
constexpr uint32_t kEvery = 0x01010101u;   // a bit in each pixel's byte

// Pixel i's exit value: its key lifted to at least its height, value bits.
template <typename I>
__device__ __forceinline__ int32_t exit_value(const int32_t* pk, const int32_t* qs, I i,
                                              int lb, int32_t labm) {
  const int32_t k = __ldg(pk + i), s = __ldg(qs + i);
  return (k >= s ? k : (s | (k & labm))) >> lb;
}

// Pixel p's bits: the neighbours whose exit value equals its value, for a
// claimable pixel with a key; none for any other.
template <typename I>
__device__ __forceinline__ uint32_t edge_bits(const int32_t* pk, const int32_t* qs,
                                              const uint8_t* claimable, I p, I h, I w,
                                              int lb, int32_t labm) {
  const int32_t k = __ldg(pk + p);
  if (!__ldg(claimable + p) || k == kSentinel) return 0;
  const int32_t v = k >> lb;
  const I row = p / w;
  const I x = p - row * w, y = row % h;
  uint32_t e = 0;
  if (y > 0 && exit_value(pk, qs, p - w, lb, labm) == v) e |= kUp;
  if (y + 1 < h && exit_value(pk, qs, p + w, lb, labm) == v) e |= kDown;
  if (x > 0 && exit_value(pk, qs, p - 1, lb, labm) == v) e |= kLeft;
  if (x + 1 < w && exit_value(pk, qs, p + 1, lb, labm) == v) e |= kRight;
  return e;
}

// The first phase on the chunk of kVec pixels from p0 = kVec * chunk of the
// stack of n pixels: their bits, and their first labels into both buffers.
template <typename I>
__device__ __forceinline__ void setup_chunk(const int32_t* lab0, const int32_t* pk,
                                            const int32_t* qs, const uint8_t* claimable,
                                            int lb, int32_t labm, I chunk, I n, I h, I w,
                                            uint8_t* edges, int32_t* buf0, int32_t* buf1) {
  const I p0 = chunk * kVec;
  if (p0 + kVec <= n) {
    uint32_t e = 0;
    int32_t l[kVec];
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      e |= edge_bits(pk, qs, claimable, p0 + j, h, w, lb, labm) << (8 * j);
      l[j] = __ldg(lab0 + p0 + j);
    }
    *reinterpret_cast<uint32_t*>(edges + p0) = e;
    const int4 v = make_int4(l[0], l[1], l[2], l[3]);
    *reinterpret_cast<int4*>(buf0 + p0) = v;
    *reinterpret_cast<int4*>(buf1 + p0) = v;
  } else {
    for (I p = p0; p < n; ++p) {
      edges[p] = (uint8_t)edge_bits(pk, qs, claimable, p, h, w, lb, labm);
      buf0[p] = buf1[p] = __ldg(lab0 + p);
    }
  }
}

__device__ __forceinline__ int32_t label_or_none(int32_t l) { return l > 0 ? l : kSentinel; }

__device__ __forceinline__ int4 load4(const int32_t* p) {
  return __ldcg(reinterpret_cast<const int4*>(p));
}

// One round on the chunk of kVec pixels from p0 = kVec * chunk of the stack
// of n = B * H * W pixels (fewer at its end, none past it): labels from `in`,
// the chunk written to `out` where one of its pixels has bits; returns whether
// a label changed. Every lane of a warp calls it at once, on consecutive
// chunks (lanes past the end too): the pixels beside a chunk come from the
// neighbouring lanes. kAligned: W % kVec == 0, so a chunk lies in one row, as
// do the chunks above and below it. I: the index type (32 bits where n <
// 2^31). No bit points past the image, so a round needs no coordinates.
template <bool kAligned, typename I>
__device__ __forceinline__ bool relabel_chunk(const int32_t* __restrict__ in,
                                              const uint8_t* __restrict__ edges,
                                              int32_t* __restrict__ out, I chunk, I n, I w) {
  const int lane = threadIdx.x & 31;
  const I p0 = chunk * kVec;
  const bool full = p0 + kVec <= n;
  uint32_t e = 0;                       // pixel j's bits in byte j
  int32_t own[kVec];
  if (full) {
    e = *reinterpret_cast<const uint32_t*>(edges + p0);
    const int4 l = load4(in + p0);
    own[0] = l.x;
    own[1] = l.y;
    own[2] = l.z;
    own[3] = l.w;
  } else {
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const bool inside = p0 + j < n;
      own[j] = inside ? __ldcg(in + p0 + j) : 0;
      if (inside) e |= (uint32_t)edges[p0 + j] << (8 * j);
    }
  }
  // the pixels just left and right of the chunk: the neighbouring lanes'
  int32_t left_end = __shfl_up_sync(kFull, own[kVec - 1], 1);
  int32_t right_end = __shfl_down_sync(kFull, own[0], 1);

  // the bits of the pixels still waiting for a label
  uint32_t need = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    if (own[j] == 0) need |= e & (0xfu << (8 * j));
  }
  int32_t next[kVec] = {own[0], own[1], own[2], own[3]};
  bool changed = false;
  if (need != 0) {
    int32_t up[kVec] = {0, 0, 0, 0}, down[kVec] = {0, 0, 0, 0};
    if (kAligned) {
      if (need & (kEvery * kUp)) {
        const int4 u = load4(in + (p0 - w));
        up[0] = u.x;
        up[1] = u.y;
        up[2] = u.z;
        up[3] = u.w;
      }
      if (need & (kEvery * kDown)) {
        const int4 d = load4(in + (p0 + w));
        down[0] = d.x;
        down[1] = d.y;
        down[2] = d.z;
        down[3] = d.w;
      }
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const uint32_t b = need >> (8 * j);
        if (b & kUp) up[j] = __ldcg(in + (p0 + j - w));
        if (b & kDown) down[j] = __ldcg(in + (p0 + j + w));
      }
    }
    if (lane == 0 && (need & kLeft)) left_end = __ldcg(in + (p0 - 1));
    if (lane == 31 && (need & (kRight << (8 * (kVec - 1))))) {
      right_end = __ldcg(in + (p0 + kVec));
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const uint32_t b = need >> (8 * j);
      int32_t cand = kSentinel;
      if (b & kUp) cand = min(cand, label_or_none(up[j]));
      if (b & kDown) cand = min(cand, label_or_none(down[j]));
      if (b & kLeft) cand = min(cand, label_or_none(j == 0 ? left_end : own[j - 1]));
      if (b & kRight) {
        cand = min(cand, label_or_none(j == kVec - 1 ? right_end : own[j + 1]));
      }
      if (cand < kSentinel) {
        next[j] = cand;
        changed = true;
      }
    }
  }
  if (e != 0) {
    if (full) {
      *reinterpret_cast<int4*>(out + p0) = make_int4(next[0], next[1], next[2], next[3]);
    } else {
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        if (p0 + j < n) out[p0 + j] = next[j];
      }
    }
  }
  return changed;
}

// status[0]: the rounds run; status[1]: which buffer holds the labels;
// status[2]: 1 if the last round changed nothing. flags: 3 ints, zero at
// launch.
template <bool kAligned, typename I>
__global__ void __launch_bounds__(kThreads)
relabel_kernel(const int32_t* __restrict__ lab0, const int32_t* __restrict__ pk,
               const int32_t* __restrict__ qs, const uint8_t* __restrict__ claimable, int lb,
               int32_t labm, int32_t max_rounds, I n, I h, I w, uint8_t* edges, int32_t* buf0,
               int32_t* buf1, int32_t* flags, int32_t* status) {
  __shared__ int32_t round_changed;
  cg::grid_group grid = cg::this_grid();
  const I chunks = (n + kVec - 1) / kVec;
  const I stride = (I)gridDim.x * kThreads;
  const I first = (I)blockIdx.x * kThreads + (threadIdx.x & ~31u);
  const I lane = threadIdx.x & 31;
  for (I chunk = first + lane; chunk < chunks; chunk += stride) {
    setup_chunk<I>(lab0, pk, qs, claimable, lb, labm, chunk, n, h, w, edges, buf0, buf1);
  }
  grid.sync();
  // both buffers hold the first labels: the first round reads buf1
  const int32_t* in = buf1;
  int32_t* dst = buf0;
  int rounds = 0, which = 1, converged = 0;
  while (rounds < max_rounds) {
    bool mine = false;
    // the loop's bound is the warp's, so its lanes stay together for the shuffles
    for (I base = first; base < chunks; base += stride) {
      mine |= relabel_chunk<kAligned, I>(in, edges, dst, base + lane, n, w);
    }
    int32_t* const flag = flags + rounds % 3;
    if (__syncthreads_or(mine) && threadIdx.x == 0) atomicOr(flag, 1);
    if (blockIdx.x == 0 && threadIdx.x == 0) flags[(rounds + 1) % 3] = 0;
    grid.sync();
    // one read of the flag a block, not a thread
    if (threadIdx.x == 0) round_changed = __ldcg(flag);
    __syncthreads();
    const int32_t changed = round_changed;
    which = dst == buf0 ? 0 : 1;
    in = dst;
    dst = dst == buf0 ? buf1 : buf0;
    ++rounds;
    if (changed == 0) {
      converged = 1;
      break;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    status[0] = rounds;
    status[1] = which;
    status[2] = converged;
  }
}

// The kernel's grid over n pixels: every block resident on the current
// device (the occupancy query), and no more blocks than the pixels need.
template <bool kAligned, typename I>
cudaError_t relabel_grid(I n, unsigned* grid) {
  const void* kernel = (const void*)relabel_kernel<kAligned, I>;
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
int launch(const int32_t* lab0, const int32_t* pk, const int32_t* qs,
           const uint8_t* claimable, int lb, int32_t labm, int32_t max_rounds, I n, I h, I w,
           uint8_t* edges, int32_t* buf0, int32_t* buf1, int32_t* flags, int32_t* status,
           cudaStream_t stream) {
  unsigned grid = 0;
  const cudaError_t err = relabel_grid<kAligned, I>(n, &grid);
  if (err != cudaSuccess) return (int)err;
  void* args[] = {&lab0, &pk, &qs, &claimable, &lb,   &labm,  &max_rounds, &n,
                  &h,    &w,  &edges, &buf0, &buf1, &flags, &status};
  return (int)cudaLaunchCooperativeKernel((const void*)relabel_kernel<kAligned, I>,
                                          dim3(grid), dim3(kThreads), args, 0, stream);
}

}  // namespace

// Launches the re-labeling on `stream` as one cooperative kernel over b
// images of h x w pixels (contiguous device pointers): first labels `lab0`,
// keys `pk` and shifted heights `qs` (int32), `claimable` (bool, one byte a
// pixel), the label bits `lb` and label mask `labm`; at most `max_rounds`
// rounds, stopping at the first that changes nothing. Writes b x h x w bytes
// of bits to `edges`, labels to `buf0` and `buf1` (b x h x w int32 each, none
// aliasing an input); `flags`: 3 int32 the caller zeroes; `status`: 3 int32,
// the rounds run, which buffer holds the labels and 1 if the last round
// changed nothing. Returns the launch's error code (0 when it was accepted; a
// grid the card cannot hold resident is refused). Does not synchronise.
extern "C" int ark_minimax_relabel_launch(const int32_t* lab0, const int32_t* pk,
                                          const int32_t* qs, const uint8_t* claimable, int lb,
                                          int32_t labm, int32_t max_rounds, int b, int h,
                                          int w, uint8_t* edges, int32_t* buf0, int32_t* buf1,
                                          int32_t* flags, int32_t* status, void* stream) {
  if (b < 0 || h < 0 || w < 0 || lb < 1 || lb > 30 || max_rounds < 0 || buf0 == buf1 ||
      buf0 == lab0 || buf1 == lab0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)b * h * w;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < (1LL << 31)) {
    const uint32_t n32 = (uint32_t)n, h32 = (uint32_t)h, w32 = (uint32_t)w;
    return w % kVec == 0
               ? launch<true>(lab0, pk, qs, claimable, lb, labm, max_rounds, n32, h32, w32,
                              edges, buf0, buf1, flags, status, s)
               : launch<false>(lab0, pk, qs, claimable, lb, labm, max_rounds, n32, h32, w32,
                               edges, buf0, buf1, flags, status, s);
  }
  const unsigned long long n64 = n, h64 = h, w64 = w;
  return w % kVec == 0
             ? launch<true>(lab0, pk, qs, claimable, lb, labm, max_rounds, n64, h64, w64,
                            edges, buf0, buf1, flags, status, s)
             : launch<false>(lab0, pk, qs, claimable, lb, labm, max_rounds, n64, h64, w64,
                             edges, buf0, buf1, flags, status, s);
}

extern "C" const char* ark_minimax_relabel_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
