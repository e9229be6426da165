// One synchronous claim round of the level-scan watershed flood, written by
// hand for sm_90a.
//
// Replaces the TPU kernel ark_tpu/ops/watershed.py::_claim_band_kernel (and
// its launcher _claim_round_pallas). Labels are mask-encoded int32: -1 lies
// outside the mask, 0 is unlabeled, > 0 is a basin label. For a level l, a
// SOURCE is a pixel with lab > 0 and q <= l. Every unlabeled pixel (lab == 0)
// takes the minimum source label among its 4 neighbours; everything else
// keeps its label. -1 is never a source (-1 > 0 fails) and never claimed
// (-1 == 0 fails). A label of 2^31 - 1 counts as "no source", as the
// sentinel of the reference does. The kernel also counts the pixels whose
// label changed.
//
// The round is synchronous: each output reads only the INPUT labels, so the
// kernel writes a separate output array. Updating in place would turn a
// breadth-first round into a Gauss-Seidel sweep and hand ties to other
// owners.
//
// What bounds it on an H100: it reads 8 bytes (lab, q) and writes 4 bytes per
// pixel, plus neighbour reads that hit L1/L2; a few integer operations per
// pixel, so it is memory-bound (3 x 1024^2 pixels: ~38 MB of traffic, ~11 us
// at 3.35 TB/s). The TPU kernel's row bands with halos, its W % 128 == 0
// constraint and its per-band count slots were for VMEM tiling and carry no
// meaning here. The design is the simple one: one thread per pixel on a
// 32 x 8 block, so a warp reads 32 consecutive pixels of a row (coalesced);
// neighbours come through the read-only data cache; the changed count is
// reduced per warp with a ballot and summed per block in shared memory, then
// one atomicAdd per block goes into the device counter that the caller
// zeroes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;
constexpr int32_t kSentinel = 2147483647;

__device__ __forceinline__ int32_t source_label(const int32_t* __restrict__ lab,
                                                const int32_t* __restrict__ q,
                                                long long i, int32_t level) {
  const int32_t l = __ldg(lab + i);
  return (l > 0 && __ldg(q + i) <= level) ? l : kSentinel;
}

__global__ void __launch_bounds__(kBlockX * kBlockY)
claim_round_kernel(const int32_t* __restrict__ lab, const int32_t* __restrict__ q,
                   int32_t level, int h, int w, int32_t* __restrict__ out,
                   int32_t* __restrict__ changed) {
  __shared__ int32_t block_changed;
  const int x = blockIdx.x * kBlockX + threadIdx.x;
  const int y = blockIdx.y * kBlockY + threadIdx.y;
  const int tid = threadIdx.y * kBlockX + threadIdx.x;
  if (tid == 0) block_changed = 0;
  __syncthreads();

  bool did_change = false;
  if (x < w && y < h) {
    const long long plane = (long long)h * w;
    const long long i = (long long)blockIdx.z * plane + (long long)y * w + x;
    const int32_t own = __ldg(lab + i);
    int32_t next = own;
    if (own == 0) {
      int32_t cand = kSentinel;
      if (y > 0) cand = min(cand, source_label(lab, q, i - w, level));
      if (y < h - 1) cand = min(cand, source_label(lab, q, i + w, level));
      if (x > 0) cand = min(cand, source_label(lab, q, i - 1, level));
      if (x < w - 1) cand = min(cand, source_label(lab, q, i + 1, level));
      if (cand < kSentinel) next = cand;
    }
    out[i] = next;
    did_change = next != own;
  }
  // every thread of the warp takes part in the ballot, live or not
  const unsigned votes = __ballot_sync(0xffffffffu, did_change);
  if ((tid & 31) == 0 && votes != 0) atomicAdd(&block_changed, __popc(votes));
  __syncthreads();
  if (tid == 0 && block_changed != 0) atomicAdd(changed, block_changed);
}

}  // namespace

// Launches one claim round on `stream` over b images of h x w int32 labels
// `lab` and levels `q` (contiguous, device pointers), writing the new labels
// to `out` (not aliasing `lab`) and ADDING the number of changed pixels to
// `*changed` (the caller zeroes it). Returns cudaGetLastError() of the launch
// (0 when it was accepted). Does not synchronise.
extern "C" int ark_claim_round_launch(const int32_t* lab, const int32_t* q,
                                      int32_t level, int b, int h, int w,
                                      int32_t* out, int32_t* changed,
                                      void* stream) {
  if (b < 0 || h < 0 || w < 0 || b > 65535 || (h + kBlockY - 1) / kBlockY > 65535 ||
      out == lab) {
    return (int)cudaErrorInvalidValue;
  }
  if (b == 0 || h == 0 || w == 0) return 0;
  const dim3 block(kBlockX, kBlockY);
  const dim3 grid((unsigned)((w + kBlockX - 1) / kBlockX),
                  (unsigned)((h + kBlockY - 1) / kBlockY), (unsigned)b);
  claim_round_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      lab, q, level, h, w, out, changed);
  return (int)cudaGetLastError();
}

extern "C" const char* ark_claim_round_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
