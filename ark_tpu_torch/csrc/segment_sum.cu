// Deterministic segmented sum of per-pixel rows, written by hand for sm_90a.
//
// Replaces the XLA scatter behind jax.ops.segment_sum in
// ark_tpu/ops/segment_reduce.py (cell_sizes, channel_sums, the centroid and
// central-moment passes, Crofton and Euler sums). That is not a Pallas
// kernel; it needs a kernel here because a float scatter-add on CUDA
// (index_add_, scatter_add_) uses atomics, so its summation order, and with it
// the last bits of every cell-table number, changes from run to run. The
// cell table's contract is bitwise.
//
// What it computes: out[s, k] = sum of values[i, k] over the pixels i with
// labels[i] == s, accumulated in ASCENDING pixel order, one correctly rounded
// f32 add at a time, starting from +0.0. That is the order of a sequential
// scatter (np.add.at, torch's CPU index_add_, XLA's CPU scatter), so the sums
// are bitwise equal to those. Row 0 (background) is written as zero: no
// caller reads it, and one thread walking half a FOV would take milliseconds.
//
// Inputs: the wrapper's CSR view of the labels, built with integer ops only:
// `order` holds the pixel indices stably sorted by label (pixel order kept
// within a label), and `offsets` (num_segments + 1 entries) the start of
// each segment in `order`. Pixels whose label lies outside
// [0, num_segments) sit outside every segment's range and are dropped, as
// jax.ops.segment_sum drops them.
//
// What bounds it on an H100: every foreground value is read once (at most
// N * K * 4 bytes: 12.6 MB per 1024^2 FOV at K = 3, 185 MB at K = 44) through
// a gather by `order`, and each thread's adds form one dependent chain as
// long as its cell (a few hundred pixels): it is bound by latency more than
// by bandwidth. The design is the simple one: one thread per (segment,
// column), neighbouring threads on neighbouring columns of one segment, so a
// warp reads one pixel's row contiguously; the loop is unrolled so that
// several loads are in flight ahead of the serial adds. No FMA can form
// (the loop only adds), and the add is written as __fadd_rn to say so.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const float* __restrict__ values, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets, int num_segments, int k,
                   float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (long long)num_segments * k) return;
  const int s = (int)(t / k);
  const int col = (int)(t % k);
  float acc = 0.0f;
  if (s != 0) {
    const int64_t begin = __ldg(offsets + s);
    const int64_t end = __ldg(offsets + s + 1);
    int64_t i = begin;
    for (; i + kUnroll <= end; i += kUnroll) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        v[u] = __ldg(values + __ldg(order + i + u) * k + col);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc = __fadd_rn(acc, v[u]);
    }
    for (; i < end; ++i) acc = __fadd_rn(acc, __ldg(values + __ldg(order + i) * k + col));
  }
  out[t] = acc;
}

}  // namespace

// Launches the segmented sum on `stream`: `values` (n, k) f32 row-major,
// `order` (n,) int64 pixel indices sorted stably by label, `offsets`
// (num_segments + 1,) int64, `out` (num_segments, k) f32, all contiguous
// device pointers. Returns cudaGetLastError() of the launch (0 when it was
// accepted). Does not synchronise.
extern "C" int ark_segment_sum_launch(const float* values, const int64_t* order,
                                      const int64_t* offsets, int num_segments, int k,
                                      float* out, void* stream) {
  if (num_segments < 0 || k < 0) return (int)cudaErrorInvalidValue;
  const long long total = (long long)num_segments * k;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647LL) return (int)cudaErrorInvalidValue;
  segment_sum_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, order, offsets, num_segments, k, out);
  return (int)cudaGetLastError();
}

extern "C" const char* ark_segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
