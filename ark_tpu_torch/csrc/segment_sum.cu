// Deterministic segmented sum of per-pixel rows, written by hand for sm_90a.
//
// Replaces the XLA scatter behind jax.ops.segment_sum in
// ark_tpu/ops/segment_reduce.py:44 (cell_sizes, channel_sums, the centroid
// and central-moment passes, Crofton and Euler sums). That is not a Pallas
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
// caller reads it, and one warp walking half a FOV would take milliseconds.
// Labels outside [0, num_segments) are dropped, as jax.ops.segment_sum drops
// them. No float atomics, no host synchronisation.
//
// Two launches, both on the caller's stream:
// - the plan, once per label image: each segment's bounding box (first and
//   last row and column) from integer atomicMin/atomicMax, which give the same
//   box whatever their order. A warp reads 32 neighbouring pixels of one row;
//   a shuffle finds where each run of one label starts and ends, and only
//   those lanes issue atomics (first row, last row and first column at the
//   start, last column at the end). Every sum over that image reuses it.
// - the walk: one warp per segment. It scans the box in raster order, which
//   is ascending pixel order, 1024 box pixels at a time: the lanes load the
//   labels together (coalesced along the rows), and a ballot per 32 pixels
//   compacts the matching pixel indices, in order, into shared memory. The
//   lanes then stage those pixels' rows of values into shared memory
//   together (cp.async, 16 bytes a copy where K is a multiple of 4, else 4,
//   so the loads of a whole chunk are in flight at once and the rows of a run
//   of pixels are read contiguously), double-buffered: the next chunk's
//   loads are issued before the current chunk's adds. Lane c then adds
//   column c (and c + 32, c + 64, c + 96) of the chunk in order. Columns are
//   walked in tiles of 128.
//
// What bounds it on an H100: the walk must read each foreground pixel's K
// values once (one dense 1024^2 FOV, 58% foreground: 107 MB at K = 44, 7.3 MB
// at K = 3) plus the labels of each box, 4 bytes per box pixel, so it is
// bound by HBM bandwidth (33 us at K = 44 for values and labels). To come
// near it, a warp keeps up to two chunks of values in flight (9.4 KB each),
// the adds are a short dependent chain per lane that overlaps the next
// chunk's loads, and the plan needs no sort (a stable sort of the labels
// alone takes longer than the plan and the walk together). The
// sizes were tuned on an H100: 16-byte copies cut the instructions per
// byte fourfold, and two warps a block with 9.4 KB buffers (46.6 KB of
// static shared memory a block, four blocks an SM) keep more bytes in
// flight per segment than four warps with smaller ones; a third buffer did
// not help. At small K (the centroid pass, K = 3) the walk is not bound by
// bytes: a FOV's segments run in one wave of warps, and each warp's time is
// the latency of its serial steps over its box (label loads, ballots,
// copies, adds). Lanes past K idle during the adds; sharing a warp among
// several segments would fill them, but the adds are not what a warp waits
// on there, so it is not done.
//
// Cost model: the walk reads (box area) x 4 bytes of labels and (cell area)
// x K x 4 bytes of values per segment. For compact cells box area / cell area
// is ~1.3-1.6; an elongated diagonal cell of length L and width w has a box
// ~L^2 / 2 against an area ~L w, a ratio ~L / (2 w), which costs label reads
// (and ballot work) but no extra value reads. Segment lengths differ ~10x; a
// warp per segment lets the scheduler fill the card with the short ones while
// the long ones run, and no warp waits for another.

#include <climits>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 2;                 // warps (segments) per block
constexpr int kThreads = kWarps * 32;
constexpr int kPix = 1024;                // box pixels scanned per step
constexpr int kPixPerLane = kPix / 32;
constexpr int kStages = 2;                // value buffers per warp (chunks in flight)
constexpr int kBuf = 2400;                // floats per value buffer
constexpr int kColTile = 128;             // columns walked at once
constexpr int kColRegs = kColTile / 32;
constexpr int kPlanThreads = 256;

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Boxes start empty: first row and column INT_MAX, last -1.
__global__ void __launch_bounds__(kPlanThreads)
box_init_kernel(int4* __restrict__ boxes, int num_segments) {
  const long long s = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  if (s < num_segments) boxes[s] = make_int4(INT_MAX, -1, INT_MAX, -1);
}

// boxes[s] = (first row, last row, first column, last column) of label s,
// for labels in [1, num_segments). Block (x, y) reads columns [x * kPlanThreads,
// (x + 1) * kPlanThreads) of rows y, y + gridDim.y, ...; a warp's lanes share
// a row. Every lane of a warp runs the same iterations, so the shuffles see
// the full warp.
__global__ void __launch_bounds__(kPlanThreads)
box_kernel(const int* __restrict__ labels, int rows, int w, int num_segments,
           int* __restrict__ boxes) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int l = c < w ? __ldg(labels + (long long)r * w + c) : 0;
    const int prev = __shfl_up_sync(full, l, 1);
    const int next = __shfl_down_sync(full, l, 1);
    if (l <= 0 || l >= num_segments) continue;
    int* b = boxes + 4LL * l;
    if (lane == 0 || prev != l) {   // the first pixel of a run of l
      atomicMin(b, r);
      atomicMax(b + 1, r);
      atomicMin(b + 2, (int)c);
    }
    if (lane == 31 || next != l) atomicMax(b + 3, (int)c);   // the last pixel of the run
  }
}

// Writes into pix, in raster order, the pixel index of every position
// [q0, q0 + count) of the box (first row r0, first column c0, width bw)
// whose label is s; returns how many (the same on every lane).
__device__ __forceinline__ int compact_box(int* pix, const int* __restrict__ labels, int s,
                                           int r0, int c0, int bw, int w, long long q0,
                                           int count, int lane) {
  int lab[kPixPerLane];
  int p[kPixPerLane];
  const long long q = q0 + lane;
  int r = (int)(q / bw);
  int c = (int)(q - (long long)r * bw);
  const int dr = 32 / bw;
  const int dc = 32 - dr * bw;
#pragma unroll
  for (int t = 0; t < kPixPerLane; ++t) {
    p[t] = (r0 + r) * w + c0 + c;
    lab[t] = lane + 32 * t < count ? __ldg(labels + p[t]) : -1;
    c += dc;
    r += dr;
    if (c >= bw) {
      c -= bw;
      ++r;
    }
  }
  const unsigned below = (1u << lane) - 1u;
  int found = 0;
#pragma unroll
  for (int t = 0; t < kPixPerLane; ++t) {
    const bool hit = lab[t] == s;
    const unsigned ballot = __ballot_sync(0xffffffffu, hit);
    if (hit) pix[found + __popc(ballot & below)] = p[t];
    found += __popc(ballot);
  }
  return found;
}

// Issues the copies of columns [k0, k0 + kt) of the rows of pixels
// pix[j0 .. j0 + m) into dst (m x kt, row-major), then commits them as one
// group. With vec4 (k, k0 and kt multiples of 4, values 16-byte aligned) a
// lane copies 16 bytes at a time, else 4.
__device__ __forceinline__ void stage(float* dst, const int* pix, int j0, int m,
                                      const float* __restrict__ values, int k, int k0,
                                      int kt, bool vec4, int lane) {
  const int width = vec4 ? kt / 4 : kt;    // copies per pixel row
  const int total = m * width;
  const int dj = 32 / width;
  const int dc = 32 - dj * width;
  int j = lane / width;
  int c = lane - j * width;
  for (int f = lane; f < total; f += 32) {
    const float* src = values + (long long)pix[j0 + j] * k + k0;
    if (vec4) {
      cp_async16(dst + 4 * f, src + 4 * c);
    } else {
      cp_async4(dst + f, src + c);
    }
    j += dj;
    c += dc;
    if (c >= width) {
      c -= width;
      ++j;
    }
  }
  cp_async_commit();
}

// Adds columns [k0, k0 + kt) of the rows of pixels pix[0 .. n), in that
// order, into acc (lane c holds columns c, c + 32, ...). A ring of kStages
// buffers: the copies of the next kStages - 1 chunks are in flight while a
// chunk is added. Every step commits one group (empty past the end), so
// waiting for all but the newest kStages - 1 groups waits for this chunk.
__device__ __forceinline__ void walk_pixels(const int* pix, int n,
                                            const float* __restrict__ values, int k, int k0,
                                            int kt, bool vec4, float* bufs,
                                            float (&acc)[kColRegs], int lane) {
  const int per = kBuf / kt;
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i * per < n) {
      stage(bufs + i * kBuf, pix, i * per, min(per, n - i * per), values, k, k0, kt, vec4,
            lane);
    } else {
      cp_async_commit();
    }
  }
  for (int chunk = 0, j0 = 0; j0 < n; ++chunk, j0 += per) {
    const int ahead = j0 + (kStages - 1) * per;
    if (ahead < n) {
      stage(bufs + ((chunk + kStages - 1) % kStages) * kBuf, pix, ahead,
            min(per, n - ahead), values, k, k0, kt, vec4, lane);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncwarp();
    const float* cur = bufs + (chunk % kStages) * kBuf;
    const int m = min(per, n - j0);
#pragma unroll
    for (int t = 0; t < kColRegs; ++t) {
      const int c = lane + 32 * t;
      if (c < kt) {
        float a = acc[t];
#pragma unroll 8
        for (int j = 0; j < m; ++j) a = __fadd_rn(a, cur[j * kt + c]);
        acc[t] = a;
      }
    }
    __syncwarp();  // every lane is done with cur before it is refilled
  }
}

__global__ void __launch_bounds__(kThreads)
segment_walk_kernel(const float* __restrict__ values, int k, int num_segments,
                    const int* __restrict__ labels, int w, const int4* __restrict__ boxes,
                    bool vec4, float* __restrict__ out) {
  __shared__ int pix_all[kWarps][kPix];
  __shared__ __align__(16) float buf_all[kWarps][kStages * kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= num_segments) return;  // the whole warp: no block-wide barrier follows
  int* pix = pix_all[warp];
  float* bufs = buf_all[warp];
  const int4 box = s == 0 ? make_int4(1, 0, 1, 0) : boxes[s];  // row 0 stays zero
  const int bw = box.w - box.z + 1;
  const long long area = box.x <= box.y ? (long long)(box.y - box.x + 1) * bw : 0;
  for (int k0 = 0; k0 < k; k0 += kColTile) {
    const int kt = min(kColTile, k - k0);
    float acc[kColRegs];
#pragma unroll
    for (int t = 0; t < kColRegs; ++t) acc[t] = 0.0f;
    for (long long q0 = 0; q0 < area; q0 += kPix) {
      const int count = (int)min((long long)kPix, area - q0);
      const int n = compact_box(pix, labels, s, box.x, box.z, bw, w, q0, count, lane);
      __syncwarp();
      walk_pixels(pix, n, values, k, k0, kt, vec4, bufs, acc, lane);
    }
#pragma unroll
    for (int t = 0; t < kColRegs; ++t) {
      const int c = lane + 32 * t;
      if (c < kt) out[(long long)s * k + k0 + c] = acc[t];
    }
  }
}

}  // namespace

// Builds the plan of a label image on `stream`: labels (n,) int32, the image's
// rows of width w (n = rows * w < 2^31), boxes (num_segments, 4) int32, all
// contiguous device pointers. Returns cudaGetLastError() of the launches (0
// when they were accepted). Does not synchronise.
extern "C" int ark_segment_plan_launch(const int* labels, long long n, int w,
                                       int num_segments, int* boxes, void* stream) {
  if (n < 0 || n > INT_MAX || w <= 0 || n % w != 0 || num_segments < 1) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long init_blocks = ((long long)num_segments + kPlanThreads - 1) / kPlanThreads;
  box_init_kernel<<<(unsigned)init_blocks, kPlanThreads, 0, st>>>(
      reinterpret_cast<int4*>(boxes), num_segments);
  const int rows = (int)(n / w);
  if (rows > 0) {
    // about 16 blocks an SM, each reading one run of columns of a few rows
    const int col_blocks = (int)(((long long)w + kPlanThreads - 1) / kPlanThreads);
    const int row_blocks = max(1, min(min(rows, 65535), 132 * 16 / col_blocks));
    box_kernel<<<dim3(col_blocks, row_blocks), kPlanThreads, 0, st>>>(labels, rows, w,
                                                                       num_segments, boxes);
  }
  return (int)cudaGetLastError();
}

// Launches the segmented sum on `stream`: values (n, k) f32 row-major, labels
// (n,) int32 and the plan's boxes (num_segments, 4) int32 of the same image
// (rows of width w), out (num_segments, k) f32, all contiguous device
// pointers. Returns cudaGetLastError() of the launch (0 when it was
// accepted). Does not synchronise.
extern "C" int ark_segment_sum_launch(const float* values, const int* labels, int w,
                                      const int* boxes, int num_segments, int k, float* out,
                                      void* stream) {
  if (num_segments < 1 || k < 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  const long long blocks = ((long long)num_segments + kWarps - 1) / kWarps;
  segment_walk_kernel<<<(unsigned)blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      values, k, num_segments, labels, w, reinterpret_cast<const int4*>(boxes),
      k % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0, out);
  return (int)cudaGetLastError();
}

extern "C" const char* ark_segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
