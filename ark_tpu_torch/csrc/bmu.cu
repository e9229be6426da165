// Best-matching-unit (BMU) search of the pixel SOM, written by hand for sm_90a.
//
// Replaces the TPU kernels ark_tpu/ops/som.py::_bmu_packed_kernel_idx (index
// only) and ark_tpu/ops/som.py::_bmu_packed_kernel (index and distance; here
// the `with_dist` flag of the same kernel, one more store). For each data row
// x of X (N x C, f32) and the SOM weights W (K x C, f32) with node norms
// w2[k] = |w_k|^2 (computed by the caller):
//
//   d_k  = w2[k] - 2 * dot(x, w_k)   dot: fmaf over the channels in order, f32
//   idx  = argmin_k d_k              strict <, so the lowest index wins ties
//   dist = max(d_idx + |x|^2, 0)     with_dist only
//
// What bounds it on an H100: at the pixel stage's shape (N = 4,194,304, C = 16,
// K = 100) it reads 268 MB of pixels and issues 13.4 GFLOP of f32 FMA, about
// 47 FLOP per byte. The card's f32 CUDA-core ridge is ~67 TFLOP/s over
// 3.35 TB/s, about 20 FLOP per byte, so the kernel is bound by FMA issue
// (0.200 ms at that shape) and not by memory (the TPU kernel was bound by
// HBM). Every operand of the FMA chain stays on chip: the node table,
// zero-padded to the register width, sits in shared memory with the node
// norms (staged in chunks, so any K fits).
//
// Register blocking, as in an SGEMM micro-kernel: each thread owns R rows,
// held in registers at a width CT that is C rounded up to a multiple of 4
// (the padding multiplies zeros: fmaf(0, 0, acc) == acc, so every dot product
// is unchanged, and a width of 20 for the cell SOM's C = 20 wastes nothing).
// A node's row is read from shared memory once, as float4 broadcasts (every
// lane of a warp reads the same address), and each float4 feeds 4 R FMAs, so
// the shared-memory pipe does not pace the FMA pipe (with one row a thread
// it would: one LDS.128 per 4 FMAs). R falls as CT grows, to keep the rows
// in registers without spilling. The blocking leaves each (row, node) pair's
// operations and their order as above, so the indices and distances do not
// depend on R or on the register width. Rows wider than 64 read both operands
// through the L1 cache instead. No tensor cores: TF32 would break the f32
// contract, and a 3xTF32 split on wgmma changes the rounding (later work).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNodeChunk = 128;

template <int CT>
__host__ __device__ constexpr int rows_per_thread() {
  return CT <= 8 ? 8 : CT <= 20 ? 4 : CT <= 40 ? 2 : 1;
}

template <int CT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kNodeChunk * CT + kNodeChunk);
}

// Rows of `CT` floats for nodes [k0, k0 + kn), channels past c set to zero,
// and the nodes' norms.
template <int CT>
__device__ void stage_nodes(float* wt, float* w2s, const float* __restrict__ w,
                            const float* __restrict__ w2, int k0, int kn, int c) {
  for (int i = threadIdx.x; i < kn * CT; i += blockDim.x) {
    const int node = i / CT;
    const int j = i - node * CT;
    wt[i] = j < c ? w[(long long)(k0 + node) * c + j] : 0.0f;
  }
  for (int i = threadIdx.x; i < kn; i += blockDim.x) w2s[i] = w2[k0 + i];
}

// Thread t of a block owns rows base + t + r * kThreads, r < R, so that each
// load instruction of a warp covers 32 neighbouring rows.
template <int CT, bool WITH_DIST>
__global__ void __launch_bounds__(kThreads)
bmu_regs_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ w2, long long n, int c, int k, int vec4,
                int32_t* __restrict__ idx, float* __restrict__ dist) {
  constexpr int R = rows_per_thread<CT>();
  extern __shared__ __align__(16) float smem[];
  float* wt = smem;
  float* w2s = smem + kNodeChunk * CT;
  const long long base = (long long)blockIdx.x * (kThreads * R) + threadIdx.x;

  float xr[R][CT];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = base + (long long)r * kThreads;
#pragma unroll
    for (int j = 0; j < CT; ++j) xr[r][j] = 0.0f;
    if (row < n) {
      const float* xrow = x + row * c;
      if (vec4) {  // c % 4 == 0 and x is 16-byte aligned
#pragma unroll
        for (int j = 0; j < CT; j += 4) {
          if (j < c) {
            const float4 v = *reinterpret_cast<const float4*>(xrow + j);
            xr[r][j] = v.x;
            xr[r][j + 1] = v.y;
            xr[r][j + 2] = v.z;
            xr[r][j + 3] = v.w;
          }
        }
      } else {
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          if (j < c) xr[r][j] = xrow[j];
        }
      }
    }
  }

  float best[R];
  int besti[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    best[r] = INFINITY;
    besti[r] = 0;
  }
  for (int k0 = 0; k0 < k; k0 += kNodeChunk) {
    const int kn = min(kNodeChunk, k - k0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_nodes<CT>(wt, w2s, w, w2, k0, kn, c);
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float4* wk = reinterpret_cast<const float4*>(wt + kk * CT);
      float dot[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dot[r] = 0.0f;
#pragma unroll
      for (int j4 = 0; j4 < CT / 4; ++j4) {
        const float4 wv = wk[j4];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = fmaf(xr[r][4 * j4], wv.x, dot[r]);
          dot[r] = fmaf(xr[r][4 * j4 + 1], wv.y, dot[r]);
          dot[r] = fmaf(xr[r][4 * j4 + 2], wv.z, dot[r]);
          dot[r] = fmaf(xr[r][4 * j4 + 3], wv.w, dot[r]);
        }
      }
      const float wn = w2s[kk];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = wn - 2.0f * dot[r];
        if (d < best[r]) {
          best[r] = d;
          besti[r] = k0 + kk;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long row = base + (long long)r * kThreads;
    if (row < n) {
      idx[row] = besti[r];
      if (WITH_DIST) {
        float x2 = 0.0f;
#pragma unroll
        for (int j = 0; j < CT; ++j) x2 = fmaf(xr[r][j], xr[r][j], x2);
        dist[row] = fmaxf(best[r] + x2, 0.0f);
      }
    }
  }
}

// C > 64: the same arithmetic with both operands read through L1.
template <bool WITH_DIST>
__global__ void __launch_bounds__(kThreads)
bmu_wide_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ w2, long long n, int c, int k,
                int32_t* __restrict__ idx, float* __restrict__ dist) {
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (row >= n) return;
  const float* xrow = x + row * c;
  float best = INFINITY;
  int besti = 0;
  for (int kk = 0; kk < k; ++kk) {
    const float* wk = w + (long long)kk * c;
    float dot = 0.0f;
    for (int j = 0; j < c; ++j) dot = fmaf(__ldg(xrow + j), __ldg(wk + j), dot);
    const float d = __ldg(w2 + kk) - 2.0f * dot;
    if (d < best) {
      best = d;
      besti = kk;
    }
  }
  idx[row] = besti;
  if (WITH_DIST) {
    float x2 = 0.0f;
    for (int j = 0; j < c; ++j) {
      const float v = __ldg(xrow + j);
      x2 = fmaf(v, v, x2);
    }
    dist[row] = fmaxf(best + x2, 0.0f);
  }
}

template <int CT, bool WITH_DIST>
void launch_regs(cudaStream_t stream, const float* x, const float* w, const float* w2,
                 long long n, int c, int k, int vec4, int32_t* idx, float* dist) {
  constexpr long long rows = (long long)kThreads * rows_per_thread<CT>();
  const dim3 grid((unsigned)((n + rows - 1) / rows));
  bmu_regs_kernel<CT, WITH_DIST><<<grid, kThreads, smem_bytes<CT>(), stream>>>(
      x, w, w2, n, c, k, vec4, idx, dist);
}

// The register width: c rounded up to a multiple of 4 up to 32, of 8 up to 64.
template <bool WITH_DIST>
void launch(cudaStream_t stream, const float* x, const float* w, const float* w2,
            long long n, int c, int k, int32_t* idx, float* dist) {
  const int vec4 = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
#define ARK_BMU_WIDTH(CT)                                                     \
  if (c <= CT) {                                                              \
    launch_regs<CT, WITH_DIST>(stream, x, w, w2, n, c, k, vec4, idx, dist);   \
    return;                                                                   \
  }
  ARK_BMU_WIDTH(4)
  ARK_BMU_WIDTH(8)
  ARK_BMU_WIDTH(12)
  ARK_BMU_WIDTH(16)
  ARK_BMU_WIDTH(20)
  ARK_BMU_WIDTH(24)
  ARK_BMU_WIDTH(28)
  ARK_BMU_WIDTH(32)
  ARK_BMU_WIDTH(40)
  ARK_BMU_WIDTH(48)
  ARK_BMU_WIDTH(56)
  ARK_BMU_WIDTH(64)
#undef ARK_BMU_WIDTH
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  bmu_wide_kernel<WITH_DIST><<<grid, kThreads, 0, stream>>>(x, w, w2, n, c, k, idx, dist);
}

}  // namespace

// Launches the BMU search on `stream` and returns cudaGetLastError() of the
// launch (0 when it was accepted). Pointers are device pointers to contiguous
// row-major arrays: x (n, c), w (k, c), w2 (k,), idx (n,), and dist (n,) when
// with_dist is nonzero (it may be null otherwise). Does not synchronise.
extern "C" int ark_bmu_launch(const float* x, const float* w, const float* w2,
                              long long n, int c, int k, int32_t* idx, float* dist,
                              int with_dist, void* stream) {
  if (n < 0 || c < 0 || k <= 0 || (with_dist && dist == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (with_dist) {
    launch<true>(s, x, w, w2, n, c, k, idx, dist);
  } else {
    launch<false>(s, x, w, w2, n, c, k, idx, dist);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* ark_bmu_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
