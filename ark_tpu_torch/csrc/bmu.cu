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
// 3.35 TB/s, about 20 FLOP per byte, so this kernel is bound by FMA issue and
// not by memory (the TPU kernel was bound by HBM). The design keeps every
// operand of the FMA chain on chip: one thread per pixel holds its row in
// registers (read as float4 where C allows), and the node table, zero-padded
// to the register width, sits in shared memory with the node norms, where all
// threads of a warp read the same word (a broadcast). Nodes are staged in
// chunks, so any K fits; rows wider than the widest register path read both
// operands through the L1 cache instead. No tensor cores: TF32 would break the
// f32 contract, and a 3xTF32 split on wgmma is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kNodeChunk = 128;
constexpr int kMaxRegChannels = 64;

template <int CT>
constexpr size_t smem_bytes() {
  return sizeof(float) * (kNodeChunk * CT + kNodeChunk);
}

// Rows of `CT` floats for nodes [k0, k0 + kn), channels past c set to zero
// (fmaf(0, 0, acc) == acc, so the padding leaves every dot product unchanged),
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

template <int CT, bool WITH_DIST>
__global__ void __launch_bounds__(kThreads)
bmu_regs_kernel(const float* __restrict__ x, const float* __restrict__ w,
                const float* __restrict__ w2, long long n, int c, int k, int vec4,
                int32_t* __restrict__ idx, float* __restrict__ dist) {
  extern __shared__ float smem[];
  float* wt = smem;
  float* w2s = smem + kNodeChunk * CT;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool live = row < n;

  float xr[CT];
#pragma unroll
  for (int j = 0; j < CT; ++j) xr[j] = 0.0f;
  if (live) {
    const float* xrow = x + row * c;
    if (vec4) {  // c % 4 == 0 and x is 16-byte aligned
#pragma unroll
      for (int j = 0; j < CT; j += 4) {
        if (j < c) {
          const float4 v = *reinterpret_cast<const float4*>(xrow + j);
          xr[j] = v.x;
          xr[j + 1] = v.y;
          xr[j + 2] = v.z;
          xr[j + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < CT; ++j) {
        if (j < c) xr[j] = xrow[j];
      }
    }
  }

  float best = INFINITY;
  int besti = 0;
  for (int k0 = 0; k0 < k; k0 += kNodeChunk) {
    const int kn = min(kNodeChunk, k - k0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_nodes<CT>(wt, w2s, w, w2, k0, kn, c);
    __syncthreads();
    if (live) {
      for (int kk = 0; kk < kn; ++kk) {
        const float* wk = wt + kk * CT;
        float dot = 0.0f;
#pragma unroll
        for (int j = 0; j < CT; ++j) dot = fmaf(xr[j], wk[j], dot);
        const float d = w2s[kk] - 2.0f * dot;
        if (d < best) {
          best = d;
          besti = k0 + kk;
        }
      }
    }
  }
  if (live) {
    idx[row] = besti;
    if (WITH_DIST) {
      float x2 = 0.0f;
#pragma unroll
      for (int j = 0; j < CT; ++j) x2 = fmaf(xr[j], xr[j], x2);
      dist[row] = fmaxf(best + x2, 0.0f);
    }
  }
}

// C > kMaxRegChannels: the same arithmetic with both operands read through L1.
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
void launch_regs(dim3 grid, cudaStream_t stream, const float* x, const float* w,
                 const float* w2, long long n, int c, int k, int vec4, int32_t* idx,
                 float* dist) {
  bmu_regs_kernel<CT, WITH_DIST><<<grid, kThreads, smem_bytes<CT>(), stream>>>(
      x, w, w2, n, c, k, vec4, idx, dist);
}

template <bool WITH_DIST>
void launch(cudaStream_t stream, const float* x, const float* w, const float* w2,
            long long n, int c, int k, int32_t* idx, float* dist) {
  const dim3 grid((unsigned)((n + kThreads - 1) / kThreads));
  const int vec4 = (c % 4 == 0) && (reinterpret_cast<uintptr_t>(x) % 16 == 0);
  if (c <= 4) {
    launch_regs<4, WITH_DIST>(grid, stream, x, w, w2, n, c, k, vec4, idx, dist);
  } else if (c <= 8) {
    launch_regs<8, WITH_DIST>(grid, stream, x, w, w2, n, c, k, vec4, idx, dist);
  } else if (c <= 16) {
    launch_regs<16, WITH_DIST>(grid, stream, x, w, w2, n, c, k, vec4, idx, dist);
  } else if (c <= 32) {
    launch_regs<32, WITH_DIST>(grid, stream, x, w, w2, n, c, k, vec4, idx, dist);
  } else if (c <= kMaxRegChannels) {
    launch_regs<kMaxRegChannels, WITH_DIST>(grid, stream, x, w, w2, n, c, k, vec4,
                                            idx, dist);
  } else {
    bmu_wide_kernel<WITH_DIST><<<grid, kThreads, 0, stream>>>(x, w, w2, n, c, k,
                                                               idx, dist);
  }
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
