// Deterministic segmented sum of per-pixel rows, written by hand for sm_90a.
//
// Replaces the XLA scatter behind jax.ops.segment_sum in
// ark_tpu/ops/segment_reduce.py:44 (cell_sizes, channel_sums, the centroid
// and central-moment passes, Crofton and Euler sums) and UMAP's sorted
// seg_add (ark_tpu/ops/umap.py:173-176). That is not a Pallas kernel; it
// needs a kernel here because a float scatter-add on CUDA (index_add_,
// scatter_add_) uses atomics, so its summation order, and with it the last
// bits of every cell-table number, changes from run to run. The cell
// table's contract is bitwise.
//
// What it computes: out[s, k] = sum of values[i, k] over the pixels i with
// labels[i] == s, accumulated in ASCENDING pixel order, one correctly rounded
// f32 add at a time, starting from +0.0. That is the order of a sequential
// scatter (np.add.at, torch's CPU index_add_, XLA's CPU scatter), so the sums
// are bitwise equal to those. Segment 0 is a segment like any other: the
// background of a label image, or point 0 of UMAP's edge sums; with
// background = false row 0 is written as zero (the cell and fiber tables
// never read it). Labels outside [0, num_segments) are dropped, as
// jax.ops.segment_sum drops them. No float atomics, no host synchronisation.
//
// Launches, all on the caller's stream:
// - the plan, once per label image: each segment's bounding box (first and
//   last row and column) from integer atomicMin/atomicMax, which give the same
//   box whatever their order. A warp reads 32 neighbouring pixels of one row;
//   a shuffle finds where each run of one label starts and ends, and only
//   those lanes issue atomics (first row, last row and first column at the
//   start, last column at the end). Label 0 has far more runs than any cell,
//   all on one address, so each thread keeps its own box of the zeros it saw
//   and a block issues one set of atomics for them. Every sum over that image
//   reuses the plan.
// - the cells' walk of a label image (rows of width w): one warp per
//   segment. It scans the box in raster order, which is ascending pixel
//   order, 1024 box pixels at a time: the lanes load the labels together
//   (coalesced along the rows), and a ballot per 32 pixels compacts the
//   matching pixel indices, in order, into shared memory. The lanes then
//   stage those pixels' rows of values into shared memory together (cp.async,
//   16 bytes a copy where K is a multiple of 4, else 4, so the loads of a
//   whole chunk are in flight at once and the rows of a run of pixels are
//   read contiguously), double-buffered: the next chunk's loads are issued
//   before the current chunk's adds. Lane c then adds column c (and c + 32,
//   c + 64, c + 96) of the chunk in order. Columns are walked in tiles of
//   128. With background = true the walk skips segment 0, and
// - the background row's kernel follows it. Segment 0's box is the whole
//   image, and each of its columns is one serial chain of adds over every
//   background pixel (~0.44M in a dense 1024^2 FOV), which no blocking may
//   split. The columns are cut into groups of 8 (one 32-byte sector of a
//   row), a block each. In a block three producer warps take turns over
//   tiles of 1024 positions of segment 0's span: each streams its tiles'
//   labels two tiles ahead (cp.async), compacts a tile's label-0 positions
//   in order by ballots, and gathers those pixels' 8 values (cp.async, the
//   copies spread over its lanes) into a ring of its own in shared memory.
//   One consumer warp takes the tiles in order from the three rings; its
//   lane c carries column c's chain, each add issued beside the load of the
//   row 32 ahead, so only the dependent __fadd_rn is serial. Counts in
//   shared memory (release stores, acquire loads) pass tiles and free rows
//   between the warps. A second kernel, not more blocks of the walk's grid,
//   because the producers need four warps and ~200 KB of shared memory a
//   block, which would cut the walk's occupancy; the walk takes ~0.05 ms of
//   the ~1.4 ms.
// - the sum of flat labels ((N,) laid out as one row: UMAP's heads and
//   tails, the sharded epoch's list), one launch of segment_flat_kernel: one
//   thread per (segment, column), column fastest, walks the segment's span
//   (its first to its last position, from the plan) in ascending order and
//   adds the values whose label is its segment, 16 positions' loads ahead of
//   the adds. With sorted ids every position of a span matches and a span is
//   a segment's length (~15 for UMAP's edges); unsorted ids stay correct,
//   only slower (a span can reach the whole array). The path is picked by
//   the labels' layout, never by their values.
//
// What bounds it on an H100: the cell walk must read each foreground pixel's
// K values once (one dense 1024^2 FOV, 58% foreground: 107 MB at K = 44,
// 7.3 MB at K = 3) plus the labels of each box, 4 bytes per box pixel, so it
// is bound by HBM bandwidth (33 us at K = 44 for values and labels). To come
// near it, a warp keeps up to two chunks of values in flight (9.4 KB each),
// the adds are a short dependent chain per lane that overlaps the next
// chunk's loads, and the plan needs no sort (a stable sort of the labels
// alone takes longer than the plan and the walk together). The sizes were
// tuned on an H100: 16-byte copies cut the instructions per byte fourfold,
// and two warps a block with 9.4 KB buffers (46.6 KB of static shared
// memory a block, four blocks an SM) keep more bytes in flight per segment
// than four warps with smaller ones; a third buffer did not help. At small K
// (the centroid pass, K = 3) the walk is not bound by bytes: a FOV's segments
// run in one wave of warps, and each warp's time is the latency of its
// serial steps over its box (label loads, ballots, copies, adds).
// The background row is bound by its chain, whatever K is: (background
// pixels) dependent adds of ~4.2 cycles each (measured), ~0.94 ms for a
// dense 1024^2 FOV at 1.98 GHz, against ~0.06 ms for its bytes. One
// producer warp could not keep up (scattered copies and label scans), nor
// could a consumer whose loads and adds ran as separate batches; tiles
// shared over three producers and the interleaved adds bring it within
// ~1.5x of the chain (scripts/port_kernel_ab.py). The flat sums are
// bound by bytes (each entry's K values and label read once) and by the
// latency of one wave of short walks.
//
// Cost model: the walk reads (box area) x 4 bytes of labels and (cell area)
// x K x 4 bytes of values per segment. For compact cells box area / cell area
// is ~1.3-1.6; an elongated diagonal cell of length L and width w has a box
// ~L^2 / 2 against an area ~L w, a ratio ~L / (2 w), which costs label reads
// (and ballot work) but no extra value reads. Segment lengths differ ~10x; a
// warp per segment lets the scheduler fill the card with the short ones while
// the long ones run, and no warp waits for another. Each background block
// reads the span's labels (4 bytes a position; the groups share them through
// L2) and its 8 columns of every background pixel.

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
// the background row's kernel
constexpr int kBgProducers = 3;                  // producer warps a block
constexpr int kBgThreads = 32 * (1 + kBgProducers);
constexpr int kGroupCols = 8;                    // columns a block sums
constexpr int kBgTile = 1024;                    // label positions a producer step scans
constexpr int kBgLabelStages = 2;                // a producer's label tiles in flight
constexpr int kBgQueue = 64;                     // tiles a producer may run ahead
constexpr int kBgUnroll = 32;                    // rows the consumer reads ahead
constexpr long long kSpinLimit = 1LL << 30;      // waits without progress before a trap

// A producer's shared memory: its label tiles, the current tile's compacted
// positions, a queue of rows a tile, and a ring of kRows rows of S floats
// (row r in slot r % kRows; kBgUnroll more rows of pad, which the consumer
// reads ahead but never adds).
template <int S>
struct BgRing {
  static constexpr int kRows = S == 8 ? 1664 : 3328;
  static constexpr int kBytes =
      (kBgLabelStages * kBgTile + kBgTile + kBgQueue) * 4 + (kRows + kBgUnroll) * S * 4;
};
constexpr int kBgSyncInts = 4 * kBgProducers + 4;

// flat labels
constexpr int kFlatThreads = 256;
constexpr int kFlatUnroll = 16;                  // positions whose loads go ahead of the adds

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
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

// Waits until at most n of this thread's cp.async groups are pending (more
// than 7: at most 7).
__device__ __forceinline__ void cp_async_wait_at_most(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    case 2: cp_async_wait<2>(); break;
    case 3: cp_async_wait<3>(); break;
    case 4: cp_async_wait<4>(); break;
    case 5: cp_async_wait<5>(); break;
    case 6: cp_async_wait<6>(); break;
    default: cp_async_wait<7>(); break;
  }
}

// A count in shared memory passed between the warps of a block: the writer
// releases what it wrote before, the reader acquires it.
__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(a) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("st.release.cta.shared.b32 [%0], %1;\n" ::"r"(a), "r"(v) : "memory");
}

// Boxes start empty: first row and column INT_MAX, last -1.
__global__ void __launch_bounds__(kPlanThreads)
box_init_kernel(int4* __restrict__ boxes, int num_segments) {
  const long long s = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  if (s < num_segments) boxes[s] = make_int4(INT_MAX, -1, INT_MAX, -1);
}

// boxes[s] = (first row, last row, first column, last column) of label s,
// for labels in [0, num_segments). Block (x, y) reads columns [x * kPlanThreads,
// (x + 1) * kPlanThreads) of rows y, y + gridDim.y, ...; a warp's lanes share
// a row. Every thread of a block runs the same iterations, so the shuffles see
// the full warp and the barriers the full block. Label 0 goes through the
// thread's own first and last row (its column is fixed), a warp reduction,
// shared memory, then one set of global atomics a block.
__global__ void __launch_bounds__(kPlanThreads)
box_kernel(const int* __restrict__ labels, int rows, int w, int num_segments,
           int* __restrict__ boxes) {
  __shared__ int zero_box[4];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kPlanThreads + threadIdx.x;
  if (threadIdx.x == 0) {
    zero_box[0] = INT_MAX;
    zero_box[1] = -1;
    zero_box[2] = INT_MAX;
    zero_box[3] = -1;
  }
  __syncthreads();
  int zr0 = INT_MAX, zr1 = -1;
  for (int r = blockIdx.y; r < rows; r += gridDim.y) {
    const int l = c < w ? __ldg(labels + (long long)r * w + c) : -1;
    const int prev = __shfl_up_sync(full, l, 1);
    const int next = __shfl_down_sync(full, l, 1);
    if (l == 0) {   // rows ascend, and the thread's column is fixed
      zr0 = min(zr0, r);
      zr1 = r;
    }
    if (l <= 0 || l >= num_segments) continue;
    int* b = boxes + 4LL * l;
    if (lane == 0 || prev != l) {   // the first pixel of a run of l
      atomicMin(b, r);
      atomicMax(b + 1, r);
      atomicMin(b + 2, (int)c);
    }
    if (lane == 31 || next != l) atomicMax(b + 3, (int)c);   // the last pixel of the run
  }
  __syncwarp();
  const bool seen = zr1 >= 0;
  const int wr0 = __reduce_min_sync(full, zr0);
  const int wr1 = __reduce_max_sync(full, zr1);
  const int wc0 = __reduce_min_sync(full, seen ? (int)c : INT_MAX);
  const int wc1 = __reduce_max_sync(full, seen ? (int)c : -1);
  if (lane == 0 && wr1 >= 0) {
    atomicMin(zero_box, wr0);
    atomicMax(zero_box + 1, wr1);
    atomicMin(zero_box + 2, wc0);
    atomicMax(zero_box + 3, wc1);
  }
  __syncthreads();
  if (threadIdx.x == 0 && zero_box[1] >= 0) {
    atomicMin(boxes, zero_box[0]);
    atomicMax(boxes + 1, zero_box[1]);
    atomicMin(boxes + 2, zero_box[2]);
    atomicMax(boxes + 3, zero_box[3]);
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
                    bool vec4, bool background, float* __restrict__ out) {
  __shared__ int pix_all[kWarps][kPix];
  __shared__ __align__(16) float buf_all[kWarps][kStages * kBuf];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= num_segments) return;  // the whole warp: no block-wide barrier follows
  if (s == 0 && background) return;       // row 0 is segment_background_kernel's
  int* pix = pix_all[warp];
  float* bufs = buf_all[warp];
  // without the background, segment 0 is not walked and its row is zero
  const int4 box = s == 0 ? make_int4(1, 0, 1, 0) : boxes[s];
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

// Flat labels (one row of n positions): thread (s, c) adds column c of the
// positions of segment s's span, boxes[s].z .. boxes[s].w, whose label is s,
// in ascending order; the loads of kFlatUnroll positions go ahead of their
// adds. Threads run column fastest, so a warp's writes are contiguous.
__global__ void __launch_bounds__(kFlatThreads)
segment_flat_kernel(const float* __restrict__ values, int k, int num_segments,
                    const int* __restrict__ labels, const int4* __restrict__ boxes,
                    bool background, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * kFlatThreads + threadIdx.x;
  if (t >= (long long)num_segments * k) return;
  const int s = (int)(t / k);
  const int c = (int)(t - (long long)s * k);
  // without the background, segment 0 is not walked and its row is zero
  const int4 box = s == 0 && !background ? make_int4(1, 0, 1, 0) : boxes[s];
  float a = 0.0f;
  if (box.x <= box.y) {
    const float* col = values + c;
    const int end = box.w + 1;
    for (int p = box.z; p < end; p += kFlatUnroll) {
      int lab[kFlatUnroll];
      float x[kFlatUnroll];
#pragma unroll
      for (int u = 0; u < kFlatUnroll; ++u) {
        const bool in = p + u < end;
        lab[u] = in ? __ldg(labels + p + u) : -1;
        x[u] = in ? __ldg(col + (long long)(p + u) * k) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kFlatUnroll; ++u) {
        if (lab[u] == s) a = __fadd_rn(a, x[u]);
      }
    }
  }
  out[t] = a;
}

// The background row's kernel. Block g sums columns [8 g, 8 g + 8) of row 0
// over segment 0's span (its box's first pixel to its last, in raster
// order). Warp 0's lanes [0, S) consume, warps 1..kBgProducers produce; each
// producer takes every kBgProducers-th tile of the span and keeps a ring of
// its own in shared memory (its label tiles, the tile's compacted positions,
// a queue of rows a tile, and the rows of values), so no producer waits for
// another. Counts in shared memory: ready[w] (producer w's tiles landed),
// consumed[w] (rows of its ring added) and done (tiles added).
template <int S>
struct BgShared {
  int* sync;                    // ready[kBgProducers], consumed[kBgProducers], done
  unsigned char* base;
  __device__ int* lring(int w) const {
    return reinterpret_cast<int*>(base + (long long)w * BgRing<S>::kBytes);
  }
  __device__ int* idx(int w) const { return lring(w) + kBgLabelStages * kBgTile; }
  __device__ int* queue(int w) const { return idx(w) + kBgTile; }
  __device__ float* ring(int w) const { return reinterpret_cast<float*>(queue(w) + kBgQueue); }
};

// Producer w: for its tiles j = 0, 1, ... (tile w + j kBgProducers of the
// span, positions from pa0, up to p_end) it streams the labels
// kBgLabelStages tiles ahead (cp.async, 16 bytes where the labels are
// aligned), compacts the tile's label-0 positions in order by ballots (4
// positions a lane), waits for room in its ring, and gathers those pixels'
// columns [col0, col0 + kc) into the ring (cp.async, the copies spread over
// the lanes). Each step commits one group: the labels of tile j +
// kBgLabelStages and the values of tile j, so once group g has landed, the
// values of tiles below g - kBgLabelStages have; ready[w] says how many.
// Every value that steers the loop is the same on each lane.
template <int S>
__device__ void background_produce(const float* __restrict__ values, int k,
                                   const int* __restrict__ labels, bool label16, int pa0,
                                   int p_end, int tiles, int col0, int kc, bool vec4, int w,
                                   const BgShared<S>& sh, int lane) {
  constexpr int kRows = BgRing<S>::kRows;
  constexpr int kChunks = kBgTile / 128;
  const unsigned full = 0xffffffffu;
  const unsigned below = (1u << lane) - 1u;
  const int mine = tiles > w ? (tiles - w + kBgProducers - 1) / kBgProducers : 0;
  int* lring = sh.lring(w);
  int* idx = sh.idx(w);
  int* queue = sh.queue(w);
  float* ring = sh.ring(w);
  int head = 0, committed = 0, published = 0;
  auto tile_start = [&](int j) { return pa0 + (w + j * kBgProducers) * kBgTile; };
  auto issue_labels = [&](int j) {
    if (j >= mine) return;
    int* dst = lring + (j % kBgLabelStages) * kBgTile;
    const int q0 = tile_start(j);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = c * 128 + 4 * lane;
      if (label16 && q0 + i + 3 < p_end) {
        cp_async16(dst + i, labels + q0 + i);
      } else {
        for (int e = 0; e < 4; ++e) {
          if (q0 + i + e < p_end) cp_async4(dst + i + e, labels + q0 + i + e);
        }
      }
    }
  };
  auto commit = [&]() {
    cp_async_commit();
    ++committed;
  };
  // every group before `upto` has landed; tell the consumer
  auto publish = [&](int upto) {
    if (upto <= published) return;
    cp_async_wait_at_most(committed - upto);
    __threadfence_block();
    __syncwarp();
    if (lane == 0) st_release(sh.sync + w, max(0, upto - kBgLabelStages));
    published = upto;
  };
  for (int j = 0; j < kBgLabelStages; ++j) {
    issue_labels(j);
    commit();
  }
  for (int j = 0; j < mine; ++j) {
    publish(j + 1);                        // group j holds tile j's labels
    const int* lab = lring + (j % kBgLabelStages) * kBgTile;
    const int q0 = tile_start(j);
    int n = 0;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int i = c * 128 + 4 * lane;
      const int4 l4 = *reinterpret_cast<const int4*>(lab + i);
      const bool h0 = q0 + i < p_end && l4.x == 0;
      const bool h1 = q0 + i + 1 < p_end && l4.y == 0;
      const bool h2 = q0 + i + 2 < p_end && l4.z == 0;
      const bool h3 = q0 + i + 3 < p_end && l4.w == 0;
      const unsigned b0 = __ballot_sync(full, h0);
      const unsigned b1 = __ballot_sync(full, h1);
      const unsigned b2 = __ballot_sync(full, h2);
      const unsigned b3 = __ballot_sync(full, h3);
      int at = n + __popc(b0 & below) + __popc(b1 & below) + __popc(b2 & below) +
               __popc(b3 & below);
      if (h0) idx[at++] = i;
      if (h1) idx[at++] = i + 1;
      if (h2) idx[at++] = i + 2;
      if (h3) idx[at] = i + 3;
      n += __popc(b0) + __popc(b1) + __popc(b2) + __popc(b3);
    }
    __syncwarp();                          // the positions are written, the labels read
    // room for n rows in the ring and for the tile in the queue (the
    // consumer frees only what is published: publish landed groups meanwhile)
    const int first_in_queue = j - kBgQueue;
    const int need_done = first_in_queue >= 0 ? w + first_in_queue * kBgProducers + 1 : 0;
    for (long long spins = 0;; ++spins) {
      const int used = head - __reduce_min_sync(full, ld_acquire(sh.sync + kBgProducers + w));
      const int done = __reduce_min_sync(full, ld_acquire(sh.sync + 2 * kBgProducers));
      if (used + n <= kRows && done >= need_done) break;
      if (published < committed) publish(published + 1);
      if (spins > kSpinLimit) __trap();    // a launch error rather than a hung card
    }
    if (vec4) {
      const int per = (kc + 3) / 4;
#pragma unroll 4
      for (int f = lane; f < n * per; f += 32) {
        const int r = per == 2 ? f >> 1 : f;
        const int h = per == 2 ? (f & 1) * 4 : 0;
        cp_async16(ring + ((head + r) % kRows) * S + h,
                   values + (long long)(q0 + idx[r]) * k + col0 + h);
      }
    } else {
#pragma unroll 2
      for (int r = lane; r < n; r += 32) {
        float* dst = ring + ((head + r) % kRows) * S;
        const float* src = values + (long long)(q0 + idx[r]) * k + col0;
        for (int c = 0; c < kc; ++c) cp_async4(dst + c, src + c);
      }
    }
    if (lane == 0) queue[j % kBgQueue] = n;
    issue_labels(j + kBgLabelStages);
    head += n;
    commit();
  }
  publish(committed);
}

// Adds rows [0, m) at src[j * S] to `a` in order. Each row's add is issued
// beside the load of the row kBgUnroll ahead (a batch of loads, then a batch
// of adds, runs at about half the rate), so only the dependent __fadd_rn is
// serial. It reads up to kBgUnroll rows past m (the ring's pad) without
// adding them.
template <int S>
__device__ __forceinline__ float chain_rows(float a, const float* src, int m) {
  if (m <= 0) return a;
  float x[kBgUnroll];
#pragma unroll
  for (int u = 0; u < kBgUnroll; ++u) x[u] = src[u * S];
  int j = 0;
  for (; j + kBgUnroll <= m; j += kBgUnroll) {
#pragma unroll
    for (int u = 0; u < kBgUnroll; ++u) {
      const float v = x[u];
      x[u] = src[(j + kBgUnroll + u) * S];
      a = __fadd_rn(a, v);
    }
  }
#pragma unroll
  for (int u = 0; u < kBgUnroll; ++u) {
    if (u < m - j) a = __fadd_rn(a, x[u]);
  }
  return a;
}

// The consumer: lane c carries column col0 + c's chain over the tiles in
// order (tile t from producer t % kBgProducers's ring), and writes row 0.
template <int S>
__device__ void background_consume(const BgShared<S>& sh, int tiles, int kc,
                                   float* __restrict__ out_row, int lane) {
  constexpr int kRows = BgRing<S>::kRows;
  constexpr unsigned mask = (1u << S) - 1u;
  float a = 0.0f;
  int tails[kBgProducers] = {};
  for (int t0 = 0; t0 < tiles; t0 += kBgProducers) {
    const int j = t0 / kBgProducers;
#pragma unroll
    for (int w = 0; w < kBgProducers; ++w) {
      if (t0 + w < tiles) {
        for (long long spins = 0; __reduce_min_sync(mask, ld_acquire(sh.sync + w)) <= j;
             ++spins) {
          if (spins > kSpinLimit) __trap();  // a launch error rather than a hung card
        }
        const int n = sh.queue(w)[j % kBgQueue];
        const float* ring = sh.ring(w) + lane;
        const int at = tails[w] % kRows;
        const int first = min(n, kRows - at);
        a = chain_rows<S>(a, ring + at * S, first);
        a = chain_rows<S>(a, ring, n - first);
        tails[w] += n;
        __syncwarp(mask);                  // every lane has read the rows
        if (lane == 0) {
          st_release(sh.sync + kBgProducers + w, tails[w]);
          st_release(sh.sync + 2 * kBgProducers, t0 + w + 1);
        }
      }
    }
  }
  if (lane < kc) out_row[lane] = a;
}

template <int S>
__global__ void __launch_bounds__(kBgThreads)
segment_background_kernel(const float* __restrict__ values, int k,
                          const int* __restrict__ labels, int w,
                          const int4* __restrict__ boxes, bool vec4, bool label16,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char bg_smem[];
  const BgShared<S> sh{reinterpret_cast<int*>(bg_smem), bg_smem + kBgSyncInts * 4};
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int col0 = blockIdx.x * kGroupCols;
  const int kc = min(kGroupCols, k - col0);
  const int4 box = boxes[0];
  int pa0 = 0, p_end = 0;
  if (box.x <= box.y) {
    pa0 = (box.x * w + box.z) & ~3;        // aligned down: no label 0 before the box
    p_end = box.y * w + box.w + 1;
  }
  const int tiles = (p_end - pa0 + kBgTile - 1) / kBgTile;
  if (threadIdx.x < kBgSyncInts) sh.sync[threadIdx.x] = 0;
  __syncthreads();
  if (warp > 0) {
    background_produce<S>(values, k, labels, label16, pa0, p_end, tiles, col0, kc, vec4,
                          warp - 1, sh, lane);
  } else if (lane < S) {
    background_consume<S>(sh, tiles, kc, out + col0, lane);
  }
}

template <int S>
cudaError_t launch_background(const float* values, int k, const int* labels, int w,
                              const int4* boxes, float* out, cudaStream_t st) {
  const int bytes = kBgSyncInts * 4 + kBgProducers * BgRing<S>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(segment_background_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int groups = (k + kGroupCols - 1) / kGroupCols;
  segment_background_kernel<S><<<groups, kBgThreads, bytes, st>>>(
      values, k, labels, w, boxes, k % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0,
      reinterpret_cast<uintptr_t>(labels) % 16 == 0, out);
  return cudaGetLastError();
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
// (n,) int32 and the plan's boxes (num_segments, 4) int32 of the same labels
// (rows of width w; flat != 0 for flat labels, one row of n), out
// (num_segments, k) f32, all contiguous device pointers; background != 0 sums
// segment 0 too, else row 0 of out is zero. Returns cudaGetLastError() of the
// launch (0 when it was accepted). Does not synchronise.
extern "C" int ark_segment_sum_launch(const float* values, const int* labels, int w,
                                      const int* boxes, int num_segments, int k,
                                      int background, int flat, float* out, void* stream) {
  if (num_segments < 1 || k < 0 || w <= 0) return (int)cudaErrorInvalidValue;
  if (k == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int4* box4 = reinterpret_cast<const int4*>(boxes);
  if (flat) {
    const long long blocks = ((long long)num_segments * k + kFlatThreads - 1) / kFlatThreads;
    if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
    segment_flat_kernel<<<(unsigned)blocks, kFlatThreads, 0, st>>>(
        values, k, num_segments, labels, box4, background != 0, out);
    return (int)cudaGetLastError();
  }
  const long long blocks = ((long long)num_segments + kWarps - 1) / kWarps;
  segment_walk_kernel<<<(unsigned)blocks, kThreads, 0, st>>>(
      values, k, num_segments, labels, w, box4,
      k % 4 == 0 && reinterpret_cast<uintptr_t>(values) % 16 == 0, background != 0, out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !background) return (int)err;
  err = k <= 4 ? launch_background<4>(values, k, labels, w, box4, out, st)
               : launch_background<8>(values, k, labels, w, box4, out, st);
  return (int)err;
}

extern "C" const char* ark_segment_sum_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
