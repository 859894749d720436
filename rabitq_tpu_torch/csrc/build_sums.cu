// The build's float sums in one fixed order, so that one seed gives one
// index on every run (ops/kmeans.py). Build kernels, not counterparts of a
// TPU kernel: they take the place of index_add_ and of a one-dimensional
// torch.cumsum, whose CUDA forms add in whatever order threads or tiles
// finish. Each has a plain version in ops/kmeans.py that adds in the same
// order on the CPU, so the two are bitwise equal.
//
// rabitq_segment_sum -- the port's jax.ops.segment_sum (the k-means, MSTG
// and sharded Lloyd steps, the MSTG leaf means): out[s] = the rows x[r] with
// segment id s, added one row at a time in ascending r. The caller passes the
// rows grouped by segment: `order` lists the row indices sorted by segment id
// with a stable sort (so ascending within a segment) and
// `offsets[s] .. offsets[s + 1]` is segment s's range of it. Block (s, y)
// owns segment s and a slice of the columns; thread c of it walks the
// segment's rows in order with one running sum per column (four with float4
// rows) in registers. Loads run UNROLL rows ahead of the adds, which stay in
// row order. Bound on the H100: bytes (each row read once; no [N, D]
// gathered copy is made).
//
// rabitq_running_sum -- the inclusive running sum of the k-means++ init's
// weights, in tiles of SCAN_TILE weights (zeros past n) spread over the
// card, one block a tile. In a tile, thread t holds SCAN_ITEMS consecutive
// weights (16-byte loads) and adds them in turn; each warp scans its
// threads' totals (Kogge-Stone, warp_inclusive_scan), warp 0 scans the
// warps' totals the same way, and the tile's total is the last of those.
// Each output is carry + (warp's prefix + lane's prefix) plus the thread's
// running sum, where a tile's carry is the running sum, in this same order,
// of the tile totals before it (so the order is a function of n alone). A
// tile needs no carry: one launch. Otherwise rabitq_tile_sums writes the
// tile totals (one block a tile), and in the second launch every block runs
// the same one-tile scan over all the totals (up to SCAN_TILE of them) and
// takes its own carry from it, so every block gets the same bits with no
// atomics and no look-back; beyond SCAN_TILE tiles the wrapper forms the
// totals' running sum first (this function again) and the blocks read their
// carries from it. Bound on the H100: bytes (weights read once, sums written
// once); the second launch reads the weights again (from the L2 at the
// init's 1 MB).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;
constexpr int MAX_THREADS = 256;
constexpr int SCAN_THREADS = 256;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_ITEMS = 8;  // consecutive weights a thread adds in turn
constexpr int SCAN_TILE = SCAN_THREADS * SCAN_ITEMS;

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float add(float a, float b) { return a + b; }
template <typename V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ float4 zero<float4>() { return make_float4(0.f, 0.f, 0.f, 0.f); }
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }

// cols: row width in units of V
template <typename V>
__global__ void __launch_bounds__(MAX_THREADS)
segment_sum_kernel(const V* __restrict__ x, const int64_t* __restrict__ order,
                   const int64_t* __restrict__ offsets, V* __restrict__ out, int64_t cols) {
  const int64_t s = blockIdx.x;
  const int64_t c = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (c >= cols) return;
  const int64_t end = offsets[s + 1];
  int64_t r = offsets[s];
  V acc = zero<V>();
  for (; r + UNROLL <= end; r += UNROLL) {
    V v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) v[u] = x[order[r + u] * cols + c];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) acc = add(acc, v[u]);
  }
  for (; r < end; ++r) acc = add(acc, x[order[r] * cols + c]);
  out[s * cols + c] = acc;
}

template <typename V>
int launch_segment_sum(const void* x, const int64_t* order, const int64_t* offsets, void* out,
                       long long segments, long long cols, cudaStream_t stream) {
  const int threads = (int)(cols >= MAX_THREADS ? MAX_THREADS : (cols + 31) / 32 * 32);
  const dim3 grid((unsigned)segments, (unsigned)((cols + threads - 1) / threads));
  segment_sum_kernel<V><<<grid, threads, 0, stream>>>((const V*)x, order, offsets, (V*)out, cols);
  return (int)cudaGetLastError();
}

// Kogge-Stone inclusive scan across a warp: at distance d = 1, 2, .., 16 each
// lane l >= d adds the value lane l - d held before the step.
__device__ __forceinline__ float warp_inclusive_scan(float x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float y = __shfl_up_sync(0xFFFFFFFFu, x, d);
    if (lane >= d) x = x + y;
  }
  return x;
}

// The SCAN_ITEMS weights from `first` (zeros past n), as 16-byte loads where
// the run is whole and aligned.
__device__ __forceinline__ void load_items(float (&v)[SCAN_ITEMS], const float* __restrict__ w,
                                           int64_t first, int64_t n, bool vec) {
  if (vec && first + SCAN_ITEMS <= n) {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; i += 4) {
      const float4 q = *(const float4*)(w + first + i);
      v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) v[i] = first + i < n ? w[first + i] : 0.f;
  }
}

// One tile's scan: adds the thread's items in turn (in place), scans the
// threads' totals in warps and the warps' totals in warp 0. Returns the
// thread's prefix (warp's prefix + lane's prefix) and sets `total` to the
// tile's total. Every thread of the block calls it; two barriers.
__device__ __forceinline__ float tile_scan(float (&v)[SCAN_ITEMS], float* warp_total,
                                           float* warp_before, float& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 1; i < SCAN_ITEMS; ++i) v[i] = v[i - 1] + v[i];  // the thread's items in turn
  const float incl = warp_inclusive_scan(v[SCAN_ITEMS - 1], lane);
  float lane_before = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
  if (lane == 0) lane_before = 0.f;
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  if (warp == 0) {  // lanes past SCAN_WARPS hold zeros and reach no lane below them
    const float wincl = warp_inclusive_scan(lane < SCAN_WARPS ? warp_total[lane] : 0.f, lane);
    const float wb = __shfl_up_sync(0xFFFFFFFFu, wincl, 1);
    if (lane < SCAN_WARPS) warp_before[lane] = lane == 0 ? 0.f : wb;
    if (lane == SCAN_WARPS - 1) warp_before[SCAN_WARPS] = wincl;
  }
  __syncthreads();
  total = warp_before[SCAN_WARPS];
  return warp_before[warp] + lane_before;
}

__global__ void __launch_bounds__(SCAN_THREADS)
tile_sum_kernel(const float* __restrict__ w, float* __restrict__ totals, int64_t n) {
  __shared__ float warp_total[SCAN_WARPS];
  __shared__ float warp_before[SCAN_WARPS + 1];
  const bool vec = (uintptr_t)w % 16 == 0;
  float v[SCAN_ITEMS];
  load_items(v, w, (int64_t)blockIdx.x * SCAN_TILE + (int64_t)threadIdx.x * SCAN_ITEMS, n, vec);
  float total;
  tile_scan(v, warp_total, warp_before, total);
  if (threadIdx.x == 0) totals[blockIdx.x] = total;
}

// Block b scans tile b with its carry: 0 for tile 0; else, with `scanned`,
// tile_sums[b - 1] (the totals' running sum), or else entry b - 1 of the
// one-tile scan of the `tiles` totals in tile_sums, which every block forms
// alike.
__global__ void __launch_bounds__(SCAN_THREADS)
running_sum_kernel(const float* __restrict__ w, float* __restrict__ out, int64_t n,
                   const float* __restrict__ tile_sums, int64_t tiles, int scanned) {
  __shared__ float warp_total[SCAN_WARPS];
  __shared__ float warp_before[SCAN_WARPS + 1];
  __shared__ float carry_s;
  const int t = threadIdx.x;
  const int64_t first = (int64_t)blockIdx.x * SCAN_TILE + (int64_t)t * SCAN_ITEMS;
  const bool vec = ((uintptr_t)w % 16 == 0) && ((uintptr_t)out % 16 == 0);
  float v[SCAN_ITEMS];
  load_items(v, w, first, n, vec);  // in flight while the carry forms
  float carry = 0.f;
  if (blockIdx.x > 0 && scanned) {
    carry = tile_sums[blockIdx.x - 1];
  } else if (blockIdx.x > 0) {
    float u[SCAN_ITEMS], ignored;
    load_items(u, tile_sums, (int64_t)t * SCAN_ITEMS, tiles, (uintptr_t)tile_sums % 16 == 0);
    const float before = 0.f + tile_scan(u, warp_total, warp_before, ignored);
    const int64_t j = blockIdx.x - 1;
    if (j / SCAN_ITEMS == t) {
#pragma unroll
      for (int i = 0; i < SCAN_ITEMS; ++i)
        if (i == j % SCAN_ITEMS) carry_s = before + u[i];
    }
    __syncthreads();
    carry = carry_s;
  }
  float total;
  const float before = carry + tile_scan(v, warp_total, warp_before, total);
  if (vec && first + SCAN_ITEMS <= n) {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; i += 4)
      *(float4*)(out + first + i) =
          make_float4(before + v[i], before + v[i + 1], before + v[i + 2], before + v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i)
      if (first + i < n) out[first + i] = before + v[i];
  }
}

}  // namespace

// x [rows, dim] f32, order [rows] int64, offsets [segments + 1] int64, out
// [segments, dim] f32. vec4: dim % 4 == 0 and x, out 16-byte aligned.
extern "C" int rabitq_segment_sum(const void* x, const void* order, const void* offsets,
                                  void* out, long long segments, long long dim, int vec4,
                                  void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (segments <= 0 || dim <= 0) return 0;
  if (segments > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  if (vec4)
    return launch_segment_sum<float4>(x, (const int64_t*)order, (const int64_t*)offsets, out,
                                      segments, dim / 4, stream);
  return launch_segment_sum<float>(x, (const int64_t*)order, (const int64_t*)offsets, out,
                                   segments, dim, stream);
}

// w [n] f32, totals [ceil(n / SCAN_TILE)] f32: each tile's total, in the
// order above.
extern "C" int rabitq_tile_sums(const void* w, void* totals, long long n, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0) return 0;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (tiles > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  tile_sum_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>((const float*)w, (float*)totals, n);
  return (int)cudaGetLastError();
}

// w [n] f32, out [n] f32: out[j] = w[0] + ... + w[j] in the order above.
// tile_sums: null where n fits one tile; else rabitq_tile_sums' totals
// (scanned = 0, at most SCAN_TILE tiles) or their running sum (scanned = 1).
extern "C" int rabitq_running_sum(const void* w, void* out, long long n, const void* tile_sums,
                                  int scanned, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0) return 0;
  const long long tiles = (n + SCAN_TILE - 1) / SCAN_TILE;
  if (tiles > 0x7FFFFFFFLL || (tiles > 1 && !tile_sums) || (!scanned && tiles > SCAN_TILE))
    return (int)cudaErrorInvalidValue;
  running_sum_kernel<<<(unsigned)tiles, SCAN_THREADS, 0, stream>>>(
      (const float*)w, (float*)out, n, (const float*)tile_sums, tiles, scanned);
  return (int)cudaGetLastError();
}
