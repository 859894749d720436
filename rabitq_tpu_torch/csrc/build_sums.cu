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
// weights, one block walking tiles of SCAN_TILE weights in turn (zeros past
// n). In a tile, thread t holds SCAN_ITEMS consecutive weights (16-byte
// loads) and adds them in turn; each warp scans its threads' totals
// (Kogge-Stone, warp_inclusive_scan), warp 0 scans the warps' totals the
// same way, and each output is carry + (warp's prefix + lane's prefix) plus
// the thread's running sum, where carry, the sum of the earlier tiles, grows
// by each tile's total in turn; the next tile's weights load while a tile is
// scanned. One block: the init calls it once a step on
// at most a few hundred thousand weights, and a second launch to join blocks
// would cost more than the pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int UNROLL = 8;
constexpr int MAX_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_WARPS = SCAN_THREADS / 32;
constexpr int SCAN_ITEMS = 16;  // consecutive weights a thread adds in turn
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

__global__ void __launch_bounds__(SCAN_THREADS)
running_sum_kernel(const float* __restrict__ w, float* __restrict__ out, int64_t n) {
  __shared__ float warp_total[SCAN_WARPS];
  __shared__ float warp_before[SCAN_WARPS];
  __shared__ float tile_total;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool vec = ((uintptr_t)w % 16 == 0) && ((uintptr_t)out % 16 == 0);
  float carry = 0.f;  // the sum of every earlier tile, added tile by tile
  float next[SCAN_ITEMS];
  load_items(next, w, (int64_t)t * SCAN_ITEMS, n, vec);
  for (int64_t base = 0; base < n; base += SCAN_TILE) {
    const int64_t first = base + (int64_t)t * SCAN_ITEMS;
    float v[SCAN_ITEMS];
#pragma unroll
    for (int i = 0; i < SCAN_ITEMS; ++i) v[i] = next[i];
    if (base + SCAN_TILE < n) load_items(next, w, first + SCAN_TILE, n, vec);  // in flight
#pragma unroll
    for (int i = 1; i < SCAN_ITEMS; ++i) v[i] = v[i - 1] + v[i];  // the thread's items in turn
    const float incl = warp_inclusive_scan(v[SCAN_ITEMS - 1], lane);
    float lane_before = __shfl_up_sync(0xFFFFFFFFu, incl, 1);
    if (lane == 0) lane_before = 0.f;
    if (lane == 31) warp_total[warp] = incl;
    __syncthreads();
    if (warp == 0) {
      const float wincl = warp_inclusive_scan(warp_total[lane], lane);
      const float wb = __shfl_up_sync(0xFFFFFFFFu, wincl, 1);
      warp_before[lane] = lane == 0 ? 0.f : wb;
      if (lane == 31) tile_total = wincl;
    }
    __syncthreads();
    const float before = carry + (warp_before[warp] + lane_before);
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
    carry = carry + tile_total;
    __syncthreads();  // warp_total, warp_before and tile_total are read before the next tile
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

// w [n] f32, out [n] f32: out[j] = w[0] + ... + w[j] in the order above.
extern "C" int rabitq_running_sum(const void* w, void* out, long long n, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (n <= 0) return 0;
  running_sum_kernel<<<1, SCAN_THREADS, 0, stream>>>((const float*)w, (float*)out, n);
  return (int)cudaGetLastError();
}
