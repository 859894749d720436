// Unnormalized fast Walsh-Hadamard transform along the last axis of a
// row-major f32 [rows, n] tensor, n a power of two.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_fht.py (_fht_kernel /
// fht_pallas). Stage h updates every pair (j, j + h) with j & h == 0 to
// (x[j] + x[j+h], x[j] - x[j+h]), in ascending h -- the same single f32 add
// or subtract per element, in the same order, as the plain butterfly in
// ops/fht.py, so results are bitwise equal.
//
// Bound on the H100: bytes. A launch moves 2 * rows * n * 4 bytes and does
// rows * n * log2(n) adds, far below the f32 rate. So the data crosses device
// memory once each way in 16-byte accesses and every stage runs in
// registers or between lanes, with as few block barriers as the row length
// allows. Design:
//
// * Rows of 4 .. 512 (one warp a row, or several rows a warp): lane l of a
//   row holds elements 4 * L * k + 4 * l + i (L lanes a row, k < n / 4L,
//   i < 4) as float4 loads. Stages h = 1, 2 run in registers (bits of i),
//   h = 4 .. 2L by __shfl_xor_sync (bits of l), the rest in registers again
//   (bits of k). No shared memory, no barrier.
// * Rows of 1024 .. 32768 (one block a row, W = min(n / 512, 16) warps): each
//   warp runs the 512-element scheme above on its n / (512 W) consecutive
//   segments, writes them to shared memory, one barrier, and then thread c
//   holds column c of the [n / 512, 512] view and runs the stages h >= 512
//   in registers, storing 128 bytes a warp and row of the view.
// * Longer rows: segments of 32768 through the block scheme (stages below
//   32768 never leave a segment), then one in-place pass over device memory
//   per stage h >= 32768, a pair a thread.
// Offsets are 64-bit throughout: a call takes any number of elements.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xFFFFFFFFu;
constexpr int WARP_N = 512;     // elements a warp transforms alone (32 lanes x 16)
constexpr int MAX_BLOCK_LOG_N = 15;  // longest row a block holds: 32768 (128 KB)
constexpr int WARP_KERNEL_THREADS = 256;
constexpr int PASS_THREADS = 256;

// h = 1, 2: pairs inside each float4 of v
template <int K>
__device__ __forceinline__ void stages_in_registers(float (&v)[K][4]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int i = 0; i < 4; i += 2) {
      const float a = v[k][i], b = v[k][i + 1];
      v[k][i] = a + b;
      v[k][i + 1] = a - b;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float a = v[k][i], b = v[k][i + 2];
      v[k][i] = a + b;
      v[k][i + 2] = a - b;
    }
  }
}

// h = 4 .. 2L: the partner element sits in lane sub ^ m of the row's L lanes
// (lanes of one row are aligned, so xor stays inside them). The low element
// of a pair takes a + b, the high one a - b, with a the low element's value.
template <int K, int L>
__device__ __forceinline__ void stages_across_lanes(float (&v)[K][4], int sub) {
#pragma unroll
  for (int m = 1; m < L; m <<= 1) {
    const bool high = sub & m;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float other = __shfl_xor_sync(FULL_MASK, v[k][i], m);
        v[k][i] = high ? other - v[k][i] : v[k][i] + other;
      }
    }
  }
}

// the stages over the bits of k below M: pairs (k, k + m) of this lane
template <int K, int M>
__device__ __forceinline__ void stages_across_chunks(float (&v)[K][4]) {
#pragma unroll
  for (int m = 1; m < M; m <<= 1) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (k & m) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = v[k][i], b = v[k + m][i];
        v[k][i] = a + b;
        v[k + m][i] = a - b;
      }
    }
  }
}

// Rows of n = 2^LOG_N, 4 <= n <= 512: L lanes a row, 32 / L rows a warp.
template <int LOG_N>
__global__ void __launch_bounds__(WARP_KERNEL_THREADS)
fht_warp_kernel(const float* __restrict__ x, float* __restrict__ y, int64_t rows) {
  constexpr int N = 1 << LOG_N;
  constexpr int L = N / 4 < 32 ? N / 4 : 32;
  constexpr int K = N / (4 * L);
  constexpr int ROWS_A_WARP = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;
  const int64_t warp = (int64_t)blockIdx.x * (WARP_KERNEL_THREADS / 32) + (threadIdx.x >> 5);
  const int64_t row = warp * ROWS_A_WARP + lane / L;
  const bool live = row < rows;  // every lane runs the shuffles; only live rows touch memory
  const int64_t at = row * N + 4 * sub;
  float v[K][4];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const float4 f = live ? *reinterpret_cast<const float4*>(x + at + 4 * L * k)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
    v[k][0] = f.x, v[k][1] = f.y, v[k][2] = f.z, v[k][3] = f.w;
  }
  stages_in_registers<K>(v);
  stages_across_lanes<K, L>(v, sub);
  stages_across_chunks<K, K>(v);
  if (!live) return;
#pragma unroll
  for (int k = 0; k < K; ++k)
    *reinterpret_cast<float4*>(y + at + 4 * L * k) = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
}

template <int LOG_N>
struct BlockGeo {
  static constexpr int N = 1 << LOG_N;
  static constexpr int SEGS = N / WARP_N;                // 512-element segments a row
  static constexpr int WARPS = SEGS < 16 ? SEGS : 16;
  static constexpr int SEGS_A_WARP = SEGS / WARPS;
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int COLS = WARP_N / THREADS;          // columns a thread in phase 2
  static constexpr int SMEM_BYTES = N * 4;
};

// One row of n = 2^LOG_N, 1024 <= n <= 32768, a block (blockIdx.x = row).
template <int LOG_N>
__global__ void __launch_bounds__(BlockGeo<LOG_N>::THREADS)
fht_block_kernel(const float* __restrict__ x, float* __restrict__ y) {
  using BG = BlockGeo<LOG_N>;
  extern __shared__ float4 smem4[];
  float* s = reinterpret_cast<float*>(smem4);
  const int64_t base = (int64_t)blockIdx.x * BG::N;
  const int lane = threadIdx.x & 31;
  {
    // phase 1: the warp's segments, element 128 * k + 4 * lane + i of its span
    constexpr int K = 4 * BG::SEGS_A_WARP;
    const int span = (threadIdx.x >> 5) * BG::SEGS_A_WARP * WARP_N + 4 * lane;
    float v[K][4];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(x + base + span + 128 * k);
      v[k][0] = f.x, v[k][1] = f.y, v[k][2] = f.z, v[k][3] = f.w;
    }
    stages_in_registers<K>(v);
    stages_across_lanes<K, 32>(v, lane);
    stages_across_chunks<K, 4>(v);  // h = 128, 256: inside a segment
#pragma unroll
    for (int k = 0; k < K; ++k)
      smem4[(span + 128 * k) / 4] = make_float4(v[k][0], v[k][1], v[k][2], v[k][3]);
  }
  __syncthreads();
  // phase 2: column c of the [SEGS, 512] view, stages h = 512 .. n / 2
#pragma unroll
  for (int cc = 0; cc < BG::COLS; ++cc) {
    const int c = threadIdx.x + BG::THREADS * cc;
    float u[BG::SEGS];
#pragma unroll
    for (int r = 0; r < BG::SEGS; ++r) u[r] = s[c + WARP_N * r];
#pragma unroll
    for (int m = 1; m < BG::SEGS; m <<= 1) {
#pragma unroll
      for (int r = 0; r < BG::SEGS; ++r) {
        if (r & m) continue;
        const float a = u[r], b = u[r + m];
        u[r] = a + b;
        u[r + m] = a - b;
      }
    }
#pragma unroll
    for (int r = 0; r < BG::SEGS; ++r) y[base + c + WARP_N * r] = u[r];
  }
}

// n = 2: a row a thread
__global__ void __launch_bounds__(PASS_THREADS)
fht_pair_kernel(const float2* __restrict__ x, float2* __restrict__ y, int64_t rows) {
  const int64_t r = (int64_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (r >= rows) return;
  const float2 f = x[r];
  y[r] = make_float2(f.x + f.y, f.x - f.y);
}

// One stage h of rows of length n, in place: pair p of row r is
// (j, j + h) with j = (i / h) * 2h + i % h, i = p % (n / 2).
__global__ void __launch_bounds__(PASS_THREADS)
fht_stage_kernel(float* __restrict__ y, int64_t pairs, int64_t n, int64_t h) {
  const int64_t p = (int64_t)blockIdx.x * PASS_THREADS + threadIdx.x;
  if (p >= pairs) return;
  const int64_t half = n >> 1;
  const int64_t r = p / half;
  const int64_t i = p - r * half;
  const int64_t j = ((i & ~(h - 1)) << 1) | (i & (h - 1));
  float* row = y + r * n;
  const float a = row[j];
  const float b = row[j + h];
  row[j] = a + b;
  row[j + h] = a - b;
}

unsigned blocks_for(int64_t items, int64_t per_block) {
  return (unsigned)((items + per_block - 1) / per_block);
}

template <int LOG_N>
cudaError_t launch_warp(const float* x, float* y, int64_t rows, cudaStream_t stream) {
  constexpr int N = 1 << LOG_N;
  constexpr int L = N / 4 < 32 ? N / 4 : 32;
  constexpr int ROWS_A_BLOCK = WARP_KERNEL_THREADS / 32 * (32 / L);
  fht_warp_kernel<LOG_N><<<blocks_for(rows, ROWS_A_BLOCK), WARP_KERNEL_THREADS, 0, stream>>>(
      x, y, rows);
  return cudaGetLastError();
}

template <int LOG_N>
cudaError_t launch_block(const float* x, float* y, int64_t rows, cudaStream_t stream) {
  using BG = BlockGeo<LOG_N>;
  static bool prepared[64] = {};  // the shared-memory attribute, per device
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (!prepared[device % 64]) {
    err = cudaFuncSetAttribute(fht_block_kernel<LOG_N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               BG::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    prepared[device % 64] = true;
  }
  fht_block_kernel<LOG_N><<<(unsigned)rows, BG::THREADS, BG::SMEM_BYTES, stream>>>(x, y);
  return cudaGetLastError();
}

cudaError_t launch_rows(int log_n, const float* x, float* y, int64_t rows, cudaStream_t stream) {
  switch (log_n) {
    case 2: return launch_warp<2>(x, y, rows, stream);
    case 3: return launch_warp<3>(x, y, rows, stream);
    case 4: return launch_warp<4>(x, y, rows, stream);
    case 5: return launch_warp<5>(x, y, rows, stream);
    case 6: return launch_warp<6>(x, y, rows, stream);
    case 7: return launch_warp<7>(x, y, rows, stream);
    case 8: return launch_warp<8>(x, y, rows, stream);
    case 9: return launch_warp<9>(x, y, rows, stream);
    case 10: return launch_block<10>(x, y, rows, stream);
    case 11: return launch_block<11>(x, y, rows, stream);
    case 12: return launch_block<12>(x, y, rows, stream);
    case 13: return launch_block<13>(x, y, rows, stream);
    case 14: return launch_block<14>(x, y, rows, stream);
    case 15: return launch_block<15>(x, y, rows, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dynamic shared memory a block takes for rows of length n, bytes (0: the
// warp scheme, rows of 512 or fewer)
extern "C" int rabitq_fht_smem_bytes(int n) {
  if (n <= WARP_N) return 0;
  return (n < (1 << MAX_BLOCK_LOG_N) ? n : (1 << MAX_BLOCK_LOG_N)) * (int)sizeof(float);
}

extern "C" int rabitq_fht(const void* x_, void* y_, long long rows, int n, void* stream_) {
  const float* x = (const float*)x_;
  float* y = (float*)y_;
  cudaStream_t stream = (cudaStream_t)stream_;
  if (rows <= 0) return 0;
  if (n <= 0 || (n & (n - 1))) return (int)cudaErrorInvalidValue;
  int log_n = 0;
  while ((1 << log_n) < n) ++log_n;
  if (n == 1)
    return (int)cudaMemcpyAsync(y, x, (size_t)rows * sizeof(float), cudaMemcpyDeviceToDevice,
                                stream);
  if (n == 2) {
    fht_pair_kernel<<<blocks_for(rows, PASS_THREADS), PASS_THREADS, 0, stream>>>(
        (const float2*)x, (float2*)y, rows);
    return (int)cudaGetLastError();
  }
  // rows longer than a block holds: segments of 2^MAX_BLOCK_LOG_N first
  const int seg_log = log_n < MAX_BLOCK_LOG_N ? log_n : MAX_BLOCK_LOG_N;
  const int64_t seg_rows = rows * (int64_t)(n >> seg_log);
  cudaError_t err = launch_rows(seg_log, x, y, seg_rows, stream);
  if (err != cudaSuccess) return (int)err;
  const int64_t pairs = rows * (int64_t)(n / 2);
  for (int64_t h = (int64_t)1 << seg_log; h < n; h <<= 1) {
    fht_stage_kernel<<<blocks_for(pairs, PASS_THREADS), PASS_THREADS, 0, stream>>>(y, pairs, n, h);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
