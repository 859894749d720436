// Unnormalized fast Walsh-Hadamard transform along the last axis of a
// row-major f32 [rows, n] tensor, n a power of two.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_fht.py (_fht_kernel /
// fht_pallas). Stage h updates every pair (j, j + h) with j & h == 0 to
// (x[j] + x[j+h], x[j] - x[j+h]) -- the same single f32 add or subtract per
// element as the plain butterfly in ops/fht.py, so results are bitwise equal.
//
// Bound on the H100: memory. A launch moves 2 * rows * n * 4 bytes and does
// rows * n * log2(n) adds, far below the f32 rate. Design: a block stages
// whole rows in shared memory (at most 8192 floats = 32 KB), runs all log2(n)
// stages there with one barrier per stage, and touches device memory once
// on the way in and once on the way out, with consecutive threads on
// consecutive addresses. Short rows are packed several to a block so every
// block moves at least 2048 floats. A row longer than 8192 runs as n / 8192
// segments through the same kernel (stages h < 8192 never leave a segment),
// then one pass over device memory per remaining stage h >= 8192, each pair
// updated in place by one thread: the same adds in the same order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMinBlockElems = 2048;
constexpr int kSegment = 8192;  // longest run staged in shared memory (32 KB)

__global__ void __launch_bounds__(kThreads)
fht_rows_kernel(const float* __restrict__ x, float* __restrict__ y,
                int rows, int n, int rows_per_block) {
  extern __shared__ float s[];
  const int row0 = blockIdx.x * rows_per_block;
  const int nr = min(rows_per_block, rows - row0);
  const int64_t base = (int64_t)row0 * n;
  const int total = nr * n;
  for (int i = threadIdx.x; i < total; i += kThreads) s[i] = x[base + i];
  __syncthreads();
  const int half = n >> 1;
  const int pairs = nr * half;
  for (int h = 1; h < n; h <<= 1) {
    for (int p = threadIdx.x; p < pairs; p += kThreads) {
      const int r = p / half;
      const int i = p - r * half;
      // i-th pair of the stage: j = (i / h) * 2h + i % h
      const int j = ((i & ~(h - 1)) << 1) | (i & (h - 1));
      float* row = s + r * n;
      const float a = row[j];
      const float b = row[j + h];
      row[j] = a + b;
      row[j + h] = a - b;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < total; i += kThreads) y[base + i] = s[i];
}

// One stage h of rows of length n, in place: pair p of row r is
// (j, j + h) with j = (i / h) * 2h + i % h, i = p % (n / 2).
__global__ void __launch_bounds__(kThreads)
fht_stage_kernel(float* __restrict__ y, int64_t pairs, int n, int h) {
  const int64_t p = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (p >= pairs) return;
  const int half = n >> 1;
  const int64_t r = p / half;
  const int i = (int)(p - r * half);
  const int j = ((i & ~(h - 1)) << 1) | (i & (h - 1));
  float* row = y + r * n;
  const float a = row[j];
  const float b = row[j + h];
  row[j] = a + b;
  row[j + h] = a - b;
}

}  // namespace

extern "C" int rabitq_fht(const void* x, void* y, int rows, int n,
                          void* stream) {
  if (rows <= 0) return 0;
  if (n > kSegment) {
    const int64_t segments = (int64_t)rows * (n / kSegment);
    fht_rows_kernel<<<(unsigned)segments, kThreads, kSegment * sizeof(float),
                      (cudaStream_t)stream>>>((const float*)x, (float*)y,
                                              (int)segments, kSegment, 1);
    const int64_t pairs = (int64_t)rows * (n / 2);
    const unsigned blocks = (unsigned)((pairs + kThreads - 1) / kThreads);
    for (int h = kSegment; h < n; h <<= 1)
      fht_stage_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>((float*)y, pairs, n, h);
    return (int)cudaGetLastError();
  }
  const int rows_per_block = n >= kMinBlockElems ? 1 : kMinBlockElems / n;
  const int blocks = (rows + rows_per_block - 1) / rows_per_block;
  const size_t smem = (size_t)rows_per_block * n * sizeof(float);
  fht_rows_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)x, (float*)y, rows, n, rows_per_block);
  return (int)cudaGetLastError();
}
