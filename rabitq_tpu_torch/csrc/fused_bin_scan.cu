// Fused EXACT bin scan: stream a dense int8 code plane against f32 queries
// and reduce the per-row distances into per-query bins, row n -> bin n % L.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_fused_scan.py fused_bin_scan
// in direct mode (_tile_update, _kernel for the dense walk, _kernel_compact
// for the compacted tile lists). For query b and row n of tile t:
//
//   g  = bf16 g1[b, cluster_of[n]]   if cluster_of[n] lies in tile t's
//        W-wide cluster window starting at 128 * c_blk[t], else 0
//   lb = fa[n] + fr[n] * (<plane[n], q[b]> + k1x[b]) + g     (f32, this order)
//
// bins_val[b, l] is the minimum of lb over rows n == l (mod L), bins_idx the
// row that first reached it in ascending tile order (strict <, so the first
// row wins a tie; -1 when nothing beat the BIG initial value), offered[b, u]
// counts rows with u == n % 128 and lb < BIG / 2.
//
// Bound on the H100: operations. Each (query, row) pair costs D multiply-adds
// against D bytes of codes shared by every query of the batch; at the bf16
// tensor rate (the codes are exact in bf16, and q split into three bf16
// parts keeps f32 accuracy) that work is the bound. This kernel does it as
// f32 CUDA-core FMAs, the product the reference computes, and so runs far
// above that bound (PERF.md). Design: the bin of row n
// depends only on its tile t (group t % GROUPS) and its place u in the
// tile, so a block owns QB queries x one group x RU of the tile's rows, and
// its bins stay in registers for the whole walk: no atomics on the bins, and
// the first-wins tie rule holds because each block walks its tiles in
// ascending order (dense walk), or in list order (compacted walk; the lists
// are built ascending). Each thread keeps a 4 x 8 register tile of
// accumulators fed from shared-memory chunks of q and codes. CUDA-core FMAs;
// tensor-core paths come later.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TN = 512;      // rows per tile
constexpr int GROUPS = 16;   // bin groups: L = GROUPS * TN bins
constexpr int WIN = 256;     // cluster window width
constexpr int QB = 32;       // queries per block
constexpr int RU = 128;      // tile rows per block
constexpr int SLICES = TN / RU;
constexpr int KC = 64;       // k chunk staged in shared memory
constexpr int THREADS = 128; // 8 query groups x 16 row groups
constexpr int TQ = 4;        // queries per thread
constexpr int TR = 8;        // rows per thread
constexpr float BIG = 1.0e30f;

__global__ void __launch_bounds__(THREADS, 2)
bin_scan_kernel(const int8_t* __restrict__ plane,    // [n_tiles * TN, d]
                const float* __restrict__ q,         // [bp, d]
                const float* __restrict__ fa,        // [n_tiles * TN]
                const float* __restrict__ fr,        // [n_tiles * TN]
                const int* __restrict__ cluster_of,  // [n_tiles * TN]
                const float* __restrict__ k1x,       // [bp]
                const __nv_bfloat16* __restrict__ g1,  // [bp, c_pad]
                const int* __restrict__ c_blk,       // [n_tiles]
                const int* __restrict__ tiles,       // [bp / tb, list_len] or null
                const int* __restrict__ tcount,      // [bp / tb] or null
                float* __restrict__ out_val,         // [bp, GROUPS * TN]
                int* __restrict__ out_idx,           // [bp, GROUPS * TN]
                int* __restrict__ offered,           // [bp, 128], zeroed
                int n_tiles, int d, int c_pad, int list_len, int tb) {
  __shared__ __align__(16) float qs[KC * QB];  // [k][query]
  __shared__ __align__(16) float cs[KC * RU];  // [k][row]

  const int tid = threadIdx.x;
  const int ty = tid >> 4;  // query group
  const int tx = tid & 15;  // row group
  const int q0 = blockIdx.x * QB;
  const int group = blockIdx.y / SLICES;
  const int r0 = (blockIdx.y % SLICES) * RU;

  float bval[TQ][TR];
  int bidx[TQ][TR];
  int cnt[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      bval[i][j] = BIG;
      bidx[i][j] = -1;
      cnt[i][j] = 0;
    }
  }
  float kx[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) kx[i] = k1x[q0 + ty * TQ + i];

  int steps;
  const int* list = nullptr;
  if (tiles != nullptr) {
    const int j = q0 / tb;
    list = tiles + (int64_t)j * list_len;
    steps = min(tcount[j], list_len);
  } else {
    steps = (n_tiles - group + GROUPS - 1) / GROUPS;
  }

  for (int s = 0; s < steps; ++s) {
    int t;
    if (list != nullptr) {
      t = list[s];  // uniform across the block
      if (t < 0 || t >= n_tiles || t % GROUPS != group) continue;
    } else {
      t = group + s * GROUPS;
    }
    const int64_t row_base = (int64_t)t * TN + r0;

    float acc[TQ][TR];
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
#pragma unroll
      for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
    }

    for (int k0 = 0; k0 < d; k0 += KC) {
      // q chunk: QB x KC floats, stored [k][query]; consecutive threads take
      // consecutive queries so the transposed stores hit distinct banks
#pragma unroll
      for (int l = 0; l < (QB * KC / 4) / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int qq = idx % QB;
        const int c4 = idx / QB;
        const float4 v = *reinterpret_cast<const float4*>(
            q + (int64_t)(q0 + qq) * d + k0 + c4 * 4);
        qs[(c4 * 4 + 0) * QB + qq] = v.x;
        qs[(c4 * 4 + 1) * QB + qq] = v.y;
        qs[(c4 * 4 + 2) * QB + qq] = v.z;
        qs[(c4 * 4 + 3) * QB + qq] = v.w;
      }
      // code chunk: RU rows x KC bytes, four 16-byte segments per row read
      // by neighbouring threads; stored as floats [k][row]
#pragma unroll
      for (int l = 0; l < (RU * KC / 16) / THREADS; ++l) {
        const int idx = tid + l * THREADS;
        const int r = idx >> 2;
        const int seg = idx & 3;
        const int4 raw = *reinterpret_cast<const int4*>(
            plane + (row_base + r) * d + k0 + seg * 16);
        const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
        for (int e = 0; e < 16; ++e) cs[(seg * 16 + e) * RU + r] = (float)b[e];
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < KC; ++k) {
        const float4 a = *reinterpret_cast<const float4*>(&qs[k * QB + ty * TQ]);
        const float4 c0 = *reinterpret_cast<const float4*>(&cs[k * RU + tx * TR]);
        const float4 c1 = *reinterpret_cast<const float4*>(&cs[k * RU + tx * TR + 4]);
        const float av[TQ] = {a.x, a.y, a.z, a.w};
        const float cv[TR] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
        for (int i = 0; i < TQ; ++i) {
#pragma unroll
          for (int j = 0; j < TR; ++j) acc[i][j] = fmaf(av[i], cv[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

    // epilogue: f32 in the reference's order, no contraction
    const int cbase = c_blk[t] * 128;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int64_t n = row_base + tx * TR + j;
      const float faj = fa[n];
      const float frj = fr[n];
      const int cl = cluster_of[n];
      const int loc = cl - cbase;
      const bool inwin = loc >= 0 && loc < WIN && cl < c_pad;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qq = q0 + ty * TQ + i;
        const float g =
            inwin ? __bfloat162float(g1[(int64_t)qq * c_pad + cl]) : 0.0f;
        const float lb = __fadd_rn(
            __fadd_rn(faj, __fmul_rn(frj, __fadd_rn(acc[i][j], kx[i]))), g);
        cnt[i][j] += lb < 0.5f * BIG ? 1 : 0;
        if (lb < bval[i][j]) {
          bval[i][j] = lb;
          bidx[i][j] = (int)n;
        }
      }
    }
  }

  const int l_bins = GROUPS * TN;
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    const int qq = q0 + ty * TQ + i;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int u = r0 + tx * TR + j;
      out_val[(int64_t)qq * l_bins + group * TN + u] = bval[i][j];
      out_idx[(int64_t)qq * l_bins + group * TN + u] = bidx[i][j];
      if (cnt[i][j]) atomicAdd(&offered[qq * 128 + (u & 127)], cnt[i][j]);
    }
  }
}

}  // namespace

extern "C" int rabitq_bin_scan(const void* plane, const void* q,
                               const void* fa, const void* fr,
                               const void* cluster_of, const void* k1x,
                               const void* g1, const void* c_blk,
                               const void* tiles, const void* tcount,
                               void* out_val, void* out_idx, void* offered,
                               int n_tiles, int d, int bp, int c_pad,
                               int list_len, int tb, void* stream) {
  dim3 grid(bp / QB, GROUPS * SLICES);
  bin_scan_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)plane, (const float*)q, (const float*)fa,
      (const float*)fr, (const int*)cluster_of, (const float*)k1x,
      (const __nv_bfloat16*)g1, (const int*)c_blk, (const int*)tiles,
      (const int*)tcount, (float*)out_val, (int*)out_idx, (int*)offered,
      n_tiles, d, c_pad, list_len, tb);
  return (int)cudaGetLastError();
}
