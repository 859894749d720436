// Packed bin scan: stage 1 of the two-stage search. Stream 1-bit code planes
// against bf16 or int8 queries and reduce the per-row lower bounds into
// per-query bins, row n -> bin n % L.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_fused_scan.py fused_bin_scan
// in packed mode (_tile_update with direct == False; _kernel for the dense
// walk, _kernel_compact for the compacted tile lists). For query b and row n
// of tile t, with cl = cluster_of[n]:
//
//   acc = <bits[n], q[b]>                     f32 sum of exact products (bf16 q)
//         f32(<bits[n], q8[b]>) * q_scale[b]  exact int32 dot (int8 q)
//   g   = f32(g1[b, cl]) + f32(bf16(-fe[n])) * f32(g2[b, cl])
//         if cl lies in tile t's W-wide cluster window starting at
//         128 * c_blk[t], else 0
//   lb  = (fa[n] + fr[n] * (acc + k1x[b])) + g             (f32, this order)
//
// f_error is rounded to bf16 before its product, as the reference's one-hot
// bf16 window matmul does; the product of two bf16 values is exact in f32.
// bins_val, bins_idx and offered are those of fused_bin_scan.cu: the minimum
// over rows n == l (mod L), the row that first reached it in walk order
// (strict <), and the count of rows with lb < BIG / 2 by n % 128.
//
// Bound on the H100: operations. A (query, row) pair costs 8 * Db
// multiply-adds against Db bytes of codes shared by every query of the
// batch, an eighth of the dense plane's bytes. Design: the ownership scheme
// of fused_bin_scan.cu (a block owns QB queries x one bin group x RU of each
// tile's rows, bins in registers for the whole walk, ascending tiles or list
// order, so no atomics on the bins and the first row wins a tie) around the
// bit-plane dots of bitplane_dot.cuh. CUDA cores; the tensor cores come later.

#include "bitplane_dot.cuh"

namespace {

using namespace bitplane;

constexpr int TN = 512;     // rows per tile
constexpr int GROUPS = 16;  // bin groups: L = GROUPS * TN bins
constexpr int WIN = 256;    // cluster window width
constexpr int SLICES = TN / RU;
constexpr float BIG = 1.0e30f;

template <bool INT8>
__global__ void __launch_bounds__(THREADS, 2)
packed_bin_scan_kernel(const uint8_t* __restrict__ packed,  // [n_tiles * TN, db]
                       const void* __restrict__ q,          // [bp, 8 * db]
                       const float* __restrict__ q_scale,   // [bp] (int8 q)
                       const float* __restrict__ fa,        // [n_tiles * TN]
                       const float* __restrict__ fr,
                       const float* __restrict__ fe,
                       const int* __restrict__ cluster_of,
                       const float* __restrict__ k1x,           // [bp]
                       const __nv_bfloat16* __restrict__ g1,    // [bp, c_pad]
                       const __nv_bfloat16* __restrict__ g2,    // [bp, c_pad]
                       const int* __restrict__ c_blk,           // [n_tiles]
                       const int* __restrict__ tiles,   // [bp / tb, list_len] or null
                       const int* __restrict__ tcount,  // [bp / tb] or null
                       float* __restrict__ out_val,     // [bp, GROUPS * TN]
                       int* __restrict__ out_idx,       // [bp, GROUPS * TN]
                       int* __restrict__ offered,       // [bp, 128], zeroed
                       int n_tiles, int db, int c_pad, int list_len, int tb) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];

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
  float qsc[TQ];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
    kx[i] = k1x[q0 + ty * TQ + i];
    qsc[i] = INT8 ? q_scale[q0 + ty * TQ + i] : 1.0f;
  }

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
    if constexpr (INT8) {
      int acc_i[TQ][TR];
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TR; ++j) acc_i[i][j] = 0;
      }
      dot_int8(packed, static_cast<const int8_t*>(q), row_base, q0, db, acc_i, smem);
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TR; ++j)
          acc[i][j] = __fmul_rn((float)acc_i[i][j], qsc[i]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
      }
      dot_bf16(packed, static_cast<const __nv_bfloat16*>(q), row_base, q0, db, acc, smem);
    }

    // epilogue: f32 in the reference's order, no contraction
    const int cbase = c_blk[t] * 128;
#pragma unroll
    for (int j = 0; j < TR; ++j) {
      const int64_t n = row_base + tile_row(tx, j);
      const float faj = fa[n];
      const float frj = fr[n];
      const float nfe = __bfloat162float(__float2bfloat16_rn(-fe[n]));
      const int cl = cluster_of[n];
      const int loc = cl - cbase;
      const bool inwin = loc >= 0 && loc < WIN && cl < c_pad;
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
        const int qq = q0 + ty * TQ + i;
        float g = 0.0f;
        if (inwin) {
          const float g1f = __bfloat162float(g1[(int64_t)qq * c_pad + cl]);
          const float g2f = __bfloat162float(g2[(int64_t)qq * c_pad + cl]);
          g = __fadd_rn(g1f, __fmul_rn(nfe, g2f));
        }
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
      const int u = r0 + tile_row(tx, j);
      out_val[(int64_t)qq * l_bins + group * TN + u] = bval[i][j];
      out_idx[(int64_t)qq * l_bins + group * TN + u] = bidx[i][j];
      if (cnt[i][j]) atomicAdd(&offered[qq * 128 + (u & 127)], cnt[i][j]);
    }
  }
}

}  // namespace

// q_is_int8 != 0: q is int8 with per-query q_scale; else q is bf16 and
// q_scale is not read.
extern "C" int rabitq_packed_bin_scan(
    const void* packed, const void* q, const void* q_scale, const void* fa,
    const void* fr, const void* fe, const void* cluster_of, const void* k1x,
    const void* g1, const void* g2, const void* c_blk, const void* tiles,
    const void* tcount, void* out_val, void* out_idx, void* offered,
    int n_tiles, int db, int bp, int c_pad, int list_len, int tb,
    int q_is_int8, void* stream) {
  dim3 grid(bp / QB, GROUPS * SLICES);
  auto kernel = q_is_int8 ? packed_bin_scan_kernel<true>
                          : packed_bin_scan_kernel<false>;
  kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, q, (const float*)q_scale, (const float*)fa,
      (const float*)fr, (const float*)fe, (const int*)cluster_of,
      (const float*)k1x, (const __nv_bfloat16*)g1, (const __nv_bfloat16*)g2,
      (const int*)c_blk, (const int*)tiles, (const int*)tcount,
      (float*)out_val, (int*)out_idx, (int*)offered, n_tiles, db, c_pad,
      list_len, tb);
  return (int)cudaGetLastError();
}
