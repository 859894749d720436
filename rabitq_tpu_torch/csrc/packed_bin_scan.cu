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
// batch, an eighth of the dense plane's bytes; the bound is the bf16 tensor
// rate for a bf16 query and the int8 tensor rate for an int8 one. Design: the
// ownership scheme of fused_bin_scan.cu (a block owns QB queries x one bin
// group x RU of each tile's rows, bins in registers for the whole walk,
// ascending tiles or list order, so no atomics on the bins and the first row
// wins a tie) around the tensor-core tile of mma_tile.cuh: the packed bytes
// go to shared memory as they are and each thread unpacks the bits of its own
// fragment rows in registers, to bf16 {0, 1} (mode BITS_BF16, every product
// exact, f32 accumulators) or to s8 {0, 1} (mode BITS_S8, s32 accumulators:
// the exact integer dot).

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;

template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
packed_bin_scan_kernel(const uint8_t* __restrict__ packed,  // [n_tiles * TN, db]
                       const uint8_t* __restrict__ q_image, // [bp / QB, db / 32 stages]
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
  using G = Geo<MODE>;
  constexpr bool INT8 = MODE == BITS_S8;
  extern __shared__ unsigned char smem[];

  const int q0 = blockIdx.x * QB;
  const int group = blockIdx.y / SLICES;
  const int r0 = (blockIdx.y % SLICES) * RU;

  // bins, indexed like the accumulators: [mt][4j + 2h + e]
  float bval[2][16];
  int bidx[2][16];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      bval[mt][i] = BIG;
      bidx[mt][i] = -1;
    }
  }
  Offered off;
  float kx[4][2];
  float qsc[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kx[j][e] = k1x[q0 + frag_query(j, e)];
      qsc[j][e] = INT8 ? q_scale[q0 + frag_query(j, e)] : 1.0f;
    }
  }

  int steps;
  const int* list = nullptr;
  if (tiles != nullptr) {
    const int lj = q0 / tb;
    list = tiles + (int64_t)lj * list_len;
    steps = min(tcount[lj], list_len);
  } else {
    steps = (n_tiles - group + GROUPS - 1) / GROUPS;
  }

  Walk<MODE> walk(packed, db,
                  q_image + (int64_t)blockIdx.x * (db / G::CODE_BYTES) * G::Q_BYTES,
                  list, steps, group, n_tiles, r0, smem);
  while (walk.valid()) {
    const int t = walk.tile();
    const int64_t row_base = (int64_t)t * TN + r0;
    // the rows' terms are asked for before the dot, so they arrive under it
    const int cbase = c_blk[t] * 128;
    float fan[2][2], frn[2][2], nfen[2][2];
    int cln[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = row_base + frag_row(mt, h);
        fan[mt][h] = fa[n];
        frn[mt][h] = fr[n];
        nfen[mt][h] = -fe[n];
        cln[mt][h] = cluster_of[n];
      }
    }
    typename Acc<MODE>::type acc[2][16];
    walk.dot(acc);

    // epilogue: f32 in the reference's order, no contraction
    // A thread's rows mostly share one cluster (rows are cluster-sorted), so
    // the g values of its queries are gathered once per run of equal clusters.
    int cl_held = -1;
    float g1v[4][2], g2v[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = (int)row_base + frag_row(mt, h);
        const float nfe = __bfloat162float(__float2bfloat16_rn(nfen[mt][h]));
        const int cl = cln[mt][h];
        const int loc = cl - cbase;
        const bool inwin = loc >= 0 && loc < WIN && cl < c_pad;
        if (inwin && cl != cl_held) {
          cl_held = cl;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int64_t at = (int64_t)(q0 + frag_query(j, e)) * c_pad + cl;
              g1v[j][e] = __bfloat162float(g1[at]);
              g2v[j][e] = __bfloat162float(g2[at]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            float dot;
            if constexpr (INT8) {
              dot = __fmul_rn((float)acc[mt][i], qsc[j][e]);
            } else {
              dot = acc[mt][i];
            }
            const float g =
                inwin ? __fadd_rn(g1v[j][e], __fmul_rn(nfe, g2v[j][e])) : 0.0f;
            const float lb = __fadd_rn(
                __fadd_rn(fan[mt][h], __fmul_rn(frn[mt][h], __fadd_rn(dot, kx[j][e]))), g);
            off.add(mt, j, h, e, lb < 0.5f * BIG);
            if (lb < bval[mt][i]) {
              bval[mt][i] = lb;
              bidx[mt][i] = n;
            }
          }
        }
      }
    }
    off.tile_done(offered, q0);
    walk.next();
  }
  off.flush(offered, q0);

  const int l_bins = GROUPS * TN;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int u = r0 + frag_row(mt, h);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * j + 2 * h + e;
          const int qq = q0 + frag_query(j, e);
          out_val[(int64_t)qq * l_bins + group * TN + u] = bval[mt][i];
          out_idx[(int64_t)qq * l_bins + group * TN + u] = bidx[mt][i];
        }
      }
    }
  }
}

template <int MODE>
int launch(const void* packed, const void* q_image, const void* q_scale, const void* fa,
           const void* fr, const void* fe, const void* cluster_of, const void* k1x,
           const void* g1, const void* g2, const void* c_blk, const void* tiles,
           const void* tcount, void* out_val, void* out_idx, void* offered,
           int n_tiles, int db, int bp, int c_pad, int list_len, int tb, void* stream) {
  using G = Geo<MODE>;
  static bool prepared[MAX_DEVICES] = {};  // one per MODE
  const cudaError_t err =
      prepare_launch(packed_bin_scan_kernel<MODE>, G::SMEM_BYTES, prepared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bp / QB, GROUPS * SLICES);
  packed_bin_scan_kernel<MODE><<<grid, THREADS, G::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)q_image, (const float*)q_scale,
      (const float*)fa, (const float*)fr, (const float*)fe, (const int*)cluster_of,
      (const float*)k1x, (const __nv_bfloat16*)g1, (const __nv_bfloat16*)g2,
      (const int*)c_blk, (const int*)tiles, (const int*)tcount,
      (float*)out_val, (int*)out_idx, (int*)offered, n_tiles, db, c_pad,
      list_len, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a block of the kernel takes, bytes
extern "C" int rabitq_packed_bin_scan_smem_bytes(int q_is_int8) {
  return q_is_int8 ? Geo<BITS_S8>::SMEM_BYTES : Geo<BITS_BF16>::SMEM_BYTES;
}

// q_image: the query as ops/fused_scan.py query_image lays it out, for mode
// "bits_s8" when q_is_int8 != 0 (q_scale holds the per-query scales), else
// for mode "bits_bf16" (q_scale is not read).
extern "C" int rabitq_packed_bin_scan(
    const void* packed, const void* q_image, const void* q_scale, const void* fa,
    const void* fr, const void* fe, const void* cluster_of, const void* k1x,
    const void* g1, const void* g2, const void* c_blk, const void* tiles,
    const void* tcount, void* out_val, void* out_idx, void* offered,
    int n_tiles, int db, int bp, int c_pad, int list_len, int tb,
    int q_is_int8, void* stream) {
  auto fn = q_is_int8 ? launch<BITS_S8> : launch<BITS_BF16>;
  return fn(packed, q_image, q_scale, fa, fr, fe, cluster_of, k1x, g1, g2, c_blk, tiles,
            tcount, out_val, out_idx, offered, n_tiles, db, bp, c_pad, list_len, tb, stream);
}
