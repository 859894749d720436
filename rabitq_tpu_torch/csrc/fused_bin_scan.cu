// Fused EXACT bin scan: stream a dense int8 code plane against f32 queries
// and reduce the per-row distances into per-query bins, row n -> bin n % L.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_fused_scan.py fused_bin_scan
// in direct mode (_tile_update, _kernel for the dense walk, _kernel_compact
// for the compacted tile lists). For query b and row n of tile t:
//
//   g   = bf16 g1[b, cluster_of[n]]   if cluster_of[n] lies in tile t's
//         W-wide cluster window starting at 128 * c_blk[t], else 0
//   dot = <plane[n], q[b]>                          (f32 query)
//         f32(<plane[n], q8[b]>) * q_scale[b]       (int8 query: an exact
//                                                    integer dot, rounded once)
//   lb  = fa[n] + fr[n] * (dot + k1x[b]) + g        (f32, this order)
//
// bins_val[b, l] is the minimum of lb over rows n == l (mod L), bins_idx the
// row that first reached it in ascending tile order (strict <, so the first
// row wins a tie; -1 when nothing beat the BIG initial value), offered[b, u]
// counts rows with u == n % 128 and lb < BIG / 2.
//
// Bound on the H100: operations. Each (query, row) pair costs D multiply-adds
// against D bytes of codes shared by every query of the batch, so the work
// is a matrix product and its bound the bf16 tensor rate. Design: the dot
// runs on the tensor cores (mma_tile.cuh). An f32 query (mode DENSE_BF16X3):
// the int8 codes are exact in bf16; the query arrives as three bf16 planes
// hi + mid + lo (ops/fused_scan.py split_bf16x3, laid out by query_image), so
// each product is exact in f32 and the sum keeps f32 accuracy at three
// tensor-core products a column. A query that is an integer grid with a
// per-query scale (an int8 or int4 upload that is not rotated; mode DENSE_S8,
// S8Walk): one s8 product a column with an exact s32 sum, the codes and a
// byte of query a column straight from shared memory, so that L2 carries
// the codes and a sixth as many query bytes as before. The bin of row n depends only on its tile t (group
// t % GROUPS) and its place u in the tile, so a block owns QB queries x one
// group x RU of the tile's rows, and its bins stay in registers, indexed like
// the accumulator fragment, for the whole walk: no atomics on the bins, and
// the first-wins tie rule holds because each block walks its tiles in
// ascending order (dense walk), or in list order (compacted walk; the lists
// are built ascending).

#include <type_traits>

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using G = Geo<DENSE_BF16X3>;

// MODE DENSE_BF16X3 or DENSE_S8
template <int MODE>
__global__ void __launch_bounds__(THREADS, 2)
bin_scan_kernel(const int8_t* __restrict__ plane,    // [n_tiles * TN, d]
                const uint8_t* __restrict__ q_image, // [bp / QB, img_bytes]
                const float* __restrict__ q_scale,   // [bp] (DENSE_S8)
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
  constexpr bool INT8 = MODE == DENSE_S8;
  float kx[4][2], qs[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      kx[j][e] = k1x[q0 + frag_query(j, e)];
      if constexpr (INT8) qs[j][e] = q_scale[q0 + frag_query(j, e)];
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

  // a block's image: three bf16 planes of d columns, or a byte a column
  const int64_t img_bytes = INT8 ? (int64_t)QB * d : (int64_t)(d / G::CODE_BYTES) * G::Q_BYTES;
  std::conditional_t<INT8, S8Walk, Walk<DENSE_BF16X3>> walk(
      reinterpret_cast<const uint8_t*>(plane), d, q_image + blockIdx.x * img_bytes, list, steps,
      group, n_tiles, r0, smem);
  while (walk.valid()) {
    const int t = walk.tile();
    const int64_t row_base = (int64_t)t * TN + r0;
    // the rows' terms are asked for before the dot, so they arrive under it
    const int cbase = c_blk[t] * 128;
    float fan[2][2], frn[2][2];
    int cln[2][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = row_base + frag_row(mt, h);
        fan[mt][h] = fa[n];
        frn[mt][h] = fr[n];
        cln[mt][h] = cluster_of[n];
      }
    }
    typename Acc<MODE>::type acc[2][16];
    walk.dot(acc);

    // epilogue: f32 in the reference's order, no contraction
    // A thread's rows mostly share one cluster (rows are cluster-sorted), so
    // the g values of its queries are gathered once per run of equal clusters.
    int cl_held = -1;
    float g1v[4][2];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int n = (int)row_base + frag_row(mt, h);
        const int cl = cln[mt][h];
        const int loc = cl - cbase;
        const bool inwin = loc >= 0 && loc < WIN && cl < c_pad;
        if (inwin && cl != cl_held) {
          cl_held = cl;
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e)
              g1v[j][e] =
                  __bfloat162float(g1[(int64_t)(q0 + frag_query(j, e)) * c_pad + cl]);
          }
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * h + e;
            const float g = inwin ? g1v[j][e] : 0.0f;
            float dot;
            if constexpr (INT8)
              dot = __fmul_rn(__int2float_rn(acc[mt][i]), qs[j][e]);
            else
              dot = acc[mt][i];
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
int launch(const void* plane, const void* q_image, const void* q_scale, const void* fa,
           const void* fr, const void* cluster_of, const void* k1x, const void* g1,
           const void* c_blk, const void* tiles, const void* tcount, void* out_val,
           void* out_idx, void* offered, int n_tiles, int d, int bp, int c_pad, int list_len,
           int tb, void* stream) {
  static bool prepared[MAX_DEVICES] = {};  // one per instantiation
  const cudaError_t err = prepare_launch(bin_scan_kernel<MODE>, Geo<MODE>::SMEM_BYTES, prepared);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bp / QB, GROUPS * SLICES);
  bin_scan_kernel<MODE><<<grid, THREADS, Geo<MODE>::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const int8_t*)plane, (const uint8_t*)q_image, (const float*)q_scale, (const float*)fa,
      (const float*)fr, (const int*)cluster_of, (const float*)k1x,
      (const __nv_bfloat16*)g1, (const int*)c_blk, (const int*)tiles,
      (const int*)tcount, (float*)out_val, (int*)out_idx, (int*)offered,
      n_tiles, d, c_pad, list_len, tb);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a block of the kernel takes, bytes, for an f32
// query (q_is_int8 == 0) or an int8 one
extern "C" int rabitq_bin_scan_smem_bytes(int q_is_int8) {
  return q_is_int8 ? Geo<DENSE_S8>::SMEM_BYTES : G::SMEM_BYTES;
}

// q_image: the query as ops/fused_scan.py query_image lays it out, for mode
// "dense_s8" when q_scale is given (an int8 query), else for mode "direct"
// (three bf16 planes in swizzled stage tiles).
extern "C" int rabitq_bin_scan(const void* plane, const void* q_image, const void* q_scale,
                               const void* fa, const void* fr,
                               const void* cluster_of, const void* k1x,
                               const void* g1, const void* c_blk,
                               const void* tiles, const void* tcount,
                               void* out_val, void* out_idx, void* offered,
                               int n_tiles, int d, int bp, int c_pad,
                               int list_len, int tb, void* stream) {
  if (q_scale == nullptr)
    return launch<DENSE_BF16X3>(plane, q_image, q_scale, fa, fr, cluster_of, k1x, g1, c_blk,
                                tiles, tcount, out_val, out_idx, offered, n_tiles, d, bp, c_pad,
                                list_len, tb, stream);
  if (d % Geo<DENSE_S8>::CODE_BYTES) return (int)cudaErrorInvalidValue;
  return launch<DENSE_S8>(plane, q_image, q_scale, fa, fr, cluster_of, k1x, g1, c_blk, tiles,
                          tcount, out_val, out_idx, offered, n_tiles, d, bp, c_pad, list_len, tb,
                          stream);
}
