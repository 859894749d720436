// Packed lower-bound scan: the dense [B, N] bf16 plane of stage-1 lower
// bounds from 1-bit code planes.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_scan.py packed_lb_scan
// (_lb_kernel). For query b and row n:
//
//   out[b, n] = bf16((fa[n] + fr[n] * (<bits[n], q[b]> + k1x[b])) + f32(g[b, n]))
//
// with the dot a f32 sum of exact products (bf16 q, bits {0, 1}), the
// epilogue in f32 in this order without contraction, and one rounding (to
// nearest even) at the store. g arrives unmasked; the caller masks the plane.
//
// Bound on the H100: operations at the main path's shapes (256 queries: 2 *
// 8 * Db flops per pair against 4 bytes of g and out per pair), bytes for
// small batches. Design: a block takes QB queries x RU rows, runs the
// bit-plane dot of bitplane_dot.cuh with the accumulators in registers, and
// applies the epilogue there; each thread reads and writes its g values and
// results four at a time (8-byte accesses, a warp's sixteen side by side), so
// the [B, N] planes move once and nothing else touches device memory. CUDA
// cores; the tensor cores come later.

#include "bitplane_dot.cuh"

namespace {

using namespace bitplane;

__global__ void __launch_bounds__(THREADS, 2)
packed_lb_kernel(const uint8_t* __restrict__ packed,       // [n, db]
                 const __nv_bfloat16* __restrict__ q,      // [bp, 8 * db]
                 const float* __restrict__ fa,             // [n]
                 const float* __restrict__ fr,             // [n]
                 const float* __restrict__ k1x,            // [bp]
                 const __nv_bfloat16* __restrict__ g,      // [bp, n]
                 __nv_bfloat16* __restrict__ out,          // [bp, n]
                 int64_t n, int db) {
  __shared__ __align__(16) unsigned char smem[SMEM_BYTES];

  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int64_t row_base = (int64_t)blockIdx.x * RU;
  const int q0 = blockIdx.y * QB;

  float acc[TQ][TR];
#pragma unroll
  for (int i = 0; i < TQ; ++i) {
#pragma unroll
    for (int j = 0; j < TR; ++j) acc[i][j] = 0.0f;
  }
  dot_bf16(packed, q, row_base, q0, db, acc, smem);

  // the thread's rows are two runs of four (tile_row): each run's g values
  // and results move as one 8-byte access per query
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t row = row_base + tile_row(tx, 4 * h);
    const float4 fa4 = *reinterpret_cast<const float4*>(fa + row);
    const float4 fr4 = *reinterpret_cast<const float4*>(fr + row);
    const float faj[4] = {fa4.x, fa4.y, fa4.z, fa4.w};
    const float frj[4] = {fr4.x, fr4.y, fr4.z, fr4.w};
#pragma unroll
    for (int i = 0; i < TQ; ++i) {
      const int qq = q0 + ty * TQ + i;
      const float kx = k1x[qq];
      const int64_t off = (int64_t)qq * n + row;
      const uint2 graw = *reinterpret_cast<const uint2*>(g + off);
      const __nv_bfloat16* gh = reinterpret_cast<const __nv_bfloat16*>(&graw);
      uint2 oraw;
      __nv_bfloat16* oh = reinterpret_cast<__nv_bfloat16*>(&oraw);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float lb = __fadd_rn(
            __fadd_rn(faj[j],
                      __fmul_rn(frj[j], __fadd_rn(acc[i][4 * h + j], kx))),
            __bfloat162float(gh[j]));
        oh[j] = __float2bfloat16_rn(lb);
      }
      *reinterpret_cast<uint2*>(out + off) = oraw;
    }
  }
}

}  // namespace

extern "C" int rabitq_packed_lb_scan(const void* packed, const void* q,
                                     const void* fa, const void* fr,
                                     const void* k1x, const void* g,
                                     void* out, int n, int db, int bp,
                                     void* stream) {
  dim3 grid(n / RU, bp / QB);
  packed_lb_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const __nv_bfloat16*)q, (const float*)fa,
      (const float*)fr, (const float*)k1x, (const __nv_bfloat16*)g,
      (__nv_bfloat16*)out, (int64_t)n, db);
  return (int)cudaGetLastError();
}
