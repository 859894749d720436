// <bit planes, q> for a block of QB queries x RU rows on CUDA cores, for the
// packed lower-bound scan (packed_lb_scan.cu). The packed bin scan
// (packed_bin_scan.cu) used these dots until it moved to the tensor-core tile
// of mma_tile.cuh.
//
// A packed row holds Db bytes; byte j, bit k (LSB first) is dimension
// j*8 + k. The query arrives in bit-plane order: position p = k*Db + j holds
// that dimension. Both dots walk p in chunks that stay inside one bit plane
// (Db is a multiple of 128), so a chunk is bit k of bytes j0.. of every row
// against q positions k*Db + j0.. .
//
//   dot_bf16: q is bf16. The chunk's bits are staged in shared memory as
//     floats {0, 1} and q as floats, and each thread runs a TQ x TR register
//     tile of f32 FMAs. Every product is exact; only the order of the f32
//     sum differs from another implementation's.
//   dot_int8: q is int8. Four consecutive positions make one 32-bit word for
//     both operands (the bits of four packed bytes are one shift and one
//     mask: (w >> k) & 0x01010101), and each thread runs its tile with
//     __dp4a into int32. Exact.
//
// CUDA cores only; the lower-bound scan's move to the tensor-core tile is the
// next kernel work (ROADMAP.md B).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace bitplane {

constexpr int QB = 32;        // queries per block
constexpr int RU = 128;       // rows per block
constexpr int THREADS = 128;  // 8 query groups x 16 row groups
constexpr int TQ = 4;         // queries per thread
constexpr int TR = 8;         // rows per thread
constexpr int KC = 64;        // bf16 mode: positions per chunk
constexpr int KC8 = 128;      // int8 mode: positions per chunk (32 words)
constexpr int SMEM_BYTES = (KC * QB + KC * RU) * 4;  // the bf16 mode's need

static_assert(THREADS == RU, "each thread stages one row of the chunk");
static_assert(TR == 8 && RU == 16 * TR, "tile_row's two runs of four rows");
static_assert((KC8 / 4) * (QB + RU) * 4 <= SMEM_BYTES, "int8 chunk fits");

// Row j of thread tx's tile, as an offset in the block's RU rows: two runs of
// four, tx*4.. and RU/2 + tx*4.., so that the 16 row groups of a warp read a
// staged chunk with contiguous 16-byte loads (a run of eight per thread
// would put them 32 bytes apart, on conflicting banks).
__device__ __forceinline__ int tile_row(int tx, int j) {
  return (j < 4 ? 0 : RU / 2 - 4) + tx * 4 + j;
}

// acc[i][j] += <bits of row row_base + tile_row(tx, j), q[q0 + ty*TQ + i]>
__device__ __forceinline__ void dot_bf16(
    const uint8_t* __restrict__ packed,    // [rows, db]
    const __nv_bfloat16* __restrict__ q,   // [bp, 8 * db]
    int64_t row_base, int q0, int db, float (&acc)[TQ][TR],
    unsigned char* smem) {
  float* qs = reinterpret_cast<float*>(smem);  // [KC][QB]
  float* cs = qs + KC * QB;                    // [KC][RU]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int d8 = 8 * db;
  for (int k0 = 0; k0 < d8; k0 += KC) {
    const int plane = k0 / db;
    const int j0 = k0 - plane * db;
    // q chunk: QB x KC bf16, eight to a 16-byte load; consecutive threads
    // take consecutive queries so the transposed stores hit distinct banks
#pragma unroll
    for (int l = 0; l < (QB * KC / 8) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int qq = idx % QB;
      const int c8 = idx / QB;
      const uint4 raw = *reinterpret_cast<const uint4*>(
          q + (int64_t)(q0 + qq) * d8 + k0 + c8 * 8);
      const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        qs[(c8 * 8 + e) * QB + qq] = __bfloat162float(h[e]);
    }
    // code chunk: thread r stages bit `plane` of KC bytes of row r
#pragma unroll
    for (int l = 0; l < KC / 16; ++l) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          packed + (row_base + tid) * db + j0 + l * 16);
      const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
#pragma unroll
      for (int e = 0; e < 16; ++e)
        cs[(l * 16 + e) * RU + tid] = (float)((b[e] >> plane) & 1);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < KC; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&qs[k * QB + ty * TQ]);
      const float4 c0 = *reinterpret_cast<const float4*>(&cs[k * RU + tx * 4]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&cs[k * RU + RU / 2 + tx * 4]);
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
}

// acc[i][j] += <bits of row row_base + tile_row(tx, j), q[q0 + ty*TQ + i]> (int32)
__device__ __forceinline__ void dot_int8(
    const uint8_t* __restrict__ packed,  // [rows, db], db % KC8 == 0
    const int8_t* __restrict__ q,        // [bp, 8 * db]
    int64_t row_base, int q0, int db, int (&acc)[TQ][TR],
    unsigned char* smem) {
  constexpr int WORDS = KC8 / 4;
  int* qs = reinterpret_cast<int*>(smem);  // [WORDS][QB]
  int* cs = qs + WORDS * QB;               // [WORDS][RU]
  const int tid = threadIdx.x;
  const int ty = tid >> 4;
  const int tx = tid & 15;
  const int d8 = 8 * db;
  for (int k0 = 0; k0 < d8; k0 += KC8) {
    const int plane = k0 / db;
    const int j0 = k0 - plane * db;
#pragma unroll
    for (int l = 0; l < (QB * KC8 / 16) / THREADS; ++l) {
      const int idx = tid + l * THREADS;
      const int qq = idx % QB;
      const int c16 = idx / QB;
      const int4 raw = *reinterpret_cast<const int4*>(
          q + (int64_t)(q0 + qq) * d8 + k0 + c16 * 16);
      qs[(c16 * 4 + 0) * QB + qq] = raw.x;
      qs[(c16 * 4 + 1) * QB + qq] = raw.y;
      qs[(c16 * 4 + 2) * QB + qq] = raw.z;
      qs[(c16 * 4 + 3) * QB + qq] = raw.w;
    }
#pragma unroll
    for (int l = 0; l < KC8 / 16; ++l) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          packed + (row_base + tid) * db + j0 + l * 16);
      cs[(l * 4 + 0) * RU + tid] = (int)((raw.x >> plane) & 0x01010101u);
      cs[(l * 4 + 1) * RU + tid] = (int)((raw.y >> plane) & 0x01010101u);
      cs[(l * 4 + 2) * RU + tid] = (int)((raw.z >> plane) & 0x01010101u);
      cs[(l * 4 + 3) * RU + tid] = (int)((raw.w >> plane) & 0x01010101u);
    }
    __syncthreads();
#pragma unroll 8
    for (int w = 0; w < WORDS; ++w) {
      const int4 a = *reinterpret_cast<const int4*>(&qs[w * QB + ty * TQ]);
      const int4 c0 = *reinterpret_cast<const int4*>(&cs[w * RU + tx * 4]);
      const int4 c1 = *reinterpret_cast<const int4*>(&cs[w * RU + RU / 2 + tx * 4]);
      const int av[TQ] = {a.x, a.y, a.z, a.w};
      const int cv[TR] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int i = 0; i < TQ; ++i) {
#pragma unroll
        for (int j = 0; j < TR; ++j) acc[i][j] = __dp4a(av[i], cv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace bitplane
