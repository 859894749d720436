// The survivors' gather-dot (ops/gather_dot.py; index/scan.py _stage2_rerank, _gather_scan): for
// each query b and slot r,
//
//     dots[b, r] = sum_d f32(plane[rows[b, r], d]) * q[b, d],   d < D (q's width; D <= the plane's)
//
// for one plane, or for two planes that share the rows (the 8-bit re-rank: the {0,1} binary
// plane with the bf16-rounded query, the raw ex codes with the f32 query) in one launch. Codes
// are int8 or int32 (raw ex codes past 7 bits), exact in f32; products and sums are f32.
// Not a counterpart of a Pallas kernel: it stands where the JAX package gathers the code rows and
// dots them with XLA ops (rabitq_tpu/index/scan.py:658 _stage2_rerank and :576 _gather_scan,
// jnp.take + einsum), which the port's plain version does as an int8 gather, an f32 copy of the
// [B, R, D] codes and a batched GEMV.
//
// Bound on the H100: bytes. Each survivor row is read once and used by one query (a GEMV with no
// reuse), so the least time is the gathered rows over 3.35 TB/s: at the 8-bit cell's block, 256
// queries x 400 survivors x 2 planes x 1,024 bytes = 210 MB, ~0.061 ms. The arithmetic (one FMA a
// byte) is ~0.2 GFLOP a block, nothing to the card, but a naive I2F a byte would cost about as
// much as the bytes. The design:
//   * a block is one query and 64 of its slots: 8 warps, each warp owns 8 slots in two groups of
//     4 rows; the query (one a plane) waits in shared memory as f32, zero past D, in tiles of
//     2,048 columns, so any width fits and nothing [B, R, D] ever reaches device memory;
//   * a warp reads whole rows: lane l takes the 16-byte vectors l and l + 32 of each of its 4
//     rows at once (8 loads of 16 bytes in flight a lane, 16 warps an SM), neighbouring lanes on
//     neighbouring bytes; a lane reuses the 16 query values of a vector across the 4 rows;
//   * int8 codes become f32 with integer ops: __byte_perm puts a byte, biased by 128, under the
//     exponent of 2^23 and one FADD takes 2^23 + 128 off, exact; then one FFMA. int32 codes take
//     one I2F each (a quarter of the conversions a byte);
//   * each row's lane sums are reduced in f32 by warp shuffles and written as [B, R] directly.
// A plane whose width or row stride in bytes, or base address, is not a multiple of 16 (a
// MatrixRotator width such as 100) takes a scalar path: one element a lane at a time. A row
// index outside [0, rows of the plane) gives NaN. No atomics: every sum is added in one fixed
// order, so two calls, and a graph replay, give equal bits. Launches on the caller's stream,
// allocates nothing, never synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int U = 4;                          // rows a warp reads at once
constexpr int GROUPS = 2;                     // groups of U rows a warp owns
constexpr int ROWS_WARP = U * GROUPS;         // 8 slots a warp
constexpr int ROWS_BLOCK = WARPS * ROWS_WARP;  // 64 slots a block
constexpr int TILE = 2048;                    // query columns a plane holds in shared memory

// element kinds; VEC16: rows 16-byte aligned, read as uint4
constexpr int K_S8 = 0, K_S32 = 1;
constexpr int VEC16 = 2;

struct Plane {
  const char* base;
  const float* q;     // [B, D] f32
  float* out;         // [B, R] f32
  long long row_bytes;  // the row stride in bytes
  long long n_rows;
  int width;          // elements a row
  int kind;           // K_* | VEC16
};

struct Args {
  Plane p[2];
  const int64_t* rows;  // [B, R]
  int R, D, chunks, tiles, q_cols;
};

// byte K of w (bytes biased by 128) as an exact f32 with no I2F: 2^23 + byte, less 2^23 + 128
template <int K>
__device__ __forceinline__ float byte_f32(uint32_t w) {
  return __int_as_float((int)__byte_perm(w, 0x4B000000u, 0x7440u | K)) - 8388736.0f;
}

__device__ __forceinline__ float dot_word(uint32_t w, const float* q, float acc) {
  w ^= 0x80808080u;  // int8 -> int8 + 128 in each byte
  acc = fmaf(byte_f32<0>(w), q[0], acc);
  acc = fmaf(byte_f32<1>(w), q[1], acc);
  acc = fmaf(byte_f32<2>(w), q[2], acc);
  return fmaf(byte_f32<3>(w), q[3], acc);
}

// one 16-byte vector of codes against its EV query values
template <int KIND>
__device__ __forceinline__ float dot_vec(const uint4 v, const float* q, float acc) {
  if constexpr (KIND == K_S32) {
    acc = fmaf(__int2float_rn((int)v.x), q[0], acc);
    acc = fmaf(__int2float_rn((int)v.y), q[1], acc);
    acc = fmaf(__int2float_rn((int)v.z), q[2], acc);
    return fmaf(__int2float_rn((int)v.w), q[3], acc);
  } else {
    acc = dot_word(v.x, q, acc);
    acc = dot_word(v.y, q + 4, acc);
    acc = dot_word(v.z, q + 8, acc);
    return dot_word(v.w, q + 12, acc);
  }
}

template <int KIND>
__device__ __forceinline__ float elem_f32(const char* row, int e) {
  if constexpr (KIND == K_S32) return __int2float_rn(__ldg((const int*)row + e));
  else return (float)(int)__ldg((const signed char*)row + e);
}

// this tile's columns [t0, t_end) of U rows, 16-byte vectors: lane takes vectors v and v + 32
template <int KIND>
__device__ __forceinline__ void tile_vec(const char* const (&row)[U], const float* qs, int t0,
                                         int t_end, int lane, float (&acc)[U]) {
  constexpr int EV = KIND == K_S32 ? 4 : 16;  // elements a vector
  const int v_end = (t_end + EV - 1) / EV;
  for (int v = t0 / EV + lane; v < v_end; v += 64) {
    const bool two = v + 32 < v_end;
    uint4 a[U], c[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a[u] = __ldg((const uint4*)row[u] + v);
      c[u] = two ? __ldg((const uint4*)row[u] + v + 32) : make_uint4(0, 0, 0, 0);
    }
    float qv[EV];
#pragma unroll
    for (int i = 0; i < EV; i += 4) {
      const float4 t = *(const float4*)(qs + v * EV - t0 + i);
      qv[i] = t.x, qv[i + 1] = t.y, qv[i + 2] = t.z, qv[i + 3] = t.w;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = dot_vec<KIND>(a[u], qv, acc[u]);
    if (two) {
#pragma unroll
      for (int i = 0; i < EV; i += 4) {
        const float4 t = *(const float4*)(qs + (v + 32) * EV - t0 + i);
        qv[i] = t.x, qv[i + 1] = t.y, qv[i + 2] = t.z, qv[i + 3] = t.w;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) acc[u] = dot_vec<KIND>(c[u], qv, acc[u]);
    }
  }
}

// the same, one element a lane at a time (rows that are not 16-byte aligned)
template <int KIND>
__device__ __forceinline__ void tile_scalar(const char* const (&row)[U], const float* qs, int t0,
                                            int t_end, int lane, float (&acc)[U]) {
#pragma unroll 2
  for (int e = t0 + lane; e < t_end; e += 32) {
    const float qv = qs[e - t0];
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u) x[u] = elem_f32<KIND>(row[u], e);
#pragma unroll
    for (int u = 0; u < U; ++u) acc[u] = fmaf(x[u], qv, acc[u]);
  }
}

template <int NP>
__global__ void __launch_bounds__(THREADS, 2) gather_dot_kernel(const Args a) {
  __shared__ __align__(16) float qs[NP][TILE];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long b = blockIdx.x / a.chunks;
  const int r0 = (int)(blockIdx.x % a.chunks) * ROWS_BLOCK + warp * ROWS_WARP;
  const bool busy = r0 < a.R;  // uniform over the warp
  // lane j < ROWS_WARP holds slot r0 + j's row index
  long long my_row = 0;
  if (lane < ROWS_WARP && r0 + lane < a.R) my_row = a.rows[b * a.R + r0 + lane];

  float acc[NP][GROUPS][U];
#pragma unroll
  for (int p = 0; p < NP; ++p)
#pragma unroll
    for (int g = 0; g < GROUPS; ++g)
#pragma unroll
      for (int u = 0; u < U; ++u) acc[p][g][u] = 0.f;

  for (int t = 0; t < a.tiles; ++t) {
    const int t0 = t * TILE;
    const int n_cols = min(TILE, a.q_cols - t0);
    __syncthreads();  // the previous tile's readers are done
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const float* q = a.p[p].q + b * a.D;
      for (int i = threadIdx.x; i < n_cols; i += THREADS)
        qs[p][i] = t0 + i < a.D ? q[t0 + i] : 0.f;
    }
    __syncthreads();
    if (!busy) continue;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      const Plane& pl = a.p[p];
      const int t_end = min(t0 + TILE, min(a.D, pl.width));
      if (t0 >= t_end) continue;
#pragma unroll
      for (int g = 0; g < GROUPS; ++g) {
        const char* row[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long ri = __shfl_sync(0xffffffffu, my_row, g * U + u);
          row[u] = pl.base + (ri >= 0 && ri < pl.n_rows ? ri : 0) * pl.row_bytes;
        }
        switch (pl.kind) {
          case K_S8 | VEC16: tile_vec<K_S8>(row, qs[p], t0, t_end, lane, acc[p][g]); break;
          case K_S32 | VEC16: tile_vec<K_S32>(row, qs[p], t0, t_end, lane, acc[p][g]); break;
          case K_S8: tile_scalar<K_S8>(row, qs[p], t0, t_end, lane, acc[p][g]); break;
          default: tile_scalar<K_S32>(row, qs[p], t0, t_end, lane, acc[p][g]); break;
        }
      }
    }
  }
  if (!busy) return;
#pragma unroll
  for (int p = 0; p < NP; ++p) {
#pragma unroll
    for (int g = 0; g < GROUPS; ++g) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        float s = acc[p][g][u];
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
        const int j = g * U + u;
        const long long ri = __shfl_sync(0xffffffffu, my_row, j);
        if (lane == 0 && r0 + j < a.R)
          a.p[p].out[b * a.R + r0 + j] = (ri >= 0 && ri < a.p[p].n_rows) ? s : __int_as_float(0x7fc00000);
      }
    }
  }
}

}  // namespace

// Planes [n_rows, width] of element size esize (1 int8, 4 int32), rows of stride elements (the
// column stride 1); plane1 null for one plane. rows [B, R] int64,
// q0 / q1 [B, D] f32 contiguous, out0 / out1 [B, R] f32; D <= each width.
extern "C" int rabitq_gather_dot(const void* plane0, const void* plane1, const void* rows,
                                 const void* q0, const void* q1, void* out0, void* out1,
                                 long long stride0, long long stride1, long long n0, long long n1,
                                 int esize0, int esize1, int width0, int width1, int B, int R,
                                 int D, void* stream_) {
  if (B <= 0 || R <= 0) return 0;
  const int np = plane1 ? 2 : 1;
  const void* base[2] = {plane0, plane1};
  const long long stride[2] = {stride0, stride1}, n[2] = {n0, n1};
  const int esize[2] = {esize0, esize1}, width[2] = {width0, width1};
  const float* q[2] = {(const float*)q0, (const float*)q1};
  float* out[2] = {(float*)out0, (float*)out1};
  Args a{};
  a.rows = (const int64_t*)rows;
  a.R = R;
  a.D = D;
  a.chunks = (R + ROWS_BLOCK - 1) / ROWS_BLOCK;
  a.q_cols = 0;
  for (int p = 0; p < np; ++p) {
    const int bytes = esize[p];
    if ((bytes != 1 && bytes != 4) || D > width[p] || n[p] <= 0)
      return (int)cudaErrorInvalidValue;
    Plane& pl = a.p[p];
    pl.base = (const char*)base[p];
    pl.q = q[p];
    pl.out = out[p];
    pl.row_bytes = stride[p] * bytes;
    pl.n_rows = n[p];
    pl.width = width[p];
    pl.kind = bytes == 4 ? K_S32 : K_S8;
    if (pl.row_bytes % 16 == 0 && (long long)width[p] * bytes % 16 == 0 &&
        ((uintptr_t)base[p]) % 16 == 0)
      pl.kind |= VEC16;
    // query columns a vector of this plane may touch past D (zeros in shared memory)
    const int ev = 16 / bytes;
    const int cols = (pl.kind & VEC16) ? (D + ev - 1) / ev * ev : D;
    a.q_cols = cols > a.q_cols ? cols : a.q_cols;
  }
  a.tiles = (a.q_cols + TILE - 1) / TILE;
  const long long blocks = (long long)B * a.chunks;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream_;
  if (np == 2)
    gather_dot_kernel<2><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  else
    gather_dot_kernel<1><<<(unsigned)blocks, THREADS, 0, s>>>(a);
  return (int)cudaGetLastError();
}
