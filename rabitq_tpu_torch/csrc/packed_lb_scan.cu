// Packed lower-bound scan: the dense [B, N] bf16 plane of stage-1 lower
// bounds from 1-bit code planes, on the tensor-core tile of mma_tile.cuh.
//
// Replaces the TPU kernel rabitq_tpu/ops/pallas_scan.py packed_lb_scan
// (_lb_kernel). For query b and row n, with the dot a f32 sum of exact
// products (bits {0, 1} against a bf16 query in bit-plane order):
//
//   lb[b, n] = bf16((fa[n] + fr[n] * (<bits[n], q[b]> + k1x[b])) + f32(g))
//
// in f32, in this order, without contraction, one rounding at the end. Two
// epilogues on one mainloop, chosen by a template parameter:
//
//   G_PLANE  the TPU contract: g = g_comb[b, n] read from a [B, N] bf16
//            plane, out[b, n] = lb[b, n]. Callers mask the plane.
//   G_TABLE  stage 1 of the dense "packed" scan (index/scan.py) as one
//            function: with cl = cluster_of[n],
//              g   = bf16(f32(g_add[b, cl]) - f_error[n] * f32(g_err[b, cl]))
//              out = -inf              if !(probe[b, cl] && allowed[n])
//                    +inf              if lb is not finite (never prune)
//                    -lb               otherwise
//            g_add and g_err arrive as one word per (query, cluster) (bf16
//            pair, g_add in the low half: 4 MB at 256 x 4096, L2-resident),
//            probe as one bit per query (a word for the block's 32 queries
//            per cluster), and a pair's g word is read only where it is
//            allowed.
//
// Bound on the H100: operations. A (query, row) pair costs 8 * Db
// multiply-adds against Db bytes of codes shared by the batch, 2 * 8 * Db
// flops at the bf16 tensor rate (0.53 ms at 256 x 1M x Db 128), against 2
// bytes of output a pair (0.15 ms). So the dot belongs on the tensor cores,
// and the [B, N] plane should cross device memory once: G_TABLE reads no
// [B, N] input at all. Design:
//
// * Mainloop: Walk<BITS_BF16> of mma_tile.cuh (raw packed bytes by cp.async,
//   bits unpacked to bf16 {0, 1} in registers, wgmma m64n32k16, f32 sums),
//   the query as query_image(..., "bits_bf16") lays it out. No bins, so a
//   block owns QB queries x a run of consecutive 128-row tiles and writes
//   each of its pairs once; blocks need no order between them. The wrapper
//   sizes the runs so that the grid is one wave of resident blocks, and the
//   cp.async ring runs across the block's whole run.
// * Everything a tile's epilogue reads that does not depend on a gather is
//   asked for before the dot; G_TABLE also asks for the next tile's row
//   terms there, and for its probe words right after the dot, so that the
//   chain row -> cluster -> probe bit -> g word never stalls a tile.
// * Output: the wgmma fragment puts a query's rows 8 lanes apart. Lanes g
//   and g ^ 1 of a quad row swap one value (__shfl_xor_sync) so that each
//   lane holds two adjacent rows of one query as one 32-bit word, and a
//   warp's store of one (query block j, e) covers whole 32-byte sectors: no
//   shared-memory staging. G_PLANE reads its g words the same way round.

#include "mma_tile.cuh"

namespace {

using namespace mma_tile;
using G = Geo<BITS_BF16>;

enum Epilogue { G_PLANE = 0, G_TABLE = 1 };

constexpr uint32_t BF16_POS_INF = 0x7F80u;
constexpr uint32_t BF16_NEG_INF = 0xFF80u;
constexpr unsigned FULL_MASK = 0xFFFFFFFFu;

__device__ __forceinline__ uint32_t bf16_bits(float x) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_value(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

// Row of the pair word (two adjacent rows) this lane stores or loads for
// M-tile mt: lanes 4g + t with g even take rows g, g + 1 of the warp's 16,
// those with g odd rows 8 + g - 1, 8 + g.
__device__ __forceinline__ int pair_row(int mt) {
  const int g = (threadIdx.x & 31) >> 2;
  return mt * 64 + (threadIdx.x >> 5) * 16 + (g & ~1) + 8 * (g & 1);
}
__device__ __forceinline__ bool odd_quad_row() { return (threadIdx.x >> 2) & 1; }

// Per-row terms of a tile: this thread's rows frag_row(mt, h).
template <int EPI>
struct Rows {
  float fa[2][2], fr[2][2];
  float fe[2][2];
  int cl[2][2];
  bool ok[2][2];  // row allowed and cluster in range
  __device__ __forceinline__ void load(int64_t row_base, const float* fa_, const float* fr_,
                                       const float* fe_, const int* cl_, const uint8_t* allowed,
                                       int n_clusters) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t n = row_base + frag_row(mt, h);
        fa[mt][h] = fa_[n];
        fr[mt][h] = fr_[n];
        if constexpr (EPI == G_TABLE) {
          fe[mt][h] = fe_[n];
          const int c = cl_[n];
          cl[mt][h] = c;
          ok[mt][h] = allowed[n] != 0 && c >= 0 && c < n_clusters;
        }
      }
    }
  }
};

template <int EPI>
__global__ void __launch_bounds__(THREADS, 2)
packed_lb_kernel(const uint8_t* __restrict__ packed,    // [n, db]
                 const uint8_t* __restrict__ q_image,   // [bp / QB, db / 32 stages]
                 const float* __restrict__ fa,          // [n]
                 const float* __restrict__ fr,          // [n]
                 const float* __restrict__ k1x,         // [bp]
                 const uint32_t* __restrict__ g_plane,  // G_PLANE: [bp, n / 2] bf16 pairs
                 const float* __restrict__ fe,          // G_TABLE: [n]
                 const int* __restrict__ cluster_of,    // G_TABLE: [n]
                 const uint8_t* __restrict__ allowed,   // G_TABLE: [n] 0 / 1
                 const uint32_t* __restrict__ g_table,  // G_TABLE: [bp, n_clusters]
                 const uint32_t* __restrict__ probe,    // G_TABLE: [bp / QB, n_clusters]
                 uint32_t* __restrict__ out,            // [bp, n / 2] bf16 pairs
                 int64_t n, int db, int run, int n_clusters) {
  extern __shared__ unsigned char smem[];

  const int q0 = blockIdx.x * QB;
  const int n_blocks = (int)(n / RU);
  const int first = blockIdx.y * run;
  const int steps = max(0, min(run, n_blocks - first));
  const int64_t half_n = n / 2;  // pair words a query row
  const bool odd = odd_quad_row();

  float kx[4][2];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) kx[j][e] = k1x[q0 + frag_query(j, e)];
  }
  const uint32_t* probe_blk = probe + (int64_t)blockIdx.x * n_clusters;
  const int bit0 = 2 * (threadIdx.x & 3);  // probe bit of query (j, e): 8j + bit0 + e

  Walk<BITS_BF16, RU, 1> walk(packed, db, q_image + (int64_t)blockIdx.x * (db / G::CODE_BYTES) * G::Q_BYTES,
                              nullptr, steps, first, n_blocks, 0, smem);

  Rows<EPI> cur;
  uint32_t pw[2][2] = {{0, 0}, {0, 0}};  // G_TABLE: probe words of cur's rows
  if (EPI == G_TABLE && steps > 0) {
    // G_TABLE carries each tile's row terms and probe words over from the
    // tile before; the first tile's are asked for here
    cur.load((int64_t)first * RU, fa, fr, fe, cluster_of, allowed, n_clusters);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) pw[mt][h] = cur.ok[mt][h] ? probe_blk[cur.cl[mt][h]] : 0u;
    }
  }

  while (walk.valid()) {
    const int t = walk.tile();
    const int64_t row_base = (int64_t)t * RU;

    // asked for before the dot, so that they arrive under it
    uint32_t gw[2][4][2][2];  // [mt][j][e][h]: G_PLANE pair words (h = 0 only), G_TABLE g words
    Rows<EPI> nxt;
    if constexpr (EPI == G_PLANE) {
      cur.load(row_base, fa, fr, fe, cluster_of, allowed, n_clusters);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            gw[mt][j][e][0] =
                g_plane[(int64_t)(q0 + frag_query(j, e)) * half_n + (row_base + pair_row(mt)) / 2];
        }
      }
    } else {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const bool on = (pw[mt][h] >> (8 * j + bit0 + e)) & 1u;
              gw[mt][j][e][h] =
                  on ? g_table[(int64_t)(q0 + frag_query(j, e)) * n_clusters + cur.cl[mt][h]] : 0u;
            }
          }
        }
      }
      if (t + 1 < first + steps)
        nxt.load(row_base + RU, fa, fr, fe, cluster_of, allowed, n_clusters);
    }

    float acc[2][16];
    walk.dot(acc);

    uint32_t pw_next[2][2] = {{0, 0}, {0, 0}};
    if constexpr (EPI == G_TABLE) {
      if (t + 1 < first + steps) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int h = 0; h < 2; ++h)
            pw_next[mt][h] = nxt.ok[mt][h] ? probe_blk[nxt.cl[mt][h]] : 0u;
        }
      }
    }

    // epilogue: f32 in the reference's order, no contraction, one rounding
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float g[2];
          if constexpr (EPI == G_PLANE) {
            // rows g, g + 8 of this lane from the pair words of lanes g, g ^ 1
            const uint32_t mine = gw[mt][j][e][0];
            const uint32_t other = __shfl_xor_sync(FULL_MASK, mine, 4);
            g[0] = bf16_value(odd ? other >> 16 : mine & 0xFFFFu);
            g[1] = bf16_value(odd ? mine >> 16 : other & 0xFFFFu);
          }
          uint32_t res[2];
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int i = 4 * j + 2 * h + e;
            const float base = __fadd_rn(
                cur.fa[mt][h], __fmul_rn(cur.fr[mt][h], __fadd_rn(acc[mt][i], kx[j][e])));
            if constexpr (EPI == G_PLANE) {
              res[h] = bf16_bits(__fadd_rn(base, g[h]));
            } else {
              const bool on = (pw[mt][h] >> (8 * j + bit0 + e)) & 1u;
              const uint32_t w = gw[mt][j][e][h];
              const float gc = bf16_value(bf16_bits(__fsub_rn(
                  bf16_value(w & 0xFFFFu), __fmul_rn(cur.fe[mt][h], bf16_value(w >> 16)))));
              const uint32_t lb = bf16_bits(__fadd_rn(base, gc));
              const bool finite = (lb & 0x7F80u) != 0x7F80u;
              res[h] = !on ? BF16_NEG_INF : (finite ? lb ^ 0x8000u : BF16_POS_INF);
            }
          }
          // lane g even: rows g, g + 1 (its h = 0 and the partner's h = 0);
          // g odd: rows 8 + g - 1, 8 + g (the partner's h = 1 and its h = 1)
          const uint32_t other = __shfl_xor_sync(FULL_MASK, odd ? res[0] : res[1], 4);
          const uint32_t word = odd ? (other | (res[1] << 16)) : (res[0] | (other << 16));
          out[(int64_t)(q0 + frag_query(j, e)) * half_n + (row_base + pair_row(mt)) / 2] = word;
        }
      }
    }

    if constexpr (EPI == G_TABLE) {
      cur = nxt;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) pw[mt][h] = pw_next[mt][h];
      }
    }
    walk.next();
  }
}

// Blocks of 128-row tiles each query block's walkers take: the grid is as
// many blocks as the card holds at once (one wave), each with one run.
template <int EPI>
cudaError_t run_length(int n_blocks, int q_blocks, int& run) {
  static int slots_on[MAX_DEVICES] = {};  // resident blocks, per device; 0: not asked yet
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  int& slots = slots_on[device % MAX_DEVICES];
  if (slots == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_lb_kernel<EPI>,
                                                          THREADS, G::SMEM_BYTES);
    if (err != cudaSuccess) return err;
    slots = max(1, sms * per_sm);
  }
  const int walkers = max(1, min(n_blocks, (slots + q_blocks - 1) / q_blocks));
  run = (n_blocks + walkers - 1) / walkers;
  return cudaSuccess;
}

template <int EPI>
int launch(const void* packed, const void* q_image, const void* fa, const void* fr,
           const void* k1x, const void* g_plane, const void* fe, const void* cluster_of,
           const void* allowed, const void* g_table, const void* probe, void* out,
           int64_t n, int db, int bp, int n_clusters, void* stream) {
  static bool prepared[MAX_DEVICES] = {};  // one per EPI
  cudaError_t err = prepare_launch(packed_lb_kernel<EPI>, G::SMEM_BYTES, prepared);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (int)(n / RU);
  if (n_blocks == 0 || bp == 0) return 0;
  int run = 0;
  err = run_length<EPI>(n_blocks, bp / QB, run);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(bp / QB, (n_blocks + run - 1) / run);
  packed_lb_kernel<EPI><<<grid, THREADS, G::SMEM_BYTES, (cudaStream_t)stream>>>(
      (const uint8_t*)packed, (const uint8_t*)q_image, (const float*)fa, (const float*)fr,
      (const float*)k1x, (const uint32_t*)g_plane, (const float*)fe, (const int*)cluster_of,
      (const uint8_t*)allowed, (const uint32_t*)g_table, (const uint32_t*)probe,
      (uint32_t*)out, n, db, run, n_clusters);
  return (int)cudaGetLastError();
}

}  // namespace

// dynamic shared memory a block of either epilogue takes, bytes
extern "C" int rabitq_packed_lb_scan_smem_bytes() { return G::SMEM_BYTES; }

// G_PLANE (the TPU contract): out = lb with g from the [bp, n] bf16 g_comb.
// q_image: the query as ops/fused_scan.py query_image lays it out for mode
// "bits_bf16".
extern "C" int rabitq_packed_lb_scan(const void* packed, const void* q_image, const void* fa,
                                     const void* fr, const void* k1x, const void* g_comb,
                                     void* out, long long n, int db, int bp, void* stream) {
  return launch<G_PLANE>(packed, q_image, fa, fr, k1x, g_comb, nullptr, nullptr, nullptr,
                         nullptr, nullptr, out, n, db, bp, 0, stream);
}

// G_TABLE (stage 1 of the "packed" scan): out = the masked -lb plane.
// g_table: [bp, n_clusters] words (bf16 g_add | bf16 g_err << 16); probe:
// [bp / 32, n_clusters] words, bit i = query 32 * block + i probes the cluster.
extern "C" int rabitq_packed_lb_plane(const void* packed, const void* q_image, const void* fa,
                                      const void* fr, const void* k1x, const void* fe,
                                      const void* cluster_of, const void* allowed,
                                      const void* g_table, const void* probe, void* out,
                                      long long n, int db, int bp, int n_clusters, void* stream) {
  return launch<G_TABLE>(packed, q_image, fa, fr, k1x, nullptr, fe, cluster_of, allowed, g_table,
                         probe, out, n, db, bp, n_clusters, stream);
}
