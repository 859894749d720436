// Tensor-core tile of the scans: <codes, q> for a block of RU = 128 stored
// rows x QB = 32 queries, on Hopper's warpgroup matrix multiply
// (wgmma.mma_async, sm_90a), shared by fused_bin_scan.cu (the int8 TOTAL plane
// against an f32 query, or against an int8 one: S8Walk), packed_bin_scan.cu
// (1-bit planes against a bf16 or an int8 query) and packed_lb_scan.cu (1-bit
// planes against a bf16 query, no bins). It takes the place of the TPU
// kernels' MXU dots in rabitq_tpu/ops/pallas_fused_scan.py (_tile_update) and
// rabitq_tpu/ops/pallas_scan.py (_lb_kernel).
//
// Bound on the H100: operations at the tensor rate; the CUDA-core register
// tiles this replaces sat 30-50x above it. What holds this tile 3-9x above
// it (PERF.md) is, for the three-plane dot, the L2 traffic of a 128 x 32
// tile (8 KB of codes and 12 KB of query planes per 64 columns; the copies
// alone take two thirds of the kernel's time), and for the bit planes the
// short K (1024 positions a row) against a fixed epilogue. Design:
//
// * Orientation. M = code rows, N = queries, K = columns. One warpgroup of
//   128 threads runs m64n32k16 (bf16, f32 accumulators) or m64n32k32 (s8,
//   s32 accumulators) for two 64-row M-tiles, 2 x 16 accumulator registers a
//   thread: thread (warp w, lane 4g + t) owns rows mt*64 + 16w + g + 8h and
//   queries 8j + 2t + e, in every tile of the walk, so the caller's bins are
//   registers indexed like the accumulators.
// * Operand A comes from registers. The raw code bytes of a stage are copied
//   to shared memory as they lie in device memory (cp.async, 16 bytes a
//   thread); each thread reads the 32-bit words of its own fragment rows and
//   converts them in registers: int8 -> bf16 exactly (a biased byte placed in
//   an f32 mantissa), a bit plane -> bf16 {0, 1} as ((w >> k) & 0x00010001) *
//   0x3F80, or -> s8 {0, 1} as (w >> k) & 0x01010101. No converted copy of
//   the codes ever lies in shared memory.
// * A dot is a sum over columns, so the order of the columns inside a k-step
//   is free as long as both operands agree. The fragment slots take the code
//   bytes in the order that makes the conversion cheapest, and the query is
//   laid out to match by the wrapper (ops/fused_scan.py, query_image), which
//   also writes it as the 128-byte-swizzled K-major tiles the wgmma
//   descriptor names, stage by stage. Staging q is then a straight copy.
// * An f32 query is three bf16 planes hi + mid + lo (split_bf16x3): every
//   product with an int8 code is exact in f32, three products per column.
// * A ring of STAGES shared-memory stages, filled two stages ahead by
//   cp.async and walked without a break across the tiles of a block's walk:
//   while a tile's epilogue runs, the next tile's stages are in flight. The
//   wgmma groups of one k-step run while the next k-step's fragments are
//   converted (two fragment buffers, wgmma.wait_group 1).
// * The tensor cores truncate as they accumulate. Exact s32 sums do not
//   care; the bit-plane bf16 dot stays inside the f32 loop's error; the
//   three-plane dot, whose sum is large against its small parts, restarts
//   its tensor-core sum every 64 columns and adds the pieces on the CUDA
//   cores (see Walk::dot).
//
// Stage geometry, per mode (B tiles are [32 queries][128 bytes], 4 k-steps):
//   DENSE_BF16X3  64 code bytes a row; 3 B tiles (one per q plane);
//                 k-step s = columns 64c + 16s .. + 16 against each plane.
//   BITS_BF16     32 packed bytes a row; 4 B tiles; k-step i = 8*jg + k is
//                 bit k of bytes 32c + 16jg .. + 16 against q positions
//                 k*Db + 32c + 16jg .. (bit-plane order).
//   BITS_S8       32 packed bytes a row; 2 B tiles; k-step i = 4*jg + kp is
//                 bits 2kp and 2kp + 1 of the same 16 bytes (32 s8 values).
//   DENSE_S8      128 code bytes a row; 1 B tile (S8Walk below); k-step s =
//                 columns 128c + 32s .. + 32, in order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mma_tile {

// geometry of the bin scans (ops/fused_scan.py holds the same numbers)
constexpr int TN = 512;      // rows per tile
constexpr int GROUPS = 16;   // bin groups: L = GROUPS * TN bins
constexpr int WIN = 256;     // cluster window width
constexpr int QB = 32;       // queries per block (N of the wgmma)
constexpr int RU = 128;      // tile rows per block (two M-tiles)
constexpr int SLICES = TN / RU;
constexpr int THREADS = 128;  // one warpgroup
constexpr float BIG = 1.0e30f;

constexpr int STAGES = 4;  // ring depth
// Loads run this many stages ahead: the slot refilled at stage c is the one
// read at stage c - 2, whose wgmma groups the k-steps of stage c - 1 have
// waited for. (One stage further ahead, where a stage ends drained, measured
// no faster.)
constexpr int AHEAD = STAGES - 2;
constexpr int B_TILE_BYTES = QB * 128;

enum Mode { DENSE_BF16X3 = 0, BITS_BF16 = 1, BITS_S8 = 2, DENSE_S8 = 3 };

template <int MODE>
struct Geo {
  static constexpr int CODE_BYTES = MODE == DENSE_BF16X3 ? 64 : 32;  // a row, a stage
  // padded row stride in shared memory: a warp's fragment words (8 rows x 4
  // words) fall on 32 distinct banks
  static constexpr int CODE_STRIDE = CODE_BYTES + 16;
  static constexpr int B_TILES = MODE == DENSE_BF16X3 ? 3 : (MODE == BITS_BF16 ? 4 : 2);
  static constexpr int Q_BYTES = B_TILES * B_TILE_BYTES;
  static constexpr int STAGE_BYTES = Q_BYTES + RU * CODE_STRIDE;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  static_assert(STAGE_BYTES % 1024 == 0, "B tiles stay 1024-byte aligned");
  static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks share an SM's shared memory");
};

// DENSE_S8 (S8Walk below): a stage's RU code rows unpadded, in the 128-byte
// swizzle that wgmma reads by descriptor, and its one B tile
template <>
struct Geo<DENSE_S8> {
  static constexpr int CODE_BYTES = 128;  // a row, a stage: one swizzled row
  static constexpr int CODE_TILE = RU * CODE_BYTES;
  static constexpr int Q_BYTES = B_TILE_BYTES;
  static constexpr int STAGE_BYTES = CODE_TILE + Q_BYTES;
  static constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack
  static_assert(STAGE_BYTES % 1024 == 0, "tiles stay 1024-byte aligned");
  static_assert(2 * SMEM_BYTES <= 227 * 1024, "two blocks share an SM's shared memory");
};

template <int MODE>
struct Acc {
  using type = float;
};
template <>
struct Acc<BITS_S8> {
  using type = int;
};
template <>
struct Acc<DENSE_S8> {
  using type = int;
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// shared-memory writes of this thread become visible to the async proxy
// (the wgmma's descriptor reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins a register operand of an asynchronous wgmma: the value stays where it
// is until this point, and later code reads it only after this point.
__device__ __forceinline__ void pin(uint32_t& r) { asm volatile("" : "+r"(r)::"memory"); }
__device__ __forceinline__ void pin(float& r) { asm volatile("" : "+f"(r)::"memory"); }
__device__ __forceinline__ void pin(int& r) { asm volatile("" : "+r"(r)::"memory"); }

// K-major B tile with the 128-byte swizzle: rows of 128 bytes, eight rows to
// a 1024-byte atom (SBO), leading offset unused (1).
__device__ __forceinline__ uint64_t b_descriptor(uint32_t smem_addr) {
  return (uint64_t)((smem_addr & 0x3FFFF) >> 4) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

// d[16] += A (64 x 16 bf16, registers) * B (16 x 32 bf16, shared memory)
// (scale_d == 0: d = A * B, whatever d held)
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b, int scale_d = 1) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d[16] += A (64 x 32 s8, registers) * B (32 x 32 s8, shared memory), s32
__device__ __forceinline__ void wgmma_m64n32k32(int (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// d[16] += A (64 x 32 s8, shared memory) * B (32 x 32 s8, shared memory), s32
__device__ __forceinline__ void wgmma_m64n32k32_ss(int (&d)[16], uint64_t desc_a,
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),
        "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]),
        "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// Two int8 values (bytes LO and LO + 1 of w ^ 0x80808080) as one bf16x2
// register, exactly: the biased byte u = b + 128 in the low mantissa byte of
// 2^23 is the f32 number 2^23 + u; minus 2^23 + 128 that is b, whose upper 16
// bits are its bf16.
template <int LO>
__device__ __forceinline__ uint32_t s8x2_to_bf16x2(uint32_t biased) {
  const float f0 = __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | LO)) - 8388736.0f;
  const float f1 =
      __uint_as_float(__byte_perm(biased, 0x4B000000u, 0x7440 | (LO + 1))) - 8388736.0f;
  return __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
}

// What a kernel on this tile asks of the runtime, once, before its first
// launch: its dynamic shared memory, and a shared-memory carve-out that lets
// two blocks share an SM whatever ran before (without it one process in
// several ran the three-plane kernel at 11 ms in place of 4.5).
// `done_on` is the caller's record, per device, for this kernel.
constexpr int MAX_DEVICES = 64;
template <class Kernel>
inline cudaError_t prepare_launch(Kernel kernel, int smem_bytes, bool (&done_on)[MAX_DEVICES]) {
  int device = 0;
  cudaError_t got = cudaGetDevice(&device);
  if (got != cudaSuccess) return got;
  bool& done = done_on[device % MAX_DEVICES];
  if (done) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  done = err == cudaSuccess;
  return err;
}

// Row of accumulator element (mt, h) in the block's RU rows, and query of
// element (j, e) in its QB queries, for this thread.
__device__ __forceinline__ int frag_row(int mt, int h) {
  const int tid = threadIdx.x;
  return mt * 64 + (tid >> 5) * 16 + ((tid & 31) >> 2) + h * 8;
}
__device__ __forceinline__ int frag_query(int j, int e) {
  return j * 8 + (threadIdx.x & 3) * 2 + e;
}

// ---------------------------------------------------------------- offered

// The bin scans' offered counts: rows with a lower bound below BIG / 2, per
// query and row slot u % 128 of the block's fragment. Two queries (e = 0, 1)
// share a word, 16 bits each. A walk adds at most one a tile to each count,
// so the counts go to `offered` (atomics) every FLUSH_TILES walked tiles,
// before a half can pass 65535, and once when the walk ends.
constexpr int FLUSH_TILES = 32768;

struct Offered {
  int cnt[2][8];  // [mt][2j + h]
  int since;      // tiles walked since the last flush

  __device__ __forceinline__ Offered() : since(0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 8; ++i) cnt[mt][i] = 0;
    }
  }
  __device__ __forceinline__ void add(int mt, int j, int h, int e, bool yes) {
    cnt[mt][2 * j + h] += yes ? 1 << (16 * e) : 0;
  }
  // after each walked tile
  __device__ __forceinline__ void tile_done(int* offered, int q0) {
    if (++since == FLUSH_TILES) flush(offered, q0);
  }
  // offered: [bp, 128]; the block's row slots r0 + frag_row are 128-aligned
  __device__ __forceinline__ void flush(int* offered, int q0) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int seen = (cnt[mt][2 * j + h] >> (16 * e)) & 0xFFFF;
            if (seen) atomicAdd(&offered[(q0 + frag_query(j, e)) * 128 + frag_row(mt, h)], seen);
          }
          cnt[mt][2 * j + h] = 0;
        }
      }
    }
    since = 0;
  }
};

// ---------------------------------------------------------------- the walk

// A block's walk over its tiles and the dot of each tile. A tile is
// TILE_ROWS rows of `codes` ([n_tiles * TILE_ROWS, row_bytes], int8 columns or
// packed bytes), of which the block takes rows r0 .. r0 + RU; `q_image` is the
// query image of this block's QB queries: row_bytes / CODE_BYTES stages of
// Q_BYTES each. Dense walk (list == nullptr): tiles group, group + STRIDE, ...
// (the bin scans: one bin group of TN-row tiles; the lower-bound scan: a run
// of consecutive RU-row tiles). Compacted walk (bin scans): the entries of
// `list` in order, those skipped that lie outside [0, n_tiles) or in another
// group.
//
//   Walk<MODE> w(...);              // starts the first loads
//   while (w.valid()) { t = w.tile(); w.dot(acc); ...epilogue...; w.next(); }
template <int MODE, int TILE_ROWS = TN, int STRIDE = GROUPS>
class Walk {
  using G = Geo<MODE>;
  using acc_t = typename Acc<MODE>::type;

 public:
  __device__ __forceinline__ Walk(const uint8_t* codes, int row_bytes, const uint8_t* q_image,
                                  const int* list, int steps, int group, int n_tiles, int r0,
                                  unsigned char* smem_raw)
      : codes_(codes), q_image_(q_image), list_(list), row_bytes_(row_bytes),
        n_chunks_(row_bytes / G::CODE_BYTES), steps_(steps), group_(group),
        n_tiles_(n_tiles), r0_(r0) {
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    const uint32_t pad = (1024u - (raw & 1023u)) & 1023u;
    smem_ = smem_raw + pad;
    saddr_ = raw + pad;
    const int tid = threadIdx.x;
    // word offset of this thread's first fragment row in a stage's code rows
    frag_word_ = (frag_row(0, 0) * G::CODE_STRIDE + (tid & 3) * 4) / 4;
    s_ = first_valid(0);
    p_s_ = s_;
    p_c_ = 0;
    p_slot_ = 0;
    slot_ = 0;
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) load_next();
  }

  __device__ __forceinline__ bool valid() const { return s_ < steps_; }
  __device__ __forceinline__ int tile() const { return tile_at(s_); }
  __device__ __forceinline__ void next() { s_ = first_valid(s_ + 1); }

  // acc[mt][4j + 2h + e] = <codes row r0 + mt*64 + 16w + g + 8h of this tile,
  // query 8j + 2t + e> over all columns (w = warp, lane = 4g + t).
  __device__ __forceinline__ void dot(acc_t (&acc)[2][16]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[mt][i] = 0;
    }
    uint32_t a[2][2][4];
#pragma unroll
    for (int b = 0; b < 2; ++b) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int r = 0; r < 4; ++r) a[b][mt][r] = 0;
      }
    }
    if constexpr (MODE == DENSE_BF16X3) {
      // The tensor cores truncate when they add a k-step's products into the
      // accumulator, one ulp of the accumulator a wgmma at worst and always
      // the same way. So the tensor-core sum restarts every stage (64 columns),
      // while it is small, and joins a running f32 sum on the CUDA cores with
      // round-to-nearest adds.
      float part[2][16];
      for (int c = 0; c < n_chunks_; ++c) {
        const uint32_t* cw;
        const uint64_t desc = begin_stage(cw);
        stage_dense(cw, desc, part, a);
        end_stage();
        wgmma_wait<0>();
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            pin(part[mt][i]);
            acc[mt][i] = __fadd_rn(acc[mt][i], part[mt][i]);
          }
        }
      }
    } else {
      for (int c = 0; c < n_chunks_; ++c) {
        const uint32_t* cw;
        const uint64_t desc = begin_stage(cw);
        stage_bits(cw, desc, acc, a);
        end_stage();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int i = 0; i < 16; ++i) pin(acc[mt][i]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pin(a[0][mt][r]);
        pin(a[1][mt][r]);
      }
    }
  }

 private:
  __device__ __forceinline__ int tile_at(int s) const {
    if (list_ == nullptr) return group_ + s * STRIDE;
    const int t = list_[s];  // uniform across the block
    return (t < 0 || t >= n_tiles_ || t % GROUPS != group_) ? -1 : t;
  }
  __device__ __forceinline__ int first_valid(int s) const {
    while (s < steps_ && tile_at(s) < 0) ++s;
    return s;
  }

  // Waits for the ring's current stage, refills the slot read two stages ago
  // and names the stage's code words and B tiles.
  __device__ __forceinline__ uint64_t begin_stage(const uint32_t*& cw) {
    cp_async_wait<AHEAD - 1>();
    fence_proxy_async();
    __syncthreads();
    load_next();
    cw = reinterpret_cast<const uint32_t*>(smem_ + slot_ * G::STAGE_BYTES + G::Q_BYTES) +
         frag_word_;
    return b_descriptor(saddr_ + slot_ * G::STAGE_BYTES);
  }
  __device__ __forceinline__ void end_stage() { slot_ = (slot_ + 1) % STAGES; }

  // Starts the loads of the next (tile, stage) of the walk into the next ring
  // slot, and always commits a group so that the group count is uniform.
  __device__ __forceinline__ void load_next() {
    if (p_s_ < steps_) {
      const int tid = threadIdx.x;
      const uint32_t dst = saddr_ + p_slot_ * G::STAGE_BYTES;
      const uint8_t* gq = q_image_ + (int64_t)p_c_ * G::Q_BYTES;
#pragma unroll
      for (int l = 0; l < G::Q_BYTES / 16 / THREADS; ++l) {
        const int id = tid + l * THREADS;
        cp_async16(dst + id * 16, gq + id * 16);
      }
      constexpr int UNITS = G::CODE_BYTES / 16;  // 16-byte units a row
      const uint8_t* gc = codes_ + ((int64_t)tile_at(p_s_) * TILE_ROWS + r0_) * row_bytes_ +
                          (int64_t)p_c_ * G::CODE_BYTES;
#pragma unroll
      for (int l = 0; l < RU * UNITS / THREADS; ++l) {
        const int id = tid + l * THREADS;
        const int row = id / UNITS;
        const int seg = id % UNITS;
        cp_async16(dst + G::Q_BYTES + row * G::CODE_STRIDE + seg * 16,
                   gc + (int64_t)row * row_bytes_ + seg * 16);
      }
      if (++p_c_ == n_chunks_) {
        p_c_ = 0;
        p_s_ = first_valid(p_s_ + 1);
      }
    }
    cp_async_commit();
    p_slot_ = (p_slot_ + 1) % STAGES;
  }

  // fragment word of M-tile mt, row half h (rows g and g + 8), word column wc
  __device__ __forceinline__ static uint32_t frag(const uint32_t* cw, int mt, int h, int wc) {
    return cw[((mt * 64 + h * 8) * G::CODE_STRIDE) / 4 + wc];
  }

  // before a fragment buffer is rewritten: every wgmma group but the newest
  // is done, so the groups that read this buffer two k-steps ago are
  __device__ __forceinline__ static void reuse(uint32_t (&buf)[2][4]) {
    wgmma_wait<1>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) pin(buf[mt][r]);
    }
  }

  // 64 int8 columns against the three q planes, lo first
  __device__ __forceinline__ static void stage_dense(const uint32_t* cw, uint64_t desc,
                                                     float (&acc)[2][16],
                                                     uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t(&buf)[2][4] = a[s & 1];
      reuse(buf);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t biased = frag(cw, mt, h, s * 4) ^ 0x80808080u;
          buf[mt][h] = s8x2_to_bf16x2<0>(biased);      // slots 2t, 2t + 1
          buf[mt][2 + h] = s8x2_to_bf16x2<2>(biased);  // slots 2t + 8, 2t + 9
        }
      }
      wgmma_fence();
#pragma unroll
      for (int p = 2; p >= 0; --p) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          wgmma_m64n32k16(acc[mt], buf[mt], desc + p * (B_TILE_BYTES >> 4) + s * 2,
                          (s == 0 && p == 2) ? 0 : 1);  // a stage starts its sum anew
      }
      wgmma_commit();
    }
  }

  // 32 packed bytes a row: two groups of 16 bytes x 8 bit planes
  __device__ __forceinline__ static void stage_bits(const uint32_t* cw, uint64_t desc,
                                                    acc_t (&acc)[2][16],
                                                    uint32_t (&a)[2][2][4]) {
#pragma unroll
    for (int jg = 0; jg < 2; ++jg) {
      uint32_t w[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) w[mt][h] = frag(cw, mt, h, jg * 4);
      }
      if constexpr (MODE == BITS_BF16) {
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int i = jg * 8 + k;
          uint32_t(&buf)[2][4] = a[k & 1];
          reuse(buf);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // bytes 0, 2 -> slots 2t, 2t + 1; bytes 1, 3 -> slots 2t + 8, 2t + 9
              buf[mt][h] = ((w[mt][h] >> k) & 0x00010001u) * 0x3F80u;
              buf[mt][2 + h] = ((w[mt][h] >> (k + 8)) & 0x00010001u) * 0x3F80u;
            }
          }
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wgmma_m64n32k16(acc[mt], buf[mt],
                            desc + (i / 4) * (B_TILE_BYTES >> 4) + (i % 4) * 2);
          wgmma_commit();
        }
      } else {
#pragma unroll
        for (int kp = 0; kp < 4; ++kp) {
          const int i = jg * 4 + kp;
          uint32_t(&buf)[2][4] = a[kp & 1];
          reuse(buf);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              // bytes 0..3, bit 2kp -> slots 4t..; bit 2kp + 1 -> slots 16 + 4t..
              buf[mt][h] = (w[mt][h] >> (2 * kp)) & 0x01010101u;
              buf[mt][2 + h] = (w[mt][h] >> (2 * kp + 1)) & 0x01010101u;
            }
          }
          wgmma_fence();
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            wgmma_m64n32k32(acc[mt], buf[mt],
                            desc + (i / 4) * (B_TILE_BYTES >> 4) + (i % 4) * 2);
          wgmma_commit();
        }
      }
    }
  }

  const uint8_t* codes_;
  const uint8_t* q_image_;
  const int* list_;
  unsigned char* smem_;
  uint32_t saddr_;
  int row_bytes_, n_chunks_, steps_, group_, n_tiles_, r0_;
  int frag_word_;
  int s_, slot_;          // consumer: walk step, ring slot
  int p_s_, p_c_, p_slot_;  // producer: walk step, stage of its tile, ring slot
};

// ---------------------------------------------------------------- DENSE_S8

// The walk of Walk<MODE> for an int8 query against the int8 plane (a query
// that is an integer grid times a per-query scale): neither operand needs a
// conversion, so both reach the tensor cores from shared memory through
// descriptors and no thread touches a code byte. A stage is 128 columns: the
// block's RU code rows as one [128 rows][128 bytes] K-major tile in the
// 128-byte swizzle (the copy writes 16-byte unit u of row r at unit
// u ^ (r % 8), the layout b_descriptor names), against the [32 queries][128
// bytes] B tile of the same columns, which each stage carries as in
// Walk<MODE>; four m64n32k32 k-steps a stage, s32 accumulators over the
// whole row, exact.
class S8Walk {
  using G = Geo<DENSE_S8>;

 public:
  __device__ __forceinline__ S8Walk(const uint8_t* codes, int row_bytes, const uint8_t* q_image,
                                    const int* list, int steps, int group, int n_tiles, int r0,
                                    unsigned char* smem_raw)
      : codes_(codes), q_image_(q_image), list_(list), row_bytes_(row_bytes),
        n_chunks_(row_bytes / G::CODE_BYTES), steps_(steps), group_(group),
        n_tiles_(n_tiles), r0_(r0) {
    const uint32_t raw = (uint32_t)__cvta_generic_to_shared(smem_raw);
    saddr_ = raw + ((1024u - (raw & 1023u)) & 1023u);
    s_ = first_valid(0);
    p_s_ = s_;
    p_c_ = 0;
    p_slot_ = 0;
    slot_ = 0;
#pragma unroll
    for (int i = 0; i < AHEAD; ++i) load_next();
  }

  __device__ __forceinline__ bool valid() const { return s_ < steps_; }
  __device__ __forceinline__ int tile() const { return tile_at(s_); }
  __device__ __forceinline__ void next() { s_ = first_valid(s_ + 1); }

  // acc[mt][4j + 2h + e] as Walk<MODE>::dot, the exact integer dot
  __device__ __forceinline__ void dot(int (&acc)[2][16]) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[mt][i] = 0;
    }
    for (int c = 0; c < n_chunks_; ++c) {
      cp_async_wait<AHEAD - 1>();
      // the slot load_next refills was read by the wgmma group of two stages ago
      wgmma_wait<1>();
      fence_proxy_async();
      __syncthreads();
      load_next();
      const uint32_t stage = saddr_ + slot_ * G::STAGE_BYTES;
      const uint64_t desc_a = b_descriptor(stage);
      const uint64_t desc_b = b_descriptor(stage + G::CODE_TILE);
      wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          wgmma_m64n32k32_ss(acc[mt], desc_a + mt * ((64 * G::CODE_BYTES) >> 4) + s * 2,
                             desc_b + s * 2);
      }
      wgmma_commit();
      slot_ = (slot_ + 1) % STAGES;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
      for (int i = 0; i < 16; ++i) pin(acc[mt][i]);
    }
  }

 private:
  __device__ __forceinline__ int tile_at(int s) const {
    if (list_ == nullptr) return group_ + s * GROUPS;
    const int t = list_[s];  // uniform across the block
    return (t < 0 || t >= n_tiles_ || t % GROUPS != group_) ? -1 : t;
  }
  __device__ __forceinline__ int first_valid(int s) const {
    while (s < steps_ && tile_at(s) < 0) ++s;
    return s;
  }

  // as Walk<MODE>::load_next: the next (tile, stage) into the next ring slot,
  // and always a committed group
  __device__ __forceinline__ void load_next() {
    if (p_s_ < steps_) {
      const int tid = threadIdx.x;
      const uint32_t dst = saddr_ + p_slot_ * G::STAGE_BYTES;
      const uint8_t* gq = q_image_ + (int64_t)p_c_ * B_TILE_BYTES;
#pragma unroll
      for (int l = 0; l < B_TILE_BYTES / 16 / THREADS; ++l) {
        const int id = tid + l * THREADS;
        cp_async16(dst + G::CODE_TILE + id * 16, gq + id * 16);
      }
      constexpr int UNITS = G::CODE_BYTES / 16;  // 8: one swizzle row
      const uint8_t* gc = codes_ + ((int64_t)tile_at(p_s_) * TN + r0_) * row_bytes_ +
                          (int64_t)p_c_ * G::CODE_BYTES;
#pragma unroll
      for (int l = 0; l < RU * UNITS / THREADS; ++l) {
        const int id = tid + l * THREADS;
        const int row = id / UNITS;
        const int u = id % UNITS;
        cp_async16(dst + row * G::CODE_BYTES + ((u ^ (row & 7)) << 4),
                   gc + (int64_t)row * row_bytes_ + u * 16);
      }
      if (++p_c_ == n_chunks_) {
        p_c_ = 0;
        p_s_ = first_valid(p_s_ + 1);
      }
    }
    cp_async_commit();
    p_slot_ = (p_slot_ + 1) % STAGES;
  }

  const uint8_t* codes_;
  const uint8_t* q_image_;
  const int* list_;
  uint32_t saddr_;
  int row_bytes_, n_chunks_, steps_, group_, n_tiles_, r0_;
  int s_, slot_;            // consumer: walk step, ring slot
  int p_s_, p_c_, p_slot_;  // producer: walk step, stage of its tile, ring slot
};

}  // namespace mma_tile
