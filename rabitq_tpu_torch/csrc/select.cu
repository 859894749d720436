// rabitq_top_k -- jax.lax.top_k on the card: the k largest entries of each
// row of a [rows, n] f32 or bf16 matrix, in descending order of the float's
// total order (+NaN > +inf > ... > +0.0 > -0.0 > ... > -inf > -NaN, NaN
// payloads ordered by their bits), ties to the lower index; values returned
// bit for bit, indices int32. Not a counterpart of a TPU kernel: it stands
// at every site where the JAX package calls lax.top_k (an XLA op) -- the
// dense scans' survivor cut (rabitq_tpu/index/scan.py:552-558), the
// centroid ranking (:289), the final top-k (:633, :731), the best bins
// (rabitq_tpu/ops/pallas_fused_scan.py:664), the shard merge
// (rabitq_tpu/parallel/sharding.py:167), the MSTG closure
// (rabitq_tpu/index/mstg/closure.py:39) and the k-means reseed
// (rabitq_tpu/ops/kmeans.py:221). Its plain version is
// ops/select.top_k_plain (a stable sort of the same key); the two are
// bitwise equal.
//
// Every entry's key v is the float's bits b mapped so that v ascending is
// the total order descending (b where the sign bit is set, else b with every
// other bit flipped; the map is its own inverse, so values come back exactly
// from the keys), and the unique 64-bit composite (v << 32 | index) orders
// as lax.top_k does with ties to the lower index: any correct sort or
// selection of the composites gives the same output, whatever the order in
// which they were gathered.
//
// rabitq_top_k -- rows longer than SHORT_N (the survivor cut [256, ~1M]):
// top_k_cluster_kernel. Bound on the H100: bytes, one read of the row from
// HBM and one write of the outputs (512 MB for the survivors in bf16: 0.153
// ms at 3.35 TB/s). The design reads the row once from HBM and orders the
// winners on chip:
//  - A persistent grid of thread-block clusters (cudaLaunchKernelEx; 1-16
//    blocks a cluster, G clusters, ops/select.long_row_plan). Cluster c takes
//    rows c, c + G, c + 2G, ...; each of its blocks a contiguous slice of the
//    row. G rows in flight hold at most about 24 MB, half the L2, so a row
//    stays in the L2 between its passes: the histogram passes read with an
//    evict_last policy (the first one from HBM, the rest from the L2), the
//    last pass with evict_first. No global work counter.
//  - Radix select, 8 bits a pass from the top: each block counts the digits
//    of its slice's keys that match the prefix so far into per-warp
//    histograms, the blocks' histograms are added across the cluster through
//    distributed shared memory, and every block picks the same digit. The
//    histograms are what bounds the kernel (a shared-memory atomic costs
//    about as much as the entry's bytes from the L2), so a pass spends one
//    only where it must: the keys of the pass's most frequent digit in the
//    cluster's last row (a masked plane's -inf, the one exponent of a plane
//    of lower bounds) count in a register, both tests on the float's bits;
//    the first pass puts the other keys into this thread's slots in shared
//    memory, and once the first digit is off that hint the later passes and
//    the collection read those slots instead of the row.
//  - As soon as the keys whose masked value is at most the prefix number at
//    most CAND (k and the ties at the cut), they are taken as composites into
//    a slot buffer in the L2 (at most 64 KB a row; slots from atomics, which
//    no output depends on: the composites are unique).
//  - The rows of a cluster come in waves of one row a block: after a wave's
//    passes each block reads one row's candidates into shared memory, selects
//    the k smallest composites with a radix select and sorts them with the
//    short rows' bitonic network, while no other block waits for it.
//  - The spill, where k exceeds CAND or the ties at the k-th key push the
//    candidates past it: the row's block takes its winners in index order
//    into device scratch (every key whose masked value is below the prefix,
//    and the first `need` equal to it: per-warp counts of tiles of 512
//    16-byte loads, one block scan for their output positions, warp scans to
//    place them) and sorts them with a stable least-significant-digit radix
//    sort (a tile of 512 winners scattered with its rank among equal digits,
//    so every k <= n is exact). Counted on the card in spilled_rows
//    (rabitq_top_k_spilled); no main-path selection takes it.
// rabitq_top_k_grid -- one long row with k <= WARP_K (the k-means reseed):
// top_k_grid_kernel, the whole card on the row, each warp keeping its k
// smallest composites in registers, the last block to finish (a ticket)
// merging the blocks' lists; bound: one read of the row.
// Output positions come from the sorts and selections of unique composites
// only, so every run gives the same bits, in a CUDA graph or eagerly; the
// launches allocate nothing and do not synchronise.
//
// rabitq_top_k_short -- the same function for rows that fit on chip (n <=
// SHORT_N), read once, with no device scratch. ops/select.kernel_path picks
// the variant:
//  warp:   k <= WARP_K and n <= WARP_N (the final top-k, the shard merge).
//          A warp a row, WARP_ROWS rows a block; each lane holds its
//          entries' composites in registers and k rounds of a warp minimum
//          (shuffles) take the winners in order.
//  sort:   k above half the padded row (the centroid ranking at k = n). One
//          block a row: the composites in dynamic shared memory, padded to
//          a power of two with sentinels that sort last, sorted by a
//          bitonic network, the first k written.
//  select: the rest (the best bins, a probe bucket, the closure). A radix
//          select on the composites in shared memory, 8 bits a pass from
//          the top (the key's bytes, then the index's; per-warp histograms,
//          each thread adding runs of one digit), stops once the k-th
//          composite's bin is taken whole; the k winners go to a second
//          buffer (their slots from atomics: the sort orders them) and are
//          sorted by the same network.
// The network keeps a warp's 256 composites in registers (8 a thread,
// lane-strided) for every step of stride below 256 (shuffles below 32),
// and goes through shared memory only for the longer strides. Bound on the
// H100: bytes, one read of the row and one write of the k outputs; at the
// main path's shapes the row is L2-resident and the time is the network's
// steps and barriers.

#include <cooperative_groups.h>
#include <cooperative_groups/scan.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
// 16-byte loads a thread takes in turn in the spill's compaction (8 bf16 or
// 4 f32 entries)
constexpr int CHUNK = 1;
constexpr int UNROLL = 4;  // 16-byte loads a thread takes a batch in a pass over a slice (two batches in flight)
constexpr int ROUND_TILES = 256;  // tiles of THREADS chunks a round of the spill's compaction counts
constexpr int CELLS = ROUND_TILES * WARPS;  // a warp's share of a tile: one cell

template <int BITS> struct Word;
template <> struct Word<16> { using raw = uint16_t; };
template <> struct Word<32> { using raw = uint32_t; };

// the ordered key of a float's bits, and back (the map is an involution)
template <int BITS>
__device__ __forceinline__ uint32_t flip(uint32_t b) {
  constexpr uint32_t SIGN = 1u << (BITS - 1);
  return (b & SIGN) ? b : (b ^ (SIGN - 1u));
}

// The bits of the floats whose key is `key`, where `sign_of` (a key) has the
// same sign bit: the key map is an xor with a constant fixed by the sign.
template <int BITS>
__device__ __forceinline__ uint32_t raw_of(uint32_t key, uint32_t sign_of) {
  constexpr uint32_t SIGN = 1u << (BITS - 1);
  return (sign_of & SIGN) ? key : (key ^ (SIGN - 1u));
}

// the VEC elements' bits in one 16-byte word, lowest address first
template <int BITS>
__device__ __forceinline__ void unpack(const uint4& q, uint32_t* out) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
  if (BITS == 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      out[2 * i] = w[i] & 0xFFFFu;
      out[2 * i + 1] = w[i] >> 16;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) out[i] = w[i];
  }
}

// Element i (a constant once unrolled) of a thread's CHUNK 16-byte words.
template <int BITS>
__device__ __forceinline__ uint32_t element(const uint4 (&q)[CHUNK], int i) {
  constexpr int VEC = 128 / BITS;
  const uint4& w4 = q[i / VEC];
  const int j = i % VEC;
  if (BITS == 32) return j == 0 ? w4.x : j == 1 ? w4.y : j == 2 ? w4.z : w4.w;
  const uint32_t w = (j >> 1) == 0 ? w4.x : (j >> 1) == 1 ? w4.y : (j >> 1) == 2 ? w4.z : w4.w;
  return (j & 1) ? w >> 16 : w & 0xFFFFu;
}

// A thread's ITEMS consecutive elements from `first` (zeros past n), as
// 16-byte loads where the row is aligned.
template <int BITS>
__device__ __forceinline__ void load_chunk(const typename Word<BITS>::raw* __restrict__ x,
                                           int64_t first, int64_t n, bool vec,
                                           uint4 (&q)[CHUNK]) {
  constexpr int ITEMS = CHUNK * 128 / BITS;
  if (vec && first + ITEMS <= n) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + first);
#pragma unroll
    for (int u = 0; u < CHUNK; ++u) q[u] = __ldg(xv + u);
    return;
  }
  uint32_t w[4 * CHUNK];
#pragma unroll
  for (int i = 0; i < 4 * CHUNK; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (first + i < n) w[i * BITS / 32] |= (uint32_t)x[first + i] << (i * BITS % 32);
#pragma unroll
  for (int u = 0; u < CHUNK; ++u) q[u] = make_uint4(w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3]);
}

// Elements of a chunk at `first` that lie before n: 0 .. ITEMS.
template <int BITS>
__device__ __forceinline__ int chunk_valid(int64_t first, int64_t n) {
  constexpr int ITEMS = CHUNK * 128 / BITS;
  const int64_t left = n - first;
  return left <= 0 ? 0 : left >= ITEMS ? ITEMS : (int)left;
}

// (equal << 16) | below: the chunk's keys whose masked value is below the
// prefix, and equal to it
template <int BITS>
__device__ __forceinline__ uint32_t chunk_counts(const uint4 (&q)[CHUNK], int valid,
                                                 uint32_t mask, uint32_t prefix) {
  constexpr int ITEMS = CHUNK * 128 / BITS;
  uint32_t lt = 0, eq = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const uint32_t m = flip<BITS>(element<BITS>(q, i)) & mask;
    const bool ok = i < valid;
    lt += ok && m < prefix;
    eq += ok && m == prefix;
  }
  return (eq << 16) | lt;
}

__device__ __forceinline__ uint32_t warp_exclusive_scan(uint32_t x) {
  const int lane = threadIdx.x & 31;
  uint32_t incl = x;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
    if (lane >= d) incl += y;
  }
  return incl - x;
}

__device__ __forceinline__ uint32_t warp_total(uint32_t x) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x += __shfl_xor_sync(0xFFFFFFFFu, x, d);
  return x;
}

// Exclusive scan of one value a thread, in thread order; `total` is the
// block's sum. Every thread must call it.
__device__ __forceinline__ uint32_t block_exclusive_scan(uint32_t x, uint32_t* warp_sum,
                                                         uint32_t& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const uint32_t in_warp = warp_exclusive_scan(x);
  if (lane == 31) warp_sum[warp] = in_warp + x;
  __syncthreads();
  if (warp == 0) {
    const uint32_t w = lane < WARPS ? warp_sum[lane] : 0u;
    const uint32_t incl = warp_exclusive_scan(w) + w;
    if (lane < WARPS) warp_sum[lane] = incl;
  }
  __syncthreads();
  const uint32_t before = (warp ? warp_sum[warp - 1] : 0u) + in_warp;
  total = warp_sum[WARPS - 1];
  __syncthreads();  // warp_sum is written again by the next call
  return before;
}

// Warp 0's view of a histogram: lane l takes bins 8l .. 8l + 7 into c and
// gets the count of the bins before them.
__device__ __forceinline__ uint32_t lane_bins(const uint32_t* hist, uint32_t (&c)[8]) {
  const int lane = threadIdx.x & 31;
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    c[i] = hist[lane * 8 + i];
    s += c[i];
  }
  return warp_exclusive_scan(s);
}

// Warp 0 writes to pick the bin of hist that holds the need-th smallest
// entry: (digit, entries in the bins below it, entries in it).
__device__ __forceinline__ void pick_bin(const uint32_t* hist, uint32_t need, uint32_t* pick) {
  if (threadIdx.x < 32) {
    uint32_t c[8];
    uint32_t before = lane_bins(hist, c);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (before < need && need <= before + c[i]) {
        pick[0] = (threadIdx.x & 31) * 8 + i;
        pick[1] = before;
        pick[2] = c[i];
      }
      before += c[i];
    }
  }
}

// The most frequent digit of hist (the lower on a tie) into *top. Called by
// one whole warp.
__device__ __forceinline__ void most_frequent(const uint32_t* hist, uint32_t* top) {
  const int lane = threadIdx.x & 31;
  uint32_t best = hist[lane * 8], at = lane * 8;
#pragma unroll
  for (int i = 1; i < 8; ++i)
    if (hist[lane * 8 + i] > best) best = hist[lane * 8 + i], at = lane * 8 + i;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const uint32_t ob = __shfl_xor_sync(0xFFFFFFFFu, best, d);
    const uint32_t oa = __shfl_xor_sync(0xFFFFFFFFu, at, d);
    if (ob > best || (ob == best && oa < at)) best = ob, at = oa;
  }
  if (lane == 0) *top = at;
}

// Warp 0 turns the histogram into exclusive digit starts in place; returns
// (to every thread, after the barrier) whether one digit holds all m keys.
__device__ __forceinline__ bool digit_starts(uint32_t* hist, uint32_t m, uint32_t* flag) {
  if (threadIdx.x < 32) {
    uint32_t c[8];
    uint32_t before = lane_bins(hist, c);
    bool one = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hist[(threadIdx.x & 31) * 8 + i] = before;
      before += c[i];
      one |= c[i] == m;
    }
    one = __any_sync(0xFFFFFFFFu, one);
    if (threadIdx.x == 0) *flag = one;
  }
  __syncthreads();
  return *flag != 0;
}

// ---- composites and the bitonic network (both row lengths)

constexpr int SHORT_N = 8192;       // longest row the shared-memory variants take
constexpr int SORT_MIN = 256;       // the network sorts at least one warp's worth
constexpr int WARP_N = 1024, WARP_K = 32;
constexpr int WARP_ROWS = 2;        // rows (warps) a block of the warp variant
constexpr int SHORT_THREADS = 512;
constexpr int SHORT_WARPS = SHORT_THREADS / 32;
constexpr int LANE_ITEMS = 8;       // composites a thread holds in the network: 256 a warp
constexpr int WARP_SPAN = 32 * LANE_ITEMS;
using u64 = unsigned long long;  // a composite (the shuffles' 64-bit type)
constexpr u64 SENTINEL = ~0ull;  // above every composite: an index is < 2^31
constexpr int SHORT_SMEM_MAX = (SHORT_N + SHORT_N / 2) * 8;  // the row and the winners
static_assert(THREADS == SHORT_THREADS, "the long rows' blocks run the short rows' network");

template <int BITS>
__device__ __forceinline__ u64 composite(uint32_t bits, uint32_t index) {
  return ((u64)flip<BITS>(bits) << 32) | index;
}

template <int BITS>
__device__ __forceinline__ void write_out(u64 c, typename Word<BITS>::raw* values,
                                          int32_t* indices, int64_t at) {
  values[at] = (typename Word<BITS>::raw)flip<BITS>((uint32_t)(c >> 32));
  indices[at] = (int32_t)(uint32_t)c;
}

// The shift of the highest nonzero byte of an index below n (0 .. 24).
__device__ __forceinline__ int index_top_of(int64_t n) {
  int top = 0;
  while (top < 24 && ((uint64_t)(n - 1) >> (top + 8)) != 0) top += 8;
  return top;
}

// Whether element base + 32e + lane lies in a run that bitonic stage
// `size` sorts ascending; `base` is a multiple of WARP_SPAN, so below that
// size it is a function of the lane alone once e and size are constants.
__device__ __forceinline__ bool ascending(int64_t base, int e, int lane, int size) {
  return size >= WARP_SPAN ? (base & size) == 0 : ((32 * e + lane) & size) == 0;
}

// Step of bitonic stage `size` at stride 32 * S on a warp's 256 composites
// r[e] = element base + 32e + lane: pairs (e, e + S) inside the thread.
template <int S>
__device__ __forceinline__ void register_step(u64 (&r)[LANE_ITEMS], int64_t base, int size) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int e = 0; e < LANE_ITEMS; ++e) {
    if (e & S) continue;
    const u64 a = r[e], b = r[e | S];
    const bool swap = (a > b) == ascending(base, e, lane, size);
    r[e] = swap ? b : a;
    r[e | S] = swap ? a : b;
  }
}

// The steps of bitonic stage `size` from `stride` (at most 128) down to 1
// on a warp's 256 composites: strides >= 32 inside the thread, the rest by
// shuffles, where an element takes its partner's composite when that is
// the smaller and it keeps the smaller (the lower element of an ascending
// pair, the upper of a descending one), or the larger and it keeps that.
__device__ __forceinline__ void warp_steps(u64 (&r)[LANE_ITEMS], int64_t base, int size,
                                           int stride) {
  static_assert(LANE_ITEMS == 8, "register strides 128, 64, 32");
  const int lane = threadIdx.x & 31;
  if (stride >= 128) register_step<4>(r, base, size);
  if (stride >= 64) register_step<2>(r, base, size);
  if (stride >= 32) register_step<1>(r, base, size);
  for (int d = stride < 16 ? stride : 16; d >= 1; d >>= 1) {
    const bool low = (lane & d) == 0;
#pragma unroll
    for (int e = 0; e < LANE_ITEMS; ++e) {
      const u64 o = __shfl_xor_sync(0xFFFFFFFFu, r[e], d);
      r[e] = (o < r[e]) == (low == ascending(base, e, lane, size)) ? o : r[e];
    }
  }
}

// Bitonic sort of s[0 .. S) ascending, S a power of two >= WARP_SPAN, by
// every thread of the block (barriers inside; enter after one).
__device__ void bitonic_sort(u64* s, int S) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // every warp span sorted (stages 2 .. 256), alternating in direction
  for (int64_t base = (int64_t)warp * WARP_SPAN; base < S; base += SHORT_WARPS * WARP_SPAN) {
    u64 r[LANE_ITEMS];
#pragma unroll
    for (int e = 0; e < LANE_ITEMS; ++e) r[e] = s[base + 32 * e + lane];
#pragma unroll
    for (int size = 2; size <= WARP_SPAN; size <<= 1) warp_steps(r, base, size, size / 2);
#pragma unroll
    for (int e = 0; e < LANE_ITEMS; ++e) s[base + 32 * e + lane] = r[e];
  }
  __syncthreads();
  for (int size = 2 * WARP_SPAN; size <= S; size <<= 1) {
    for (int stride = size / 2; stride >= WARP_SPAN; stride >>= 1) {  // across warp spans
      for (int i = threadIdx.x; i < S / 2; i += SHORT_THREADS) {
        const int lo = 2 * i - (i & (stride - 1)), hi = lo + stride;
        const u64 a = s[lo], b = s[hi];
        if ((a > b) == ((lo & size) == 0)) {
          s[lo] = b;
          s[hi] = a;
        }
      }
      __syncthreads();
    }
    for (int64_t base = (int64_t)warp * WARP_SPAN; base < S; base += SHORT_WARPS * WARP_SPAN) {
      u64 r[LANE_ITEMS];
#pragma unroll
      for (int e = 0; e < LANE_ITEMS; ++e) r[e] = s[base + 32 * e + lane];
      warp_steps(r, base, size, WARP_SPAN / 2);
#pragma unroll
      for (int e = 0; e < LANE_ITEMS; ++e) s[base + 32 * e + lane] = r[e];
    }
    __syncthreads();
  }
}

// The k smallest of the unique composites s[0 .. n) (indices below n_row)
// into w[0 .. KP), in no order, sentinels past k: a radix select 8 bits a
// pass from the top (the key's bytes, then the index's from its highest
// nonzero byte; the bits above are 0), which stops once the k-th
// composite's bin is taken whole (always at the last pass), then the
// winners by slots from atomics. Enter after a barrier with warp_hist and
// *count zero; leaves warp_hist zero and ends with a barrier. The long rows'
// ordering of their candidates; the short rows' select variant keeps its
// own copy of these steps inline (called as a function, at its 64
// registers, it spills).
template <int BITS>
__device__ void select_composites(const u64* s, int n, int64_t n_row, int k, u64* w, int KP,
                                  uint32_t* hist, uint32_t (*warp_hist)[RADIX], uint32_t* pick,
                                  uint32_t* count) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int index_top = index_top_of(n_row);
  u64 prefix = 0, mask = 0;
  uint32_t need = (uint32_t)k;
  for (int shift = 32 + BITS - 8; shift >= 0; shift -= 8) {
    if (shift < 32 && shift > index_top) continue;
    // a thread adds a run of one digit to its warp's histogram when the
    // run ends: a row of one value (bins no query offered) does not queue
    // on one address
    uint32_t run_d = RADIX, run_n = 0;
#pragma unroll 4
    for (int i = t; i < n; i += SHORT_THREADS) {
      const u64 c = s[i];
      if ((c & mask) != prefix) continue;
      const uint32_t d = (uint32_t)(c >> shift) & 0xFFu;
      if (d != run_d) {
        if (run_n) atomicAdd(&warp_hist[warp][run_d], run_n);
        run_d = d;
        run_n = 0;
      }
      ++run_n;
    }
    if (run_n) atomicAdd(&warp_hist[warp][run_d], run_n);
    __syncthreads();
    for (int b = t; b < RADIX; b += SHORT_THREADS) {
      uint32_t c = 0;
#pragma unroll
      for (int v = 0; v < SHORT_WARPS; ++v) {
        c += warp_hist[v][b];
        warp_hist[v][b] = 0;
      }
      hist[b] = c;
    }
    __syncthreads();
    pick_bin(hist, need, pick);
    __syncthreads();  // hist and pick are written again after the next pass's barriers
    const uint32_t d = pick[0], below = pick[1], in_bin = pick[2];
    prefix |= (u64)d << shift;
    mask |= 0xFFull << shift;
    need -= below;
    if (in_bin == need) break;  // the k-th composite's bin taken whole (always at the last pass)
  }
  // the winners: every composite whose masked bits are at most the prefix
  for (int base = 0; base < n; base += SHORT_THREADS) {
    const int i = base + t;
    const u64 c = i < n ? s[i] : SENTINEL;
    const bool win = i < n && (c & mask) <= prefix;
    const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, win);
    uint32_t at = 0;
    if (lane == 0 && ballot) at = atomicAdd(count, (uint32_t)__popc(ballot));
    at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
    if (win) w[at] = c;
  }
  for (int i = k + t; i < KP; i += SHORT_THREADS) w[i] = SENTINEL;
  __syncthreads();
}

// ---- the short rows (rabitq_top_k_short)

// The k (<= 32) smallest of a warp's unique composites, ITEMS a lane, by k
// rounds of a warp minimum (shuffles): lane r returns the r-th smallest,
// lanes from k on SENTINEL.
template <int ITEMS>
__device__ __forceinline__ u64 warp_smallest(u64 (&c)[ITEMS], int k) {
  const int lane = threadIdx.x & 31;
  u64 least = SENTINEL;  // this lane's smallest composite left
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) least = c[i] < least ? c[i] : least;
  u64 mine = SENTINEL;  // lane r keeps round r's winner
  for (int round = 0; round < k; ++round) {
    u64 m = least;
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) {
      const u64 o = __shfl_xor_sync(0xFFFFFFFFu, m, d);
      m = o < m ? o : m;
    }
    if (lane == round) mine = m;
    if (least == m) {  // one lane: composites are unique
      least = SENTINEL;
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        c[i] = c[i] == m ? SENTINEL : c[i];
        least = c[i] < least ? c[i] : least;
      }
    }
  }
  return mine;
}

// Warp variant: warp w of block b takes row b * WARP_ROWS + w; ITEMS
// entries a lane (entry 32i + lane), n <= 32 * ITEMS, k <= 32.
template <int BITS, int ITEMS>
__global__ void __launch_bounds__(WARP_ROWS * 32)
top_k_warp_kernel(const void* __restrict__ x_, void* __restrict__ values_,
                  int32_t* __restrict__ indices, int64_t rows, int n, int k) {
  using raw_t = typename Word<BITS>::raw;
  const int lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * WARP_ROWS + (threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp
  const raw_t* __restrict__ x = reinterpret_cast<const raw_t*>(x_) + row * n;
  u64 c[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int j = 32 * i + lane;
    c[i] = j < n ? composite<BITS>((uint32_t)x[j], (uint32_t)j) : SENTINEL;
  }
  const u64 mine = warp_smallest(c, k);
  if (lane < k) write_out<BITS>(mine, reinterpret_cast<raw_t*>(values_), indices, row * k + lane);
}

// Shared-memory variants: block b takes row b. The row's composites in
// s[0 .. P) (sentinels past n), P = max(SORT_MIN, next power of two >= n);
// `select`: the winners in w[0 .. KP) (sentinels past k), KP likewise from k.
template <int BITS>
__global__ void __launch_bounds__(SHORT_THREADS, 2)
top_k_shared_kernel(const void* __restrict__ x_, void* __restrict__ values_,
                    int32_t* __restrict__ indices, int n, int k, int P, int KP, int select) {
  using raw_t = typename Word<BITS>::raw;
  constexpr int VEC = 128 / BITS;
  extern __shared__ u64 s[];
  __shared__ uint32_t hist[RADIX];
  __shared__ uint32_t warp_hist[SHORT_WARPS][RADIX];  // select: each warp counts here
  __shared__ uint32_t pick[3];
  __shared__ uint32_t count;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int64_t row = blockIdx.x;
  const raw_t* __restrict__ x = reinterpret_cast<const raw_t*>(x_) + row * n;
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(x) & 15) == 0) {  // 16-byte loads
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int nv = n / VEC;
#pragma unroll 4
    for (int j = t; j < nv; j += SHORT_THREADS) {
      uint32_t b[VEC];
      unpack<BITS>(__ldg(xv + j), b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) s[j * VEC + i] = composite<BITS>(b[i], j * VEC + i);
    }
    done = nv * VEC;
  }
  for (int i = done + t; i < P; i += SHORT_THREADS)
    s[i] = i < n ? composite<BITS>((uint32_t)x[i], i) : SENTINEL;
  if (select)
    for (int i = t; i < SHORT_WARPS * RADIX; i += SHORT_THREADS) (&warp_hist[0][0])[i] = 0;
  if (t == 0) count = 0;
  __syncthreads();
  const u64* out = s;
  if (select) {
    // the k-th smallest composite, 8 bits a pass: the key's bytes, then
    // the index's from its highest nonzero byte (the bits above are 0)
    const int index_top = n > 256 ? 8 : 0;  // n <= SHORT_N: 13 index bits at most
    u64 prefix = 0, mask = 0;
    uint32_t need = (uint32_t)k;
    for (int shift = 32 + BITS - 8; shift >= 0; shift -= 8) {
      if (shift < 32 && shift > index_top) continue;
      // a thread adds a run of one digit to its warp's histogram when the
      // run ends: a row of one value (bins no query offered) does not queue
      // on one address
      uint32_t run_d = RADIX, run_n = 0;
#pragma unroll 4
      for (int i = t; i < n; i += SHORT_THREADS) {
        const u64 c = s[i];
        if ((c & mask) != prefix) continue;
        const uint32_t d = (uint32_t)(c >> shift) & 0xFFu;
        if (d != run_d) {
          if (run_n) atomicAdd(&warp_hist[warp][run_d], run_n);
          run_d = d;
          run_n = 0;
        }
        ++run_n;
      }
      if (run_n) atomicAdd(&warp_hist[warp][run_d], run_n);
      __syncthreads();
      for (int b = t; b < RADIX; b += SHORT_THREADS) {
        uint32_t c = 0;
#pragma unroll
        for (int w = 0; w < SHORT_WARPS; ++w) {
          c += warp_hist[w][b];
          warp_hist[w][b] = 0;
        }
        hist[b] = c;
      }
      __syncthreads();
      if (t < 32) {  // the bin that holds the need-th smallest
        uint32_t cnt[8];
        uint32_t before = lane_bins(hist, cnt);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (before < need && need <= before + cnt[i]) {
            pick[0] = lane * 8 + i;
            pick[1] = before;
            pick[2] = cnt[i];
          }
          before += cnt[i];
        }
      }
      __syncthreads();  // hist and pick are written again after the next pass's barriers
      const uint32_t d = pick[0], below = pick[1], in_bin = pick[2];
      prefix |= (u64)d << shift;
      mask |= 0xFFull << shift;
      need -= below;
      if (in_bin == need) break;  // the k-th composite's bin taken whole (always at the last pass)
    }
    // the winners: every composite whose masked bits are at most the prefix
    u64* w = s + P;
    for (int base = 0; base < n; base += SHORT_THREADS) {
      const int i = base + t;
      const u64 c = i < n ? s[i] : SENTINEL;
      const bool win = i < n && (c & mask) <= prefix;
      const uint32_t ballot = __ballot_sync(0xFFFFFFFFu, win);
      uint32_t at = 0;
      if (lane == 0 && ballot) at = atomicAdd(&count, (uint32_t)__popc(ballot));
      at = __shfl_sync(0xFFFFFFFFu, at, 0) + __popc(ballot & ((1u << lane) - 1u));
      if (win) w[at] = c;
    }
    for (int i = k + t; i < KP; i += SHORT_THREADS) w[i] = SENTINEL;
    __syncthreads();
    bitonic_sort(w, KP);
    out = w;
  } else {
    bitonic_sort(s, P);
  }
  raw_t* values = reinterpret_cast<raw_t*>(values_);
  for (int i = t; i < k; i += SHORT_THREADS) write_out<BITS>(out[i], values, indices, row * k + i);
}

template <int BITS>
int launch_top_k_short(const void* x, void* values, void* indices, long long rows, int n, int k,
                       int mode, cudaStream_t stream) {
  if (mode == 0) {
    const unsigned blocks = (unsigned)((rows + WARP_ROWS - 1) / WARP_ROWS);
    if (n <= 128)
      top_k_warp_kernel<BITS, 4><<<blocks, WARP_ROWS * 32, 0, stream>>>(
          x, values, (int32_t*)indices, rows, n, k);
    else if (n <= 512)
      top_k_warp_kernel<BITS, 16><<<blocks, WARP_ROWS * 32, 0, stream>>>(
          x, values, (int32_t*)indices, rows, n, k);
    else
      top_k_warp_kernel<BITS, 32><<<blocks, WARP_ROWS * 32, 0, stream>>>(
          x, values, (int32_t*)indices, rows, n, k);
    return (int)cudaGetLastError();
  }
  int P = SORT_MIN, KP = SORT_MIN;
  while (P < n) P <<= 1;
  while (KP < k) KP <<= 1;
  const int select = mode == 2;
  if (select && 2 * KP > P) return (int)cudaErrorInvalidValue;
  // the shared-memory limit, set once a device (the first call comes before
  // any graph capture: every capture follows an eager run)
  static bool sized[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(top_k_shared_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SHORT_SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    sized[dev] = true;
  }
  const size_t smem = (size_t)(P + (select ? KP : 0)) * sizeof(u64);
  top_k_shared_kernel<BITS><<<(unsigned)rows, SHORT_THREADS, smem, stream>>>(
      x, values, (int32_t*)indices, n, k, P, KP, select);
  return (int)cudaGetLastError();
}

// ---- the long rows (rabitq_top_k)

constexpr int CAND = SHORT_N;  // candidates a row's block orders on chip: k and the ties at the cut
constexpr int META = 8;        // words a slot: candidates, prefix, mask, need, on chip or spilled
// the first pass's keys off the hint (SLOTS a thread); a row's candidates
// and winners; the spill's cells
constexpr int LONG_SMEM = 200 * 1024;
constexpr int MAX_CLUSTER = 16;
constexpr int SLOTS = LONG_SMEM / 8 / THREADS;  // the first pass's buffered keys a thread
static_assert(CELLS * 4 <= LONG_SMEM && SHORT_SMEM_MAX <= LONG_SMEM, "the dynamic shared memory");

__device__ unsigned long long spilled_rows;  // rows that took the spill, since the last reset

// A 16-byte load with an L2 cache policy (createpolicy); volatile, so that
// a batch's loads stay together ahead of their uses.
__device__ __forceinline__ uint4 load_policy(const uint4* p, uint64_t policy) {
  uint4 r;
  asm volatile("ld.global.nc.L2::cache_hint.v4.u32 {%0, %1, %2, %3}, [%4], %5;"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p), "l"(policy));
  return r;
}

// Calls f(bits[VEC], valid, index of bits[0]) on the slice [lo, hi) of a
// row, in no particular order: where the slice is aligned (lo a multiple of
// 8), batches of UNROLL 16-byte loads a thread with the cache policy, the
// next batch in flight while f runs on this one (a last batch's extra loads
// repeat the last word); single entries (valid = 1) elsewhere.
template <int BITS, typename F>
__device__ __forceinline__ void for_slice(const typename Word<BITS>::raw* __restrict__ x,
                                          int64_t lo, int64_t hi, bool vec, uint64_t policy,
                                          F&& f) {
  constexpr int VEC = 128 / BITS;
  constexpr int64_t STEP = (int64_t)UNROLL * THREADS;
  const int64_t nv = vec ? (hi - lo) / VEC : 0;
  int64_t done = lo;
  if (nv > 0) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    uint4 q[UNROLL], next[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int64_t j = threadIdx.x + u * THREADS;
      q[u] = load_policy(xv + (j < nv ? j : nv - 1), policy);
    }
    for (int64_t base = threadIdx.x; base < nv; base += STEP) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = base + STEP + u * THREADS;
        next[u] = load_policy(xv + (j < nv ? j : nv - 1), policy);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int64_t j = base + u * THREADS;
        if (j >= nv) break;
        uint32_t b[VEC];
        unpack<BITS>(q[u], b);
        f(b, VEC, lo + j * VEC);
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) q[u] = next[u];
    }
    done = lo + nv * VEC;
  }
  for (int64_t i = done + threadIdx.x; i < hi; i += THREADS) {
    uint32_t b[VEC] = {};
    b[0] = (uint32_t)x[i];
    f(b, 1, i);
  }
}

// The spill: one block takes the row's winners in index order into device
// scratch (every key whose masked value is below the prefix, and the first
// `need` equal to it) and sorts them stably by key, then writes the k
// outputs. key_a / idx_a hold k entries, their second buffers `plane`
// entries on. Leaves warp_digit zero.
template <int BITS>
__device__ void spill_row(const typename Word<BITS>::raw* __restrict__ x, int64_t n, int k,
                          uint32_t prefix, uint32_t mask, uint32_t need, uint32_t* key_a,
                          int32_t* idx_a, int64_t plane, typename Word<BITS>::raw* values,
                          int32_t* out_idx, uint32_t* hist, uint32_t (*warp_digit)[RADIX],
                          uint32_t* warp_sum, uint32_t* pick, uint32_t* cell_eq) {
  constexpr int VEC = 128 / BITS;
  constexpr int ITEMS = CHUNK * VEC;  // consecutive elements a thread takes
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // a cell's counts, then its first output position (the warps' histograms'
  // memory, free until the sort)
  uint32_t* cell_pos = &warp_digit[0][0];
  static_assert(CELLS == WARPS * RADIX, "cell_pos takes warp_digit's place");

  // ---- the winners in index order. In rounds of ROUND_TILES tiles: each
  // warp counts its cell of every tile (no barrier), one scan over the cells
  // in index order gives each cell's first output position and the equal
  // keys before it, then each warp reads again only its cells that hold
  // winners and places them with warp scans.
  constexpr int64_t TILE = (int64_t)THREADS * ITEMS;
  constexpr int PER = CELLS / THREADS;  // cells a thread scans
  uint32_t lt_seen = 0, eq_seen = 0;    // over the rounds before
  for (int64_t round = 0; round < n && lt_seen + min(eq_seen, need) < (uint32_t)k;
       round += TILE * ROUND_TILES) {
    const int64_t left = (n - round + TILE - 1) / TILE;
    const int tiles = left < ROUND_TILES ? (int)left : ROUND_TILES;
    const int cells = tiles * WARPS;
    uint4 q[CHUNK], next[CHUNK];
    load_chunk<BITS>(x, round + (int64_t)t * ITEMS, n, vec, q);
    for (int j = 0; j < tiles; ++j) {
      const int64_t first = round + j * TILE + (int64_t)t * ITEMS;
      if (j + 1 < tiles) load_chunk<BITS>(x, first + TILE, n, vec, next);  // in flight
      const uint32_t c = warp_total(chunk_counts<BITS>(q, chunk_valid<BITS>(first, n), mask, prefix));
      if (lane == 0) cell_pos[j * WARPS + warp] = c;
#pragma unroll
      for (int u = 0; u < CHUNK; ++u) q[u] = next[u];
    }
    __syncthreads();
    uint32_t lt_c[PER], eq_c[PER], eq_sum = 0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = t * PER + p;
      const uint32_t v = c < cells ? cell_pos[c] : 0u;
      lt_c[p] = v & 0xFFFFu;
      eq_c[p] = v >> 16;
      eq_sum += eq_c[p];
    }
    uint32_t eq_total, win_total;
    uint32_t e = eq_seen + block_exclusive_scan(eq_sum, warp_sum, eq_total);
    uint32_t win_sum = 0;
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const uint32_t eb = e;
      e += eq_c[p];
      eq_c[p] = eb;                                         // now: equal keys before the cell
      lt_c[p] += eb < need ? min(e - eb, need - eb) : 0u;  // now: the cell's winners
      win_sum += lt_c[p];
    }
    uint32_t pos = lt_seen + min(eq_seen, need) + block_exclusive_scan(win_sum, warp_sum, win_total);
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int c = t * PER + p;
      if (c < cells) {
        cell_pos[c] = pos;
        cell_eq[c] = eq_c[p];
      }
      pos += lt_c[p];
    }
    const uint32_t taken_eq = min(eq_seen + eq_total, need) - min(eq_seen, need);
    const uint32_t end = lt_seen + min(eq_seen, need) + win_total;
    lt_seen += win_total - taken_eq;
    eq_seen += eq_total;
    __syncthreads();
    for (int j = 0; j < tiles; ++j) {
      const int c = j * WARPS + warp;
      const uint32_t p0 = cell_pos[c], p1 = c + 1 < cells ? cell_pos[c + 1] : end;
      if (p0 == p1) continue;  // no winner in the cell (the same for the whole warp)
      const int64_t first = round + j * TILE + (int64_t)t * ITEMS;
      load_chunk<BITS>(x, first, n, vec, q);
      const int valid = chunk_valid<BITS>(first, n);
      const uint32_t cnt = chunk_counts<BITS>(q, valid, mask, prefix);
      uint32_t eb = cell_eq[c] + warp_exclusive_scan(cnt >> 16);
      const uint32_t mine = (cnt & 0xFFFFu) + (eb < need ? min(cnt >> 16, need - eb) : 0u);
      uint32_t at = p0 + warp_exclusive_scan(mine);
#pragma unroll
      for (int i = 0; i < ITEMS; ++i) {
        if (i >= valid) break;
        const uint32_t v = flip<BITS>(element<BITS>(q, i));
        const uint32_t m = v & mask;
        if (m < prefix || (m == prefix && eb < need)) {
          key_a[at] = v;
          idx_a[at] = (int32_t)(first + i);
          ++at;
        }
        eb += m == prefix;
      }
    }
    __syncthreads();  // the cells are written again by the next round
  }

  // ---- stable LSD radix sort of the k winners by key, 8 bits a pass (a
  // pass whose digits are all equal is skipped): each tile of 512 winners is
  // scattered with its rank among equal digits from the warps before it
  // (__match_any_sync inside a warp, per-warp digit counts across warps)
  uint32_t *src_k = key_a, *dst_k = key_a + plane;
  int32_t *src_i = idx_a, *dst_i = idx_a + plane;
  const uint32_t m = (uint32_t)k;
  for (int i = t; i < WARPS * RADIX; i += THREADS) (&warp_digit[0][0])[i] = 0;
  for (int shift = 0; shift < BITS; shift += 8) {
    for (int i = t; i < RADIX; i += THREADS) hist[i] = 0;
    __syncthreads();
    for (uint32_t i = t; i < m; i += THREADS) atomicAdd(&hist[(src_k[i] >> shift) & 0xFFu], 1u);
    __syncthreads();
    if (digit_starts(hist, m, &pick[0])) {
      __syncthreads();  // pick is written again by the next pass
      continue;         // one digit: the pass would move nothing
    }
    for (uint32_t tile = 0; tile < m; tile += THREADS) {
      const uint32_t i = tile + t;
      const bool ok = i < m;
      const uint32_t v = ok ? src_k[i] : 0u;
      const int32_t id = ok ? src_i[i] : 0;
      const uint32_t d = ok ? (v >> shift) & 0xFFu : 0xFFFFu;
      const uint32_t peers = __match_any_sync(0xFFFFFFFFu, d);
      const uint32_t rank = __popc(peers & ((1u << lane) - 1u));
      if (ok && rank == 0) warp_digit[warp][d] = __popc(peers);
      __syncthreads();
      if (ok) {
        uint32_t r = hist[d] + rank;
        for (int w = 0; w < warp; ++w) r += warp_digit[w][d];
        dst_k[r] = v;
        dst_i[r] = id;
      }
      __syncthreads();
      for (int dd = t; dd < RADIX; dd += THREADS) {
        uint32_t s = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          s += warp_digit[w][dd];
          warp_digit[w][dd] = 0;
        }
        hist[dd] += s;
      }
      __syncthreads();
    }
    uint32_t* tk = src_k;
    src_k = dst_k;
    dst_k = tk;
    int32_t* ti = src_i;
    src_i = dst_i;
    dst_i = ti;
  }
  for (uint32_t i = t; i < m; i += THREADS) {
    values[i] = (typename Word<BITS>::raw)flip<BITS>(src_k[i]);
    out_idx[i] = src_i[i];
  }
}

// The persistent grid: `clusters` clusters of cs blocks; cluster c takes
// rows c, c + clusters, ..., in waves of cs rows. Slot s (a block of the
// grid) holds the candidates cand[s][0 .. CAND) and meta[s] of the row that
// block s orders: row j of the wave goes to the cluster's block of rank j.
template <int BITS>
__global__ void __launch_bounds__(THREADS, 1)
top_k_cluster_kernel(const void* __restrict__ x_, void* __restrict__ values_,
                     int32_t* __restrict__ indices, u64* __restrict__ cand,
                     uint32_t* __restrict__ meta, uint32_t* __restrict__ skey,
                     int32_t* __restrict__ sidx, int64_t rows, int64_t n, int k, int clusters,
                     int spill_slots) {
  using raw_t = typename Word<BITS>::raw;
  constexpr int VEC = 128 / BITS;
  extern __shared__ u64 dyn[];  // a row's candidates and winners; the spill's cells
  __shared__ uint32_t part[2][RADIX];  // this block's histogram of a pass, by parity: the cluster adds them
  __shared__ uint32_t hist[RADIX];     // the cluster's histogram of a pass
  __shared__ uint32_t warp_digit[WARPS][RADIX];
  __shared__ uint32_t warp_sum[WARPS];
  __shared__ uint32_t pick[3];
  __shared__ uint32_t count;
  __shared__ uint32_t hints[4];  // a pass's most frequent digit in the last row (alike in every block)
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int64_t cid = blockIdx.x / cs;
  const int t = threadIdx.x, warp = t >> 5;
  for (int i = t; i < WARPS * RADIX; i += THREADS) (&warp_digit[0][0])[i] = 0;
  if (t < 4) hints[t] = t == 0 ? 0xFFu : 0u;  // 0xFF: the top byte of -inf
  __syncthreads();
  int par = 0;
  for (int64_t j0 = 0; cid + j0 * clusters < rows; j0 += cs) {
    for (int64_t j = j0; j < j0 + cs && cid + j * clusters < rows; ++j) {
      const int64_t row = cid + j * clusters;
      const raw_t* __restrict__ x = reinterpret_cast<const raw_t*>(x_) + row * n;
      const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
      const int64_t slot = blockIdx.x - rank + (j - j0);  // the block that orders the row
      uint32_t* m = meta + slot * META;
      u64* c_out = cand + slot * CAND;
      // this block's slice of the row: [lo, hi), lo a multiple of 8
      const int64_t per = ((n + cs - 1) / cs + 7) / 8 * 8;
      const int64_t lo = min(n, (int64_t)rank * per), hi = min(n, lo + per);
      if (rank == 0 && t == 0) m[0] = 0;  // the candidates' count: the blocks add after a barrier
      uint32_t prefix = 0, mask = 0, need = (uint32_t)k;
      bool on_chip = false;
      // the first pass's keys off the hint: thread t's j-th at buf[j * THREADS + t]
      u64* buf = dyn;
      uint32_t nbuf = 0;
      bool from_buf = false;  // the later passes read the buffer: the first digit is off the hint
      bool buf_wins = false;  // and so can the collection: the hint's keys are above the prefix
      for (int shift = BITS - 8; shift >= 0; shift -= 8) {
        // This block's histogram of the keys that match the prefix. From the
        // row: the keys of the hinted digit (this pass's most frequent in the
        // cluster's last row) counted in a register, each other one taken
        // apart (in the first pass into this thread's slots of the buffer,
        // past them one atomic on the warp's histogram). Both tests on the
        // float's bits: once the prefix holds the sign bit the key is the
        // bits xor a constant (raw_of), and the first digit holds the sign.
        // From the buffer, once the first digit is off the hint: every key
        // that can still match is there.
        const int p = (BITS - 8 - shift) / 8;
        const uint32_t hint = hints[p];
        uint64_t keep;  // the row stays in the L2 for the passes after this one
        asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(keep));
        uint32_t* own = warp_digit[warp];
        bool short_of_slots = false;
        if (from_buf) {
          for (uint32_t j = 0; j < nbuf; ++j) {
            const uint32_t v = (uint32_t)(buf[j * THREADS + t] >> 32);
            if ((v & mask) == prefix) atomicAdd(&own[(v >> shift) & 0xFFu], 1u);
          }
        } else {
          const bool first = mask == 0;
          const uint32_t hm = mask | (0xFFu << shift);
          const uint32_t rp = raw_of<BITS>(prefix, prefix) & mask;  // the prefix's bits
          const uint32_t hv =  // the prefix and hint's bits
              raw_of<BITS>(prefix | (hint << shift), first ? hint << shift : prefix) & hm;
          uint32_t n0 = 0;
          if (first) {  // every key matches; those off the hint into the slots
            for_slice<BITS>(x, lo, hi, vec, keep, [&](const uint32_t (&b)[VEC], int valid, int64_t at) {
              uint32_t rare = 0;
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                const bool ok = i < valid, hit = (b[i] & hm) == hv;
                n0 += ok && hit;
                rare |= (uint32_t)(ok && !hit) << i;
              }
              while (rare) {
                const int i = __ffs(rare) - 1;
                rare &= rare - 1;
                uint32_t bi = b[0];
#pragma unroll
                for (int j = 1; j < VEC; ++j) bi = i == j ? b[j] : bi;
                const uint32_t v = flip<BITS>(bi);
                if (nbuf < SLOTS) {
                  buf[nbuf++ * THREADS + t] = ((u64)v << 32) | (uint32_t)(at + i);
                } else {
                  short_of_slots = true;
                  atomicAdd(&own[v >> shift], 1u);
                }
              }
            });
            for (uint32_t j = 0; j < nbuf; ++j)  // the buffered keys' digits
              atomicAdd(&own[(uint32_t)(buf[j * THREADS + t] >> (32 + shift))], 1u);
          } else {
            for_slice<BITS>(x, lo, hi, vec, keep, [&](const uint32_t (&b)[VEC], int valid, int64_t) {
              uint32_t rare = 0;
#pragma unroll
              for (int i = 0; i < VEC; ++i) {
                const bool ok = i < valid, hit = (b[i] & hm) == hv;
                n0 += ok && hit;
                rare |= (uint32_t)(ok && !hit && (b[i] & mask) == rp) << i;
              }
#pragma unroll
              for (int i = 0; i < VEC; ++i)  // mostly all of them: no loop over the bits
                if ((rare >> i) & 1u) atomicAdd(&own[(flip<BITS>(b[i]) >> shift) & 0xFFu], 1u);
            });
          }
          if (n0) atomicAdd(&own[hint], n0);
        }
        const bool incomplete = __syncthreads_or(short_of_slots);  // some keys off the hint not buffered
        for (int i = t; i < RADIX; i += THREADS) {
          uint32_t c = 0;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) {
            c += warp_digit[w][i];
            warp_digit[w][i] = 0;
          }
          part[par][i] = c;
        }
        // part[par] is read by the cluster after this barrier and written
        // again two passes on, after the next one
        cluster.sync();
        for (int i = t; i < RADIX; i += THREADS) {  // every block's bin i, all loads in flight
          uint32_t c[MAX_CLUSTER];
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r)
            c[r] = r < cs ? cluster.map_shared_rank(&part[par][0], r)[i] : 0u;
          uint32_t sum = 0;
#pragma unroll
          for (int r = 0; r < MAX_CLUSTER; ++r) sum += c[r];
          hist[i] = sum;
        }
        __syncthreads();
        pick_bin(hist, need, pick);
        if (warp == 1) most_frequent(hist, &hints[p]);  // the next row's hint for this pass
        __syncthreads();  // hist and pick are written again after the next pass's barrier
        const uint32_t d = pick[0], below = pick[1], in_bin = pick[2];
        par ^= 1;
        if (mask == 0) {
          from_buf = !incomplete && d != hint;
          buf_wins = from_buf && hint > d;
        }
        prefix |= d << shift;
        mask |= 0xFFu << shift;
        need -= below;
        if ((uint32_t)k - need + in_bin <= (uint32_t)CAND) {  // below the prefix, and its bin
          on_chip = true;
          break;
        }
        if (in_bin == need) break;  // the k-th key's bin taken whole: the spill takes it
      }
      if (on_chip && buf_wins) {  // every key whose masked value is at most the prefix
        for (uint32_t j = 0; j < nbuf; ++j) {
          const u64 c = buf[j * THREADS + t];
          if (((uint32_t)(c >> 32) & mask) <= prefix) c_out[atomicAdd(m, 1u)] = c;
        }
      } else if (on_chip) {  // the same from the row, as composites, its last read
        uint64_t drop;
        asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(drop));
        for_slice<BITS>(x, lo, hi, vec, drop, [&](const uint32_t (&b)[VEC], int valid, int64_t first) {
          uint32_t mine = 0;
#pragma unroll
          for (int i = 0; i < VEC; ++i) mine += i < valid && (flip<BITS>(b[i]) & mask) <= prefix;
          if (!mine) return;
          cg::coalesced_group g = cg::coalesced_threads();
          const uint32_t before = cg::exclusive_scan(g, mine);
          uint32_t at = 0;
          if (g.thread_rank() == g.num_threads() - 1) at = atomicAdd(m, before + mine);
          at = g.shfl(at, g.num_threads() - 1) + before;
#pragma unroll
          for (int i = 0; i < VEC; ++i) {
            const uint32_t v = flip<BITS>(b[i]);
            if (i < valid && (v & mask) <= prefix) c_out[at++] = ((u64)v << 32) | (uint32_t)(first + i);
          }
        });
      }
      if (rank == 0 && t == 0) {
        m[1] = prefix;
        m[2] = mask;
        m[3] = need;
        m[4] = on_chip;
      }
    }
    cluster.sync();  // the wave's candidates and meta are written
    const int64_t row = cid + (j0 + rank) * clusters;
    if (row < rows) {  // this block orders row j0 + rank of the wave
      // what other blocks wrote, read from the L2 (__ldcg): this block's L1
      // may hold the slot's lines from an earlier wave
      const uint32_t* m = meta + (int64_t)blockIdx.x * META;
      uint32_t mv[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) mv[i] = __ldcg(m + i);
      raw_t* values = reinterpret_cast<raw_t*>(values_) + row * k;
      int32_t* out_idx = indices + row * k;
      if (mv[4]) {
        const int M = (int)mv[0];
        int P = SORT_MIN, KP = SORT_MIN;
        while (P < M) P <<= 1;
        while (KP < k) KP <<= 1;
        const bool select = 2 * KP <= P;  // else sort all P: at most CAND
        const u64* c_in = cand + (int64_t)blockIdx.x * CAND;
        for (int i = t; i < P; i += THREADS) dyn[i] = i < M ? __ldcg(c_in + i) : SENTINEL;
        if (t == 0) count = 0;
        __syncthreads();
        const u64* out = dyn;
        if (select) {
          select_composites<BITS>(dyn, M, n, k, dyn + P, KP, hist, warp_digit, pick, &count);
          bitonic_sort(dyn + P, KP);
          out = dyn + P;
        } else {
          bitonic_sort(dyn, P);
        }
        for (int i = t; i < k; i += THREADS) write_out<BITS>(out[i], values, out_idx, i);
      } else {
        // scratch of this block's first row, unique in the grid and below spill_slots
        const int64_t slot = cid + (int64_t)rank * clusters;
        spill_row<BITS>(reinterpret_cast<const raw_t*>(x_) + row * n, n, k, mv[1], mv[2], mv[3],
                        skey + slot * k, sidx + slot * k, (int64_t)spill_slots * k, values,
                        out_idx, hist, warp_digit, warp_sum, pick, reinterpret_cast<uint32_t*>(dyn));
        if (t == 0) atomicAdd(&spilled_rows, 1ull);
      }
      __syncthreads();  // shared memory is written again by the next wave
    }
  }
}

// ---- one long row, k <= WARP_K (the k-means reseed): top_k_grid_kernel.
// Every block of the grid takes a slice of the row, each warp keeps the k
// smallest composites it has seen (lane i the i-th; an entry below the k-th
// is inserted with shuffles), the block merges its warps' lists, and the
// last block to finish (a ticket) merges the blocks' lists: one read of the
// row from HBM over the whole card, and an order that no slot or ticket
// decides, the composites being unique.

constexpr int GRID_UNROLL = 4;  // 16-byte loads a lane has in flight
__device__ unsigned int grid_ticket;  // blocks of a grid launch done; the last one resets it

// Offers each lane's composite c (SENTINEL: none) to the warp's list of the k
// smallest so far: lane i holds the i-th (lanes from k on SENTINEL), thr the
// k-th. Every lane of the warp calls it.
__device__ __forceinline__ void offer(u64 c, u64& list, u64& thr, int k) {
  const int lane = threadIdx.x & 31;
  unsigned want = __ballot_sync(0xFFFFFFFFu, c < thr);
  while (want) {
    const int src = __ffs(want) - 1;
    const u64 cc = __shfl_sync(0xFFFFFFFFu, c, src);
    const u64 prev = __shfl_up_sync(0xFFFFFFFFu, list, 1);
    if (lane < k && !(list < cc)) list = (lane == 0 || prev < cc) ? cc : prev;
    thr = __shfl_sync(0xFFFFFFFFu, list, k - 1);
    if (lane == src) c = SENTINEL;
    want = __ballot_sync(0xFFFFFFFFu, c < thr);
  }
}

// The block's k smallest of its warps' lists, in order, into out[0 .. k)
// (written by warp 0; wl holds WARPS x 32 composites). Barriers inside.
__device__ void merge_warp_lists(u64 list, u64* wl, int k, u64* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  wl[warp * 32 + lane] = list;
  __syncthreads();
  if (warp == 0) {
    u64 c[WARPS];
#pragma unroll
    for (int i = 0; i < WARPS; ++i) c[i] = wl[i * 32 + lane];
    const u64 mine = warp_smallest(c, k);
    if (lane < k) out[lane] = mine;
  }
  __syncthreads();
}

// One row of n entries; part [gridDim.x, WARP_K] holds the blocks' lists.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
top_k_grid_kernel(const void* __restrict__ x_, void* __restrict__ values_,
                  int32_t* __restrict__ indices, u64* __restrict__ part, int64_t n, int k) {
  using raw_t = typename Word<BITS>::raw;
  constexpr int VEC = 128 / BITS;
  __shared__ u64 wl[WARPS * 32];
  __shared__ u64 best[WARP_K];
  __shared__ unsigned last;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const raw_t* __restrict__ x = reinterpret_cast<const raw_t*>(x_);
  const int64_t per = ((n + gridDim.x - 1) / gridDim.x + 7) / 8 * 8;
  const int64_t lo = min(n, (int64_t)blockIdx.x * per), hi = min(n, lo + per);
  u64 list = SENTINEL, thr = SENTINEL;
  int64_t done = lo;
  if ((reinterpret_cast<uintptr_t>(x + lo) & 15) == 0) {  // 16-byte loads, a warp in step
    const uint4* xv = reinterpret_cast<const uint4*>(x + lo);
    const int64_t nv = (hi - lo) / VEC;
    for (int64_t base = (int64_t)warp * 32 * GRID_UNROLL; base < nv;
         base += (int64_t)THREADS * GRID_UNROLL) {
      uint4 q[GRID_UNROLL];
#pragma unroll
      for (int u = 0; u < GRID_UNROLL; ++u) {
        const int64_t j = base + u * 32 + lane;
        q[u] = __ldg(xv + (j < nv ? j : nv - 1));
      }
#pragma unroll
      for (int u = 0; u < GRID_UNROLL; ++u) {
        const int64_t j = base + u * 32 + lane;
        uint32_t b[VEC];
        unpack<BITS>(q[u], b);
#pragma unroll
        for (int i = 0; i < VEC; ++i)
          offer(j < nv ? composite<BITS>(b[i], (uint32_t)(lo + j * VEC + i)) : SENTINEL, list,
                thr, k);
      }
    }
    done = lo + nv * VEC;
  }
  for (int64_t base = done + warp * 32; base < hi; base += THREADS) {
    const int64_t i = base + lane;
    offer(i < hi ? composite<BITS>((uint32_t)x[i], (uint32_t)i) : SENTINEL, list, thr, k);
  }
  merge_warp_lists(list, wl, k, part + (int64_t)blockIdx.x * WARP_K);
  __threadfence();  // the block's list, before its ticket
  __syncthreads();
  if (t == 0) last = atomicAdd(&grid_ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  list = thr = SENTINEL;
  const int64_t m = (int64_t)gridDim.x * k;
  for (int64_t base = warp * 32; base < m; base += THREADS) {
    const int64_t i = base + lane;
    offer(i < m ? __ldcg(part + (i / k) * WARP_K + i % k) : SENTINEL, list, thr, k);
  }
  merge_warp_lists(list, wl, k, best);
  if (t < k) write_out<BITS>(best[t], reinterpret_cast<raw_t*>(values_), indices, t);
  if (t == 0) grid_ticket = 0;  // for the next launch, stream-ordered behind this one
}

// The long-row kernel's attributes, set once a device (the first call comes
// before any graph capture: every capture follows an eager run).
template <int BITS>
cudaError_t prepare_cluster_kernel() {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (ready[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(top_k_cluster_kernel<BITS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           LONG_SMEM);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(top_k_cluster_kernel<BITS>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (e == cudaSuccess) ready[dev] = true;
  return e;
}

// `clusters` clusters of `cluster` blocks on `stream`; attr holds the
// cluster dimension.
cudaLaunchConfig_t cluster_config(int cluster, int clusters, cudaStream_t stream,
                                  cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(cluster * clusters));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = LONG_SMEM;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int BITS>
int launch_top_k_long(const void* x, void* values, void* indices, void* cand, void* meta,
                      void* skey, void* sidx, long long rows, long long n, int k, int cluster,
                      int clusters, cudaStream_t stream) {
  cudaError_t e = prepare_cluster_kernel<BITS>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, clusters, stream, &attr);
  const long long blocks = (long long)cluster * clusters;
  const int spill_slots = (int)(rows < blocks ? rows : blocks);
  e = cudaLaunchKernelEx(&cfg, top_k_cluster_kernel<BITS>, x, values, (int32_t*)indices,
                         (u64*)cand, (uint32_t*)meta, (uint32_t*)skey, (int32_t*)sidx,
                         (int64_t)rows, (int64_t)n, k, clusters, spill_slots);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The long rows: x [rows, n] f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// values [rows, k] of x's type, indices [rows, k] int32 into the row. The
// grid: `clusters` clusters of `cluster` blocks (1 .. 16). Scratch:
// candidates [cluster * clusters, CAND] 64-bit, meta [cluster * clusters,
// META] 32-bit, spill keys and spill indices [2, min(rows, cluster *
// clusters), k] 32-bit each. 1 <= k <= n < 2^31.
extern "C" int rabitq_top_k(const void* x, void* values, void* indices, void* cand, void* meta,
                            void* skey, void* sidx, long long rows, long long n, int k,
                            int cluster, int clusters, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (rows <= 0 || k <= 0) return 0;
  if (k > n || n > 0x7FFFFFFFLL || cluster < 1 || cluster > MAX_CLUSTER || clusters < 1 ||
      (long long)cluster * clusters > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    return launch_top_k_long<16>(x, values, indices, cand, meta, skey, sidx, rows, n, k, cluster,
                                 clusters, stream);
  return launch_top_k_long<32>(x, values, indices, cand, meta, skey, sidx, rows, n, k, cluster,
                               clusters, stream);
}

// One long row, k <= 32: x [n] f32 (bf16 = 0) or bf16 (bf16 = 1); values
// [k] of x's type, indices [k] int32; `blocks` blocks, scratch part [blocks,
// 32] 64-bit. Launches of this variant on one device run one at a time (the
// stream orders them). 1 <= k <= n < 2^31.
extern "C" int rabitq_top_k_grid(const void* x, void* values, void* indices, void* part,
                                 long long n, int k, int blocks, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (k <= 0) return 0;
  if (k > WARP_K || k > n || n > 0x7FFFFFFFLL || blocks < 1)
    return (int)cudaErrorInvalidValue;
  if (bf16)
    top_k_grid_kernel<16><<<blocks, THREADS, 0, stream>>>(x, values, (int32_t*)indices,
                                                           (u64*)part, n, k);
  else
    top_k_grid_kernel<32><<<blocks, THREADS, 0, stream>>>(x, values, (int32_t*)indices,
                                                           (u64*)part, n, k);
  return (int)cudaGetLastError();
}

// How many clusters of `cluster` blocks of the long-row kernel the current
// device holds at once, into *out (0 where that size does not fit).
extern "C" int rabitq_top_k_clusters(int cluster, int bf16, int* out) {
  *out = 0;
  if (cluster < 1 || cluster > MAX_CLUSTER) return (int)cudaErrorInvalidValue;
  cudaError_t e = bf16 ? prepare_cluster_kernel<16>() : prepare_cluster_kernel<32>();
  if (e != cudaSuccess) return (int)e;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(cluster, 1, nullptr, &attr);
  e = bf16 ? cudaOccupancyMaxActiveClusters(out, top_k_cluster_kernel<16>, &cfg)
           : cudaOccupancyMaxActiveClusters(out, top_k_cluster_kernel<32>, &cfg);
  if (e != cudaSuccess) {  // a size the card refuses holds no cluster
    *out = 0;
    cudaGetLastError();
  }
  return 0;
}

// The rows the long-row kernel sent through the spill on the current device
// since the last reset, into *out; resets the count where `reset` is set.
// Synchronous (the caller synchronises its streams first).
extern "C" int rabitq_top_k_spilled(unsigned long long* out, int reset) {
  cudaError_t e = cudaMemcpyFromSymbol(out, spilled_rows, sizeof(unsigned long long));
  if (e == cudaSuccess && reset) {
    const unsigned long long zero = 0;
    e = cudaMemcpyToSymbol(spilled_rows, &zero, sizeof zero);
  }
  return (int)e;
}

// The short rows: x [rows, n] f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous;
// values [rows, k] of x's type, indices [rows, k] int32 into the row. mode:
// 0 the warp variant (k <= 32, n <= 1024), 1 sort, 2 select (n <= 8192; for
// select, 2 * KP <= P). 1 <= k <= n.
extern "C" int rabitq_top_k_short(const void* x, void* values, void* indices, long long rows,
                                  long long n, int k, int mode, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (rows <= 0 || k <= 0) return 0;
  if (k > n || n > SHORT_N || rows > 0x7FFFFFFFLL || mode < 0 || mode > 2 ||
      (mode == 0 && (k > WARP_K || n > WARP_N)))
    return (int)cudaErrorInvalidValue;
  if (bf16) return launch_top_k_short<16>(x, values, indices, rows, (int)n, k, mode, stream);
  return launch_top_k_short<32>(x, values, indices, rows, (int)n, k, mode, stream);
}
