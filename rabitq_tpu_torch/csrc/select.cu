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
// One block a row, or where the rows are too few to fill the card one block
// a segment of a row and then a second launch over the segments' winners
// (`idx_in` maps their indices back; ops/select.py picks the segments).
// Three phases on the key v of each entry: the float's bits b mapped so that
// v ascending is the total order descending (b where the sign bit is set,
// else b with every other bit flipped; the map is its own inverse, so values
// come back exactly from the keys).
//  A. Radix select, 8 bits a pass from the top (two passes for bf16, read
//     as 16 bits, four for f32): a histogram of the digit of every key that
//     matches the prefix found so far, then the digit that holds the k-th
//     smallest key. It stops early once the k-th key's bin is taken whole.
//     Atomics only count: each thread keeps runs of its two most frequent
//     digits in registers and adds them to its warp's own histogram in
//     shared memory when one is displaced, so a row that is mostly one or
//     two values (a masked -inf plane, lower bounds of one magnitude) does
//     not queue on one address.
//  B. The winners in index order: every key whose masked value is below
//     the prefix, and the first `need` keys equal to it. In rounds of 256
//     tiles of 4096 entries: each warp counts its share of every tile (no
//     barrier), one block-wide exclusive scan over those shares in index
//     order gives each share's first output position and the equal keys
//     before it, and each warp reads again only its shares that hold
//     winners and places them with warp scans. No atomics; the winners
//     land in index order in scratch.
//  C. A stable least-significant-digit radix sort of the k winners by key,
//     8 bits a pass (a pass whose digits are all equal is skipped): each
//     tile of 512 winners is scattered with its rank among equal digits
//     from the warps before it (__match_any_sync inside a warp, per-warp
//     digit counts across warps), so equal keys keep index order. It runs
//     in device scratch, so every k <= n is exact; no library sort.
// Output positions come from the scans and the sort only, so every run
// gives the same bits, in a CUDA graph or eagerly; the launch allocates
// nothing and does not synchronise.
//
// Bound on the H100: bytes, one read of the row (512 MB for [256, 1M]
// bf16: 0.153 ms at 3.35 TB/s). The design reads it three times for bf16
// (two histogram passes and B's count; B's second read touches only the
// shares with winners) and five times for f32; two blocks of 512 threads
// stay resident on a multiprocessor (64 registers, no spills).
//
// rabitq_top_k_short -- the same function for rows that fit on chip (n <=
// SHORT_N), read once, with no device scratch. Each entry becomes a unique
// 64-bit composite: its key (as above) in the high word and its index in
// the low word, so ascending composites are lax.top_k's order with ties to
// the lower index, and any correct sort or selection of the composites
// gives the same output. ops/select.kernel_path picks the variant:
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

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int RADIX = 256;
// 16-byte loads a thread takes in turn in phase B: 8 consecutive entries of
// either type
template <int BITS> constexpr int CHUNK = BITS == 16 ? 1 : 2;
constexpr int UNROLL = 4;  // 16-byte loads a thread has in flight in a pass of phase A
constexpr int ROUND_TILES = 256;  // tiles of THREADS chunks a round of phase B counts
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
__device__ __forceinline__ uint32_t element(const uint4 (&q)[CHUNK<BITS>], int i) {
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
                                           uint4 (&q)[CHUNK<BITS>]) {
  constexpr int ITEMS = CHUNK<BITS> * 128 / BITS;
  if (vec && first + ITEMS <= n) {
    const uint4* xv = reinterpret_cast<const uint4*>(x + first);
#pragma unroll
    for (int u = 0; u < CHUNK<BITS>; ++u) q[u] = __ldg(xv + u);
    return;
  }
  uint32_t w[4 * CHUNK<BITS>];
#pragma unroll
  for (int i = 0; i < 4 * CHUNK<BITS>; ++i) w[i] = 0;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i)
    if (first + i < n) w[i * BITS / 32] |= (uint32_t)x[first + i] << (i * BITS % 32);
#pragma unroll
  for (int u = 0; u < CHUNK<BITS>; ++u) q[u] = make_uint4(w[4 * u], w[4 * u + 1], w[4 * u + 2], w[4 * u + 3]);
}

// Elements of a chunk at `first` that lie before n: 0 .. ITEMS.
template <int BITS>
__device__ __forceinline__ int chunk_valid(int64_t first, int64_t n) {
  constexpr int ITEMS = CHUNK<BITS> * 128 / BITS;
  const int64_t left = n - first;
  return left <= 0 ? 0 : left >= ITEMS ? ITEMS : (int)left;
}

// (equal << 16) | below: the chunk's keys whose masked value is below the
// prefix, and equal to it
template <int BITS>
__device__ __forceinline__ uint32_t chunk_counts(const uint4 (&q)[CHUNK<BITS>], int valid,
                                                 uint32_t mask, uint32_t prefix) {
  constexpr int ITEMS = CHUNK<BITS> * 128 / BITS;
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

// Calls f(bits) on every element of the row, in no particular order:
// UNROLL 16-byte loads at a time where the row is aligned.
template <int BITS, typename F>
__device__ __forceinline__ void for_each(const typename Word<BITS>::raw* __restrict__ x,
                                         int64_t n, bool vec, F&& f) {
  constexpr int VEC = 128 / BITS;
  int64_t done = 0;
  if (vec) {
    const uint4* xv = reinterpret_cast<const uint4*>(x);
    const int64_t nv = n / VEC;
    int64_t j = threadIdx.x;
    for (; j + (UNROLL - 1) * THREADS < nv; j += UNROLL * THREADS) {
      uint4 q[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) q[u] = __ldg(xv + j + u * THREADS);
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        uint32_t b[VEC];
        unpack<BITS>(q[u], b);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f(b[i]);
      }
    }
    for (; j < nv; j += THREADS) {
      uint32_t b[VEC];
      unpack<BITS>(__ldg(xv + j), b);
#pragma unroll
      for (int i = 0; i < VEC; ++i) f(b[i]);
    }
    done = nv * VEC;
  }
  for (int64_t i = done + threadIdx.x; i < n; i += THREADS) f((uint32_t)x[i]);
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

template <int BITS>
__global__ void __launch_bounds__(THREADS, 2)
top_k_select_kernel(const void* __restrict__ x_, void* __restrict__ values_,
                    int32_t* __restrict__ indices, uint32_t* __restrict__ skey,
                    int32_t* __restrict__ sidx, const int32_t* __restrict__ idx_in,
                    int64_t row_len, int64_t seg, int segments, int k) {
  using raw_t = typename Word<BITS>::raw;
  constexpr int VEC = 128 / BITS;
  constexpr int ITEMS = CHUNK<BITS> * VEC;  // consecutive elements a thread takes in phase B
  __shared__ uint32_t hist[RADIX];
  __shared__ uint32_t warp_digit[WARPS][RADIX];  // per-warp histograms in A, digit counts in C
  __shared__ uint32_t warp_sum[WARPS];
  __shared__ uint32_t pick[3];
  __shared__ uint32_t cell_eq[CELLS];  // phase B: equal keys before a cell
  // phase B: a cell's counts, then its first output position (the warps'
  // histograms' memory, free between A and C)
  uint32_t* cell_pos = &warp_digit[0][0];
  static_assert(CELLS == WARPS * RADIX, "cell_pos takes warp_digit's place");
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  // block b selects from segment b % segments of row b / segments
  const int64_t row = blockIdx.x / segments;
  const int64_t start = (blockIdx.x % segments) * seg;
  const int64_t n = blockIdx.x % segments == segments - 1 ? row_len - start : seg;
  const raw_t* __restrict__ x = reinterpret_cast<const raw_t*>(x_) + row * row_len + start;
  const bool vec = (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int64_t plane = (int64_t)gridDim.x * k;  // one scratch buffer
  uint32_t* key_a = skey + (int64_t)blockIdx.x * k;
  int32_t* idx_a = sidx + (int64_t)blockIdx.x * k;
  for (int i = t; i < WARPS * RADIX; i += THREADS) (&warp_digit[0][0])[i] = 0;

  // ---- A: the k-th smallest key, 8 bits a pass
  uint32_t prefix = 0, mask = 0, need = (uint32_t)k;
  for (int shift = BITS - 8; shift >= 0; shift -= 8) {
    __syncthreads();  // the warps' histograms are zero
    // a thread counts runs of its two most frequent digits in registers and
    // adds them to its warp's histogram when one is displaced: a row that is
    // mostly one or two values (a masked plane, lower bounds of one
    // magnitude) does not queue on one address
    uint32_t d0 = RADIX, n0 = 0, d1 = RADIX, n1 = 0;
    uint32_t* own = warp_digit[warp];
    for_each<BITS>(x, n, vec, [&](uint32_t b) {
      const uint32_t v = flip<BITS>(b);
      if ((v & mask) != prefix) return;
      const uint32_t d = (v >> shift) & 0xFFu;
      if (d == d0) {
        ++n0;
      } else if (d == d1) {
        if (++n1 > n0) {  // keep the more frequent digit in slot 0
          const uint32_t td = d0, tn = n0;
          d0 = d1, n0 = n1, d1 = td, n1 = tn;
        }
      } else {
        if (n1) atomicAdd(&own[d1], n1);
        d1 = d;
        n1 = 1;
      }
    });
    if (n0) atomicAdd(&own[d0], n0);
    if (n1) atomicAdd(&own[d1], n1);
    __syncthreads();
    for (int i = t; i < RADIX; i += THREADS) {
      uint32_t c = 0;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        c += warp_digit[w][i];
        warp_digit[w][i] = 0;
      }
      hist[i] = c;
    }
    __syncthreads();
    if (t < 32) {  // the bin that holds the need-th smallest key
      uint32_t c[8];
      uint32_t before = lane_bins(hist, c);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (before < need && need <= before + c[i]) {
          pick[0] = lane * 8 + i;
          pick[1] = before;
          pick[2] = c[i];
        }
        before += c[i];
      }
    }
    __syncthreads();
    const uint32_t d = pick[0], below = pick[1], in_bin = pick[2];
    __syncthreads();  // pick and hist are written again by the next pass
    prefix |= d << shift;
    mask |= 0xFFu << shift;
    need -= below;
    if (in_bin == need) break;  // the k-th key's bin is taken whole
  }

  // ---- B: the winners in index order: masked key below the prefix, and the
  // first `need` equal to it. In rounds of ROUND_TILES tiles: each warp
  // counts its cell of every tile (no barrier), one scan over the cells in
  // index order gives each cell's first output position and the equal keys
  // before it, then each warp reads again only its cells that hold winners
  // and places them with warp scans.
  constexpr int64_t TILE = (int64_t)THREADS * ITEMS;
  constexpr int PER = CELLS / THREADS;  // cells a thread scans
  uint32_t lt_seen = 0, eq_seen = 0;    // over the rounds before
  for (int64_t round = 0; round < n && lt_seen + min(eq_seen, need) < (uint32_t)k;
       round += TILE * ROUND_TILES) {
    const int64_t left = (n - round + TILE - 1) / TILE;
    const int tiles = left < ROUND_TILES ? (int)left : ROUND_TILES;
    const int cells = tiles * WARPS;
    uint4 q[CHUNK<BITS>], next[CHUNK<BITS>];
    load_chunk<BITS>(x, round + (int64_t)t * ITEMS, n, vec, q);
    for (int j = 0; j < tiles; ++j) {
      const int64_t first = round + j * TILE + (int64_t)t * ITEMS;
      if (j + 1 < tiles) load_chunk<BITS>(x, first + TILE, n, vec, next);  // in flight
      const uint32_t c = warp_total(chunk_counts<BITS>(q, chunk_valid<BITS>(first, n), mask, prefix));
      if (lane == 0) cell_pos[j * WARPS + warp] = c;
#pragma unroll
      for (int u = 0; u < CHUNK<BITS>; ++u) q[u] = next[u];
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

  // ---- C: stable LSD radix sort of the k winners by key
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

  // ---- the sorted winners, their bits restored; indices into the row, or
  // through idx_in where the row holds candidates
  raw_t* values = reinterpret_cast<raw_t*>(values_) + (int64_t)blockIdx.x * k;
  int32_t* out_idx = indices + (int64_t)blockIdx.x * k;
  for (uint32_t i = t; i < m; i += THREADS) {
    values[i] = (raw_t)flip<BITS>(src_k[i]);
    const int64_t g = start + src_i[i];
    out_idx[i] = idx_in ? idx_in[row * row_len + g] : (int32_t)g;
  }
}

// ---- the short rows (rabitq_top_k_short)

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

}  // namespace

// x [rows, n] f32 (bf16 = 0) or bf16 (bf16 = 1), contiguous. Each row is cut
// into `segments` segments of `seg` entries (the last one takes the rest;
// every segment holds at least k), and block (row, s) writes segment s's top
// k: values [rows, segments, k] of x's type, indices [rows, segments, k]
// int32 into the row, or idx_in's entries where idx_in ([rows, n] int32) is
// given. Scratch keys [2, rows * segments, k] uint32 and scratch indices of
// the same shape int32. 1 <= k <= seg, n < 2^31.
extern "C" int rabitq_top_k(const void* x, void* values, void* indices, void* scratch_keys,
                            void* scratch_idx, const void* idx_in, long long rows, long long n,
                            long long seg, int segments, int k, int bf16, void* stream_) {
  cudaStream_t stream = (cudaStream_t)stream_;
  if (rows <= 0 || k <= 0) return 0;
  if (segments < 1 || seg < k || (segments - 1) * seg + k > n || n > 0x7FFFFFFFLL ||
      rows * segments > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)(rows * segments);
  if (bf16)
    top_k_select_kernel<16><<<blocks, THREADS, 0, stream>>>(
        x, values, (int32_t*)indices, (uint32_t*)scratch_keys, (int32_t*)scratch_idx,
        (const int32_t*)idx_in, n, seg, segments, k);
  else
    top_k_select_kernel<32><<<blocks, THREADS, 0, stream>>>(
        x, values, (int32_t*)indices, (uint32_t*)scratch_keys, (int32_t*)scratch_idx,
        (const int32_t*)idx_in, n, seg, segments, k);
  return (int)cudaGetLastError();
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
