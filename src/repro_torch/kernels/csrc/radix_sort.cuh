// Stable LSD radix sort of one row per CTA, for Hopper (sm_90a): the
// machinery of the block top-k (block_topk.cu, K6) and of the segmented
// sweeps (sweep.cuh: K1 and K2).  Included by each user; every definition
// has internal linkage, so each library carries its own copy.
//
// A row holds n <= 2^17 64-bit words.  The sort key is the 31 bits of a
// word from bit KEY_LO up; the bits below it (the caller's payload, e.g.
// the element's index) ride along.  Each pass sorts on one 8-bit digit of
// the key, least significant first (passes 0..3: key bits 0-7, 8-15,
// 16-23, 24-30), and is stable, so a row whose words arrive in index order
// leaves sorted by (key, index).
//
// One CTA of THREADS threads owns the row and walks it in tiles of TILE
// words, in index order, so no pass needs another CTA's counts:
//   row_histograms  reads the row once and counts every pass's digits in
//                   shared memory (atomics), then turns the counts into
//                   each digit's first position in the row.
//   row_pass        per tile: loads ITEMS words a thread (a warp owns 32 x
//                   ITEMS consecutive words, lane-striped so the loads
//                   coalesce), ranks each word among the warp's words of
//                   its digit in index order (per warp, a mask of the
//                   digit's lanes built with atomicOr, and digit counters),
//                   adds the earlier warps' counts of that digit, places
//                   the tile in digit order in shared memory and writes it
//                   out from there, so each digit's run leaves as one
//                   contiguous store at the digit's running position.
//                   The ranking (warp_rank) serves any 8-bit label: the
//                   sweeps' cap walk ranks words by slot with it.
// The scattered runs are what a pass costs beyond its reads: a tile of 8192
// words makes them ~32 words long (runs half as long measured up to a
// quarter slower).
// A CTA has the SM to itself, so nothing hides a tile's load latency but
// the CTA: the next tile's raw words are copied into shared memory with
// cp.async while the current one is ranked and written.
// Load and Store are functors, so the first pass can read the caller's
// data, the last write the caller's outputs, and the words in between live
// in any format the caller packs.  A Load names its raw element (Raw), its
// row (p) and how a raw element at index i becomes a word (word(raw, i));
// kWritten marks a row this kernel writes, which is copied in 16-byte
// chunks through L2 alone (cp.async.cg: the SM's L1 may hold older copies
// of those addresses), the caller's input element by element.
//
// Between passes the row is in the caller's global scratch.  A pass reads
// what the same CTA wrote in the one before, after a __syncthreads().

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {
namespace radix {

constexpr int BITS = 8;
constexpr int BINS = 1 << BITS;          // 256 digits
constexpr int THREADS = 2 * BINS;        // threads < BINS: one digit each
constexpr int WARPS = THREADS / 32;
static_assert(THREADS >= BINS, "a thread per digit in the scans");
constexpr int ITEMS = 16;                // words per thread per tile
constexpr int TILE = THREADS * ITEMS;    // 8192 words: digit runs ~32 long
constexpr int WARP_SPAN = 32 * ITEMS;
constexpr int MAX_PASSES = 4;            // 31 key bits in 8-bit digits
constexpr unsigned FULL = 0xffffffffu;

// 150 KB: dynamic shared memory, above the 48 KB a launch gets by default
struct Smem {
  union {
    unsigned long long stage[TILE];      // one tile in digit order
    unsigned peers[WARPS][BINS];         // ranking: lanes holding digit d
  };
  unsigned long long raw[TILE];          // the next tile, as loaded
  int warp_count[WARPS][BINS];           // per warp: count, then offset
  int offset[MAX_PASSES][BINS];          // per pass: digit's first position
  int tile_start[BINS];                  // digit's first slot in stage
  int tile_dst[BINS];                    // stage slot -> row position
  int scan[WARPS];
};

template <int KEY_LO>
__device__ __forceinline__ int digit(unsigned long long word, int pass) {
  return (int)(word >> (KEY_LO + BITS * pass)) & (BINS - 1);
}

// Start copying the raw elements [tile0, tile0 + TILE) of load's row (up
// to n) into s.raw; wait for them with cp.async.wait_all.
template <class Load>
__device__ __forceinline__ void fetch_tile(const Load& load, int tile0,
                                           int n, Smem& s) {
  using Raw = typename Load::Raw;
  const int m = n - tile0 < TILE ? n - tile0 : TILE;
  Raw* dst = reinterpret_cast<Raw*>(s.raw);
  const Raw* src = load.p + tile0;
  if constexpr (Load::kWritten) {
    constexpr int V = 16 / sizeof(Raw);
    for (int c = threadIdx.x; c * V < m; c += THREADS) {
      const int bytes = (m - c * V < V ? m - c * V : V) * sizeof(Raw);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + c * V)),
                   "l"(src + c * V), "r"(bytes));
    }
  } else {
    for (int e = threadIdx.x; e < m; e += THREADS)
      asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(
                       (unsigned)__cvta_generic_to_shared(dst + e)),
                   "l"(src + e), "n"(sizeof(Raw)));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void wait_tile() {
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
}

// Exclusive prefix sum of one int per thread over the CTA (THREADS threads).
// Digit d's thread is thread d; the threads past BINS add 0.
__device__ __forceinline__ int exclusive_scan(int v, int* scan) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int t = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += t;
  }
  if (lane == 31) scan[warp] = inc;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w)
    if (w < warp) before += scan[w];
  __syncthreads();
  return before + inc - v;
}

// Turns s.offset[p][d], the count of digit d in pass p for p < PASSES,
// into the digit's first position in the sorted row.  Needs the counts
// complete (a __syncthreads() after the last count); ends with one.
template <int PASSES>
__device__ void scan_offsets(Smem& s) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int ex = exclusive_scan(tid < BINS ? s.offset[p][tid] : 0, s.scan);
    if (tid < BINS) s.offset[p][tid] = ex;
  }
  __syncthreads();
}

// The rank of this lane's word among the warp's valid words of digit d:
// counts[d] (the warp's count of d so far, which this advances by the
// warp's valid words of d) plus the words of d on lower lanes.  The whole
// warp calls it; peer_bits are the warp's BINS masks, all 0 between calls.
__device__ __forceinline__ int warp_rank(int d, bool valid,
                                         unsigned* peer_bits, int* counts) {
  const int lane = threadIdx.x & 31;
  const unsigned lanes_upto = FULL >> (31 - lane);
  // the lanes of this word's digit: each sets its bit in the digit's
  // mask (shared-memory atomics; a warp vote per digit bit, or
  // __match_any_sync, is slower on this card)
  if (valid) atomicOr(&peer_bits[d], 1u << lane);
  __syncwarp();
  const unsigned peers =
      valid ? *static_cast<volatile unsigned*>(&peer_bits[d]) : 0u;
  const int upto = __popc(peers & lanes_upto);
  // the highest peer counts them all, hands out the warp's count so far
  // and clears the mask
  const int leader = 31 - __clz(peers);
  int before = 0;
  if (valid && lane == leader) before = atomicAdd(&counts[d], upto);
  before = __shfl_sync(FULL, before, valid ? leader : lane);
  if (valid && lane == leader) peer_bits[d] = 0u;
  __syncwarp();
  return before + upto - 1;
}

// s.offset[p][d] = the position in the sorted row of the first word whose
// digit p is d, for p < PASSES.  Ends with a __syncthreads().
template <int KEY_LO, int PASSES, class Load>
__device__ void row_histograms(const Load& load, int n, Smem& s) {
  static_assert(PASSES <= MAX_PASSES, "at most 4 passes of 8 bits");
  const int tid = threadIdx.x;
  const auto* raw = reinterpret_cast<const typename Load::Raw*>(s.raw);
  for (int i = tid; i < PASSES * BINS; i += THREADS)
    s.offset[i / BINS][i % BINS] = 0;
  fetch_tile(load, 0, n, s);
  for (int tile0 = 0; tile0 < n; tile0 += TILE) {
    wait_tile();
    unsigned long long word[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = tile0 + j * THREADS + tid;
      word[j] = i < n ? load.word(raw[i - tile0], i) : 0ULL;
    }
    __syncthreads();
    if (tile0 + TILE < n) fetch_tile(load, tile0 + TILE, n, s);
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (tile0 + j * THREADS + tid < n) {
#pragma unroll
        for (int p = 0; p < PASSES; ++p)
          atomicAdd(&s.offset[p][digit<KEY_LO>(word[j], p)], 1);
      }
    }
  }
  __syncthreads();
  scan_offsets<PASSES>(s);
}

// One stable pass on digit `pass`: store(position, word) for every word
// load(i), i < n.  Needs row_histograms' offsets.  Ends with a
// __syncthreads().
template <int KEY_LO, class Load, class Store>
__device__ void row_pass(const Load& load, const Store& store, int n,
                         int pass, Smem& s) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool owner = tid < BINS;         // owns digit tid
  int run = owner ? s.offset[pass][tid] : 0;   // its next row position
  unsigned* peer_bits = s.peers[warp];   // this warp's; all 0 between words
  const auto* raw = reinterpret_cast<const typename Load::Raw*>(s.raw);
  for (int i = tid; i < WARPS * BINS; i += THREADS)
    s.warp_count[i / BINS][i % BINS] = 0;
  fetch_tile(load, 0, n, s);
  for (int tile0 = 0; tile0 < n; tile0 += TILE) {
    wait_tile();
    const int first = tile0 + warp * WARP_SPAN + lane;
    unsigned long long word[ITEMS];
    unsigned rank2[ITEMS / 2];           // two 16-bit ranks a register
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = first + 32 * j;
      word[j] = i < n ? load.word(raw[i - tile0], i) : 0ULL;
    }
    __syncthreads();
    if (tile0 + TILE < n) fetch_tile(load, tile0 + TILE, n, s);
    // the staged tile overwrote the peer masks: clear this warp's
#pragma unroll
    for (int d = lane; d < BINS; d += 32) peer_bits[d] = 0u;
    __syncwarp();
    // rank among the warp's words of the same digit, in index order
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const bool valid = first + 32 * j < n;
      const int d = digit<KEY_LO>(word[j], pass);
      const unsigned rank = (unsigned)warp_rank(d, valid, peer_bits,
                                                s.warp_count[warp]);
      rank2[j / 2] = j % 2 ? rank2[j / 2] | rank << 16 : rank;
    }
    __syncthreads();
    // digit tid: each warp's offset among the tile's words of that digit,
    // the digit's first slot in the staged tile and its row position
    int count = 0;
    if (owner) {
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const int c = s.warp_count[w][tid];
        s.warp_count[w][tid] = count;
        count += c;
      }
    }
    const int start = exclusive_scan(count, s.scan);
    if (owner) {
      s.tile_start[tid] = start;
      s.tile_dst[tid] = run - start;
      run += count;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (first + 32 * j < n) {
        const int d = digit<KEY_LO>(word[j], pass);
        const int rank = (rank2[j / 2] >> (16 * (j % 2))) & 0xFFFF;
        s.stage[s.tile_start[d] + s.warp_count[warp][d] + rank] = word[j];
      }
    }
    __syncthreads();
    for (int i = tid; i < WARPS * BINS; i += THREADS)
      s.warp_count[i / BINS][i % BINS] = 0;
    const int m = n - tile0 < TILE ? n - tile0 : TILE;
    for (int k = tid; k < m; k += THREADS) {
      const unsigned long long w = s.stage[k];
      store(s.tile_dst[digit<KEY_LO>(w, pass)] + k, w);
    }
    __syncthreads();
  }
}

// The word formats of the per-block sorts (block_topk.cu, sweep.cuh).  A
// row holds <= 2^17 elements; the key is the magnitude rank
// r = 0x7FFFFFFF - bits(|x|) (31 bits, the sign bit cleared on the bits, so
// a NaN ranks by its payload, above inf), the element's row index below it.
constexpr int LOC_BITS = 17;                 // rows <= 131072 = 2^17
constexpr unsigned LOC_MASK = (1u << LOC_BITS) - 1u;

// the first pass's words, from a row of floats: r over the index.
// WRITTEN: the row is this kernel's own output (fetched through L2).
template <bool WRITTEN>
struct KeysOf {
  using Raw = float;
  static constexpr bool kWritten = WRITTEN;
  const float* p;
  __device__ unsigned long long word(float x, int i) const {
    const unsigned bits = __float_as_uint(x) & 0x7FFFFFFFu;
    return ((unsigned long long)(0x7FFFFFFFu - bits) << LOC_BITS) |
           (unsigned)i;
  }
};

struct Words64 {
  using Raw = unsigned long long;
  static constexpr bool kWritten = true;
  unsigned long long* p;
  __device__ unsigned long long word(unsigned long long w, int) const {
    return w;
  }
  __device__ void operator()(int pos, unsigned long long w) const {
    __stcg(p + pos, w);
  }
};

// r from bit R0 up over the index: all the passes after the one that
// sorted r's bits below R0 read
template <int R0>
struct Words32 {
  static_assert(31 - R0 + LOC_BITS <= 32, "does not fit 32 bits");
  static constexpr int SHIFT = LOC_BITS + R0;
  using Raw = unsigned;
  static constexpr bool kWritten = true;
  unsigned* p;
  __device__ unsigned long long word(unsigned c, int) const {
    return ((unsigned long long)(c >> LOC_BITS) << SHIFT) | (c & LOC_MASK);
  }
  __device__ void operator()(int pos, unsigned long long w) const {
    __stcg(p + pos,
           (unsigned)(w >> SHIFT) << LOC_BITS | ((unsigned)w & LOC_MASK));
  }
};

}  // namespace radix
}  // namespace
