// The exact segmented top-k sweep of K1 (sparsify_ef.cu, with the error-
// feedback accumulate) and K2 (segmented_topk.cu, without it), for Hopper
// (sm_90a), on the per-block stable radix sort of radix_sort.cuh.  Included
// by each; every definition has internal linkage.
//
// The function: per block of `block` elements of a vector x (K1: v'), up to
// n_cand (value, global index, slot) triples: for every slot piece in the
// block its top-min(kcap[slot], |piece|) elements by |x|, all emitted in
// |x| descending / index ascending order (lax.top_k's, NaN and the other
// special values ordered by their bits); unused entries are
// (0, base + block, -1).  Elements with seg < 0 are not selectable.
//
// What bounds it: device-memory bytes.  A block of up to 2^17 elements does
// not fit a CTA's shared memory, so each block that holds a selectable
// element ("active") is sorted by one CTA in a global scratch, as the block
// top-k (K6) sorts its rows:
//   1. the histogram walk reads the row (K1: g, u, v, writing u' and v')
//      and seg once, and counts the four 8-bit digits of the magnitude rank
//      r = 0x7FFFFFFF - bits(|x|), each slot's piece size and the block's
//      slot range;
//   2. four stable 8-bit LSD passes on r with the block-local index riding
//      along, x (64-bit words) -> a -> b (32-bit) -> a (32-bit) -> b, the
//      last writing the indices alone.  Read in index order, a stable sort
//      on r leaves ties lowest index first: lax.top_k's order.  Elements
//      with seg < 0 are sorted too (no 31-bit key can sort after a zero,
//      whose r is already 0x7FFFFFFF) and skipped by the walk;
//   3. the cap walk reads the sorted indices in order, looks up each one's
//      slot, keeps it iff fewer than kcap[slot] words of its slot came
//      before it, and compacts the kept ones into the pool.  It stops once
//      the block's budget (the sum of min(piece, kcap) over its slots) is
//      spent.  A word's rank in its slot is warp_rank's, on the slot less
//      the block's lowest slot, when the block's slots span <= 256 ids; a
//      block with a wider span (many small pieces) is ranked by one warp
//      walking each tile in order.
// Blocks with no selectable element (e.g. the exempt embedding) need only
// the accumulate (K1) and the pool fill: a second kernel, eight CTAs of 256
// threads per block, streams them at full occupancy.
// About 52 bytes of scratch traffic move per active element, plus the
// reads and writes of the function itself.  The cap walk's two gathers
// (the slot of every word it reads, the value of every word it keeps) are
// most of its time; tools/kernel_variants.py times the parts.

#pragma once

#include <limits.h>

#include <initializer_list>

#include "radix_sort.cuh"

namespace {
namespace sweep {

using radix::BINS;
using radix::FULL;
using radix::ITEMS;
using radix::THREADS;
using radix::TILE;
using radix::WARP_SPAN;
using radix::WARPS;

constexpr int FILL_THREADS = 256;
constexpr int FILL_SLICES = 8;           // CTAs of the fill kernel a block

// dynamic shared memory: the sort's, the block's slot range and budget,
// then one int per slot (piece size in the walk, words taken in the cap
// walk)
struct Smem {
  radix::Smem r;
  int lo, hi, budget;
};

inline size_t smem_bytes(int n_slots) {
  return sizeof(Smem) + (size_t)n_slots * sizeof(int);
}

// the sorted row's indices: the last pass's output, the cap walk's input
struct Locs {
  using Raw = unsigned;
  static constexpr bool kWritten = true;
  unsigned* p;
  __device__ unsigned long long word(unsigned c, int) const { return c; }
  __device__ void operator()(int pos, unsigned long long w) const {
    __stcg(p + pos, (unsigned)w & radix::LOC_MASK);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

// The histogram walk's counts: the four digits of r of one element, and
// `c` elements of slot sl.
__device__ __forceinline__ void count_digits(float x, Smem& s) {
  const unsigned r = 0x7FFFFFFFu - (__float_as_uint(x) & 0x7FFFFFFFu);
#pragma unroll
  for (int p = 0; p < 4; ++p)
    atomicAdd(&s.r.offset[p][(r >> (radix::BITS * p)) & (BINS - 1)], 1);
}

__device__ __forceinline__ void count_slot(int sl, int c, int* count,
                                           int& lo, int& hi) {
  if (sl >= 0) {
    atomicAdd(&count[sl], c);
    lo = min(lo, sl);
    hi = max(hi, sl);
  }
}

__device__ __forceinline__ void count4(float4 x, int4 sl, Smem& s,
                                       int* count, int& lo, int& hi) {
  count_digits(x.x, s);
  count_digits(x.y, s);
  count_digits(x.z, s);
  count_digits(x.w, s);
  if (sl.x == sl.y && sl.x == sl.z && sl.x == sl.w) {   // one slot piece
    count_slot(sl.x, 4, count, lo, hi);
  } else {
    count_slot(sl.x, 1, count, lo, hi);
    count_slot(sl.y, 1, count, lo, hi);
    count_slot(sl.z, 1, count, lo, hi);
    count_slot(sl.w, 1, count, lo, hi);
  }
}

// 1. The histogram walk over the row [base, base + len): every element's
// x (src.load4/apply4 or src.one, which also write K1's u', v') counted.
// vec: every pointer 16-byte aligned (base is a multiple of 128).
template <class Src>
__device__ void histogram_walk(const Src& src, const int* __restrict__ seg,
                               long long base, int len, bool vec, Smem& s,
                               int* count) {
  const int tid = threadIdx.x;
  int lo = INT_MAX, hi = -1;
  int head = 0;
  if (vec) {
    // two float4 groups a thread in flight: one CTA holds the SM
    const int n4 = len >> 2;
    for (int c = tid; c < n4; c += 2 * THREADS) {
      const long long i0 = base + 4LL * c, i1 = i0 + 4LL * THREADS;
      const bool two = c + THREADS < n4;
      const auto in0 = src.load4(i0);
      const int4 s0 = __ldg(reinterpret_cast<const int4*>(seg + i0));
      auto in1 = in0;
      int4 s1 = s0;
      if (two) {
        in1 = src.load4(i1);
        s1 = __ldg(reinterpret_cast<const int4*>(seg + i1));
      }
      count4(src.apply4(in0, i0), s0, s, count, lo, hi);
      if (two) count4(src.apply4(in1, i1), s1, s, count, lo, hi);
    }
    head = n4 << 2;
  }
  for (int e = head + tid; e < len; e += THREADS) {
    count_digits(src.one(base + e), s);
    count_slot(__ldg(seg + base + e), 1, count, lo, hi);
  }
  lo = __reduce_min_sync(FULL, lo);
  hi = __reduce_max_sync(FULL, hi);
  if ((tid & 31) == 0) {
    atomicMin(&s.lo, lo);
    atomicMax(&s.hi, hi);
  }
}

// 3. The cap walk over the sorted indices locs[0, len) of the row at base;
// emits the kept triples into cv/ci/cs (this block's n_cand entries) and
// returns how many it found (it stops at min(budget, n_cand)).
// count[lo..hi] must be 0.
template <class Src>
__device__ int cap_walk(const Src& src, const int* __restrict__ seg,
                        const int* __restrict__ kcap, unsigned* locs,
                        long long base, int len, int lo, int hi, int budget,
                        float* cv, int* ci, int* cs, int n_cand, Smem& s,
                        int* count) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned below = (1u << lane) - 1u;
  const bool ranked = hi - lo < BINS;    // slot - lo is a digit
  unsigned* peer_bits = s.r.peers[warp];
  int* slot_of = reinterpret_cast<int*>(s.r.stage);   // unranked walk
  const auto* raw = reinterpret_cast<const unsigned*>(s.r.raw);
  const Locs in{locs};
  for (int i = tid; i < WARPS * BINS; i += THREADS)
    s.r.warp_count[i / BINS][i % BINS] = 0;
  const int stop = min(budget, n_cand);
  int out = 0;
  if (stop > 0) radix::fetch_tile(in, 0, len, s.r);
  for (int tile0 = 0; tile0 < len && out < stop; tile0 += TILE) {
    radix::wait_tile();
    const int first = tile0 + warp * WARP_SPAN + lane;
    int loc[ITEMS], sl[ITEMS];
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int i = first + 32 * j;
      loc[j] = i < len ? (int)raw[i - tile0] : 0;
      sl[j] = i < len ? __ldg(seg + base + loc[j]) : -1;
    }
    __syncthreads();
    if (tile0 + TILE < len) radix::fetch_tile(in, tile0 + TILE, len, s.r);
    unsigned keep = 0;                   // bit j: word j is kept
    if (ranked) {
      // the staged tile overwrote the peer masks: clear this warp's
#pragma unroll
      for (int d = lane; d < BINS; d += 32) peer_bits[d] = 0u;
      __syncwarp();
      unsigned rank2[ITEMS / 2];         // two 16-bit ranks a register
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const bool valid = sl[j] >= 0;
        // an unselectable word's rank (-1) must not spill into its twin's
        const unsigned rank = (unsigned)radix::warp_rank(
            valid ? sl[j] - lo : 0, valid, peer_bits, s.r.warp_count[warp]) &
            0xFFFFu;
        rank2[j / 2] = j % 2 ? rank2[j / 2] | rank << 16 : rank;
      }
      __syncthreads();
      // slot lo + tid: each warp's offset among the tile's words of the
      // slot, after the words the earlier tiles took
      if (tid < BINS) {
        int c = tid <= hi - lo ? count[lo + tid] : 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          const int t = s.r.warp_count[w][tid];
          s.r.warp_count[w][tid] = c;
          c += t;
        }
        if (tid <= hi - lo) count[lo + tid] = c;
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int rank = (rank2[j / 2] >> (16 * (j % 2))) & 0xFFFF;
        if (sl[j] >= 0 &&
            s.r.warp_count[warp][sl[j] - lo] + rank < __ldg(kcap + sl[j]))
          keep |= 1u << j;
      }
    } else {
      // one warp walks the tile in order, 32 words at a time
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        slot_of[warp * WARP_SPAN + 32 * j + lane] = sl[j];
      __syncthreads();
      if (warp == 0) {
        for (int p = lane; p < TILE; p += 32) {
          const int x = slot_of[p];
          const bool valid = x >= 0;
          const unsigned peers = __match_any_sync(FULL, x);
          const int c0 = valid ? count[x] : 0;
          const bool k = valid && c0 + __popc(peers & below) < __ldg(kcap + x);
          __syncwarp();
          if (valid && lane == 31 - __clz(peers))
            count[x] = c0 + __popc(peers);
          __syncwarp();
          slot_of[p] = k;
        }
      }
      __syncthreads();
#pragma unroll
      for (int j = 0; j < ITEMS; ++j)
        if (slot_of[warp * WARP_SPAN + 32 * j + lane]) keep |= 1u << j;
    }
    // compaction in sorted order: the warp's earlier words, then the
    // earlier warps'
    int at[ITEMS], run = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const unsigned bal = __ballot_sync(FULL, (keep >> j) & 1u);
      at[j] = run + __popc(bal & below);
      run += __popc(bal);
    }
    if (lane == 0) s.r.scan[warp] = run;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      const int y = s.r.scan[w];
      before += w < warp ? y : 0;
      total += y;
    }
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      const int pos = out + before + at[j];
      if (((keep >> j) & 1u) && pos < n_cand) {
        const long long gi = base + loc[j];
        cv[pos] = src.value(gi);
        ci[pos] = (int)gi;
        cs[pos] = sl[j];
      }
    }
    out += total;
    __syncthreads();
    for (int i = tid; i < WARPS * BINS; i += THREADS)
      s.r.warp_count[i / BINS][i % BINS] = 0;
  }
  asm volatile("cp.async.wait_all;\n" ::);   // a tile the walk left unread
  return out;
}

// One CTA of THREADS threads per active block (150 KB of shared memory and
// 4 B per slot: one CTA on each SM); inactive blocks return at once.
template <class Src>
__global__ void __launch_bounds__(THREADS, 1)
sweep_kernel(Src src, const int* __restrict__ seg,
             const int* __restrict__ kcap,
             const int* __restrict__ active_of_block, int n_slots,
             float* __restrict__ cvals, int* __restrict__ cidx,
             int* __restrict__ cseg, unsigned long long* a, unsigned* b,
             long long n, int block, int n_cand, int vec) {
  const int row = active_of_block[blockIdx.x];
  if (row < 0) return;
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  int* count = reinterpret_cast<int*>(smem + sizeof(Smem));
  const int tid = threadIdx.x;
  const long long base = (long long)blockIdx.x * block;
  const int len = (int)min((long long)block, n - base);
  for (int i = tid; i < 4 * BINS; i += THREADS)
    s.r.offset[i / BINS][i % BINS] = 0;
  for (int i = tid; i < n_slots; i += THREADS) count[i] = 0;
  if (tid == 0) {
    s.lo = INT_MAX;
    s.hi = -1;
    s.budget = 0;
  }
  __syncthreads();
  histogram_walk(src, seg, base, len, vec != 0, s, count);
  __syncthreads();
  radix::scan_offsets<4>(s.r);
  const int lo = s.lo, hi = s.hi;        // hi < lo: nothing selectable
  int part = 0;
  for (int sl = lo + tid; hi >= lo && sl <= hi; sl += THREADS)
    part += min(count[sl], __ldg(kcap + sl));
  part = __reduce_add_sync(FULL, part);
  if ((tid & 31) == 0 && part) atomicAdd(&s.budget, part);
  __syncthreads();
  const int budget = s.budget;
  for (int sl = lo + tid; hi >= lo && sl <= hi; sl += THREADS) count[sl] = 0;

  // 2. the four passes (each starts and ends with a __syncthreads())
  using radix::LOC_BITS;
  unsigned long long* ra = a + (long long)row * block;
  unsigned* rb = b + (long long)row * block;
  const typename Src::Keys keys{src.row(base)};
  const radix::Words64 wa{ra};
  const radix::Words32<2 * radix::BITS> wb{rb};
  const radix::Words32<3 * radix::BITS> wc{reinterpret_cast<unsigned*>(ra)};
  const Locs locs{rb};
  radix::row_pass<LOC_BITS>(keys, wa, len, 0, s.r);
  radix::row_pass<LOC_BITS>(wa, wb, len, 1, s.r);
  radix::row_pass<LOC_BITS>(wb, wc, len, 2, s.r);
  radix::row_pass<LOC_BITS>(wc, locs, len, 3, s.r);

  // 3. the cap walk, then the fill
  const long long o = (long long)blockIdx.x * n_cand;
  const int out = cap_walk(src, seg, kcap, rb, base, len, lo, hi, budget,
                           cvals + o, cidx + o, cseg + o, n_cand, s, count);
  for (int p = out + tid; p < n_cand; p += THREADS) {
    cvals[o + p] = 0.f;
    cidx[o + p] = (int)(base + block);
    cseg[o + p] = -1;
  }
}

// The blocks with no selectable element: K1's accumulate and the fill,
// FILL_SLICES CTAs a block.
template <class Src>
__global__ void __launch_bounds__(FILL_THREADS)
inactive_kernel(Src src, const int* __restrict__ active_of_block,
                float* __restrict__ cvals, int* __restrict__ cidx,
                int* __restrict__ cseg, long long n, int block, int n_cand,
                int vec) {
  const int bk = blockIdx.x / FILL_SLICES;
  if (active_of_block[bk] >= 0) return;
  const int tid = blockIdx.x % FILL_SLICES * FILL_THREADS + threadIdx.x;
  constexpr int STRIDE = FILL_SLICES * FILL_THREADS;
  const long long base = (long long)bk * block;
  if constexpr (Src::kAccumulates) {
    const int len = (int)min((long long)block, n - base);
    int head = 0;
    if (vec) {
      for (int c = tid; c < len >> 2; c += STRIDE) {
        const long long i = base + 4LL * c;
        src.apply4(src.load4(i), i);
      }
      head = len & ~3;
    }
    for (int e = head + tid; e < len; e += STRIDE) src.one(base + e);
  }
  const long long o = (long long)bk * n_cand;
  for (int p = tid; p < n_cand; p += STRIDE) {
    cvals[o + p] = 0.f;
    cidx[o + p] = (int)(base + block);
    cseg[o + p] = -1;
  }
}

__host__ inline bool aligned16(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if ((unsigned long long)p & 15) return false;
  return true;
}

// Launches both kernels on st; returns the first launch error.
template <class Src>
cudaError_t launch(const Src& src, const int* seg, const int* kcap,
                   const int* active_of_block, int n_slots, float* cvals,
                   int* cidx, int* cseg, unsigned long long* a, unsigned* b,
                   long long n, int block, int n_blocks, int n_cand,
                   bool vec, cudaStream_t st) {
  const size_t bytes = smem_bytes(n_slots);
  cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)bytes);
  if (err != cudaSuccess) return err;
  sweep_kernel<Src><<<n_blocks, THREADS, bytes, st>>>(
      src, seg, kcap, active_of_block, n_slots, cvals, cidx, cseg, a, b, n,
      block, n_cand, vec);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  inactive_kernel<Src><<<n_blocks * FILL_SLICES, FILL_THREADS, 0, st>>>(
      src, active_of_block, cvals, cidx, cseg, n, block, n_cand, vec);
  return cudaGetLastError();
}

}  // namespace sweep
}  // namespace
