// Per-block exact top-k by |x| on Hopper (sm_90a): the machinery that the
// fused sweep (sparsify_ef.cu) and the segmented sweep (segmented_topk.cu)
// share.  Included by each of them; every definition has internal linkage,
// so each library carries its own copy.
//
// One 64-bit key per element of a block,
//   (0x7FFFFFFF - bits(|x|)) << 17 | local index,
// sorts ascending in exactly lax.top_k's order (|x| descending, lowest index
// first).  An element that may not be selected gets MASKED (~0), which sorts
// after every real key; so do the keys that pad a block to a power of two.
// A TPU core sorts a 128Ki-element block in VMEM; 1 MiB of keys does not fit
// a CTA's 227 KB of shared memory, so the keys live in a global-memory
// scratch: a bitonic sort per block, 4096-key shared-memory tiles for the
// short merge distances and one global pass per long one.  The sort moves
// the scratch ~20 times; that, not arithmetic, bounds these kernels.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOC_BITS = 17;                 // block <= 131072 = 2^17
constexpr unsigned LOC_MASK = (1u << LOC_BITS) - 1u;
constexpr unsigned long long MASKED = ~0ULL;
constexpr int TILE = 4096;                   // keys per shared-memory tile
constexpr int SORT_THREADS = 1024;
constexpr int EMIT_THREADS = 256;

int grid_for(long long work, int threads) {
  long long g = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

__device__ __forceinline__ unsigned long long magnitude_key(float x,
                                                            int loc) {
  const unsigned bits = __float_as_uint(x) & 0x7FFFFFFFu;
  return ((unsigned long long)(0x7FFFFFFFu - bits) << LOC_BITS) |
         (unsigned)loc;
}

// keys of the power-of-two padding [block, block2) of every sorted block
__global__ void pad_keys_kernel(unsigned long long* __restrict__ keys,
                                long long n_rows, int block, int block2) {
  const long long pad = block2 - block;
  const long long total = n_rows * pad;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long a = i / pad;
    keys[a * block2 + block + (i - a * pad)] = MASKED;
  }
}

__device__ __forceinline__ void tile_stage(unsigned long long* s, int half,
                                           int j, int kk, int off) {
  for (int p = threadIdx.x; p < half; p += blockDim.x) {
    const int i = ((p & ~(j - 1)) << 1) | (p & (j - 1));
    const int l = i + j;
    const bool asc = ((off + i) & kk) == 0;
    const unsigned long long a = s[i], b = s[l];
    if (asc ? a > b : a < b) {
      s[i] = b;
      s[l] = a;
    }
  }
}

// kk_merge == 0: sort each tile completely (merge sizes 2..tile).
// kk_merge > 0:  the shared-memory tail (distances tile/2..1) of merge kk.
// Directions follow the position inside the block's power-of-two segment,
// so tiles and global passes compose into one bitonic sort per block.
__global__ void __launch_bounds__(SORT_THREADS)
bitonic_tile_kernel(unsigned long long* __restrict__ keys, int block2,
                    int tile, int kk_merge) {
  __shared__ unsigned long long s[TILE];
  const long long base = (long long)blockIdx.x * tile;
  const int off = (int)(base % block2);
  for (int t = threadIdx.x; t < tile; t += blockDim.x) s[t] = keys[base + t];
  __syncthreads();
  const int half = tile >> 1;
  if (kk_merge == 0) {
    for (int kk = 2; kk <= tile; kk <<= 1)
      for (int j = kk >> 1; j > 0; j >>= 1) {
        tile_stage(s, half, j, kk, off);
        __syncthreads();
      }
  } else {
    for (int j = half; j > 0; j >>= 1) {
      tile_stage(s, half, j, kk_merge, off);
      __syncthreads();
    }
  }
  for (int t = threadIdx.x; t < tile; t += blockDim.x) keys[base + t] = s[t];
}

__global__ void bitonic_global_step(unsigned long long* __restrict__ keys,
                                    long long pairs, int block2, int j,
                                    int kk) {
  const long long jm = (long long)j - 1;
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < pairs; p += (long long)gridDim.x * blockDim.x) {
    const long long i = ((p & ~jm) << 1) | (p & jm);
    const long long l = i + j;
    const bool asc = ((int)(i & (block2 - 1)) & kk) == 0;
    const unsigned long long a = keys[i], b = keys[l];
    if (asc ? a > b : a < b) {
      keys[i] = b;
      keys[l] = a;
    }
  }
}

// Sort each of the n_rows rows of keys (row stride block2 =
// next_pow2(block)) ascending; [block, block2) of each row is set to MASKED
// first.  Launches only: returns the first launch error.
cudaError_t sort_rows(unsigned long long* keys, long long n_rows, int block,
                      int block2, cudaStream_t st) {
  cudaError_t err;
  if (n_rows <= 0) return cudaSuccess;
  if (block2 > block) {
    pad_keys_kernel<<<grid_for(n_rows * (block2 - block), 256), 256, 0,
                      st>>>(keys, n_rows, block, block2);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int tile = block2 < TILE ? block2 : TILE;
  const long long n_tiles = n_rows * block2 / tile;
  const long long pairs = n_rows * block2 / 2;
  bitonic_tile_kernel<<<(unsigned)n_tiles, SORT_THREADS, 0, st>>>(
      keys, block2, tile, 0);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  for (int kk = tile << 1; kk <= block2; kk <<= 1) {
    for (int j = kk >> 1; j >= tile; j >>= 1) {
      bitonic_global_step<<<grid_for(pairs, 256), 256, 0, st>>>(
          keys, pairs, block2, j, kk);
      if ((err = cudaGetLastError()) != cudaSuccess) return err;
    }
    bitonic_tile_kernel<<<(unsigned)n_tiles, SORT_THREADS, 0, st>>>(
        keys, block2, tile, kk);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// The per-slot cap and emit of the segmented sweeps.  One CTA per block
// walks its sorted keys, ranks each element within its slot (warp match on
// the slot id, per-slot counters in shared memory), keeps rank <
// kcap[slot] and compacts the kept elements in sorted order into the pool
// as (x[gi], gi, slot); then fills the rest with (0, base + block, -1).
// Blocks with active_of_block[b] < 0 have no keys and emit only the fill.
__global__ void __launch_bounds__(EMIT_THREADS)
cap_emit_kernel(const unsigned long long* __restrict__ keys,
                const int* __restrict__ seg,
                const float* __restrict__ x,
                const int* __restrict__ kcap,
                const int* __restrict__ active_of_block,
                float* __restrict__ cvals, int* __restrict__ cidx,
                int* __restrict__ cseg, int block, int block2, int n_cand,
                int n_slots) {
  extern __shared__ int counts[];            // per-slot kept so far
  __shared__ int s_slot[EMIT_THREADS];
  __shared__ unsigned char s_keep[EMIT_THREADS];
  __shared__ int s_wsum[EMIT_THREADS / 32];
  const int b = blockIdx.x;
  const int a = active_of_block[b];
  const long long base = (long long)b * block;
  const long long out_base = (long long)b * n_cand;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const unsigned lt = (1u << lane) - 1u;
  int out = 0;
  if (a >= 0) {
    for (int s = threadIdx.x; s < n_slots; s += blockDim.x) counts[s] = 0;
    __syncthreads();
    const unsigned long long* kb = keys + (long long)a * block2;
    for (int c = 0; c < block2; c += EMIT_THREADS) {
      const unsigned long long key = kb[c + threadIdx.x];
      const bool valid = key != MASKED;
      const long long gi = base + (int)(key & LOC_MASK);
      const int s = valid ? seg[gi] : -1;
      s_slot[threadIdx.x] = s;
      if (!__syncthreads_or(valid)) break;    // the rest is unselectable
      if (warp == 0) {
        // rank within slot, in sorted order: one warp walks the chunk
        for (int w = 0; w < EMIT_THREADS / 32; ++w) {
          const int sl = s_slot[w * 32 + lane];
          const unsigned peers = __match_any_sync(0xffffffffu, sl);
          const int c0 = sl >= 0 ? counts[sl] : 0;
          const bool keep = sl >= 0 && c0 + __popc(peers & lt) < kcap[sl];
          __syncwarp();
          if (sl >= 0 && lane == __ffs(peers) - 1)
            counts[sl] = c0 + __popc(peers);
          __syncwarp();
          s_keep[w * 32 + lane] = keep;
        }
      }
      __syncthreads();
      const bool keep = s_keep[threadIdx.x];
      const unsigned bal = __ballot_sync(0xffffffffu, keep);
      if (lane == 0) s_wsum[warp] = __popc(bal);
      __syncthreads();
      int before = 0, total = 0;
      for (int w = 0; w < EMIT_THREADS / 32; ++w) {
        const int y = s_wsum[w];
        before += w < warp ? y : 0;
        total += y;
      }
      if (keep) {
        const int pos = out + before + __popc(bal & lt);
        if (pos < n_cand) {
          cvals[out_base + pos] = x[gi];
          cidx[out_base + pos] = (int)gi;
          cseg[out_base + pos] = s;
        }
      }
      out += total;
      __syncthreads();
    }
  }
  for (int p = out + threadIdx.x; p < n_cand; p += blockDim.x) {
    cvals[out_base + p] = 0.f;
    cidx[out_base + p] = (int)(base + block);
    cseg[out_base + p] = -1;
  }
}

// The segmented sweeps' tail: sort the active blocks' keys, then the cap
// and emit pass over all n_blocks blocks.
cudaError_t sort_and_emit(unsigned long long* keys, const int* seg,
                          const float* x, const int* kcap,
                          const int* active_of_block, int n_slots,
                          float* cvals, int* cidx, int* cseg, int block,
                          int n_blocks, int n_active, int n_cand,
                          cudaStream_t st) {
  const int block2 = next_pow2(block);
  cudaError_t err = sort_rows(keys, n_active, block, block2, st);
  if (err != cudaSuccess) return err;
  cap_emit_kernel<<<n_blocks, EMIT_THREADS, n_slots * sizeof(int), st>>>(
      keys, seg, x, kcap, active_of_block, cvals, cidx, cseg, block, block2,
      n_cand, n_slots);
  return cudaGetLastError();
}

}  // namespace
