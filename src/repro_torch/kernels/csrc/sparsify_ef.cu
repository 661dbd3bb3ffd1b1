// Fused error-feedback accumulate + exact segmented top-k candidates, for
// Hopper (sm_90a).  Built by repro_torch/kernels/build.py with nvcc into a
// shared library with a plain C interface; bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/sparsify_ef.py::sparsify_ef_topk
// (body _ef_topk_kernel, per-block extractors segmented_topk.select_candidates
// and bitonic.select_candidates_bitonic).  Same contract, same triples:
//
//   u' = m*u + g, v' = v + u'  (sparse_gd: u' = u, v' = v + g), rounded per
//   operation (no FMA contraction, so v' is bitwise the plain version's);
//   per block of `block` elements, up to n_cand (value, global index, slot)
//   triples: for every slot piece in the block its top-min(kcap, |piece|)
//   elements by |v'| (ties: lowest index first), all emitted in |v'|
//   descending / index ascending order; unused entries are
//   (0, base + block, -1).
//
// What bounds it on this card: device-memory bytes.  The work is one read of
// (g, u, v, seg), one write of (u', v') and a write of the candidate pool;
// the arithmetic is a few operations per element.  A TPU core keeps a whole
// 128Ki-element block in VMEM and sorts it there; one CTA's 227 KB of shared
// memory holds 28Ki 64-bit keys at most, so here the sort runs in a
// global-memory key scratch instead:
//
//   1. ef_keys_kernel: the accumulate, plus one 64-bit key per element of a
//      block that holds any selectable element ("active" block):
//      (0x7FFFFFFF - bits(|v'|)) << 17 | local index.  Ascending keys give
//      lax.top_k's order exactly; unselectable elements get ~0 and sort last.
//      Blocks with no selectable element (the exempt embedding) get no keys.
//   2. a bitonic sort of each active block's keys: 4096-key tiles sort and
//      merge in shared memory; merge distances >= 4096 are global passes.
//   3. cap_emit_kernel: one CTA per block walks its sorted keys, ranks each
//      element within its slot (warp match on the slot id, per-slot counters
//      in shared memory), keeps rank < kcap[slot] and compacts the kept
//      elements in sorted order into the pool, then fills the rest.
//
// The sort moves the key scratch ~20 times, so the kernel is several times
// its byte bound; fewer global passes (several merge distances per pass) and
// sorting only each slot's top candidates are the known next steps.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int LOC_BITS = 17;                 // block <= 131072 = 2^17
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

__global__ void ef_keys_kernel(const float* __restrict__ g,
                               const float* __restrict__ u,
                               const float* __restrict__ v,
                               const int* __restrict__ seg,
                               const int* __restrict__ active_of_block,
                               float* __restrict__ u_out,
                               float* __restrict__ v_out,
                               unsigned long long* __restrict__ keys,
                               long long n, int block, int block2,
                               long long total, float m, int use_momentum) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float vn = 0.f;
    int s = -1;
    if (i < n) {
      const float gi = g[i], ui = u[i], vi = v[i];
      float un;
      if (use_momentum) {
        un = __fadd_rn(__fmul_rn(m, ui), gi);
        vn = __fadd_rn(vi, un);
      } else {
        un = ui;
        vn = __fadd_rn(vi, gi);
      }
      u_out[i] = un;
      v_out[i] = vn;
      s = seg[i];
    }
    const long long b = i / block;
    const int loc = (int)(i - b * block);
    const int a = active_of_block[b];
    if (a >= 0) {
      unsigned long long key = MASKED;
      if (s >= 0) {
        const unsigned bits = __float_as_uint(vn) & 0x7FFFFFFFu;
        key = ((unsigned long long)(0x7FFFFFFFu - bits) << LOC_BITS) |
              (unsigned)loc;
      }
      keys[(long long)a * block2 + loc] = key;
    }
  }
}

// keys of the power-of-two padding [block, block2) of every active block
__global__ void pad_keys_kernel(unsigned long long* __restrict__ keys,
                                long long n_active, int block, int block2) {
  const long long pad = block2 - block;
  const long long total = n_active * pad;
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

__global__ void __launch_bounds__(EMIT_THREADS)
cap_emit_kernel(const unsigned long long* __restrict__ keys,
                const int* __restrict__ seg,
                const float* __restrict__ v_out,
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
      const long long gi = base + (int)(key & ((1u << LOC_BITS) - 1u));
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
        const int x = s_wsum[w];
        before += w < warp ? x : 0;
        total += x;
      }
      if (keep) {
        const int pos = out + before + __popc(bal & lt);
        if (pos < n_cand) {
          cvals[out_base + pos] = v_out[gi];
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

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

extern "C" int fused_ef_topk(const float* g, const float* u, const float* v,
                             const int* seg, const int* kcap,
                             const int* active_of_block, int n_slots,
                             float* u_out, float* v_out, float* cvals,
                             int* cidx, int* cseg, unsigned long long* keys,
                             long long n, int block, int n_blocks,
                             int n_active, int n_cand, float momentum,
                             int use_momentum, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int block2 = next_pow2(block);
  const long long total = (long long)n_blocks * block;
  cudaError_t err;
  ef_keys_kernel<<<grid_for(total, 256), 256, 0, st>>>(
      g, u, v, seg, active_of_block, u_out, v_out, keys, n, block, block2,
      total, momentum, use_momentum);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if (n_active > 0) {
    if (block2 > block) {
      pad_keys_kernel<<<grid_for((long long)n_active * (block2 - block), 256),
                        256, 0, st>>>(keys, n_active, block, block2);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
    const int tile = block2 < TILE ? block2 : TILE;
    const int n_tiles = (int)((long long)n_active * block2 / tile);
    const long long pairs = (long long)n_active * block2 / 2;
    bitonic_tile_kernel<<<n_tiles, SORT_THREADS, 0, st>>>(keys, block2, tile,
                                                          0);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    for (int kk = tile << 1; kk <= block2; kk <<= 1) {
      for (int j = kk >> 1; j >= tile; j >>= 1) {
        bitonic_global_step<<<grid_for(pairs, 256), 256, 0, st>>>(
            keys, pairs, block2, j, kk);
        if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
      }
      bitonic_tile_kernel<<<n_tiles, SORT_THREADS, 0, st>>>(keys, block2,
                                                            tile, kk);
      if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    }
  }
  cap_emit_kernel<<<n_blocks, EMIT_THREADS, n_slots * sizeof(int), st>>>(
      keys, seg, v_out, kcap, active_of_block, cvals, cidx, cseg, block,
      block2, n_cand, n_slots);
  return (int)cudaGetLastError();
}
