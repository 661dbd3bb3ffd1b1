// Per-block exact top-k by |x|, for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/block_topk.py::block_topk.  Same
// contract: x is (n_blocks, block); per block, the kb elements of largest
// |x|, emitted |x| descending, lowest index first on ties, as (value,
// block-local index).  Zeros (the caller's zero padding included) take part
// like any other value.
//
// The TPU kernel runs kb rounds of (max, record, mask) over a block held in
// VMEM.  On the path that calls it (ops.global_topk at the per-leaf block
// max(8192, roundup128(k))), kb is nearly the whole block -- 67109 of 67200
// at llama3.2-1b's MLP leaves -- so here it is a sort, not a selection:
// block_keys_kernel writes one 64-bit key per element, the blocks are
// bitonic-sorted in a global key scratch padded to the next power of two
// (topk_sort.cuh, shared with the fused sweep), and block_emit_kernel reads
// the first kb keys of each block back into (x[loc], loc).
//
// What bounds it on this card: device-memory bytes (one read of x, one
// write of kb values and indices per block).  The sort's ~20 passes over
// the key scratch -- twice the block where the block is just above a power
// of two -- are what it costs.

#include "topk_sort.cuh"

namespace {

__global__ void block_keys_kernel(const float* __restrict__ x,
                                  unsigned long long* __restrict__ keys,
                                  long long total, int block, int block2) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / block;
    const int loc = (int)(i - b * block);
    keys[b * block2 + loc] = magnitude_key(x[i], loc);
  }
}

__global__ void block_emit_kernel(const unsigned long long* __restrict__ keys,
                                  const float* __restrict__ x,
                                  float* __restrict__ vals,
                                  int* __restrict__ idx, long long total,
                                  int block, int block2, int kb) {
  for (long long p = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       p < total; p += (long long)gridDim.x * blockDim.x) {
    const long long b = p / kb;
    const int loc = (int)(keys[b * block2 + (p - b * kb)] & LOC_MASK);
    vals[p] = x[b * block + loc];
    idx[p] = loc;
  }
}

}  // namespace

extern "C" int block_topk(const float* x, float* vals, int* idx,
                          unsigned long long* keys, int n_blocks, int block,
                          int kb, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int block2 = next_pow2(block);
  const long long total = (long long)n_blocks * block;
  block_keys_kernel<<<grid_for(total, 256), 256, 0, st>>>(x, keys, total,
                                                         block, block2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sort_rows(keys, n_blocks, block, block2, st);
  if (err != cudaSuccess) return (int)err;
  const long long out = (long long)n_blocks * kb;
  block_emit_kernel<<<grid_for(out, 256), 256, 0, st>>>(
      keys, x, vals, idx, out, block, block2, kb);
  return (int)cudaGetLastError();
}
