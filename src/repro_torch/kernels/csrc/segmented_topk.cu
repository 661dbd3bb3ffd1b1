// Exact segmented top-k candidates of a flat vector, for Hopper (sm_90a).
// Built by repro_torch/kernels/build.py with nvcc into a shared library with
// a plain C interface; bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/segmented_topk.py::
// segmented_topk (per-block extractors segmented_topk.select_candidates and
// bitonic.select_candidates_bitonic, which the reference proves
// bit-identical): the fused sweep of sparsify_ef.cu without the error-feedback
// accumulate.  Per block of `block` elements of x, up to n_cand (value,
// global index, slot) triples: for every slot piece in the block its
// top-min(kcap, |piece|) elements by |x| (ties: lowest index first), all
// emitted in |x| descending / index ascending order; unused entries are
// (0, base + block, -1).  The ragged last block is masked here, so x and
// seg are (n,) and need no padding.
//
// What bounds it on this card: device-memory bytes (one read of x and seg,
// one write of the candidate pool; a few operations per element).  The
// design is K1's (topk_sort.cuh): seg_keys_kernel writes one 64-bit key per
// element of each block holding a selectable element, a bitonic sort per
// block in a global key scratch, then the per-slot cap and emit pass.  As in
// K1, the sort's ~20 passes over the scratch are what it costs.

#include "topk_sort.cuh"

namespace {

__global__ void seg_keys_kernel(const float* __restrict__ x,
                                const int* __restrict__ seg,
                                const int* __restrict__ active_of_block,
                                unsigned long long* __restrict__ keys,
                                long long n, int block, int block2,
                                long long total) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long b = i / block;
    const int a = active_of_block[b];
    if (a < 0) continue;
    const int loc = (int)(i - b * block);
    const int s = i < n ? seg[i] : -1;
    keys[(long long)a * block2 + loc] =
        s >= 0 ? magnitude_key(x[i], loc) : MASKED;
  }
}

}  // namespace

extern "C" int segmented_topk(const float* x, const int* seg,
                              const int* kcap, const int* active_of_block,
                              int n_slots, float* cvals, int* cidx,
                              int* cseg, unsigned long long* keys,
                              long long n, int block, int n_blocks,
                              int n_active, int n_cand, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const long long total = (long long)n_blocks * block;
  if (n_active > 0) {
    seg_keys_kernel<<<grid_for(total, 256), 256, 0, st>>>(
        x, seg, active_of_block, keys, n, block, next_pow2(block), total);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)sort_and_emit(keys, seg, x, kcap, active_of_block, n_slots,
                            cvals, cidx, cseg, block, n_blocks, n_active,
                            n_cand, st);
}
