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
// design is K1's (sweep.cuh): per block holding a selectable element, one
// CTA counts the digits of x's magnitude rank, radix-sorts the block in a
// global scratch (radix_sort.cuh) and walks the sorted indices applying
// each slot's cap; the other blocks get only the pool fill.

#include "sweep.cuh"

namespace {

// K2's row: x as given
struct XSource {
  static constexpr bool kAccumulates = false;
  using Keys = radix::KeysOf<false>;
  using In = float4;
  const float* x;

  __device__ float one(long long i) const { return __ldg(x + i); }
  __device__ In load4(long long i) const { return sweep::ld4(x + i); }
  __device__ float4 apply4(const In& in, long long) const { return in; }
  __device__ const float* row(long long base) const { return x + base; }
  __device__ float value(long long i) const { return __ldg(x + i); }
};

}  // namespace

extern "C" int segmented_topk(const float* x, const int* seg,
                              const int* kcap, const int* active_of_block,
                              int n_slots, float* cvals, int* cidx,
                              int* cseg, unsigned long long* a, unsigned* b,
                              long long n, int block, int n_blocks,
                              int n_cand, void* stream_ptr) {
  return (int)sweep::launch(XSource{x}, seg, kcap, active_of_block, n_slots,
                            cvals, cidx, cseg, a, b, n, block, n_blocks,
                            n_cand, sweep::aligned16({x, seg}),
                            (cudaStream_t)stream_ptr);
}
