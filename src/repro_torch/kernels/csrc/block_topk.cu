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
// at llama3.2-1b's MLP leaves -- so here it is a sort, not a selection.
//
// What bounds it on this card: device-memory bytes.  The least it must move
// is one read of x and one write of kb values and indices per block; a
// block of up to 2^17 elements does not fit a CTA's shared memory, so a
// sort keeps the block in a global scratch between passes, and the passes
// over that scratch are what it costs.  The design keeps them few and
// unpadded: one CTA sorts one block with a stable LSD radix sort
// (radix_sort.cuh) on the 31-bit magnitude rank r = 0x7FFFFFFF - bits(|x|),
// the block-local index riding along in the word r << 17 | index.  Read in
// index order, a stable sort on r alone leaves ties lowest index first,
// which is lax.top_k's order (NaN, +-inf, +-0 and subnormals ordered by
// their bits).  One histogram read of x, then four 8-bit passes:
//   x -> a (64-bit words) -> b (32-bit) -> a (32-bit) -> vals/idx
// where a pass's output keeps only the digits still to sort (after the
// second pass r's top 15 bits and the 17-bit index fit in 32 bits), and
// the last pass writes only positions < kb, with the value gathered from
// x.  About 52 bytes move per element, against ~20 passes over a scratch
// padded to the next power of two in the bitonic sort it replaces.

#include "radix_sort.cuh"

namespace {

using radix::LOC_BITS;
using radix::LOC_MASK;
using radix::Words32;
using radix::Words64;
using KeysOfX = radix::KeysOf<false>;

struct Emit {
  const float* x;
  float* vals;
  int* idx;
  int kb;
  __device__ void operator()(int pos, unsigned long long w) const {
    if (pos < kb) {
      const int loc = (int)(w & LOC_MASK);
      vals[pos] = x[loc];
      idx[pos] = loc;
    }
  }
};

// one CTA of 512 threads on each SM (150 KB of shared memory), <= 128
// registers: measured faster than two of 256 threads with 32 words each,
// which spill
__global__ void __launch_bounds__(radix::THREADS, 1)
block_topk_kernel(const float* __restrict__ x, float* __restrict__ vals,
                  int* __restrict__ idx, unsigned long long* a,
                  unsigned* b, int block, int kb) {
  extern __shared__ __align__(16) unsigned char smem[];
  radix::Smem& s = *reinterpret_cast<radix::Smem*>(smem);
  const long long row = blockIdx.x;
  const KeysOfX keys{x + row * block};
  const Words64 wa{a + row * block};
  const Words32<2 * radix::BITS> wb{b + row * block};
  const Words32<3 * radix::BITS> wc{reinterpret_cast<unsigned*>(
      a + row * block)};
  const Emit out{x + row * block, vals + row * kb, idx + row * kb, kb};
  radix::row_histograms<LOC_BITS, 4>(keys, block, s);
  radix::row_pass<LOC_BITS>(keys, wa, block, 0, s);
  radix::row_pass<LOC_BITS>(wa, wb, block, 1, s);
  radix::row_pass<LOC_BITS>(wb, wc, block, 2, s);
  radix::row_pass<LOC_BITS>(wc, out, block, 3, s);
}

}  // namespace

// a, b: scratch of n_blocks * block 64-bit and 32-bit words.
extern "C" int block_topk(const float* x, float* vals, int* idx,
                          unsigned long long* a, unsigned* b,
                          int n_blocks, int block, int kb,
                          void* stream_ptr) {
  const cudaError_t err = cudaFuncSetAttribute(
      block_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(radix::Smem));
  if (err != cudaSuccess) return (int)err;
  block_topk_kernel<<<n_blocks, radix::THREADS, sizeof(radix::Smem),
                      (cudaStream_t)stream_ptr>>>(x, vals, idx, a, b, block,
                                                  kb);
  return (int)cudaGetLastError();
}
