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
// global-memory key scratch instead (topk_sort.cuh):
//
//   1. ef_keys_kernel: the accumulate, plus one 64-bit key per element of a
//      block that holds any selectable element ("active" block); blocks
//      with no selectable element (the exempt embedding) get no keys.
//   2. a bitonic sort of each active block's keys (sort_rows).
//   3. cap_emit_kernel: the per-slot cap, and the compaction of the kept
//      elements into the pool.
//
// The sort moves the key scratch ~20 times, so the kernel is several times
// its byte bound; fewer global passes (several merge distances per pass) and
// sorting only each slot's top candidates are the known next steps.

#include "topk_sort.cuh"

namespace {

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
    if (a >= 0)
      keys[(long long)a * block2 + loc] =
          s >= 0 ? magnitude_key(vn, loc) : MASKED;
  }
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
  const long long total = (long long)n_blocks * block;
  ef_keys_kernel<<<grid_for(total, 256), 256, 0, st>>>(
      g, u, v, seg, active_of_block, u_out, v_out, keys, n, block,
      next_pow2(block), total, momentum, use_momentum);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)sort_and_emit(keys, seg, v_out, kcap, active_of_block, n_slots,
                            cvals, cidx, cseg, block, n_blocks, n_active,
                            n_cand, st);
}
