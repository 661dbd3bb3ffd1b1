// Two error-feedback kernels for Hopper (sm_90a): the fused accumulate +
// exact segmented top-k candidates (fused_ef_topk, K1) and the threshold
// pass (sparsify_ef, K7).  Built by repro_torch/kernels/build.py with nvcc
// into a shared library with a plain C interface; bound with ctypes.
//
// fused_ef_topk replaces the TPU kernel
// src/repro/kernels/sparsify_ef.py::sparsify_ef_topk
// (body _ef_topk_kernel, per-block extractors segmented_topk.select_candidates
// and bitonic.select_candidates_bitonic).  Same contract, same triples:
//
//   u' = m*u + g as one FMA (__fmaf_rn: the reference's kernel under jit is
//   contracted the same way), v' = v + u' (sparse_gd: u' = u, v' = v + g);
//   every operation is an explicit intrinsic, so nvcc contracts nothing
//   else and v' is bitwise the plain version's;
//   per block of `block` elements, up to n_cand (value, global index, slot)
//   triples: for every slot piece in the block its top-min(kcap, |piece|)
//   elements by |v'| (ties: lowest index first), all emitted in |v'|
//   descending / index ascending order; unused entries are
//   (0, base + block, -1).
//
// What bounds it on this card: device-memory bytes.  The work is one read of
// (g, u, v, seg), one write of (u', v') and a write of the candidate pool;
// the arithmetic is a few operations per element.  A TPU core keeps a whole
// 128Ki-element block in VMEM and sorts it there; a CTA's 227 KB of shared
// memory does not hold one, so each block is radix-sorted by one CTA in a
// global scratch (sweep.cuh, on radix_sort.cuh): the accumulate is the
// sort's histogram walk, whose v' the first pass reads back through L2, and
// the per-slot cap is a walk over the sorted indices in the same CTA.

#include "sweep.cuh"

namespace {

int grid_for(long long work, int threads) {
  long long g = (work + threads - 1) / threads;
  const long long cap = 132LL * 32;
  if (g > cap) g = cap;
  return g < 1 ? 1 : (int)g;
}

// K1's row: the accumulate, whose v' the sweep selects on
struct EfSource {
  static constexpr bool kAccumulates = true;
  using Keys = radix::KeysOf<true>;      // v' is this kernel's own output
  struct In {
    float4 g, u, v;
  };
  const float *g, *u, *v;
  float *u_out, *v_out;
  float m;
  int use_momentum;

  __device__ void acc(float gi, float ui, float vi, float& un,
                      float& vn) const {
    if (use_momentum) {
      un = __fmaf_rn(m, ui, gi);
      vn = __fadd_rn(vi, un);
    } else {
      un = ui;
      vn = __fadd_rn(vi, gi);
    }
  }
  __device__ float one(long long i) const {
    float un, vn;
    acc(__ldg(g + i), __ldg(u + i), __ldg(v + i), un, vn);
    u_out[i] = un;
    __stcg(v_out + i, vn);
    return vn;
  }
  __device__ In load4(long long i) const {
    return {sweep::ld4(g + i), sweep::ld4(u + i), sweep::ld4(v + i)};
  }
  __device__ float4 apply4(const In& in, long long i) const {
    float4 un, vn;
    acc(in.g.x, in.u.x, in.v.x, un.x, vn.x);
    acc(in.g.y, in.u.y, in.v.y, un.y, vn.y);
    acc(in.g.z, in.u.z, in.v.z, un.z, vn.z);
    acc(in.g.w, in.u.w, in.v.w, un.w, vn.w);
    *reinterpret_cast<float4*>(u_out + i) = un;
    __stcg(reinterpret_cast<float4*>(v_out + i), vn);
    return vn;
  }
  __device__ const float* row(long long base) const { return v_out + base; }
  // a kept element's value: v' as this kernel wrote it, through L2
  __device__ float value(long long i) const { return __ldcg(v_out + i); }
};

// K7, the threshold pass (replaces src/repro/kernels/sparsify_ef.py::
// sparsify_ef, body _kernel): per element u' = fma(m, u, g), v' = v + u',
// keep = |v'| >= tau (false for NaN); u_out = keep ? +0 : u',
// v_out = keep ? +0 : v', sent = keep ? v' : +0.  One read of g, u, v and
// one write of three outputs, so it is bound by device-memory bytes.  The
// TPU kernel streams 64Ki-element tiles of an input padded to whole tiles;
// here a grid-stride loop over float4s (when every pointer is 16-byte
// aligned) and a scalar tail cover any n.
__device__ __forceinline__ void threshold_one(float gi, float ui, float vi,
                                              float tau, float m, float& uo,
                                              float& vo, float& so) {
  const float un = __fmaf_rn(m, ui, gi);
  const float vn = __fadd_rn(vi, un);
  const bool keep = fabsf(vn) >= tau;
  uo = keep ? 0.f : un;
  vo = keep ? 0.f : vn;
  so = keep ? vn : 0.f;
}

__global__ void threshold_ef_kernel(const float* __restrict__ g,
                                    const float* __restrict__ u,
                                    const float* __restrict__ v,
                                    const float* __restrict__ tau_ptr,
                                    float m, float* __restrict__ u_out,
                                    float* __restrict__ v_out,
                                    float* __restrict__ sent, long long n,
                                    int vec) {
  const float tau = *tau_ptr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  long long head = 0;
  if (vec) {
    const long long n4 = n >> 2;
    const float4* g4 = reinterpret_cast<const float4*>(g);
    const float4* u4 = reinterpret_cast<const float4*>(u);
    const float4* v4 = reinterpret_cast<const float4*>(v);
    float4* uo4 = reinterpret_cast<float4*>(u_out);
    float4* vo4 = reinterpret_cast<float4*>(v_out);
    float4* so4 = reinterpret_cast<float4*>(sent);
    for (long long i = tid; i < n4; i += stride) {
      const float4 a = g4[i], b = u4[i], c = v4[i];
      float4 x, y, z;
      threshold_one(a.x, b.x, c.x, tau, m, x.x, y.x, z.x);
      threshold_one(a.y, b.y, c.y, tau, m, x.y, y.y, z.y);
      threshold_one(a.z, b.z, c.z, tau, m, x.z, y.z, z.z);
      threshold_one(a.w, b.w, c.w, tau, m, x.w, y.w, z.w);
      uo4[i] = x;
      vo4[i] = y;
      so4[i] = z;
    }
    head = n4 << 2;
  }
  for (long long i = head + tid; i < n; i += stride)
    threshold_one(g[i], u[i], v[i], tau, m, u_out[i], v_out[i], sent[i]);
}

}  // namespace

extern "C" int sparsify_ef(const float* g, const float* u, const float* v,
                           const float* tau, float momentum, float* u_out,
                           float* v_out, float* sent, long long n,
                           void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const int vec = sweep::aligned16({g, u, v, u_out, v_out, sent});
  const int threads = 256;
  threshold_ef_kernel<<<grid_for(vec ? (n >> 2) : n, threads), threads, 0,
                        st>>>(g, u, v, tau, momentum, u_out, v_out, sent, n,
                              vec);
  return (int)cudaGetLastError();
}

extern "C" int fused_ef_topk(const float* g, const float* u, const float* v,
                             const int* seg, const int* kcap,
                             const int* active_of_block, int n_slots,
                             float* u_out, float* v_out, float* cvals,
                             int* cidx, int* cseg, unsigned long long* a,
                             unsigned* b, long long n, int block,
                             int n_blocks, int n_cand, float momentum,
                             int use_momentum, void* stream_ptr) {
  const EfSource src{g, u, v, u_out, v_out, momentum, use_momentum};
  const bool vec = sweep::aligned16({g, u, v, u_out, v_out, seg});
  return (int)sweep::launch(src, seg, kcap, active_of_block, n_slots, cvals,
                            cidx, cseg, a, b, n, block, n_blocks, n_cand, vec,
                            (cudaStream_t)stream_ptr);
}
