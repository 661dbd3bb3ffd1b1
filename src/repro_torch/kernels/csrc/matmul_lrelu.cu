// Y = LeakyReLU_0.01(X @ W + b) in f32, for Hopper (sm_90a).  Built by
// repro_torch/kernels/build.py with nvcc into a shared library with a plain
// C interface; bound with ctypes.
//
// Replaces the TPU kernel src/repro/kernels/matmul_lrelu.py::matmul_bias_lrelu
// (body _kernel): the LGC encoder's convolutions after the im2col unfold,
// with the bias and the activation in the epilogue so the pre-activation
// never goes back to device memory.
//
// What bounds it on this card: at the encoder's shapes (M ~ 1e4..1e5 rows,
// K = 3..768, N = 4..256) the K = 192..768 layers are bound by their
// operations, the K = 3 first layer and the N = 4 last by their bytes.  In
// f32 outside the tensor cores (67 TFLOP/s) the operations take longer
// than the bytes, so the products run on the tensor cores at f32 accuracy
// (3xTF32): each operand splits into hi = tf32(x) and lo = x - hi, and
// hi*hi + hi*lo + lo*hi accumulate in f32 through mma.sync.m16n8k8.tf32;
// the dropped lo*lo is ~2^-22 of each product.  Beside the mma the split
// is what costs (each warp splits its fragments), so it is two integer
// operations and a subtraction, and a K-step whose fragments hold a
// non-finite operand redoes it exactly (one warp vote per K-step): such an
// operand enters only hi*hi, so infinities and NaNs propagate as in f32
// products.  The tensor cores' accumulation rounds toward zero, so each
// 64-deep slice of K sums into a fresh accumulator that is added to the
// running one in f32, round to nearest.  Operands reach shared memory
// through cp.async, double buffered in 64-deep K-slices (measured faster
// than 16- or 32-deep slices and than more stages), zero-filled at the
// ragged edges (K % 64, N % 32, M % 32), so no padding to 128 (the TPU
// kernel's MXU tiling) is needed.  Each warp owns a 32x32 output tile; the
// CTA tile is 64x128 for N > 64 and 64x64 otherwise.  The K = 3 layer, where an mma tile would be mostly zero fill,
// takes a plain f32 FMA path instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 64, STAGES = 2, WARP_TILE = 32;
constexpr float LEAKY_SLOPE = 0.01f;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

constexpr unsigned TF32_HALF_ULP = 0x1000u, TF32_MASK = 0xFFFFE000u;

// x = hi + lo: hi = tf32(x), round to nearest, ties away (what
// cvt.rna.tf32.f32 gives, in two integer operations), lo = x - hi exactly;
// the mma reads lo at tf32 precision, so the product drops ~2^-22 of it.
// `bad` records an x that is not finite or rounds past the largest tf32:
// lo is then not finite.
__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo,
                                      bool& bad) {
  hi = (__float_as_uint(x) + TF32_HALF_ULP) & TF32_MASK;
  const float r = x - __uint_as_float(hi);
  bad |= !(fabsf(r) < __int_as_float(0x7F800000));
  lo = __float_as_uint(r);
}

// The same for a K-step holding such an x: it keeps its own bits in hi
// and enters the cross products as 0 (mid = 0, lo = 0), so an infinity or
// NaN reaches y through hi * hi alone, as in an f32 product.
__device__ __forceinline__ void split_exact(float x, unsigned& hi,
                                            unsigned& mid, unsigned& lo) {
  const unsigned bits = __float_as_uint(x);
  const unsigned r = (bits + TF32_HALF_ULP) & TF32_MASK;
  const float l = x - __uint_as_float(r);
  const bool ok = fabsf(l) < __int_as_float(0x7F800000);
  hi = ok ? r : bits;
  mid = ok ? r : 0u;
  lo = ok ? __float_as_uint(l) : 0u;
}

__device__ __forceinline__ void mma(float (&c)[4], const unsigned (&a)[4],
                                    const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// WM x WN warps, each a 32x32 output tile: the CTA tile is BM x BN.
// vec_x / vec_w: the rows of X / W are 16-byte aligned (K % 4 == 0 /
// N % 4 == 0), so they load in 16-byte chunks; else element by element.
template <int WM, int WN>
__global__ void __launch_bounds__(WM * WN * 32, 512 / (WM * WN * 32))
matmul_bias_lrelu_kernel(const float* __restrict__ X,
                         const float* __restrict__ W,
                         const float* __restrict__ bias,
                         float* __restrict__ Y, int M, int N, int K,
                         int apply_lrelu, int vec_x, int vec_w) {
  constexpr int BM = WM * WARP_TILE, BN = WN * WARP_TILE;
  constexpr int THREADS = WM * WN * 32;
  constexpr int AS = BK + 4, BS = BN + 8;   // strides: no bank conflicts
  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [STAGES][BM][AS]
  float* Bs = As + STAGES * BM * AS;             // [STAGES][BK][BS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  const int n_k = (K + BK - 1) / BK;

  // stage st <- rows [row0, +BM) x cols [k0, k0 + kw) of X and rows
  // [k0, k0 + kw) x cols [col0, +BN) of W, kw = K's slice rounded up to 8
  auto load = [&](int kt, int st) {
    const int k0 = kt * BK;
    const int kw = min(BK, (K - k0 + 7) & ~7);
    float* a = As + st * BM * AS;
    float* b = Bs + st * BK * BS;
    if (vec_x) {
      const int q_row = kw / 4;
      for (int c = tid; c < BM * q_row; c += THREADS) {
        const int m = c / q_row, k = 4 * (c % q_row);
        const bool ok = row0 + m < M && k0 + k < K;
        cp_async16(a + m * AS + k,
                   ok ? X + (long long)(row0 + m) * K + k0 + k : X, ok);
      }
    } else {
      for (int c = tid; c < BM * kw; c += THREADS) {
        const int m = c / kw, k = c % kw;
        const bool ok = row0 + m < M && k0 + k < K;
        cp_async4(a + m * AS + k,
                  ok ? X + (long long)(row0 + m) * K + k0 + k : X, ok);
      }
    }
    if (vec_w) {
      constexpr int q_row = BN / 4;
      for (int c = tid; c < kw * q_row; c += THREADS) {
        const int k = c / q_row, n = 4 * (c % q_row);
        const bool ok = k0 + k < K && col0 + n < N;
        cp_async16(b + k * BS + n,
                   ok ? W + (long long)(k0 + k) * N + col0 + n : W, ok);
      }
    } else {
      for (int c = tid; c < kw * BN; c += THREADS) {
        const int k = c / BN, n = c % BN;
        const bool ok = k0 + k < K && col0 + n < N;
        cp_async4(b + k * BS + n,
                  ok ? W + (long long)(k0 + k) * N + col0 + n : W, ok);
      }
    }
  };

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // STAGES - 1 slices in flight; slice kt + STAGES - 1 goes into the
  // stage that slice kt - 1 left, once every warp is past it
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_k) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < n_k)
      load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const int st = kt % STAGES;
    const float* a = As + st * BM * AS + (wm * WARP_TILE + g) * AS + t;
    const float* b = Bs + st * BK * BS + t * BS + wn * WARP_TILE + g;
    const int steps = min(BK, K - kt * BK + 7) / 8;
    float part[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      if (ks < steps) {
        // A fragment (row, k): (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
        // B fragment (k, n): (t, g), (t + 4, g)
        const float* pa = a + ks * 8;
        const float* pb = b + ks * 8 * BS;
        const int at[4] = {0, 8 * AS, 4, 8 * AS + 4}, bt[2] = {0, 4 * BS};
        unsigned ahi[2][4], alo[2][4], bhi[4][2], blo[4][2];
        bool bad = false;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            split(pa[i * 16 * AS + at[e]], ahi[i][e], alo[i][e], bad);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            split(pb[j * 8 + bt[e]], bhi[j][e], blo[j][e], bad);
        if (!__any_sync(0xffffffffu, bad)) {
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma(part[i][j], alo[i], bhi[j]);
              mma(part[i][j], ahi[i], blo[j]);
              mma(part[i][j], ahi[i], bhi[j]);
            }
        } else {                     // rare: a non-finite or huge operand
          unsigned amid[2][4], bmid[4][2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              split_exact(pa[i * 16 * AS + at[e]], ahi[i][e], amid[i][e],
                          alo[i][e]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
              split_exact(pb[j * 8 + bt[e]], bhi[j][e], bmid[j][e],
                          blo[j][e]);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              mma(part[i][j], alo[i], bmid[j]);
              mma(part[i][j], amid[i], blo[j]);
              mma(part[i][j], ahi[i], bhi[j]);
            }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
  }

  // C fragment: e = 0, 1 at (g, 2t + e), e = 2, 3 at (g + 8, 2t + e - 2)
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row0 + wm * WARP_TILE + i * 16 + g + (e >> 1) * 8;
        const int c = col0 + wn * WARP_TILE + j * 8 + 2 * t + (e & 1);
        if (r < M && c < N) {
          float y = acc[i][j][e] + bias[c];
          if (apply_lrelu) y = y >= 0.f ? y : LEAKY_SLOPE * y;
          Y[(long long)r * N + c] = y;
        }
      }
}

// A layer bound by its bytes with K < 8 (the first, K = 3), where an mma
// tile would be mostly zero fill: one thread per four consecutive outputs
// of a row, f32 FMAs over K in order.
__global__ void __launch_bounds__(256)
matmul_bias_lrelu_simt(const float* __restrict__ X,
                       const float* __restrict__ W,
                       const float* __restrict__ bias,
                       float* __restrict__ Y, int M, int N, int K,
                       int apply_lrelu, int vec_y) {
  const int quads = (N + 3) / 4;
  const long long q = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (q >= (long long)M * quads) return;
  const long long r = q / quads;
  const int c0 = 4 * (int)(q % quads);
  const float* xr = X + r * K;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < K; ++k) {
    const float x = xr[k];
    const float* wk = W + (long long)k * N + c0;
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < N) acc[e] = fmaf(x, wk[e], acc[e]);
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float y = c0 + e < N ? acc[e] + bias[c0 + e] : 0.f;
    acc[e] = apply_lrelu && !(y >= 0.f) ? LEAKY_SLOPE * y : y;
  }
  float* yr = Y + r * N + c0;
  if (vec_y) {
    *reinterpret_cast<float4*>(yr) = make_float4(acc[0], acc[1], acc[2],
                                                 acc[3]);
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (c0 + e < N) yr[e] = acc[e];
  }
}

template <int WM, int WN>
int launch(const float* X, const float* W, const float* bias, float* Y,
           int M, int N, int K, int apply_lrelu, int vec_x, int vec_w,
           cudaStream_t st) {
  constexpr int BM = WM * WARP_TILE, BN = WN * WARP_TILE;
  constexpr int SMEM =
      STAGES * (BM * (BK + 4) + BK * (BN + 8)) * (int)sizeof(float);
  // above 48 KB of shared memory a launch needs the opt-in
  const cudaError_t err = cudaFuncSetAttribute(
      matmul_bias_lrelu_kernel<WM, WN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_bias_lrelu_kernel<WM, WN><<<grid, WM * WN * 32, SMEM, st>>>(
      X, W, bias, Y, M, N, K, apply_lrelu, vec_x, vec_w);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int matmul_bias_lrelu(const float* X, const float* W,
                                 const float* bias, float* Y, int M, int N,
                                 int K, int apply_lrelu, void* stream_ptr) {
  const cudaStream_t st = (cudaStream_t)stream_ptr;
  if (K < 8) {
    const long long threads = (long long)M * ((N + 3) / 4);
    const int vec_y = N % 4 == 0 && ((uintptr_t)Y & 15) == 0;
    matmul_bias_lrelu_simt<<<(unsigned)((threads + 255) / 256), 256, 0,
                             st>>>(X, W, bias, Y, M, N, K, apply_lrelu,
                                   vec_y);
    return (int)cudaGetLastError();
  }
  const int vec_x = K % 4 == 0 && ((uintptr_t)X & 15) == 0;
  const int vec_w = N % 4 == 0 && ((uintptr_t)W & 15) == 0;
  if (N > 64)                                // 64x128 tiles
    return launch<2, 4>(X, W, bias, Y, M, N, K, apply_lrelu, vec_x, vec_w,
                        st);
  return launch<2, 2>(X, W, bias, Y, M, N, K, apply_lrelu, vec_x, vec_w,
                      st);
}
