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
// K = 3..768, N = 4..256) the product is small; the larger layers are bound
// by the f32 operations outside the tensor cores, the K = 3 first layer by
// its bytes.  The reference is f32, so TF32 tensor cores are out: this is a
// tiled SIMT GEMM, 64x64 output tiles staged through shared memory in K
// steps of 16, each of 256 threads keeping a 4x4 block of outputs in
// registers.  It masks ragged edges itself, so no padding to 128 (the TPU
// kernel's MXU tiling) is needed.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;
constexpr float LEAKY_SLOPE = 0.01f;

__global__ void __launch_bounds__(THREADS)
matmul_bias_lrelu_kernel(const float* __restrict__ X,
                         const float* __restrict__ W,
                         const float* __restrict__ bias,
                         float* __restrict__ Y, int M, int N, int K,
                         int apply_lrelu) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.x * BM, col0 = blockIdx.y * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = threadIdx.x; e < BM * BK; e += THREADS) {
      const int m = e / BK, kk = e % BK;
      const int r = row0 + m, k = k0 + kk;
      As[kk][m] = (r < M && k < K) ? X[(long long)r * K + k] : 0.f;
    }
    for (int e = threadIdx.x; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int k = k0 + kk, c = col0 + nn;
      Bs[kk][nn] = (k < K && c < N) ? W[(long long)k * N + c] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += a[i] * b[j];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c >= N) continue;
      float y = acc[i][j] + bias[c];
      if (apply_lrelu) y = y >= 0.f ? y : LEAKY_SLOPE * y;
      Y[(long long)r * N + c] = y;
    }
  }
}

}  // namespace

extern "C" int matmul_bias_lrelu(const float* X, const float* W,
                                 const float* bias, float* Y, int M, int N,
                                 int K, int apply_lrelu, void* stream_ptr) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  matmul_bias_lrelu_kernel<<<grid, THREADS, 0, (cudaStream_t)stream_ptr>>>(
      X, W, bias, Y, M, N, K, apply_lrelu);
  return (int)cudaGetLastError();
}
