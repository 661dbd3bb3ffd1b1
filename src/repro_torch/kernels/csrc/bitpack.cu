// Bit-plane pack and unpack of int32 values, and the fused sparse-wire
// encode, for Hopper (sm_90a).  Built by repro_torch/kernels/build.py with
// nvcc into a shared library with a plain C interface; bound with ctypes.
//
// Replaces the TPU kernels of src/repro/kernels/bitpack.py:
//   pack_bits      (K5a)  word[b][j] = sum_r bit_b(x[r*W + j]) << r
//   unpack_bits    (K5b)  x[r*W + j] = sum_b bit_r(word[b][j]) << b
//   quantize_pack  (K4)   per scale block: non-finite -> 0,
//                         scale = max(max|x|, eps) * f32(1/127),
//                         q = clamp(rint(x / scale), -127, 127);
//                         and the bit planes of idx_lo, in one launch.
// The values are read as the zero-padded (32, W) row-major array of the
// reference, so word j gathers values j, W + j, 2W + j, ...
//
// What bounds them on this card: nothing at the path's sizes.  Each moves
// 1-3 MB (k ~ 243K pairs, 16-bit planes), a byte bound near 1 us, so the
// launch latency sets their time.  The design is therefore the simplest
// exact one: one thread per output word (pack) or value (unpack), reading
// its 32 (or width) inputs with neighbouring threads on neighbouring words,
// and one CTA per scale block for the quantize, whose max is a tree
// reduction (max is exact in any order).  The words are built in uint32,
// so bit 31 is just a bit.  The scale multiplies by the f32 reciprocal of
// 127, as XLA compiles the reference's division by the constant 127 under
// jit; x / scale stays a true IEEE division (__fdiv_rn) and rintf rounds
// half to even.  No --use_fast_math: it would make the division
// approximate.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kGroup = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ unsigned pack_word(const int* __restrict__ x,
                                              int k, int W, int b, int j) {
  unsigned word = 0;
#pragma unroll
  for (int r = 0; r < kGroup; ++r) {
    const long long i = (long long)r * W + j;
    const unsigned v = i < k ? (unsigned)x[i] : 0u;
    word |= ((v >> b) & 1u) << r;
  }
  return word;
}

__global__ void pack_kernel(const int* __restrict__ x, int* __restrict__ words,
                            int k, int width, int W) {
  const long long total = (long long)width * W;
  for (long long o = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       o < total; o += (long long)gridDim.x * blockDim.x) {
    const int b = (int)(o / W), j = (int)(o - (long long)b * W);
    words[o] = (int)pack_word(x, k, W, b, j);
  }
}

__global__ void unpack_kernel(const int* __restrict__ words,
                              int* __restrict__ out, int k, int width,
                              int W) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < k;
       i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / W), j = (int)(i - (long long)r * W);
    unsigned v = 0;
    for (int b = 0; b < width; ++b)
      v |= (((unsigned)words[(long long)b * W + j] >> r) & 1u) << b;
    out[i] = (int)v;
  }
}

// Blocks [0, m) quantize one scale block each; blocks [m, gridDim.x) pack
// the index words, one thread per word.
__global__ void quantize_pack_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ idx_lo,
                                     int* __restrict__ words,
                                     signed char* __restrict__ q,
                                     float* __restrict__ scales, int k,
                                     int width, int W, int m, int sb,
                                     float eps) {
  if ((int)blockIdx.x >= m) {
    const long long o =
        (long long)(blockIdx.x - m) * blockDim.x + threadIdx.x;
    if (o < (long long)width * W) {
      const int b = (int)(o / W), j = (int)(o - (long long)b * W);
      words[o] = (int)pack_word(idx_lo, k, W, b, j);
    }
    return;
  }
  __shared__ float red[kThreads];
  const long long base = (long long)blockIdx.x * sb;
  float mx = 0.0f;
  for (int t = threadIdx.x; t < sb; t += blockDim.x) {
    const long long i = base + t;
    const float x = i < k ? vals[i] : 0.0f;
    mx = fmaxf(mx, isfinite(x) ? fabsf(x) : 0.0f);
  }
  red[threadIdx.x] = mx;
  __syncthreads();
  for (int s = blockDim.x / 2; s > 0; s >>= 1) {
    if ((int)threadIdx.x < s)
      red[threadIdx.x] = fmaxf(red[threadIdx.x], red[threadIdx.x + s]);
    __syncthreads();
  }
  const float scale = __fmul_rn(fmaxf(red[0], eps), 1.0f / 127.0f);
  if (threadIdx.x == 0) scales[blockIdx.x] = scale;
  for (int t = threadIdx.x; t < sb; t += blockDim.x) {
    const long long i = base + t;
    float x = i < k ? vals[i] : 0.0f;
    if (!isfinite(x)) x = 0.0f;
    const float r = rintf(__fdiv_rn(x, scale));
    q[base + t] = (signed char)fminf(fmaxf(r, -127.0f), 127.0f);
  }
}

int grid_for(long long n) {
  const long long g = (n + kThreads - 1) / kThreads;
  return (int)(g < 1 ? 1 : (g > 65535 ? 65535 : g));
}

}  // namespace

extern "C" int pack_bits(const int* x, int* words, int k, int width, int W,
                         void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  pack_kernel<<<grid_for((long long)width * W), kThreads, 0, st>>>(
      x, words, k, width, W);
  return (int)cudaGetLastError();
}

extern "C" int unpack_bits(const int* words, int* out, int k, int width,
                           int W, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  unpack_kernel<<<grid_for(k), kThreads, 0, st>>>(words, out, k, width, W);
  return (int)cudaGetLastError();
}

extern "C" int quantize_pack(const float* vals, const int* idx_lo, int* words,
                             signed char* q, float* scales, int k, int width,
                             int W, int m, int sb, float eps,
                             void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const long long n_words = (long long)width * W;
  const long long grid = m + (n_words + kThreads - 1) / kThreads;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  quantize_pack_kernel<<<(unsigned)grid, kThreads, 0, st>>>(
      vals, idx_lo, words, q, scales, k, width, W, m, sb, eps);
  return (int)cudaGetLastError();
}
