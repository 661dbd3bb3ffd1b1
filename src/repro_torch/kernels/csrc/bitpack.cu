// Bit-plane pack and unpack of int32 values, and the fused sparse-wire
// encode, for Hopper (sm_90a).  Built by repro_torch/kernels/build.py with
// nvcc into a shared library with a plain C interface; bound with ctypes.
//
// Replaces the TPU kernels of src/repro/kernels/bitpack.py:
//   pack_bits      (K5a, :172)  word[b][j] = sum_r bit_b(x[r*W + j]) << r
//   unpack_bits    (K5b, :206)  x[r*W + j] = sum_b bit_r(word[b][j]) << b,
//                               for a (B, width, W) stack of planes
//   quantize_pack  (K4, :112)   per scale block: non-finite -> 0,
//                               scale = max(max|x|, eps) * f32(1/127),
//                               q = clamp(rint(x / scale), -127, 127);
//                               and the bit planes of idx_lo, in one launch.
// The values are read as the zero-padded (32, W) row-major array of the
// reference, so word j gathers values j, W + j, 2W + j, ...
//
// What bounds them on this card: bytes, and a launch.  Each moves 1-3 MB
// (k ~ 243K pairs, 16-bit planes), a byte bound near 1 us, so DRAM latency
// and the launch set their device time, and the host's work in the
// wrapper their time per call.  So each reads every input word once and
// writes every output once, coalesced, with no block-wide reduction:
//   K5b  one CTA per 32-column tile of one stack entry (grid.y = B, so
//        the whole gathered table decodes in one launch) loads the tile's
//        width x 32 words into shared memory, neighbouring threads on
//        neighbouring columns; each warp then builds rows of the tile from
//        it, lane j writing out[r*W + j0 + j], so each row's 32 values
//        are one 128-byte store.  Nothing is written at or past k.
//   K4   one warp per scale block: each lane loads its values (16-byte
//        loads where the block and the pointer allow), the warp takes the
//        max of the finite |x| by __shfl_xor_sync (max is exact in any
//        order) and writes the int8 values four to a store.  The pack half
//        stages a 32-row x 32-column tile of idx_lo in shared memory (read
//        once, coalesced; rows padded to 33 words against bank
//        conflicts); a warp makes plane b's word of column c with one
//        __ballot_sync((x >> b) & 1) over the 32 rows (lane r's bit is
//        bit r of the word, as the reference sums them), keeps it in lane
//        c and stores the plane's 32 words of the tile as one 128-byte
//        row (pack_tile).
//   K5a  K4's pack half alone: one CTA per 32-column tile runs the same
//        pack_tile, so every value is read once, in 128-byte rows, where
//        one thread per word read each value width times.
// The words are built in uint32, so bit 31 is just a bit.  The scale
// multiplies by the f32 reciprocal of 127, as XLA compiles the reference's
// division by the constant 127 under jit; x / scale stays a true IEEE
// division (__fdiv_rn) and rintf rounds half to even.  No
// --use_fast_math: it would make the division approximate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 32;
constexpr int kMaxWidth = 31;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;

// One CTA per 32-column tile of stack entry blockIdx.y: the tile's planes
// are read once into shared memory, then each lane holds its column's
// width words and builds rows r = warp, warp + 8, ... of it.
__global__ void unpack_kernel(const int* __restrict__ words,
                              int* __restrict__ out, int k, int width,
                              int W) {
  __shared__ unsigned tile[kMaxWidth][kGroup];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = blockIdx.x * kGroup + lane;
  const int* planes = words + (long long)blockIdx.y * width * W;
  int* dst = out + (long long)blockIdx.y * k;
  for (int b = warp; b < width; b += kWarps)
    tile[b][lane] = j < W ? (unsigned)planes[(long long)b * W + j] : 0u;
  __syncthreads();
  if (j >= W) return;
  unsigned col[kMaxWidth];
#pragma unroll
  for (int b = 0; b < kMaxWidth; ++b) col[b] = b < width ? tile[b][lane] : 0u;
  for (int r = warp; r < kGroup; r += kWarps) {
    const long long i = (long long)r * W + j;
    if (i >= k) break;                       // i grows with r
    unsigned v = 0;
#pragma unroll
    for (int b = 0; b < kMaxWidth; ++b) v |= ((col[b] >> r) & 1u) << b;
    dst[i] = (int)v;
  }
}

__device__ __forceinline__ float finite_abs(float x) {
  return isfinite(x) ? fabsf(x) : 0.0f;
}

__device__ __forceinline__ signed char quantize(float x, float scale) {
  if (!isfinite(x)) x = 0.0f;
  const float r = rintf(__fdiv_rn(x, scale));
  return (signed char)fminf(fmaxf(r, -127.0f), 127.0f);
}

// vals[i .. i + 3], zero at and past k.
__device__ __forceinline__ float4 load4(const float* __restrict__ vals,
                                        long long i, int k) {
  if (i + 4 <= k) return __ldg(reinterpret_cast<const float4*>(vals + i));
  float4 x;
  x.x = i < k ? vals[i] : 0.0f;
  x.y = i + 1 < k ? vals[i + 1] : 0.0f;
  x.z = i + 2 < k ? vals[i + 2] : 0.0f;
  x.w = 0.0f;
  return x;
}

// One warp quantizes scale block blk; vec: 16-byte loads and 4-byte
// stores (sb % 4 == 0 and aligned pointers).  The second loop reads the
// block again from L1.
__device__ void quantize_block(const float* __restrict__ vals,
                               signed char* __restrict__ q,
                               float* __restrict__ scales, long long blk,
                               int k, int sb, float eps, bool vec,
                               int lane) {
  const long long base = blk * sb;
  float mx = 0.0f;
  if (vec) {
    for (int t = lane * 4; t < sb; t += 4 * kGroup) {
      const float4 x = load4(vals, base + t, k);
      mx = fmaxf(fmaxf(mx, fmaxf(finite_abs(x.x), finite_abs(x.y))),
                 fmaxf(finite_abs(x.z), finite_abs(x.w)));
    }
  } else {
    for (int t = lane; t < sb; t += kGroup)
      mx = fmaxf(mx, base + t < k ? finite_abs(vals[base + t]) : 0.0f);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, off));
  const float scale = __fmul_rn(fmaxf(mx, eps), 1.0f / 127.0f);
  if (lane == 0) scales[blk] = scale;
  if (vec) {
    for (int t = lane * 4; t < sb; t += 4 * kGroup) {
      const float4 x = load4(vals, base + t, k);
      char4 c;
      c.x = quantize(x.x, scale);
      c.y = quantize(x.y, scale);
      c.z = quantize(x.z, scale);
      c.w = quantize(x.w, scale);
      *reinterpret_cast<char4*>(q + base + t) = c;
    }
  } else {
    for (int t = lane; t < sb; t += kGroup)
      q[base + t] = quantize(base + t < k ? vals[base + t] : 0.0f, scale);
  }
}

// The planes of the 32-column tile t of idx_lo: the tile staged in shared
// memory, then per plane b (one warp each) a ballot over the 32 rows makes
// the word of each column; lane c keeps column c's and stores it.
__device__ void pack_tile(const int* __restrict__ x, int* __restrict__ words,
                          int k, int width, int W, int t) {
  __shared__ unsigned rows[kGroup][kGroup + 1];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int j = t * kGroup + lane;
  for (int r = warp; r < kGroup; r += kWarps) {
    const long long i = (long long)r * W + j;
    rows[r][lane] = j < W && i < k ? (unsigned)x[i] : 0u;
  }
  __syncthreads();
  for (int b = warp; b < width; b += kWarps) {
    unsigned mine = 0;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const unsigned w = __ballot_sync(kFull, (rows[lane][c] >> b) & 1u);
      if (lane == c) mine = w;
    }
    if (j < W) words[(long long)b * W + j] = (int)mine;
  }
}

// K5a: one CTA per 32-column tile of the planes.
__global__ void pack_kernel(const int* __restrict__ x, int* __restrict__ words,
                            int k, int width, int W) {
  pack_tile(x, words, k, width, W, blockIdx.x);
}

// Blocks [0, n_q) quantize kWarps scale blocks each, a warp a block;
// blocks [n_q, gridDim.x) pack one 32-column tile of the index words each.
__global__ void quantize_pack_kernel(const float* __restrict__ vals,
                                     const int* __restrict__ idx_lo,
                                     int* __restrict__ words,
                                     signed char* __restrict__ q,
                                     float* __restrict__ scales, int k,
                                     int width, int W, int m, int sb,
                                     float eps, bool vec, int n_q) {
  if ((int)blockIdx.x >= n_q) {
    pack_tile(idx_lo, words, k, width, W, blockIdx.x - n_q);
    return;
  }
  const long long blk = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (blk < m)
    quantize_block(vals, q, scales, blk, k, sb, eps, vec, threadIdx.x & 31);
}

}  // namespace

extern "C" int pack_bits(const int* x, int* words, int k, int width, int W,
                         void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  pack_kernel<<<(W + kGroup - 1) / kGroup, kThreads, 0, st>>>(x, words, k,
                                                              width, W);
  return (int)cudaGetLastError();
}

extern "C" int unpack_bits(const int* words, int* out, int B, int k,
                           int width, int W, void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const dim3 grid((W + kGroup - 1) / kGroup, B);
  unpack_kernel<<<grid, kThreads, 0, st>>>(words, out, k, width, W);
  return (int)cudaGetLastError();
}

extern "C" int quantize_pack(const float* vals, const int* idx_lo, int* words,
                             signed char* q, float* scales, int k, int width,
                             int W, int m, int sb, float eps,
                             void* stream_ptr) {
  cudaStream_t st = (cudaStream_t)stream_ptr;
  const long long n_q = ((long long)m + kWarps - 1) / kWarps;
  const long long grid = n_q + (W + kGroup - 1) / kGroup;
  if (grid > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  const bool vec = sb % 4 == 0 && ((uintptr_t)vals & 15) == 0 &&
                   ((uintptr_t)q & 3) == 0;
  quantize_pack_kernel<<<(unsigned)grid, kThreads, 0, st>>>(
      vals, idx_lo, words, q, scales, k, width, W, m, sb, eps, vec,
      (int)n_q);
  return (int)cudaGetLastError();
}
