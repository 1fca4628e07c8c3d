// int4 weight-only matvec for the serving rollout: y = (bf16(x) @ W) * s
// with W stored as packed signed nibbles.
//
// Replaces sea_tpu/ops/quant_matmul.py::_mv_kernel, the Pallas TPU kernel.
// Storage is the JAX package's: wp is uint8 [K/2, N], byte [k, n] holding
// w[k, n] in its low nibble and w[k + K/2, n] in its high nibble, both
// signed (-8..7); s is an f32 scale per output column. x is f32 [M, K] with
// M <= 8 rows; each element is rounded to bf16 once, as the TPU kernel
// feeds bf16 x to its dots. Products of an exact nibble and a bf16 value
// are exact in f32, sums are f32, and s multiplies once at the end: the
// math the TPU kernel keeps with its AND/XOR +8 trick and rank-1
// correction, which are Mosaic workarounds and are not carried over.
//
// What bounds it: memory. A call reads K/2 * N bytes of weights and does
// 2 M multiply-adds per byte, far below what the card computes per byte
// (the B=1 rollout streams every weight once a step). So the design minds
// bytes in flight and filling the card:
//  - each lane reads 16 bytes (16 columns) of a packed row in one vector
//    load, neighbouring lanes on neighbouring columns: a warp sweeps 512
//    contiguous bytes of a row, and a block of 8 warps covers a strip of
//    512 columns, its warps taking every 8th row of the block's K chunk;
//  - the nibbles are unpacked in registers (shifts of the signed byte) and
//    each pairs with x[m, k] (low) or x[m, k + K/2] (high) from shared
//    memory, where the block stages only its own K chunk of x, bf16-rounded
//    (at most 256 packed rows: 16 KB at M = 8, where all of x at K = 16384
//    would be 512 KB, over the 227 KB a block may have);
//  - N = 1024 or 2048 gives only 2-4 column strips for 132 SMs, so K is
//    split over blocks (split-K, about two blocks per SM): each block sums
//    its 8 warps in shared memory in a fixed order and writes a partial
//    [split, M, N]; a second small kernel sums the splits in order and
//    applies s. No atomics: the result does not depend on block timing.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 16;             // columns per lane: one 16-byte load
constexpr int kStrip = 32 * kCols;    // columns per block
constexpr int kMaxChunk = 256;        // packed rows per split, at most
constexpr int kRedLd = kCols + 1;     // odd row stride: no bank conflicts

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

// Signed low and high nibble of a byte, as exact floats.
__device__ __forceinline__ float nib_lo(unsigned b) {
  return static_cast<float>(static_cast<int>(b << 28) >> 28);
}
__device__ __forceinline__ float nib_hi(unsigned b) {
  return static_cast<float>(static_cast<int>(b << 24) >> 28);
}

template <int M>
__global__ void __launch_bounds__(kThreads)
int4_partial(const float* __restrict__ x, const uint8_t* __restrict__ wp,
             float* __restrict__ part, int K2, int N, int chunk) {
  __shared__ float xs[M][2][kMaxChunk];
  __shared__ float red[kWarps][32 * kRedLd];
  const int split = blockIdx.y;
  const int k0 = split * chunk;
  const int rows = min(chunk, K2 - k0);
  const size_t K = 2 * static_cast<size_t>(K2);
  for (int e = threadIdx.x; e < M * rows; e += kThreads) {
    const int m = e / rows, r = e % rows;
    xs[m][0][r] = bf16_round(__ldg(x + m * K + k0 + r));
    xs[m][1][r] = bf16_round(__ldg(x + m * K + K2 + k0 + r));
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n0 = blockIdx.x * kStrip + lane * kCols;
  const bool vec = (N % kCols == 0) && (n0 + kCols <= N);
  float acc[M][kCols];
#pragma unroll
  for (int m = 0; m < M; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  if (n0 < N) {
#pragma unroll 2
    for (int r = warp; r < rows; r += kWarps) {
      const uint8_t* src = wp + static_cast<size_t>(k0 + r) * N + n0;
      uint8_t b[kCols];
      if (vec) {
        const uint4 w = __ldg(reinterpret_cast<const uint4*>(src));
        memcpy(b, &w, sizeof(w));
      } else {
#pragma unroll
        for (int j = 0; j < kCols; ++j) b[j] = n0 + j < N ? __ldg(src + j) : 0;
      }
      float xl[M], xh[M];
#pragma unroll
      for (int m = 0; m < M; ++m) {
        xl[m] = xs[m][0][r];
        xh[m] = xs[m][1][r];
      }
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float lo = nib_lo(b[j]), hi = nib_hi(b[j]);
#pragma unroll
        for (int m = 0; m < M; ++m)
          acc[m][j] = fmaf(xh[m], hi, fmaf(xl[m], lo, acc[m][j]));
      }
    }
  }

  // Sum the warps in a fixed order, one row of x at a time.
  const int n_strip = blockIdx.x * kStrip;
#pragma unroll
  for (int m = 0; m < M; ++m) {
#pragma unroll
    for (int j = 0; j < kCols; ++j) red[warp][lane * kRedLd + j] = acc[m][j];
    __syncthreads();
    for (int c = threadIdx.x; c < kStrip; c += kThreads) {
      const int idx = (c / kCols) * kRedLd + c % kCols;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[w][idx];
      const int n = n_strip + c;
      if (n < N) part[(static_cast<size_t>(split) * M + m) * N + n] = sum;
    }
    __syncthreads();
  }
}

// out[m, n] = s[n] * sum over splits, in split order.
__global__ void __launch_bounds__(kThreads)
int4_merge(const float* __restrict__ part, const float* __restrict__ s,
           float* __restrict__ out, int M, int N, int splits) {
  const size_t e = static_cast<size_t>(blockIdx.x) * kThreads + threadIdx.x;
  const size_t MN = static_cast<size_t>(M) * N;
  if (e >= MN) return;
  float sum = 0.f;
  for (int sp = 0; sp < splits; ++sp) sum += part[sp * MN + e];
  out[e] = sum * __ldg(s + e % N);
}

template <int M>
cudaError_t launch(const float* x, const uint8_t* wp, const float* s,
                   float* part, float* out, int K2, int N, int splits,
                   int chunk, cudaStream_t stream) {
  const dim3 grid((N + kStrip - 1) / kStrip, splits);
  int4_partial<M><<<grid, kThreads, 0, stream>>>(x, wp, part, K2, N, chunk);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t MN = static_cast<size_t>(M) * N;
  int4_merge<<<static_cast<unsigned>((MN + kThreads - 1) / kThreads),
               kThreads, 0, stream>>>(part, s, out, M, N, splits);
  return cudaGetLastError();
}

}  // namespace

// x: f32 [M, 2*K2]; wp: uint8 [K2, N]; s: f32 [N]; part: f32 [splits, M, N]
// scratch; out: f32 [M, N]. All contiguous; 1 <= M <= 8; every split covers
// `chunk` <= 256 packed rows (the last one the rest), splits * chunk >= K2.
// Enqueues on `stream`; returns cudaGetLastError() after the launches.
extern "C" int sea_int4_matvec(const void* x, const void* wp, const void* s,
                               void* part, void* out, int M, int K2, int N,
                               int splits, int chunk, void* stream) {
  if (chunk > kMaxChunk || chunk < 1 ||
      static_cast<long long>(splits) * chunk < K2)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* X = static_cast<const float*>(x);
  const uint8_t* W = static_cast<const uint8_t*>(wp);
  const float* S = static_cast<const float*>(s);
  float* P = static_cast<float*>(part);
  float* O = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SEA_INT4_CASE(MM) \
  case MM:                \
    return static_cast<int>(launch<MM>(X, W, S, P, O, K2, N, splits, chunk, st))
  switch (M) {
    SEA_INT4_CASE(1);
    SEA_INT4_CASE(2);
    SEA_INT4_CASE(3);
    SEA_INT4_CASE(4);
    SEA_INT4_CASE(5);
    SEA_INT4_CASE(6);
    SEA_INT4_CASE(7);
    SEA_INT4_CASE(8);
  }
#undef SEA_INT4_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
