// Kernels of the int4 matvec microbenchmarks (sea_tpu_torch/tools/), one
// launch a call each. They take the serving int4 matvec (csrc/quant_matmul.cu,
// the port of sea_tpu/ops/quant_matmul.py::_mv_kernel) apart: the byte
// stream alone, the unpack alone, three ways to unpack a nibble, int8
// weights, and output-major weights.
//
// They replace the eight Pallas TPU functions under tools/:
//
//   tools/bench_quant_matvec.py:56    matvec_p4          matvec_in<kP4>
//   tools/bench_quant_matvec.py:85    matvec_p4b         matvec_in<kP4b>
//   tools/bench_quant_matvec.py:118   matvec_p4c         matvec_in<kP4c>
//   tools/bench_quant_matvec.py:142   matvec_s8          matvec_in<kS8>
//   tools/bench_quant_matvec.py:169   stream_bytes       reduce_kernel<0>
//   tools/bench_quant_matvec.py:186   dma_only           copy_kernel
//   tools/bench_unpack_ceiling.py:73  _unpack_only_call  reduce_kernel<1>
//   tools/bench_unpack_ceiling.py:115 _mvt_call          matvec_out
//
// (reduce_kernel<0> is kColumnSums, reduce_kernel<1> kUnpackSums.)
//
// Storage is the tools': wp uint8 [K/2, N], byte [k, n] holding w[k, n] in
// its low nibble and w[k + K/2, n] in its high one (input-major);
// _mvt_call's wpt uint8 [N, K/2] holds the same nibbles output-major;
// matvec_s8's w8 is int8 [K, N]. x is bf16 [B, K], s an f32 scale per
// output column, y f32 [B, N].
//
// What bounds them: memory. Each reads its weight once, K/2 * N bytes
// (K * N for matvec_s8): 16.8 MB at the tools' (K, N) = (2048, 16384),
// 5.0 us at 3.35 TB/s. The matvecs do 2 B multiply-adds a weight, nothing
// against the tensor cores; they run as f32 FMAs on the CUDA cores, where
// the unpack's integer operations and the conversions compete with the
// FMAs for the schedulers' slots. So every form converts its small
// integers to f32 with one integer add and one f32 subtraction (the
// 1.5 * 2^23 bias, exact below 2^22), not with I2F, which runs at an
// eighth of the FMA rate on sm_90; the forms differ only in their integer
// formulas, which
// keep the TPU kernels' own:
//
//   kP4   32-bit: ((w & 0xF) ^ 8) - 8 and ((w >> 4) ^ 8) - 8;
//   kP4b  byte-width sign extension: int8(w << 4) >> 4 and int8(w) >> 4;
//   kP4c  the bias form: (w & 0xF) ^ 8 = lo + 8 and int8(w) & -16 = 16 hi;
//         x's high half is read times 1/16 (exact) and 8 sum(x_lo) is
//         taken off the sum once a row, as the TPU kernel's rank-1 term;
//   kS8   int8(w) as it is.
//
// Design, simple first:
//
//  - matvec_in: a block owns 64 output columns and all of K; 256 threads
//    are 4 column groups of 16 bytes by 64 row slices, so one warp load
//    reads 8 rows of 64 contiguous bytes. Each thread loads 8 rows' (4 at
//    B > 4) 16-byte pieces before it uses any (bytes in flight), keeps
//    B x 16 f32 sums, and reads x from shared memory, where the block
//    stages it once as f32 [K][BT] (BT = B rounded up to 1, 2, 4 or 8;
//    rows past B zero).
//    The 64 slices are summed in a fixed order: shuffles inside a warp,
//    then the 8 warps in order through shared memory.
//  - matvec_out: a warp owns 8 output columns (weight rows) at a time, its
//    lanes reading 4 contiguous bytes of each (a warp reads 128-byte
//    lines) and x once for the 8; the lane sums meet in a fixed shuffle
//    order. Blocks walk the columns (a persistent grid of 2 an SM).
//  - reduce_kernel: a grid of (row splits, column tiles), enough blocks to
//    fill the card twice; 16-byte loads, 4 rows in flight a thread. The
//    column sums (stream_bytes) and the unpacked tile sums
//    (_unpack_only_call) fold across blocks with 64-bit integer atomics:
//    exact and independent of order. The last block to arrive (a counter
//    in the same scratch) writes the result and zeroes the scratch for
//    the next call. Every block's sums reach the atomics, so no block's
//    unpack is dead code.
//  - copy_kernel (dma_only): the same grid, each block copying its rows
//    into a ring of 4 shared-memory stages of up to 8 KB with 16-byte
//    cp.async, which the compiler cannot drop; only the block holding row
//    0 of the last tile reads it back and writes the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;
// matvec_in: column groups of 16 bytes a block, row slices, rows a load.
constexpr int kGroups = 4;
constexpr int kCols = 16 * kGroups;
constexpr int kSlices = kThreads / kGroups;
// Rows a thread loads before it uses any: 8, or 4 at B > 4, where its B x 16
// sums already take 128 registers.
__host__ __device__ constexpr int unroll(int bt) { return bt > 4 ? 4 : 8; }
// matvec_out: weight rows a warp, 4-byte loads a lane a row per step, steps
// unrolled.
constexpr int kRowsPerWarp = 8;
constexpr int kOutSteps = 2;
// reduce_kernel: rows in flight a thread. copy_kernel: ring of stages.
constexpr int kReduceUnroll = 4;
constexpr int kRing = 4;
constexpr int kStageBytes = 8192;

enum Form : int { kP4 = 0, kP4b = 1, kP4c = 2, kS8 = 3, kOut = 4 };
enum Reduce : int { kColumnSums = 0, kUnpackSums = 1, kCopy = 2 };

// An integer |v| < 2^22 as f32, exactly, in two full-rate operations.
__device__ __forceinline__ float small_int_to_float(int v) {
  return __int_as_float(0x4B400000 + v) - 12582912.0f;
}

// The two nibble planes of packed byte w (0..255) in form F, as f32.
template <int F>
__device__ __forceinline__ void planes(uint32_t w, float& lo, float& hi) {
  if constexpr (F == kP4) {
    const int v = static_cast<int>(w);
    lo = small_int_to_float(((v & 0xF) ^ 8) - 8);
    hi = small_int_to_float(((v >> 4) ^ 8) - 8);
  } else if constexpr (F == kP4b) {
    const int8_t b = static_cast<int8_t>(w);
    const int8_t shl = static_cast<int8_t>(static_cast<uint8_t>(w << 4));
    lo = small_int_to_float(shl >> 4);
    hi = small_int_to_float(b >> 4);
  } else {  // kP4c, kOut
    lo = small_int_to_float(static_cast<int>((w & 0xF) ^ 8));
    hi = small_int_to_float(static_cast<int8_t>(w) & -16);
  }
}

// Sum of v over the block's threads in a fixed order (shuffles, then the
// warps in order); every thread gets it. `part` holds kWarps floats.
__device__ float block_sum(float v, float* part) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x / 32;
  __syncthreads();  // part may still be read from a previous call
  if (threadIdx.x % 32 == 0) part[warp] = v;
  __syncthreads();
  float total = 0.0f;
  for (int w = 0; w < kWarps; ++w) total += part[w];
  return total;
}

// x bf16 [B, K] into xs f32 [K][BT], rows b >= B zero; for the bias forms
// k >= K/2 times 1/16 (exact) and corr[b] = 8 * sum_{k < K/2} x[b][k].
template <int F, int BT>
__device__ void stage_x(const __nv_bfloat16* __restrict__ x, int B, int K,
                        float* xs, float* corr, float* part) {
  const int K2 = K / 2;
  for (int i = threadIdx.x; i < K * BT; i += kThreads) {
    const int k = i / BT, b = i % BT;
    float v = b < B ? __bfloat162float(x[static_cast<size_t>(b) * K + k])
                    : 0.0f;
    if constexpr (F == kP4c || F == kOut) {
      if (k >= K2) v *= 0.0625f;
    }
    xs[i] = v;
  }
  if constexpr (F == kP4c || F == kOut) {
    for (int b = 0; b < BT; ++b) {
      float v = 0.0f;
      if (b < B)
        for (int k = threadIdx.x; k < K2; k += kThreads)
          v += __bfloat162float(x[static_cast<size_t>(b) * K + k]);
      v = block_sum(v, part);
      if (threadIdx.x == 0) corr[b] = 8.0f * v;
    }
  }
}

// y = (x @ W) * s over input-major weights: w uint8 [K/2, N] (int4 forms)
// or int8 [K, N] (kS8), N a multiple of 16, w on 16 bytes.
template <int F, int BT>
__global__ void __launch_bounds__(kThreads)
    matvec_in(const __nv_bfloat16* __restrict__ x,
              const uint8_t* __restrict__ w, const float* __restrict__ s,
              float* __restrict__ y, int B, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;               // [K][BT]
  float* red = smem + K * BT;     // [kWarps][BT][kCols]
  __shared__ float corr[BT];
  __shared__ float part[kWarps];
  stage_x<F, BT>(x, B, K, xs, corr, part);
  __syncthreads();

  const int rows = F == kS8 ? K : K / 2;
  const int K2 = K / 2;
  const int group = threadIdx.x % kGroups;
  const int slice = threadIdx.x / kGroups;
  const int col0 = blockIdx.x * kCols + group * 16;
  float acc[BT][16];
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 16; ++j) acc[b][j] = 0.0f;

  if (col0 < N) {
    constexpr int kUnroll = unroll(BT);
    for (int r0 = slice; r0 < rows; r0 += kSlices * kUnroll) {
      uint4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kSlices;
        v[u] = r < rows ? __ldg(reinterpret_cast<const uint4*>(
                              w + static_cast<size_t>(r) * N + col0))
                        : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int r = r0 + u * kSlices;
        if (r >= rows) break;
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
        if constexpr (F == kS8) {
          float xr[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) xr[b] = xs[r * BT + b];
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const int8_t q =
                static_cast<int8_t>(words[j / 4] >> (8 * (j % 4)));
            const float f = small_int_to_float(q);
#pragma unroll
            for (int b = 0; b < BT; ++b) acc[b][j] = fmaf(xr[b], f, acc[b][j]);
          }
        } else {
          float xl[BT], xh[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            xl[b] = xs[r * BT + b];
            xh[b] = xs[(r + K2) * BT + b];
          }
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            float lo, hi;
            planes<F>((words[j / 4] >> (8 * (j % 4))) & 0xFFu, lo, hi);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              acc[b][j] = fmaf(xl[b], lo, acc[b][j]);
              acc[b][j] = fmaf(xh[b], hi, acc[b][j]);
            }
          }
        }
      }
    }
  }

  // The slices of one column group inside a warp are kGroups lanes apart.
#pragma unroll
  for (int b = 0; b < BT; ++b)
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int o = kGroups; o < 32; o <<= 1)
        acc[b][j] += __shfl_xor_sync(0xffffffffu, acc[b][j], o);
  const int warp = threadIdx.x / 32;
  if (threadIdx.x % 32 < kGroups) {
#pragma unroll
    for (int b = 0; b < BT; ++b)
#pragma unroll
      for (int j = 0; j < 16; ++j)
        red[(warp * BT + b) * kCols + group * 16 + j] = acc[b][j];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B * kCols; i += kThreads) {
    const int b = i / kCols, c = i % kCols;
    const int col = blockIdx.x * kCols + c;
    if (col >= N) continue;
    float v = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) v += red[(wi * BT + b) * kCols + c];
    if constexpr (F == kP4c) v -= corr[b];
    y[static_cast<size_t>(b) * N + col] = v * s[col];
  }
}

// y = (x @ W) * s over output-major weights, the bias form (kP4c's):
// wt uint8 [N, K/2], K/2 a multiple of 4, wt on 4 bytes.
template <int BT>
__global__ void __launch_bounds__(kThreads)
    matvec_out(const __nv_bfloat16* __restrict__ x,
               const uint8_t* __restrict__ wt, const float* __restrict__ s,
               float* __restrict__ y, int B, int K, int N) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;  // [K][BT]
  __shared__ float corr[BT];
  __shared__ float part[kWarps];
  stage_x<kOut, BT>(x, B, K, xs, corr, part);
  __syncthreads();

  const int K2 = K / 2;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int stride = gridDim.x * kWarps * kRowsPerWarp;
  for (int n0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp; n0 < N;
       n0 += stride) {
    float acc[kRowsPerWarp][BT];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < BT; ++b) acc[r][b] = 0.0f;
    for (int k0 = 4 * lane; k0 < K2; k0 += 128 * kOutSteps) {
      uint32_t v[kOutSteps][kRowsPerWarp];
#pragma unroll
      for (int t = 0; t < kOutSteps; ++t)
#pragma unroll
        for (int r = 0; r < kRowsPerWarp; ++r) {
          const int k = k0 + 128 * t;
          v[t][r] = (k < K2 && n0 + r < N)
                        ? __ldg(reinterpret_cast<const uint32_t*>(
                              wt + static_cast<size_t>(n0 + r) * K2 + k))
                        : 0u;
        }
#pragma unroll
      for (int t = 0; t < kOutSteps; ++t) {
        const int k = k0 + 128 * t;
        if (k >= K2) break;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float xl[BT], xh[BT];
#pragma unroll
          for (int b = 0; b < BT; ++b) {
            xl[b] = xs[(k + j) * BT + b];
            xh[b] = xs[(k + j + K2) * BT + b];
          }
#pragma unroll
          for (int r = 0; r < kRowsPerWarp; ++r) {
            float lo, hi;
            planes<kOut>((v[t][r] >> (8 * j)) & 0xFFu, lo, hi);
#pragma unroll
            for (int b = 0; b < BT; ++b) {
              acc[r][b] = fmaf(xl[b], lo, acc[r][b]);
              acc[r][b] = fmaf(xh[b], hi, acc[r][b]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
      for (int b = 0; b < BT; ++b)
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], o);
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
        for (int b = 0; b < BT; ++b)
          if (b < B && n0 + r < N)
            y[static_cast<size_t>(b) * N + n0 + r] =
                (acc[r][b] - corr[b]) * s[n0 + r];
    }
  }
}

// The block's share of the grid (row splits, column tiles): rows
// [k0, k1) of tile blockIdx.y.
struct Share {
  int k0, k1;
  const uint8_t* tile;  // wp + tile * bn
};

__device__ __forceinline__ Share share(const uint8_t* wp, int K2, int bn,
                                       int rows_per_block) {
  Share sh;
  sh.k0 = blockIdx.x * rows_per_block;
  sh.k1 = min(K2, sh.k0 + rows_per_block);
  sh.tile = wp + static_cast<size_t>(blockIdx.y) * bn;
  return sh;
}

// stream_bytes (kColumnSums): out f32 [bn], out[c] = sum over tiles j and
// rows k of wp[k, j bn + c]. _unpack_only_call (kUnpackSums): out f32 [2],
// out[0] the last tile's sum((w & 0xF) ^ 8) + sum(int8(w) & -16), plus
// sum(x) over x bf16 [xn], out[1] that sum(x); ints int64 [2] the last
// tile's two integer sums, so a check can hold them exactly. scratch:
// 64-bit, [0] the arrival counter, then the bn column sums or the (lo, hi)
// sums of each tile; zero before and after.
template <int R>
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const uint8_t* __restrict__ wp,
                  const __nv_bfloat16* __restrict__ x, int xn,
                  float* __restrict__ out, long long* __restrict__ ints,
                  unsigned long long* __restrict__ scratch, int K2, int N,
                  int bn, int rows_per_block) {
  __shared__ int red[kThreads * 16];
  __shared__ float part[kWarps];
  __shared__ bool last;
  __shared__ long long tail[2];
  const Share sh = share(wp, K2, bn, rows_per_block);
  const int groups = bn / 16;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int l = threadIdx.x / groups;
  const bool active = l < lanes;
  unsigned long long* sums = scratch + 1;

  int colsum[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) colsum[j] = 0;
  int lo = 0, hi = 0;
  if (active) {
    for (int k = sh.k0 + l; k < sh.k1; k += lanes * kReduceUnroll) {
      uint4 v[kReduceUnroll];
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        const int r = k + u * lanes;
        v[u] = r < sh.k1 ? __ldg(reinterpret_cast<const uint4*>(
                               sh.tile + static_cast<size_t>(r) * N + 16 * g))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < kReduceUnroll; ++u) {
        if (k + u * lanes >= sh.k1) break;
        const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const uint32_t byte = (words[j / 4] >> (8 * (j % 4))) & 0xFFu;
          if constexpr (R == kColumnSums) {
            colsum[j] += static_cast<int>(byte);
          } else {
            lo += static_cast<int>((byte & 0xF) ^ 8);
            hi += static_cast<int8_t>(byte) & -16;
          }
        }
      }
    }
  }

  if constexpr (R == kColumnSums) {
#pragma unroll
    for (int j = 0; j < 16; ++j) red[threadIdx.x * 16 + j] = colsum[j];
    __syncthreads();
    for (int c = threadIdx.x; c < bn; c += kThreads) {
      long long total = 0;
      for (int li = 0; li < lanes; ++li)
        total += red[(li * groups + c / 16) * 16 + c % 16];
      atomicAdd(&sums[c], static_cast<unsigned long long>(total));
    }
  } else {
    // Integer sums: exact in any order.
    for (int o = 16; o > 0; o >>= 1) {
      lo += __shfl_xor_sync(0xffffffffu, lo, o);
      hi += __shfl_xor_sync(0xffffffffu, hi, o);
    }
    if (threadIdx.x % 32 == 0) {
      atomicAdd(&sums[2 * blockIdx.y],
                static_cast<unsigned long long>(static_cast<long long>(lo)));
      atomicAdd(&sums[2 * blockIdx.y + 1],
                static_cast<unsigned long long>(static_cast<long long>(hi)));
    }
  }

  // The last block to arrive writes the result and zeroes the scratch.
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned long long blocks =
        static_cast<unsigned long long>(gridDim.x) * gridDim.y;
    last = atomicAdd(&scratch[0], 1ull) == blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if constexpr (R == kColumnSums) {
    for (int c = threadIdx.x; c < bn; c += kThreads)
      out[c] = static_cast<float>(
          static_cast<long long>(atomicExch(&sums[c], 0ull)));
  } else {
    const int tiles = gridDim.y;
    for (int i = threadIdx.x; i < 2 * tiles; i += kThreads) {
      const long long v = static_cast<long long>(atomicExch(&sums[i], 0ull));
      if (i >= 2 * (tiles - 1)) tail[i - 2 * (tiles - 1)] = v;
    }
    float xv = 0.0f;
    for (int i = threadIdx.x; i < xn; i += kThreads)
      xv += __bfloat162float(x[i]);
    const float xsum = block_sum(xv, part);  // its barriers publish tail
    if (threadIdx.x == 0) {
      out[0] = (static_cast<float>(tail[0]) + static_cast<float>(tail[1])) +
               xsum;
      out[1] = xsum;
      ints[0] = tail[0];
      ints[1] = tail[1];
    }
  }
  if (threadIdx.x == 0) atomicExch(&scratch[0], 0ull);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// dma_only: every block copies its rows of its tile into shared memory;
// out f32 [bn] = row 0 of the last tile, read back from the copy.
__global__ void __launch_bounds__(kThreads)
    copy_kernel(const uint8_t* __restrict__ wp, float* __restrict__ out,
                int K2, int N, int bn, int rows_per_block) {
  __shared__ __align__(16) uint8_t ring[kRing][kStageBytes];
  const Share sh = share(wp, K2, bn, rows_per_block);
  const int pieces_per_row = bn / 16;
  const int stage_rows = max(1, kStageBytes / bn);
  const int stages = (sh.k1 - sh.k0 + stage_rows - 1) / stage_rows;
  const bool writer = blockIdx.x == 0 && blockIdx.y == gridDim.y - 1;
  for (int st = 0; st < stages; ++st) {
    if (st >= kRing) cp_async_wait<kRing - 1>();  // stage st - kRing landed
    if (st == kRing) {
      __syncthreads();  // every thread's pieces of stage 0 have landed
      if (writer)
        for (int c = threadIdx.x; c < bn; c += kThreads)
          out[c] = static_cast<float>(ring[0][c]);
      __syncthreads();  // read before the slot is refilled
    }
    const int r0 = sh.k0 + st * stage_rows;
    const int nrows = min(stage_rows, sh.k1 - r0);
    uint8_t* slot = ring[st % kRing];
    for (int p = threadIdx.x; p < nrows * pieces_per_row; p += kThreads) {
      const int r = p / pieces_per_row, c = p % pieces_per_row;
      cp_async16(slot + r * bn + 16 * c,
                 sh.tile + static_cast<size_t>(r0 + r) * N + 16 * c);
    }
    cp_async_commit();
  }
  cp_async_wait<0>();
  if (stages <= kRing) {
    __syncthreads();
    if (writer)
      for (int c = threadIdx.x; c < bn; c += kThreads)
        out[c] = static_cast<float>(ring[0][c]);
  }
}

// Dynamic shared memory past 48 KB needs the kernel's attribute raised, once
// a device to each larger size (the attribute's limit is 227 KB less the
// kernel's static shared memory).
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, size_t* allowed) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] >= bytes) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess)
    allowed[dev] = bytes;
  else
    cudaGetLastError();  // a refused size (past 227 KB) is no sticky error
  return err;
}

template <int F, int BT>
cudaError_t launch_in(const __nv_bfloat16* x, const uint8_t* w,
                      const float* s, float* y, int B, int K, int N,
                      cudaStream_t stream) {
  static size_t allowed[64] = {};
  const size_t smem = sizeof(float) * (static_cast<size_t>(K) * BT +
                                       kWarps * BT * kCols);
  cudaError_t err = allow_smem(matvec_in<F, BT>, smem, allowed);
  if (err != cudaSuccess) return err;
  matvec_in<F, BT><<<(N + kCols - 1) / kCols, kThreads, smem, stream>>>(
      x, w, s, y, B, K, N);
  return cudaGetLastError();
}

template <int BT>
cudaError_t launch_out(const __nv_bfloat16* x, const uint8_t* w,
                       const float* s, float* y, int B, int K, int N,
                       int blocks, cudaStream_t stream) {
  static size_t allowed[64] = {};
  const size_t smem = sizeof(float) * static_cast<size_t>(K) * BT;
  cudaError_t err = allow_smem(matvec_out<BT>, smem, allowed);
  if (err != cudaSuccess) return err;
  const int need = (N + kWarps * kRowsPerWarp - 1) / (kWarps * kRowsPerWarp);
  matvec_out<BT><<<blocks < need ? blocks : need, kThreads, smem, stream>>>(
      x, w, s, y, B, K, N);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_form(int bt, const __nv_bfloat16* x, const uint8_t* w,
                        const float* s, float* y, int B, int K, int N,
                        int blocks, cudaStream_t stream) {
  if constexpr (F == kOut) {
    switch (bt) {
      case 1: return launch_out<1>(x, w, s, y, B, K, N, blocks, stream);
      case 2: return launch_out<2>(x, w, s, y, B, K, N, blocks, stream);
      case 4: return launch_out<4>(x, w, s, y, B, K, N, blocks, stream);
      default: return launch_out<8>(x, w, s, y, B, K, N, blocks, stream);
    }
  } else {
    switch (bt) {
      case 1: return launch_in<F, 1>(x, w, s, y, B, K, N, stream);
      case 2: return launch_in<F, 2>(x, w, s, y, B, K, N, stream);
      case 4: return launch_in<F, 4>(x, w, s, y, B, K, N, stream);
      default: return launch_in<F, 8>(x, w, s, y, B, K, N, stream);
    }
  }
}

}  // namespace

// The rows of x a matvec instance is built for: B rounded up to 1, 2, 4, 8.
static int rows_instance(int B) {
  return B <= 1 ? 1 : B <= 2 ? 2 : B <= 4 ? 4 : 8;
}

// form: kP4, kP4b, kP4c, kS8 (input-major w, N a multiple of 16, w on 16
// bytes) or kOut (w uint8 [N, K/2], K/2 a multiple of 4, w on 4 bytes).
// x: bf16 [B, K], 1 <= B <= 8, K even; s: f32 [N]; y: f32 [B, N]. All
// contiguous. blocks: kOut's persistent grid. Enqueues one launch on
// `stream`; returns its error, or cudaGetLastError() after it.
extern "C" int sea_qb_matvec(int form, const void* x, const void* w,
                             const void* s, void* y, int B, int K, int N,
                             int blocks, void* stream) {
  if (B < 1 || B > kMaxB || K < 2 || K % 2 || N < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bt = rows_instance(B);
  const auto* X = static_cast<const __nv_bfloat16*>(x);
  const auto* W = static_cast<const uint8_t*>(w);
  const auto* S = static_cast<const float*>(s);
  auto* Y = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (form == kOut ? (K / 2) % 4 != 0 : N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (form) {
    case kP4: return launch_form<kP4>(bt, X, W, S, Y, B, K, N, blocks, st);
    case kP4b: return launch_form<kP4b>(bt, X, W, S, Y, B, K, N, blocks, st);
    case kP4c: return launch_form<kP4c>(bt, X, W, S, Y, B, K, N, blocks, st);
    case kS8: return launch_form<kS8>(bt, X, W, S, Y, B, K, N, blocks, st);
    case kOut: return launch_form<kOut>(bt, X, W, S, Y, B, K, N, blocks, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// form: kColumnSums (stream_bytes), kUnpackSums (_unpack_only_call, x bf16
// [xn]) or kCopy (dma_only). wp: uint8 [K2, N] on 16 bytes, N a multiple
// of bn, bn a multiple of 16 and at most 4096. The grid is (ceil(K2 /
// rows_per_block), N / bn). scratch: zeroed 64-bit words, 1 + bn
// (kColumnSums) or 1 + 2 N / bn (kUnpackSums), left zeroed. out: f32 [bn]
// or, for kUnpackSums, [2] beside ints int64 [2] (null for the others).
extern "C" int sea_qb_stream(int form, const void* wp, const void* x, int xn,
                             void* out, void* ints, void* scratch, int K2,
                             int N, int bn, int rows_per_block,
                             void* stream) {
  if (K2 < 1 || bn < 16 || bn % 16 || bn > 4096 || N % bn ||
      rows_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K2 + rows_per_block - 1) / rows_per_block, N / bn);
  const auto* W = static_cast<const uint8_t*>(wp);
  const auto* X = static_cast<const __nv_bfloat16*>(x);
  auto* O = static_cast<float*>(out);
  auto* I = static_cast<long long*>(ints);
  auto* S = static_cast<unsigned long long*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kColumnSums:
      reduce_kernel<kColumnSums><<<grid, kThreads, 0, st>>>(
          W, X, xn, O, I, S, K2, N, bn, rows_per_block);
      break;
    case kUnpackSums:
      if (ints == nullptr) return static_cast<int>(cudaErrorInvalidValue);
      reduce_kernel<kUnpackSums><<<grid, kThreads, 0, st>>>(
          W, X, xn, O, I, S, K2, N, bn, rows_per_block);
      break;
    case kCopy:
      copy_kernel<<<grid, kThreads, 0, st>>>(W, O, K2, N, bn,
                                             rows_per_block);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
