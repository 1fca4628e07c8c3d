// Flash attention for the teacher-forced training step: the forward (with
// the row log-sum-exp the backward needs), dQ, and dK/dV, with the
// attention-probability dropout hashed inside the kernels.
//
// Replaces the Pallas TPU kernels of sea_tpu/ops/flash_attention.py:
// _fwd_kernel (forward), _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK/dV).
// Semantics, f32 throughout (no TF32):
//     s   = q . k^T * hd^-0.5, masked to k <= q + src_len when causal
//     p   = exp(s - m); the softmax denominator sums the UNdropped p
//     o   = sum_k p * M(bh, q, k) v / sum_k p,    lse = m + log(sum_k p)
// with M the {0, 1/(1-rate)} dropout scale; and, with D = rowsum(dO * o)
// computed by the caller (the JAX package computes it outside its kernels
// too),
//     P = exp(s - lse);  dS = P * (M * dO.v^T - D)
//     dQ = dS k * scale;  dK = dS^T q * scale;  dV = (P * M)^T dO.
//
// Dropout hash: murmur3-style mixing of (seed0, seed1, bh = b*H + h, global
// q position, global k position) in uint32 arithmetic, bit for bit the
// function of the TPU kernel (dropout_scale_from_positions), so the
// forward and both backward kernels, the plain PyTorch version and the
// JAX package all draw the same mask. The keep threshold and the scale
// are computed on the host.
//
// What bounds it: operations. At the training shapes (B=2, T=399, H=8,
// hd 128 and 64) the causal forward does about 2 B H T^2 hd multiply-adds
// over inputs of 3 B T H hd floats: ~100 operations per byte, far above
// what the card streams per operation in f32 outside the tensor cores.
// This first version runs those operations as f32 FMAs on the CUDA cores
// (tensor cores, TMA and bf16 come later), so the design minds shared
// memory traffic and the causal band:
//  - the TPU grid walked the in-band (q block, k block) pairs in order with
//    scratch carried between grid steps. Here a block owns one (bh, q tile)
//    for the forward and dQ, or one (bh, k tile) for dK/dV, keeps its
//    accumulator in registers and loops over the in-band tiles itself:
//    out-of-band tiles are never loaded, as with the TPU's band lists;
//  - 256 threads as 16 x 16; a thread owns rows ty*R.. and columns tx,
//    tx+16, ... of every tile product, so a row's statistics reduce over the
//    16 lanes of half a warp with shuffles;
//  - tiles live in shared memory with a row stride of hd+1 floats, so the
//    16 column threads of a half warp read 16 different banks;
//  - inputs are read through their strides ([B, T, H, hd] with hd
//    contiguous): no transpose to [B*H, T, hd] in device memory.
// Tiles are 64 x 64 for hd 64 and 128 and 32 x 32 for hd 256, which keeps
// every kernel inside the 227 KB of dynamic shared memory a block may use.
//
// The dense dropout mask (dropout_mask_kernel) replaces the Pallas TPU
// kernel _mask_kernel (via _dropout_mask_dense), the oracle of the dropout
// verification: it writes the f32 scale M(bh_map[bh], q, k) of every
// element of [BH, Tq, Tk], one thread per element, through the same
// dropout_scale the flash kernels call, so it equals their mask by
// construction. It is bound by the bytes it writes (4 per element; the
// hash is ~20 integer operations). It writes the logical [BH, Tq, Tk]
// region only, not the TPU kernel's padding to block multiples.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr float kNegInf = -1e30f;  // finite: no NaN from (-inf) - (-inf)

struct View {  // a [B, T, H, hd] f32 tensor with hd contiguous
  const float* p;
  long long sb, st, sh;
  __device__ const float* row(int b, int t, int h) const {
    return p + b * sb + t * st + h * sh;
  }
};

struct Shape {
  int B, H, Tq, Tk, causal, src_len;
  float scale;
  unsigned seed0, seed1, threshold;
  float inv_keep;
  int dropout;
};

__device__ __forceinline__ float dropout_scale(const Shape& s, unsigned bh,
                                               unsigned q, unsigned k) {
  unsigned x = q * 0x9E3779B9u + k * 0x3243F6A9u + bh * 0x27D4EB2Fu +
               s.seed0 * 0x165667B1u + s.seed1;
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 16; x *= 0xC2B2AE35u;
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 16; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= s.threshold ? s.inv_keep : 0.f;
}

__device__ __forceinline__ bool in_band(const Shape& s, int q, int k) {
  return q < s.Tq && k < s.Tk && (!s.causal || k <= q + s.src_len);
}

// rows [t0, t0 + ROWS) of one (b, h) into a tile of stride HD + 1; rows
// past T are zero.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(float* tile, const View& x, int b,
                                          int h, int t0, int T) {
  constexpr int LD = HD + 1;
  for (int e = threadIdx.x; e < ROWS * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, t = t0 + r;
    tile[r * LD + d] = t < T ? __ldg(x.row(b, t, h) + d) : 0.f;
  }
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Last key (exclusive) any query of the tile [q0, q0 + BQ) may see.
__device__ __forceinline__ int key_end(const Shape& s, int q0, int BQ) {
  return s.causal ? min(s.Tk, q0 + BQ + s.src_len) : s.Tk;
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
fwd_kernel(View q, View k, View v, float* __restrict__ o,
           float* __restrict__ lse, Shape s) {
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * LD;
  float* sV = sK + BK * LD;
  float* sP = sV + BK * LD;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int q0 = blockIdx.x * BQ;

  load_tile<HD, BQ>(sQ, q, b, h, q0, s.Tq);
  float m[RQ], l[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(s, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // the previous tile's sK, sV and sP are consumed
    load_tile<HD, BK>(sK, k, b, h, k0, s.Tk);
    load_tile<HD, BK>(sV, v, b, h, k0, s.Tk);
    __syncthreads();

    float sc[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = sQ[(ty * RQ + i) * LD + d];
#pragma unroll
      for (int j = 0; j < CK; ++j) kv[j] = sK[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, qp = q0 + r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const bool ok = in_band(s, qp, k0 + tx + 16 * j);
        sc[i][j] = ok ? sc[i][j] * s.scale : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p = in_band(s, qp, kp) ? expf(sc[i][j] - m_new) : 0.f;
        psum += p;
        sP[r * LP + tx + 16 * j] =
            s.dropout ? p * dropout_scale(s, bh, qp, kp) : p;
      }
      l[i] = l[i] * alpha + half_warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = sP[(ty * RQ + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float vv = sV[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t >= s.Tq) continue;
    const float den = l[i] == 0.f ? 1.f : l[i];
    float* out = o + ((static_cast<long long>(b) * s.Tq + t) * s.H + h) * HD;
#pragma unroll
    for (int c = 0; c < CD; ++c) out[tx + 16 * c] = acc[i][c] / den;
    if (tx == 0) lse[static_cast<long long>(bh) * s.Tq + t] = m[i] + logf(den);
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, float* __restrict__ dq, Shape s) {
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sO = sQ + BQ * LD;  // dO
  float* sK = sO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int q0 = blockIdx.x * BQ;

  load_tile<HD, BQ>(sQ, q, b, h, q0, s.Tq);
  load_tile<HD, BQ>(sO, dout, b, h, q0, s.Tq);
  float row_lse[RQ], row_d[RQ], acc[RQ][CD];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    const long long at = static_cast<long long>(bh) * s.Tq + t;
    row_lse[i] = t < s.Tq ? lse[at] : 0.f;
    row_d[i] = t < s.Tq ? dsum[at] : 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const int k_end = key_end(s, q0, BQ);
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_tile<HD, BK>(sK, k, b, h, k0, s.Tk);
    load_tile<HD, BK>(sV, v, b, h, k0, s.Tk);
    __syncthreads();

    float sc[RQ][CK], dp[RQ][CK];
#pragma unroll
    for (int i = 0; i < RQ; ++i)
#pragma unroll
      for (int j = 0; j < CK; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], ov[RQ], kv[CK], vv[CK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
        qv[i] = sQ[(ty * RQ + i) * LD + d];
        ov[i] = sO[(ty * RQ + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        kv[j] = sK[(tx + 16 * j) * LD + d];
        vv[j] = sV[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RQ; ++i)
#pragma unroll
        for (int j = 0; j < CK; ++j) {
          sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int r = ty * RQ + i, qp = q0 + r;
#pragma unroll
      for (int j = 0; j < CK; ++j) {
        const int kp = k0 + tx + 16 * j;
        const float p =
            in_band(s, qp, kp) ? expf(sc[i][j] * s.scale - row_lse[i]) : 0.f;
        const float mk = s.dropout ? dropout_scale(s, bh, qp, kp) : 1.f;
        sS[r * LP + tx + 16 * j] = p * (dp[i][j] * mk - row_d[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) dsv[i] = sS[(ty * RQ + i) * LP + kk];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float kv = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RQ; ++i) acc[i][c] = fmaf(dsv[i], kv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int t = q0 + ty * RQ + i;
    if (t >= s.Tq) continue;
    float* out = dq + ((static_cast<long long>(b) * s.Tq + t) * s.H + h) * HD;
#pragma unroll
    for (int c = 0; c < CD; ++c) out[tx + 16 * c] = acc[i][c] * s.scale;
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, float* __restrict__ dk,
           float* __restrict__ dv, Shape s) {
  constexpr int LD = HD + 1, LP = BQ + 1;
  constexpr int RK = BK / 16, CQ = BQ / 16, CD = HD / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sO = sQ + BQ * LD;   // dO
  float* sP = sO + BQ * LD;   // (P * M)^T, [BK, BQ]
  float* sS = sP + BK * LP;   // dS^T, [BK, BQ]
  float* sL = sS + BK * LP;   // lse of the q tile
  float* sD = sL + BQ;        // D of the q tile
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int k0 = blockIdx.x * BK;

  load_tile<HD, BK>(sK, k, b, h, k0, s.Tk);
  load_tile<HD, BK>(sV, v, b, h, k0, s.Tk);
  float gk[RK][CD], gv[RK][CD];
#pragma unroll
  for (int i = 0; i < RK; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) gk[i][c] = gv[i][c] = 0.f;

  // First query that may see key k0: keys above the band get no gradient.
  const int q_first = s.causal ? max(0, k0 - s.src_len) : 0;
  for (int q0 = (q_first / BQ) * BQ; q0 < s.Tq; q0 += BQ) {
    __syncthreads();
    load_tile<HD, BQ>(sQ, q, b, h, q0, s.Tq);
    load_tile<HD, BQ>(sO, dout, b, h, q0, s.Tq);
    if (threadIdx.x < BQ) {
      const int t = q0 + threadIdx.x;
      const long long at = static_cast<long long>(bh) * s.Tq + t;
      sL[threadIdx.x] = t < s.Tq ? lse[at] : 0.f;
      sD[threadIdx.x] = t < s.Tq ? dsum[at] : 0.f;
    }
    __syncthreads();

    float sc[RK][CQ], dp[RK][CQ];
#pragma unroll
    for (int i = 0; i < RK; ++i)
#pragma unroll
      for (int j = 0; j < CQ; ++j) sc[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float kv[RK], vv[RK], qv[CQ], ov[CQ];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        kv[i] = sK[(ty * RK + i) * LD + d];
        vv[i] = sV[(ty * RK + i) * LD + d];
      }
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        qv[j] = sQ[(tx + 16 * j) * LD + d];
        ov[j] = sO[(tx + 16 * j) * LD + d];
      }
#pragma unroll
      for (int i = 0; i < RK; ++i)
#pragma unroll
        for (int j = 0; j < CQ; ++j) {
          sc[i][j] = fmaf(kv[i], qv[j], sc[i][j]);
          dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < RK; ++i) {
      const int r = ty * RK + i, kp = k0 + r;
#pragma unroll
      for (int j = 0; j < CQ; ++j) {
        const int c = tx + 16 * j, qp = q0 + c;
        const float p =
            in_band(s, qp, kp) ? expf(sc[i][j] * s.scale - sL[c]) : 0.f;
        const float mk = s.dropout ? dropout_scale(s, bh, qp, kp) : 1.f;
        sP[r * LP + c] = p * mk;
        sS[r * LP + c] = p * (dp[i][j] * mk - sD[c]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int qq = 0; qq < BQ; ++qq) {
      float pm[RK], ds[RK];
#pragma unroll
      for (int i = 0; i < RK; ++i) {
        pm[i] = sP[(ty * RK + i) * LP + qq];
        ds[i] = sS[(ty * RK + i) * LP + qq];
      }
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const float ov = sO[qq * LD + tx + 16 * c];
        const float qv = sQ[qq * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < RK; ++i) {
          gv[i][c] = fmaf(pm[i], ov, gv[i][c]);
          gk[i][c] = fmaf(ds[i], qv, gk[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RK; ++i) {
    const int t = k0 + ty * RK + i;
    if (t >= s.Tk) continue;
    const long long at = ((static_cast<long long>(b) * s.Tk + t) * s.H + h) * HD;
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      dk[at + tx + 16 * c] = gk[i][c] * s.scale;
      dv[at + tx + 16 * c] = gv[i][c];
    }
  }
}

template <int HD, int BQ, int BK>
constexpr size_t fwd_smem() {
  return sizeof(float) * ((BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1));
}
template <int HD, int BQ, int BK>
constexpr size_t dq_smem() {
  return sizeof(float) * ((2 * BQ + 2 * BK) * (HD + 1) + BQ * (BK + 1));
}
template <int HD, int BQ, int BK>
constexpr size_t dkv_smem() {
  return sizeof(float) *
         ((2 * BK + 2 * BQ) * (HD + 1) + 2 * BK * (BQ + 1) + 2 * BQ);
}

// Raise the kernel's dynamic shared memory limit once per instantiation.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int HD, int BQ, int BK>
int launch_fwd(View q, View k, View v, float* o, float* lse, Shape s,
               cudaStream_t stream) {
  constexpr size_t smem = fwd_smem<HD, BQ, BK>();
  static const cudaError_t set = allow_smem(fwd_kernel<HD, BQ, BK>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s.Tq + BQ - 1) / BQ, s.B * s.H);
  fwd_kernel<HD, BQ, BK><<<grid, kThreads, smem, stream>>>(q, k, v, o, lse,
                                                           s);
  return cudaGetLastError();
}

template <int HD, int BQ, int BK>
int launch_dq(View q, View k, View v, View dout, const float* lse,
              const float* dsum, float* dq, Shape s, cudaStream_t stream) {
  constexpr size_t smem = dq_smem<HD, BQ, BK>();
  static const cudaError_t set = allow_smem(dq_kernel<HD, BQ, BK>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s.Tq + BQ - 1) / BQ, s.B * s.H);
  dq_kernel<HD, BQ, BK><<<grid, kThreads, smem, stream>>>(q, k, v, dout, lse,
                                                          dsum, dq, s);
  return cudaGetLastError();
}

template <int HD, int BQ, int BK>
int launch_dkv(View q, View k, View v, View dout, const float* lse,
               const float* dsum, float* dk, float* dv, Shape s,
               cudaStream_t stream) {
  constexpr size_t smem = dkv_smem<HD, BQ, BK>();
  static const cudaError_t set = allow_smem(dkv_kernel<HD, BQ, BK>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s.Tk + BK - 1) / BK, s.B * s.H);
  dkv_kernel<HD, BQ, BK><<<grid, kThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, dk, dv, s);
  return cudaGetLastError();
}

Shape make_shape(int B, int H, int Tq, int Tk, int hd, int causal,
                 int src_len, unsigned seed0, unsigned seed1,
                 unsigned threshold, float inv_keep, int dropout) {
  Shape s;
  s.B = B; s.H = H; s.Tq = Tq; s.Tk = Tk; s.causal = causal;
  s.src_len = src_len;
  s.scale = 1.f / sqrtf(static_cast<float>(hd));
  s.seed0 = seed0; s.seed1 = seed1; s.threshold = threshold;
  s.inv_keep = inv_keep; s.dropout = dropout;
  return s;
}

View view(const void* p, long long sb, long long st, long long sh) {
  View x;
  x.p = static_cast<const float*>(p);
  x.sb = sb; x.st = st; x.sh = sh;
  return x;
}

// out[bh, q, k] = M(bh_map[bh], q, k), flat over [BH, Tq, Tk].
__global__ void __launch_bounds__(kThreads)
dropout_mask_kernel(const int* __restrict__ bh_map, float* __restrict__ out,
                    int Tq, int Tk, long long total, Shape s) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       e < total; e += stride) {
    const int kk = static_cast<int>(e % Tk);
    const long long r = e / Tk;
    const int qq = static_cast<int>(r % Tq);
    const int bh = static_cast<int>(r / Tq);
    out[e] = dropout_scale(s, static_cast<unsigned>(__ldg(bh_map + bh)),
                           static_cast<unsigned>(qq),
                           static_cast<unsigned>(kk));
  }
}

}  // namespace

// Tensors are f32 [B, T, H, hd] with hd contiguous, given by pointer and
// (batch, time, head) strides in elements; o/dq/dk/dv are contiguous
// [B, T, H, hd], lse and dsum contiguous [B*H, Tq]. hd must be 64, 128
// or 256. Each entry returns cudaGetLastError() after its launch (0 on
// success); an unsupported hd returns cudaErrorInvalidValue.
#define SEA_FLASH_ARGS                                                    \
  int B, int H, int Tq, int Tk, int hd, int causal, int src_len,          \
      unsigned seed0, unsigned seed1, unsigned threshold, float inv_keep, \
      int dropout, void* stream
#define SEA_FLASH_SHAPE                                                  \
  make_shape(B, H, Tq, Tk, hd, causal, src_len, seed0, seed1, threshold, \
             inv_keep, dropout)

extern "C" int sea_flash_fwd(const void* q, long long qsb, long long qst,
                             long long qsh, const void* k, long long ksb,
                             long long kst, long long ksh, const void* v,
                             long long vsb, long long vst, long long vsh,
                             void* o, void* lse, SEA_FLASH_ARGS) {
  const View Q = view(q, qsb, qst, qsh), K = view(k, ksb, kst, ksh),
             V = view(v, vsb, vst, vsh);
  const Shape s = SEA_FLASH_SHAPE;
  float* O = static_cast<float*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_fwd<64, 64, 64>(Q, K, V, O, L, s, st);
    case 128: return launch_fwd<128, 64, 64>(Q, K, V, O, L, s, st);
    case 256: return launch_fwd<256, 32, 32>(Q, K, V, O, L, s, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int sea_flash_bwd_dq(
    const void* q, long long qsb, long long qst, long long qsh,
    const void* k, long long ksb, long long kst, long long ksh,
    const void* v, long long vsb, long long vst, long long vsh,
    const void* dout, long long osb, long long ost, long long osh,
    const void* lse, const void* dsum, void* dq, SEA_FLASH_ARGS) {
  const View Q = view(q, qsb, qst, qsh), K = view(k, ksb, kst, ksh),
             V = view(v, vsb, vst, vsh), dO = view(dout, osb, ost, osh);
  const Shape s = SEA_FLASH_SHAPE;
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(dsum);
  float* dQ = static_cast<float*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dq<64, 64, 64>(Q, K, V, dO, L, D, dQ, s, st);
    case 128: return launch_dq<128, 64, 64>(Q, K, V, dO, L, D, dQ, s, st);
    case 256: return launch_dq<256, 32, 32>(Q, K, V, dO, L, D, dQ, s, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int sea_flash_bwd_dkv(
    const void* q, long long qsb, long long qst, long long qsh,
    const void* k, long long ksb, long long kst, long long ksh,
    const void* v, long long vsb, long long vst, long long vsh,
    const void* dout, long long osb, long long ost, long long osh,
    const void* lse, const void* dsum, void* dk, void* dv, SEA_FLASH_ARGS) {
  const View Q = view(q, qsb, qst, qsh), K = view(k, ksb, kst, ksh),
             V = view(v, vsb, vst, vsh), dO = view(dout, osb, ost, osh);
  const Shape s = SEA_FLASH_SHAPE;
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(dsum);
  float* dK = static_cast<float*>(dk);
  float* dV = static_cast<float*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 64: return launch_dkv<64, 64, 64>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 128:
      return launch_dkv<128, 64, 64>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 256:
      return launch_dkv<256, 32, 32>(Q, K, V, dO, L, D, dK, dV, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// bh_map: int32 [BH], the global (b*H + h) each row hashes with; out: f32
// [BH, Tq, Tk] contiguous. Returns cudaGetLastError() after the launch.
extern "C" int sea_dropout_mask(const void* bh_map, void* out, int BH, int Tq,
                                int Tk, unsigned seed0, unsigned seed1,
                                unsigned threshold, float inv_keep,
                                void* stream) {
  const Shape s = make_shape(BH, 1, Tq, Tk, 64, 0, 0, seed0, seed1, threshold,
                             inv_keep, 1);
  const long long total = static_cast<long long>(BH) * Tq * Tk;
  if (total <= 0) return static_cast<int>(cudaSuccess);
  const long long blocks = (total + kThreads - 1) / kThreads;
  const unsigned grid = static_cast<unsigned>(blocks < 65536 ? blocks : 65536);
  dropout_mask_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(bh_map), static_cast<float*>(out), Tq, Tk, total,
      s);
  return static_cast<int>(cudaGetLastError());
}
