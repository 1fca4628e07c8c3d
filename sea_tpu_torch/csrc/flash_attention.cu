// Flash attention for the teacher-forced training step: the forward (with
// the row log-sum-exp the backward needs), dQ, and dK/dV, with the
// attention-probability dropout hashed inside the kernels.
//
// Replaces the Pallas TPU kernels of sea_tpu/ops/flash_attention.py:
// _fwd_kernel (forward), _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK/dV).
// Semantics, f32 throughout (the forward's products on the tensor cores
// with f32 accuracy, below; never single-pass TF32):
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
// What bounds them: operations. At the training shapes (B=2, T=399, H=8,
// hd 128 and 64) the causal forward does about 2 B H T^2 hd multiply-adds
// over inputs of 3 B T H hd floats: ~100 operations per byte, far above
// what the card streams per operation in f32 outside the tensor cores.
//
// The forward (fwd_kernel) runs both products on the tensor cores. Its
// bound is the TF32 peak over three (3xTF32, below): ~165 TFLOP/s, which
// at hd 128 is about the time its bytes take.
//  - Q.K^T and P.V are warp-level mma.sync.m16n8k8.row.col.f32.tf32.tf32
//    .f32 with operands in registers, split 3xTF32: big = rna(x), small =
//    rna(x - big), acc += a_small b_big + a_big b_small + a_big b_big in
//    f32, each part sent to 4-8 accumulators in turn so that no mma.sync
//    waits for the one before it. rna is cvt.rna.tf32.f32 (to nearest,
//    ties away, 10 mantissa bits) done as two integer operations: sm_90
//    has no instruction for it, and ptxas expands the PTX cvt into a
//    longer sequence. The dropped small x small term and the roundings
//    leave ~2^-21 of each product, f32 accuracy (one TF32 pass keeps ~3
//    digits);
//  - one block of 4 warps per (bh, 64-row q tile), 16 query rows a warp,
//    looping over the in-band key tiles only (key_end): 64 keys a tile at
//    hd 64 and 128, 32 at hd 256;
//  - Q is copied once; K and V tiles go through a two-stage ring of
//    16-byte cp.async copies (commit_group / wait_group): tile j + 1 is in
//    flight while tile j is multiplied, its copies started a slice after
//    each 16 d of Q.K^T so that starting them overlaps the products.
//    Rows past T are zero-filled (src size 0). Every row must start on 16
//    bytes: the wrapper refuses a view whose start or strides are not
//    whole multiples of 4 floats;
//  - the softmax statistics live in the accumulator layout: a thread holds
//    rows g and g + 8 of its warp's 16 (g = lane / 4, t = lane % 4) and
//    reduces a row over the 4 lanes of its quad with two shuffles. Keys
//    are masked against a per-row limit, every exp is taken and masked by a
//    select, and dropout is one loop behind one uniform branch: a branch
//    per element serialised the exp latency;
//  - P stays in registers: S's accumulator fragment (rows g, g + 8; keys
//    2t, 2t + 1 of 8) is P.V's A fragment once the 8 keys are taken in the
//    order 0, 2, 4, 6, 1, 3, 5, 7, and V's rows are read in that order;
//  - fragments are read as float4: Q and K over 16 d (two k steps, d
//    4t, 4t + 1 and 4t + 2, 4t + 3), V over four output column tiles
//    (column n of tile 4J + i is d = 32J + 4n + i). Row strides of hd + 16
//    floats (Q, K) and hd + 4 (V) keep every such load free of bank
//    conflicts;
//  - the loop over d is not unrolled: with one warp per scheduler nothing
//    hides an instruction fetch, and the smaller loop measured faster;
//  - shared memory, Q plus two stages of K and V: 206 KB at hd 256,
//    178 KB at hd 128, 96 KB at hd 64 (two blocks an SM).
// Not wgmma or TMA yet: wgmma's tf32 form wants both shared-memory operands
// K-major, but P.V's V tile is [key][d] (the transposing forms are 16-bit
// only); 3xTF32 would stage the big and small halves of every shared
// operand; mma.sync takes registers, where the split is a few
// instructions. Each of the 4 warps splits the whole K and V tile for
// itself: those splits and their loads take about as long as the mma.sync.
// At (2, 399, 8, 128) the 112 blocks are under one wave of 132 SMs, and the
// last q tile walks all 7 key tiles alone: that serial walk is the
// kernel's time (splitting the key range is later work).
//
// dQ and dK/dV (dq_kernel, dkv_kernel) run their products as f32 FMAs on
// the CUDA cores, so their design minds shared memory traffic and the
// causal band:
//  - the TPU grid walked the in-band (q block, k block) pairs in order with
//    scratch carried between grid steps. Here a block owns one (bh, q tile)
//    for dQ, as for the forward, or one (bh, k tile) for dK/dV, keeps its
//    accumulator in registers and loops over the in-band tiles itself:
//    out-of-band tiles are never loaded, as with the TPU's band lists;
//  - 256 threads as 16 x 16; a thread owns rows ty*R.. and columns tx,
//    tx+16, ... of every tile product;
//  - tiles live in shared memory with a row stride of hd+1 floats, so the
//    16 column threads of a half warp read 16 different banks;
//  - inputs are read through their strides ([B, T, H, hd] with hd
//    contiguous): no transpose to [B*H, T, hd] in device memory.
// Their tiles are 64 x 64 for hd 8 to 128 and 32 x 32 for hd 256, which
// keeps every kernel inside the 227 KB of dynamic shared memory a block
// may use.
//
// Head dims 8 and 16 are the smoke presets' (cylinder_flow_smoke: E=32 over
// 2 heads, and the exchange at half that width). The forward takes them
// with the same mma.sync tiles, its fragments read one float at a time in
// the mma's k order (a float4 would span more d than the row holds); the
// backward's 16 column threads own d = tx + 16c as at any hd, and at hd 8
// half of them sit out the d products.
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

// Last key (exclusive) any query of the tile [q0, q0 + BQ) may see.
__device__ __forceinline__ int key_end(const Shape& s, int q0, int BQ) {
  return s.causal ? min(s.Tk, q0 + BQ + s.src_len) : s.Tk;
}

// ---------------------------------------------------------------------------
// Forward: tensor cores, 3xTF32, cp.async ring (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kFwdThreads = 128;  // 4 warps of 16 query rows
constexpr int kFwdBQ = 64;

// 16 bytes global -> shared, asynchronously; zeros when !valid (src size
// 0: nothing is read from src).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Part `part` of PARTS of the copy of rows [t0, t0 + ROWS) of one (b, h)
// into a tile of row stride LD, with cp.async; rows past T are zero.
template <int HD, int ROWS, int LD, int PARTS = 1>
__device__ __forceinline__ void load_tile_async(float* tile, const View& x,
                                                int b, int h, int t0, int T,
                                                int part = 0) {
  constexpr int kChunks = HD / 4, kStep = kFwdThreads / kChunks;
  constexpr int kPer = ROWS / kStep / PARTS;  // copies a thread, a part
  static_assert(kFwdThreads % kChunks == 0 && kPer * kStep * PARTS == ROWS,
                "tiling");
  const int r0 = threadIdx.x / kChunks, c = 4 * (threadIdx.x % kChunks);
  const float* src = x.row(b, t0 + r0, h) + c;
  float* dst = tile + r0 * LD + c;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int i = part * kPer + u;
    const bool ok = t0 + r0 + i * kStep < T;
    cp_async16(dst + i * kStep * LD, ok ? src + i * kStep * x.st : x.p, ok);
  }
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero, to 10 mantissa
// bits) for finite x, as two integer operations: sm_90 has no single
// instruction for it, and ptxas expands the PTX cvt into a longer sequence.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = big + small, each a tf32 value.
struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  const uint32_t big = to_tf32(x);
  return {big, to_tf32(x - __uint_as_float(big))};
}

// An A fragment of m16n8k8 (rows g, g+8 x k t, t+4), split.
struct FragA {
  uint32_t big[4], small[4];
};

__device__ __forceinline__ FragA split_a(float a0, float a1, float a2,
                                         float a3) {
  FragA f;
  const float a[4] = {a0, a1, a2, a3};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const Split x = split(a[i]);
    f.big[i] = x.big;
    f.small[i] = x.small;
  }
  return f;
}

// d += a b over one m16n8k8 tile: tf32 operands, f32 accumulator.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 3xTF32 into N accumulators, d[n] += a_small b_big + a_big b_small +
// a_big b_big with b = (b0[n], b1[n]), part by part across the N:
// consecutive mma.sync go to different accumulators, so none waits for
// the one before it.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const FragA& a,
                                           const Split (&b0)[N],
                                           const Split (&b1)[N]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.small, b0[n].big, b1[n].big);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.big, b0[n].small, b1[n].small);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a.big, b0[n].big, b1[n].big);
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Head dims 8 and 16 (kSmall) read fragments one float at a time in the
// mma's own k order, with row strides of hd + 4 floats.
template <int HD, int BK>
struct FwdTiles {
  static constexpr bool kSmall = HD < 32;
  // hd + 16 = 16 (mod 32) floats at hd >= 64; hd + 4 everywhere else
  static constexpr int kLdQK = kSmall ? HD + 4 : HD + 16;
  static constexpr int kLdV = HD + 4;
  static constexpr size_t kSmem =
      sizeof(float) * (kFwdBQ * kLdQK + 2 * BK * (kLdQK + kLdV));
  static_assert((HD == 8 || HD == 16 || HD % 64 == 0) && BK % 8 == 0,
                "tile shape");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

template <int HD, int BK>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel(View q, View k, View v, float* __restrict__ o,
           float* __restrict__ lse, Shape s) {
  constexpr int LQK = FwdTiles<HD, BK>::kLdQK, LV = FwdTiles<HD, BK>::kLdV;
  constexpr bool kSmall = FwdTiles<HD, BK>::kSmall;
  constexpr int NS = BK / 8;  // n tiles of S = k steps of P.V
  constexpr int NO = HD / 8;  // n tiles of O
  extern __shared__ __align__(16) float fwd_smem_base[];
  float* sQ = fwd_smem_base;
  float* sK = sQ + kFwdBQ * LQK;  // two stages
  float* sV = sK + 2 * BK * LQK;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const int q0 = blockIdx.x * kFwdBQ;
  const int n_tiles = (key_end(s, q0, kFwdBQ) + BK - 1) / BK;

  load_tile_async<HD, kFwdBQ, LQK>(sQ, q, b, h, q0, s.Tq);
  if (n_tiles > 0) {
    load_tile_async<HD, BK, LQK>(sK, k, b, h, 0, s.Tk);
    load_tile_async<HD, BK, LV>(sV, v, b, h, 0, s.Tk);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, row0 + 8
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lim[r] = qp >= s.Tq ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  const float* qa = sQ + (warp * 16 + g) * LQK + (kSmall ? t : 4 * t);
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile j (and Q) landed for every thread's copies
    const float* cK = sK + (j & 1) * BK * LQK;
    const float* cV = sV + (j & 1) * BK * LV;
    // Tile j + 1 goes into the other stage, a part after each 16 d of S,
    // so that starting the copies spreads over the products.
    const bool prefetch = j + 1 < n_tiles;
    float* nK = sK + ((j + 1) & 1) * BK * LQK;
    float* nV = sV + ((j + 1) & 1) * BK * LV;

    // S = Q K^T over 16 d at a time: two k steps, d 4t, 4t+1 | 4t+2, 4t+3.
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
    if constexpr (kSmall) {
      // One k step per 8 d, in the mma's own order: k t -> d t, t + 4.
#pragma unroll
      for (int d0 = 0; d0 < HD; d0 += 8) {
        Split b0[NS], b1[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          const float* y = cK + (n * 8 + g) * LQK + d0 + t;
          b0[n] = split(y[0]);
          b1[n] = split(y[4]);
        }
        mma_3xtf32(sc, split_a(qa[d0], qa[8 * LQK + d0], qa[d0 + 4],
                               qa[8 * LQK + d0 + 4]), b0, b1);
      }
      if (prefetch) {
        load_tile_async<HD, BK, LQK>(nK, k, b, h, k0 + BK, s.Tk);
        load_tile_async<HD, BK, LV>(nV, v, b, h, k0 + BK, s.Tk);
      }
    } else {
#pragma unroll 1
      for (int d0 = 0; d0 < HD; d0 += 16) {
        const float4 x0 = lds4(qa + d0), x1 = lds4(qa + 8 * LQK + d0);
        float4 y[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n)
          y[n] = lds4(cK + (n * 8 + g) * LQK + d0 + 4 * t);
        Split b0[NS], b1[NS];
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          b0[n] = split(y[n].x);
          b1[n] = split(y[n].y);
        }
        mma_3xtf32(sc, split_a(x0.x, x1.x, x0.y, x1.y), b0, b1);
#pragma unroll
        for (int n = 0; n < NS; ++n) {
          b0[n] = split(y[n].z);
          b1[n] = split(y[n].w);
        }
        mma_3xtf32(sc, split_a(x0.z, x1.z, x0.w, x1.w), b0, b1);
        if (prefetch) {
          load_tile_async<HD, BK, LQK, HD / 16>(nK, k, b, h, k0 + BK, s.Tk,
                                                d0 / 16);
          load_tile_async<HD, BK, LV, HD / 16>(nV, v, b, h, k0 + BK, s.Tk,
                                               d0 / 16);
        }
      }
    }
    if (prefetch) cp_async_commit();

    // Online softmax; sc[n][2r + e] is row row0 + 8r, key k0 + 8n + 2t + e.
    // No branch per element: every exp is taken and masked by a select.
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = kNegInf;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * r + e];
          x = k0 + 8 * n + 2 * t + e < lim[r] ? x * s.scale : kNegInf;
          mx = fmaxf(mx, x);
        }
      const float m_new = fmaxf(m[r], quad_max(mx));
      alpha[r] = expf(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[n][2 * r + e];
          const float p = expf(x - m[r]);
          x = k0 + 8 * n + 2 * t + e < lim[r] ? p : 0.f;
          psum[r] += x;
        }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        acc[c][2 * r] *= alpha[r];
        acc[c][2 * r + 1] *= alpha[r];
      }
    }
    if (s.dropout) {  // the denominator above summed the undropped p
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int n = 0; n < NS; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[n][2 * r + e] *= dropout_scale(s, bh, row0 + 8 * r,
                                              k0 + 8 * n + 2 * t + e);
    }

    // O += P V. k step n is S's n tile n with its keys taken as k = t ->
    // key 2t, k = t + 4 -> key 2t + 1, so P's A fragment is sc[n] as it
    // is. Column c of O's n tile 4J + i is d = 32J + 4c + i: one float4 of
    // a V row feeds four n tiles.
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA p = split_a(sc[n][0], sc[n][2], sc[n][1], sc[n][3]);
      if constexpr (kSmall) {  // column g of O's n tile c is d = 8c + g
        const float* v0 = cV + (n * 8 + 2 * t) * LV + g;
        Split b0[NO], b1[NO];
#pragma unroll
        for (int c = 0; c < NO; ++c) {
          b0[c] = split(v0[8 * c]);
          b1[c] = split(v0[LV + 8 * c]);
        }
        mma_3xtf32(acc, p, b0, b1);
      } else {
        const float* v0 = cV + (n * 8 + 2 * t) * LV + 4 * g;
#pragma unroll
        for (int J = 0; J < HD / 32; J += 2) {  // 8 n tiles of O at a time
          Split b0[8], b1[8];
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const float4 y0 = lds4(v0 + 32 * (J + u));
            const float4 y1 = lds4(v0 + LV + 32 * (J + u));
            const float c0[4] = {y0.x, y0.y, y0.z, y0.w};
            const float c1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              b0[4 * u + i] = split(c0[i]);
              b1[4 * u + i] = split(c1[i]);
            }
          }
          mma_3xtf32(acc + 4 * J, p, b0, b1);
        }
      }
    }
    __syncthreads();  // stage j & 1 is refilled at iteration j + 1
  }

  // acc[4J + i][2r + e] is row row0 + 8r, d = 32J + 8t + 4e + i.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
    float* out = o + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) * HD;
    if constexpr (kSmall) {  // acc[c][2r + e] is d = 8c + 2t + e
#pragma unroll
      for (int c = 0; c < NO; ++c)
        *reinterpret_cast<float2*>(out + 8 * c + 2 * t) =
            make_float2(acc[c][2 * r] / den, acc[c][2 * r + 1] / den);
    } else {
#pragma unroll
      for (int J = 0; J < HD / 32; ++J)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(out + 8 * t + 32 * J + 4 * e) =
              make_float4(acc[4 * J][2 * r + e] / den,
                          acc[4 * J + 1][2 * r + e] / den,
                          acc[4 * J + 2][2 * r + e] / den,
                          acc[4 * J + 3][2 * r + e] / den);
    }
    if (t == 0) lse[static_cast<long long>(bh) * s.Tq + qp] = m[r] + logf(den);
  }
}

// Whether column thread tx owns d = tx + 16c: always at hd % 16 == 0; at
// hd 8 the upper half of the 16 column threads idles in the d products.
template <int HD>
__device__ __forceinline__ bool has_col(int tx, int c) {
  return HD % 16 == 0 || tx + 16 * c < HD;
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, float* __restrict__ dq, Shape s) {
  constexpr int LD = HD + 1, LP = BK + 1;
  constexpr int RQ = BQ / 16, CK = BK / 16, CD = (HD + 15) / 16;
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
        if (!has_col<HD>(tx, c)) continue;
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
    for (int c = 0; c < CD; ++c)
      if (has_col<HD>(tx, c)) out[tx + 16 * c] = acc[i][c] * s.scale;
  }
}

template <int HD, int BQ, int BK>
__global__ void __launch_bounds__(kThreads)
dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, float* __restrict__ dk,
           float* __restrict__ dv, Shape s) {
  constexpr int LD = HD + 1, LP = BQ + 1;
  constexpr int RK = BK / 16, CQ = BQ / 16, CD = (HD + 15) / 16;
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
        if (!has_col<HD>(tx, c)) continue;
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
      if (!has_col<HD>(tx, c)) continue;
      dk[at + tx + 16 * c] = gk[i][c] * s.scale;
      dv[at + tx + 16 * c] = gv[i][c];
    }
  }
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

template <int HD, int BK>
int launch_fwd(View q, View k, View v, float* o, float* lse, Shape s,
               cudaStream_t stream) {
  constexpr size_t smem = FwdTiles<HD, BK>::kSmem;
  static const cudaError_t set = allow_smem(fwd_kernel<HD, BK>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s.Tq + kFwdBQ - 1) / kFwdBQ, s.B * s.H);
  fwd_kernel<HD, BK><<<grid, kFwdThreads, smem, stream>>>(q, k, v, o, lse, s);
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
// [B, T, H, hd], lse and dsum contiguous [B*H, Tq]. hd must be 8, 16, 64,
// 128 or 256. Each entry returns cudaGetLastError() after its launch (0 on
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
    case 8: return launch_fwd<8, 64>(Q, K, V, O, L, s, st);
    case 16: return launch_fwd<16, 64>(Q, K, V, O, L, s, st);
    case 64: return launch_fwd<64, 64>(Q, K, V, O, L, s, st);
    case 128: return launch_fwd<128, 64>(Q, K, V, O, L, s, st);
    case 256: return launch_fwd<256, 32>(Q, K, V, O, L, s, st);
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
    case 8: return launch_dq<8, 64, 64>(Q, K, V, dO, L, D, dQ, s, st);
    case 16: return launch_dq<16, 64, 64>(Q, K, V, dO, L, D, dQ, s, st);
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
    case 8: return launch_dkv<8, 64, 64>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 16: return launch_dkv<16, 64, 64>(Q, K, V, dO, L, D, dK, dV, s, st);
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
