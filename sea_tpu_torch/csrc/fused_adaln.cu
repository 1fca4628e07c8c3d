// Fused AdaLN modulate for the training step: the forward and the backward,
// one launch a call each.
//
// Replaces sea_tpu/ops/fused_adaln.py::_fwd_kernel (:46) and ::_bwd_kernel
// (:62), the Pallas TPU kernels, together with the sums over trajectories
// that the JAX package's VJP (_vjp_bwd) adds after the backward. For x
// [B, T, E] (f32, bf16 or f16), time-constant cond cw, cb [B, 1, E] and base
// w, b [E] (one parameter dtype: f32, bf16 or f16):
//     forward   out = xhat * a + c, in x's dtype,
//     backward  dx = rstd (g a - mean(g a) - xhat mean(g a xhat)), in x's
//               dtype; dcw[b] = sum_t g xhat, dcb[b] = sum_t g,
//               dw = sum_b dcw[b], db = sum_b dcb[b], all f32,
// per row xhat = (x - mean) rstd, rstd = 1 / sqrt(var + eps), with f32
// statistics, and a = w + cw, c = b + cb rounded in the parameter dtype
// before they are widened, as the TPU kernel does.
//
// What bounds them: bytes. A row is a normalisation and an affine, a few
// operations per element read: the forward streams x in and out once, the
// backward reads x and g and writes dx once. At the train step's shapes
// ((2, 399, 1024) and (2, 399, 512) f32) that is 3.3-9.8 MB, 1-3 us at the
// card's memory rate, so the launch, the memory latency and the
// cross-block sums set the time. The design therefore:
//  - gives a row to one warp (wpr warps for rows over 32 x 32 elements):
//    each thread holds n elements of x (and g) in registers, read as
//    16-byte vectors where E and the pointers allow, else one element at
//    a time; the row's sums are warp shuffles, with no block barrier a
//    row (a row over several warps meets at its own named barrier);
//  - fills the card with rows in flight: a block of 8 warps takes a
//    contiguous run of one trajectory's rows, its row groups every
//    (8 / wpr)-th of them, and each group loads its next row before it
//    computes the current one; the grid (ops/fused_adaln.adaln_plan) is
//    one wave of the card's blocks, a function of (B, T, E, dtype) and the
//    card only, so a CUDA graph can replay it. Each block asks for its
//    first rows, then for a = w + cw (and c = b + cb), which it keeps in
//    shared memory (asked for first, or landed before the rows were asked
//    for, the parameters' few lines still arrived last and the calls took
//    longer: chip_adaln_probe.py, PERF.md);
//  - finishes the backward's column sums inside the same launch, in a
//    fixed order (two calls give the same bits; no float atomics): each
//    thread sums g xhat and g over its rows for its columns in its row
//    group's shared memory; the block adds its groups in group order; the
//    blocks of a thread-block cluster (up to 8, the portable size) then
//    sum across the cluster over distributed shared memory: rank s owns
//    columns [s L, (s + 1) L), and every rank pushes its sums of those
//    columns into rank s's shared memory, which adds them in rank order
//    after one cluster barrier and writes the cluster's partial to a
//    scratch [B, clusters, 2, E]. Per column slice an arrival counter
//    finds the last of the B x clusters partials to be written; that
//    block sums the slice's partials, each trajectory's in cluster order
//    into dcw / dcb and those in trajectory order into dw / db. The
//    counter is reset by its last arrival, so the next call (or a graph
//    replay) finds it at 0. The cluster spreads the finish over 8 blocks
//    and cuts the partials it reads eightfold: one block reading every
//    block's partials would stream ~0.5 MB from L2 on one SM at
//    (2, 399, 1024).
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

// The same constants stand in ops/fused_adaln.py.
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxCluster = 8;
constexpr int kMaxE = 16384;
constexpr int kClusterMaxE = 8192;
// Partials the backward's finish loads before it adds them.
constexpr int kBatch = 16;

// The element types of x (and of out, g and dx), by kind 0, 1, 2.
struct F32 {
  using Raw = float;
  static constexpr int kVec = 4;  // elements a 16-byte load
  __device__ static float load(Raw r) { return r; }
  __device__ static Raw store(float v) { return v; }
};

struct BF16 {
  using Raw = unsigned short;  // bf16 bits
  static constexpr int kVec = 8;
  __device__ static float load(Raw r) {
    return __uint_as_float(static_cast<unsigned>(r) << 16);
  }
  __device__ static Raw store(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

struct F16 {
  using Raw = unsigned short;  // f16 bits
  static constexpr int kVec = 8;
  __device__ static float load(Raw r) {
    return __half2float(__ushort_as_half(r));
  }
  __device__ static Raw store(float v) {
    return __half_as_ushort(__float2half_rn(v));
  }
};

// A parameter element of kind 0 (f32), 1 (bf16) or 2 (f16), widened, and
// a float rounded to that kind and widened again.
__device__ __forceinline__ float load_param(const void* p, size_t i,
                                            int kind) {
  if (kind == 1)
    return BF16::load(static_cast<const unsigned short*>(p)[i]);
  if (kind == 2)
    return F16::load(static_cast<const unsigned short*>(p)[i]);
  return static_cast<const float*>(p)[i];
}

__device__ __forceinline__ float round_param(float v, int kind) {
  if (kind == 1) return BF16::load(BF16::store(v));
  if (kind == 2) return F16::load(F16::store(v));
  return v;
}

// One thread's share of a row: N elements as K = N / VEC loads of VEC
// elements; load k covers columns [c, c + VEC), c = (k tpr + j) VEC, for
// thread j of the tpr threads of the row. A load past E reads nothing and
// holds zeros (E is a multiple of VEC on the vector path).
template <typename Xt, int VEC, int N>
struct Slice {
  using Raw = typename Xt::Raw;
  static constexpr int K = N / VEC;
  using Word = std::conditional_t<VEC == 1, Raw, uint4>;
  static_assert(N % VEC == 0, "whole vectors");
  static_assert(VEC == 1 || VEC * sizeof(Raw) == 16, "16-byte vectors");
  Word w[K];

  __device__ __forceinline__ void load(const Raw* __restrict__ row, int j,
                                       int tpr, int E) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c = (k * tpr + j) * VEC;
      if (c < E)
        w[k] = __ldg(reinterpret_cast<const Word*>(row + c));
      else
        w[k] = Word{};
    }
  }

  __device__ __forceinline__ void to_float(float (&f)[N]) const {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if constexpr (VEC == 1) {
        f[k] = Xt::load(w[k]);
      } else {
        union {
          uint4 u;
          Raw r[VEC];
        } t;
        t.u = w[k];
#pragma unroll
        for (int v = 0; v < VEC; ++v) f[k * VEC + v] = Xt::load(t.r[v]);
      }
    }
  }
};

// VEC floats of shared memory at p (16-byte aligned when VEC % 4 == 0).
template <int VEC>
__device__ __forceinline__ void load_sm(const float* p, float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(p + i);
      v[i] = t.x;
      v[i + 1] = t.y;
      v[i + 2] = t.z;
      v[i + 3] = t.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = p[i];
  }
}

template <int VEC>
__device__ __forceinline__ void store_sm(float* p, const float* v) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int i = 0; i < VEC; i += 4)
      *reinterpret_cast<float4*>(p + i) =
          make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) p[i] = v[i];
  }
}

// VEC floats of v stored at row + c in x's type.
template <typename Xt, int VEC>
__device__ __forceinline__ void store_row(typename Xt::Raw* __restrict__ p,
                                          const float* v) {
  using Raw = typename Xt::Raw;
  if constexpr (VEC == 1) {
    *p = Xt::store(v[0]);
  } else {
    union {
      uint4 u;
      Raw r[VEC];
    } t;
#pragma unroll
    for (int i = 0; i < VEC; ++i) t.r[i] = Xt::store(v[i]);
    *reinterpret_cast<uint4*>(p) = t.u;
  }
}

// The sums of v[0..M) over the threads of a row: a butterfly of shuffles
// inside the warp (every lane ends with the same bits), then, for a row
// over wpr warps, the warps' sums in warp order through `red` behind the
// row group's named barrier (id 1 + group). `red` has two slots of
// [kWarps groups][kWarps warps][2]; consecutive sums alternate between
// them, so a slot is rewritten only after every warp has passed the
// barrier of the sum that followed its last reading.
template <int M>
__device__ __forceinline__ void row_sum(float (&v)[M], float* red, int& slot,
                                        int group, int wig, int wpr,
                                        int lane) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int m = 0; m < M; ++m) v[m] += __shfl_xor_sync(0xffffffffu, v[m], o);
  if (wpr == 1) return;
  float* s = red + (slot * kWarps + group) * kWarps * 2;
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < M; ++m) s[wig * 2 + m] = v[m];
  asm volatile("bar.sync %0, %1;\n" ::"r"(group + 1), "r"(wpr * 32)
               : "memory");
#pragma unroll
  for (int m = 0; m < M; ++m) {
    v[m] = 0.f;
    for (int w = 0; w < wpr; ++w) v[m] += s[w * 2 + m];
  }
  slot ^= 1;
}

// Four interleaved chains of a thread's partial sums, added at the end in
// a fixed order: four adds in flight where one chain has one.
__device__ __forceinline__ float sum4(const float (&c)[4]) {
  return (c[0] + c[1]) + (c[2] + c[3]);
}

__host__ __device__ constexpr int align4(int n) { return (n + 3) & ~3; }

struct FwdArgs {
  const void* x;
  const void* cw;
  const void* cb;
  const void* w;
  const void* b;
  void* out;
  int T, E, wpr, p_kind;
  float eps;
};

struct BwdArgs {
  const void* x;
  const void* cw;
  const void* g;
  const void* w;
  void* dx;
  float* dgw;  // [B, E]
  float* dgb;
  float* dw;  // [E]
  float* db;
  float* part;  // [B, clusters, 2, E]
  int* count;   // [kMaxCluster]: arrivals a column slice
  int B, T, E, wpr, p_kind;
  float eps;
};

// Shared memory (floats): the forward's a and c [align4(E)] each; the
// backward's a [align4(E)], the column sums of g xhat and g, one pair a
// row group ([8 / wpr][2][align4(E)], each thread touching its own columns
// only), then, in a cluster, what the ranks push [cs][2][L], L the columns
// a rank owns (a multiple of 4).
int fwd_smem(int E) { return 4 * 2 * align4(E); }

int bwd_smem(int E, int wpr, int cs) {
  const int E4 = align4(E);
  const int L = align4((E + cs - 1) / cs);  // columns a rank owns
  return 4 * ((1 + (kWarps / wpr) * 2) * E4 + (cs > 1 ? cs * 2 * L : 0));
}

// A parameter sum p + q[qoff:] (p, q of kind `kind`) rounded in that kind,
// into shared memory. load() asks for a thread's first four columns,
// [4 t, 4 t + 4) (one 16-byte load each of p and q for f32 parameters on
// the vector path, where E % 4 == 0 and the pointers are on 16 bytes);
// store() writes them, then loads and writes the columns past 4 kThreads,
// every kThreads-th one a thread.
template <int VEC>
struct ParamSum {
  float p[4], q[4];

  __device__ __forceinline__ void load(const void* pp, const void* qp,
                                       size_t qoff, int E, int kind) {
    const int e = 4 * threadIdx.x;
    if constexpr (VEC > 1) {
      if (kind == 0) {
        const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 a = e < E ? __ldg(reinterpret_cast<const float4*>(
                                     static_cast<const float*>(pp) + e))
                               : zero;
        const float4 b = e < E ? __ldg(reinterpret_cast<const float4*>(
                                     static_cast<const float*>(qp) + qoff + e))
                               : zero;
        p[0] = a.x, p[1] = a.y, p[2] = a.z, p[3] = a.w;
        q[0] = b.x, q[1] = b.y, q[2] = b.z, q[3] = b.w;
        return;
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      p[u] = e + u < E ? load_param(pp, e + u, kind) : 0.f;
      q[u] = e + u < E ? load_param(qp, qoff + e + u, kind) : 0.f;
    }
  }

  __device__ __forceinline__ void store(float* dst, const void* pp,
                                        const void* qp, size_t qoff, int E,
                                        int kind) const {
    const int e = 4 * threadIdx.x;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (e + u < E) dst[e + u] = round_param(p[u] + q[u], kind);
    for (int c = threadIdx.x + 4 * kThreads; c < E; c += kThreads)
      dst[c] = round_param(
          load_param(pp, c, kind) + load_param(qp, qoff + c, kind), kind);
  }
};

// Block (blockIdx.x, b = blockIdx.y) takes rows [r0, r1) of trajectory b,
// nb = gridDim.x blocks a trajectory; row group `group` (wpr warps) every
// (8 / wpr)-th of them from r0 + group. Each thread j of a group holds
// columns of Slice<Xt, VEC, N>.
template <typename Xt, int VEC, int N>
__global__ void __launch_bounds__(kThreads)
adaln_fwd_kernel(const FwdArgs a) {
  using Raw = typename Xt::Raw;
  using S = Slice<Xt, VEC, N>;
  constexpr bool kPrefetch = N <= 32;  // else registers run short
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * kWarps * kWarps * 2];
  S xs;
  const int E = a.E, wpr = a.wpr, groups = kWarps / wpr, tpr = 32 * wpr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / wpr, wig = warp % wpr, j = wig * 32 + lane;
  const int b = blockIdx.y, nb = gridDim.x;
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * a.T / nb);
  const int r1 =
      static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.T / nb);
  const Raw* x = static_cast<const Raw*>(a.x) + static_cast<size_t>(b) * a.T * E;
  Raw* out = static_cast<Raw*>(a.out) + static_cast<size_t>(b) * a.T * E;
  float* a_sm = smem;
  float* c_sm = smem + align4(E);

  // The first rows, then a and c of trajectory b (asked for the other way
  // round, the calls took longer: chip_adaln_probe.py's params_first).
  const size_t boff = static_cast<size_t>(b) * E;
  int r = r0 + group;
  {
    if (kPrefetch && r < r1)
      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);
    ParamSum<VEC> pa, pc;
    pa.load(a.w, a.cw, boff, E, a.p_kind);
    pc.load(a.b, a.cb, boff, E, a.p_kind);
    pa.store(a_sm, a.w, a.cw, boff, E, a.p_kind);
    pc.store(c_sm, a.b, a.cb, boff, E, a.p_kind);
  }
  __syncthreads();
  const float inv_e = 1.f / static_cast<float>(E);
  int slot = 0;
  for (; r < r1; r += groups) {
    if (!kPrefetch) xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);
    float xf[N];
    xs.to_float(xf);
    if (kPrefetch && r + groups < r1)
      xs.load(x + static_cast<size_t>(r + groups) * E, j, tpr, E);
    float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) c4[i & 3] += xf[i];
    float s[1] = {sum4(c4)};
    row_sum(s, red, slot, group, wig, wpr, lane);
    const float mean = s[0] * inv_e;
    c4[0] = c4[1] = c4[2] = c4[3] = 0.f;
#pragma unroll
    for (int k = 0; k < S::K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int c = (k * tpr + j) * VEC + v;
        const float d = c < E ? xf[k * VEC + v] - mean : 0.f;
        xf[k * VEC + v] = d;
        c4[(k * VEC + v) & 3] += d * d;
      }
    float q[1] = {sum4(c4)};
    row_sum(q, red, slot, group, wig, wpr, lane);
    const float rstd = 1.f / sqrtf(q[0] * inv_e + a.eps);
    Raw* orow = out + static_cast<size_t>(r) * E;
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int c = (k * tpr + j) * VEC;
      if (c < E) {
        float av[VEC], cv[VEC], o[VEC];
        load_sm<VEC>(a_sm + c, av);
        load_sm<VEC>(c_sm + c, cv);
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          o[v] = xf[k * VEC + v] * rstd * av[v] + cv[v];
        store_row<Xt, VEC>(orow + c, o);
      }
    }
  }
}

template <typename Xt, int VEC, int N>
__global__ void __launch_bounds__(kThreads, 1)
adaln_bwd_kernel(const BwdArgs a) {
  using Raw = typename Xt::Raw;
  using S = Slice<Xt, VEC, N>;
  constexpr bool kPrefetch = N <= 32;
  extern __shared__ __align__(16) float smem[];
  __shared__ float red[2 * kWarps * kWarps * 2];
  __shared__ int last;
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // Every block of the cluster has started before any writes into
  // another's shared memory (the wait comes after the rows).
  if (cs > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int E = a.E, wpr = a.wpr, groups = kWarps / wpr, tpr = 32 * wpr;
  const int E4 = align4(E);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int group = warp / wpr, wig = warp % wpr, j = wig * 32 + lane;
  const int b = blockIdx.y, nb = gridDim.x, nc = nb / cs;
  const int cl = blockIdx.x / cs;  // the cluster, along the trajectory
  const int r0 = static_cast<int>(static_cast<long long>(blockIdx.x) * a.T / nb);
  const int r1 =
      static_cast<int>(static_cast<long long>(blockIdx.x + 1) * a.T / nb);
  const size_t base = static_cast<size_t>(b) * a.T * E;
  const Raw* x = static_cast<const Raw*>(a.x) + base;
  const Raw* g = static_cast<const Raw*>(a.g) + base;
  Raw* dx = static_cast<Raw*>(a.dx) + base;
  float* a_sm = smem;
  float* acc_w = smem + E4 + group * 2 * E4;  // this group's sums of g xhat
  float* acc_b = acc_w + E4;                  // and of g

  // The first rows, then a of trajectory b (as in the forward); the
  // thread's columns of its group's sums start at 0.
  S xs, gs;
  int r = r0 + group;
  {
    if (kPrefetch && r < r1) {
      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);
      gs.load(g + static_cast<size_t>(r) * E, j, tpr, E);
    }
    const size_t boff = static_cast<size_t>(b) * E;
    ParamSum<VEC> pa;
    pa.load(a.w, a.cw, boff, E, a.p_kind);
    pa.store(a_sm, a.w, a.cw, boff, E, a.p_kind);
  }
#pragma unroll
  for (int k = 0; k < S::K; ++k) {
    const int c = (k * tpr + j) * VEC;
    if (c < E) {
      const float z[VEC] = {};
      store_sm<VEC>(acc_w + c, z);
      store_sm<VEC>(acc_b + c, z);
    }
  }
  __syncthreads();
  const float inv_e = 1.f / static_cast<float>(E);
  int slot = 0;
  for (; r < r1; r += groups) {
    if (!kPrefetch) {
      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);
      gs.load(g + static_cast<size_t>(r) * E, j, tpr, E);
    }
    float xf[N], gf[N];
    xs.to_float(xf);
    gs.to_float(gf);
    if (kPrefetch && r + groups < r1) {
      xs.load(x + static_cast<size_t>(r + groups) * E, j, tpr, E);
      gs.load(g + static_cast<size_t>(r + groups) * E, j, tpr, E);
    }
    float c4[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < N; ++i) c4[i & 3] += xf[i];
    float s[1] = {sum4(c4)};
    row_sum(s, red, slot, group, wig, wpr, lane);
    const float mean = s[0] * inv_e;
    c4[0] = c4[1] = c4[2] = c4[3] = 0.f;
#pragma unroll
    for (int k = 0; k < S::K; ++k)
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const int c = (k * tpr + j) * VEC + v;
        const float d = c < E ? xf[k * VEC + v] - mean : 0.f;
        xf[k * VEC + v] = d;
        c4[(k * VEC + v) & 3] += d * d;
      }
    float q[1] = {sum4(c4)};
    row_sum(q, red, slot, group, wig, wpr, lane);
    const float rstd = 1.f / sqrtf(q[0] * inv_e + a.eps);
    // xhat into xf, dxhat = g a into gf; the column sums take g xhat and
    // g; the row's sums of dxhat and dxhat xhat.
    float t0[4] = {0.f, 0.f, 0.f, 0.f}, t1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int c = (k * tpr + j) * VEC;
      if (c < E) {
        float av[VEC], sw[VEC], sb[VEC];
        load_sm<VEC>(a_sm + c, av);
        load_sm<VEC>(acc_w + c, sw);
        load_sm<VEC>(acc_b + c, sb);
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float xh = xf[k * VEC + v] * rstd;
          const float gg = gf[k * VEC + v];
          sw[v] += gg * xh;
          sb[v] += gg;
          const float dxh = gg * av[v];
          t0[(k * VEC + v) & 3] += dxh;
          t1[(k * VEC + v) & 3] += dxh * xh;
          xf[k * VEC + v] = xh;
          gf[k * VEC + v] = dxh;
        }
        store_sm<VEC>(acc_w + c, sw);
        store_sm<VEC>(acc_b + c, sb);
      }
    }
    float t[2] = {sum4(t0), sum4(t1)};
    row_sum(t, red, slot, group, wig, wpr, lane);
    const float m1 = t[0] * inv_e, m2 = t[1] * inv_e;
    Raw* drow = dx + static_cast<size_t>(r) * E;
#pragma unroll
    for (int k = 0; k < S::K; ++k) {
      const int c = (k * tpr + j) * VEC;
      if (c < E) {
        float o[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v)
          o[v] = rstd * (gf[k * VEC + v] - m1 - xf[k * VEC + v] * m2);
        store_row<Xt, VEC>(drow + c, o);
      }
    }
  }
  __syncthreads();

  // The block's column sums, its groups added in group order; then the
  // cluster's, its ranks added in rank order by the rank that owns the
  // columns. The cluster's partial goes to part[b][cl]. Each sum loads
  // all of its terms before it adds them; a thread takes 4 columns at a
  // time (columns past E are never written out), and rank slices are
  // whole 16-byte words, so the pushes into other ranks are 16 bytes.
  float* part = a.part + (static_cast<size_t>(b) * nc + cl) * 2 * E;
  const int L = align4((E + cs - 1) / cs);
  float* recv = smem + (1 + groups * 2) * E4;  // [cs][2][L]
  if (cs > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = 4 * threadIdx.x; e < E; e += 4 * kThreads) {
    float4 vw[kWarps], vb[kWarps];
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      const float* sq = smem + E4 + q * 2 * E4 + e;
      vw[q] = q < groups ? *reinterpret_cast<const float4*>(sq)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
      vb[q] = q < groups ? *reinterpret_cast<const float4*>(sq + E4)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    float4 sw = make_float4(0.f, 0.f, 0.f, 0.f), sb = sw;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) {
      sw.x += vw[q].x, sw.y += vw[q].y, sw.z += vw[q].z, sw.w += vw[q].w;
      sb.x += vb[q].x, sb.y += vb[q].y, sb.z += vb[q].z, sb.w += vb[q].w;
    }
    if (cs == 1) {
      const float tw[4] = {sw.x, sw.y, sw.z, sw.w};
      const float tb[4] = {sb.x, sb.y, sb.z, sb.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (e + u < E) part[e + u] = tw[u], part[E + e + u] = tb[u];
    } else {
      const int o = e / L;
      float* dst =
          cluster.map_shared_rank(recv, o) + rank * 2 * L + e - o * L;
      *reinterpret_cast<float4*>(dst) = sw;
      *reinterpret_cast<float4*>(dst + L) = sb;
    }
  }
  const int c0 = rank * L, n = max(0, min(L, E - c0));
  if (cs > 1) {
    cluster.sync();
    for (int i = threadIdx.x; i < n; i += kThreads) {
      float vw[kMaxCluster], vb[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        vw[q] = q < cs ? recv[q * 2 * L + i] : 0.f;
        vb[q] = q < cs ? recv[q * 2 * L + L + i] : 0.f;
      }
      float sw = 0.f, sb = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) sw += vw[q], sb += vb[q];
      part[c0 + i] = sw;
      part[E + c0 + i] = sb;
    }
  }

  // Per column slice [c0, c0 + n), the last of the B nc clusters to write
  // its partial sums the slice: each trajectory's partials in cluster
  // order into dcw / dcb, and those in trajectory order into dw / db. The
  // partials are read kBatch at a time, so the finish waits on few L2
  // round trips. Thread 0 fences for the block, after the barrier that
  // orders the block's writes before it (as cooperative groups' grid
  // barrier does).
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(a.count + rank, 1) == a.B * nc - 1;
    if (last) {
      atomicExch(a.count + rank, 0);  // every cluster has arrived
      __threadfence();
    }
  }
  __syncthreads();
  if (!last) return;
  const int total = a.B * nc;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const float* p = a.part + c0 + i;
    float sw = 0.f, sb = 0.f, tw = 0.f, tb = 0.f;
    int q = 0;
    size_t out = c0 + i;
    for (int k0 = 0; k0 < total; k0 += kBatch) {
      float vw[kBatch], vb[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const size_t k = static_cast<size_t>(min(k0 + u, total - 1)) * 2 * E;
        vw[u] = __ldcg(p + k);
        vb[u] = __ldcg(p + k + E);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (k0 + u < total) {
          sw += vw[u];
          sb += vb[u];
          if (++q == nc) {  // trajectory (k0 + u) / nc is complete
            a.dgw[out] = sw;
            a.dgb[out] = sb;
            tw += sw;
            tb += sb;
            sw = sb = 0.f;
            q = 0;
            out += E;
          }
        }
      }
    }
    a.dw[c0 + i] = tw;
    a.db[c0 + i] = tb;
  }
}

// Raises a kernel's dynamic shared-memory limit to `smem` bytes where it
// is lower, once per device (`allowed` is the kernel's own).
cudaError_t configure(const void* kernel, int* allowed, int smem) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

// A call's launch: the plan, the stream and the kernel's arguments; with
// `slots` set, only asks how many blocks an SM (forward, or backward
// clusters of one) or clusters (backward) the card holds at once.
struct Launch {
  int B, T, E, wpr, nb, cs;
  cudaStream_t stream;
  const FwdArgs* fwd;
  const BwdArgs* bwd;
  int* slots;
};

template <typename Xt, int VEC, int N>
cudaError_t run(bool backward, const Launch& l) {
  static int allowed_fwd[64] = {}, allowed_bwd[64] = {};
  const void* kernel =
      backward ? reinterpret_cast<const void*>(adaln_bwd_kernel<Xt, VEC, N>)
               : reinterpret_cast<const void*>(adaln_fwd_kernel<Xt, VEC, N>);
  const int smem = backward ? bwd_smem(l.E, l.wpr, l.cs) : fwd_smem(l.E);
  cudaError_t err =
      configure(kernel, backward ? allowed_bwd : allowed_fwd, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(l.slots ? l.cs : l.nb, l.slots ? 1 : l.B, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = l.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = l.cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (l.slots) {
    if (backward && l.cs > 1)
      return cudaOccupancyMaxActiveClusters(l.slots, kernel, &cfg);
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(l.slots, kernel,
                                                         kThreads, smem);
  }
  if (backward)
    err = cudaLaunchKernelEx(&cfg, adaln_bwd_kernel<Xt, VEC, N>, *l.bwd);
  else
    err = cudaLaunchKernelEx(&cfg, adaln_fwd_kernel<Xt, VEC, N>, *l.fwd);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The layouts the kernels are built for: 16-byte vectors with N in
// {4, 8, 16, 32, 64} (f32) or {8, 16, 32, 64} (16-bit), and scalars with
// N in {4, 32, 64} (ops/fused_adaln.ELEMS; 64 for rows past 8 warps of
// 32 x 32).
template <typename Xt>
int by_layout(bool backward, int vec, int n, const Launch& l) {
  if (vec == 1) {
    switch (n) {
      case 4: return static_cast<int>(run<Xt, 1, 4>(backward, l));
      case 32: return static_cast<int>(run<Xt, 1, 32>(backward, l));
      case 64: return static_cast<int>(run<Xt, 1, 64>(backward, l));
    }
  } else if (vec == Xt::kVec) {
    constexpr int V = Xt::kVec;
    switch (n) {
      case 4:
        if constexpr (V == 4) return static_cast<int>(run<Xt, V, 4>(backward, l));
        break;
      case 8: return static_cast<int>(run<Xt, V, 8>(backward, l));
      case 16: return static_cast<int>(run<Xt, V, 16>(backward, l));
      case 32: return static_cast<int>(run<Xt, V, 32>(backward, l));
      case 64: return static_cast<int>(run<Xt, V, 64>(backward, l));
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(bool backward, int x_kind, int p_kind, int vec, int n,
             const Launch& l) {
  // The plan must cover a row (wpr warps of n elements a thread, wpr a
  // power of two up to 8) and a trajectory (nb a whole number of clusters
  // of at most 8, one cluster past kClusterMaxE columns).
  const bool wpr_ok = l.wpr == 1 || l.wpr == 2 || l.wpr == 4 || l.wpr == 8;
  if (l.B < 1 || l.B > 65535 || l.T < 1 || l.E < 1 || l.E > kMaxE ||
      !wpr_ok || static_cast<long long>(32) * l.wpr * n < l.E ||
      (vec > 1 && l.E % vec) || l.nb < 1 ||
      l.cs < 1 || l.cs > kMaxCluster || l.nb % l.cs ||
      (l.cs > 1 && l.E > kClusterMaxE) || p_kind < 0 || p_kind > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  switch (x_kind) {
    case 0: return by_layout<F32>(backward, vec, n, l);
    case 1: return by_layout<BF16>(backward, vec, n, l);
    case 2: return by_layout<F16>(backward, vec, n, l);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// x, out: [B, T, E] contiguous of kind x_kind (0 f32, 1 bf16, 2 f16), 16-byte
// aligned when vec > 1; cw, cb: [B, E] and w, b: [E] of kind p_kind. The
// plan (vec, n, wpr, nb) from ops/fused_adaln.adaln_plan. Enqueues one
// launch on `stream`; returns its error, or cudaGetLastError() after it
// (0 on success).
extern "C" int sea_adaln_fwd(const void* x, const void* cw, const void* cb,
                             const void* w, const void* b, void* out, int B,
                             int T, int E, float eps, int x_kind, int p_kind,
                             int vec, int n, int wpr, int nb, void* stream) {
  const FwdArgs args{x, cw, cb, w, b, out, T, E, wpr, p_kind, eps};
  const Launch l{B, T, E, wpr, nb, 1, static_cast<cudaStream_t>(stream),
                 &args, nullptr, nullptr};
  return dispatch(false, x_kind, p_kind, vec, n, l);
}

// x, g, dx: [B, T, E] of kind x_kind; cw: [B, E] and w: [E] of kind p_kind;
// dgw, dgb: f32 [B, E]; dw, db: f32 [E]; part: f32 scratch [B, nb / cs, 2,
// E]; count: int32 [8], zero before the call and after it. nb
// blocks a trajectory in clusters of cs. One launch, as sea_adaln_fwd.
extern "C" int sea_adaln_bwd(const void* x, const void* cw, const void* g,
                             const void* w, void* dx, void* dgw, void* dgb,
                             void* dw, void* db, void* part, void* count,
                             int B, int T, int E, float eps, int x_kind,
                             int p_kind, int vec, int n, int wpr, int nb,
                             int cs, void* stream) {
  const BwdArgs args{x,
                     cw,
                     g,
                     w,
                     dx,
                     static_cast<float*>(dgw),
                     static_cast<float*>(dgb),
                     static_cast<float*>(dw),
                     static_cast<float*>(db),
                     static_cast<float*>(part),
                     static_cast<int*>(count),
                     B,
                     T,
                     E,
                     wpr,
                     p_kind,
                     eps};
  const Launch l{B, T, E, wpr, nb, cs, static_cast<cudaStream_t>(stream),
                 nullptr, &args, nullptr};
  return dispatch(true, x_kind, p_kind, vec, n, l);
}

// How many blocks of the kernel (backward != 0: the backward) for rows of
// E elements of kind x_kind at (vec, n, wpr) the current device holds at
// once: clusters of cs for the backward with cs > 1, else blocks an SM; -1
// if the layout is refused or the query fails.
extern "C" int sea_adaln_slots(int backward, int x_kind, int vec, int n,
                               int E, int wpr, int cs) {
  int slots = 0;
  const Launch l{1, 1, E, wpr, cs, cs, nullptr, nullptr, nullptr, &slots};
  return dispatch(backward != 0, x_kind, 0, vec, n, l) == 0 ? slots : -1;
}
