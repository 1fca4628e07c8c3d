// Flash-decode: one query token per (batch, head) against a head-major KV
// cache, for the autoregressive rollout step (ops/attention.mha_step).
//
// Replaces sea_tpu/ops/decode_attention.py::_decode_kernel, the Pallas TPU
// kernel. For every (b, h) it computes
//     out = softmax(q . K[:t+1]^T / sqrt(hd)) . V[:t+1]
// over a [B, H, T, hd] f32 or bf16 cache, accumulates in f32 and writes f32
// [B, H, hd]. As in the TPU kernel, q is rounded to the cache dtype and
// each unnormalised probability to the value dtype before p . V.
//
// What bounds it: memory. Step t reads 2 (t+1) hd sizeof(cache) bytes per
// (b, h) and does about one multiply-add per element read, far below what
// the card computes per byte. The design therefore minds bytes and
// parallelism, not arithmetic:
//  - no key or value past t is read. Each block loads t from device
//    memory, returns at once if its key range starts past t, and stops at
//    t otherwise (the TPU kernel got the same from a clamped index map).
//  - at B=1 there are only B*H = 8 (b, h) pairs for 132 SMs, so the key
//    axis is split (split-K): grid (B*H, S), each block writes a partial
//    (max, sum, acc[hd]) to scratch the caller allocates, and a second
//    small kernel merges the partials of each (b, h).
//  - inside a block each warp takes every kWarps-th key; its 32 lanes hold
//    hd/32 consecutive elements of q, K and V, so a warp reads a key row in
//    one coalesced sweep of vector loads (16 bytes a lane for f32 at
//    hd >= 128).
//  - head dims 8 and 16 (the smoke presets) are too narrow for a warp a
//    row: hd/4 lanes hold a row, 4 elements each, and a warp pass takes
//    32/(hd/4) consecutive keys, each lane group with its own running max
//    and sum until the block merges them (Lanes below).
// t is read on the device, not passed by value, so a CUDA graph captured
// over a rollout can replay it without rebuilding the launch.
//
// The int8 cache (decode_partial_q8) replaces
// sea_tpu/ops/decode_attention.py::_decode_kernel_q8. The planes hold int8
// K and V [B*H, T, hd] with an f32 scale per (b, h, token) beside them
// (k_s, v_s [B*H, T]), written by ops/attention._quantize_token. As in the
// TPU kernel, q is rounded to bf16 once; a key's score is
// (q . k_int8) * hd^-0.5 * k_s[t']; each unnormalised probability times
// v_s[t'] is rounded to bf16 before it multiplies the int8 values; the
// statistics are f32 and the softmax denominator sums the probabilities
// without v_s. Nothing is dequantized into memory. The bound is still
// bytes (now one per element, a quarter of f32), so a lane reads 16 int8
// elements with one 16-byte load: hd/16 lanes cover a key row, and a warp
// takes 32/(hd/16) keys at once (2 at hd 256, 8 at hd 64), each lane group
// with its own running max and sum until the block merges them. The TPU
// kernel's gates (hd % 128, T >= 128, B*H <= 64) and its 8-row sublane
// replication of q and the scales are not carried over.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;

struct F32 {
  using Raw = float;
  __device__ static float load(Raw x) { return x; }
  __device__ static float round(float x) { return x; }
};

struct BF16 {
  using Raw = unsigned short;  // bf16 bits
  __device__ static float load(Raw x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

// V consecutive elements at p as floats, in the widest aligned words the
// slice allows. p is aligned to V * sizeof(Raw) bytes by construction
// (row starts are multiples of hd elements, lanes of V elements).
template <typename Dt, int V>
__device__ __forceinline__ void load_row(const typename Dt::Raw* __restrict__ p,
                                         float (&out)[V]) {
  using Raw = typename Dt::Raw;
  constexpr int kBytes = V * static_cast<int>(sizeof(Raw));
  static_assert(kBytes % 4 == 0, "a lane's slice must be whole 32-bit words");
  using Word = std::conditional_t<
      kBytes % 16 == 0, uint4,
      std::conditional_t<kBytes % 8 == 0, uint2, unsigned>>;
  constexpr int kWords = kBytes / static_cast<int>(sizeof(Word));
  Raw raw[V];
  const Word* src = reinterpret_cast<const Word*>(p);
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    const Word w = __ldg(src + i);
    memcpy(reinterpret_cast<char*>(raw) + i * sizeof(Word), &w, sizeof(Word));
  }
#pragma unroll
  for (int i = 0; i < V; ++i) out[i] = Dt::load(raw[i]);
}

__device__ __forceinline__ int clamp_t(const int* t_ptr, int T) {
  // The kernel cannot raise: an out-of-range position is clamped so that no
  // load leaves the cache. The Python wrapper checks positions it can see.
  return min(max(__ldg(t_ptr), 0), T - 1);
}

// A key row of HD elements over G lanes of E consecutive elements each; a
// warp pass takes KPW = 32 / G keys, one per lane group. At hd >= 64 a
// whole warp holds a row (KPW 1); the smoke presets' hd 8 and 16 put 16 and
// 8 keys in a warp pass, 4 elements a lane.
template <int HD>
struct Lanes {
  static_assert(HD % 8 == 0 && (HD < 32 || HD % 32 == 0), "head dim");
  static constexpr int G = HD >= 32 ? 32 : HD / 4;
  static constexpr int E = HD / G;
  static constexpr int KPW = 32 / G;
  static constexpr int S = kWarps * KPW;  // streams a block
};

// Partial attention of one (b, h) over keys [split * chunk, (split+1) * chunk)
// cut at t. Writes part_ml[bh, split] = (max score, sum of exp) and
// part_acc[bh, split, :] = sum of exp * v, both relative to that max.
template <typename Dt, int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial(const float* __restrict__ q, const typename Dt::Raw* __restrict__ k,
               const typename Dt::Raw* __restrict__ v, const int* __restrict__ t_ptr,
               float* __restrict__ part_ml, float* __restrict__ part_acc, int T,
               int chunk, float scale) {
  using L = Lanes<HD>;
  constexpr int G = L::G, E = L::E, KPW = L::KPW, S = L::S;
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int t = clamp_t(t_ptr, T);
  const int start = split * chunk;
  if (start > t) return;  // uniform over the block, before any barrier
  const int stop = min(start + chunk, t + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int sub = lane % G;
  const int stream = warp * KPW + grp;

  float qv[E];
  load_row<F32, E>(q + static_cast<size_t>(bh) * HD + sub * E, qv);
#pragma unroll
  for (int i = 0; i < E; ++i) qv[i] = Dt::round(qv[i]);

  const size_t row0 = static_cast<size_t>(bh) * T * HD + sub * E;
  float m = -INFINITY;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // The loop runs the same count on every lane of a warp (the shuffles need
  // all 32); a group whose key is past `stop` joins them and skips the rest.
  for (int base = start + warp * KPW; base < stop; base += S) {
    const int j = base + grp;
    const bool valid = KPW == 1 || j < stop;
    float kv[E];
    float vv[E];
    float s = 0.f;
    if (valid) {
      load_row<Dt, E>(k + row0 + static_cast<size_t>(j) * HD, kv);
      load_row<Dt, E>(v + row0 + static_cast<size_t>(j) * HD, vv);
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qv[i], kv[i], s);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (valid) {
      s *= scale;
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 on the first key (m = -inf)
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float pr = Dt::round(p);
#pragma unroll
      for (int i = 0; i < E; ++i) acc[i] = fmaf(pr, vv[i], acc[i] * alpha);
      m = m_new;
    }
  }

  // Merge the streams. Stream 0 always owns key `start` <= t, so the block
  // max is finite; a stream that saw no key has m = -inf and weight 0.
  __shared__ float sm_m[S];
  __shared__ float sm_l[S];
  __shared__ float sm_acc[S][HD];
  if (sub == 0) {
    sm_m[stream] = m;
    sm_l[stream] = l;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) sm_acc[stream][sub * E + i] = acc[i];
  __syncthreads();

  float mx = sm_m[0];
#pragma unroll
  for (int w = 1; w < S; ++w) mx = fmaxf(mx, sm_m[w]);
  float wgt[S];
#pragma unroll
  for (int w = 0; w < S; ++w) wgt[w] = expf(sm_m[w] - mx);

  const size_t slot = static_cast<size_t>(bh) * gridDim.y + split;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < S; ++w) a = fmaf(sm_acc[w][d], wgt[w], a);
    part_acc[slot * HD + d] = a;
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < S; ++w) sum = fmaf(sm_l[w], wgt[w], sum);
    part_ml[2 * slot] = mx;
    part_ml[2 * slot + 1] = sum;
  }
}

// out[bh, :] = merged partials of the splits that start at or before t.
__global__ void __launch_bounds__(kThreads)
decode_merge(const float* __restrict__ part_ml, const float* __restrict__ part_acc,
             const int* __restrict__ t_ptr, float* __restrict__ out, int T, int hd,
             int splits, int chunk) {
  const int bh = blockIdx.x;
  const int t = clamp_t(t_ptr, T);
  const int n = min(splits, t / chunk + 1);
  const float* ml = part_ml + static_cast<size_t>(bh) * splits * 2;
  const float* acc = part_acc + static_cast<size_t>(bh) * splits * hd;
  float mx = -INFINITY;
  for (int s = 0; s < n; ++s) mx = fmaxf(mx, ml[2 * s]);
  float l = 0.f;
  for (int s = 0; s < n; ++s) l = fmaf(ml[2 * s + 1], expf(ml[2 * s] - mx), l);
  const float l_safe = (l == 0.f) ? 1.f : l;  // the TPU kernel's finalize guard
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int s = 0; s < n; ++s)
      a = fmaf(acc[static_cast<size_t>(s) * hd + d], expf(ml[2 * s] - mx), a);
    out[static_cast<size_t>(bh) * hd + d] = a / l_safe;
  }
}

template <typename Dt, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* t,
                   float* part_ml, float* part_acc, float* out, int bh, int T,
                   int splits, int chunk, cudaStream_t stream) {
  using Raw = typename Dt::Raw;
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  decode_partial<Dt, HD><<<dim3(bh, splits), kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const Raw*>(k),
      static_cast<const Raw*>(v), t, part_ml, part_acc, T, chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<<<bh, kThreads, 0, stream>>>(part_ml, part_acc, t, out, T, HD,
                                            splits, chunk);
  return cudaGetLastError();
}

// Partial attention over an int8 cache with per-token scales: the same
// split-K partials as decode_partial. G = HD/16 lanes hold 16 elements of a
// key row each (at hd 8 one lane holds the row); the warp's 32/G lane groups take consecutive keys, so the
// block runs kWarps * 32/G streams, each with its own (m, l, acc).
template <int HD>
__global__ void __launch_bounds__(kThreads)
decode_partial_q8(const float* __restrict__ q, const int8_t* __restrict__ k,
                  const int8_t* __restrict__ v, const float* __restrict__ k_s,
                  const float* __restrict__ v_s, const int* __restrict__ t_ptr,
                  float* __restrict__ part_ml, float* __restrict__ part_acc,
                  int T, int chunk, float scale) {
  constexpr int E = HD < 16 ? HD : 16;  // elements per lane: one load
  constexpr int G = HD / E;             // lanes per key row
  constexpr int KPW = 32 / G;      // keys per warp pass
  constexpr int S = kWarps * KPW;  // streams per block
  const int bh = blockIdx.x;
  const int split = blockIdx.y;
  const int t = clamp_t(t_ptr, T);
  const int start = split * chunk;
  if (start > t) return;  // uniform over the block, before any barrier
  const int stop = min(start + chunk, t + 1);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int sub = lane % G;
  const int stream = warp * KPW + grp;

  float qv[E];
  load_row<F32, E>(q + static_cast<size_t>(bh) * HD + sub * E, qv);
#pragma unroll
  for (int i = 0; i < E; ++i) qv[i] = BF16::round(qv[i]);

  const size_t row0 = static_cast<size_t>(bh) * T * HD + sub * E;
  const float* ks = k_s + static_cast<size_t>(bh) * T;
  const float* vs = v_s + static_cast<size_t>(bh) * T;
  float m = -INFINITY;
  float l = 0.f;
  float acc[E];
#pragma unroll
  for (int i = 0; i < E; ++i) acc[i] = 0.f;

  // The loop runs the same count on every lane of a warp (the shuffles need
  // all 32); a group whose key is past `stop` joins them and skips the rest.
  for (int base = start + warp * KPW; base < stop; base += S) {
    const int j = base + grp;
    const bool valid = j < stop;
    int8_t kb[E], vb[E];
    float s = 0.f;
    if (valid) {
      using Word = std::conditional_t<E == 16, uint4, uint2>;
      const Word kw = __ldg(reinterpret_cast<const Word*>(
          k + row0 + static_cast<size_t>(j) * HD));
      const Word vw = __ldg(reinterpret_cast<const Word*>(
          v + row0 + static_cast<size_t>(j) * HD));
      memcpy(kb, &kw, E);
      memcpy(vb, &vw, E);
#pragma unroll
      for (int i = 0; i < E; ++i) s = fmaf(qv[i], static_cast<float>(kb[i]), s);
    }
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (valid) {
      s = s * scale * __ldg(ks + j);
      const float m_new = fmaxf(m, s);
      const float alpha = expf(m - m_new);  // 0 on the first key (m = -inf)
      const float p = expf(s - m_new);
      l = l * alpha + p;
      const float pv = BF16::round(p * __ldg(vs + j));
#pragma unroll
      for (int i = 0; i < E; ++i)
        acc[i] = fmaf(pv, static_cast<float>(vb[i]), acc[i] * alpha);
      m = m_new;
    }
  }

  // Merge the streams. Stream 0 always owns key `start` <= t, so the block
  // max is finite; a stream that saw no key has m = -inf and weight 0.
  __shared__ float sm_m[S];
  __shared__ float sm_l[S];
  __shared__ float sm_acc[S][HD];
  if (sub == 0) {
    sm_m[stream] = m;
    sm_l[stream] = l;
  }
#pragma unroll
  for (int i = 0; i < E; ++i) sm_acc[stream][sub * E + i] = acc[i];
  __syncthreads();

  float mx = sm_m[0];
  for (int w = 1; w < S; ++w) mx = fmaxf(mx, sm_m[w]);
  const size_t slot = static_cast<size_t>(bh) * gridDim.y + split;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float a = 0.f;
    for (int w = 0; w < S; ++w) a = fmaf(sm_acc[w][d], expf(sm_m[w] - mx), a);
    part_acc[slot * HD + d] = a;
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int w = 0; w < S; ++w) sum = fmaf(sm_l[w], expf(sm_m[w] - mx), sum);
    part_ml[2 * slot] = mx;
    part_ml[2 * slot + 1] = sum;
  }
}

template <int HD>
cudaError_t launch_q8(const float* q, const int8_t* k, const int8_t* v,
                      const float* k_s, const float* v_s, const int* t,
                      float* part_ml, float* part_acc, float* out, int bh,
                      int T, int splits, int chunk, cudaStream_t stream) {
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  decode_partial_q8<HD><<<dim3(bh, splits), kThreads, 0, stream>>>(
      q, k, v, k_s, v_s, t, part_ml, part_acc, T, chunk, scale);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  decode_merge<<<bh, kThreads, 0, stream>>>(part_ml, part_acc, t, out, T, HD,
                                            splits, chunk);
  return cudaGetLastError();
}

}  // namespace

// The int8 cache: q f32 [bh, hd]; k, v int8 [bh, T, hd]; k_s, v_s f32
// [bh, T]; t, part_ml, part_acc and out as for sea_decode_attention.
extern "C" int sea_decode_attention_q8(const void* q, const void* k,
                                       const void* v, const void* k_s,
                                       const void* v_s, const void* t,
                                       void* part_ml, void* part_acc,
                                       void* out, int bh, int T, int hd,
                                       int splits, int chunk, void* stream) {
  const float* Q = static_cast<const float*>(q);
  const int8_t* K = static_cast<const int8_t*>(k);
  const int8_t* V = static_cast<const int8_t*>(v);
  const float* KS = static_cast<const float*>(k_s);
  const float* VS = static_cast<const float*>(v_s);
  const int* tp = static_cast<const int*>(t);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 8:
      return static_cast<int>(launch_q8<8>(Q, K, V, KS, VS, tp, ml, acc, o, bh,
                                           T, splits, chunk, s));
    case 16:
      return static_cast<int>(launch_q8<16>(Q, K, V, KS, VS, tp, ml, acc, o,
                                            bh, T, splits, chunk, s));
    case 64:
      return static_cast<int>(launch_q8<64>(Q, K, V, KS, VS, tp, ml, acc, o,
                                            bh, T, splits, chunk, s));
    case 128:
      return static_cast<int>(launch_q8<128>(Q, K, V, KS, VS, tp, ml, acc, o,
                                             bh, T, splits, chunk, s));
    case 256:
      return static_cast<int>(launch_q8<256>(Q, K, V, KS, VS, tp, ml, acc, o,
                                             bh, T, splits, chunk, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// q: f32 [bh, hd]; k, v: [bh, T, hd] in the cache dtype (f32, or bf16 when
// cache_is_bf16); t: one int32 on the device; part_ml: f32 [bh, splits, 2];
// part_acc: f32 [bh, splits, hd]; out: f32 [bh, hd]. All contiguous and
// 16-byte aligned. Requires splits * chunk >= T. Enqueues on `stream` and
// returns cudaGetLastError() after the launches (0 on success).
extern "C" int sea_decode_attention(const void* q, const void* k, const void* v,
                                    const void* t, void* part_ml, void* part_acc,
                                    void* out, int bh, int T, int hd, int splits,
                                    int chunk, int cache_is_bf16, void* stream) {
  const int* tp = static_cast<const int*>(t);
  float* ml = static_cast<float*>(part_ml);
  float* acc = static_cast<float*>(part_acc);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SEA_DECODE_CASE(DT, HD) \
  case HD:                      \
    return static_cast<int>(launch<DT, HD>(q, k, v, tp, ml, acc, o, bh, T, splits, chunk, s))
  if (cache_is_bf16) {
    switch (hd) {
      SEA_DECODE_CASE(BF16, 8);
      SEA_DECODE_CASE(BF16, 16);
      SEA_DECODE_CASE(BF16, 64);
      SEA_DECODE_CASE(BF16, 128);
      SEA_DECODE_CASE(BF16, 256);
    }
  } else {
    switch (hd) {
      SEA_DECODE_CASE(F32, 8);
      SEA_DECODE_CASE(F32, 16);
      SEA_DECODE_CASE(F32, 64);
      SEA_DECODE_CASE(F32, 128);
      SEA_DECODE_CASE(F32, 256);
    }
  }
#undef SEA_DECODE_CASE
  return static_cast<int>(cudaErrorInvalidValue);
}
