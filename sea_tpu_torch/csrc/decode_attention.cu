// Flash-decode: one query token per (batch, head) against a head-major KV
// cache, for the autoregressive rollout step (ops/attention.mha_step). One
// kernel, one launch a call, for f32, bf16 and int8 caches.
//
// Replaces sea_tpu/ops/decode_attention.py::_decode_kernel and
// ::_decode_kernel_q8, the Pallas TPU kernels. For every (b, h) it computes
//     out = softmax(q . K[:t+1]^T / sqrt(hd)) . V[:t+1]
// and writes f32 [B, H, hd]; statistics and sums are f32.
//  - f32 or bf16 cache [B*H, T, hd]: as in the TPU kernel, q is rounded to
//    the cache dtype and each unnormalised probability to the value dtype
//    before p . V.
//  - int8 cache (the planes written by ops/attention._quantize_token, with
//    an f32 scale per (b, h, token), k_s and v_s [B*H, T]): q is rounded to
//    bf16; a key's score is (q . k_int8) * hd^-0.5 * k_s[t']; each
//    unnormalised probability times v_s[t'] is rounded to bf16 before it
//    multiplies the int8 values; the denominator sums the probabilities
//    without v_s. Nothing is dequantized into memory.
//  - "unnormalised" as the TPU kernel has it: the TPU kernel walks the keys
//    in tiles of 256 (one tile up to T = 256) with an online softmax, so a
//    key's probability is exp(s - m) with m the running max over the tiles
//    up to and including its own, and it is rounded so. This kernel rounds
//    at the same m (a cluster-wide table of tile maxima), then weighs each
//    key by exp(m - max over all keys), so the rounding is the TPU
//    kernel's and the plain version's (ops/decode_attention.
//    decode_attention_ref) whatever the split of the keys. An f32 cache
//    rounds nothing, so there each key stream takes its own max instead
//    and the table and its cluster barrier are skipped.
// The TPU kernels' gates (hd % 128, T >= 128, B*H <= 64), their 8-row
// sublane replication of q and the scales and the Precision.HIGHEST pin
// are Mosaic's and are not carried over.
//
// What bounds it: memory. Step t reads 2 (t+1) hd bytes per element of the
// cache per (b, h), and does about one multiply-add per element read, far
// below what the card computes per byte (so no tensor cores: with one
// query a (b, h) every product is a matrix-vector product). At the
// rollout's shapes that is 0.1-4 MB, a few microseconds at most, so the
// launch, the memory latency and the merge of the key splits set the
// time. The design therefore:
//  - splits the keys of a (b, h) over the blocks of a thread-block cluster
//    (grid (B*H, splits), cluster (1, splits, 1), splits <= 8, the
//    portable limit): at B=1 there are only 8 (b, h) pairs for 132 SMs.
//    The plan (ops/decode_attention.decode_plan) depends on T, B*H, hd,
//    the dtype and the card, never on t, so every step of a rollout
//    launches the same grid; it takes fewer splits where that lets all
//    B*H clusters run in one wave (cudaOccupancyMaxActiveClusters).
//  - has each block ask for all of its bytes before any dependent
//    arithmetic: cp.async copies of K rows [start, min(stop, t+1)), then
//    of the same V rows (and the int8 scales with them), into shared
//    memory, as two commit groups; the scores start when K has landed,
//    while V may still arrive. A chunk larger than one shared-memory
//    stage streams through a two-stage ring (T = 4096 at hd 256 f32):
//    first its K stages, then its V stages. No key, value or scale past t
//    is copied: t is read on the device, so a CUDA graph captured over a
//    rollout could replay the launch.
//  - scores the whole chunk first (kept in shared memory, 4 bytes a key);
//    for bf16 and int8 takes the maxima of its 256-key tiles and
//    exchanges them over the cluster (distributed shared memory and one
//    cluster barrier); then weighs and sums p . V against the running
//    maxima (f32: against each key stream's own max).
//  - merges inside the cluster: each block sums its key streams into a
//    partial (m, l, acc[hd]); rank o owns a 1/splits share of hd, and
//    every rank pushes its partial sums of those elements, with its
//    (m, l), into the owner's shared memory over distributed shared
//    memory (stores, nothing waits on a remote load). After one cluster
//    barrier each rank merges its share in rank order (so a call is
//    deterministic) from its own shared memory and writes out. Where the
//    table was exchanged every rank's m is the max over all keys and
//    each weight is exactly 1. No second kernel, no scratch in device
//    memory, and no rank touches another's shared memory after the
//    barrier. A block whose keys start past t publishes zeros and takes
//    part in every barrier; the first pushes wait on a cluster barrier
//    armed at the block's start, so every peer has started.
//  - inside a block, 8 warps (4 for int8); lanes read 16 bytes of a row at a time (8
//    for int8 at hd 8), G = hd / E lanes a key row (E = elements a lane,
//    at least hd / 32), so a warp takes 32 / G keys at once, each lane
//    group a key stream with its own sums; the shared-memory vectors of a
//    lane are interleaved with its neighbours' (conflict-free 16-byte
//    loads).
// Measured variants (chip_decode_probe.py, PERF.md): clusters of up to 16
// blocks and the other warp count were no faster; nor, in this design's
// development, one bulk copy (cp.async.bulk) a stage for the rows.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 8;
// The TPU kernel's key block past 256 keys: each probability is rounded
// against the running max over these tiles up to its own (ops/
// decode_attention.decode_attention_ref).
constexpr int kTile = 256;

// The cache element types. round() is applied to q and to each
// unnormalised probability (times v_s for int8) before p . V; kRounds
// says whether it changes anything (where the probability is taken
// against which max then matters). kWarps: a
// block's warps (chip_decode_probe.py measured 8 faster for f32 and bf16
// rows, 4 for int8, whose 16-byte lane slices give twice the streams to
// merge).
struct F32 {
  using Raw = float;
  static constexpr bool kScaled = false;
  static constexpr bool kRounds = false;
  static constexpr int kWarps = 8;
  __device__ static float load(Raw x) { return x; }
  __device__ static float round(float x) { return x; }
};

struct BF16 {
  using Raw = unsigned short;  // bf16 bits
  static constexpr bool kScaled = false;
  static constexpr bool kRounds = true;
  static constexpr int kWarps = 8;
  __device__ static float load(Raw x) {
    return __uint_as_float(static_cast<unsigned>(x) << 16);
  }
  __device__ static float round(float x) {
    return __bfloat162float(__float2bfloat16(x));
  }
};

struct I8 {
  using Raw = int8_t;
  static constexpr bool kScaled = true;  // per-token k_s, v_s
  static constexpr bool kRounds = true;
  static constexpr int kWarps = 4;
  __device__ static float load(Raw x) { return static_cast<float>(x); }
  __device__ static float round(float x) { return BF16::round(x); }
};

// A key row of HD elements over G lanes of E elements each, read as NV
// vectors of VE elements (16 bytes, or the whole row when it is shorter);
// vector i of lane `sub` holds elements [(i G + sub) VE, ... + VE). A warp
// pass takes KPW = 32 / G keys, one per lane group; a block runs S key
// streams.
template <typename Dt, int HD>
struct Lanes {
  static constexpr int kSize = static_cast<int>(sizeof(typename Dt::Raw));
  static constexpr int VE = 16 / kSize < HD ? 16 / kSize : HD;
  static constexpr int E = HD / 32 > VE ? HD / 32 : VE;
  static constexpr int G = HD / E;
  static constexpr int NV = E / VE;
  static constexpr int KPW = 32 / G;
  static constexpr int S = Dt::kWarps * KPW;
  static constexpr int kRowBytes = HD * kSize;
  static_assert(HD % E == 0 && E % VE == 0 && 32 % G == 0, "head dim");
  static_assert(VE * kSize == 16 || VE * kSize == 8, "vector of 8 or 16 bytes");
};

__host__ __device__ constexpr int align16(int n) { return (n + 15) & ~15; }

// 0 for a partial that saw no key (m = -inf), else exp(m - mx).
__device__ __forceinline__ float weight(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// Dynamic shared memory: the scores of the block's whole chunk, the
// cluster's table of key-tile maxima ([ranks + 2][tiles]: a row per rank,
// then the running max and its weight per tile; none for f32), then one
// or two ring
// slots of [K rows][V rows][k_s][v_s] (scales for int8 only). Once the
// ring is spent, the block's stream partials alias its start.
template <typename Dt, int HD>
struct Smem {
  using L = Lanes<Dt, HD>;
  __host__ __device__ static int scores(int chunk) {
    return align16(4 * chunk);
  }
  __host__ __device__ static int tiles(int T) {
    return (T + kTile - 1) / kTile;
  }
  __host__ __device__ static int table(int T, int ranks) {
    return Dt::kRounds ? align16(4 * (ranks + 2) * tiles(T)) : 0;
  }
  __host__ __device__ static int rows(int stage) {
    return align16(stage * L::kRowBytes);
  }
  __host__ __device__ static int scales(int stage) {
    return Dt::kScaled ? align16(4 * stage) : 0;
  }
  __host__ __device__ static int slot(int stage) {
    return 2 * rows(stage) + 2 * scales(stage);
  }
  static constexpr int kMerge = 4 * (L::S * HD + 3 * L::S);
  __host__ __device__ static int bytes(int T, int ranks, int chunk, int stage,
                                       int slots) {
    const int ring =
        scores(chunk) + table(T, ranks) + slots * slot(stage);
    return ring > kMerge ? ring : kMerge;
  }
};

// Async copies global -> shared of N = 4, 8 or 16 bytes (16 bypasses L1).
template <int N>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(d),
                 "l"(src), "n"(N));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// `bytes` contiguous bytes (a multiple of N, both ends on N bytes), shared
// by the block's `threads` threads in N-byte copies.
template <int N, int threads>
__device__ __forceinline__ void copy_block(unsigned char* dst,
                                           const unsigned char* src,
                                           int bytes) {
  for (int i = threadIdx.x * N; i < bytes; i += threads * N)
    cp_async<N>(dst + i, src + i);
}

// V consecutive f32 elements of q from global memory, as 16-byte words.
template <int V>
__device__ __forceinline__ void load_q(const float* __restrict__ p,
                                       float (&out)[V]) {
  static_assert(V % 4 == 0, "q slices of whole 16-byte words");
#pragma unroll
  for (int i = 0; i < V / 4; ++i) {
    const float4 w = __ldg(reinterpret_cast<const float4*>(p) + i);
    out[4 * i] = w.x;
    out[4 * i + 1] = w.y;
    out[4 * i + 2] = w.z;
    out[4 * i + 3] = w.w;
  }
}

// One vector of VE cache elements from shared memory, as floats.
template <typename Dt, int VE>
__device__ __forceinline__ void load_vec(const typename Dt::Raw* p,
                                         float (&out)[VE]) {
  using Raw = typename Dt::Raw;
  constexpr int kBytes = VE * static_cast<int>(sizeof(Raw));
  using Word = std::conditional_t<kBytes == 16, uint4, uint2>;
  union {
    Word w;
    Raw raw[VE];
  } u;
  u.w = *reinterpret_cast<const Word*>(p);
#pragma unroll
  for (int i = 0; i < VE; ++i) out[i] = Dt::load(u.raw[i]);
}

// One cluster per (b, h) = blockIdx.x; rank r = blockIdx.y of the cluster
// takes keys [r chunk, (r + 1) chunk) cut at t, in stages of `stage` keys.
template <typename Dt, int HD>
__global__ void __launch_bounds__(Dt::kWarps * 32)
decode_cluster(const float* __restrict__ q, const typename Dt::Raw* __restrict__ k,
               const typename Dt::Raw* __restrict__ v,
               const float* __restrict__ k_s, const float* __restrict__ v_s,
               const int* __restrict__ t_ptr, float* __restrict__ out, int T,
               int chunk, int stage, float scale) {
  using Raw = typename Dt::Raw;
  using L = Lanes<Dt, HD>;
  using Sm = Smem<Dt, HD>;
  constexpr int G = L::G, VE = L::VE, NV = L::NV, KPW = L::KPW,
                S = L::S;
  constexpr int kCopy = L::kRowBytes < 16 ? L::kRowBytes : 16;
  constexpr int kThreads = Dt::kWarps * 32;
  extern __shared__ __align__(16) unsigned char smem[];
  // What the cluster's ranks push here: row r holds rank r's partial sums
  // of the elements this rank owns (share of them), and its (m, l).
  __shared__ float gather[HD + kMaxCluster];
  __shared__ float gather_ml[kMaxCluster][2];
  __shared__ float rank_w[kMaxCluster];
  __shared__ float denom;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  // Every block of the cluster has started before any writes into
  // another's shared memory (the wait is at the tile maxima, after the
  // scores, or for f32 at the merge).
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
  const int bh = blockIdx.x;
  // The kernel cannot raise: an out-of-range position is clamped so that
  // no copy leaves the cache. The Python wrapper checks what it can see.
  const int t = min(max(__ldg(t_ptr), 0), T - 1);
  const int start = rank * chunk;
  const int n = max(0, min(start + chunk, t + 1) - start);  // keys here
  const int stages = (n + stage - 1) / stage;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int grp = lane / G;
  const int sub = lane % G;
  const int stream = warp * KPW + grp;

  const int tiles = Sm::tiles(T);
  float* sc = reinterpret_cast<float*>(smem);  // [chunk] scores
  float* table = reinterpret_cast<float*>(smem + Sm::scores(chunk));
  float* run_max = table + ranks * tiles;      // [tiles]
  float* tile_w = run_max + tiles;             // [tiles]
  unsigned char* ring = smem + Sm::scores(chunk) + Sm::table(T, ranks);
  const int slot_bytes = Sm::slot(stage), rows = Sm::rows(stage),
            scales = Sm::scales(stage);
  // Copies as 2 * stages items, each one commit group: K (with k_s) of
  // stage i into slot i % 2, then V (with v_s) of stage i into the V half
  // of slot i % 2. Item i + 2 is issued once item i is consumed; an item
  // past the last commits an empty group, so that every wait counts the
  // same groups.
  auto issue = [&](int i) {
    if (i < 2 * stages) {
      const bool is_k = i < stages;
      const int st = is_k ? i : i - stages;
      unsigned char* slot = ring + (st & 1) * slot_bytes;
      const int nk = min(stage, n - st * stage);
      const size_t row = static_cast<size_t>(bh) * T + start + st * stage;
      const Raw* src = (is_k ? k : v) + row * HD;
      copy_block<kCopy, kThreads>(slot + (is_k ? 0 : rows),
                                  reinterpret_cast<const unsigned char*>(src),
                                  nk * L::kRowBytes);
      if constexpr (Dt::kScaled)
        copy_block<4, kThreads>(
            slot + 2 * rows + (is_k ? 0 : scales),
            reinterpret_cast<const unsigned char*>((is_k ? k_s : v_s) + row),
            4 * nk);
    }
    cp_async_commit();
  };
  issue(0);
  issue(1);

  float qv[NV][VE];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    load_q<VE>(q + static_cast<size_t>(bh) * HD + (i * G + sub) * VE, qv[i]);
#pragma unroll
    for (int e = 0; e < VE; ++e) qv[i][e] = Dt::round(qv[i][e]);
  }

  // Pass 1: the scores of every key of the chunk, stage by stage. Stream
  // w takes keys w, w + S, w + 2 S, ... of each stage, here and in pass 2;
  // m_str: the max its terms are weighed to (f32: its own keys' max).
  float m_str = -INFINITY;
  for (int st = 0; st < stages; ++st) {
    const Raw* ks = reinterpret_cast<const Raw*>(ring + (st & 1) * slot_bytes);
    const float* kscale = reinterpret_cast<const float*>(
        ring + (st & 1) * slot_bytes + 2 * rows);
    const int nk = min(stage, n - st * stage);
    cp_async_wait<1>();
    __syncthreads();
    // Every lane of a warp runs the same count (the shuffles need all 32);
    // a group whose key is past the stage joins them and skips the rest.
    for (int b = warp * KPW; b < nk; b += S) {
      const int j = b + grp;
      const bool valid = j < nk;
      float s = 0.f;
      if (valid) {
#pragma unroll
        for (int i = 0; i < NV; ++i) {
          float kv[VE];
          load_vec<Dt, VE>(ks + j * HD + (i * G + sub) * VE, kv);
#pragma unroll
          for (int e = 0; e < VE; ++e) s = fmaf(qv[i][e], kv[e], s);
        }
      }
#pragma unroll
      for (int o = G / 2; o > 0; o >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, o);
      if (valid) {
        if constexpr (Dt::kScaled)
          s = s * scale * kscale[j];
        else
          s *= scale;
        if (sub == 0) sc[st * stage + j] = s;
        m_str = fmaxf(m_str, s);
      }
    }
    // Item st + 2 refills this slot's K once every warp has left it (past
    // the K items it is a V item, into a V half no one reads yet).
    if (st + 2 < stages) __syncthreads();
    issue(st + 2);
  }

  // This block's row of tile maxima (-inf where it holds no key of a
  // tile), where Dt rounds: pushed into every rank's table once all have
  // started; after a cluster barrier each rank holds the running max over
  // the tiles up to each one, as the TPU kernel's online softmax sees it,
  // and every stream weighs its terms to the max over all keys. An f32
  // stream keeps its own max (nothing rounds, so no term depends on it).
  if constexpr (Dt::kRounds) {
    float* row_t = table + rank * tiles;
    for (int j = threadIdx.x; j < tiles; j += kThreads) row_t[j] = -INFINITY;
    __syncthreads();
    if (n > 0) {
      const int t_lo = start / kTile, t_hi = (start + n - 1) / kTile;
      for (int j = t_lo + warp; j <= t_hi; j += Dt::kWarps) {
        const int lo = max(start, j * kTile) - start;
        const int hi = min(start + n, (j + 1) * kTile) - start;
        float mx = -INFINITY;
        for (int i = lo + lane; i < hi; i += 32) mx = fmaxf(mx, sc[i]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        if (lane == 0) row_t[j] = mx;
      }
    }
    __syncthreads();
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
    for (int e = threadIdx.x; e < ranks * tiles; e += kThreads) {
      const int r = e / tiles;
      if (r != rank)
        cluster.map_shared_rank(table, r)[rank * tiles + e % tiles] =
            row_t[e % tiles];
    }
    cluster.sync();
    // Rank 0 always holds key 0 <= t, so every running max is finite.
    if (threadIdx.x == 0) {
      float m = -INFINITY;
      for (int j = 0; j < tiles; ++j) {
        for (int r = 0; r < ranks; ++r) m = fmaxf(m, table[r * tiles + j]);
        run_max[j] = m;
      }
      for (int j = 0; j < tiles; ++j) tile_w[j] = expf(run_max[j] - m);
    }
    __syncthreads();
    m_str = run_max[tiles - 1];
  }

  // Pass 2: p = exp(s - running max of its tile), rounded to the value
  // dtype (times v_s for int8) before p . V; the key's sums are weighed
  // by exp(running max - the max over all keys), so that every stream,
  // block and rank sums against one max. f32: p = exp(s - m_str).
  float l = 0.f;
  float acc[NV][VE];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e) acc[i][e] = 0.f;
  for (int st = 0; st < stages; ++st) {
    const unsigned char* slot = ring + (st & 1) * slot_bytes;
    const Raw* vs = reinterpret_cast<const Raw*>(slot + rows);
    const float* vscale =
        reinterpret_cast<const float*>(slot + 2 * rows + scales);
    const int nk = min(stage, n - st * stage);
    cp_async_wait<1>();
    __syncthreads();
    for (int j = stream; j < nk; j += S) {
      float p, w;
      if constexpr (Dt::kRounds) {
        const int tile = (start + st * stage + j) / kTile;
        p = expf(sc[st * stage + j] - run_max[tile]);
        w = tile_w[tile];
      } else {
        p = expf(sc[st * stage + j] - m_str);
        w = 1.f;
      }
      l = fmaf(p, w, l);
      float pr;
      if constexpr (Dt::kScaled)
        pr = Dt::round(p * vscale[j]) * w;
      else
        pr = Dt::round(p) * w;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float vv[VE];
        load_vec<Dt, VE>(vs + j * HD + (i * G + sub) * VE, vv);
#pragma unroll
        for (int e = 0; e < VE; ++e) acc[i][e] = fmaf(pr, vv[e], acc[i][e]);
      }
    }
    // Item stages + st + 2 refills this slot's V once every warp has left
    // it.
    if (st + 2 < stages) __syncthreads();
    issue(stages + st + 2);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is spent: the stream partials alias it

  // The block's partial (m_blk, l, acc): its streams summed in stream
  // order. Where Dt rounds, every stream's terms are weighed to the max
  // over all keys already; an f32 stream is weighed by exp(m_str - m_blk)
  // (one that saw no key holds zeros and m_str = -inf: weight 0).
  float* sm_acc = reinterpret_cast<float*>(smem);  // [S][HD]
  float* sm_l = sm_acc + S * HD;
  float* sm_m = sm_l + S;
  float* sm_w = sm_m + S;
  if (sub == 0) {
    sm_l[stream] = l;
    sm_m[stream] = m_str;
  }
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int e = 0; e < VE; ++e)
      sm_acc[stream * HD + (i * G + sub) * VE + e] = acc[i][e];
  __syncthreads();
  float m_blk = m_str;
  if constexpr (!Dt::kRounds) {
#pragma unroll
    for (int w = 0; w < S; ++w) m_blk = fmaxf(m_blk, sm_m[w]);
    for (int w = threadIdx.x; w < S; w += kThreads)
      sm_w[w] = weight(sm_m[w], m_blk);
    __syncthreads();
  }
  auto stream_w = [&](int w) {
    if constexpr (Dt::kRounds) return 1.f;
    else return sm_w[w];
  };

  // The cluster's merge. Rank o owns elements [o share, (o + 1) share) of
  // out. Each rank pushes its partial sum of every element, and its
  // (m, l), into the owner's shared memory (distributed shared memory) at
  // its own rank's row; after one cluster barrier each rank merges its
  // elements from its own shared memory, in rank order, so a call is
  // deterministic, and no rank touches another's shared memory after the
  // barrier (a block may leave at once).
  if constexpr (!Dt::kRounds)
    asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  const int share = (HD + ranks - 1) / ranks;
  for (int d = threadIdx.x; d < HD; d += kThreads) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < S; ++w) a = fmaf(sm_acc[w * HD + d], stream_w(w), a);
    const int o = d / share;
    cluster.map_shared_rank(gather, o)[rank * share + d - o * share] = a;
  }
  if (static_cast<int>(threadIdx.x) < ranks) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < S; ++w) sum = fmaf(sm_l[w], stream_w(w), sum);
    float* ml = cluster.map_shared_rank(&gather_ml[0][0], threadIdx.x);
    ml[2 * rank] = m_blk;
    ml[2 * rank + 1] = sum;
  }
  cluster.sync();
  // Warp 0 weighs the ranks against the cluster's max (rank 0 always
  // holds key 0 <= t, so it is finite) and sums the denominator.
  if (warp == 0) {
    const float mr = lane < ranks ? gather_ml[lane][0] : -INFINITY;
    const float lr = lane < ranks ? gather_ml[lane][1] : 0.f;
    float M = mr;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, o));
    const float w = weight(mr, M);
    float sum = lr * w;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane < kMaxCluster) rank_w[lane] = w;
    if (lane == 0) denom = sum == 0.f ? 1.f : sum;  // the TPU kernel's guard
  }
  __syncthreads();
  const int d0 = rank * share;
  for (int i = threadIdx.x; i < share && d0 + i < HD; i += kThreads) {
    float a = 0.f;
    for (int r = 0; r < ranks; ++r)
      a = fmaf(gather[r * share + i], rank_w[r], a);
    out[static_cast<size_t>(bh) * HD + d0 + i] = a / denom;
  }
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* k_s;
  const void* v_s;
  const int* t;
  float* out;
  int bh, T, splits, chunk, stage, slots;
  cudaStream_t stream;
};

// Raises the kernel's dynamic shared-memory limit to `smem` bytes where
// it is lower, once per device.
template <typename Dt, int HD>
cudaError_t configure(int smem) {
  static int allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (smem > allowed[dev]) {
    err = cudaFuncSetAttribute(decode_cluster<Dt, HD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    // All of the SM's unified L1/shared memory as shared memory: the
    // kernel reads its cache rows from shared memory only, and two blocks
    // of a ring of RING_BYTES fit an SM only so.
    err = cudaFuncSetAttribute(decode_cluster<Dt, HD>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
  }
  return cudaSuccess;
}

// Launches the kernel, or with `clusters` set only asks how many of its
// clusters the card holds at once.
template <typename Dt, int HD>
cudaError_t run(const Args& a, int* clusters) {
  using Raw = typename Dt::Raw;
  const int smem =
      Smem<Dt, HD>::bytes(a.T, a.splits, a.chunk, a.stage, a.slots);
  cudaError_t err = configure<Dt, HD>(smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.bh, a.splits, 1);
  cfg.blockDim = dim3(Dt::kWarps * 32, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = a.splits;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  if (clusters)
    return cudaOccupancyMaxActiveClusters(clusters, decode_cluster<Dt, HD>,
                                          &cfg);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(HD)));
  err = cudaLaunchKernelEx(
      &cfg, decode_cluster<Dt, HD>, static_cast<const float*>(a.q),
      static_cast<const Raw*>(a.k), static_cast<const Raw*>(a.v),
      static_cast<const float*>(a.k_s), static_cast<const float*>(a.v_s),
      a.t, a.out, a.T, a.chunk, a.stage, scale);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename Dt>
int by_head_dim(int hd, const Args& a, int* clusters) {
  // The plan: splits blocks of chunk keys cover [0, T) with none empty; a
  // one-slot ring holds a whole chunk.
  if (a.bh < 1 || a.T < 1 || a.splits < 1 || a.splits > kMaxCluster ||
      a.chunk < 1 || a.stage < 1 || a.slots < 1 || a.slots > 2 ||
      static_cast<long long>(a.splits) * a.chunk < a.T ||
      static_cast<long long>(a.splits - 1) * a.chunk >= a.T ||
      (a.slots == 1 && a.stage < a.chunk))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (hd) {
    case 8: return static_cast<int>(run<Dt, 8>(a, clusters));
    case 16: return static_cast<int>(run<Dt, 16>(a, clusters));
    case 64: return static_cast<int>(run<Dt, 64>(a, clusters));
    case 128: return static_cast<int>(run<Dt, 128>(a, clusters));
    case 256: return static_cast<int>(run<Dt, 256>(a, clusters));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

int dispatch(int kind, int hd, const Args& a, int* clusters) {
  switch (kind) {
    case 0: return by_head_dim<F32>(hd, a, clusters);
    case 1: return by_head_dim<BF16>(hd, a, clusters);
    case 2: return by_head_dim<I8>(hd, a, clusters);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// q: f32 [bh, hd]; k, v: [bh, T, hd] in the cache dtype (f32, or bf16 when
// cache_is_bf16); t: one int32 on the device; out: f32 [bh, hd]. All
// contiguous and 16-byte aligned. splits (1..8) blocks of a cluster take
// chunk keys each (splits * chunk >= T, no split empty), through a ring of
// `slots` (1 or 2) stages of `stage` keys (one slot holds a whole chunk).
// Enqueues one launch on `stream`; returns its error, or
// cudaGetLastError() after it (0 on success).
extern "C" int sea_decode_attention(const void* q, const void* k, const void* v,
                                    const void* t, void* out, int bh, int T,
                                    int hd, int splits, int chunk, int stage,
                                    int slots, int cache_is_bf16,
                                    void* stream) {
  const Args a{q, k, v, nullptr, nullptr, static_cast<const int*>(t),
               static_cast<float*>(out), bh, T, splits, chunk, stage, slots,
               static_cast<cudaStream_t>(stream)};
  return dispatch(cache_is_bf16 ? 1 : 0, hd, a, nullptr);
}

// The int8 cache: k, v int8 [bh, T, hd]; k_s, v_s f32 [bh, T]; the rest as
// for sea_decode_attention.
extern "C" int sea_decode_attention_q8(const void* q, const void* k,
                                       const void* v, const void* k_s,
                                       const void* v_s, const void* t,
                                       void* out, int bh, int T, int hd,
                                       int splits, int chunk, int stage,
                                       int slots, void* stream) {
  const Args a{q, k, v, k_s, v_s, static_cast<const int*>(t),
               static_cast<float*>(out), bh, T, splits, chunk, stage, slots,
               static_cast<cudaStream_t>(stream)};
  return dispatch(2, hd, a, nullptr);
}

// How many clusters of the plan (splits, chunk, stage, slots) the card
// holds at once for cache kind 0 (f32), 1 (bf16) or 2 (int8) and head dim
// hd (cudaOccupancyMaxActiveClusters on the current device); -1 if the
// plan is refused or the query fails.
extern "C" int sea_decode_cluster_slots(int kind, int hd, int T, int splits,
                                        int chunk, int stage, int slots) {
  const Args a{nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
               1, T, splits, chunk, stage, slots, nullptr};
  int n = 0;
  return dispatch(kind, hd, a, &n) == 0 ? n : -1;
}
