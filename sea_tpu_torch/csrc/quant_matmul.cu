// int4 weight-only matvec for the serving rollout: y = (bf16(x) @ W) * s
// with W stored as packed signed nibbles. One kernel, one launch a call.
//
// Replaces sea_tpu/ops/quant_matmul.py::_mv_kernel, the Pallas TPU kernel.
// Storage is the JAX package's: wp is uint8 [K/2, N], byte [k, n] holding
// w[k, n] in its low nibble and w[k + K/2, n] in its high nibble, both
// signed (-8..7); s is an f32 scale per output column. x is f32 [M, K] with
// M <= 8 rows; each element is rounded to bf16 once, as the TPU kernel
// feeds bf16 x to its dots. The TPU kernel runs two bf16 dots with f32
// accumulation on its matrix unit; here the products run on the tensor
// cores as bf16 mma.sync with an f32 accumulator: a nibble times a bf16
// value is exact, sums are f32, and s multiplies once at the end. The TPU
// kernel's AND/XOR +8 plane, its rank-1 correction and its prescale of x's
// high half are Mosaic workarounds and are not carried over: each nibble
// becomes its exact signed value in registers.
//
// What bounds it: memory. A call reads K/2 * N bytes of weights and does
// 2 M multiply-adds per byte, far below the ~295 operations per byte at
// which the card's bf16 tensor cores, and not its memory, would limit. The
// design keeps bytes in flight, fills the card in one wave, and keeps the
// per-byte instruction count small:
//
//  - Products: mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32 with the weights
//    as A (16 output columns x 16 k) and x as B (16 k x 8 rows of x; rows
//    m >= M are zero, so every M in 1..8 runs the same code). Lane
//    (g, t) = (lane / 4, lane % 4) of a warp holds A rows g and g + 8 and
//    k pairs {2t, 2t + 1}, {2t + 8, 2t + 9}.
//  - k order. One MMA covers 8 packed rows p0..p0+7 of the tile: k pair
//    {2t, 2t + 1} is (low nibble of row p0+t, low nibble of row p0+t+4),
//    pair {2t + 8, 2t + 9} the two high nibbles, i.e. k = K/2 + row. The
//    staged x (B) follows the same order. So a lane's A registers come
//    from two packed rows, t and t + 4, and never mix bytes across rows.
//  - Column order. A warp covers 8 * V contiguous columns (V = 16 or 8
//    bytes a lane), lane group g the V columns [V g, V g + V). Each lane
//    reads its V bytes of row t and of row t + 4 as one 16- or 8-byte
//    shared-memory load each. MMA tile j (of V / 2) takes bytes 2j and
//    2j + 1 of the lane's piece as its A rows g and g + 8, so tile j's 16
//    rows are the columns {V g + 2j, V g + 2j + 1 : g = 0..7}, and its
//    accumulator c0..c3 holds y[2t, 2t+1][V g + 2j] and y[2t, 2t+1][V g +
//    2j + 1]: a lane ends holding V whole columns for x rows 2t and 2t + 1.
//  - Nibbles to bf16, two at a time, without I2F: one byte permute pairs
//    two bytes of row t with the same two of row t + 4; then per A
//    register a shift and one lop3, (v & 0x000F000F) ^ 0x43084308 (inline
//    PTX: the compiler split it in two), give the two bf16 values
//    128 + (nibble ^ 8) = 136 + w exactly (bf16's ulp at 128 is 1), and
//    one bf16x2 subtraction of 136 gives w exactly: about 3 instructions
//    a weight byte. A k-step is ~140 instructions for 8 MMAs.
//  - Bytes in flight: the block's column tile streams through a ring of
//    stages of 128 packed rows in shared memory with 16-byte cp.async
//    (commit_group / wait_group), 5 stages at 128 columns and 7 at 64,
//    3 or 5 of them in flight while one is multiplied: 48 KB or 40 KB of
//    weights per block, whose shared memory (126 or 116 KB) leaves one
//    block an SM. An SM takes only so many outstanding copies; past that a
//    cp.async waits for a free slot. So the next stage is issued before
//    the wait for the current one, and each thread works out the addresses
//    of its share of a stage's copies once (Copies): the copy code per
//    stage was ~570 instructions, ahead of the k-step. Deeper rings
//    measured no faster (PERF.md). The 16-byte pieces of row r sit
//    at piece index c ^ 2 (r & 3) (128 columns) or c ^ 2 ((r >> 1) & 1)
//    (64), so each quarter- or half-warp of fragment loads hits every bank
//    once. N not a multiple of 16, K/2 not a multiple of 4 or x not on 16
//    bytes take the kernel's other form, which reads the weights byte by
//    byte and x float by float.
//  - x travels with the weights: each stage also copies the f32 x of its
//    128 packed rows, both halves, rows m < M ([2][8][128 + 4] floats: 32
//    lanes' B-fragment loads on 32 banks), and each lane rounds its B
//    fragment to bf16 (cvt.rn.bf16x2) at the k-step. Staging all of a
//    block's x before the loop measured 5-7 us on an H100, alone in front
//    of the weight stream (PERF.md).
//  - 16 warps a block, one MMA k-step each of each stage: four warps a
//    scheduler to hide the latencies of a k-step's dependent chain.
//  - Split-K inside a thread-block cluster (at most 8 blocks, the portable
//    limit): the blocks of a cluster share one column tile and split its
//    packed rows. Each block sums its 16 warps in its own shared memory in
//    warp order, in the accumulators' fragment order (16-byte stores, no
//    bank conflict). Each element has an owner rank; every block writes
//    its sum of the element into the owner's shared memory (distributed
//    shared memory) at its own rank's row, one cluster barrier follows,
//    and the owner sums the rows in rank order, applies s (copied into
//    shared memory with the first stage) and writes y. No atomics, no
//    scratch in device memory, no second kernel: the result does not
//    depend on block timing. A cluster of one writes y from its warp sums.
//  - Grid: (cluster size, column tiles); the plan (ops/quant_matmul.py
//    int4_plan) picks the tile width, the cluster size and the rows per
//    split so that the blocks fill the card in one wave, one block an SM,
//    with no more clusters of a size than the card holds at once
//    (sea_int4_cluster_slots: a cluster stays inside one GPC).
//
// Measured on an H100 (PERF.md): at (M, K, N) = (1, 2048, 16384) a
// block's k loop streams at about the card's copy-only rate, and the
// launch, the first stage's latency and the sums make the rest.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = kWarps * 32;
constexpr int kStepRows = 8;  // packed rows per MMA (16 k)
constexpr int kStageRows = kStepRows * kWarps;  // one k-step a warp: 128
constexpr int kMaxRows = 8;   // rows of x: the MMA's n
constexpr int kMaxCluster = 8;
// A stage's x: [half][m][row] f32, half 0 the rows of x[:, :K/2], half 1
// of x[:, K/2:]; a row stride of kStageRows + 4 floats puts the 32 lanes'
// B-fragment loads on 32 banks.
constexpr int kXLd = kStageRows + 4;
constexpr int kXStageBytes = 2 * kMaxRows * kXLd * 4;
constexpr int kXPieces = kStageRows / 4;  // 16-byte pieces of an x row

// V: weight bytes per lane per packed row, 16 or 8.
template <int V>
struct Tile {
  static constexpr int kCols = 8 * V;         // columns per block
  static constexpr int kPieces = kCols / 16;  // 16-byte pieces per row
  static constexpr int kWCopies = kStageRows * kPieces / kThreads;
  static constexpr int kMmaTiles = V / 2;     // 16-column MMA tiles a warp
  static constexpr int kStages = V == 16 ? 5 : 7;  // ring depth
  static constexpr int kWBytes = kStageRows * kCols;  // a stage's weights
  static constexpr int kStageBytes = kWBytes + kXStageBytes;
  static constexpr int kRingBytes = kStages * kStageBytes;
  static constexpr int kAcc = kMmaTiles * 32 * 4;  // a warp's accumulators
  // Ring, then s for the tile's columns, then the cluster's partial sums
  // ([rank][elements a rank owns]).
  static constexpr int kSmemBytes =
      kRingBytes + kCols * 4 + (kAcc + kMaxCluster) * 4;
  static_assert(kWarps * kAcc * 4 <= kRingBytes, "warp sums alias the ring");
  static_assert(kWCopies >= 1, "a thread copies whole pieces");
};

// XOR applied to the 16-byte piece index of packed row r of a stage.
template <int V>
__device__ __forceinline__ int swz(int r) {
  return V == 16 ? 2 * (r & 3) : 2 * ((r >> 1) & 1);
}

// 16-byte cp.async; bytes past src_bytes (0..16) are zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes = 16) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

// 4-byte cp.async (through L1); src_bytes 0 writes a zero.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// One thread's share of every stage's copies, worked out once: weight
// pieces (a packed row and 16 columns each) and at most one x piece (4
// rows of one half of one x row). A stage adds kStageRows rows to each.
// Weight rows at or past the block's end and pieces at or past N are left
// as they are (any byte is a finite weight; the x it meets is zero, and
// columns past N are never written out); x past the end is zero-filled.
template <int V, bool kAligned>
struct Copies {
  using T = Tile<V>;
  const uint8_t* w[T::kWCopies];  // row kb + wrow[i], its piece
  int wdst[T::kWCopies], wrow[T::kWCopies], wcols[T::kWCopies];
  const float* xsrc;  // row kb + xrow of its half of x row m
  int xdst, xrow;
  bool xact;

  __device__ __forceinline__ Copies(const uint8_t* wp, const float* x,
                                    int M, int K2, int N, int kb, int n0) {
#pragma unroll
    for (int i = 0; i < T::kWCopies; ++i) {
      const int p = i * kThreads + threadIdx.x;
      const int r = p / T::kPieces, c = p % T::kPieces;
      wrow[i] = r;
      wdst[i] = r * T::kCols + 16 * (c ^ swz<V>(r));
      wcols[i] = N - (n0 + 16 * c);  // columns of the piece inside N
      w[i] = wp + static_cast<size_t>(kb + r) * N + min(n0 + 16 * c, N - 1);
    }
    const int hm = threadIdx.x / kXPieces, h = hm / M, m = hm % M;
    xact = threadIdx.x < 2 * M * kXPieces;
    xrow = 4 * (threadIdx.x % kXPieces);
    xdst = T::kWBytes + ((h * kMaxRows + m) * kXLd + xrow) * 4;
    xsrc = x + m * 2 * static_cast<size_t>(K2) + h * K2 + kb;
  }

  // Stage st (rows kb + st * kStageRows ..) into `slot`; `rows` is the
  // block's row count, N the weight's row stride.
  __device__ __forceinline__ void issue(uint8_t* slot, int st, int rows,
                                        int N) const {
    const int r0 = st * kStageRows;
#pragma unroll
    for (int i = 0; i < T::kWCopies; ++i) {
      if (wcols[i] <= 0 || r0 + wrow[i] >= rows) continue;
      const uint8_t* src = w[i] + static_cast<size_t>(r0) * N;
      if constexpr (kAligned) {
        cp_async16(slot + wdst[i], src);
      } else {
        uint32_t v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b)
            if (4 * q + b < wcols[i])
              v[q] |= static_cast<uint32_t>(__ldg(src + 4 * q + b)) << (8 * b);
        }
        *reinterpret_cast<uint4*>(slot + wdst[i]) =
            make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
    if (!xact) return;
    const int row = r0 + xrow;
    if constexpr (kAligned) {
      // Past the end the copy reads nothing, from the last aligned piece.
      cp_async16(slot + xdst, xsrc + min(row, (rows - 1) & ~3),
                 4 * max(0, min(4, rows - row)));
    } else {
      float* d = reinterpret_cast<float*>(slot + xdst);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        d[e] = row + e < rows ? __ldg(xsrc + row + e) : 0.f;
    }
  }
};

// Nibbles at bits 0-3 and 16-19 of v -> their two exact signed values as
// bf16x2: (v & 0x000F000F) ^ 0x43084308 in one lop3 is 0x4300 | (n ^ 8),
// i.e. 128 + (w + 8); minus 136 (which is 0x4308 in bf16).
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  constexpr uint32_t k136 = 0x43084308u;
  uint32_t r;
  asm("lop3.b32 %0, %1, 0x000F000F, 0x43084308, 0x6a;\n" : "=r"(r) : "r"(v));
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&r),
                             *reinterpret_cast<const __nv_bfloat162*>(&k136));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two f32 -> bf16x2 (round to nearest even), a in the low half.
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int V>
__device__ __forceinline__ void load_piece(uint32_t (&w)[V / 4],
                                           const uint8_t* p) {
  if constexpr (V == 16) {
    const uint4 v = *reinterpret_cast<const uint4*>(p);
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x; w[1] = v.y;
  }
}

// One MMA k-step: stage rows sr..sr+7 of `slot` for the warp's V / 2
// column tiles. x row g's B fragment is rounded to bf16 here; rows g >= M
// are zero.
template <int V>
__device__ __forceinline__ void mma_step(float (&acc)[V / 2][4],
                                         const uint8_t* slot, int sr, int M,
                                         int g, int t) {
  using T = Tile<V>;
  uint32_t b0 = 0, b1 = 0;
  if (g < M) {
    const float* xs = reinterpret_cast<const float*>(slot + T::kWBytes) +
                      g * kXLd + sr + t;
    const float* xh = xs + kMaxRows * kXLd;
    b0 = bf16x2(xs[0], xs[4]);
    b1 = bf16x2(xh[0], xh[4]);
  }
  const uint8_t* rows = slot + sr * T::kCols;
  const int piece = V == 16 ? g : g >> 1;
  const int off = V == 16 ? 0 : (g & 1) * 8;
  uint32_t wa[V / 4], wb[V / 4];
  load_piece<V>(wa, rows + t * T::kCols + 16 * (piece ^ swz<V>(t)) + off);
  load_piece<V>(wb, rows + (t + 4) * T::kCols +
                        16 * (piece ^ swz<V>(t + 4)) + off);
#pragma unroll
  for (int q = 0; q < V / 4; ++q) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // Bytes 2h, 2h + 1 of word q in row t, then the same in row t + 4.
      const uint32_t v = __byte_perm(wa[q], wb[q], h ? 0x7632 : 0x5410);
      const uint32_t a[4] = {nibbles_to_bf16x2(v), nibbles_to_bf16x2(v >> 8),
                             nibbles_to_bf16x2(v >> 4),
                             nibbles_to_bf16x2(v >> 12)};
      mma_bf16(acc[2 * q + h], a, b0, b1);
    }
  }
}

// The x row and column of accumulator element e of the fragment order
// [tile j][lane][c0..c3]: c0..c3 are rows 2t, 2t+1 of column V g + 2j,
// then of column V g + 2j + 1.
template <int V>
__device__ __forceinline__ void element(int e, int& m, int& col) {
  const int j = e >> 7, lane = (e >> 2) & 31, c = e & 3;
  m = 2 * (lane & 3) + (c & 1);
  col = V * (lane >> 2) + 2 * j + (c >> 1);
}

template <int V, bool kAligned>
__global__ void __launch_bounds__(kThreads, 1)
int4_matvec_mma(const float* __restrict__ x, const uint8_t* __restrict__ wp,
                const float* __restrict__ s, float* __restrict__ out, int M,
                int K2, int N, int rows_per_split) {
  using T = Tile<V>;
  constexpr int S = T::kStages;
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ring = smem;
  float* s_tile = reinterpret_cast<float*>(smem + T::kRingBytes);
  float* part = s_tile + T::kCols;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ranks = static_cast<int>(cluster.num_blocks());
  // Every block of the cluster has started before any writes into another's
  // shared memory (the wait is at the sums, long after).
  if (ranks > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");
  const int n0 = blockIdx.y * T::kCols;
  const int kb = rank * rows_per_split;
  const int rows = min(K2, kb + rows_per_split) - kb;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  // s for the tile's columns (with the first stage's copies), and the
  // first S - 2 stages in flight.
  for (int c = threadIdx.x; c < T::kCols; c += kThreads)
    cp_async4(s_tile + c, s + min(n0 + c, N - 1), n0 + c < N ? 4 : 0);
  const Copies<V, kAligned> copies(wp, x, M, K2, N, kb, n0);
  const int stages = (rows + kStageRows - 1) / kStageRows;
#pragma unroll
  for (int st = 0; st < S - 2; ++st) {
    if (st < stages) copies.issue(ring + st * T::kStageBytes, st, rows, N);
    cp_async_commit();
  }

  float acc[T::kMmaTiles][4];
#pragma unroll
  for (int j = 0; j < T::kMmaTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  const int steps = (rows + kStepRows - 1) / kStepRows;
  uint8_t* fill = ring + (S - 2) * T::kStageBytes;  // stage st + S - 2
  const uint8_t* slot = ring;                        // stage st
  for (int st = 0; st < stages; ++st) {
    // Stage st + S - 2 goes to the slot of st - 2, which every warp left
    // before the barrier of iteration st - 1; issued before the wait for
    // stage st, so that a copy that waits for a free request slot waits
    // alongside it, not in front of the k-step.
    if (st + S - 2 < stages) copies.issue(fill, st + S - 2, rows, N);
    cp_async_commit();
    fill = fill + T::kStageBytes == ring + T::kRingBytes
               ? ring : fill + T::kStageBytes;
    cp_async_wait<S - 2>();
    __syncthreads();  // stage st landed, for every thread's copies
    if (st * kWarps + warp < steps)
      mma_step<V>(acc, slot, warp * kStepRows, M, g, t);
    slot = slot + T::kStageBytes == ring + T::kRingBytes
               ? ring : slot + T::kStageBytes;
  }

  // The block's sum over its warps, in warp order, in the accumulators'
  // fragment order; the warp sums alias the ring, which no copy targets
  // any more.
  cp_async_wait<0>();
  __syncthreads();
  float4* red = reinterpret_cast<float4*>(ring);  // [warp][tile][lane]
#pragma unroll
  for (int j = 0; j < T::kMmaTiles; ++j)
    red[(warp * T::kMmaTiles + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  __syncthreads();
  const float* redf = reinterpret_cast<const float*>(red);
  // Element e is owned by rank e % ranks, at e / ranks of its share.
  const int share = (T::kAcc + ranks - 1) / ranks;
  if (ranks > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int e = threadIdx.x; e < T::kAcc; e += kThreads) {
    int m, col;
    element<V>(e, m, col);
    if (m >= M) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += redf[w * T::kAcc + e];
    if (ranks > 1)  // into the owner's shared memory, at this rank's row
      cluster.map_shared_rank(part, e % ranks)[rank * share + e / ranks] =
          sum;
    else if (n0 + col < N)  // a cluster of one: no rank sum
      out[static_cast<size_t>(m) * N + n0 + col] = sum * s_tile[col];
  }
  if (ranks == 1) return;

  // The cluster's sum over its ranks, in rank order, for the elements this
  // rank owns: every rank's row has landed after the barrier, and no rank
  // touches another's shared memory after it.
  cluster.sync();
  for (int i = threadIdx.x; i < share; i += kThreads) {
    const int e = rank + ranks * i;
    if (e >= T::kAcc) break;
    int m, col;
    element<V>(e, m, col);
    if (m >= M || n0 + col >= N) continue;
    float sum = 0.f;
    for (int r = 0; r < ranks; ++r) sum += part[r * share + i];
    out[static_cast<size_t>(m) * N + n0 + col] = sum * s_tile[col];
  }
}

template <int V, bool kAligned>
cudaError_t configure() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!done[dev]) {
    err = cudaFuncSetAttribute(int4_matvec_mma<V, kAligned>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Tile<V>::kSmemBytes);
    if (err != cudaSuccess) return err;
    done[dev] = true;
  }
  return cudaSuccess;
}

template <int V>
cudaLaunchConfig_t launch_config(int cluster, int N, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, (N + Tile<V>::kCols - 1) / Tile<V>::kCols, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = Tile<V>::kSmemBytes;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int V, bool kAligned>
cudaError_t launch(const float* x, const uint8_t* wp, const float* s,
                   float* out, int M, int K2, int N, int cluster, int rows,
                   cudaStream_t stream) {
  cudaError_t err = configure<V, kAligned>();
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<V>(cluster, N, stream, &attr);
  err = cudaLaunchKernelEx(&cfg, int4_matvec_mma<V, kAligned>, x, wp, s, out,
                           M, K2, N, rows);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <int V>
int cluster_slots(int cluster) {
  if (configure<V, true>() != cudaSuccess) return -1;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config<V>(cluster, 1, nullptr, &attr);
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, int4_matvec_mma<V, true>, &cfg) !=
      cudaSuccess)
    return -1;
  return n;
}

}  // namespace

// x: f32 [M, 2*K2]; wp: uint8 [K2, N], starting on 16 bytes; s: f32 [N];
// out: f32 [M, N]. All contiguous; 1 <= M <= 8. cols (64 or 128) is the
// column tile of a block, cluster (1..8) the blocks that split its packed
// rows, rows (a multiple of 8) the packed rows of each: the last rank
// takes the rest, and every rank has at least one. Enqueues one launch on
// `stream`; returns its error, or cudaGetLastError() after it.
extern "C" int sea_int4_matvec(const void* x, const void* wp, const void* s,
                               void* out, int M, int K2, int N, int cols,
                               int cluster, int rows, void* stream) {
  if (M < 1 || M > kMaxRows || K2 < 1 || N < 1 || cluster < 1 ||
      cluster > kMaxCluster || rows < kStepRows || rows % kStepRows ||
      static_cast<long long>(cluster) * rows < K2 ||
      static_cast<long long>(cluster - 1) * rows >= K2)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* X = static_cast<const float*>(x);
  const uint8_t* W = static_cast<const uint8_t*>(wp);
  const float* S = static_cast<const float*>(s);
  float* O = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 16-byte copies need N a multiple of 16 (weight rows) and K2 a multiple
  // of 4 with x on 16 bytes (x rows); otherwise the byte-wise form.
  const bool aligned = N % 16 == 0 && K2 % 4 == 0 &&
                       reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define SEA_INT4_LAUNCH(VV, AA) \
  return static_cast<int>(launch<VV, AA>(X, W, S, O, M, K2, N, cluster, rows, st))
  if (cols == 128) {
    if (aligned) SEA_INT4_LAUNCH(16, true);
    SEA_INT4_LAUNCH(16, false);
  }
  if (cols == 64) {
    if (aligned) SEA_INT4_LAUNCH(8, true);
    SEA_INT4_LAUNCH(8, false);
  }
#undef SEA_INT4_LAUNCH
  return static_cast<int>(cudaErrorInvalidValue);
}

// How many clusters of `cluster` blocks of the cols-wide kernel the current
// device holds at once (cudaOccupancyMaxActiveClusters; its shared memory
// allows one block an SM); -1 on an error.
extern "C" int sea_int4_cluster_slots(int cols, int cluster) {
  if (cluster < 1 || cluster > kMaxCluster) return -1;
  if (cols == 128) return cluster_slots<16>(cluster);
  if (cols == 64) return cluster_slots<8>(cluster);
  return -1;
}
