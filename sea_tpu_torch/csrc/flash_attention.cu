// Flash attention for the teacher-forced training step: the forward (with
// the row log-sum-exp the backward needs), dQ, and dK/dV, with the
// attention-probability dropout hashed inside the kernels.
//
// Replaces the Pallas TPU kernels of sea_tpu/ops/flash_attention.py:
// _fwd_kernel (forward), _bwd_dq_kernel (dQ) and _bwd_dkv_kernel (dK/dV),
// each in an f32 form and a bf16 form (the bf16 forms: their own note,
// below the dense mask's).
// Semantics of the f32 forms, f32 throughout (the products on the tensor
// cores with f32 accuracy, below; never single-pass TF32):
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
// Sharded calls (sea_tpu_torch/parallel) hash GLOBAL positions, as the TPU
// kernels do under shard_map and in the ring: an optional int32 bh_map
// [B*H] names the global b*H + h of each local row (one __ldg a block;
// null: the identity), and (q_off, k_off) are added to the q and k
// positions (seed words 2-3 of the TPU kernels). The offsets enter the
// hash as one host-computed constant, q_off * A + k_off * B in uint32,
// which is 0 by default, so an unsharded call computes what it did
// before. The causal mask stays on local positions.
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
// dQ and dK/dV (dq_kernel, dkv_kernel) run all their products on the tensor
// cores too, with the forward's mma.sync.m16n8k8 3xTF32 split, so their
// bound is the same ~165 TFLOP/s. They replace a TPU grid that walked the
// in-band (q block, k block) pairs in order with scratch carried between
// steps: here a block owns a tile of its own rows and walks the in-band
// tiles of the other side itself, out-of-band tiles never loaded.
//  - dK/dV: a block owns (bh, 64 keys; 32 at hd 256). Per q tile it forms
//    S^T = K.Q^T and dP^T = V.dO^T with K and V as the A operands (rows =
//    keys), so each accumulator holds keys g, g + 8 against queries 2t,
//    2t + 1 of every 8: after the forward's key-order trick (k step t ->
//    query 2t, t + 4 -> 2t + 1) P^T.M and dS^T are already the A fragments
//    of dV += (P.M)^T dO and dK += dS^T Q, with dO and Q read as [q][d] B
//    operands as the forward reads V. lse and D of the q tile are indexed
//    per column from shared memory.
//  - dQ: a block owns (bh, 64 queries; 32 at hd 256). S = Q.K^T and dP =
//    dO.V^T give dS in the A layout of dQ += dS K, K read as [key][d].
//  - neither P nor dS goes through shared memory;
//  - a warp owns 16 rows and up to 128 d columns of the accumulators
//    (dK and dV, or dQ): at hd 256 two warps share 16 rows, each forming
//    S and dP over its half of d; they add the halves through shared
//    memory (the same sum in both) and go on with their own d columns;
//  - the band: two groups of four warps per block split the walk, group
//    0 taking the even tiles and group 1 the odd ones, so the longest walk
//    (the first key tile's, the last q tile's) takes half as long and the
//    critical group walks about the mean tile count of a block. The grid
//    starts the longest walks first (blockIdx.y over tiles, in reverse for
//    dQ), so where it is over a wave the short ones fill in behind. Each
//    group streams its own tiles of 32 rows (16 at hd 256: Q, dO, lse and
//    D for dK/dV; K and V for dQ) through its own two-stage ring of 16-byte
//    cp.async copies (4-byte ones for lse and D), synchronised by a named
//    barrier per group; the block's own tiles are copied once. At the end
//    group 1 hands its sums to group 0 through shared memory, which adds
//    them to its own in a fixed order: no atomics, the same bits on every
//    call;
//  - every tile has a row stride of hd + 4 floats (= 4 mod 32 from hd 64),
//    and fragments are read one float at a time in the mma's own order:
//    conflict-free for the A reads (rows g, k t), the S-like B reads (row
//    g, k t) and the P.V-like B reads (rows 2t, 2t + 1, column g) alike,
//    where a float4 layout serves only one of the last two, and both read
//    Q and dO (dK/dV) or K (dQ). The same code takes hd 8 and 16;
//  - shared memory: 199 KB at hd 128, 212 KB at hd 256 (one block an SM),
//    103 KB at hd 64 (dK/dV; dQ 1 KB less).
//
// Head dims 8 and 16 are the smoke presets' (cylinder_flow_smoke: E=32 over
// 2 heads, and the exchange at half that width). The forward takes them
// with the same mma.sync tiles, its fragments read one float at a time in
// the mma's k order (a float4 would span more d than the row holds).
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
// The bf16 forms (fwd_kernel_bf16, dq_kernel_bf16, dkv_kernel_bf16 and, at
// hd 8 and 16, their *_bf16_mma forms) take bf16 q, k, v and dO and write o,
// dq, dk and dv in bf16, with the TPU kernels' rounding points: scores, the
// softmax statistics, lse, D and every sum in f32; the unnormalised p =
// exp(s - m) M rounded to bf16 (v's dtype) before P.V, under the running
// max of the key tiles walked so far as the TPU kernel rounds it (in
// fwd_kernel_bf16, those of the consumer group that walks the tile); dS
// rounded to bf16 before dS.K (k's dtype) and dS^T.Q (q's dtype), P.M
// before (P.M)^T.dO (dO's). bf16 is the tensor cores' own operand type: no
// split, so their bound is the bf16 peak (989 TFLOP/s) against 2-byte
// operands.
//
// The bf16 forward at hd 64, 128 and 256 (fwd_kernel_bf16) replaces
// _fwd_kernel on bf16 inputs, redesigned for Hopper. Its bound is bytes: q,
// k, v read once, o written once (2 bytes an element) and lse, 0.0020,
// 0.0010 and 0.0039 ms at (B, T, H, hd) = (2, 399, 8, 128), (2, 399, 8,
// 64) and (4, 199, 8, 256) at 3.35 TB/s, above its operations at the bf16
// peak. What held the first form (the f32 kernel's tiling with mma.sync)
// far above it was latency: 112 blocks under one wave of 132 SMs, the last
// q tile walking all 7 key tiles alone, one warp a scheduler issuing
// mma.sync, copies issued by every thread and a block barrier a tile. So:
//  - a block owns (bh, 64 q rows), the grid starting the last q tiles (the
//    longest walks) first, with three warpgroups: a loader, of which one
//    thread issues the copies, and two consumer groups of 128 threads;
//    setmaxnreg leaves the loader 40 registers a thread and gives the
//    consumers 232 (168 each at launch). The warp and warpgroup indices
//    are read from lane 0, so that ptxas sees the branches around the
//    wgmma as uniform: it serialises wgmma under a branch it takes for
//    divergent;
//  - TMA (cp.async.bulk.tensor) loads Q once and the K and V tiles into a
//    ring of ST stages a group, K and V each completing on an mbarrier
//    with its bytes, the stage released by its group's 128 threads on a
//    third. The tensor maps are 4-D, (hd, H, T, B) over the strided [B,
//    T, H, hd] views (the fused qkv and kv column slices too), encoded on
//    the host at each call and passed as __grid_constant__; boxes of 64
//    columns (128 bytes) by the tile's rows in the 128-byte swizzle, rows
//    past T land as zeros. TMA wants what the wrapper's alignment rule already
//    asks (start and strides on 16 bytes); a dim of size 1 gets its
//    packed stride. cuTensorMapEncodeTiled comes through the runtime's
//    driver entry point query, so the library links no more than the
//    runtime;
//  - the walk is split: group 0 takes the even key tiles of the band and
//    group 1 the odd ones, each with its own m, l and O, so the critical
//    walk takes 4 tiles of 7 at T = 399. At the end group 1 hands (m, l, O)
//    to group 0 through its own stages, and group 0 merges them into its
//    own in that fixed order: no atomics, a second call gives the same
//    bits;
//  - S = Q K^T is wgmma.mma_async.m64nBKk16 with both operands in shared
//    memory, K-major (a k step moves 32 bytes along the swizzled rows);
//    O += P V is m64nHDk16 with P in registers, S's accumulator rounded to
//    bf16 pairs being its A fragment (as in the mma.sync form), and V in
//    shared memory as an MN-major B (the transpose bit);
//  - inside a group, S of tile i and P.V of tile i - 1 go to the tensor
//    cores together and the group waits for both before the softmax of
//    tile i; the other group's products keep the tensor cores busy
//    meanwhile. Running the softmax under the P.V (wgmma.wait_group 1, P
//    in two register buffers) and turns that keep the two groups'
//    products apart (named barriers) measured no faster
//    (chip_flash_probe.py fwd16);
//  - the softmax runs in base 2: s scale log2(e) - m in one FFMA, then
//    ex2.approx; keys are masked only in a tile that reaches past the
//    band of some row of the warp;
//  - tiles: 64 keys and 4 stages a group at hd 64 (140 KB of shared
//    memory), 64 keys and 3 stages at hd 128 (214 KB), 32 keys and 3
//    stages at hd 256 (230 KB; 64-key tiles do not fit in 227 KB).
//
// The bf16 dQ and dK/dV at hd 64, 128 and 256 (dq_kernel_bf16,
// dkv_kernel_bf16) replace _bwd_dq_kernel and _bwd_dkv_kernel on bf16
// inputs, redesigned for Hopper as the forward was. Their bound is bytes
// too (q, k, v, dO read once, the gradients written once, lse and D),
// 0.0025 / 0.0029 ms at (2, 399, 8, 128); what held the mma.sync forms at
// 1.2-1.3x cuDNN's backward was again the critical block's serial walk.
// So, with the forward's pieces (Wgmma, the tensor maps, setmaxnreg, the
// base-2 exponent, indices from lane 0, peeled first and last tiles; each
// k step's descriptor added where it is used, desc_at) and the walk split
// of the mma.sync forms (kWalkers, walk_count):
//  - dQ: a block owns (bh, 64 q rows), the longest walks first; its loader
//    TMA-loads Q and dO once, then the in-band key tiles (64 keys, 32 at
//    hd 256) into a ring of stages a group, K and V on barriers of their
//    own. The consumer groups walk the even and the odd tiles: S = Q K^T
//    and dP = dO V^T are m64nBKk16 with both operands K-major; dS = P (M
//    dP - D) in the accumulator layout, with P = 2^(s scale log2(e) - lse
//    log2(e)) (one FFMA, ex2.approx), masks only on edge tiles, rounded to
//    bf16 pairs as the A fragment of dQ += dS K (m64nHDk16, K's tile
//    MN-major through the transpose bit); S and dP of tile i go to the
//    tensor cores with dS K of tile i - 1;
//  - dK/dV: a block owns (bh, 64 keys), K and V loaded once; the loader
//    hands the q tiles from the first in band on (64 rows at hd 64, 32 at
//    128 and 256); its first warp copies their lse and D with 4-byte
//    cp.async that arrive on the tile's barrier as they land (a row of Tq
//    floats is no legal tensor-map stride, and a 1-D tensor map over the
//    flat buffer faulted on the card). S^T = K Q^T and dP^T = V dO^T; P M
//    and dS^T stay in registers as the A fragments of dV += (P M)^T dO
//    and dK += dS^T Q, dO and Q MN-major. At hd 64 and 128 the groups
//    walk alternate q tiles; at hd 256 dK and dV (256 f32 a thread) do
//    not fit one warpgroup's registers, so d is split: each group owns 128
//    columns of dK and dV and walks every q tile of one shared ring,
//    forming S^T and dP^T over its half of d and adding the other
//    group's half through shared memory (SPLIT_D; each forming all of S^T
//    and dP^T itself measured 1-2% slower: chip_flash_probe.py bwd16);
//  - the groups' sums meet in a fixed order: group 1 hands its f32 sums
//    to group 0 through the ring once both walks are done, no atomics, so
//    a second call gives the same bits (under the d split no sum is
//    shared);
//  - shared memory: dQ 81 / 225 / 193 KB at hd 64 / 128 / 256 (2, 3, 2
//    stages a group), dK/dV 149 / 131 / 226 KB (4, 3 stages a group; 3
//    shared).
//
// The other bf16 forms keep the f32 kernels' tiling, warp split, cp.async
// rings, dropout hash and fixed-order sums of the two backward groups (a
// second call gives the same bits), with one mma.sync.m16n8k16 a product:
// dQ, dK/dV and the forward at hd 8 and 16 (the smoke presets), whose rows
// are narrower than a 64-column TMA box:
//  - S's m16n8k16 accumulator of n tiles 2kk and 2kk + 1 (rows g, g + 8;
//    keys 2t, 2t + 1 of each 8) is, rounded to bf16 pairs, the A fragment
//    of k step kk of the next product (P.V, dS.K, (P.M)^T.dO, dS^T.Q): P
//    and dS stay in registers and need no key reordering;
//  - operands whose k dimension is d ([row][d] tiles: Q, K, dO, V as A or
//    as the B of S-like products) are read as 32-bit pairs straight from
//    shared memory; B operands whose k dimension is the rows (V, K, dO, Q
//    in the second products) with ldmatrix.x4.trans (x2 at hd 8), two n
//    tiles at once;
//  - every bf16 tile has a row stride of hd + 8 elements (24 at hd 8 and
//    16): both kinds of read are free of bank conflicts, and rows start on
//    16 bytes for cp.async and ldmatrix;
//  - hd 8: the k dimension of Q.K^T is zero-padded to 16 in registers.
//
// Plain C interface (no PyTorch headers): built with nvcc for sm_90a and
// loaded with ctypes by sea_tpu_torch/ops/_build.py.

#include <cuda.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

// A bf16 value, kept as its 16 bits: the kernels only move bf16 values and
// hand them to the tensor cores, and convert with cvt in PTX.
using bf16 = uint16_t;

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
  const int* bh_map;  // local -> global b*H + h; null: the identity
  unsigned pos_hash;  // q_off * 0x9E3779B9 + k_off * 0x3243F6A9
};

// The global b*H + h that local row bh hashes with.
__device__ __forceinline__ unsigned global_bh(const Shape& s, int bh) {
  return s.bh_map ? static_cast<unsigned>(__ldg(s.bh_map + bh))
                  : static_cast<unsigned>(bh);
}

__device__ __forceinline__ float dropout_scale(const Shape& s, unsigned bh,
                                               unsigned q, unsigned k) {
  unsigned x = q * 0x9E3779B9u + k * 0x3243F6A9u + bh * 0x27D4EB2Fu +
               s.seed0 * 0x165667B1u + s.seed1 + s.pos_hash;
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 16; x *= 0xC2B2AE35u;
  x ^= x >> 16; x *= 0x85EBCA6Bu;
  x ^= x >> 16; x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x >= s.threshold ? s.inv_keep : 0.f;
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
  const unsigned gbh = global_bh(s, bh);
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
            sc[n][2 * r + e] *= dropout_scale(s, gbh, row0 + 8 * r,
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

// ---------------------------------------------------------------------------
// Backward: dQ and dK/dV on the tensor cores (see the note at the top)
// ---------------------------------------------------------------------------

constexpr int kGroupThreads = 128;  // a group: 4 warps
constexpr int kBwdThreads = 2 * kGroupThreads;
constexpr int kWalkers = 2;  // groups splitting a block's walk

// The walk's tiles group, group + kWalkers, ... of n_tiles: how many of
// them this group takes.
__device__ __forceinline__ int walk_count(int n_tiles, int group) {
  return n_tiles > group ? (n_tiles - group + kWalkers - 1) / kWalkers : 0;
}

// Tiles of the backward kernels. A block owns ROWS rows of its own side
// (queries for dQ, keys for dK/dV) and walks tiles of WALK rows of the
// other side; a warp owns 16 rows and DW d columns of the accumulators.
template <int HD>
struct BwdTiles {
  static constexpr int DW = HD < 128 ? HD : 128;
  static constexpr int KW = HD / DW;        // warps sharing 16 rows
  static constexpr int RW = 4 / KW;         // 16-row slices of a group
  static constexpr int ROWS = 16 * RW;
  static constexpr int WALK = HD == 256 ? 16 : 32;
  static constexpr int LD = HD + 4;         // row stride, floats
  static constexpr int NS = WALK / 8;       // n tiles of S, k steps after
  static constexpr int J = DW / 8;          // n tiles of a d accumulator
  // The block's own two tiles, then two groups x two stages of the walked
  // side's two tiles (and, for dK/dV, its lse and D).
  static constexpr int kDqStage = 2 * WALK * LD;
  static constexpr int kDkvStage = 2 * WALK * LD + 2 * WALK;
  // At hd 256, per warp of both groups: its halves of S and dP.
  static constexpr int kXchWarp = 2 * NS * 4 * 32;
  static constexpr int kXch = KW == 2 ? 8 * kXchWarp : 0;
  static constexpr size_t kDqSmem =
      sizeof(float) * (2 * ROWS * LD + 4 * kDqStage + kXch);
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * ROWS * LD + 4 * kDkvStage + kXch);
  static_assert((HD == 8 || HD == 16 || HD % 64 == 0) && HD <= 256,
                "head dim");
  static_assert(kDkvSmem <= 232448, "over the 227 KB a block may use");
  // group 1's sums (4 warps x registers x 32 lanes) fit in the ring
  static_assert(4 * 2 * J * 4 * 32 <= 4 * kDqStage, "reduction buffer");
};

__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "n"(kGroupThreads)
               : "memory");
}

// 4 bytes global -> shared, asynchronously; zero when !valid.
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

// Rows [t0, t0 + ROWS) of one (b, h) into a tile of row stride LD, copied
// in 16-byte pieces by THREADS threads of which this is number tid; rows
// past T are zero.
template <int HD, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void copy_rows(float* tile, const View& x, int b,
                                          int h, int t0, int T, int tid) {
  constexpr int kChunks = HD / 4;
  for (int e = tid; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = 4 * (e % kChunks);
    const bool ok = t0 + r < T;
    cp_async16(tile + r * LD + c, ok ? x.row(b, t0 + r, h) + c : x.p, ok);
  }
}

// acc[n] += A B^T over d in [0, HD), 3xTF32: A's rows g and g + 8 at a and
// a + 8 LD, B's row 8n + g at b + 8n LD (a and b already offset by row g
// and column t). k step t -> d0 + t, t + 4 -> d0 + t + 4.
template <int N, int HD, int LD>
__device__ __forceinline__ void qk_product(float (*acc)[4], const float* a,
                                           const float* b) {
#pragma unroll 4
  for (int d0 = 0; d0 < HD; d0 += 8) {
    const FragA fa =
        split_a(a[d0], a[8 * LD + d0], a[d0 + 4], a[8 * LD + d0 + 4]);
    Split b0[N], b1[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      b0[n] = split(b[8 * n * LD + d0]);
      b1[n] = split(b[8 * n * LD + d0 + 4]);
    }
    mma_3xtf32(acc, fa, b0, b1);
  }
}

// S = A0 B0^T and dP = A1 B1^T for this warp's 16 rows (qk_product; the
// pointers offset by row g, column t and the warp's d columns). Where two
// warps share the rows (KW = 2, hd 256) each forms both over its own half
// of d, then they add the halves through `xch` (a slot a warp; `group`
// synchronises), which gives both warps the same bits.
template <int NS, int HD, int LD, int KW>
__device__ __forceinline__ void qk_pair(float (&s0)[NS][4], const float* a0,
                                        const float* b0, float (&s1)[NS][4],
                                        const float* a1, const float* b1,
                                        float* xch, int gw, int lane,
                                        int group) {
  qk_product<NS, HD / KW, LD>(s0, a0, b0);
  qk_product<NS, HD / KW, LD>(s1, a1, b1);
  if constexpr (KW == 2) {
    constexpr int kWarp = 2 * NS * 4 * 32;
    float* mine = xch + gw * kWarp + lane;
    const float* other = xch + (gw ^ 2) * kWarp + lane;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[32 * (4 * n + e)] = s0[n][e];
        mine[32 * (4 * (NS + n) + e)] = s1[n][e];
      }
    group_sync(group);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s0[n][e] += other[32 * (4 * n + e)];
        s1[n][e] += other[32 * (4 * (NS + n) + e)];
      }
  }
}

// acc[j] += P B, 3xTF32: P is an accumulator fragment of N n tiles (rows
// g, g + 8; columns 2t, 2t + 1 of each 8), taken as N k steps in the
// key order (k t -> column 2t, t + 4 -> 2t + 1), so B's rows 8n + 2t and
// 8n + 2t + 1 at b + 8n LD and one LD below (b already offset by row 2t
// and column g), column 8j of them for n tile j.
template <int N, int J, int LD>
__device__ __forceinline__ void pv_product(float (*acc)[4],
                                           const float (*p)[4],
                                           const float* b) {
  constexpr int JN = J < 4 ? J : 4;  // n tiles a split batch
#pragma unroll
  for (int n = 0; n < N; ++n) {
    const FragA fa = split_a(p[n][0], p[n][2], p[n][1], p[n][3]);
    const float* y = b + 8 * n * LD;
#pragma unroll
    for (int j0 = 0; j0 < J; j0 += JN) {
      Split b0[JN], b1[JN];
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        b0[j] = split(y[8 * (j0 + j)]);
        b1[j] = split(y[LD + 8 * (j0 + j)]);
      }
      mma_3xtf32(acc + j0, fa, b0, b1);
    }
  }
}

// The two groups' sums meet in shared memory: group 1 puts its
// accumulator registers at red ([warp][register][lane]), then group 0 adds
// them to its own, always in that order, so every call gives the same bits.
template <int J>
__device__ __forceinline__ void put_sums(float* red, const float (&a)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) red[32 * (4 * j + i)] = a[j][i];
}

template <int J>
__device__ __forceinline__ void add_sums(float (&a)[J][4], const float* red) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) a[j][i] += red[32 * (4 * j + i)];
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
          const float* __restrict__ dsum, float* __restrict__ dq, Shape s) {
  using T = BwdTiles<HD>;
  constexpr int LD = T::LD, BQ = T::ROWS, BK = T::WALK, NS = T::NS;
  constexpr int J = T::J, kStage = T::kDqStage;
  extern __shared__ __align__(16) float bwd_smem_base[];
  float* sQ = bwd_smem_base;
  float* sO = sQ + BQ * LD;  // dO
  float* ring = sO + BQ * LD;  // [group][stage]: K, V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2, gw = warp & 3;
  const int rw = gw % T::RW, dcol = (gw / T::RW) * T::DW;
  const int gtid = threadIdx.x - group * kGroupThreads;
  // The q tiles in reverse, the longest walks first: where the grid is
  // over a wave, the short ones fill in behind them.
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int n_tiles = (key_end(s, q0, BQ) + BK - 1) / BK;  // in band
  const int mine = walk_count(n_tiles, group);
  float* gring = ring + group * 2 * kStage;
  float* xch = ring + 4 * kStage + group * 4 * T::kXchWarp;

  copy_rows<HD, BQ, LD, kBwdThreads>(sQ, q, b, h, q0, s.Tq, threadIdx.x);
  copy_rows<HD, BQ, LD, kBwdThreads>(sO, dout, b, h, q0, s.Tq, threadIdx.x);
  if (mine > 0) {
    copy_rows<HD, BK, LD, kGroupThreads>(gring, k, b, h, group * BK, s.Tk,
                                         gtid);
    copy_rows<HD, BK, LD, kGroupThreads>(gring + BK * LD, v, b, h,
                                         group * BK, s.Tk, gtid);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * rw + g;  // this thread's rows: row0, row0 + 8
  float row_lse[2], row_d[2];
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    const bool ok = qp < s.Tq;
    const long long at = static_cast<long long>(bh) * s.Tq + qp;
    row_lse[r] = ok ? lse[at] : 0.f;
    row_d[r] = ok ? dsum[at] : 0.f;
    lim[r] = !ok ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  float acc[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const float* qa = sQ + (16 * rw + g) * LD + t + dcol;
  const float* oa = sO + (16 * rw + g) * LD + t + dcol;
  cp_async_wait<0>();
  __syncthreads();  // the block's Q and dO, and each group's first tile

  for (int i = 0; i < mine; ++i) {
    if (i > 0) {
      cp_async_wait<0>();
      group_sync(group);  // tile i landed; stage (i + 1) & 1 is free
    }
    const float* cK = gring + (i & 1) * kStage;
    const float* cV = cK + BK * LD;
    if (i + 1 < mine) {
      float* nK = gring + ((i + 1) & 1) * kStage;
      const int k1 = (group + kWalkers * (i + 1)) * BK;
      copy_rows<HD, BK, LD, kGroupThreads>(nK, k, b, h, k1, s.Tk, gtid);
      copy_rows<HD, BK, LD, kGroupThreads>(nK + BK * LD, v, b, h, k1, s.Tk,
                                           gtid);
      cp_async_commit();
    }
    const int k0 = (group + kWalkers * i) * BK;

    // S = Q K^T and dP = dO V^T; sc[n][2r + e] is row row0 + 8r, key
    // k0 + 8n + 2t + e.
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    qk_pair<NS, HD, LD, T::KW>(sc, qa, cK + g * LD + t + dcol, dp, oa,
                               cV + g * LD + t + dcol, xch, gw, lane, group);

    // dS = P (M dP - D), P = exp(s scale - lse) in band, 0 elsewhere.
    if (s.dropout) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] *= dropout_scale(s, gbh, row0 + 8 * (e >> 1),
                                    k0 + 8 * n + 2 * t + (e & 1));
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(sc[n][e] * s.scale - row_lse[r]);
        sc[n][e] = k0 + 8 * n + 2 * t + (e & 1) < lim[r]
                       ? p * (dp[n][e] - row_d[r])
                       : 0.f;
      }

    // dQ += dS K over this tile's keys.
    pv_product<NS, J, LD>(acc, sc, cK + 2 * t * LD + dcol + g);
  }

  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* red = ring + gw * 4 * J * 32 + lane;
  if (group == 1) put_sums(red, acc);
  __syncthreads();
  if (group == 1) return;
  add_sums(acc, red);
  // acc[j][2r + e] is row row0 + 8r, d = dcol + 8j + 2t + e.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    float* out = dq + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) *
                          HD + dcol + 2 * t;
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<float2*>(out + 8 * j) =
          make_float2(acc[j][2 * r] * s.scale, acc[j][2 * r + 1] * s.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_kernel(View q, View k, View v, View dout, const float* __restrict__ lse,
           const float* __restrict__ dsum, float* __restrict__ dk,
           float* __restrict__ dv, Shape s) {
  using T = BwdTiles<HD>;
  constexpr int LD = T::LD, BK = T::ROWS, BQ = T::WALK, NS = T::NS;
  constexpr int J = T::J, kStage = T::kDkvStage;
  extern __shared__ __align__(16) float bwd_smem_base[];
  float* sK = bwd_smem_base;
  float* sV = sK + BK * LD;
  float* ring = sV + BK * LD;  // [group][stage]: Q, dO, lse, D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2, gw = warp & 3;
  const int rw = gw % T::RW, dcol = (gw / T::RW) * T::DW;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int k0 = blockIdx.y * BK;  // the first key tiles walk the longest
  // q tiles from the first that may see key k0 (keys above the band get
  // no gradient)
  const int first = (s.causal ? max(0, k0 - s.src_len) : 0) / BQ;
  const int n_tiles = max(0, (s.Tq + BQ - 1) / BQ - first);
  const int mine = walk_count(n_tiles, group);
  float* gring = ring + group * 2 * kStage;
  float* xch = ring + 4 * kStage + group * 4 * T::kXchWarp;
  const float* lse_bh = lse + static_cast<long long>(bh) * s.Tq;
  const float* d_bh = dsum + static_cast<long long>(bh) * s.Tq;

  // Q, dO, lse and D of q tile `tile` into `stage` of this group's ring.
  auto copy_q_tile = [&](int tile, int stage) {
    float* dst = gring + stage * kStage;
    const int q0 = tile * BQ;
    copy_rows<HD, BQ, LD, kGroupThreads>(dst, q, b, h, q0, s.Tq, gtid);
    copy_rows<HD, BQ, LD, kGroupThreads>(dst + BQ * LD, dout, b, h, q0, s.Tq,
                                         gtid);
    if (gtid < 2 * BQ) {
      const int r = gtid % BQ, qp = q0 + r;
      const bool ok = qp < s.Tq;
      const float* src = gtid < BQ ? lse_bh : d_bh;
      cp_async4(dst + 2 * BQ * LD + gtid, ok ? src + qp : src, ok);
    }
  };

  copy_rows<HD, BK, LD, kBwdThreads>(sK, k, b, h, k0, s.Tk, threadIdx.x);
  copy_rows<HD, BK, LD, kBwdThreads>(sV, v, b, h, k0, s.Tk, threadIdx.x);
  if (mine > 0) copy_q_tile(first + group, 0);
  cp_async_commit();

  const int key0 = k0 + 16 * rw + g;  // this thread's keys: key0, key0 + 8
  int qlo[2];  // query q sees key key0 + 8r iff qlo[r] <= q < Tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    qlo[r] = kp >= s.Tk ? s.Tq : s.causal ? kp - s.src_len : 0;
  }
  float gk[J][4], gv[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[j][i] = gv[j][i] = 0.f;
  const float* ka = sK + (16 * rw + g) * LD + t + dcol;
  const float* va = sV + (16 * rw + g) * LD + t + dcol;
  cp_async_wait<0>();
  __syncthreads();  // the block's K and V, and each group's first tile

  for (int i = 0; i < mine; ++i) {
    if (i > 0) {
      cp_async_wait<0>();
      group_sync(group);  // tile i landed; stage (i + 1) & 1 is free
    }
    const float* cQ = gring + (i & 1) * kStage;
    const float* cO = cQ + BQ * LD;
    const float* cL = cO + BQ * LD;  // lse, then D, of the tile's queries
    const float* cD = cL + BQ;
    if (i + 1 < mine) {
      copy_q_tile(first + group + kWalkers * (i + 1), (i + 1) & 1);
      cp_async_commit();
    }
    const int q0 = (first + group + kWalkers * i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T; st[n][2r + e] is key key0 + 8r,
    // query q0 + 8n + 2t + e.
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    qk_pair<NS, HD, LD, T::KW>(st, ka, cQ + g * LD + t + dcol, dpt, va,
                               cO + g * LD + t + dcol, xch, gw, lane, group);

    // P = exp(s scale - lse) in band, 0 elsewhere; then st <- P M and
    // dpt <- dS = P (M dP - D).
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1), qp = q0 + c;
        const float p = expf(st[n][e] * s.scale - cL[c]);
        st[n][e] = qp >= qlo[e >> 1] && qp < s.Tq ? p : 0.f;
      }
    if (s.dropout) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const float m =
              dropout_scale(s, gbh, q0 + c, key0 + 8 * (e >> 1));
          const float p = st[n][e];
          dpt[n][e] = p * (dpt[n][e] * m - cD[c]);
          st[n][e] = p * m;
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = st[n][e] * (dpt[n][e] - cD[8 * n + 2 * t + (e & 1)]);
    }

    // dV += (P M)^T dO and dK += dS^T Q over this tile's queries.
    pv_product<NS, J, LD>(gv, st, cO + 2 * t * LD + dcol + g);
    pv_product<NS, J, LD>(gk, dpt, cQ + 2 * t * LD + dcol + g);
  }

  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* red = ring + gw * 8 * J * 32 + lane;
  if (group == 1) {
    put_sums(red, gk);
    put_sums(red + 4 * J * 32, gv);
  }
  __syncthreads();
  if (group == 1) return;
  add_sums(gk, red);
  add_sums(gv, red + 4 * J * 32);
  // gk[j][2r + e] is key key0 + 8r, d = dcol + 8j + 2t + e; gv likewise.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    if (kp >= s.Tk) continue;
    const long long at =
        ((static_cast<long long>(b) * s.Tk + kp) * s.H + h) * HD + dcol +
        2 * t;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      *reinterpret_cast<float2*>(dk + at + 8 * j) =
          make_float2(gk[j][2 * r] * s.scale, gk[j][2 * r + 1] * s.scale);
      *reinterpret_cast<float2*>(dv + at + 8 * j) =
          make_float2(gv[j][2 * r], gv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 forms with mma.sync.m16n8k16, f32 accumulators (see the note at the
// top): dQ, dK/dV and the forward at hd 8 and 16. The f32 kernels' tiling,
// warp split and cp.async rings, one pass a product.
// ---------------------------------------------------------------------------

struct View16 {  // a [B, T, H, hd] bf16 tensor with hd contiguous
  const bf16* p;
  long long sb, st, sh;
  __device__ const bf16* row(int b, int t, int h) const {
    return p + b * sb + t * st + h * sh;
  }
};

// Row stride of every bf16 tile, in elements: hd + 8 (a row is then 4 words
// mod 32 past the one above from hd 64 on), 24 at hd 8 and 16; rows start
// on 16 bytes.
template <int HD>
struct Ld16 {
  static constexpr int LD = HD + 8 < 24 ? 24 : HD + 8;
  static_assert(LD % 8 == 0, "16-byte rows");
};

// 16 bytes global -> shared, asynchronously; zeros when !valid.
__device__ __forceinline__ void cp_async16_b(void* dst, const void* src,
                                             bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0));
}

// Rows [t0, t0 + ROWS) of one (b, h) into a bf16 tile of row stride LD, in
// 16-byte pieces by THREADS threads of which this is number tid; rows past
// T are zero.
template <int HD, int ROWS, int LD, int THREADS>
__device__ __forceinline__ void copy_rows16(bf16* tile, const View16& x,
                                            int b, int h, int t0, int T,
                                            int tid) {
  constexpr int kChunks = HD / 8;
  for (int e = tid; e < ROWS * kChunks; e += THREADS) {
    const int r = e / kChunks, c = 8 * (e % kChunks);
    const bool ok = t0 + r < T;
    cp_async16_b(tile + r * LD + c, ok ? x.row(b, t0 + r, h) + c : x.p, ok);
  }
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// (lo, hi) rounded to nearest even, lo in the low half: the pair layout of
// every bf16 fragment register (cvt puts its first operand in the high
// half).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// d += a b over one m16n8k16 tile: bf16 operands, f32 accumulator.
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Transposing 8x8 b16 loads: lane l gives the address of row l % 8 of
// matrix l / 8 and receives, of matrix i, the elements (rows 2t, 2t + 1;
// column g): an m16n8k16 B fragment from a [k][n] tile.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

__device__ __forceinline__ void ldsm_x2_trans(uint32_t (&r)[2],
                                              const bf16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, "
               "[%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(a));
}

// acc[n] += A B^T over d in [0, 16 KS): A's rows g and g + 8 at a and
// a + 8 LD, B's row 8n + g at b + 8n LD (a and b already offset by row g
// and column 2t). Both tiles are [row][d], so every fragment register is
// one 32-bit load of two neighbouring d. Below hd 16 the k dimension is 8:
// the upper half of each fragment is zero.
template <int N, int KS, int HD, int LD>
__device__ __forceinline__ void qk_product16(float (*acc)[4], const bf16* a,
                                             const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    const int d0 = 16 * kk;
    uint32_t fa[4] = {lds32(a + d0), lds32(a + 8 * LD + d0), 0u, 0u};
    if constexpr (HD >= 16) {
      fa[2] = lds32(a + d0 + 8);
      fa[3] = lds32(a + 8 * LD + d0 + 8);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const bf16* y = b + 8 * n * LD + d0;
      uint32_t b1 = 0u;
      if constexpr (HD >= 16) b1 = lds32(y + 8);
      mma_bf16(acc[n], fa, lds32(y), b1);
    }
  }
}

// acc[j] += P B: P an accumulator fragment of N n tiles (rows g, g + 8;
// columns 2t, 2t + 1 of each 8), rounded to bf16 pairs; n tiles 2kk and
// 2kk + 1 are the A fragment of k step kk as they stand. B is a [k][n]
// tile of row stride LD at b (offset by the warp's columns), rows 16kk to
// 16kk + 15, J n tiles of 8 columns, read with ldmatrix.trans.
template <int N, int J, int LD>
__device__ __forceinline__ void pv_product16(float (*acc)[4],
                                             const float (*p)[4],
                                             const bf16* b, int lane) {
  static_assert(N % 2 == 0 && (J == 1 || J % 2 == 0), "fragment pairs");
  const bf16* y =
      b + ((lane & 7) + 8 * ((lane >> 3) & 1)) * LD + 8 * (lane >> 4);
#pragma unroll
  for (int kk = 0; kk < N / 2; ++kk) {
    const uint32_t fa[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]),
                            pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    const bf16* yk = y + 16 * kk * LD;
    if constexpr (J == 1) {
      uint32_t fb[2];
      ldsm_x2_trans(fb, yk);
      mma_bf16(acc[0], fa, fb[0], fb[1]);
    } else {
#pragma unroll
      for (int j = 0; j < J; j += 2) {
        uint32_t fb[4];
        ldsm_x4_trans(fb, yk + 8 * j);
        mma_bf16(acc[j], fa, fb[0], fb[1]);
        mma_bf16(acc[j + 1], fa, fb[2], fb[3]);
      }
    }
  }
}

template <int HD, int BK>
struct FwdTiles16 {
  static constexpr int LD = Ld16<HD>::LD;
  static constexpr size_t kSmem = sizeof(bf16) * (kFwdBQ + 4 * BK) * LD;
  static_assert((HD == 8 || HD == 16) && BK % 16 == 0, "tile shape");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

template <int HD, int BK>
__global__ void __launch_bounds__(kFwdThreads)
fwd_kernel_bf16_mma(View16 q, View16 k, View16 v, bf16* __restrict__ o,
                    float* __restrict__ lse, Shape s) {
  constexpr int LD = FwdTiles16<HD, BK>::LD;
  constexpr int NS = BK / 8;                 // n tiles of S
  constexpr int NO = HD / 8;                 // n tiles of O
  constexpr int KS = HD < 16 ? 1 : HD / 16;  // k steps of S
  extern __shared__ __align__(16) unsigned char fwd16_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(fwd16_smem);
  bf16* sK = sQ + kFwdBQ * LD;  // two stages
  bf16* sV = sK + 2 * BK * LD;  // two stages
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int q0 = blockIdx.x * kFwdBQ;
  const int n_tiles = (key_end(s, q0, kFwdBQ) + BK - 1) / BK;

  copy_rows16<HD, kFwdBQ, LD, kFwdThreads>(sQ, q, b, h, q0, s.Tq,
                                           threadIdx.x);
  if (n_tiles > 0) {
    copy_rows16<HD, BK, LD, kFwdThreads>(sK, k, b, h, 0, s.Tk, threadIdx.x);
    copy_rows16<HD, BK, LD, kFwdThreads>(sV, v, b, h, 0, s.Tk, threadIdx.x);
  }
  cp_async_commit();

  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8 here
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lim[r] = qp >= s.Tq ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  const bf16* qa = sQ + (warp * 16 + g) * LD + 2 * t;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[NO][4];
#pragma unroll
  for (int c = 0; c < NO; ++c)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[c][i] = 0.f;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * BK;
    cp_async_wait<0>();
    __syncthreads();  // tile j landed; every warp is past tile j - 1
    const bf16* cK = sK + (j & 1) * BK * LD;
    const bf16* cV = sV + (j & 1) * BK * LD;
    if (j + 1 < n_tiles) {  // tile j + 1 into the stage tile j - 1 left
      bf16* nK = sK + ((j + 1) & 1) * BK * LD;
      bf16* nV = sV + ((j + 1) & 1) * BK * LD;
      copy_rows16<HD, BK, LD, kFwdThreads>(nK, k, b, h, k0 + BK, s.Tk,
                                           threadIdx.x);
      copy_rows16<HD, BK, LD, kFwdThreads>(nV, v, b, h, k0 + BK, s.Tk,
                                           threadIdx.x);
      cp_async_commit();
    }

    // S = Q K^T; sc[n][2r + e] is row row0 + 8r, key k0 + 8n + 2t + e.
    float sc[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = 0.f;
    qk_product16<NS, KS, HD, LD>(sc, qa, cK + g * LD + 2 * t);

    // Online softmax, as the f32 kernel.
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
            sc[n][2 * r + e] *= dropout_scale(s, gbh, row0 + 8 * r,
                                              k0 + 8 * n + 2 * t + e);
    }

    // O += P V, P rounded to bf16 (v's dtype) in registers.
    pv_product16<NS, NO, LD>(acc, sc, cV, lane);
  }

  // acc[c][2r + e] is row row0 + 8r, d = 8c + 2t + e.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    const float den = l[r] == 0.f ? 1.f : l[r];
    bf16* out = o + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) * HD +
                2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[c][2 * r] / den, acc[c][2 * r + 1] / den);
    if (t == 0) lse[static_cast<long long>(bh) * s.Tq + qp] = m[r] + logf(den);
  }
}

// ---------------------------------------------------------------------------
// bf16 forward for Hopper at hd 64, 128 and 256 (fwd_kernel_bf16): wgmma fed
// by TMA, the key walk split between two consumer warpgroups (see the note
// at the top)
// ---------------------------------------------------------------------------

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16, by the four warps of a
// warpgroup; the accumulator d is each thread's N / 2 floats: d[4i + e] is
// row 16 w + g + 8 (e / 2), column 8 i + 2 t + e % 2 of warp w's rows (the
// m16n8k16 C fragment, n tile by n tile). ss: S-like, B the K-major tile;
// rs: P.V-like, A in registers, B MN-major (the transpose bit).
template <int N>
struct Wgmma;

template <>
struct Wgmma<32> {
  // d (+)= A B^T: A [64][16] and B [32][16] in shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15}, "
        "%16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(accumulate));
  }
};

template <>
struct Wgmma<64> {
  // d (+)= A B^T: A [64][16] and B [64][16] in shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += A B: A [64][16] bf16 in registers (the m16n8k16 A fragment of
  // each warp's 16 rows), B [16][64] in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<128> {
  // d (+)= A B^T: A [64][16] and B [128][16] in shared memory, both K-major.
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a,
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(accumulate));
  }
  // d += A B: A [64][16] bf16 in registers (the m16n8k16 A fragment of
  // each warp's 16 rows), B [16][128] in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

template <>
struct Wgmma<256> {
  // d += A B: A [64][16] bf16 in registers (the m16n8k16 A fragment of
  // each warp's 16 rows), B [16][256] in shared memory, MN-major.
  static __device__ __forceinline__ void rs(float (&d)[128],
                                            const uint32_t (&a)[4],
                                            uint64_t b, int accumulate) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
        "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, "
        "%27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
        "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, "
        "%66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, "
        "%79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, "
        "%92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, "
        "%104, %105, %106, %107, %108, %109, %110, %111, %112, %113, "
        "%114, %115, %116, %117, %118, %119, %120, %121, %122, %123, "
        "%124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
          "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
          "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
          "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b),
          "r"(accumulate));
  }
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The wgmma descriptor of a tile as TMA's 128-byte swizzle lays it out:
// rows of 128 bytes (64 bf16), swizzled in atoms of 8 rows (1024 bytes,
// which start on 1024 bytes). K-major (Q, K): sbo 1024 steps to the next 8
// rows, and a k step moves p 32 bytes along the row. MN-major (V): sbo
// 1024 steps to the next 8 keys (the k dimension), lbo to the next 64
// columns (the next box).
__device__ __forceinline__ uint64_t sw128_desc(const void* p, unsigned lbo,
                                               unsigned sbo) {
  return static_cast<uint64_t>((smem_u32(p) >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties the registers of an operand to this point: the compiler moves no
// read or write of them across a wgmma issue or wait.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// The producer's arrival, with the bytes its copies will bring.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Until the phase of the given parity has completed (a fresh barrier counts
// parity 1 as completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The box of `map` at (d, h, t, b) into shared memory at dst, counted on
// bar's transaction bytes.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap& map,
                                         uint64_t* bar, int d, int h, int t,
                                         int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(&map)), "r"(smem_u32(bar)), "r"(d),
      "r"(h), "r"(t), "r"(b)
      : "memory");
}

// 2^x (ex2.approx, relative error below 2^-22; 0 for x far below -126).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap& map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(
                   reinterpret_cast<uint64_t>(&map))
               : "memory");
}

// Tiles and rings of fwd_kernel_bf16: a block owns 64 q rows (kFwdBQ); a
// warpgroup of 128 threads (one thread issuing) loads, kGroups consumer
// warpgroups walk key tiles group, group + kGroups, ... of BK keys, each
// through a ring of ST stages (K, then V, each with its own barrier).
// Every tile is boxes of 64 columns (128 bytes) by its rows, in TMA's
// 128-byte swizzle.
template <int HD, int BK, int ST>
struct FwdWg {
  static constexpr int kGroups = 2;
  static constexpr int kThreads = 128 * (1 + kGroups);
  static constexpr int kBoxes = HD / 64;  // 64-column boxes of a row
  static constexpr int kQBytes = kFwdBQ * HD * 2;
  static constexpr int kTileBytes = BK * HD * 2;  // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = kGroups * ST;
  // Group 1's O, m and l, a float4 at a time for each of its threads, in
  // its own stages.
  static constexpr int kXchBytes = (HD / 8 + 1) * 128 * 16;
  // 1024 bytes to align the base to a swizzle atom; the barriers behind
  // the ring: K and V landed, the stage free, Q landed.
  static constexpr size_t kSmem =
      1024 + kQBytes + kStages * kStageBytes + 8 * (3 * kStages + 1);
  static_assert(HD % 64 == 0 && HD <= 256 && BK % 16 == 0 && BK <= 256,
                "tile shape");
  static_assert(kXchBytes <= ST * kStageBytes, "exchange buffer");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// Registers a thread of each warpgroup keeps (setmaxnreg): the loader's
// one issuing thread needs few, the consumers' accumulators many. The
// block's 65,536 are 168 a thread at launch (384 threads).
constexpr int kLoaderRegs = 40;
constexpr int kConsumerRegs = 232;

// d + off, added where it is used: the asm keeps the compiler from
// hoisting every k step's descriptor of a tile that stays put (Q; Q and dO
// in dQ, K and V in dK/dV) out of the walk, which at hd 256 held 32 64-bit
// values live across the backward's walk and pushed it into spills.
__device__ __forceinline__ uint64_t desc_at(uint64_t d, int off) {
  uint64_t r;
  asm volatile("add.s64 %0, %1, %2;\n"
               : "=l"(r)
               : "l"(d), "l"(static_cast<uint64_t>(off)));
  return r;
}

// S = Q K^T of a key tile into sc, issued: HD / 16 k steps, each 32 bytes
// further along the rows of a 64-column box. qd and kd are the
// descriptors of Q's (64 rows) and the K tile's first box; a descriptor's
// address field counts 16 bytes, and no address here carries out of it.
template <int HD, int BK>
__device__ __forceinline__ void issue_s(float (&sc)[BK / 2], uint64_t qd,
                                        uint64_t kd) {
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int at = (kk & 3) * 2;
    Wgmma<BK>::ss(sc, desc_at(qd, (kk / 4) * (kFwdBQ * 128 / 16) + at),
                  desc_at(kd, (kk / 4) * (BK * 128 / 16) + at), kk > 0);
  }
}

// O += P V of a key tile, issued: P's bf16 fragments p, one k step of 16
// keys (2048 bytes into V's boxes, vd the descriptor of the first) each.
template <int HD, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[HD / 2],
                                         const uint32_t (&p)[BK / 16][4],
                                         uint64_t vd) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    Wgmma<HD>::rs(acc, p[kk], vd + kk * (16 * 128 / 16), 1);
}

// The online softmax of the key tile at k0 on its scores sc, in base 2:
// the running max m (of s scale log2(e)) and sum l of this thread's two
// rows, the factor alpha the O so far is to be scaled by, and P = 2^(s
// scale log2(e) - m) = exp(s scale - m ln 2), dropout applied, rounded to
// bf16 pairs into p: n tiles 2kk and 2kk + 1 of S are the A fragment of k
// step kk of P.V. MASK: some key of the tile lies past a row's band.
template <int BK, bool MASK>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[BK / 2], uint32_t (&p)[BK / 16][4], float (&m)[2],
    float (&l)[2], float (&alpha)[2], const int (&lim)[2], int k0, int row0,
    int t, unsigned bh, float scale_log2, const Shape& s) {
  constexpr int NS = BK / 8;
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = kNegInf;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        if (MASK && k0 + 8 * n + 2 * t + e >= lim[r]) x = kNegInf;
        mx = fmaxf(mx, x);
      }
    const float m_new = fmaxf(m[r], quad_max(mx) * scale_log2);
    alpha[r] = exp2_approx(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& x = sc[4 * n + 2 * r + e];
        x = exp2_approx(fmaf(x, scale_log2, -m[r]));
        if (MASK && k0 + 8 * n + 2 * t + e >= lim[r]) x = 0.f;
        psum[r] += x;
      }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + quad_sum(psum[r]);
  if (s.dropout) {  // the denominator above summed the undropped p
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          sc[4 * n + 2 * r + e] *= dropout_scale(s, bh, row0 + 8 * r,
                                                 k0 + 8 * n + 2 * t + e);
  }
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const float* x = sc + 8 * kk;
    p[kk][0] = pack_bf16(x[0], x[1]);
    p[kk][1] = pack_bf16(x[2], x[3]);
    p[kk][2] = pack_bf16(x[4], x[5]);
    p[kk][3] = pack_bf16(x[6], x[7]);
  }
}

template <int HD, int BK, int ST>
__global__ void __launch_bounds__(FwdWg<HD, BK, ST>::kThreads, 1)
fwd_kernel_bf16(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                bf16* __restrict__ o, float* __restrict__ lse, Shape s) {
  using T = FwdWg<HD, BK, ST>;
  constexpr int G = T::kGroups;
  constexpr int NS = BK / 8;  // n tiles of S
  constexpr int NO = HD / 8;  // n tiles of O
  extern __shared__ unsigned char fwd_wg_smem[];
  unsigned char* sQ =
      fwd_wg_smem + ((1024 - (smem_u32(fwd_wg_smem) & 1023)) & 1023);
  unsigned char* ring = sQ + T::kQBytes;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(ring + T::kStages *
                                                            T::kStageBytes);
  uint64_t* v_full = k_full + T::kStages;
  uint64_t* empty = v_full + T::kStages;
  uint64_t* q_full = empty + T::kStages;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;  // longest first
  const int n_tiles = (key_end(s, q0, kFwdBQ) + BK - 1) / BK;
  // The warpgroup, read from lane 0 so that the compiler sees it is the
  // same across the warp: a branch on it is not divergent, and the
  // wgmma under it need not be serialised.
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_map(qmap);
    prefetch_map(kmap);
    prefetch_map(vmap);
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(empty + i, 128);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the loader: Q once, then every key tile in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c)
        tma_load(sQ + c * kFwdBQ * 128, qmap, q_full, 64 * c, h, q0, b);
      for (int j = 0; j < n_tiles; ++j) {
        const int i = j / G, st = (j % G) * ST + i % ST;
        mbar_wait(empty + st, ((i / ST) & 1) ^ 1);
        unsigned char* dst = ring + st * T::kStageBytes;
        mbar_expect_tx(k_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(dst + c * BK * 128, kmap, k_full + st, 64 * c, h, j * BK,
                   b);
        mbar_expect_tx(v_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(dst + T::kTileBytes + c * BK * 128, vmap, v_full + st,
                   64 * c, h, j * BK, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int group = wg - 1, tid = threadIdx.x % 128;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8 here
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    lim[r] = qp >= s.Tq ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  // Keys below warp_lim are in band for all 16 rows of this warp: a tile
  // below it needs no mask (the same for every lane).
  const int wq = q0 + warp * 16;
  const int warp_lim = wq + 15 >= s.Tq ? 0
                       : s.causal      ? min(s.Tk, wq + s.src_len + 1)
                                       : s.Tk;
  const float scale_log2 = s.scale * 1.4426950408889634f;
  const int mine = n_tiles > group ? (n_tiles - group + G - 1) / G : 0;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float acc[HD / 2];  // O
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2];          // S of the tile
  uint32_t p[NS / 2][4];     // its P, bf16 pairs
  // The descriptors of Q's first box and of this group's first stage's K
  // and V; stage u is u kStageBytes further.
  const uint64_t qd = sw128_desc(sQ, 16, 1024);
  const uint64_t kd = sw128_desc(ring + group * ST * T::kStageBytes, 16,
                                 1024);
  const uint64_t vd = sw128_desc(
      ring + group * ST * T::kStageBytes + T::kTileBytes, BK * 128, 1024);
  constexpr int kStageStep = T::kStageBytes / 16;
  // The softmax of tile i of this group's walk: its P into pt, alpha.
  auto softmax = [&](int i, float (&alpha)[2], uint32_t (&pt)[NS / 2][4]) {
    const int k0 = (group + G * i) * BK;
    if (k0 + BK > warp_lim)
      softmax_tile<BK, true>(sc, pt, m, l, alpha, lim, k0, row0, t, gbh,
                             scale_log2, s);
    else
      softmax_tile<BK, false>(sc, pt, m, l, alpha, lim, k0, row0, t, gbh,
                              scale_log2, s);
  };
  mbar_wait(q_full, 0);

  // Tile i: wait for its K (and the V of tile i - 1), issue S of tile i
  // (and P.V of tile i - 1), wait for them; then its softmax, and O
  // rescaled. Tile 0 and the last P.V are peeled off, so that no wgmma
  // sits under a branch of its own.
  if (mine > 0) {
    float alpha[2];
    mbar_wait(k_full + group * ST, 0);
    pin(sc);
    wgmma_fence();
    issue_s<HD, BK>(sc, qd, kd);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    softmax(0, alpha, p);  // O is still 0: nothing to rescale
    for (int i = 1; i < mine; ++i) {
      const int u = i % ST, up = (i - 1) % ST;
      mbar_wait(k_full + group * ST + u, (i / ST) & 1);
      mbar_wait(v_full + group * ST + up, ((i - 1) / ST) & 1);
      pin(sc);
      pin(acc);
      wgmma_fence();
      issue_s<HD, BK>(sc, qd, kd + u * kStageStep);
      issue_pv<HD, BK>(acc, p, vd + up * kStageStep);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(acc);
      mbar_arrive(empty + group * ST + up);
      softmax(i, alpha, p);
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * c + e] *= alpha[e >> 1];
    }
    const int up = (mine - 1) % ST;
    mbar_wait(v_full + group * ST + up, ((mine - 1) / ST) & 1);
    pin(acc);
    wgmma_fence();
    issue_pv<HD, BK>(acc, p, vd + up * kStageStep);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive(empty + group * ST + up);
  }

  // Group 1 hands (m, l, O) to group 0 through its own stages, which no
  // copy fills any more; group 0 merges them into its own in that fixed
  // order, so a second call gives the same bits. A thread's float4 c is at
  // xch[128 c + tid]: O's n tile c, then (m, l).
  float4* xch = reinterpret_cast<float4*>(ring + ST * T::kStageBytes) + tid;
  if (group == 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < NO; ++c)
      xch[128 * c] = make_float4(acc[4 * c], acc[4 * c + 1],
                                 acc[4 * c + 2], acc[4 * c + 3]);
    xch[128 * NO] = make_float4(m[0], m[1], l[0], l[1]);
    asm volatile("bar.arrive 1, 256;\n" ::: "memory");
    return;
  }
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const float4 ml = xch[128 * NO];
  float a0[2], a1[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m1 = r ? ml.y : ml.x, l1 = r ? ml.w : ml.z;
    const float m_new = fmaxf(m[r], m1);
    a0[r] = exp2_approx(m[r] - m_new);
    a1[r] = exp2_approx(m1 - m_new);
    l[r] = l[r] * a0[r] + l1 * a1[r];
    m[r] = m_new;
  }
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const float4 x = xch[128 * c];
    acc[4 * c] = acc[4 * c] * a0[0] + x.x * a1[0];
    acc[4 * c + 1] = acc[4 * c + 1] * a0[0] + x.y * a1[0];
    acc[4 * c + 2] = acc[4 * c + 2] * a0[1] + x.z * a1[1];
    acc[4 * c + 3] = acc[4 * c + 3] * a0[1] + x.w * a1[1];
  }

  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e; lse = m ln 2 +
  // log l.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    const float den = l[r] == 0.f ? 1.f : l[r], inv = 1.f / den;
    bf16* out = o + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) * HD +
                2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[4 * c + 2 * r] * inv, acc[4 * c + 2 * r + 1] * inv);
    if (t == 0)
      lse[static_cast<long long>(bh) * s.Tq + qp] =
          m[r] * 0.6931471805599453f + logf(den);
  }
}

// The backward's bf16 tiles: BwdTiles' rows, walk and warp split, bf16
// rows of stride LD, and, for dK/dV, each stage's lse and D in f32 behind
// its Q and dO tiles. The groups' sums (f32) meet in the ring at the end.
template <int HD>
struct BwdTiles16 {
  using T = BwdTiles<HD>;
  static constexpr int LD = Ld16<HD>::LD;
  static constexpr int KS = HD < 16 ? 1 : HD / T::KW / 16;  // k steps of S
  static constexpr int kDqStage = 2 * T::WALK * LD;                // bf16
  static constexpr int kDkvStage = 2 * T::WALK * LD + 4 * T::WALK;  // bf16
  static constexpr size_t kOwn = sizeof(bf16) * 2 * T::ROWS * LD;
  static constexpr size_t kXch = sizeof(float) * T::kXch;
  static constexpr size_t kDqSmem = kOwn + sizeof(bf16) * 4 * kDqStage + kXch;
  static constexpr size_t kDkvSmem =
      kOwn + sizeof(bf16) * 4 * kDkvStage + kXch;
  static_assert(kDkvSmem <= 232448, "over the 227 KB a block may use");
  // group 1's sums (4 warps x registers x 32 lanes, f32) fit in the ring
  static_assert(sizeof(float) * 4 * 2 * T::J * 4 * 32 <=
                    sizeof(bf16) * 4 * kDkvStage &&
                sizeof(float) * 4 * T::J * 4 * 32 <=
                    sizeof(bf16) * 4 * kDqStage,
                "reduction buffer");
};

// S = A0 B0^T and dP = A1 B1^T for this warp's 16 rows (qk_product16), the
// halves of d added through `xch` where two warps share the rows (hd 256),
// as qk_pair does for the f32 kernels.
template <int NS, int KS, int HD, int LD, int KW>
__device__ __forceinline__ void qk_pair16(float (&s0)[NS][4], const bf16* a0,
                                          const bf16* b0, float (&s1)[NS][4],
                                          const bf16* a1, const bf16* b1,
                                          float* xch, int gw, int lane,
                                          int group) {
  qk_product16<NS, KS, HD, LD>(s0, a0, b0);
  qk_product16<NS, KS, HD, LD>(s1, a1, b1);
  if constexpr (KW == 2) {
    constexpr int kWarp = 2 * NS * 4 * 32;
    float* mine = xch + gw * kWarp + lane;
    const float* other = xch + (gw ^ 2) * kWarp + lane;
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        mine[32 * (4 * n + e)] = s0[n][e];
        mine[32 * (4 * (NS + n) + e)] = s1[n][e];
      }
    group_sync(group);
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s0[n][e] += other[32 * (4 * n + e)];
        s1[n][e] += other[32 * (4 * (NS + n) + e)];
      }
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
dq_kernel_bf16_mma(View16 q, View16 k, View16 v, View16 dout,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dq, Shape s) {
  using T = BwdTiles<HD>;
  using U = BwdTiles16<HD>;
  constexpr int LD = U::LD, BQ = T::ROWS, BK = T::WALK, NS = T::NS;
  constexpr int J = T::J, kStage = U::kDqStage;
  extern __shared__ __align__(16) unsigned char bwd16_smem[];
  bf16* sQ = reinterpret_cast<bf16*>(bwd16_smem);
  bf16* sO = sQ + BQ * LD;  // dO
  bf16* ring = sO + BQ * LD;  // [group][stage]: K, V
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2, gw = warp & 3;
  const int rw = gw % T::RW, dcol = (gw / T::RW) * T::DW;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;  // longest walks first
  const int n_tiles = (key_end(s, q0, BQ) + BK - 1) / BK;  // in band
  const int mine = walk_count(n_tiles, group);
  bf16* gring = ring + group * 2 * kStage;
  float* xch = reinterpret_cast<float*>(ring + 4 * kStage) +
               group * 4 * T::kXchWarp;

  copy_rows16<HD, BQ, LD, kBwdThreads>(sQ, q, b, h, q0, s.Tq, threadIdx.x);
  copy_rows16<HD, BQ, LD, kBwdThreads>(sO, dout, b, h, q0, s.Tq, threadIdx.x);
  if (mine > 0) {
    copy_rows16<HD, BK, LD, kGroupThreads>(gring, k, b, h, group * BK, s.Tk,
                                           gtid);
    copy_rows16<HD, BK, LD, kGroupThreads>(gring + BK * LD, v, b, h,
                                           group * BK, s.Tk, gtid);
  }
  cp_async_commit();

  const int row0 = q0 + 16 * rw + g;  // this thread's rows: row0, row0 + 8
  float row_lse[2], row_d[2];
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    const bool ok = qp < s.Tq;
    const long long at = static_cast<long long>(bh) * s.Tq + qp;
    row_lse[r] = ok ? lse[at] : 0.f;
    row_d[r] = ok ? dsum[at] : 0.f;
    lim[r] = !ok ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  float acc[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const bf16* qa = sQ + (16 * rw + g) * LD + 2 * t + dcol;
  const bf16* oa = sO + (16 * rw + g) * LD + 2 * t + dcol;
  cp_async_wait<0>();
  __syncthreads();  // the block's Q and dO, and each group's first tile

  for (int i = 0; i < mine; ++i) {
    if (i > 0) {
      cp_async_wait<0>();
      group_sync(group);  // tile i landed; stage (i + 1) & 1 is free
    }
    const bf16* cK = gring + (i & 1) * kStage;
    const bf16* cV = cK + BK * LD;
    if (i + 1 < mine) {
      bf16* nK = gring + ((i + 1) & 1) * kStage;
      const int k1 = (group + kWalkers * (i + 1)) * BK;
      copy_rows16<HD, BK, LD, kGroupThreads>(nK, k, b, h, k1, s.Tk, gtid);
      copy_rows16<HD, BK, LD, kGroupThreads>(nK + BK * LD, v, b, h, k1,
                                             s.Tk, gtid);
      cp_async_commit();
    }
    const int k0 = (group + kWalkers * i) * BK;

    // S = Q K^T and dP = dO V^T; sc[n][2r + e] is row row0 + 8r, key
    // k0 + 8n + 2t + e.
    float sc[NS][4], dp[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[n][e] = dp[n][e] = 0.f;
    qk_pair16<NS, U::KS, HD, LD, T::KW>(
        sc, qa, cK + g * LD + 2 * t + dcol, dp, oa,
        cV + g * LD + 2 * t + dcol, xch, gw, lane, group);

    // dS = P (M dP - D), P = exp(s scale - lse) in band, 0 elsewhere.
    if (s.dropout) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[n][e] *= dropout_scale(s, gbh, row0 + 8 * (e >> 1),
                                    k0 + 8 * n + 2 * t + (e & 1));
    }
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const float p = expf(sc[n][e] * s.scale - row_lse[r]);
        sc[n][e] = k0 + 8 * n + 2 * t + (e & 1) < lim[r]
                       ? p * (dp[n][e] - row_d[r])
                       : 0.f;
      }

    // dQ += dS K, dS rounded to bf16 (k's dtype) in registers.
    pv_product16<NS, J, LD>(acc, sc, cK + dcol, lane);
  }

  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* red = reinterpret_cast<float*>(ring) + gw * 4 * J * 32 + lane;
  if (group == 1) put_sums(red, acc);
  __syncthreads();
  if (group == 1) return;
  add_sums(acc, red);
  // acc[j][2r + e] is row row0 + 8r, d = dcol + 8j + 2t + e.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    bf16* out = dq + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) *
                         HD + dcol + 2 * t;
#pragma unroll
    for (int j = 0; j < J; ++j)
      *reinterpret_cast<uint32_t*>(out + 8 * j) =
          pack_bf16(acc[j][2 * r] * s.scale, acc[j][2 * r + 1] * s.scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kBwdThreads, 1)
dkv_kernel_bf16_mma(View16 q, View16 k, View16 v, View16 dout,
                const float* __restrict__ lse,
                const float* __restrict__ dsum, bf16* __restrict__ dk,
                bf16* __restrict__ dv, Shape s) {
  using T = BwdTiles<HD>;
  using U = BwdTiles16<HD>;
  constexpr int LD = U::LD, BK = T::ROWS, BQ = T::WALK, NS = T::NS;
  constexpr int J = T::J, kStage = U::kDkvStage;
  extern __shared__ __align__(16) unsigned char bwd16_smem[];
  bf16* sK = reinterpret_cast<bf16*>(bwd16_smem);
  bf16* sV = sK + BK * LD;
  bf16* ring = sV + BK * LD;  // [group][stage]: Q, dO, lse, D
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int group = warp >> 2, gw = warp & 3;
  const int rw = gw % T::RW, dcol = (gw / T::RW) * T::DW;
  const int gtid = threadIdx.x - group * kGroupThreads;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int k0 = blockIdx.y * BK;  // the first key tiles walk the longest
  const int first = (s.causal ? max(0, k0 - s.src_len) : 0) / BQ;
  const int n_tiles = max(0, (s.Tq + BQ - 1) / BQ - first);
  const int mine = walk_count(n_tiles, group);
  bf16* gring = ring + group * 2 * kStage;
  float* xch = reinterpret_cast<float*>(ring + 4 * kStage) +
               group * 4 * T::kXchWarp;
  const float* lse_bh = lse + static_cast<long long>(bh) * s.Tq;
  const float* d_bh = dsum + static_cast<long long>(bh) * s.Tq;

  // Q, dO, lse and D of q tile `tile` into `stage` of this group's ring.
  auto copy_q_tile = [&](int tile, int stage) {
    bf16* dst = gring + stage * kStage;
    const int q0 = tile * BQ;
    copy_rows16<HD, BQ, LD, kGroupThreads>(dst, q, b, h, q0, s.Tq, gtid);
    copy_rows16<HD, BQ, LD, kGroupThreads>(dst + BQ * LD, dout, b, h, q0,
                                           s.Tq, gtid);
    if (gtid < 2 * BQ) {
      const int r = gtid % BQ, qp = q0 + r;
      const bool ok = qp < s.Tq;
      const float* src = gtid < BQ ? lse_bh : d_bh;
      float* rows = reinterpret_cast<float*>(dst + 2 * BQ * LD);
      cp_async4(rows + gtid, ok ? src + qp : src, ok);
    }
  };

  copy_rows16<HD, BK, LD, kBwdThreads>(sK, k, b, h, k0, s.Tk, threadIdx.x);
  copy_rows16<HD, BK, LD, kBwdThreads>(sV, v, b, h, k0, s.Tk, threadIdx.x);
  if (mine > 0) copy_q_tile(first + group, 0);
  cp_async_commit();

  const int key0 = k0 + 16 * rw + g;  // this thread's keys: key0, key0 + 8
  int qlo[2];  // query q sees key key0 + 8r iff qlo[r] <= q < Tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    qlo[r] = kp >= s.Tk ? s.Tq : s.causal ? kp - s.src_len : 0;
  }
  float gk[J][4], gv[J][4];
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) gk[j][i] = gv[j][i] = 0.f;
  const bf16* ka = sK + (16 * rw + g) * LD + 2 * t + dcol;
  const bf16* va = sV + (16 * rw + g) * LD + 2 * t + dcol;
  cp_async_wait<0>();
  __syncthreads();  // the block's K and V, and each group's first tile

  for (int i = 0; i < mine; ++i) {
    if (i > 0) {
      cp_async_wait<0>();
      group_sync(group);  // tile i landed; stage (i + 1) & 1 is free
    }
    const bf16* cQ = gring + (i & 1) * kStage;
    const bf16* cO = cQ + BQ * LD;
    const float* cL = reinterpret_cast<const float*>(cO + BQ * LD);
    const float* cD = cL + BQ;
    if (i + 1 < mine) {
      copy_q_tile(first + group + kWalkers * (i + 1), (i + 1) & 1);
      cp_async_commit();
    }
    const int q0 = (first + group + kWalkers * i) * BQ;

    // S^T = K Q^T and dP^T = V dO^T; st[n][2r + e] is key key0 + 8r,
    // query q0 + 8n + 2t + e.
    float st[NS][4], dpt[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[n][e] = dpt[n][e] = 0.f;
    qk_pair16<NS, U::KS, HD, LD, T::KW>(
        st, ka, cQ + g * LD + 2 * t + dcol, dpt, va,
        cO + g * LD + 2 * t + dcol, xch, gw, lane, group);

    // P = exp(s scale - lse) in band, 0 elsewhere; then st <- P M and
    // dpt <- dS = P (M dP - D).
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * n + 2 * t + (e & 1), qp = q0 + c;
        const float p = expf(st[n][e] * s.scale - cL[c]);
        st[n][e] = qp >= qlo[e >> 1] && qp < s.Tq ? p : 0.f;
      }
    if (s.dropout) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = 8 * n + 2 * t + (e & 1);
          const float m =
              dropout_scale(s, gbh, q0 + c, key0 + 8 * (e >> 1));
          const float p = st[n][e];
          dpt[n][e] = p * (dpt[n][e] * m - cD[c]);
          st[n][e] = p * m;
        }
    } else {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[n][e] = st[n][e] * (dpt[n][e] - cD[8 * n + 2 * t + (e & 1)]);
    }

    // dV += (P M)^T dO and dK += dS^T Q, P M and dS rounded to bf16 (dO's
    // and q's dtype) in registers.
    pv_product16<NS, J, LD>(gv, st, cO + dcol, lane);
    pv_product16<NS, J, LD>(gk, dpt, cQ + dcol, lane);
  }

  cp_async_wait<0>();
  __syncthreads();  // both groups are done with their rings
  float* red = reinterpret_cast<float*>(ring) + gw * 8 * J * 32 + lane;
  if (group == 1) {
    put_sums(red, gk);
    put_sums(red + 4 * J * 32, gv);
  }
  __syncthreads();
  if (group == 1) return;
  add_sums(gk, red);
  add_sums(gv, red + 4 * J * 32);
  // gk[j][2r + e] is key key0 + 8r, d = dcol + 8j + 2t + e; gv likewise.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    if (kp >= s.Tk) continue;
    const long long at =
        ((static_cast<long long>(b) * s.Tk + kp) * s.H + h) * HD + dcol +
        2 * t;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * j) =
          pack_bf16(gk[j][2 * r] * s.scale, gk[j][2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * j) =
          pack_bf16(gv[j][2 * r], gv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 backward for Hopper at hd 64, 128 and 256 (dq_kernel_bf16,
// dkv_kernel_bf16): wgmma fed by TMA, the walk split between two consumer
// warpgroups (see the note at the top)
// ---------------------------------------------------------------------------

// An arrival on bar once every cp.async this thread issued before has
// landed, counted in bar's expected arrivals (noinc).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Tiles and rings of dq_kernel_bf16: a block owns 64 q rows (kFwdBQ), whose
// Q and dO land once on one barrier; the loader hands the in-band key tiles
// of BK keys to the two consumer groups in turn (walk_group), each through
// a ring of ST stages (K, then V, each with its own barrier). Every tile is
// boxes of 64 columns (128 bytes) by its rows, in TMA's 128-byte swizzle.
template <int HD, int BK, int ST>
struct DqWg {
  static constexpr int kThreads = 384;
  static constexpr int kBoxes = HD / 64;
  static constexpr int kOwnBytes = kFwdBQ * HD * 2;  // Q or dO
  static constexpr int kTileBytes = BK * HD * 2;     // K or V
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = 2 * ST;
  // Group 1's dQ sum at the merge, a float4 at a time for each thread.
  static constexpr int kXchBytes = HD / 8 * 128 * 16;
  // 1024 bytes to align the base to a swizzle atom; the barriers behind
  // the ring: K and V landed, the stage free, Q and dO landed.
  static constexpr size_t kSmem =
      1024 + 2 * kOwnBytes + kStages * kStageBytes + 8 * (3 * kStages + 1);
  static_assert(HD % 64 == 0 && HD <= 256 && (BK == 32 || BK == 64),
                "tile shape");
  static_assert(kXchBytes <= kStages * kStageBytes, "exchange buffer");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// dS = P (M dP - D) of the key tile at k0 for this thread's rows row0 and
// row0 + 8 of a dQ block, in the accumulator layout of S (sc) and dP (dp,
// overwritten): element 4n + 2r + e is row r, key k0 + 8n + 2t + e. P =
// exp(s scale - lse) = 2^(s scale log2(e) - lse2), lse2 = lse log2(e); M
// the dropout scale. dS goes to bf16 pairs in ds: n tiles 2kk and 2kk + 1
// are the A fragment of k step kk of dQ += dS K. MASK: some key of the
// tile lies past a row's band (key k is in band for row r iff k <
// lim[r]); the select keeps an exp that overflowed there out of dS.
template <int BK, bool MASK>
__device__ __forceinline__ void dq_grad_tile(
    const float (&sc)[BK / 2], float (&dp)[BK / 2],
    uint32_t (&ds)[BK / 16][4], const int (&lim)[2], const float (&lse2)[2],
    const float (&dr)[2], int k0, int row0, int t, unsigned bh,
    float scale_log2, const Shape& s) {
  constexpr int NS = BK / 8;
  if (s.dropout) {
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          dp[4 * n + 2 * r + e] *= dropout_scale(s, bh, row0 + 8 * r,
                                                 k0 + 8 * n + 2 * t + e);
  }
#pragma unroll
  for (int n = 0; n < NS; ++n)
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * r + e;
        float x = exp2_approx(fmaf(sc[i], scale_log2, -lse2[r])) *
                  (dp[i] - dr[r]);
        if (MASK && k0 + 8 * n + 2 * t + e >= lim[r]) x = 0.f;
        dp[i] = x;
      }
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const float* x = dp + 8 * kk;
    ds[kk][0] = pack_bf16(x[0], x[1]);
    ds[kk][1] = pack_bf16(x[2], x[3]);
    ds[kk][2] = pack_bf16(x[4], x[5]);
    ds[kk][3] = pack_bf16(x[6], x[7]);
  }
}

template <int HD, int BK, int ST>
__global__ void __launch_bounds__(DqWg<HD, BK, ST>::kThreads, 1)
dq_kernel_bf16(const __grid_constant__ CUtensorMap qmap,
               const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap,
               const __grid_constant__ CUtensorMap omap,
               const float* __restrict__ lse, const float* __restrict__ dsum,
               bf16* __restrict__ dq, Shape s) {
  using T = DqWg<HD, BK, ST>;
  constexpr int NS = BK / 8;  // n tiles of S and dP
  constexpr int NO = HD / 8;  // n tiles of dQ
  extern __shared__ unsigned char dq_wg_smem[];
  unsigned char* sQ =
      dq_wg_smem + ((1024 - (smem_u32(dq_wg_smem) & 1023)) & 1023);
  unsigned char* sO = sQ + T::kOwnBytes;  // dO
  unsigned char* ring = sO + T::kOwnBytes;
  uint64_t* k_full = reinterpret_cast<uint64_t*>(ring + T::kStages *
                                                            T::kStageBytes);
  uint64_t* v_full = k_full + T::kStages;
  uint64_t* empty = v_full + T::kStages;
  uint64_t* qo_full = empty + T::kStages;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kFwdBQ;  // longest first
  const int n_tiles = (key_end(s, q0, kFwdBQ) + BK - 1) / BK;
  // The warpgroup, read from lane 0 so that the compiler sees it is the
  // same across the warp (as in fwd_kernel_bf16).
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_map(qmap);
    prefetch_map(kmap);
    prefetch_map(vmap);
    prefetch_map(omap);
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(k_full + i, 1);
      mbar_init(v_full + i, 1);
      mbar_init(empty + i, 128);
    }
    mbar_init(qo_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the loader: Q and dO once, then every key tile in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    if (threadIdx.x == 0) {
      mbar_expect_tx(qo_full, 2 * T::kOwnBytes);
#pragma unroll
      for (int c = 0; c < T::kBoxes; ++c) {
        tma_load(sQ + c * kFwdBQ * 128, qmap, qo_full, 64 * c, h, q0, b);
        tma_load(sO + c * kFwdBQ * 128, omap, qo_full, 64 * c, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int i = j / kWalkers, st = j % kWalkers * ST + i % ST;
        mbar_wait(empty + st, ((i / ST) & 1) ^ 1);
        unsigned char* dst = ring + st * T::kStageBytes;
        mbar_expect_tx(k_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(dst + c * BK * 128, kmap, k_full + st, 64 * c, h, j * BK,
                   b);
        mbar_expect_tx(v_full + st, T::kTileBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c)
          tma_load(dst + T::kTileBytes + c * BK * 128, vmap, v_full + st,
                   64 * c, h, j * BK, b);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int group = wg - 1, tid = threadIdx.x % 128;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = q0 + warp * 16 + g;  // rows row0 and row0 + 8 here
  const float log2e = 1.4426950408889634f;
  int lim[2];  // key k is in band for row row0 + 8r iff k < lim[r]
  float lse2[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    const bool ok = qp < s.Tq;
    const long long at = static_cast<long long>(bh) * s.Tq + qp;
    lse2[r] = ok ? lse[at] * log2e : 0.f;
    dr[r] = ok ? dsum[at] : 0.f;
    lim[r] = !ok ? 0 : s.causal ? min(s.Tk, qp + s.src_len + 1) : s.Tk;
  }
  // Keys below warp_lim are in band for all 16 rows of this warp: a tile
  // below it needs no mask (the same for every lane).
  const int wq = q0 + warp * 16;
  const int warp_lim = wq + 15 >= s.Tq ? 0
                       : s.causal      ? min(s.Tk, wq + s.src_len + 1)
                                       : s.Tk;
  const float scale_log2 = s.scale * log2e;
  const int mine = walk_count(n_tiles, group);
  float acc[HD / 2];  // dQ
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float sc[BK / 2], dp[BK / 2];  // S and dP of the tile
  uint32_t ds[NS / 2][4];        // its dS, bf16 pairs
  // Descriptors of Q's and dO's first box, and of this group's first
  // stage's K and V as the K-major B of S = Q K^T and dP = dO V^T and K as
  // the MN-major B of dQ += dS K; stage u is u kStageBytes further.
  unsigned char* mine_ring = ring + group * ST * T::kStageBytes;
  const uint64_t qd = sw128_desc(sQ, 16, 1024);
  const uint64_t od = sw128_desc(sO, 16, 1024);
  const uint64_t kd = sw128_desc(mine_ring, 16, 1024);
  const uint64_t vd = sw128_desc(mine_ring + T::kTileBytes, 16, 1024);
  const uint64_t km = sw128_desc(mine_ring, BK * 128, 1024);
  constexpr int kStageStep = T::kStageBytes / 16;
  // dS of tile i of this group's walk into ds.
  auto grad = [&](int i) {
    const int k0 = (group + kWalkers * i) * BK;
    if (k0 + BK > warp_lim)
      dq_grad_tile<BK, true>(sc, dp, ds, lim, lse2, dr, k0, row0, t, gbh,
                             scale_log2, s);
    else
      dq_grad_tile<BK, false>(sc, dp, ds, lim, lse2, dr, k0, row0, t, gbh,
                              scale_log2, s);
  };
  mbar_wait(qo_full, 0);

  // Tile i: wait for its K and V, issue S and dP of tile i (and dQ += dS K
  // of tile i - 1), wait for them, free tile i - 1's stage; then dS of
  // tile i. Tile 0 and the last dS K are peeled off, so that no wgmma sits
  // under a branch of its own.
  if (mine > 0) {
    mbar_wait(k_full + group * ST, 0);
    mbar_wait(v_full + group * ST, 0);
    pin(sc);
    pin(dp);
    wgmma_fence();
    issue_s<HD, BK>(sc, qd, kd);
    issue_s<HD, BK>(dp, od, vd);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    pin(dp);
    grad(0);
    for (int i = 1; i < mine; ++i) {
      const int u = i % ST, up = (i - 1) % ST;
      mbar_wait(k_full + group * ST + u, (i / ST) & 1);
      mbar_wait(v_full + group * ST + u, (i / ST) & 1);
      pin(sc);
      pin(dp);
      pin(acc);
      wgmma_fence();
      issue_s<HD, BK>(sc, qd, kd + u * kStageStep);
      issue_s<HD, BK>(dp, od, vd + u * kStageStep);
      issue_pv<HD, BK>(acc, ds, km + up * kStageStep);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dp);
      pin(acc);
      mbar_arrive(empty + group * ST + up);
      grad(i);
    }
    const int up = (mine - 1) % ST;
    pin(acc);
    wgmma_fence();
    issue_pv<HD, BK>(acc, ds, km + up * kStageStep);
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    mbar_arrive(empty + group * ST + up);
  }

  // Both walks are done, so the ring is free: group 1 hands its dQ to
  // group 0 through it, which adds it to its own in that fixed order, so a
  // second call gives the same bits. A thread's float4 c is at xch[128 c +
  // tid].
  asm volatile("bar.sync 2, 256;\n" ::: "memory");
  float4* xch = reinterpret_cast<float4*>(ring) + tid;
  if (group == 1) {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < NO; ++c)
      xch[128 * c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                                 acc[4 * c + 3]);
    asm volatile("bar.arrive 3, 256;\n" ::: "memory");
    return;
  }
  asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
  for (int c = 0; c < NO; ++c) {
    const float4 x = xch[128 * c];
    acc[4 * c] += x.x;
    acc[4 * c + 1] += x.y;
    acc[4 * c + 2] += x.z;
    acc[4 * c + 3] += x.w;
  }
  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qp = row0 + 8 * r;
    if (qp >= s.Tq) continue;
    bf16* out = dq + ((static_cast<long long>(b) * s.Tq + qp) * s.H + h) *
                         HD + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c)
      *reinterpret_cast<uint32_t*>(out + 8 * c) =
          pack_bf16(acc[4 * c + 2 * r] * s.scale,
                    acc[4 * c + 2 * r + 1] * s.scale);
  }
}

// Tiles and rings of dkv_kernel_bf16: a block owns 64 keys (kFwdBQ), whose
// K and V land once on one barrier; the loader hands the q tiles of BQ rows
// from the first in band on to the two consumer groups. Without SPLIT_D
// they walk alternate q tiles (kWalkers) for all of d, each through a ring
// of ST stages, their dK and dV summed at the end; with SPLIT_D both walk
// every q tile of one ring of ST stages, each for its half of d's columns
// of dK and dV, forming S^T and dP^T over its half of d and adding the
// other group's half through shared memory. A stage is Q, then dO, each with its own
// barrier; its lse and D sit apart, behind the ring, in a slot of 2 BQ
// floats, copied by the loader's first warp with 4-byte cp.async that
// arrive on Q's barrier as they land (a row of Tq floats is no legal
// tensor-map stride, and a 1-D tensor map over the flat buffer faulted on
// the card: illegal instruction).
template <int HD, int BQ, int ST, bool SPLIT_D>
struct DkvWg {
  static constexpr int kThreads = 384;
  static constexpr int kBoxes = HD / 64;
  // d columns of dK and dV a group owns, and the d of its S^T and dP^T
  static constexpr int DW = SPLIT_D ? HD / 2 : HD;
  static constexpr int SD = DW;
  static constexpr int kOwnBytes = kFwdBQ * HD * 2;  // K or V
  static constexpr int kTileBytes = BQ * HD * 2;     // Q or dO
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = SPLIT_D ? ST : 2 * ST;
  static constexpr int kReleasers = SPLIT_D ? 256 : 128;  // of a stage
  // SPLIT_D: each group's halves of S^T and dP^T, BQ floats a thread, in
  // two buffers (tile parity).
  static constexpr int kHalfFloats = SPLIT_D ? 2 * 2 * BQ * 128 : 0;
  // Without: group 1's dK and dV at the merge, float4s, in the ring.
  static constexpr int kXchBytes = SPLIT_D ? 0 : 2 * DW / 8 * 128 * 16;
  // 1024 bytes to align the base to a swizzle atom; behind the ring the
  // lse and D slots, the halves, then the barriers: Q (with lse and D) and
  // dO landed, the stage free, K and V landed.
  static constexpr size_t kSmem =
      1024 + 2 * kOwnBytes + kStages * kStageBytes +
      4 * (kStages * 2 * BQ + kHalfFloats) + 8 * (3 * kStages + 1);
  static_assert(HD % 64 == 0 && HD <= 256 && (BQ == 32 || BQ == 64) &&
                    DW % 64 == 0 && SD % 64 == 0,
                "tile shape");
  static_assert(kXchBytes <= kStages * kStageBytes, "exchange buffer");
  static_assert(kSmem <= 232448, "over the 227 KB a block may use");
};

// P M and dS = P (M dP - D) of the q tile at q0 for this thread's keys key0
// and key0 + 8 of a dK/dV block, in the accumulator layout of S^T (st) and
// dP^T (dpt), both overwritten: element 4n + 2r + e is key r, query q0 +
// 8n + 2t + e, whose lse and D are lse_s and d_s at 8n + 2t + e. P =
// exp(s scale - lse) = 2^(s scale log2(e) - lse log2(e)); M the dropout
// scale. P M and dS go to bf16 pairs in pm and ds: n tiles 2kk and 2kk + 1
// are the A fragment of k step kk of dV += (P M)^T dO and dK += dS^T Q.
// MASK: some query of the tile lies outside a key's band (query q sees key
// r iff qlo[r] <= q < Tq); P = 0 there keeps an exp that overflowed, and
// the lse and D of rows past Tq, out of both.
template <int BQ, bool MASK>
__device__ __forceinline__ void dkv_grad_tile(
    float (&st)[BQ / 2], float (&dpt)[BQ / 2], uint32_t (&pm)[BQ / 16][4],
    uint32_t (&ds)[BQ / 16][4], const float* lse_s, const float* d_s,
    const int (&qlo)[2], int q0, int key0, int t, unsigned bh,
    float scale_log2, const Shape& s) {
  constexpr int NS = BQ / 8;
  const float log2e = 1.4426950408889634f;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * n + 2 * t);
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * n + 2 * r + e, qp = q0 + 8 * n + 2 * t + e;
        float p = exp2_approx(fmaf(st[i], scale_log2,
                                   -(e ? l.y : l.x) * log2e));
        if (MASK && (qp < qlo[r] || qp >= s.Tq)) p = 0.f;
        st[i] = p;
      }
  }
  if (s.dropout) {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * n + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * r + e;
          const float m = dropout_scale(s, bh, q0 + 8 * n + 2 * t + e,
                                        key0 + 8 * r);
          const float p = st[i];
          dpt[i] = p * (dpt[i] * m - (e ? d.y : d.x));
          st[i] = p * m;
        }
    }
  } else {
#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const float2 d = *reinterpret_cast<const float2*>(d_s + 8 * n + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * n + 2 * r + e;
          dpt[i] = st[i] * (dpt[i] - (e ? d.y : d.x));
        }
    }
  }
#pragma unroll
  for (int kk = 0; kk < NS / 2; ++kk) {
    const float* x = st + 8 * kk;
    const float* y = dpt + 8 * kk;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      pm[kk][j] = pack_bf16(x[2 * j], x[2 * j + 1]);
      ds[kk][j] = pack_bf16(y[2 * j], y[2 * j + 1]);
    }
  }
}

template <int HD, int BQ, int ST, bool SPLIT_D>
__global__ void __launch_bounds__(DkvWg<HD, BQ, ST, SPLIT_D>::kThreads, 1)
dkv_kernel_bf16(const __grid_constant__ CUtensorMap qmap,
                const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap,
                const __grid_constant__ CUtensorMap omap,
                const float* __restrict__ lse, const float* __restrict__ dsum,
                bf16* __restrict__ dk, bf16* __restrict__ dv, Shape s) {
  using T = DkvWg<HD, BQ, ST, SPLIT_D>;
  constexpr int NS = BQ / 8;     // n tiles of S^T and dP^T
  constexpr int NO = T::DW / 8;  // n tiles of a group's dK and dV
  extern __shared__ unsigned char dkv_wg_smem[];
  unsigned char* sK =
      dkv_wg_smem + ((1024 - (smem_u32(dkv_wg_smem) & 1023)) & 1023);
  unsigned char* sV = sK + T::kOwnBytes;
  unsigned char* ring = sV + T::kOwnBytes;
  // [stage][lse, D][BQ]
  float* rows = reinterpret_cast<float*>(ring + T::kStages * T::kStageBytes);
  float* halves = rows + T::kStages * 2 * BQ;  // [tile & 1][group][BQ][128]
  uint64_t* q_full = reinterpret_cast<uint64_t*>(halves + T::kHalfFloats);
  uint64_t* o_full = q_full + T::kStages;
  uint64_t* empty = o_full + T::kStages;
  uint64_t* kv_full = empty + T::kStages;
  const int bh = blockIdx.x, b = bh / s.H, h = bh % s.H;
  const unsigned gbh = global_bh(s, bh);
  const int k0 = blockIdx.y * kFwdBQ;  // the first key tiles walk the longest
  const int first = (s.causal ? max(0, k0 - s.src_len) : 0) / BQ;
  const int n_tiles = max(0, (s.Tq + BQ - 1) / BQ - first);
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    prefetch_map(qmap);
    prefetch_map(kmap);
    prefetch_map(vmap);
    prefetch_map(omap);
    for (int i = 0; i < T::kStages; ++i) {
      mbar_init(q_full + i, 1 + 32);  // the loader's Q, its warp's lse, D
      mbar_init(o_full + i, 1);
      mbar_init(empty + i, T::kReleasers);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {  // the loader: K and V once, then every q tile in order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kLoaderRegs));
    if (threadIdx.x < 32) {  // lane 0 the tiles, every lane lse and D
      const int lane = threadIdx.x;
      const float* lse_bh = lse + static_cast<long long>(bh) * s.Tq;
      const float* d_bh = dsum + static_cast<long long>(bh) * s.Tq;
      if (lane == 0) {
        mbar_expect_tx(kv_full, 2 * T::kOwnBytes);
#pragma unroll
        for (int c = 0; c < T::kBoxes; ++c) {
          tma_load(sK + c * kFwdBQ * 128, kmap, kv_full, 64 * c, h, k0, b);
          tma_load(sV + c * kFwdBQ * 128, vmap, kv_full, 64 * c, h, k0, b);
        }
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int i = SPLIT_D ? j : j / kWalkers;
        const int st = SPLIT_D ? i % ST : j % kWalkers * ST + i % ST;
        mbar_wait(empty + st, ((i / ST) & 1) ^ 1);
        unsigned char* dst = ring + st * T::kStageBytes;
        float* slot = rows + st * 2 * BQ;
        const int qt = (first + j) * BQ;
        if (lane == 0) {
          mbar_expect_tx(q_full + st, T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(dst + c * BQ * 128, qmap, q_full + st, 64 * c, h, qt,
                     b);
          mbar_expect_tx(o_full + st, T::kTileBytes);
#pragma unroll
          for (int c = 0; c < T::kBoxes; ++c)
            tma_load(dst + T::kTileBytes + c * BQ * 128, omap, o_full + st,
                     64 * c, h, qt, b);
        }
        // lse and D of the tile's rows, zeros past Tq
        for (int r = lane; r < BQ; r += 32) {
          const bool ok = qt + r < s.Tq;
          cp_async4(slot + r, ok ? lse_bh + qt + r : lse_bh, ok);
          cp_async4(slot + BQ + r, ok ? d_bh + qt + r : d_bh, ok);
        }
        cp_async_arrive(q_full + st);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));

  const int group = wg - 1, tid = threadIdx.x % 128;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int key0 = k0 + warp * 16 + g;  // keys key0 and key0 + 8 here
  int qlo[2];  // query q sees key key0 + 8r iff qlo[r] <= q < Tq
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    qlo[r] = kp >= s.Tk ? s.Tq : s.causal ? kp - s.src_len : 0;
  }
  // Queries from warp_qlo on see all 16 keys of this warp: a tile from
  // there to Tq needs no mask (the same for every lane).
  const int wk = k0 + warp * 16;
  const int warp_qlo = wk + 15 >= s.Tk ? s.Tq
                       : s.causal      ? wk + 15 - s.src_len
                                       : 0;
  const float scale_log2 = s.scale * 1.4426950408889634f;
  const int mine = SPLIT_D ? n_tiles : walk_count(n_tiles, group);
  const int ring0 = SPLIT_D ? 0 : group * ST;  // this group's first stage
  float gk[T::DW / 2], gv[T::DW / 2];  // dK, dV
#pragma unroll
  for (int i = 0; i < T::DW / 2; ++i) gk[i] = gv[i] = 0.f;
  float st[BQ / 2], dpt[BQ / 2];          // S^T and dP^T of the tile
  uint32_t pm[NS / 2][4], ds[NS / 2][4];  // its P M and dS, bf16 pairs
  // Descriptors: K and V as the K-major A of S^T = K Q^T and dP^T = V dO^T
  // over this group's d (its first 64-column box: sbox); Q and dO of its
  // first stage as their K-major B, and as the MN-major B of dK += dS^T Q
  // and dV += (P M)^T dO over the columns it owns (obox); stage u is u
  // kStageBytes further.
  const int sbox = SPLIT_D ? group * (T::SD / 64) : 0;
  const int obox = SPLIT_D ? group * (T::DW / 64) : 0;
  unsigned char* first_stage = ring + ring0 * T::kStageBytes;
  const uint64_t kd = sw128_desc(sK + sbox * kFwdBQ * 128, 16, 1024);
  const uint64_t vd = sw128_desc(sV + sbox * kFwdBQ * 128, 16, 1024);
  const uint64_t qd = sw128_desc(first_stage + sbox * BQ * 128, 16, 1024);
  const uint64_t od = sw128_desc(
      first_stage + T::kTileBytes + sbox * BQ * 128, 16, 1024);
  const uint64_t qm = sw128_desc(first_stage + obox * BQ * 128, BQ * 128,
                                 1024);
  const uint64_t om = sw128_desc(
      first_stage + T::kTileBytes + obox * BQ * 128, BQ * 128, 1024);
  constexpr int kStageStep = T::kStageBytes / 16;
  // SPLIT_D: add the other group's half of S^T and dP^T of tile i to this
  // group's (a + b in one group, b + a in the other: the same bits).
  auto add_halves = [&](int i) {
    if constexpr (SPLIT_D) {
      float* mine_h = halves + ((i & 1) * 2 + group) * BQ * 128 + tid;
      const float* other =
          halves + ((i & 1) * 2 + (group ^ 1)) * BQ * 128 + tid;
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        mine_h[128 * j] = st[j];
        mine_h[128 * (BQ / 2 + j)] = dpt[j];
      }
      asm volatile("bar.sync 4, 256;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        st[j] += other[128 * j];
        dpt[j] += other[128 * (BQ / 2 + j)];
      }
    }
  };
  // P M and dS of tile i of this group's walk (stage ring0 + i % ST).
  auto grad = [&](int i) {
    const int q0 = (first + (SPLIT_D ? i : group + kWalkers * i)) * BQ;
    const float* slot = rows + (ring0 + i % ST) * 2 * BQ;
    if (q0 < warp_qlo || q0 + BQ > s.Tq)
      dkv_grad_tile<BQ, true>(st, dpt, pm, ds, slot, slot + BQ, qlo, q0,
                              key0, t, gbh, scale_log2, s);
    else
      dkv_grad_tile<BQ, false>(st, dpt, pm, ds, slot, slot + BQ, qlo, q0,
                               key0, t, gbh, scale_log2, s);
  };
  mbar_wait(kv_full, 0);

  // Tile i: wait for its Q and dO, issue S^T and dP^T of tile i (and dV +=
  // (P M)^T dO, dK += dS^T Q of tile i - 1), wait for them, free tile i -
  // 1's stage; then P M and dS of tile i. Tile 0 and the last products are
  // peeled off, so that no wgmma sits under a branch of its own.
  if (mine > 0) {
    mbar_wait(q_full + ring0, 0);
    mbar_wait(o_full + ring0, 0);
    pin(st);
    pin(dpt);
    wgmma_fence();
    issue_s<T::SD, BQ>(st, kd, qd);
    issue_s<T::SD, BQ>(dpt, vd, od);
    wgmma_commit();
    wgmma_wait<0>();
    pin(st);
    pin(dpt);
    add_halves(0);
    grad(0);
    for (int i = 1; i < mine; ++i) {
      const int u = i % ST, up = (i - 1) % ST;
      mbar_wait(q_full + ring0 + u, (i / ST) & 1);
      mbar_wait(o_full + ring0 + u, (i / ST) & 1);
      pin(st);
      pin(dpt);
      pin(gk);
      pin(gv);
      wgmma_fence();
      issue_s<T::SD, BQ>(st, kd, qd + u * kStageStep);
      issue_s<T::SD, BQ>(dpt, vd, od + u * kStageStep);
      issue_pv<T::DW, BQ>(gv, pm, om + up * kStageStep);
      issue_pv<T::DW, BQ>(gk, ds, qm + up * kStageStep);
      wgmma_commit();
      wgmma_wait<0>();
      pin(st);
      pin(dpt);
      pin(gk);
      pin(gv);
      mbar_arrive(empty + ring0 + up);
      add_halves(i);
      grad(i);
    }
    const int up = (mine - 1) % ST;
    pin(gk);
    pin(gv);
    wgmma_fence();
    issue_pv<T::DW, BQ>(gv, pm, om + up * kStageStep);
    issue_pv<T::DW, BQ>(gk, ds, qm + up * kStageStep);
    wgmma_commit();
    wgmma_wait<0>();
    pin(gk);
    pin(gv);
    mbar_arrive(empty + ring0 + up);
  }

  if constexpr (!SPLIT_D) {
    // Both walks are done, so the ring is free: group 1 hands its dK and
    // dV to group 0 through it, which adds them to its own in that fixed
    // order, so a second call gives the same bits. A thread's float4 c is
    // at xch[128 c + tid]: dK's n tile c, then dV's.
    asm volatile("bar.sync 2, 256;\n" ::: "memory");
    float4* xch = reinterpret_cast<float4*>(ring) + tid;
    if (group == 1) {
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int c = 0; c < NO; ++c) {
        xch[128 * c] = make_float4(gk[4 * c], gk[4 * c + 1], gk[4 * c + 2],
                                   gk[4 * c + 3]);
        xch[128 * (NO + c)] = make_float4(gv[4 * c], gv[4 * c + 1],
                                          gv[4 * c + 2], gv[4 * c + 3]);
      }
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");
      return;
    }
    asm volatile("bar.sync 3, 256;\n" ::: "memory");
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      const float4 x = xch[128 * c], y = xch[128 * (NO + c)];
      gk[4 * c] += x.x;
      gk[4 * c + 1] += x.y;
      gk[4 * c + 2] += x.z;
      gk[4 * c + 3] += x.w;
      gv[4 * c] += y.x;
      gv[4 * c + 1] += y.y;
      gv[4 * c + 2] += y.z;
      gv[4 * c + 3] += y.w;
    }
  }
  // gk[4c + 2r + e] is key key0 + 8r, d = 64 obox + 8c + 2t + e; gv
  // likewise.
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kp = key0 + 8 * r;
    if (kp >= s.Tk) continue;
    const long long at =
        ((static_cast<long long>(b) * s.Tk + kp) * s.H + h) * HD +
        64 * obox + 2 * t;
#pragma unroll
    for (int c = 0; c < NO; ++c) {
      *reinterpret_cast<uint32_t*>(dk + at + 8 * c) =
          pack_bf16(gk[4 * c + 2 * r] * s.scale,
                    gk[4 * c + 2 * r + 1] * s.scale);
      *reinterpret_cast<uint32_t*>(dv + at + 8 * c) =
          pack_bf16(gv[4 * c + 2 * r], gv[4 * c + 2 * r + 1]);
    }
  }
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

template <int HD>
int launch_dq(View q, View k, View v, View dout, const float* lse,
              const float* dsum, float* dq, Shape s, cudaStream_t stream) {
  constexpr size_t smem = BwdTiles<HD>::kDqSmem;
  static const cudaError_t set = allow_smem(dq_kernel<HD>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(s.B * s.H,
                  (s.Tq + BwdTiles<HD>::ROWS - 1) / BwdTiles<HD>::ROWS);
  dq_kernel<HD><<<grid, kBwdThreads, smem, stream>>>(q, k, v, dout, lse,
                                                     dsum, dq, s);
  return cudaGetLastError();
}

template <int HD>
int launch_dkv(View q, View k, View v, View dout, const float* lse,
               const float* dsum, float* dk, float* dv, Shape s,
               cudaStream_t stream) {
  constexpr size_t smem = BwdTiles<HD>::kDkvSmem;
  static const cudaError_t set = allow_smem(dkv_kernel<HD>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(s.B * s.H,
                  (s.Tk + BwdTiles<HD>::ROWS - 1) / BwdTiles<HD>::ROWS);
  dkv_kernel<HD><<<grid, kBwdThreads, smem, stream>>>(q, k, v, dout, lse,
                                                      dsum, dk, dv, s);
  return cudaGetLastError();
}

template <int HD, int BK>
int launch_fwd_bf16_mma(View16 q, View16 k, View16 v, bf16* o, float* lse,
                        Shape s, cudaStream_t stream) {
  constexpr size_t smem = FwdTiles16<HD, BK>::kSmem;
  static const cudaError_t set =
      allow_smem(fwd_kernel_bf16_mma<HD, BK>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid((s.Tq + kFwdBQ - 1) / kFwdBQ, s.B * s.H);
  fwd_kernel_bf16_mma<HD, BK><<<grid, kFwdThreads, smem, stream>>>(
      q, k, v, o, lse, s);
  return cudaGetLastError();
}

// cuTensorMapEncodeTiled, a driver function, through the runtime's entry
// point query: the library links no more than the runtime (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return rc == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// x [B, T, H, hd] bf16 as a 4-D tensor map (hd, H, T, B): boxes of 64
// columns by `rows` rows of one (b, h), 128-byte swizzle, rows past T read
// as zeros. TMA wants the start and every stride on 16 bytes (the
// wrapper's rule); a dim of size 1 may carry any stride there, so it gets
// the packed one.
bool encode_rows(CUtensorMap* map, const View16& x, int B, int T, int H,
                 int HD, int rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(HD),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(T),
                              static_cast<cuuint64_t>(B)};
  cuuint64_t strides[3];
  strides[0] = H == 1 ? 2ull * HD : 2ull * x.sh;
  strides[1] = T == 1 ? strides[0] * H : 2ull * x.st;
  strides[2] = B == 1 ? strides[1] * T : 2ull * x.sb;
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t step[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
            const_cast<bf16*>(x.p), dims, strides, box, step,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int BK, int ST>
int launch_fwd_bf16(View16 q, View16 k, View16 v, bf16* o, float* lse,
                    Shape s, cudaStream_t stream) {
  using T = FwdWg<HD, BK, ST>;
  static const cudaError_t set =
      allow_smem(fwd_kernel_bf16<HD, BK, ST>, T::kSmem);
  if (set != cudaSuccess) return set;
  CUtensorMap qmap, kmap, vmap;
  if (!encode_rows(&qmap, q, s.B, s.Tq, s.H, HD, kFwdBQ) ||
      !encode_rows(&kmap, k, s.B, s.Tk, s.H, HD, BK) ||
      !encode_rows(&vmap, v, s.B, s.Tk, s.H, HD, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(s.B * s.H, (s.Tq + kFwdBQ - 1) / kFwdBQ);
  fwd_kernel_bf16<HD, BK, ST><<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, o, lse, s);
  return cudaGetLastError();
}

template <int HD, int BK, int ST>
int launch_dq_bf16(View16 q, View16 k, View16 v, View16 dout,
                   const float* lse, const float* dsum, bf16* dq, Shape s,
                   cudaStream_t stream) {
  using T = DqWg<HD, BK, ST>;
  static const cudaError_t set =
      allow_smem(dq_kernel_bf16<HD, BK, ST>, T::kSmem);
  if (set != cudaSuccess) return set;
  CUtensorMap qmap, kmap, vmap, omap;
  if (!encode_rows(&qmap, q, s.B, s.Tq, s.H, HD, kFwdBQ) ||
      !encode_rows(&omap, dout, s.B, s.Tq, s.H, HD, kFwdBQ) ||
      !encode_rows(&kmap, k, s.B, s.Tk, s.H, HD, BK) ||
      !encode_rows(&vmap, v, s.B, s.Tk, s.H, HD, BK))
    return cudaErrorInvalidValue;
  const dim3 grid(s.B * s.H, (s.Tq + kFwdBQ - 1) / kFwdBQ);
  dq_kernel_bf16<HD, BK, ST><<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, omap, lse, dsum, dq, s);
  return cudaGetLastError();
}

template <int HD, int BQ, int ST, bool SPLIT_D>
int launch_dkv_bf16(View16 q, View16 k, View16 v, View16 dout,
                    const float* lse, const float* dsum, bf16* dk, bf16* dv,
                    Shape s, cudaStream_t stream) {
  using T = DkvWg<HD, BQ, ST, SPLIT_D>;
  static const cudaError_t set =
      allow_smem(dkv_kernel_bf16<HD, BQ, ST, SPLIT_D>, T::kSmem);
  if (set != cudaSuccess) return set;
  CUtensorMap qmap, kmap, vmap, omap;
  if (!encode_rows(&qmap, q, s.B, s.Tq, s.H, HD, BQ) ||
      !encode_rows(&omap, dout, s.B, s.Tq, s.H, HD, BQ) ||
      !encode_rows(&kmap, k, s.B, s.Tk, s.H, HD, kFwdBQ) ||
      !encode_rows(&vmap, v, s.B, s.Tk, s.H, HD, kFwdBQ))
    return cudaErrorInvalidValue;
  const dim3 grid(s.B * s.H, (s.Tk + kFwdBQ - 1) / kFwdBQ);
  dkv_kernel_bf16<HD, BQ, ST, SPLIT_D>
      <<<grid, T::kThreads, T::kSmem, stream>>>(
      qmap, kmap, vmap, omap, lse, dsum, dk, dv, s);
  return cudaGetLastError();
}

template <int HD>
int launch_dq_bf16_mma(View16 q, View16 k, View16 v, View16 dout,
                       const float* lse, const float* dsum, bf16* dq,
                       Shape s, cudaStream_t stream) {
  constexpr size_t smem = BwdTiles16<HD>::kDqSmem;
  static const cudaError_t set = allow_smem(dq_kernel_bf16_mma<HD>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(s.B * s.H,
                  (s.Tq + BwdTiles<HD>::ROWS - 1) / BwdTiles<HD>::ROWS);
  dq_kernel_bf16_mma<HD><<<grid, kBwdThreads, smem, stream>>>(
      q, k, v, dout, lse, dsum, dq, s);
  return cudaGetLastError();
}

template <int HD>
int launch_dkv_bf16_mma(View16 q, View16 k, View16 v, View16 dout,
                        const float* lse, const float* dsum, bf16* dk,
                        bf16* dv, Shape s, cudaStream_t stream) {
  constexpr size_t smem = BwdTiles16<HD>::kDkvSmem;
  static const cudaError_t set = allow_smem(dkv_kernel_bf16_mma<HD>, smem);
  if (set != cudaSuccess) return set;
  const dim3 grid(s.B * s.H,
                  (s.Tk + BwdTiles<HD>::ROWS - 1) / BwdTiles<HD>::ROWS);
  dkv_kernel_bf16_mma<HD><<<grid, kBwdThreads, smem, stream>>>(
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
  s.bh_map = nullptr;
  s.pos_hash = 0u;
  return s;
}

View view(const void* p, long long sb, long long st, long long sh) {
  View x;
  x.p = static_cast<const float*>(p);
  x.sb = sb; x.st = st; x.sh = sh;
  return x;
}

View16 view16(const void* p, long long sb, long long st, long long sh) {
  View16 x;
  x.p = static_cast<const bf16*>(p);
  x.sb = sb; x.st = st; x.sh = sh;
  return x;
}

// s with a bh_map (null: the identity) and global position offsets.
Shape sharded(Shape s, const void* bh_map, int q_off, int k_off) {
  s.bh_map = static_cast<const int*>(bh_map);
  s.pos_hash = static_cast<unsigned>(q_off) * 0x9E3779B9u +
               static_cast<unsigned>(k_off) * 0x3243F6A9u;
  return s;
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
// 128 or 256. bh_map: null or int32 [B*H], the global b*H + h each local
// row hashes with; q_off, k_off: added to the q and k positions the
// dropout hash sees. Each entry returns cudaGetLastError() after its
// launch (0 on success); an unsupported hd returns cudaErrorInvalidValue.
#define SEA_FLASH_ARGS                                                    \
  int B, int H, int Tq, int Tk, int hd, int causal, int src_len,          \
      unsigned seed0, unsigned seed1, unsigned threshold, float inv_keep, \
      int dropout, const void* bh_map, int q_off, int k_off, void* stream
#define SEA_FLASH_SHAPE                                                   \
  sharded(make_shape(B, H, Tq, Tk, hd, causal, src_len, seed0, seed1,     \
                     threshold, inv_keep, dropout),                       \
          bh_map, q_off, k_off)

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
    case 8: return launch_dq<8>(Q, K, V, dO, L, D, dQ, s, st);
    case 16: return launch_dq<16>(Q, K, V, dO, L, D, dQ, s, st);
    case 64: return launch_dq<64>(Q, K, V, dO, L, D, dQ, s, st);
    case 128: return launch_dq<128>(Q, K, V, dO, L, D, dQ, s, st);
    case 256: return launch_dq<256>(Q, K, V, dO, L, D, dQ, s, st);
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
    case 8: return launch_dkv<8>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 16: return launch_dkv<16>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 64: return launch_dkv<64>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 128: return launch_dkv<128>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 256: return launch_dkv<256>(Q, K, V, dO, L, D, dK, dV, s, st);
    default: return cudaErrorInvalidValue;
  }
}

// The bf16 forms: the same arguments, q, k, v and dO bf16 (strides in
// elements), o/dq/dk/dv contiguous bf16, lse and dsum f32.
extern "C" int sea_flash_fwd_bf16(const void* q, long long qsb, long long qst,
                                  long long qsh, const void* k, long long ksb,
                                  long long kst, long long ksh, const void* v,
                                  long long vsb, long long vst, long long vsh,
                                  void* o, void* lse, SEA_FLASH_ARGS) {
  const View16 Q = view16(q, qsb, qst, qsh), K = view16(k, ksb, kst, ksh),
               V = view16(v, vsb, vst, vsh);
  const Shape s = SEA_FLASH_SHAPE;
  bf16* O = static_cast<bf16*>(o);
  float* L = static_cast<float*>(lse);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    // hd 8 and 16: the mma.sync form; 64 to 256: wgmma and TMA (note above)
    case 8: return launch_fwd_bf16_mma<8, 64>(Q, K, V, O, L, s, st);
    case 16: return launch_fwd_bf16_mma<16, 64>(Q, K, V, O, L, s, st);
    case 64: return launch_fwd_bf16<64, 64, 4>(Q, K, V, O, L, s, st);
    case 128: return launch_fwd_bf16<128, 64, 3>(Q, K, V, O, L, s, st);
    case 256: return launch_fwd_bf16<256, 32, 3>(Q, K, V, O, L, s, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int sea_flash_bwd_dq_bf16(
    const void* q, long long qsb, long long qst, long long qsh,
    const void* k, long long ksb, long long kst, long long ksh,
    const void* v, long long vsb, long long vst, long long vsh,
    const void* dout, long long osb, long long ost, long long osh,
    const void* lse, const void* dsum, void* dq, SEA_FLASH_ARGS) {
  const View16 Q = view16(q, qsb, qst, qsh), K = view16(k, ksb, kst, ksh),
               V = view16(v, vsb, vst, vsh),
               dO = view16(dout, osb, ost, osh);
  const Shape s = SEA_FLASH_SHAPE;
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(dsum);
  bf16* dQ = static_cast<bf16*>(dq);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    // hd 8 and 16: the mma.sync form; 64 to 256: wgmma and TMA (note above)
    case 8: return launch_dq_bf16_mma<8>(Q, K, V, dO, L, D, dQ, s, st);
    case 16: return launch_dq_bf16_mma<16>(Q, K, V, dO, L, D, dQ, s, st);
    case 64:
      return launch_dq_bf16<64, 64, 2>(Q, K, V, dO, L, D, dQ, s, st);
    case 128:
      return launch_dq_bf16<128, 64, 3>(Q, K, V, dO, L, D, dQ, s, st);
    case 256:
      return launch_dq_bf16<256, 32, 2>(Q, K, V, dO, L, D, dQ, s, st);
    default: return cudaErrorInvalidValue;
  }
}

extern "C" int sea_flash_bwd_dkv_bf16(
    const void* q, long long qsb, long long qst, long long qsh,
    const void* k, long long ksb, long long kst, long long ksh,
    const void* v, long long vsb, long long vst, long long vsh,
    const void* dout, long long osb, long long ost, long long osh,
    const void* lse, const void* dsum, void* dk, void* dv, SEA_FLASH_ARGS) {
  const View16 Q = view16(q, qsb, qst, qsh), K = view16(k, ksb, kst, ksh),
               V = view16(v, vsb, vst, vsh),
               dO = view16(dout, osb, ost, osh);
  const Shape s = SEA_FLASH_SHAPE;
  const float* L = static_cast<const float*>(lse);
  const float* D = static_cast<const float*>(dsum);
  bf16* dK = static_cast<bf16*>(dk);
  bf16* dV = static_cast<bf16*>(dv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (hd) {
    // hd 8 and 16: the mma.sync form; 64 to 256: wgmma and TMA (note above)
    case 8: return launch_dkv_bf16_mma<8>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 16: return launch_dkv_bf16_mma<16>(Q, K, V, dO, L, D, dK, dV, s, st);
    case 64:
      return launch_dkv_bf16<64, 64, 4, false>(Q, K, V, dO, L, D, dK, dV, s,
                                               st);
    case 128:
      return launch_dkv_bf16<128, 32, 3, false>(Q, K, V, dO, L, D, dK, dV, s,
                                                st);
    case 256:
      return launch_dkv_bf16<256, 32, 3, true>(Q, K, V, dO, L, D, dK, dV, s,
                                               st);
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
