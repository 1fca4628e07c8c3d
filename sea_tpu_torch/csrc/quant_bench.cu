// Kernels of the int4 matvec microbenchmarks (sea_tpu_torch/tools/), one
// launch a call each. They take the serving int4 matvec (csrc/quant_matmul.cu,
// the port of sea_tpu/ops/quant_matmul.py::_mv_kernel) apart: the byte
// stream alone, the unpack alone, three ways to unpack a nibble, int8
// weights, and output-major weights.
//
// They replace the eight Pallas TPU functions under tools/:
//
//   tools/bench_quant_matvec.py:56    matvec_p4          p4_mma<kP4>
//   tools/bench_quant_matvec.py:85    matvec_p4b         p4_mma<kP4b>
//   tools/bench_quant_matvec.py:118   matvec_p4c         p4_mma<kP4c>
//   tools/bench_quant_matvec.py:142   matvec_s8          s8_mma
//   tools/bench_quant_matvec.py:169   stream_bytes       reduce_kernel
//   tools/bench_quant_matvec.py:186   dma_only           copy_kernel
//   tools/bench_unpack_ceiling.py:73  _unpack_only_call  unpack_sums
//   tools/bench_unpack_ceiling.py:115 _mvt_call          mvt_mma<kVec>
//
// Storage is the tools': wp uint8 [K/2, N], byte [k, n] holding w[k, n] in
// its low nibble and w[k + K/2, n] in its high one (input-major);
// _mvt_call's wpt uint8 [N, K/2] holds the same nibbles output-major;
// matvec_s8's w8 is int8 [K, N]. x is bf16 [B, K], s an f32 scale per
// output column, y f32 [B, N].
//
// What bounds them: memory. Each reads its weight once, K/2 * N bytes
// (K * N for matvec_s8): 16.8 MB at the tools' (K, N) = (2048, 16384),
// 5.0 us at 3.35 TB/s. The matvecs do 2 B multiply-adds a weight, far
// below the ~295 operations a byte at which the bf16 tensor cores, and not
// the memory, would limit.
//
//  - The five matvecs, s8_mma (matvec_s8), mvt_mma (_mvt_call) and p4_mma
//    (matvec_p4, p4b and p4c), run the products as bf16 mma.sync.m16n8k16
//    with f32 accumulators, the serving int4 matvec's mechanism
//    (csrc/quant_matmul.cu): the weights are A (16 output columns x 16 k),
//    x is B (16 k x 8 rows of x; rows at or past B are zero, so every B in
//    1..8 runs the same MMAs and costs the same). A weight becomes its
//    exact value in bf16 and meets bf16 x in an exact product; sums are f32
//    and s multiplies once at the end. Lane (g, t) = (lane / 4, lane % 4)
//    holds A rows g and g + 8 at k slots {2t, 2t + 1} and {2t + 8, 2t + 9}.
//    The k order inside an MMA is free as long as x's B fragment follows
//    it; each kernel picks it so that a lane's A comes from few, contiguous
//    bytes. None stages anything: weights go from device memory into registers with 16- or
//    8-byte loads, a warp's load covering whole 32-byte sectors, and the
//    next step's loads are issued before the current step's MMAs (bytes in
//    flight); x comes through L1, where every warp of the block reads it.
//    Split-K runs across the warps of a block, whose sums meet in shared
//    memory in warp order: a fixed order, so two calls give the same bits.
//
//    s8_mma, input-major int8 w8 [K, N]: a warp owns 128 columns, lane
//    group g the 16 bytes [16 g, 16 g + 16) of each row, so one warp load
//    reads 4 rows of 128 contiguous bytes. An MMA step covers 16 rows; k
//    slot 2t is row t, 2t + 1 row t + 4, 2t + 8 row t + 8, 2t + 9 row t +
//    12, so a lane holds 4 rows' 16 bytes and MMA tile j (of 8) takes bytes
//    2j and 2j + 1 of them as its A rows g and g + 8: tile j's 16 rows are
//    the columns {16 g + 2j, 16 g + 2j + 1 : g = 0..7}. B is x[g] at k t,
//    t + 4, t + 8, t + 12: four 2-byte loads and two byte permutes a step.
//    An int8 is exact in bf16 (8 significant bits), but the lop3 trick of
//    the nibbles gives only 7 mantissa bits. Two ways were counted from the
//    instruction sequences, per 8 weight bytes (one MMA tile of a lane):
//    (a) one XOR of the word with 0x80808080 (w + 128; a quarter a byte),
//    one byte permute building the f32 1.5 * 2^23 + (w + 128), one f32
//    subtraction, and one cvt.rn.bf16x2.f32 a pair: 2 + 8 + 8 + 4 = 22
//    instructions and 1 MMA; (b) the byte split into an unsigned low
//    nibble and a signed high one, x times 16 for the latter, two exact
//    bf16 planes by the lop3 trick: 2 permutes + 4 x (lop3 + subtraction)
//    + 4 x (shift + lop3 + subtraction) + the shifts of the second
//    register = 24 and 2 MMAs. (a) is the kernel's. 16 warps a block
//    split the block's K in steps of 16 rows, taken in turn; one block an
//    SM, N / 128 blocks: 128 at N = 16384.
//
//    mvt_mma, output-major wt uint8 [N, K/2]: a block owns 64 columns, 4
//    MMA tiles; tile j's A rows g and g + 8 are the columns 16 j + g and 16
//    j + g + 8. A step covers 32 packed bytes of every column (4 MMAs):
//    lane t reads the 8 bytes [8 t, 8 t + 8) of its two columns, so a
//    quad reads 32 contiguous bytes, one sector. The byte's low nibble is
//    k = p and its high one k = p + K/2, the two halves of the reduction:
//    MMA s takes bytes 2s and 2s + 1 of the lane's 8, their low nibbles as
//    k slots 2t, 2t + 1 and their high ones as 2t + 8, 2t + 9. So B is
//    x[g][p], x[g][p + 1] and x[g][K/2 + p], x[g][K/2 + p + 1]: contiguous
//    pairs, one 16-byte load of each half a step. One byte permute pairs
//    bytes (2s, 2s + 1) of the two columns; then per A register a shift
//    and one lop3, (v & 0x000F000F) ^ 0x43084308, give 128 + (nibble ^ 8)
//    = 136 + w as two bf16, and one bf16x2 subtraction of 136 gives w
//    exactly (csrc/quant_matmul.cu's nibbles_to_bf16x2): about 12
//    instructions an MMA, 3 a weight byte. The TPU kernel's bias form (lo
//    + 8, 16 hi, the rank-1 term) is a Mosaic workaround and is not
//    carried over. 8 warps a block split K/2 in steps of 32 bytes, taken
//    in turn; two blocks an SM, N / 64 blocks: 256 at N = 16384. K/2 not a
//    multiple of 8, or x or w off their 16- and 8-byte alignment, take the
//    kernel's other form, which reads w in 4-byte words and x element by
//    element.
//
//    p4_mma<F>, input-major int4 wp [K/2, N] (matvec_p4, p4b, p4c), takes
//    s8_mma's grid, warps and loads over packed rows (a warp owns 128
//    columns, lane group g the 16 bytes [16 g, 16 g + 16) of each row; tile
//    j's A rows g and g + 8 are the columns 16 g + 2j and 16 g + 2j + 1; 16
//    warps split K/2 in steps of 16 packed rows, taken in turn; one block an
//    SM, N / 128 blocks) and mvt_mma's pairing of a byte's two nibbles as
//    the two halves of K. A step is two k slices: lane t holds the packed
//    rows 4t .. 4t + 3 of the step (16 st + those), and slice s takes rows
//    4t + 2s and 4t + 2s + 1, their low nibbles as k slots 2t and 2t + 1
//    and their high ones as 2t + 8 and 2t + 9, so B is x[g] at the two rows
//    and at K/2 plus them: the lane's four rows of x[g] are contiguous, one
//    8-byte load in each half a step (eight 2-byte loads when K/2 is not a
//    multiple of 4 or x is off 8 bytes; at B = 8 those touch 8 rows'
//    sectors each: chip_tools_probe.py's scalar_x). MMA tile j = 2q + h of
//    a slice takes bytes 2h and 2h + 1 of word q of each of its two rows.
//    Each form keeps its TPU kernel's integer unpack and turns its small
//    integers into bf16 exactly:
//
//      kP4   the 32-bit form, ((w & 0xF) ^ 8) - 8 and ((w >> 4) ^ 8) - 8.
//            One byte permute gathers the MMA's 4 bytes in v; v and v >> 8
//            hold the lo plane's nibbles of A rows g and g + 8 at bits 0-3
//            and 16-19, v >> 4 and v >> 12 the hi plane's. Per A register
//            one lop3, (u & 0x000F000F) ^ 0x43084308 = 128 + (n ^ 8) in
//            each bf16 half, and one bf16x2 subtraction of 136 leave (n ^
//            8) - 8 exactly (mvt_mma's nibbles_to_bf16x2): 1 permute + 3
//            shifts + 4 x 2 = 12 instructions an MMA, 3 a weight byte. It
//            needs neither kP4c's 1/16 nor its rank-1 term.
//      kP4b  byte-width sign extension, int8(w << 4) >> 4 and int8(w) >> 4.
//            For the pair (a, b) of an A register (a in the low half): a
//            byte permute with sign-replicating selectors makes the 32-bit
//            int8 of a byte whose top nibble is a's nibble (w, or w << 4 for
//            the low plane), and another 2^16 times the int8 of b's byte with
//            its low nibble cleared (w & 0xF0, (w << 4) & 0xF0): 2^20 v_b.
//            One 3-input add sums them with the bias 16 * 0x4308 + 2^20 *
//            0x4308 (mod 2^32; 0x4308 is the bf16 136), and one funnel shift
//            right by 4 of (4 : sum), the carry the 32 bits lost, is the
//            arithmetic shift: it leaves 136 + v in each bf16 half, and one
//            bf16x2 subtraction of 136 leaves v. An MMA takes 4 x (2
//            permutes + add + shift + subtraction) and 2 for the shifted and
//            masked words (3 a word, which serve its two tiles): 22
//            instructions, 5.5 a weight byte.
//      kP4c  the bias form: lo + 8 = (w & 0xF) ^ 8 and 16 hi = int8(w) & -16.
//            v as for kP4; per A register a shift and one lop3, (v &
//            0x000F000F) ^ 0x43084308 = 128 + (lo + 8), or ((v >> 1) &
//            0x00780078) ^ 0x43C043C0, which puts w & 0xF0 in the mantissa
//            with its sign bit flipped, = 384 + 16 hi, and one bf16x2
//            subtraction (of 128 or 384) leave the planes: 12 instructions
//            an MMA, 3 a weight byte, as kP4. x's high half is read times
//            1/16 (one bf16x2 multiply a slice, exact), and 8 sum_{k < K/2}
//            x[b][k] is taken off each row's sum before the scale, the TPU
//            kernel's rank-1 term: each lane sums its B fragments' x in
//            f32, then the lanes of a row (two shuffles) and the warps in
//            order.
//
//  - reduce_kernel (stream_bytes): a grid of (row splits, column tiles),
//    enough blocks to fill the card twice; 16-byte loads, 4 rows in flight
//    a thread. The column sums fold across blocks with 64-bit integer
//    atomics: exact and independent of order. The last block to arrive (a
//    counter in the same scratch) writes the result and zeroes the scratch
//    for the next call.
//  - unpack_sums (_unpack_only_call) sums a 32-bit word w of 4 packed bytes
//    at a time: one lop3, (w & 0x0F0F0F0F) ^ 0x08080808, leaves each byte's
//    (b & 0xF) ^ 8 (0..15) in place, and one unsigned dp4a against
//    0x01010101 adds the four to the thread's lo sum; one AND, w &
//    0xF0F0F0F0, leaves the four int8(b) & -16 as signed bytes, and one
//    signed dp4a adds them to hi. 4 instructions a word, 1 a byte (the
//    byte-by-byte form, extract, XOR, add, sign-extend, AND, add, took 6-7).
//    A block is 256 threads, each loading the 16 bytes of its column group
//    in 4 rows at once (64 bytes a thread, 16 KB a block; rows past K/2
//    read as 0x08080808, whose sums are 0), so a block owns lanes x 4 rows
//    of one column tile, lanes = 256 / (block_n / 16) rows side by side,
//    and the launcher's grid is (ceil(K/2 / rows), N / block_n): 1024
//    blocks at the tools' shape whatever block_n, two waves of about 4
//    blocks an SM (launch bounds: 4 blocks an SM). A block's sums stay
//    within 2^21 in magnitude (16 KB of bytes, each within 128), exact in
//    int32; its warps fold by shuffles, then in shared memory. sum(x):
//    block b (its index in launch order) also sums x's chunks b, b +
//    blocks, ... of 512 elements (2 a thread; its first chunk loaded
//    before its weights) in a fixed order into an f32 slot of the scratch,
//    so the sum is spread over the first blocks and no block reads all of
//    x. Every block stores its two sums, one 64-bit word, to its own word
//    of the scratch: they reach memory, so no block's unpack is dead code,
//    and no block waits for them. Only the blocks whose results the output
//    reads arrive on a counter (a fence, then an atomic): those of the last
//    tile, which the first-launched blocks (blockIdx.y = 0) read, and
//    those holding a chunk of x, the first ones too. The last of them adds
//    the last tile's words and the x slots in index order, writes the
//    result and zeroes the counter and the slots: two calls give the same
//    bits, and the first wave's tails run while the second wave streams.
//    chip_tools_probe.py takes this apart on the card: every block
//    arriving (arrive_all), none (no_arrive, the floor), 2 or 8 rows a
//    thread (rows2, rows8) and 8 elements of x a thread (x8).
//  - copy_kernel (dma_only): reduce_kernel's grid, each block copying its
//    rows into a ring of 4 shared-memory stages of up to 8 KB with 16-byte
//    cp.async, which the compiler cannot drop; only the block holding row
//    0 of the last tile reads it back and writes the result.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxB = 8;
// s8_mma and p4_mma: warps a block; columns a block (and a warp), MMA tiles
// of 16 of them, rows (packed rows for p4_mma) an MMA step. mvt_mma: warps a
// block; MMA tiles a block; packed bytes of a column an MMA step.
constexpr int kS8Warps = 16;
constexpr int kS8Threads = kS8Warps * 32;
constexpr int kS8Cols = 128;
constexpr int kS8Tiles = kS8Cols / 16;
constexpr int kS8StepRows = 16;
constexpr int kMvtWarps = 8;
constexpr int kMvtThreads = kMvtWarps * 32;
constexpr int kMvtTiles = 4;
constexpr int kMvtCols = 16 * kMvtTiles;
constexpr int kMvtStepBytes = 32;
// reduce_kernel: rows in flight a thread. copy_kernel: ring of stages.
constexpr int kReduceUnroll = 4;
constexpr int kRing = 4;
constexpr int kStageBytes = 8192;
// unpack_sums: rows a thread loads at once (its block's rows are its
// lanes times these), blocks an SM its launch bounds ask for, and the
// elements of x a thread adds for its block's chunk of x (kThreads times
// them).
constexpr int kUnpackRows = 4;
constexpr int kUnpackBlocksPerSm = 4;
constexpr int kXPerThread = 2;
constexpr int kXChunk = kThreads * kXPerThread;

enum Form : int { kP4 = 0, kP4b = 1, kP4c = 2, kS8 = 3, kOut = 4 };
enum Stream : int { kColumnSums = 0, kCopy = 2 };

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

__device__ __forceinline__ void mma_bf16(float (&d)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The unpacks' constants (tests/test_torch_tools_unpack.py reads them from
// here and replays the unpacks bit for bit). Byte permutes: kP4Gather[h]
// takes bytes 2h and 2h + 1 of a word of row r (the low half's k slot) and
// of row r + 1 (the high half's), so that v holds (column 16 g + 2j, r),
// (16 g + 2j + 1, r), (16 g + 2j, r + 1), (16 g + 2j + 1, r + 1) in its
// bytes 0..3; kP4bSext[i] is byte i of the first operand then its sign three
// times (its 32-bit int8), kP4bHigh[i] two zero bytes (the second operand,
// 0), byte i and its sign (2^16 times its int8).
constexpr uint32_t kP4Gather[2] = {0x5410u, 0x7632u};
constexpr uint32_t kP4bSext[4] = {0x8880u, 0x9991u, 0xAAA2u, 0xBBB3u};
constexpr uint32_t kP4bHigh[4] = {0x8044u, 0x9144u, 0xA244u, 0xB344u};
constexpr uint32_t kNibbleMask = 0xF0F0F0F0u;
// 16 * 0x4308 + 2^20 * 0x4308 mod 2^32; the 2^32s it drops, the high word
// of the funnel shift.
constexpr uint32_t kP4bBias = 0x30843080u;
constexpr uint32_t kP4bCarry = 4u;
constexpr uint32_t kBf16x2_136 = 0x43084308u;
// The nibbles at bits 0-3 and 16-19 as two bf16 128 + (n ^ 8): the lop3
// mask and xor of nibbles_to_bf16x2 (kP4, mvt_mma) and of kP4c's lo plane.
constexpr uint32_t kNibMask = 0x000F000Fu;
constexpr uint32_t kNibXor = 0x43084308u;
// kP4c: the lo plane's bf16 subtrahend (128); the hi plane's mask and xor,
// also its subtrahend (384); 1/16 in bf16.
constexpr uint32_t kP4cLoSub = 0x43004300u;
constexpr uint32_t kP4cHiMask = 0x00780078u;
constexpr uint32_t kP4cHiXor = 0x43C043C0u;
constexpr uint32_t kBf16x2_1_16 = 0x3D803D80u;
// unpack_sums: each byte's (b & 0xF) ^ 8 in place by one lop3; its int8(b)
// & -16 by kNibbleMask; the dp4a weights; the word a row past K/2 reads,
// whose two sums are 0.
constexpr uint32_t kWordLoMask = 0x0F0F0F0Fu;
constexpr uint32_t kWordLoXor = 0x08080808u;
constexpr uint32_t kOnes = 0x01010101u;
constexpr uint32_t kPadWord = 0x08080808u;

// prmt.b32 in its default mode, where a selector nibble's bit 3 replicates
// the selected byte's sign (__byte_perm ignores that bit). The selectors
// come in as template arguments: device code may not index the constant
// arrays above.
template <uint32_t kSel>
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;\n" : "=r"(r) : "r"(a), "r"(b), "n"(kSel));
  return r;
}

// (a & mask) ^ c in one lop3.
template <uint32_t kMask, uint32_t kXor>
__device__ __forceinline__ uint32_t and_xor(uint32_t a) {
  uint32_t r;
  asm("lop3.b32 %0, %1, %2, %3, 0x6a;\n"
      : "=r"(r)
      : "r"(a), "n"(kMask), "n"(kXor));
  return r;
}

__device__ __forceinline__ uint32_t hsub2(uint32_t a, uint32_t b) {
  __nv_bfloat162 h = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ uint32_t hmul2(uint32_t a, uint32_t b) {
  __nv_bfloat162 h = __hmul2(*reinterpret_cast<__nv_bfloat162*>(&a),
                             *reinterpret_cast<__nv_bfloat162*>(&b));
  return *reinterpret_cast<uint32_t*>(&h);
}

// Nibbles at bits 0-3 and 16-19 of v -> their two exact signed values as
// bf16x2: (v & 0x000F000F) ^ 0x43084308 in one lop3 is 0x4300 | (n ^ 8),
// i.e. 128 + (w + 8); minus 136 (which is 0x4308 in bf16).
__device__ __forceinline__ uint32_t nibbles_to_bf16x2(uint32_t v) {
  return hsub2(and_xor<kNibMask, kNibXor>(v), kBf16x2_136);
}

// Two f32 -> bf16x2 (round to nearest even; exact for the small integers
// here), a in the low half.
__device__ __forceinline__ uint32_t bf16x2(float a, float b) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<uint32_t*>(&h);
}

// Two bf16 bit patterns (in the low halves of a and b) as bf16x2, a low.
__device__ __forceinline__ uint32_t pair(uint32_t a, uint32_t b) {
  return __byte_perm(a, b, 0x5410);
}

// Byte b of u, which holds int8 weights XOR 0x80 (w + 128), as the f32 w:
// one permute builds the f32 1.5 * 2^23 + (w + 128) (bytes: u's byte b,
// 0x00, 0x40, 0x4B), one subtraction takes 1.5 * 2^23 + 128 off. Exact.
template <int b>
__device__ __forceinline__ float s8_value(uint32_t u) {
  return __int_as_float(__byte_perm(u, 0x4B400000u, 0x7650 | b)) -
         12583040.0f;
}

// One MMA step of s8_mma: rows 16 st + t + 4 i (i = 0..3) of the lane's 16
// columns, and its B fragment, x[g] at those rows.
struct S8Step {
  uint4 w[4];
  uint32_t b0, b1;
};

__device__ __forceinline__ void s8_load(S8Step& s, const uint8_t* w,
                                        const unsigned short* xg, int st,
                                        int t, int K, int N, int col,
                                        bool cols_in, bool x_in) {
  uint32_t xv[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = kS8StepRows * st + t + 4 * i;
    s.w[i] = k < K && cols_in
                 ? __ldg(reinterpret_cast<const uint4*>(
                       w + static_cast<size_t>(k) * N + col))
                 : make_uint4(0u, 0u, 0u, 0u);
    xv[i] = k < K && x_in ? __ldg(xg + k) : 0u;
  }
  s.b0 = pair(xv[0], xv[1]);
  s.b1 = pair(xv[2], xv[3]);
}

// The step's 8 MMA tiles: tile j = 2q + h takes bytes 2h and 2h + 1 of word
// q of each row (columns 16 g + 2j and 16 g + 2j + 1) as its A rows g and
// g + 8; k slots 2t, 2t + 1, 2t + 8, 2t + 9 are rows t, t + 4, t + 8,
// t + 12. Zero bytes (past K or N) are the weight 0.
__device__ __forceinline__ void s8_step(float (&acc)[kS8Tiles][4],
                                        const S8Step& s) {
  uint32_t u[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    u[i][0] = s.w[i].x ^ 0x80808080u;
    u[i][1] = s.w[i].y ^ 0x80808080u;
    u[i][2] = s.w[i].z ^ 0x80808080u;
    u[i][3] = s.w[i].w ^ 0x80808080u;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    mma_bf16(acc[2 * q],
             bf16x2(s8_value<0>(u[0][q]), s8_value<0>(u[1][q])),
             bf16x2(s8_value<1>(u[0][q]), s8_value<1>(u[1][q])),
             bf16x2(s8_value<0>(u[2][q]), s8_value<0>(u[3][q])),
             bf16x2(s8_value<1>(u[2][q]), s8_value<1>(u[3][q])), s.b0, s.b1);
    mma_bf16(acc[2 * q + 1],
             bf16x2(s8_value<2>(u[0][q]), s8_value<2>(u[1][q])),
             bf16x2(s8_value<3>(u[0][q]), s8_value<3>(u[1][q])),
             bf16x2(s8_value<2>(u[2][q]), s8_value<2>(u[3][q])),
             bf16x2(s8_value<3>(u[2][q]), s8_value<3>(u[3][q])), s.b0, s.b1);
  }
}

// The x row and column (inside the block's tile) of accumulator element e
// of the fragment order [tile j][lane][c0..c3], in a kernel whose tile j
// has the columns col(j, g) and col(j, g) + d as A rows g and g + 8: c0,
// c1 are x rows 2t, 2t + 1 of A row g, c2, c3 of A row g + 8.
struct Element {
  int j, g, m, hi;
  __device__ __forceinline__ explicit Element(int e) {
    j = e >> 7;
    const int lane = (e >> 2) & 31, c = e & 3;
    g = lane >> 2;
    m = 2 * (lane & 3) + (c & 1);
    hi = c >> 1;
  }
};

// The block's sum over its warps, in warp order, of each accumulator
// element, times s, into y. red: [kWarps][kTiles][32] float4, each warp's
// accumulators written there before the barrier this starts with.
// col(el) is an element's column inside the tile. xsums, where not null:
// [kWarps][kMaxB], each warp's sum of x row b's first K/2 elements, written
// likewise; 8 times their sum in warp order is taken off row b's sums
// before the scale (p4_mma<kP4c>'s rank-1 term).
template <int kWarpsT, int kTiles, int kThreadsT, typename Col>
__device__ __forceinline__ void warp_sums_out(const float* red, int n0,
                                              int B, int N,
                                              const float* __restrict__ s,
                                              float* __restrict__ y,
                                              Col col,
                                              const float* xsums = nullptr) {
  constexpr int kAcc = kTiles * 32 * 4;  // a warp's accumulators
  __syncthreads();
  for (int e = threadIdx.x; e < kAcc; e += kThreadsT) {
    const Element el(e);
    const int n = n0 + col(el);
    if (el.m >= B || n >= N) continue;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarpsT; ++w) sum += red[w * kAcc + e];
    if (xsums != nullptr) {
      float xs = 0.f;
#pragma unroll
      for (int w = 0; w < kWarpsT; ++w) xs += xsums[w * kMaxB + el.m];
      sum -= 8.f * xs;
    }
    y[static_cast<size_t>(el.m) * N + n] = sum * s[n];
  }
}

// y = (x @ W) * s over input-major int8 weights w8 [K, N], N a multiple of
// 16, w8 on 16 bytes. Grid: one block a 128-column tile.
__global__ void __launch_bounds__(kS8Threads, 1)
    s8_mma(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ y, int B, int K,
           int N) {
  extern __shared__ __align__(16) float red[];  // [warp][tile][lane] x 4
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kS8Cols;
  const int col = n0 + 16 * g;
  const bool cols_in = col < N, x_in = g < B;
  const unsigned short* xg =
      reinterpret_cast<const unsigned short*>(x) + static_cast<size_t>(g) * K;
  const int steps = (K + kS8StepRows - 1) / kS8StepRows;

  float acc[kS8Tiles][4];
#pragma unroll
  for (int j = 0; j < kS8Tiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // Step st + kS8Warps is loaded before step st is multiplied.
  S8Step cur, nxt;
  if (warp < steps) s8_load(cur, w, xg, warp, t, K, N, col, cols_in, x_in);
  for (int st = warp; st < steps; st += kS8Warps) {
    if (st + kS8Warps < steps)
      s8_load(nxt, w, xg, st + kS8Warps, t, K, N, col, cols_in, x_in);
    s8_step(acc, cur);
    cur = nxt;
  }

  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int j = 0; j < kS8Tiles; ++j)
    r4[(warp * kS8Tiles + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  warp_sums_out<kS8Warps, kS8Tiles, kS8Threads>(
      red, n0, B, N, s, y,
      [](const Element& el) { return 16 * el.g + 2 * el.j + el.hi; });
}

// One MMA step of mvt_mma: the packed bytes [p, p + 8), p = 32 st + 8 t, of
// the lane's two columns of each tile (A rows g and g + 8), and x[g]'s
// elements [p, p + 8) and [K/2 + p, K/2 + p + 8): bf16 pairs, word s of
// each the B fragment of MMA s. Past K/2 and N zero.
struct MvtStep {
  uint2 w[kMvtTiles][2];
  uint4 xl, xh;
};

template <bool kVec>
__device__ __forceinline__ void mvt_load(MvtStep& s, const uint8_t* wt,
                                         const unsigned short* xg, int st,
                                         int t, int K2, int N, int n0, int g,
                                         bool x_in) {
  const int p = kMvtStepBytes * st + 8 * t;
#pragma unroll
  for (int j = 0; j < kMvtTiles; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int n = n0 + 16 * j + g + 8 * r;
      const uint8_t* src = wt + static_cast<size_t>(n) * K2 + p;
      if constexpr (kVec) {
        s.w[j][r] = p < K2 && n < N
                        ? __ldg(reinterpret_cast<const uint2*>(src))
                        : make_uint2(0u, 0u);
      } else {  // K2 a multiple of 4: a word is in or out whole
        const uint32_t* s32 = reinterpret_cast<const uint32_t*>(src);
        s.w[j][r].x = p < K2 && n < N ? __ldg(s32) : 0u;
        s.w[j][r].y = p + 4 < K2 && n < N ? __ldg(s32 + 1) : 0u;
      }
    }
  if constexpr (kVec) {
    const bool in = x_in && p < K2;
    s.xl = in ? __ldg(reinterpret_cast<const uint4*>(xg + p))
              : make_uint4(0u, 0u, 0u, 0u);
    s.xh = in ? __ldg(reinterpret_cast<const uint4*>(xg + K2 + p))
              : make_uint4(0u, 0u, 0u, 0u);
  } else {
    uint32_t v[2][8];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int e = 0; e < 8; ++e)
        v[h][e] = x_in && p + e < K2 ? __ldg(xg + h * K2 + p + e) : 0u;
    s.xl = make_uint4(pair(v[0][0], v[0][1]), pair(v[0][2], v[0][3]),
                      pair(v[0][4], v[0][5]), pair(v[0][6], v[0][7]));
    s.xh = make_uint4(pair(v[1][0], v[1][1]), pair(v[1][2], v[1][3]),
                      pair(v[1][4], v[1][5]), pair(v[1][6], v[1][7]));
  }
}

// The step's MMAs: MMA s (0..3) of tile j takes bytes 2s and 2s + 1 of the
// lane's 8 of each column; a byte permute puts (column g: byte 2s, column
// g + 8: byte 2s, column g: byte 2s + 1, column g + 8: byte 2s + 1) in v,
// so that v, v >> 8, v >> 4, v >> 12 hold a0..a3's nibbles at bits 0-3
// and 16-19: the low nibbles are k slots 2t, 2t + 1, the high 2t + 8,
// 2t + 9.
__device__ __forceinline__ void mvt_step(float (&acc)[kMvtTiles][4],
                                         const MvtStep& s) {
  const uint32_t bl[4] = {s.xl.x, s.xl.y, s.xl.z, s.xl.w};
  const uint32_t bh[4] = {s.xh.x, s.xh.y, s.xh.z, s.xh.w};
#pragma unroll
  for (int j = 0; j < kMvtTiles; ++j) {
    const uint32_t wa[2] = {s.w[j][0].x, s.w[j][0].y};
    const uint32_t wb[2] = {s.w[j][1].x, s.w[j][1].y};
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const uint32_t v =
          __byte_perm(wa[m >> 1], wb[m >> 1], (m & 1) ? 0x7362 : 0x5140);
      mma_bf16(acc[j], nibbles_to_bf16x2(v), nibbles_to_bf16x2(v >> 8),
               nibbles_to_bf16x2(v >> 4), nibbles_to_bf16x2(v >> 12), bl[m],
               bh[m]);
    }
  }
}

// y = (x @ W) * s over output-major int4 weights wt uint8 [N, K/2], K/2 a
// multiple of 4; kVec: K/2 a multiple of 8, x on 16 bytes and wt on 8.
// Grid: one block a 64-column tile.
template <bool kVec>
__global__ void __launch_bounds__(kMvtThreads, 2)
    mvt_mma(const __nv_bfloat16* __restrict__ x,
            const uint8_t* __restrict__ wt, const float* __restrict__ s,
            float* __restrict__ y, int B, int K, int N) {
  __shared__ __align__(16) float red[kMvtWarps * kMvtTiles * 32 * 4];
  const int K2 = K / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kMvtCols;
  const bool x_in = g < B;
  const unsigned short* xg =
      reinterpret_cast<const unsigned short*>(x) + static_cast<size_t>(g) * K;
  const int steps = (K2 + kMvtStepBytes - 1) / kMvtStepBytes;

  float acc[kMvtTiles][4];
#pragma unroll
  for (int j = 0; j < kMvtTiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  // Step st + kMvtWarps is loaded before step st is multiplied.
  MvtStep cur, nxt;
  if (warp < steps) mvt_load<kVec>(cur, wt, xg, warp, t, K2, N, n0, g, x_in);
  for (int st = warp; st < steps; st += kMvtWarps) {
    if (st + kMvtWarps < steps)
      mvt_load<kVec>(nxt, wt, xg, st + kMvtWarps, t, K2, N, n0, g, x_in);
    mvt_step(acc, cur);
    cur = nxt;
  }

  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int j = 0; j < kMvtTiles; ++j)
    r4[(warp * kMvtTiles + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  warp_sums_out<kMvtWarps, kMvtTiles, kMvtThreads>(
      red, n0, B, N, s, y,
      [](const Element& el) { return 16 * el.j + el.g + 8 * el.hi; });
}

// kP4b: the A register (int8(p) >> 4, int8(q) >> 4) as bf16x2, p byte i of
// lo_src, q byte i of hi_src, whose low nibble is zero. The permutes make
// int8(p) and 2^16 int8(q); the add is exact mod 2^32, and the funnel shift
// of (kP4bCarry : sum) by 4 is the arithmetic shift of the true sum, 2^20
// ((int8(q) >> 4) + 0x4308) + 16 ((int8(p) >> 4) + 0x4308) + (p & 0xF):
// 136 + each value in its bf16 half.
template <int i>
__device__ __forceinline__ uint32_t sext_pair(uint32_t lo_src,
                                              uint32_t hi_src) {
  const uint32_t sum = prmt<kP4bSext[i]>(lo_src, 0u) +
                       prmt<kP4bHigh[i]>(hi_src, 0u) + kP4bBias;
  return hsub2(__funnelshift_r(sum, kP4bCarry, 4), kBf16x2_136);
}

// kP4 and kP4c: MMA tile 2q + h of a slice, v gathering its 4 bytes (kSel =
// kP4Gather[h]) from words ra (row r) and rb (row r + 1): v and v >> 8 hold
// the lo plane's nibbles of A rows g and g + 8 at bits 0-3 and 16-19, v >> 4
// and v >> 12 the hi plane's.
template <int F, uint32_t kSel>
__device__ __forceinline__ void gather_mma(float (&d)[4], uint32_t ra,
                                           uint32_t rb, uint32_t b0,
                                           uint32_t b1) {
  const uint32_t v = prmt<kSel>(ra, rb);
  if constexpr (F == kP4) {
    mma_bf16(d, nibbles_to_bf16x2(v), nibbles_to_bf16x2(v >> 8),
             nibbles_to_bf16x2(v >> 4), nibbles_to_bf16x2(v >> 12), b0, b1);
  } else {
    mma_bf16(d, hsub2(and_xor<kNibMask, kNibXor>(v), kP4cLoSub),
             hsub2(and_xor<kNibMask, kNibXor>(v >> 8), kP4cLoSub),
             hsub2(and_xor<kP4cHiMask, kP4cHiXor>(v >> 1), kP4cHiXor),
             hsub2(and_xor<kP4cHiMask, kP4cHiXor>(v >> 9), kP4cHiXor), b0,
             b1);
  }
}

// One MMA step of p4_mma: packed rows 16 st + 4 t + i (i = 0..3) of the
// lane's 16 columns, and its B fragments: slice c (rows 16 st + 4 t + 2 c
// and + 1) takes x[g] at those rows (b[c][0]) and at K/2 plus them
// (b[c][1]). Past K/2 and N zero.
struct P4Step {
  uint4 w[4];
  uint32_t b[2][2];
};

// vec_x: K/2 a multiple of 4 and x on 8 bytes, so the lane's four rows of
// x[g] are one 8-byte load in each half (two bf16 pairs, the B fragments
// of its two slices), in or past K/2 together; otherwise 2-byte loads.
__device__ __forceinline__ void p4_load(P4Step& s, const uint8_t* w,
                                        const unsigned short* xg, int st,
                                        int t, int K2, int N, int col,
                                        bool cols_in, bool x_in,
                                        bool vec_x) {
  const int k0 = kS8StepRows * st + 4 * t;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + i;
    s.w[i] = k < K2 && cols_in
                 ? __ldg(reinterpret_cast<const uint4*>(
                       w + static_cast<size_t>(k) * N + col))
                 : make_uint4(0u, 0u, 0u, 0u);
  }
  if (vec_x) {
    const bool in = x_in && k0 < K2;
    const uint2 lo = in ? __ldg(reinterpret_cast<const uint2*>(xg + k0))
                        : make_uint2(0u, 0u);
    const uint2 hi = in ? __ldg(reinterpret_cast<const uint2*>(xg + K2 + k0))
                        : make_uint2(0u, 0u);
    s.b[0][0] = lo.x;
    s.b[1][0] = lo.y;
    s.b[0][1] = hi.x;
    s.b[1][1] = hi.y;
  } else {
    uint32_t xl[4], xh[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = k0 + i;
      xl[i] = k < K2 && x_in ? __ldg(xg + k) : 0u;
      xh[i] = k < K2 && x_in ? __ldg(xg + K2 + k) : 0u;
    }
    s.b[0][0] = pair(xl[0], xl[1]);
    s.b[0][1] = pair(xh[0], xh[1]);
    s.b[1][0] = pair(xl[2], xl[3]);
    s.b[1][1] = pair(xh[2], xh[3]);
  }
}

// The step's 16 MMAs, 8 tiles a slice: tile j = 2q + h takes bytes 2h and
// 2h + 1 of word q of the slice's rows r = 16 st + 4 t + 2 c (k slot 2t
// and, high nibble, 2t + 8) and r + 1 (2t + 1, 2t + 9) as A rows g and
// g + 8. kP4c
// also adds the slice's x[g][k < K/2] to xsum, in f32 and in order. Zero
// bytes (past K/2 or N) are the weight 0 (kP4, kP4b) or lo + 8 = 8 against
// x = 0 (kP4c).
template <int F>
__device__ __forceinline__ void p4_step(float (&acc)[kS8Tiles][4],
                                        const P4Step& s, float& xsum) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint32_t b0 = s.b[c][0];
    uint32_t b1 = s.b[c][1];
    if constexpr (F == kP4c) {
      b1 = hmul2(b1, kBf16x2_1_16);
      xsum += __uint_as_float(b0 << 16);
      xsum += __uint_as_float(b0 & 0xFFFF0000u);
    }
    const uint32_t ra[4] = {s.w[2 * c].x, s.w[2 * c].y, s.w[2 * c].z,
                            s.w[2 * c].w};
    const uint32_t rb[4] = {s.w[2 * c + 1].x, s.w[2 * c + 1].y,
                            s.w[2 * c + 1].z, s.w[2 * c + 1].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if constexpr (F == kP4b) {
        const uint32_t la = ra[q] << 4;
        const uint32_t lb = (rb[q] << 4) & kNibbleMask;
        const uint32_t hb = rb[q] & kNibbleMask;
        mma_bf16(acc[2 * q], sext_pair<0>(la, lb), sext_pair<1>(la, lb),
                 sext_pair<0>(ra[q], hb), sext_pair<1>(ra[q], hb), b0, b1);
        mma_bf16(acc[2 * q + 1], sext_pair<2>(la, lb), sext_pair<3>(la, lb),
                 sext_pair<2>(ra[q], hb), sext_pair<3>(ra[q], hb), b0, b1);
      } else {
        gather_mma<F, kP4Gather[0]>(acc[2 * q], ra[q], rb[q], b0, b1);
        gather_mma<F, kP4Gather[1]>(acc[2 * q + 1], ra[q], rb[q], b0, b1);
      }
    }
  }
}

// y = (x @ W) * s over input-major int4 weights wp [K/2, N] in form F (kP4,
// kP4b or kP4c), N a multiple of 16, wp on 16 bytes. Grid: one block a
// 128-column tile.
template <int F>
__global__ void __launch_bounds__(kS8Threads, 1)
    p4_mma(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
           const float* __restrict__ s, float* __restrict__ y, int B, int K,
           int N) {
  extern __shared__ __align__(16) float red[];  // [warp][tile][lane] x 4
  __shared__ float xsums[kS8Warps * kMaxB];     // kP4c: [warp][row of x]
  const int K2 = K / 2;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kS8Cols;
  const int col = n0 + 16 * g;
  const bool cols_in = col < N, x_in = g < B;
  const unsigned short* xg =
      reinterpret_cast<const unsigned short*>(x) + static_cast<size_t>(g) * K;
  const int steps = (K2 + kS8StepRows - 1) / kS8StepRows;
  const bool vec_x =
      K2 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 8 == 0;

  float acc[kS8Tiles][4];
#pragma unroll
  for (int j = 0; j < kS8Tiles; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  float xsum = 0.f;
  // Step st + kS8Warps is loaded before step st is multiplied.
  P4Step cur, nxt;
  if (warp < steps)
    p4_load(cur, w, xg, warp, t, K2, N, col, cols_in, x_in, vec_x);
  for (int st = warp; st < steps; st += kS8Warps) {
    if (st + kS8Warps < steps)
      p4_load(nxt, w, xg, st + kS8Warps, t, K2, N, col, cols_in, x_in,
              vec_x);
    p4_step<F>(acc, cur, xsum);
    cur = nxt;
  }

  float4* r4 = reinterpret_cast<float4*>(red);
#pragma unroll
  for (int j = 0; j < kS8Tiles; ++j)
    r4[(warp * kS8Tiles + j) * 32 + lane] =
        make_float4(acc[j][0], acc[j][1], acc[j][2], acc[j][3]);
  if constexpr (F == kP4c) {
    // The 4 lanes of row g of x hold its partial sums; every lane gets the
    // same bits ((s0 + s1) + (s2 + s3)).
    xsum += __shfl_xor_sync(0xffffffffu, xsum, 1);
    xsum += __shfl_xor_sync(0xffffffffu, xsum, 2);
    if (t == 0) xsums[warp * kMaxB + g] = xsum;
  }
  warp_sums_out<kS8Warps, kS8Tiles, kS8Threads>(
      red, n0, B, N, s, y,
      [](const Element& el) { return 16 * el.g + 2 * el.j + el.hi; },
      F == kP4c ? xsums : nullptr);
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

// stream_bytes: out f32 [bn], out[c] = sum over tiles j and rows k of
// wp[k, j bn + c]. scratch: 64-bit, [0] the arrival counter, then the bn
// column sums; zero before and after.
__global__ void __launch_bounds__(kThreads)
    reduce_kernel(const uint8_t* __restrict__ wp, float* __restrict__ out,
                  unsigned long long* __restrict__ scratch, int K2, int N,
                  int bn, int rows_per_block) {
  __shared__ int red[kThreads * 16];
  __shared__ bool last;
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
        for (int j = 0; j < 16; ++j)
          colsum[j] += static_cast<int>((words[j / 4] >> (8 * (j % 4))) &
                                        0xFFu);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < 16; ++j) red[threadIdx.x * 16 + j] = colsum[j];
  __syncthreads();
  for (int c = threadIdx.x; c < bn; c += kThreads) {
    long long total = 0;
    for (int li = 0; li < lanes; ++li)
      total += red[(li * groups + c / 16) * 16 + c % 16];
    atomicAdd(&sums[c], static_cast<unsigned long long>(total));
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
  for (int c = threadIdx.x; c < bn; c += kThreads)
    out[c] = static_cast<float>(
        static_cast<long long>(atomicExch(&sums[c], 0ull)));
  if (threadIdx.x == 0) atomicExch(&scratch[0], 0ull);
}

// x's chunk c as f32, a thread's kXPerThread elements: c kXChunk + e
// kThreads + threadIdx.x (e < kXPerThread; past xn 0).
__device__ __forceinline__ void load_chunk(
    float (&v)[kXPerThread], const __nv_bfloat16* __restrict__ x, int xn,
    int c) {
#pragma unroll
  for (int e = 0; e < kXPerThread; ++e) {
    const int i = c * kXChunk + e * kThreads + threadIdx.x;
    v[e] = i < xn ? __bfloat162float(x[i]) : 0.0f;
  }
}

// The chunk's sum in a fixed order (each thread's elements in order, then
// block_sum) into the low 32 bits of its slot.
__device__ __forceinline__ void store_chunk(const float (&v)[kXPerThread],
                                            float* part,
                                            unsigned long long* slot) {
  float t = 0.0f;
#pragma unroll
  for (int e = 0; e < kXPerThread; ++e) t += v[e];
  const float total = block_sum(t, part);
  if (threadIdx.x == 0) *slot = __float_as_uint(total);
}

// _unpack_only_call: out f32 [2], out[0] the last tile's sum((w & 0xF) ^ 8)
// + sum(int8(w) & -16), each an exact integer rounded to f32 once, plus
// sum(x) over x bf16 [xn], out[1] that sum(x); ints int64 [2] the last
// tile's two integer sums, so a check can hold them exactly. scratch:
// 64-bit, [0] the arrival counter, then a word a block, its (lo, hi) sums
// as two 32-bit halves, then ceil(xn / kXChunk) slots, x's chunk sums as
// f32 bits. The counter and the slots are zero before and after; each call
// writes every block's word. Grid: (ceil(K2 / rows), N / bn), rows = lanes
// * kUnpackRows; blocks with blockIdx.y = 0, the first launched, read the
// last tile.
__global__ void __launch_bounds__(kThreads, kUnpackBlocksPerSm)
    unpack_sums(const uint8_t* __restrict__ wp,
                const __nv_bfloat16* __restrict__ x, int xn,
                float* __restrict__ out, long long* __restrict__ ints,
                unsigned long long* __restrict__ scratch, int K2, int N,
                int bn) {
  __shared__ int red[2][kWarps];
  __shared__ long long red64[2][kWarps];
  __shared__ float part[kWarps];
  __shared__ float slots[kThreads];
  __shared__ bool last;
  const int groups = bn / 16;
  const int lanes = kThreads / groups;
  const int g = threadIdx.x % groups;
  const int l = threadIdx.x / groups;
  const int k0 = blockIdx.x * lanes * kUnpackRows;
  const int k1 = min(K2, k0 + lanes * kUnpackRows);
  const int tiles = gridDim.y;
  const int tile = tiles - 1 - static_cast<int>(blockIdx.y);
  const uint8_t* col = wp + static_cast<size_t>(tile) * bn + 16 * g;
  const int blocks = gridDim.x * gridDim.y;
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  const int chunks = (xn + kXChunk - 1) / kXChunk;
  unsigned long long* partials = scratch + 1;
  unsigned long long* xslots = partials + blocks;

  // This block's first chunk of x and its rows, all loads issued before
  // any is used.
  float xv[kXPerThread] = {};
  if (block < chunks) load_chunk(xv, x, xn, block);
  uint4 v[kUnpackRows];
#pragma unroll
  for (int u = 0; u < kUnpackRows; ++u) {
    const int r = k0 + l + u * lanes;
    v[u] = l < lanes && r < k1
               ? __ldg(reinterpret_cast<const uint4*>(
                     col + static_cast<size_t>(r) * N))
               : make_uint4(kPadWord, kPadWord, kPadWord, kPadWord);
  }
  unsigned lo = 0;
  int hi = 0;
#pragma unroll
  for (int u = 0; u < kUnpackRows; ++u) {
    const uint32_t words[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      lo = __dp4a(and_xor<kWordLoMask, kWordLoXor>(words[q]), kOnes, lo);
      hi = __dp4a(static_cast<int>(words[q] & kNibbleMask),
                  static_cast<int>(kOnes), hi);
    }
  }

  // Integer sums: exact in any order.
  int ilo = static_cast<int>(lo);
  for (int o = 16; o > 0; o >>= 1) {
    ilo += __shfl_xor_sync(0xffffffffu, ilo, o);
    hi += __shfl_xor_sync(0xffffffffu, hi, o);
  }
  if (threadIdx.x % 32 == 0) {
    red[0][threadIdx.x / 32] = ilo;
    red[1][threadIdx.x / 32] = hi;
  }
  if (block < chunks) {  // the same for every thread of the block
    store_chunk(xv, part, &xslots[block]);
    for (int c = block + blocks; c < chunks; c += blocks) {
      load_chunk(xv, x, xn, c);
      store_chunk(xv, part, &xslots[c]);
    }
  }
  __syncthreads();
  // Only the blocks whose results the output reads, the last tile's and
  // those holding a chunk of x, arrive on the counter; the rest store
  // their word and leave.
  const bool arrives = blockIdx.y == 0 || block < chunks;
  if (threadIdx.x == 0) {
    int tlo = 0, thi = 0;
    for (int w = 0; w < kWarps; ++w) {
      tlo += red[0][w];
      thi += red[1][w];
    }
    partials[block] =
        static_cast<unsigned long long>(static_cast<uint32_t>(thi)) << 32 |
        static_cast<uint32_t>(tlo);
    if (arrives) {
      __threadfence();
      const int arrivals = max(static_cast<int>(gridDim.x),
                               min(chunks, blocks));
      last = atomicAdd(&scratch[0], 1ull) ==
             static_cast<unsigned long long>(arrivals) - 1;
    }
  }
  if (!arrives) return;  // the same for every thread of the block
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last tile's blocks' words (blocks 0 .. gridDim.x - 1) and the x
  // slots, each thread's first ones loaded together; the slots are added
  // in index order.
  const int t = threadIdx.x;
  const unsigned long long w0 =
      t < static_cast<int>(gridDim.x) ? __ldcg(&partials[t]) : 0ull;
  const uint32_t s0 = t < chunks ? static_cast<uint32_t>(
                                       atomicExch(&xslots[t], 0ull))
                                 : 0u;
  long long slo = static_cast<uint32_t>(w0);
  long long shi = static_cast<int>(static_cast<uint32_t>(w0 >> 32));
  for (int b = t + kThreads; b < static_cast<int>(gridDim.x); b += kThreads) {
    const unsigned long long w = __ldcg(&partials[b]);
    slo += static_cast<uint32_t>(w);
    shi += static_cast<int>(static_cast<uint32_t>(w >> 32));
  }
  for (int o = 16; o > 0; o >>= 1) {
    slo += __shfl_xor_sync(0xffffffffu, slo, o);
    shi += __shfl_xor_sync(0xffffffffu, shi, o);
  }
  if (t % 32 == 0) {
    red64[0][t / 32] = slo;
    red64[1][t / 32] = shi;
  }
  slots[t] = __uint_as_float(s0);
  float xsum = 0.0f;
  for (int c0 = 0; c0 < chunks; c0 += kThreads) {
    if (c0 > 0) {
      __syncthreads();  // the previous batch is added
      if (c0 + t < chunks)
        slots[t] = __uint_as_float(
            static_cast<uint32_t>(atomicExch(&xslots[c0 + t], 0ull)));
    }
    __syncthreads();
    if (t == 0)
      for (int i = 0; i < min(kThreads, chunks - c0); ++i) xsum += slots[i];
  }
  __syncthreads();  // publishes red64
  if (threadIdx.x == 0) {
    long long tlo = 0, thi = 0;
    for (int w = 0; w < kWarps; ++w) {
      tlo += red64[0][w];
      thi += red64[1][w];
    }
    ints[0] = tlo;
    ints[1] = thi;
    out[0] = (static_cast<float>(tlo) + static_cast<float>(thi)) + xsum;
    out[1] = xsum;
    atomicExch(&scratch[0], 0ull);
  }
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

cudaError_t launch_s8(const __nv_bfloat16* x, const uint8_t* w,
                      const float* s, float* y, int B, int K, int N,
                      cudaStream_t stream) {
  static size_t allowed[64] = {};
  constexpr size_t smem = sizeof(float4) * kS8Warps * kS8Tiles * 32;
  cudaError_t err = allow_smem(s8_mma, smem, allowed);
  if (err != cudaSuccess) return err;
  s8_mma<<<(N + kS8Cols - 1) / kS8Cols, kS8Threads, smem, stream>>>(
      x, w, s, y, B, K, N);
  return cudaGetLastError();
}

template <int F>
cudaError_t launch_p4(const __nv_bfloat16* x, const uint8_t* w,
                      const float* s, float* y, int B, int K, int N,
                      cudaStream_t stream) {
  static size_t allowed[64] = {};
  constexpr size_t smem = sizeof(float4) * kS8Warps * kS8Tiles * 32;
  cudaError_t err = allow_smem(p4_mma<F>, smem, allowed);
  if (err != cudaSuccess) return err;
  p4_mma<F><<<(N + kS8Cols - 1) / kS8Cols, kS8Threads, smem, stream>>>(
      x, w, s, y, B, K, N);
  return cudaGetLastError();
}

template <bool kVec>
cudaError_t launch_mvt(const __nv_bfloat16* x, const uint8_t* w,
                       const float* s, float* y, int B, int K, int N,
                       cudaStream_t stream) {
  mvt_mma<kVec><<<(N + kMvtCols - 1) / kMvtCols, kMvtThreads, 0, stream>>>(
      x, w, s, y, B, K, N);
  return cudaGetLastError();
}

}  // namespace

// form: kP4, kP4b, kP4c, kS8 (input-major w, N a multiple of 16, w on 16
// bytes) or kOut (w uint8 [N, K/2], K/2 a multiple of 4, w on 4 bytes).
// x: bf16 [B, K], 1 <= B <= 8, K even; s: f32 [N]; y: f32 [B, N]. All
// contiguous. Enqueues one launch on `stream`; returns its error, or
// cudaGetLastError() after it.
extern "C" int sea_qb_matvec(int form, const void* x, const void* w,
                             const void* s, void* y, int B, int K, int N,
                             void* stream) {
  if (B < 1 || B > kMaxB || K < 2 || K % 2 || N < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* X = static_cast<const __nv_bfloat16*>(x);
  const auto* W = static_cast<const uint8_t*>(w);
  const auto* S = static_cast<const float*>(s);
  auto* Y = static_cast<float*>(y);
  auto st = static_cast<cudaStream_t>(stream);
  if (form == kOut ? (K / 2) % 4 != 0 : N % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // mvt_mma's 8-byte weight and 16-byte x loads need K/2 a multiple of 8
  // and both pointers on their size; otherwise its word-wise form.
  const bool vec = (K / 2) % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 8 == 0;
  switch (form) {
    case kP4: return launch_p4<kP4>(X, W, S, Y, B, K, N, st);
    case kP4b: return launch_p4<kP4b>(X, W, S, Y, B, K, N, st);
    case kP4c: return launch_p4<kP4c>(X, W, S, Y, B, K, N, st);
    case kS8: return launch_s8(X, W, S, Y, B, K, N, st);
    case kOut:
      return vec ? launch_mvt<true>(X, W, S, Y, B, K, N, st)
                 : launch_mvt<false>(X, W, S, Y, B, K, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// form: kColumnSums (stream_bytes) or kCopy (dma_only). wp: uint8 [K2, N]
// on 16 bytes, N a multiple of bn, bn a multiple of 16 and at most 4096.
// The grid is (ceil(K2 / rows_per_block), N / bn). scratch (kColumnSums;
// kCopy takes none): zeroed 64-bit words, 1 + bn, left zeroed. out: f32
// [bn].
extern "C" int sea_qb_stream(int form, const void* wp, void* out,
                             void* scratch, int K2, int N, int bn,
                             int rows_per_block, void* stream) {
  if (K2 < 1 || bn < 16 || bn % 16 || bn > 4096 || N % bn ||
      rows_per_block < 1 || (form == kColumnSums && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((K2 + rows_per_block - 1) / rows_per_block, N / bn);
  const auto* W = static_cast<const uint8_t*>(wp);
  auto* O = static_cast<float*>(out);
  auto* S = static_cast<unsigned long long*>(scratch);
  auto st = static_cast<cudaStream_t>(stream);
  switch (form) {
    case kColumnSums:
      reduce_kernel<<<grid, kThreads, 0, st>>>(W, O, S, K2, N, bn,
                                              rows_per_block);
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

namespace {

// unpack_sums' grid and its scratch in 64-bit words (the arrival counter,
// a word a block, a slot a chunk of x), or -1 for shapes it does not take.
long long unpack_layout(int K2, int N, int bn, int xn, dim3* grid) {
  if (K2 < 1 || bn < 16 || bn % 16 || bn > 4096 || N % bn || xn < 0)
    return -1;
  const int rows = kThreads / (bn / 16) * kUnpackRows;
  const dim3 g((K2 + rows - 1) / rows, N / bn);
  if (grid != nullptr) *grid = g;
  return 1 + static_cast<long long>(g.x) * g.y +
         (xn + kXChunk - 1) / kXChunk;
}

}  // namespace

// The scratch sea_qb_unpack needs, in 64-bit words; -1 where it would
// refuse the shape.
extern "C" long long sea_qb_unpack_scratch_words(int K2, int N, int bn,
                                                 int xn) {
  return unpack_layout(K2, N, bn, xn, nullptr);
}

// _unpack_only_call: wp uint8 [K2, N] on 16 bytes, N a multiple of bn, bn a
// multiple of 16 and at most 4096; x bf16 [xn]. The launcher picks the
// grid (unpack_sums). scratch: `words` 64-bit words, at least
// sea_qb_unpack_scratch_words(K2, N, bn, xn), the first zero before and
// after. out f32 [2], ints int64 [2].
extern "C" int sea_qb_unpack(const void* wp, const void* x, int xn,
                             void* out, void* ints, void* scratch,
                             long long words, int K2, int N, int bn,
                             void* stream) {
  dim3 grid;
  const long long need = unpack_layout(K2, N, bn, xn, &grid);
  if (need < 0 || words < need || (xn > 0 && x == nullptr) ||
      out == nullptr || ints == nullptr || scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  unpack_sums<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(wp), static_cast<const __nv_bfloat16*>(x),
      xn, static_cast<float*>(out), static_cast<long long*>(ints),
      static_cast<unsigned long long*>(scratch), K2, N, bn);
  return static_cast<int>(cudaGetLastError());
}
