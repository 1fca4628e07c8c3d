"""Where the flash kernels' time goes, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_flash_probe.py [fwd] [fwd16] [bwd] [bwd16] [--check]
                                (all four when none is named)

It builds ``sea_tpu_torch/csrc/flash_attention.cu`` as it is and in a few
variants made by text edits of that source (an edit that no longer applies
fails the script), one nvcc each, started together. For every variant it
holds the kernels it probes against the plain version at
``chip_smoke.FLASH_SHAPES`` (dropout 0 and 0.1) and times them as
``chip_smoke.py``'s ``[kernel-time]`` does (CUDA events, L2 cold) at the
train step's shapes and the multiphase training shape, beside SDPA's f32
causal forward or backward, in turns (the variants in order, then in
reverse).

``fwd``: the forward kernel; for the source as it is it then counts clock64
cycles per key tile in the critical block (the last q tile of bh 0), by
phase: the wait for the tile, Q.K^T (with the next tile's copies), the
softmax, P.V and the closing barrier. Variants:

- ``unroll2``: the loop over d unrolled twice;
- ``small_trunc``: x_small = x - x_big left for the tensor core to truncate
  (the split of CUTLASS's fast-f32 GEMMs) instead of rounded to nearest;
- ``dead_warps``: a warp whose 16 rows all lie past Tq skips the products;
- ``rolled_pv``: P.V as a rolled loop over its k steps, S's fragments
  shifted down a register each step.

``fwd16``: the bf16 forward's wgmma form (hd 64, 128 and 256), checked
against the plain version (and a second call for the same bits) and
timed beside SDPA's bf16 causal forward; for the source as it is it then
counts clock64 cycles in the critical block (bh 0, the last q tile) for
thread 0 of each consumer group: per walked tile after the first, the
wait for its K (and the V before it), S with the P.V before it, the
softmax and hash, and the O rescale; then the wait for Q, tile 0, and
the last P.V with the merge (and group 0's wait for group 1). Variants:

- ``one_group``: the first consumer group walks every key tile and the
  second none (the walk not split);
- ``overlap``: inside a group, the softmax of tile i runs while the P.V
  of tile i - 1 does (``wgmma.wait_group 1``, P in two register buffers);
- ``bk128_hd64``: 128-key tiles at hd 64, two stages a group;
- ``st2``: two stages a group at hd 64 and 128;
- ``k_first``: the loader asks for K of tile j before V of tile j - 1;
- ``cluster2``: a cluster of two blocks a (bh, q tile), each with one
  consumer group walking the even or the odd key tiles, rank 1 handing
  (m, l, O) to rank 0 over distributed shared memory (twice the blocks).

``bwd16``: the bf16 dQ and dK/dV's wgmma forms (hd 64, 128 and 256),
checked against the plain versions (and a second call for the same bits)
and timed beside SDPA's bf16 causal backward; for the source as it is it
then counts clock64 cycles in the critical block of each (bh 0; dQ's last
q tile, dK/dV's first key tile) for thread 0 of each consumer group: per
walked tile after the first, the wait for its tiles, S and dP (S^T and
dP^T) with the products of the tile before, and dS (with the halves'
exchange where the groups split d); then the wait for the block's own
tiles, tile 0, the last products, and group 0's merge. With ``--check``
it builds and checks only the source as it is and its marked form (every
variant's edits must still apply). Variants:

- ``one_group``: the first consumer group walks every tile and the
  second none (the walk not split);
- ``dsplit128``: dK/dV at hd 128 with d split between the groups (each
  owns 64 columns of dK and dV and walks every q tile, as at hd 256);
- ``full_s``: dK/dV at hd 256 with each group forming all of S^T and
  dP^T itself (four stages), instead of over its half of d, adding the
  other's through shared memory;
- ``walk32``: 32-row walked tiles where the kernels take 64 (dQ at hd 64
  and 128, dK/dV at hd 64); ``walk64``: 64-row q tiles for dK/dV at hd
  128 (two stages);
- ``st2`` / ``st3``: two / three stages a ring where the kernels take
  another count and they fit.

``bwd``: dQ and dK/dV. Variants:

- ``one_group``: the first warp group walks every tile and the second
  none (the walk not split: the critical block's serial walk doubles);
- ``pv8``: the P.V-like products split B in batches of 8 n tiles, not 4;
- ``qk_unroll2``: the S-like products' loop over d unrolled twice, not 4
  times.

Output: the card, then one line per build, check, time and profile.
"""

import collections
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from chip_smoke import log
from chip_variants import build_all, edit, use
from sea_tpu_torch.ops import flash_attention as FA

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "flash_probe"
SOURCE = REPO / "sea_tpu_torch" / "csrc" / "flash_attention.cu"
KERNEL = "fwd_kernel<256,32>, <128,64>, <64,64>, <8,64>, <16,64>"
BWD_VARIANTS = {
    "as_is": [],
    "one_group": [
        ("constexpr int kWalkers = 2;", "constexpr int kWalkers = 1;"),
        ("return n_tiles > group ? (n_tiles - group + kWalkers - 1) / "
         "kWalkers : 0;", "return group == 0 ? n_tiles : 0;")],
    "pv8": [("constexpr int JN = J < 4 ? J : 4;",
             "constexpr int JN = J < 8 ? J : 8;")],
    "qk_unroll2": [("#pragma unroll 4\n  for (int d0 = 0; d0 < HD; d0 += 8)",
                    "#pragma unroll 2\n  for (int d0 = 0; d0 < HD; d0 += 8)")],
}

_D_LOOP = "#pragma unroll 1\n      for (int d0 = 0; d0 < HD; d0 += 16) {"
_SMALL = "return {big, to_tf32(x - __uint_as_float(big))};"
_LIVE = ("  const int row0 = q0 + warp * 16 + g;  // this thread's rows: row0, "
         "row0 + 8\n")
_PV = """#pragma unroll
    for (int n = 0; n < NS; ++n) {
      const FragA p = split_a(sc[n][0], sc[n][2], sc[n][1], sc[n][3]);
"""
VARIANTS = {
    "as_is": [],
    "unroll2": [(_D_LOOP, _D_LOOP.replace("unroll 1", "unroll 2"))],
    "small_trunc": [(_SMALL, _SMALL.replace(
        "to_tf32(x - __uint_as_float(big))",
        "__float_as_uint(x - __uint_as_float(big))"))],
    "dead_warps": [
        (_LIVE, _LIVE + "  const bool live = q0 + warp * 16 < s.Tq;\n"),
        ("        const float4 x0 = lds4(qa + d0)",
         "        if (live) {\n        const float4 x0 = lds4(qa + d0)"),
        ("        mma_3xtf32(sc, split_a(x0.z, x1.z, x0.w, x1.w), b0, b1);\n",
         "        mma_3xtf32(sc, split_a(x0.z, x1.z, x0.w, x1.w), b0, b1);\n"
         "        }\n"),
        ("    // Online softmax;", "    if (live) {\n    // Online softmax;"),
        ("    __syncthreads();  // stage j & 1 is refilled",
         "    }\n    __syncthreads();  // stage j & 1 is refilled")],
    "rolled_pv": [(_PV, """#pragma unroll 1
    for (int n = 0; n < NS; ++n) {
      const FragA p = split_a(sc[0][0], sc[0][2], sc[0][1], sc[0][3]);
#pragma unroll
      for (int i = 0; i + 1 < NS; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[i][c] = sc[i + 1][c];
""")],
}
# clock64 marks around the phases of a key tile, kept per warp for the
# last q tile of bh 0 (lane 0), read back through two extra C entries.
_MARKS = [
    ("constexpr int kFwdThreads = 128;",
     "__device__ long long g_phase[4][6];\nconstexpr int kFwdThreads = 128;"),
    ('asm("mma.sync', 'asm volatile("mma.sync'),
    ("    cp_async_wait<0>();\n",
     "    const bool mark = blockIdx.x == gridDim.x - 1 && blockIdx.y == 0 "
     "&& lane == 0;\n    long long ta = clock64();\n"
     "    cp_async_wait<0>();\n"),
    ("    __syncthreads();  // tile j (and Q) landed for every thread's "
     "copies\n",
     "    __syncthreads();  // tile j (and Q) landed for every thread's "
     "copies\n    long long tb = clock64();\n"),
    ("    // Online softmax;", "    long long tc = clock64();\n"
                               "    // Online softmax;"),
    ("    // O += P V.", "    long long td = clock64();\n    // O += P V."),
    ("    __syncthreads();  // stage j & 1 is refilled at iteration j + 1\n",
     "    long long te = clock64();\n"
     "    __syncthreads();  // stage j & 1 is refilled at iteration j + 1\n"
     "    if (mark) {\n"
     "      const long long tf = clock64(), d[6] = {tb - ta, tc - tb, "
     "td - tc, te - td, tf - te, 1};\n"
     "      for (int i = 0; i < 6; ++i) g_phase[warp][i] += d[i];\n"
     "    }\n"),
]
_MARK_ENTRIES = """
extern "C" int sea_phase_read(long long* host) {
  return cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
extern "C" int sea_phase_zero() {
  static const long long zero[24] = {};
  return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
PHASES = ("wait", "QK^T+copies", "softmax", "PV", "barrier")
# clock64 marks around the phases of a walked tile in the backward kernels,
# per warp (lane 0) of the critical block: bh 0 and blockIdx.y 0 (dK/dV's
# first key tile, dQ's last q tile), read back through two extra entries.
_BWD_TOP = ("  for (int i = 0; i < mine; ++i) {\n    if (i > 0) {\n"
            "      cp_async_wait<0>();\n      group_sync(group);  // tile i "
            "landed; stage (i + 1) & 1 is free\n    }\n")
_BWD_MARKS = [
    ("constexpr int kGroupThreads = 128;",
     "__device__ long long g_bwd_phase[2][8][6];\n"
     "constexpr int kGroupThreads = 128;"),
    ('asm("mma.sync', 'asm volatile("mma.sync'),
    ("  constexpr int J = T::J, kStage = T::kDqStage;\n",
     "  constexpr int J = T::J, kStage = T::kDqStage;\n"
     "  constexpr int kKind = 0;\n"),
    ("  constexpr int J = T::J, kStage = T::kDkvStage;\n",
     "  constexpr int J = T::J, kStage = T::kDkvStage;\n"
     "  constexpr int kKind = 1;\n"),
    (_BWD_TOP, "  const bool mark = blockIdx.x == 0 && blockIdx.y == 0 && "
     "lane == 0;\n  for (int i = 0; i < mine; ++i) {\n"
     "    long long ta = clock64();\n" + _BWD_TOP.split("{\n", 1)[1]
     + "    long long tb = clock64();\n"),
    ("    qk_pair<NS, HD, LD, T::KW>(",
     "    long long tc = clock64();\n    qk_pair<NS, HD, LD, T::KW>("),
    ("\n\n    // dS = P (M dP - D)", "\n    long long td = clock64();\n"
     "    // dS = P (M dP - D)"),
    ("\n\n    // P = exp(s scale - lse) in band",
     "\n    long long td = clock64();\n    // P = exp(s scale - lse) in band"),
    ("    // dQ += dS K over", "    long long te = clock64();\n"
     "    // dQ += dS K over"),
    ("    // dV += (P M)^T dO", "    long long te = clock64();\n"
     "    // dV += (P M)^T dO"),
    ("    pv_product<NS, J, LD>(acc, sc, cK + 2 * t * LD + dcol + g);\n",
     "    pv_product<NS, J, LD>(acc, sc, cK + 2 * t * LD + dcol + g);\n"
     "    MARK_BWD\n"),
    ("    pv_product<NS, J, LD>(gk, dpt, cQ + 2 * t * LD + dcol + g);\n",
     "    pv_product<NS, J, LD>(gk, dpt, cQ + 2 * t * LD + dcol + g);\n"
     "    MARK_BWD\n"),
    ("    MARK_BWD\n",
     "    if (mark) {\n      const long long tf = clock64(), d[6] = "
     "{tb - ta, tc - tb, td - tc, te - td, tf - te, 1};\n"
     "      for (int u = 0; u < 6; ++u) g_bwd_phase[kKind][warp][u] += d[u];"
     "\n    }\n"),
]
_BWD_MARK_ENTRIES = """
extern "C" int sea_bwd_phase_read(long long* host) {
  return cudaMemcpyFromSymbol(host, g_bwd_phase, sizeof(g_bwd_phase));
}
extern "C" int sea_bwd_phase_zero() {
  static const long long zero[96] = {};
  return cudaMemcpyToSymbol(g_bwd_phase, zero, sizeof(zero));
}
"""
BWD_PHASES = ("wait", "copies", "S,dP", "softmax", "PV")

# The bf16 forward's wgmma form (fwd16). Variants:
_FWD16_RESCALE = ("#pragma unroll\n    for (int c = 0; c < NO; ++c)\n"
                  "#pragma unroll\n      for (int e = 0; e < 4; ++e) "
                  "acc[4 * c + e] *= alpha[e >> 1];\n")
FWD16_VARIANTS = {
    "as_is": [],
    # one consumer group walks every key tile, the other none
    "one_group": [
        ("        const int i = j / G, st = (j % G) * ST + i % ST;",
         "        const int i = j, st = i % ST;"),
        ("  const int mine = n_tiles > group ? (n_tiles - group + G - 1) / G "
         ": 0;", "  const int mine = group == 0 ? n_tiles : 0;"),
        ("    const int k0 = (group + G * i) * BK;",
         "    const int k0 = i * BK;")],
    # inside a group, the softmax of tile i runs while the P.V of tile
    # i - 1 does (S and P.V in two commit groups, wgmma.wait_group 1; P in
    # two register buffers)
    "overlap": [
        ("  uint32_t p[NS / 2][4];     // its P, bf16 pairs",
         "  uint32_t p[NS / 2][4], pn[NS / 2][4];"),
        ("      issue_s<HD, BK>(sc, qd, kd + u * kStageStep);\n"
         "      issue_pv<HD, BK>(acc, p, vd + up * kStageStep);\n"
         "      wgmma_commit();\n      wgmma_wait<0>();\n"
         "      pin(sc);\n      pin(acc);\n"
         "      mbar_arrive(empty + group * ST + up);\n"
         "      softmax(i, alpha, p);\n",
         "      issue_s<HD, BK>(sc, qd, kd + u * kStageStep);\n"
         "      wgmma_commit();\n"
         "      issue_pv<HD, BK>(acc, p, vd + up * kStageStep);\n"
         "      wgmma_commit();\n      wgmma_wait<1>();\n"
         "      pin(sc);\n      softmax(i, alpha, pn);\n"
         "      wgmma_wait<0>();\n      pin(acc);\n"
         "      mbar_arrive(empty + group * ST + up);\n"
         "#pragma unroll\n      for (int kk = 0; kk < NS / 2; ++kk)\n"
         "#pragma unroll\n        for (int e = 0; e < 4; ++e) p[kk][e] = "
         "pn[kk][e];\n")],
    # 128-key tiles at hd 64 (two stages a group)
    "bk128_hd64": [
        ("    case 64: return launch_fwd_bf16<64, 64, 4>(",
         "    case 64: return launch_fwd_bf16<64, 128, 2>(")],
    # two stages a group at hd 64 and 128 (fewer tiles asked for at the
    # start; at hd 256 two stages cannot hold the merge's exchange)
    "st2": [
        ("    case 64: return launch_fwd_bf16<64, 64, 4>(",
         "    case 64: return launch_fwd_bf16<64, 64, 2>("),
        ("    case 128: return launch_fwd_bf16<128, 64, 3>(",
         "    case 128: return launch_fwd_bf16<128, 64, 2>(")],
    # the loader asks for K of tile j before V of tile j - 1 (Q, K0, K1,
    # V0, K2, V1, ...), so that both groups' first S start sooner
    "k_first": [
        ("      for (int j = 0; j < n_tiles; ++j) {\n"
         "        const int i = j / G, st = (j % G) * ST + i % ST;\n",
         "      for (int j = 0; j <= n_tiles; ++j) {\n"
         "        if (j > 0) {\n"
         "          const int i = (j - 1) / G;\n"
         "          const int st = ((j - 1) % G) * ST + i % ST;\n"
         "          unsigned char* dst = ring + st * T::kStageBytes;\n"
         "          mbar_expect_tx(v_full + st, T::kTileBytes);\n"
         "#pragma unroll\n"
         "          for (int c = 0; c < T::kBoxes; ++c)\n"
         "            tma_load(dst + T::kTileBytes + c * BK * 128, vmap,\n"
         "                     v_full + st, 64 * c, h, (j - 1) * BK, b);\n"
         "        }\n"
         "        if (j == n_tiles) break;\n"
         "        const int i = j / G, st = (j % G) * ST + i % ST;\n"),
        ("        mbar_expect_tx(v_full + st, T::kTileBytes);\n"
         "#pragma unroll\n"
         "        for (int c = 0; c < T::kBoxes; ++c)\n"
         "          tma_load(dst + T::kTileBytes + c * BK * 128, vmap, "
         "v_full + st,\n"
         "                   64 * c, h, j * BK, b);\n", "")],
}

def _cluster2(base):
    """The cluster2 variant's edits of `base`: a cluster of two blocks a
    (bh, q tile), grid z = rank. Each block's first consumer group walks
    the rank's key tiles (rank, rank + 2, ...), its second none; rank 1
    pushes (m, l, O) into rank 0's shared memory over distributed shared
    memory and arrives on an mbarrier there, and rank 0 merges them into
    its own, as the decode kernel's ranks do."""
    start = base.index("  // Group 1 hands (m, l, O) to group 0")
    end = base.index("  // acc[4c + 2r + e] is row row0 + 8r")
    merge = """  if (group == 1) return;
  {
    float* xch = reinterpret_cast<float*>(ring + ST * T::kStageBytes) + tid;
    uint64_t* xfull = q_full + 1;
    if (blockIdx.z == 1) {
      asm volatile("barrier.cluster.wait.aligned;\\n" ::: "memory");
      unsigned rx, rb;
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\\n"
                   : "=r"(rx) : "r"(smem_u32(xch)));
      asm volatile("mapa.shared::cluster.u32 %0, %1, 0;\\n"
                   : "=r"(rb) : "r"(smem_u32(xfull)));
      float ml[4] = {m[0], m[1], l[0], l[1]};
#pragma unroll
      for (int i = 0; i < HD / 2; ++i)
        asm volatile("st.shared::cluster.f32 [%0], %1;\\n"
                     ::"r"(rx + 512 * i), "f"(acc[i]) : "memory");
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("st.shared::cluster.f32 [%0], %1;\\n"
                     ::"r"(rx + 512 * (HD / 2 + i)), "f"(ml[i]) : "memory");
      asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, "
                   "[%0];\\n" ::"r"(rb) : "memory");
      return;
    }
    unsigned done;
    do {
      asm volatile("{\\n.reg .pred p;\\n"
                   "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 "
                   "p, [%1], 0;\\nselp.u32 %0, 1, 0, p;\\n}\\n"
                   : "=r"(done) : "r"(smem_u32(xfull)) : "memory");
    } while (!done);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m1 = xch[128 * (HD / 2 + r)];
      const float m_new = fmaxf(m[r], m1);
      const float a0 = exp2_approx(m[r] - m_new);
      const float a1 = exp2_approx(m1 - m_new);
      l[r] = l[r] * a0 + xch[128 * (HD / 2 + 2 + r)] * a1;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 4 * c + 2 * r + e;
          acc[i] = acc[i] * a0 + xch[128 * i] * a1;
        }
    }
  }

"""
    return edit(base[:start] + merge + base[end:], [
        ("__global__ void __launch_bounds__(FwdWg<HD, BK, ST>::kThreads, 1)",
         "__global__ void __cluster_dims__(1, 1, 2) "
         "__launch_bounds__(FwdWg<HD, BK, ST>::kThreads, 1)"),
        ("  const dim3 grid(s.B * s.H, (s.Tq + kFwdBQ - 1) / kFwdBQ);",
         "  const dim3 grid(s.B * s.H, (s.Tq + kFwdBQ - 1) / kFwdBQ, 2);"),
        ("1024 + kQBytes + kStages * kStageBytes + 8 * (3 * kStages + 1);",
         "1024 + kQBytes + kStages * kStageBytes + 8 * (3 * kStages + 2);"),
        ("    mbar_init(q_full, 1);\n",
         "    mbar_init(q_full, 1);\n    mbar_init(q_full + 1, 128);\n"),
        ('    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: '
         '"memory");\n  }\n  __syncthreads();\n',
         '    asm volatile("fence.mbarrier_init.release.cluster;\\n" ::: '
         '"memory");\n  }\n  __syncthreads();\n'
         '  asm volatile("barrier.cluster.arrive.aligned;\\n" ::: '
         '"memory");\n'),
        ("      for (int j = 0; j < n_tiles; ++j) {\n"
         "        const int i = j / G, st = (j % G) * ST + i % ST;",
         "      for (int j = blockIdx.z; j < n_tiles; j += 2) {\n"
         "        const int i = j / 2, st = i % ST;"),
        ("  const int mine = n_tiles > group ? (n_tiles - group + G - 1) / G "
         ": 0;",
         "  const int z = blockIdx.z;\n"
         "  const int mine = group == 0 && n_tiles > z ? (n_tiles - z + 1) / 2"
         " : 0;"),
        ("    const int k0 = (group + G * i) * BK;",
         "    const int k0 = (z + 2 * i) * BK;"),
    ])


# clock64 marks of the critical block (bh 0, the last q tile), thread 0 of
# each consumer group, summed over calls: per walked tile the wait for its
# K (and the V before it), S with the P.V before it, the softmax and
# hash, and the O rescale; then the wait for Q,
# the merge from the end of the walk (group 1: to its hand-off), and group
# 0's wait for group 1 at the merge.
_FWD16_MARKS = [
    ("template <int HD, int BK, int ST>\n__global__ void __launch_bounds__("
     "FwdWg<HD, BK, ST>::kThreads, 1)",
     "__device__ long long g_phase16[2][10];\n"
     "template <int HD, int BK, int ST>\n__global__ void __launch_bounds__("
     "FwdWg<HD, BK, ST>::kThreads, 1)"),
    ("  mbar_wait(q_full, 0);\n",
     "  const bool mark = blockIdx.x == 0 && blockIdx.y == 0 && tid == 0;\n"
     "  const long long t0 = clock64();\n  long long t_end = t0;\n"
     "  mbar_wait(q_full, 0);\n"
     "  const long long tq = clock64();\n"
     "  if (mark) g_phase16[group][6] += tq - t0;\n"),
    ("    softmax(0, alpha, p);  // O is still 0: nothing to rescale\n",
     "    softmax(0, alpha, p);  // O is still 0: nothing to rescale\n"
     "    if (mark) g_phase16[group][7] += clock64() - tq;\n"),
    ("      const int u = i % ST, up = (i - 1) % ST;\n",
     "      const int u = i % ST, up = (i - 1) % ST;\n"
     "      const long long ta = clock64();\n"),
    ("      mbar_wait(v_full + group * ST + up, ((i - 1) / ST) & 1);\n"
     "      pin(sc);\n",
     "      mbar_wait(v_full + group * ST + up, ((i - 1) / ST) & 1);\n"
     "      const long long tb = clock64();\n      pin(sc);\n"),
    ("      softmax(i, alpha, p);\n",
     "      const long long tc = clock64();\n      softmax(i, alpha, p);\n"
     "      const long long td = clock64();\n"),
    ("        for (int e = 0; e < 4; ++e) acc[4 * c + e] *= alpha[e >> 1];\n"
     "    }\n",
     "        for (int e = 0; e < 4; ++e) acc[4 * c + e] *= alpha[e >> 1];\n"
     "      if (mark) {\n        const long long d[5] = {tb - ta, "
     "tc - tb, td - tc, clock64() - td, 1};\n"
     "        for (int v = 0; v < 5; ++v) g_phase16[group][v] += d[v];\n"
     "      }\n    }\n    t_end = clock64();\n"),
    ('    asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n',
     '    asm volatile("bar.arrive 1, 256;\\n" ::: "memory");\n'
     "    if (mark && mine > 0) g_phase16[1][8] += clock64() - t_end;\n"),
    ('  asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n',
     "  const long long tm = clock64();\n"
     '  asm volatile("bar.sync 1, 256;\\n" ::: "memory");\n'
     "  if (mark) g_phase16[0][9] += clock64() - tm;\n"),
    ("  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e; lse = m ln 2 +",
     "  if (mark) g_phase16[0][8] += clock64() - t_end;\n"
     "  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e; lse = m ln 2 +"),
]
_FWD16_MARK_ENTRIES = """
extern "C" int sea_phase16_read(long long* host) {
  return cudaMemcpyFromSymbol(host, g_phase16, sizeof(g_phase16));
}
extern "C" int sea_phase16_zero() {
  static const long long zero[20] = {};
  return cudaMemcpyToSymbol(g_phase16, zero, sizeof(zero));
}
"""
FWD16_PHASES = ("data wait", "S+PV", "softmax", "rescale")


def probe_forward():
    base = SOURCE.read_text()
    texts = {name: edit(base, edits) for name, edits in VARIANTS.items()}
    texts["as_is+marks"] = edit(base, _MARKS) + _MARK_ENTRIES
    build_all(OUT, SOURCE.name, texts, "fwd_kernel", KERNEL)
    for name in VARIANTS:
        use(OUT, name, SOURCE.name, FA)
        worst = [0.0, 0.0]
        for shape in cs.FLASH_SHAPES:
            for rate in (0.0, 0.1):
                q, k, v, _ = cs._flash_inputs(shape)
                kw = cs._flash_kw(shape, rate)
                o, lse = FA.flash_fwd(q, k, v, **kw)
                o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
                worst = [max(worst[0], cs._err(o, o_ref)),
                         max(worst[1], cs._err(lse, lse_ref))]
        log(f"[probe-check] {name}: max abs err out {worst[0]:.3g}, lse "
            f"{worst[1]:.3g} over FLASH_SHAPES x dropout (0, 0.1)")
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    times = collections.defaultdict(list)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        use(OUT, name, SOURCE.name, FA)
        for shape in cs.FLASH_SHAPES[:3]:
            q, k, v, _ = cs._flash_inputs(shape)
            for rate in (0.0, 0.1):
                kw = cs._flash_kw(shape, rate)
                times[(shape, rate, name)].append(cs._device_ms(
                    lambda: FA.flash_fwd(q, k, v, **kw), flush))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in cs.FLASH_SHAPES[:3]:
        B, Tq, _, H, hd = shape[:5]
        q, k, v, _ = cs._flash_inputs(shape)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        with torch.no_grad():
            lib = cs._device_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                flush)
        for rate in (0.0, 0.1):
            log(f"[probe-time] (B,T,H,hd)=({B},{Tq},{H},{hd}) dropout "
                f"{rate}, L2 cold, ms (two runs each): " + ", ".join(
                    f"{name} {times[(shape, rate, name)][0]:.4f} / "
                    f"{times[(shape, rate, name)][1]:.4f}"
                    for name in VARIANTS) + f"; SDPA forward {lib:.4f}")
    lib = use(OUT, "as_is+marks", SOURCE.name, FA)
    for shape in cs.FLASH_SHAPES[:3]:
        q, k, v, _ = cs._flash_inputs(shape)
        for rate in (0.0, 0.1):
            kw = cs._flash_kw(shape, rate)
            FA.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            lib.sea_phase_zero()
            for _ in range(10):
                flush.sum()
                FA.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 24)()
            lib.sea_phase_read(buf)
            tiles = buf[5]
            per_warp = [[round(buf[6 * w + i] / tiles) for i in range(5)]
                        for w in range(4)]
            B, T, _, H, hd = shape[:5]
            log(f"[probe-phases] (B,T,H,hd)=({B},{T},{H},{hd}) "
                f"dropout {rate}: {tiles // 10} key tiles; clock64 cycles a "
                f"tile, warps 0-3, {'/'.join(PHASES)}: {per_warp}")


def _bf16_inputs(shape):
    return [x.to(torch.bfloat16) for x in cs._flash_inputs(shape)]


def probe_forward16():
    base = SOURCE.read_text()
    out = OUT.parent / "flash_probe_fwd16"
    texts = {name: edit(base, e) for name, e in FWD16_VARIANTS.items()}
    texts["cluster2"] = _cluster2(base)
    texts["as_is+marks"] = edit(base, _FWD16_MARKS) + _FWD16_MARK_ENTRIES
    build_all(out, SOURCE.name, texts, "15fwd_kernel_bf16I",
              "fwd_kernel_bf16<HD, BK, stages> in mangled order")
    names = [*FWD16_VARIANTS, "cluster2"]
    for name in names:
        use(out, name, SOURCE.name, FA)
        worst, same = [0.0, 0.0], True
        for shape in cs.FLASH_SHAPES:
            q, k, v, _ = _bf16_inputs(shape)
            for rate in (0.0, 0.1):
                kw = cs._flash_kw(shape, rate)
                o, lse = FA.flash_fwd(q, k, v, **kw)
                o2, lse2 = FA.flash_fwd(q, k, v, **kw)
                same &= torch.equal(o, o2) and torch.equal(lse, lse2)
                o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
                err, bound = cs._bf16_err(o, o_ref, cs.FLASH_BF16_REL["out"],
                                          cs.FLASH_TOL["out"])
                if not (err <= bound and cs._err(lse, lse_ref) <= 1e-5):
                    raise AssertionError(f"{name} {shape} rate={rate}: o "
                                         f"err {err} > {bound} or lse err "
                                         f"{cs._err(lse, lse_ref)} > 1e-5")
                worst = [max(worst[0], err),
                         max(worst[1], cs._err(lse, lse_ref))]
        log(f"[probe-check] fwd16 {name}: max abs err o {worst[0]:.3g}, lse "
            f"{worst[1]:.3g} over FLASH_SHAPES x dropout (0, 0.1); a second "
            f"call the same bits: {same}")
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    times = collections.defaultdict(list)
    for name in names + names[::-1]:
        use(out, name, SOURCE.name, FA)
        for shape in cs.FLASH_SHAPES[:3]:
            q, k, v, _ = _bf16_inputs(shape)
            for rate in (0.0, 0.1):
                kw = cs._flash_kw(shape, rate)
                times[(shape, rate, name)].append(cs._device_ms(
                    lambda: FA.flash_fwd(q, k, v, **kw), flush))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in cs.FLASH_SHAPES[:3]:
        B, Tq, _, H, hd = shape[:5]
        q, k, v, _ = _bf16_inputs(shape)
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        with torch.no_grad():
            lib = cs._library_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                 flush)
        for rate in (0.0, 0.1):
            log(f"[probe-time] fwd16 (B,T,H,hd)=({B},{Tq},{H},{hd}) dropout "
                f"{rate}, L2 cold, ms (two runs each): " + ", ".join(
                    f"{name} {times[(shape, rate, name)][0]:.4f} / "
                    f"{times[(shape, rate, name)][1]:.4f}"
                    for name in names)
                + f"; SDPA bf16 forward {lib:.4f}")
    lib = use(out, "as_is+marks", SOURCE.name, FA)
    for shape in cs.FLASH_SHAPES[:3]:
        q, k, v, _ = _bf16_inputs(shape)
        for rate in (0.0, 0.1):
            kw = cs._flash_kw(shape, rate)
            FA.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            lib.sea_phase16_zero()
            for _ in range(10):
                flush.sum()
                FA.flash_fwd(q, k, v, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 20)()
            lib.sea_phase16_read(buf)
            B, T, _, H, hd = shape[:5]
            rows = []
            for grp in (0, 1):
                r = buf[10 * grp:10 * grp + 10]
                tiles = max(r[4], 1)
                rows.append(f"group {grp}: {r[4] // 10 + 1} tiles, "
                            + "/".join(str(round(r[i] / tiles))
                                       for i in range(4))
                            + f" a tile after the first; Q wait "
                            f"{r[6] // 10}; tile 0 {r[7] // 10}; last P.V "
                            f"+ merge {r[8] // 10}"
                            + (f" (of it waiting for group 1 {r[9] // 10})"
                               if grp == 0 else ""))
            log(f"[probe-phases] fwd16 (B,T,H,hd)=({B},{T},{H},{hd}) "
                f"dropout {rate}, clock64 cycles of the critical block, "
                f"{'/'.join(FWD16_PHASES)}: " + "; ".join(rows))


# The bf16 backward's wgmma forms (bwd16). Variants:
_DQ_CASES = ("      return launch_dq_bf16<64, 64, 2>(",
             "      return launch_dq_bf16<128, 64, 3>(",
             "      return launch_dq_bf16<256, 32, 2>(")
_DKV_CASES = ("      return launch_dkv_bf16<64, 64, 4, false>(",
              "      return launch_dkv_bf16<128, 32, 3, false>(",
              "      return launch_dkv_bf16<256, 32, 3, true>(")
BWD16_VARIANTS = {
    "as_is": [],
    # one consumer group walks every tile, the other none (the kWalkers
    # edit of bwd's one_group)
    "one_group": BWD_VARIANTS["one_group"],
    "dsplit128": [(_DKV_CASES[1], _DKV_CASES[1].replace("false", "true"))],
    # under the d split each group forms all of S^T and dP^T (no halves to
    # exchange, so four stages fit)
    "full_s": [
        ("  static constexpr int SD = DW;", "  static constexpr int SD = HD;"),
        ("  static constexpr int kHalfFloats = SPLIT_D ? 2 * 2 * BQ * 128 : 0;",
         "  static constexpr int kHalfFloats = 0;"),
        ("  const int sbox = SPLIT_D ? group * (T::SD / 64) : 0;",
         "  const int sbox = 0;"),
        ("    if constexpr (SPLIT_D) {\n      float* mine_h",
         "    if constexpr (false) {\n      float* mine_h"),
        (_DKV_CASES[2], _DKV_CASES[2].replace("32, 3,", "32, 4,"))],
    "walk32": [(_DQ_CASES[0], _DQ_CASES[0].replace("64, 64, 2", "64, 32, 2")),
               (_DQ_CASES[1], _DQ_CASES[1].replace("64, 3", "32, 3")),
               (_DKV_CASES[0], _DKV_CASES[0].replace("64, 64, 4",
                                                     "64, 32, 4"))],
    "walk64": [(_DKV_CASES[1], _DKV_CASES[1].replace("32, 3", "64, 2"))],
    "st2": [(_DQ_CASES[1], _DQ_CASES[1].replace("64, 3>", "64, 2>")),
            (_DKV_CASES[0], _DKV_CASES[0].replace("64, 4,", "64, 2,")),
            (_DKV_CASES[1], _DKV_CASES[1].replace("32, 3,", "32, 2,")),
            (_DKV_CASES[2], _DKV_CASES[2].replace("32, 3,", "32, 2,"))],
    "st3": [(_DQ_CASES[0], _DQ_CASES[0].replace("64, 2>", "64, 3>")),
            (_DKV_CASES[0], _DKV_CASES[0].replace("64, 4,", "64, 3,"))],
}

# clock64 marks of the critical block of each kernel (bh 0; dQ's last q
# tile, dK/dV's first key tile), thread 0 of each consumer group, summed
# over calls, into g_phase_b16[kernel][group]: per walked tile after the
# first the wait for its tiles (0), S and dP with the products before (1),
# dS (2) and their count (3); the wait for the block's own tiles (6), tile
# 0 (7), the last products (8) and the merge up to the store (9).
_B16_ACC = ("        const long long d[4] = {tb - ta, tc - tb, td - tc, 1};\n"
            "        for (int v = 0; v < 4; ++v) "
            "g_phase_b16[kKind][group][v] += d[v];\n")
_B16_START = ("  const bool mark = blockIdx.x == 0 && blockIdx.y == 0 && "
              "tid == 0;\n  const long long t0 = clock64();\n")
_B16_STARTED = ("  const long long tq = clock64();\n  long long t_end = tq;\n"
                "  if (mark) g_phase_b16[kKind][group][6] += tq - t0;\n")
_B16_TAIL = ("  if (mark) g_phase_b16[kKind][group][8] += clock64() - t_end;\n"
             "  const long long tm = clock64();\n")
_B16_MERGE = "  if (mark) g_phase_b16[kKind][group][9] += clock64() - tm;\n"
_BWD16_MARKS = [
    ("// Tiles and rings of dq_kernel_bf16:",
     "__device__ long long g_phase_b16[2][2][10];\n"
     "// Tiles and rings of dq_kernel_bf16:"),
    ("  using T = DqWg<HD, BK, ST>;\n  constexpr int NS = BK / 8;",
     "  using T = DqWg<HD, BK, ST>;\n  constexpr int kKind = 0;\n"
     "  constexpr int NS = BK / 8;"),
    ("  using T = DkvWg<HD, BQ, ST, SPLIT_D>;\n  constexpr int NS = BQ / 8;",
     "  using T = DkvWg<HD, BQ, ST, SPLIT_D>;\n  constexpr int kKind = 1;\n"
     "  constexpr int NS = BQ / 8;"),
    ("  mbar_wait(qo_full, 0);\n",
     _B16_START + "  mbar_wait(qo_full, 0);\n" + _B16_STARTED),
    ("  mbar_wait(kv_full, 0);\n",
     _B16_START + "  mbar_wait(kv_full, 0);\n" + _B16_STARTED),
    ("    grad(0);\n",
     "    grad(0);\n"
     "    if (mark) g_phase_b16[kKind][group][7] += clock64() - tq;\n"),
    ("      mbar_wait(k_full + group * ST + u, (i / ST) & 1);\n"
     "      mbar_wait(v_full + group * ST + u, (i / ST) & 1);\n",
     "      const long long ta = clock64();\n"
     "      mbar_wait(k_full + group * ST + u, (i / ST) & 1);\n"
     "      mbar_wait(v_full + group * ST + u, (i / ST) & 1);\n"
     "      const long long tb = clock64();\n"),
    ("      mbar_wait(q_full + ring0 + u, (i / ST) & 1);\n"
     "      mbar_wait(o_full + ring0 + u, (i / ST) & 1);\n",
     "      const long long ta = clock64();\n"
     "      mbar_wait(q_full + ring0 + u, (i / ST) & 1);\n"
     "      mbar_wait(o_full + ring0 + u, (i / ST) & 1);\n"
     "      const long long tb = clock64();\n"),
    ("      mbar_arrive(empty + group * ST + up);\n      grad(i);\n",
     "      const long long tc = clock64();\n"
     "      mbar_arrive(empty + group * ST + up);\n      grad(i);\n"),
    ("      mbar_arrive(empty + ring0 + up);\n      add_halves(i);\n",
     "      const long long tc = clock64();\n"
     "      mbar_arrive(empty + ring0 + up);\n      add_halves(i);\n"),
    ("      grad(i);\n    }\n",
     "      grad(i);\n      const long long td = clock64();\n"
     "      if (mark) {\n" + _B16_ACC + "      }\n    }\n"
     "    t_end = clock64();\n"),
    ("(acc, ds, km + up * kStageStep);\n    wgmma_commit();\n"
     "    wgmma_wait<0>();\n    pin(acc);\n"
     "    mbar_arrive(empty + group * ST + up);\n  }\n",
     "(acc, ds, km + up * kStageStep);\n    wgmma_commit();\n"
     "    wgmma_wait<0>();\n    pin(acc);\n"
     "    mbar_arrive(empty + group * ST + up);\n  }\n" + _B16_TAIL),
    ("    pin(gv);\n    mbar_arrive(empty + ring0 + up);\n  }\n",
     "    pin(gv);\n    mbar_arrive(empty + ring0 + up);\n  }\n"
     + _B16_TAIL),
    ("  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e.\n",
     _B16_MERGE + "  // acc[4c + 2r + e] is row row0 + 8r, d = 8c + 2t + e.\n"),
    ("  // gk[4c + 2r + e] is key key0 + 8r",
     _B16_MERGE + "  // gk[4c + 2r + e] is key key0 + 8r"),
]
_BWD16_MARK_ENTRIES = """
extern "C" int sea_phase_b16_read(long long* host) {
  return cudaMemcpyFromSymbol(host, g_phase_b16, sizeof(g_phase_b16));
}
extern "C" int sea_phase_b16_zero() {
  static const long long zero[40] = {};
  return cudaMemcpyToSymbol(g_phase_b16, zero, sizeof(zero));
}
"""
BWD16_PHASES = ("data wait", "S,dP+products", "dS")


def _bwd16_calls(shape, rate):
    """(dq call, dk/dv call, plain pieces) of the bf16 backward at shape,
    from the plain forward's lse and D."""
    q, k, v, g = _bf16_inputs(shape)
    kw = cs._flash_kw(shape, rate)
    o, lse = FA.flash_forward_ref(q, k, v, **kw)
    dsum = FA.row_dot(g, o)
    return (lambda: FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw),
            lambda: FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw),
            (FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw),
             *FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum, **kw)))


def probe_backward16(check_only=False):
    base = SOURCE.read_text()
    out = OUT.parent / "flash_probe_bwd16"
    texts = {name: edit(base, e) for name, e in BWD16_VARIANTS.items()}
    texts["as_is+marks"] = edit(base, _BWD16_MARKS) + _BWD16_MARK_ENTRIES
    # --check: every edit still applies, but only the source as it is and
    # its marked form are built and checked
    names = ["as_is"] if check_only else list(BWD16_VARIANTS)
    build_all(out, SOURCE.name,
              {name: texts[name] for name in names + ["as_is+marks"]},
              ("14dq_kernel_bf16I", "15dkv_kernel_bf16I"),
              "dq_kernel_bf16<HD, BK, stages>, then dkv_kernel_bf16<HD, BQ, "
              "stages, mode>, each in mangled order")
    for name in names + ["as_is+marks"]:
        use(out, name, SOURCE.name, FA)
        worst, same = {"dq": 0.0, "dk/dv": 0.0}, True
        for shape in cs.FLASH_SHAPES:
            for rate in (0.0, 0.1):
                dq_call, dkv_call, ref = _bwd16_calls(shape, rate)
                got = [(dq_call(), *dkv_call()) for _ in range(2)]
                same &= all(torch.equal(a, b) for a, b in zip(*got))
                for kind, a, b in zip(("dq", "dk/dv", "dk/dv"), got[0], ref):
                    err, bound = cs._bf16_err(a, b, cs.FLASH_BF16_REL["grad"],
                                              cs.FLASH_TOL["grad"])
                    if not err <= bound:
                        raise AssertionError(f"bwd16 {name} {shape} rate="
                                             f"{rate}: {kind} err {err} > "
                                             f"{bound}")
                    worst[kind] = max(worst[kind], err)
        log(f"[probe-check] bwd16 {name}: max abs err dq {worst['dq']:.3g}, "
            f"dk/dv {worst['dk/dv']:.3g} over FLASH_SHAPES x dropout (0, "
            f"0.1); a second call the same bits: {same}")
        if not same:
            raise AssertionError(f"bwd16 {name}: a second call differs")
    if check_only:
        return
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    times = collections.defaultdict(list)
    for name in names + names[::-1]:
        use(out, name, SOURCE.name, FA)
        for shape in cs.FLASH_SHAPES[:3]:
            for rate in (0.0, 0.1):
                dq_call, dkv_call, _ = _bwd16_calls(shape, rate)
                times[(shape, rate, "dq", name)].append(
                    cs._device_ms(dq_call, flush))
                times[(shape, rate, "dkv", name)].append(
                    cs._device_ms(dkv_call, flush))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in cs.FLASH_SHAPES[:3]:
        B, Tq, _, H, hd = shape[:5]
        q, k, v, g = _bf16_inputs(shape)
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not g) for x in (q, k, v, g))
        graph_out = sdpa(qt, kt, vt, is_causal=True)
        lib = cs._library_ms(lambda: torch.autograd.grad(
            graph_out, (qt, kt, vt), gt, retain_graph=True), flush)
        for rate in (0.0, 0.1):
            pairs = []
            for name in names:
                pairs.append(f"{name} " + " / ".join(
                    f"{times[(shape, rate, 'dq', name)][i]:.4f} + "
                    f"{times[(shape, rate, 'dkv', name)][i]:.4f}"
                    for i in range(2)))
            log(f"[probe-time] bwd16 (B,T,H,hd)=({B},{Tq},{H},{hd}) dropout "
                f"{rate}, L2 cold, dQ + dK/dV ms (two runs each): "
                + ", ".join(pairs) + f"; SDPA bf16 backward {lib:.4f}")
    lib = use(out, "as_is+marks", SOURCE.name, FA)
    for shape in cs.FLASH_SHAPES[:3]:
        for rate in (0.0, 0.1):
            dq_call, dkv_call, _ = _bwd16_calls(shape, rate)
            dq_call()
            dkv_call()
            torch.cuda.synchronize()
            lib.sea_phase_b16_zero()
            for _ in range(10):
                flush.sum()
                dq_call()
                flush.sum()
                dkv_call()
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 40)()
            lib.sea_phase_b16_read(buf)
            B, T, _, H, hd = shape[:5]
            for kind, label in enumerate(("dq", "dkv")):
                rows = []
                for grp in (0, 1):
                    r = buf[20 * kind + 10 * grp:20 * kind + 10 * grp + 10]
                    tiles = max(r[3], 1)
                    rows.append(
                        f"group {grp}: {r[3] // 10} tiles after the first, "
                        + "/".join(str(round(r[i] / tiles)) for i in range(3))
                        + f" a tile; own tiles' wait {r[6] // 10}; tile 0 "
                        f"{r[7] // 10}; last products {r[8] // 10}; merge "
                        f"{r[9] // 10}")
                log(f"[probe-phases] bwd16 {label} (B,T,H,hd)=({B},{T},{H},"
                    f"{hd}) dropout {rate}, clock64 cycles of the critical "
                    f"block, {'/'.join(BWD16_PHASES)}: " + "; ".join(rows))


def probe_backward():
    base = SOURCE.read_text()
    out = OUT.parent / "flash_probe_bwd"
    texts = {name: edit(base, edits) for name, edits in BWD_VARIANTS.items()}
    texts["as_is+marks"] = edit(base, _BWD_MARKS) + _BWD_MARK_ENTRIES
    build_all(out, SOURCE.name, texts, "_kernel",
              "dkv_kernel<256>, <128>, <64>, <16>, <8>, dq_kernel likewise")
    for name in BWD_VARIANTS:
        use(out, name, SOURCE.name, FA)
        worst = [0.0, 0.0]
        for shape in cs.FLASH_SHAPES:
            for rate in (0.0, 0.1):
                q, k, v, g = cs._flash_inputs(shape)
                kw = cs._flash_kw(shape, rate)
                o, lse = FA.flash_forward_ref(q, k, v, **kw)
                dsum = FA.row_dot(g, o)
                dq = FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw)
                dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw)
                dq_ref = FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw)
                dk_ref, dv_ref = FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum,
                                                      **kw)
                worst = [max(worst[0], cs._err(dq, dq_ref)),
                         max(worst[1], cs._err(dk, dk_ref),
                             cs._err(dv, dv_ref))]
        log(f"[probe-check] {name}: max abs err dq {worst[0]:.3g}, dk/dv "
            f"{worst[1]:.3g} over FLASH_SHAPES x dropout (0, 0.1)")
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    times = collections.defaultdict(list)
    for name in list(BWD_VARIANTS) + list(BWD_VARIANTS)[::-1]:
        use(out, name, SOURCE.name, FA)
        for shape in cs.FLASH_SHAPES[:3]:
            q, k, v, g = cs._flash_inputs(shape)
            for rate in (0.0, 0.1):
                kw = cs._flash_kw(shape, rate)
                o, lse = FA.flash_forward_ref(q, k, v, **kw)
                dsum = FA.row_dot(g, o)
                times[(shape, rate, "dq", name)].append(cs._device_ms(
                    lambda: FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw),
                    flush))
                times[(shape, rate, "dkv", name)].append(cs._device_ms(
                    lambda: FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw),
                    flush))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in cs.FLASH_SHAPES[:3]:
        B, Tq, _, H, hd = shape[:5]
        q, k, v, g = cs._flash_inputs(shape)
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not g) for x in (q, k, v, g))
        graph_out = sdpa(qt, kt, vt, is_causal=True)
        lib = cs._library_ms(lambda: torch.autograd.grad(
            graph_out, (qt, kt, vt), gt, retain_graph=True), flush)
        leads = [cs._device_ms(lambda: torch.autograd.grad(
            graph_out, (qt, kt, vt), gt, retain_graph=True), flush, lead=n)
            for n in (1, 4, 8)]
        log(f"[probe-time] SDPA backward (B,T,H,hd)=({B},{Tq},{H},{hd}) "
            f"behind 1, 4 and 8 flushes: "
            + " / ".join(f"{x:.4f}" for x in leads) + " ms")
        for rate in (0.0, 0.1):
            for kernel in ("dq", "dkv"):
                log(f"[probe-time] {kernel} (B,T,H,hd)=({B},{Tq},{H},{hd}) "
                    f"dropout {rate}, L2 cold, ms (two runs each): "
                    + ", ".join(
                        f"{name} {times[(shape, rate, kernel, name)][0]:.4f}"
                        f" / {times[(shape, rate, kernel, name)][1]:.4f}"
                        for name in BWD_VARIANTS)
                    + f"; SDPA backward (dq, dk, dv) {lib:.4f}")
    lib = use(out, "as_is+marks", SOURCE.name, FA)
    for shape in cs.FLASH_SHAPES[:3]:
        q, k, v, g = cs._flash_inputs(shape)
        for rate in (0.0, 0.1):
            kw = cs._flash_kw(shape, rate)
            o, lse = FA.flash_forward_ref(q, k, v, **kw)
            dsum = FA.row_dot(g, o)
            FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw)
            FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw)
            torch.cuda.synchronize()
            lib.sea_bwd_phase_zero()
            for _ in range(10):
                flush.sum()
                FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw)
                flush.sum()
                FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw)
            torch.cuda.synchronize()
            buf = (ctypes.c_longlong * 96)()
            lib.sea_bwd_phase_read(buf)
            B, T, _, H, hd = shape[:5]
            for kind, name in enumerate(("dq", "dkv")):
                rows = [buf[48 * kind + 6 * w:48 * kind + 6 * w + 6]
                        for w in range(8)]
                log(f"[probe-phases] {name} (B,T,H,hd)=({B},{T},{H},{hd}) "
                    f"dropout {rate}: tiles a warp of groups 0 / 1 "
                    f"{rows[0][5] // 10} / {rows[4][5] // 10}; clock64 "
                    f"cycles a tile, warps 0-7, {'/'.join(BWD_PHASES)}: "
                    + str([[round(r[i] / max(r[5], 1)) for i in range(5)]
                           for r in rows]))


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("chip_flash_probe.py: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    check_only = "--check" in argv
    parts = [a for a in argv if a != "--check"] or ["fwd", "fwd16", "bwd",
                                                     "bwd16"]
    if "fwd" in parts:
        probe_forward()
    if "fwd16" in parts:
        probe_forward16()
    if "bwd" in parts:
        probe_backward()
    if "bwd16" in parts:
        probe_backward16(check_only)


if __name__ == "__main__":
    main(sys.argv[1:])
