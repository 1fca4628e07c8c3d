"""Where the flash kernels' time goes, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_flash_probe.py [fwd] [bwd]      (both when none is named)

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
        B, Tq, _, H, hd, _ = shape
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
            B, T, _, H, hd, _ = shape
            log(f"[probe-phases] (B,T,H,hd)=({B},{T},{H},{hd}) "
                f"dropout {rate}: {tiles // 10} key tiles; clock64 cycles a "
                f"tile, warps 0-3, {'/'.join(PHASES)}: {per_warp}")


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
        B, Tq, _, H, hd, _ = shape
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
            B, T, _, H, hd, _ = shape
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
    parts = argv or ["fwd", "bwd"]
    if "fwd" in parts:
        probe_forward()
    if "bwd" in parts:
        probe_backward()


if __name__ == "__main__":
    main(sys.argv[1:])
