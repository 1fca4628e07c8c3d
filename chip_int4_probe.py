"""Where the int4 matvec kernel's time goes, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_int4_probe.py

It builds ``sea_tpu_torch/csrc/quant_matmul.cu`` as it is and in variants
made by text edits of that source (an edit that no longer applies fails
the script), one nvcc (with ``-Xptxas -v``) each, started together. Every
variant that computes the product is held against the plain version at
``chip_smoke.INT4_SHAPES`` (M = 1 and 8) and ``chip_smoke.INT4_RAGGED``
(M = 1, 3, 8), within ``chip_smoke.INT4_REL_TOL``. Each variant is then
timed as ``chip_smoke.py``'s ``[kernel-time]`` times the kernel (CUDA
events, L2 cold) at every rollout shape, M = 1 and 8, in the order
variants, then variants reversed, beside cuBLAS over the dequantized
weight; with the sum over a rollout step's launches. Variants:

- ``stages4`` / ``stages6``: a ring of 4 / 6 or 6 / 8 stages (128 / 64
  columns) instead of 5 / 7;
- ``no_dequant`` / ``no_mma``: the nibbles go to the MMA as they are /
  the dequantized registers are XORed into an accumulator instead of
  the MMA (both wrong: timed only);
- ``copy_only``: the weights and x stream through the ring but no MMA
  k-step runs (its result is wrong: timed only) — the copies and the sums;
- ``no_copy``: the k-steps run on whatever the ring holds, and no weight
  is copied (wrong too: timed only) — x, the dequantization and the
  products.

Then: the SASS of the kernel as it is (opcode counts; the listing in
``build/int4_probe/sass.txt``); the card's clocks; a copy-only
stream of the same weight bytes through a plain ``cp.async`` ring at
several widths a block reads per row and ring depths (the rate the card
gives such a stream); the time of a one-element fill kernel timed the
same way (the floor of the method); per-block marks of the source as it
is, one launch a shape: ``%globaltimer`` when each block started, issued
its first stages, finished its k loop, summed its warps, passed the
cluster barrier and ended, on which SM it ran, and warp 0's ``clock64``
cycles in the k loop's copy issue, waits and k-steps; last, the source
as it is under other grids than the plan's at the two shapes of
chip_smoke's JSON line and the down-projection.

Output: the card, then one line per build, check, time and mark.
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
from sea_tpu_torch.ops import _build
from sea_tpu_torch.ops import quant_matmul as QM

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "int4_probe"
SOURCE = REPO / "sea_tpu_torch" / "csrc" / "quant_matmul.cu"

_STAGES = "static constexpr int kStages = V == 16 ? 5 : 7;"
_MMA = "      mma_step<V>(acc, slot, warp * kStepRows, M, g, t);"
_COPY = "        cp_async16(slot + wdst[i], src);"
_SLOT = """    slot = slot + T::kStageBytes == ring + T::kRingBytes
               ? ring : slot + T::kStageBytes;
  }
"""
_DEQUANT = "  constexpr uint32_t k136 = 0x43084308u;\n"
_HMMA = """  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
"""
_HMMA_XOR = """  d[0] = __uint_as_float(__float_as_uint(d[0]) ^ a[0] ^ a[1] ^ a[2] ^
                         a[3] ^ b0 ^ b1);
"""
VARIANTS = {
    "as_is": [],
    "stages4": [(_STAGES, _STAGES.replace("5 : 7", "4 : 6"))],
    "stages6": [(_STAGES, _STAGES.replace("5 : 7", "6 : 8"))],
    "no_dequant": [(_DEQUANT, "  return v;\n" + _DEQUANT)],
    "no_mma": [(_HMMA, _HMMA_XOR)],
    "copy_only": [(_MMA, _MMA.replace("mma_step", "if (N < 0) mma_step"))],
    "no_copy": [(_COPY, _COPY.replace("cp_async16", "if (N < 0) cp_async16"))],
}
TIMED_ONLY = ("no_dequant", "no_mma", "copy_only", "no_copy")
# %globaltimer marks per block, written by thread 0 of the source as it
# is: start, first stages issued, k loop done, warps summed, first
# cluster barrier passed (the same time twice for a cluster of one), end;
# then the SM the block ran on, and warp 0's clock64 cycles in the k
# loop's waits (and barriers), copy issue and k-steps.
_WRITE = ("  if (threadIdx.x == 0) {\n"
          "    const int b = blockIdx.y * gridDim.x + blockIdx.x;\n"
          "    unsigned smid;\n"
          "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
          "    if (b < 2048) {\n"
          "      for (int i = 0; i < 5; ++i) g_marks[b][i] = mk[i];\n"
          "      g_marks[b][5] = gtimer();\n"
          "      g_marks[b][6] = smid;\n"
          "      g_marks[b][7] = 1;\n"
          "      g_marks[b][8] = c_wait; g_marks[b][9] = c_issue;\n"
          "      g_marks[b][10] = c_mma; g_marks[b][11] = clock64() - c_start;\n"
          "    }\n  }\n")
_MARKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_marks[2048][12];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  const int g = lane >> 2, t = lane & 3;\n",
     "  const int g = lane >> 2, t = lane & 3;\n"
     "  unsigned long long mk[5] = {gtimer(), 0, 0, 0, 0};\n"
     "  const long long c_start = clock64();\n"),
    ('asm("mma.sync', 'asm volatile("mma.sync'),
    ("  float acc[T::kMmaTiles][4];\n",
     "  mk[1] = gtimer();\n  float acc[T::kMmaTiles][4];\n"),
    ("  for (int st = 0; st < stages; ++st) {\n",
     "  long long c_wait = 0, c_issue = 0, c_mma = 0;\n"
     "  for (int st = 0; st < stages; ++st) {\n"
     "    const long long ca = clock64();\n"),
    ("    cp_async_wait<S - 2>();\n",
     "    const long long cb = clock64();\n    cp_async_wait<S - 2>();\n"),
    ("    __syncthreads();  // stage st landed, for every thread's copies\n",
     "    __syncthreads();  // stage st landed, for every thread's copies\n"
     "    const long long cc = clock64();\n"),
    (_SLOT, _SLOT[:-4] + "\n    const long long cd = clock64();\n"
     "    c_issue += cb - ca; c_wait += cc - cb; c_mma += cd - cc;\n  }\n"),
    ("  cp_async_wait<0>();\n  __syncthreads();\n  float4* red",
     "  cp_async_wait<0>();\n  __syncthreads();\n  mk[2] = gtimer();\n"
     "  float4* red"),
    ("  if (ranks == 1) return;\n",
     "  if (ranks == 1) {\n    mk[3] = mk[4] = gtimer();\n" + _WRITE
     + "    return;\n  }\n"),
    ("  // touches another's shared memory after it.\n  cluster.sync();\n",
     "  // touches another's shared memory after it.\n  mk[3] = gtimer();\n"
     "  cluster.sync();\n  mk[4] = gtimer();\n"),
    ("sum * s_tile[col];\n  }\n}\n",
     "sum * s_tile[col];\n  }\n" + _WRITE + "}\n"),
]
_MARK_ENTRIES = """
extern "C" int sea_marks_read(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks));
}
extern "C" int sea_marks_zero() {
  static const unsigned long long zero[2048 * 12] = {};
  return cudaMemcpyToSymbol(g_marks, zero, sizeof(zero));
}
"""
MARKED_VARIANTS = ("as_is",)
PHASES = ("prologue", "k loop", "warp sums", "cluster wait", "rank sums")
MARKED = [(1, 2048, 16384), (8, 2048, 16384), (1, 16384, 2048),
          (8, 16384, 2048), (8, 2048, 6144), (8, 1024, 1024)]
# A copy-only stream of a uint8 [K2, N] weight through a shared-memory
# ring of 16-byte cp.async, with no product: how the bytes a block reads
# per row (W) and the ring's depth (S stages of 16 KB) set the rate the
# card delivers to such a stream. Each block takes a [rows, W] tile.
_STREAM = r"""
#include <cuda_runtime.h>
#include <stdint.h>
template <int W, int S>
__global__ void __launch_bounds__(256, 1)
stream(const uint8_t* __restrict__ wp, int N, int rows, uint8_t* sink) {
  constexpr int R = 16384 / W;  // rows a stage
  extern __shared__ __align__(16) uint8_t ring[];
  const int r0 = blockIdx.x * rows, c0 = blockIdx.y * W;
  const int stages = rows / R;
  auto issue = [&](int st) {
    for (int p = threadIdx.x; p < R * W / 16; p += 256) {
      const int r = p / (W / 16), c = p % (W / 16);
      const uint8_t* src = wp + (size_t)(r0 + st * R + r) * N + c0 + 16 * c;
      const unsigned d = (unsigned)__cvta_generic_to_shared(
          ring + (st % S) * 16384 + 16 * p);
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d),
                   "l"(src));
    }
    asm volatile("cp.async.commit_group;");
  };
  for (int st = 0; st < S - 1; ++st) {
    if (st < stages) issue(st);
    else asm volatile("cp.async.commit_group;");
  }
  unsigned acc = 0;
  for (int st = 0; st < stages; ++st) {
    asm volatile("cp.async.wait_group %0;" ::"n"(S - 2) : "memory");
    __syncthreads();
    acc += ring[(st % S) * 16384 + threadIdx.x * 64];
    __syncthreads();
    if (st + S - 1 < stages) issue(st + S - 1);
    else asm volatile("cp.async.commit_group;");
  }
  if (acc == 0x12345678u) sink[0] = 1;
}
#define CASES(X) X(128, 2) X(128, 4) X(128, 6) X(256, 4) X(512, 2) \
  X(512, 4) X(1024, 4) X(2048, 2) X(2048, 4)
extern "C" int sea_stream(const void* wp, int K2, int N, int W, int S,
                          int tiles_k, void* sink, void* st) {
  const dim3 grid(tiles_k, N / W);
  const int rows = K2 / tiles_k;
#define RUN(w, s)                                                          \
  if (W == w && S == s) {                                                  \
    cudaFuncSetAttribute(stream<w, s>,                                     \
                         cudaFuncAttributeMaxDynamicSharedMemorySize,      \
                         s * 16384);                                       \
    stream<w, s><<<grid, 256, s * 16384, (cudaStream_t)st>>>(              \
        (const uint8_t*)wp, N, rows, (uint8_t*)sink);                      \
    return (int)cudaGetLastError();                                        \
  }
  CASES(RUN)
  return -1;
}
"""
STREAMS = [(128, 2), (128, 4), (128, 6), (256, 4), (512, 2), (512, 4),
           (1024, 4), (2048, 2), (2048, 4)]
# (M, K, N) -> other grids (cols, cluster) than the plan's.
GRIDS = {(1, 2048, 16384): [(64, 1), (128, 2), (64, 2)],
         (8, 16384, 2048): [(128, 8), (128, 4), (64, 8), (64, 4)],
         (8, 2048, 16384): [(64, 1), (128, 2)]}


def _sass(lib):
    """The SASS of the 128-column kernel's 16-byte form: its opcode counts,
    and the whole listing in build/int4_probe/sass.txt."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    OUT.mkdir(parents=True, exist_ok=True)
    (OUT / "sass.txt").write_text(text)
    body = next(f for f in text.split("Function : ")
                if f.startswith("_Z") and "int4_matvec_mmaILi16ELb1E" in
                f.splitlines()[0])
    ops = collections.Counter()
    for line in body.splitlines():
        parts = line.strip().split("*/")
        if line.strip().startswith("/*") and len(parts) > 2 and \
                parts[1].strip():
            tokens = parts[1].split()
            ops[tokens[1] if tokens[0].startswith("@") else tokens[0]] += 1
    log(f"[probe-sass] int4_matvec_mma<16, true>: {sum(ops.values())} "
        f"instructions; " + ", ".join(f"{k} {v}"
                                      for k, v in ops.most_common(40)))


def _check(name):
    worst = 0.0
    cases = ([(M, K, N) for K, N in cs.INT4_SHAPES for M in (1, 8)]
             + [(M, K, N) for K, N in cs.INT4_RAGGED for M in (1, 3, 8)])
    for M, K, N in cases:
        x, wp, s = cs._int4_cases(M, K, N)
        got = QM.int4_matmul(x, wp, s)
        want = QM.int4_matvec_ref(x, wp, s)
        mag = (x.to(torch.bfloat16).float().abs()
               @ QM.unpack_int4(wp, torch.float32).abs()) * s
        if not bool(((got - want).abs() <= cs.INT4_REL_TOL * mag).all()):
            raise AssertionError(f"{name} (M,K,N)=({M},{K},{N}): max abs "
                                 f"err {cs._err(got, want)}")
        worst = max(worst, cs._err(got, want))
    log(f"[probe-check] {name}: max abs err {worst:.3g} over INT4_SHAPES "
        f"x M (1, 8) and INT4_RAGGED x M (1, 3, 8), within "
        f"{cs.INT4_REL_TOL} x sum|x w s|")


def _med_max(vals):
    vals = sorted(vals)
    return f"{vals[len(vals) // 2]}/{vals[-1]}"


def _clock_ghz(rows):
    """SM clock: clock64 cycles over %globaltimer ns of the same block."""
    rates = sorted(r[11] / (r[5] - r[0]) for r in rows if r[5] > r[0])
    return rates[len(rates) // 2]


def _smi(label):
    log(f"[probe-clocks] {label}: " + subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,clocks.mem,"
         "power.draw,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip())


def _marks(flush, name):
    """One launch at each MARKED shape after the L2 flush, with each
    block's %globaltimer marks: the launch skew, each phase's median and
    max over blocks, the span, and how many blocks shared an SM."""
    lib = use(OUT, f"{name}+marks", SOURCE.name, QM)
    buf = (ctypes.c_ulonglong * (2048 * 12))()
    for M, K, N in MARKED:
        x, wp, s = cs._int4_cases(M, K, N)
        QM.int4_matmul(x, wp, s)
        torch.cuda.synchronize()
        lib.sea_marks_zero()
        flush.sum()
        QM.int4_matmul(x, wp, s)
        torch.cuda.synchronize()
        lib.sea_marks_read(buf)
        rows = [buf[12 * b:12 * b + 12] for b in range(2048)
                if buf[12 * b + 7] == 1]
        t0 = min(r[0] for r in rows)
        per_sm = collections.Counter(r[6] for r in rows)

        def us(vals):
            vals = sorted(vals)
            return f"{vals[len(vals) // 2] / 1e3:.2f}/{vals[-1] / 1e3:.2f}"

        phases = ", ".join(
            f"{name} {us([r[i + 1] - r[i] for r in rows])}"
            for i, name in enumerate(PHASES))
        log(f"[probe-marks] {name} (M,K,N)=({M},{K},{N}) "
            f"{QM.device_plan(K, N, 'cuda')}"
            f": {len(rows)} blocks on {len(per_sm)} SMs (at most "
            f"{max(per_sm.values())} a SM); start skew "
            f"{(max(r[0] for r in rows) - t0) / 1e3:.2f} us, span "
            f"{(max(r[5] for r in rows) - t0) / 1e3:.2f} us; us median/max "
            f"over blocks: {phases}; warp 0's k loop, cycles median/max: "
            + ", ".join(f"{name} {_med_max([r[i] for r in rows])}" for i, name
                        in ((8, "wait+barrier"), (9, "issue"),
                            (10, "k-steps"), (11, "whole block")))
            + f"; clock {_clock_ghz(rows):.3f} GHz")


def _streams(flush):
    """The copy-only stream at the two big shapes, 128 blocks where the
    tile width allows: GB/s of weight bytes against the time of one
    launch (CUDA events, L2 cold)."""
    d = OUT / "stream"
    d.mkdir(parents=True, exist_ok=True)
    (d / "stream.cu").write_text(_STREAM)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o",
                    str(d / "libstream.so"), str(d / "stream.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(d / "libstream.so"))
    lib.sea_stream.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p]
    sink = torch.zeros(16, dtype=torch.uint8, device="cuda")
    for K2, N in ((1024, 16384), (8192, 2048)):
        wp = torch.randint(0, 255, (K2, N), dtype=torch.uint8, device="cuda")
        res = []
        for W, S in STREAMS:
            tiles_n = N // W
            tiles_k = max(1, 128 // tiles_n)
            while (K2 // tiles_k) % (16384 // W):
                tiles_k //= 2

            def run():
                rc = lib.sea_stream(wp.data_ptr(), K2, N, W, S, tiles_k,
                                    sink.data_ptr(),
                                    torch.cuda.current_stream().cuda_stream)
                assert rc == 0, rc

            run()
            ms = cs._device_ms(run, flush)
            res.append(f"W={W} S={S} ({tiles_k * tiles_n} blocks): "
                       f"{ms:.4f} ms {K2 * N / ms / 1e6:.0f} GB/s")
        log(f"[probe-stream] [K2,N]=[{K2},{N}] uint8, copy only, L2 cold: "
            + "; ".join(res))


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_int4_probe.py: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    QM.device_plan(2, 1, "cuda:0")  # reads the SM count and cluster slots
    log(f"[probe-slots] clusters the card holds at once, (cols, size): "
        f"count: {dict(QM._DEVICE[torch.device('cuda:0')][1])}")
    base = SOURCE.read_text()
    texts = {name: edit(base, edits) for name, edits in VARIANTS.items()}
    for name in MARKED_VARIANTS:
        texts[f"{name}+marks"] = (edit(edit(base, VARIANTS[name]), _MARKS)
                                  + _MARK_ENTRIES)
    build_all(OUT, SOURCE.name, texts, "int4",
              "int4_matvec_mma<V, aligned>")
    _sass(OUT / "as_is" / "lib.so")
    for name in VARIANTS:
        if name not in TIMED_ONLY:
            use(OUT, name, SOURCE.name, QM)
            _check(name)
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    inputs = {(M, K, N): cs._int4_cases(M, K, N)
              for K, N in cs.INT4_SHAPES for M in (1, 8)}
    times = collections.defaultdict(list)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        use(OUT, name, SOURCE.name, QM)
        for key, (x, wp, s) in inputs.items():
            QM.int4_matmul(x, wp, s)  # warm-up
            times[key, name].append(cs._device_ms(
                lambda: QM.int4_matmul(x, wp, s), flush))
    step = collections.Counter()
    for (M, K, N), (x, wp, s) in inputs.items():
        Wb = (QM.unpack_int4(wp, torch.float32) * s).to(torch.bfloat16)
        xb = x.to(torch.bfloat16)
        lib = cs._device_ms(lambda: xb @ Wb, flush)
        n = cs.INT4_SHAPES[(K, N)]
        step[M, "cuBLAS"] += n * lib
        for name in VARIANTS:
            step[M, name] += n * sum(times[(M, K, N), name]) / 2
        log(f"[probe-time] (M,K,N)=({M},{K},{N}), L2 cold, ms (two runs "
            f"each): " + ", ".join(
                f"{name} {times[(M, K, N), name][0]:.4f} / "
                f"{times[(M, K, N), name][1]:.4f}" for name in VARIANTS)
            + f"; cuBLAS over the dequantized weight {lib:.4f}")
    for M in (1, 8):
        log(f"[probe-time] a rollout step at M={M}, us: " + ", ".join(
            f"{name} {1e3 * step[M, name]:.1f}"
            for name in list(VARIANTS) + ["cuBLAS"]))
    _smi("before the marks")
    _streams(flush)
    tiny = torch.zeros(8, device="cuda")
    log(f"[probe-floor] one 8-float fill kernel timed the same way, L2 "
        f"cold: {cs._device_ms(tiny.zero_, flush):.4f} / "
        f"{cs._device_ms(tiny.zero_, flush):.4f} ms")
    for name in MARKED_VARIANTS:
        _marks(flush, name)
    use(OUT, "as_is", SOURCE.name, QM)
    plan = QM.int4_plan
    try:
        for (M, K, N), grids in GRIDS.items():
            x, wp, s = cs._int4_cases(M, K, N)
            res = []
            for cols, cluster in [(None, None)] + grids:
                QM.device_plan.cache_clear()
                if cols is None:
                    QM.int4_plan = plan
                    p = QM.device_plan(K, N, "cuda")
                else:
                    steps = -(-(K // 2) // QM.STEP_ROWS)
                    per = -(-steps // cluster)
                    p = QM.Int4Plan(cols, -(-N // cols), -(-steps // per),
                                    per * QM.STEP_ROWS)
                    QM.int4_plan = lambda *a, _p=p: _p
                got = QM.int4_matmul(x, wp, s)
                err = cs._err(got, QM.int4_matvec_ref(x, wp, s))
                ms = cs._device_ms(lambda: QM.int4_matmul(x, wp, s), flush)
                res.append(f"{p.cols} cols x {p.tiles} tiles, cluster "
                           f"{p.cluster} ({p.blocks} blocks): {ms:.4f} "
                           f"(err {err:.2g})")
            log(f"[probe-grid] (M,K,N)=({M},{K},{N}), L2 cold, ms; plan "
                f"first: " + "; ".join(res))
    finally:
        QM.int4_plan = plan
        QM.device_plan.cache_clear()


if __name__ == "__main__":
    main()
