"""Variants of the flash-decode kernel, timed on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_decode_probe.py [PARENT]

It builds ``sea_tpu_torch/csrc/decode_attention.cu`` as it is and in
variants made by text edits of that source (an edit that no longer applies
fails the script), one nvcc (with ``-Xptxas -v``) each, started together,
and holds every variant against the plain versions at ``SHAPES`` (t at 0,
either side of the first split edge and T-1, within ``chip_smoke``'s
``KERNEL_TOL`` / ``Q8_TOL``; two calls must give the same bits). Then each
variant is timed as ``chip_smoke.py``'s ``[kernel-time]`` times the kernel
(CUDA events, L2 cold, t = T-1), in the order variants, then variants
reversed, beside the bound and a one-element fill kernel timed the same
way (the floor of the method). Variants:

- ``cluster16``: clusters of up to 16 blocks (the non-portable size,
  ``cudaFuncAttributeNonPortableClusterSizeAllowed``; the plan's
  ``MAX_CLUSTER`` 16);
- ``warps_swapped``: 4 warps a block for f32 and bf16 caches and 8 for
  int8, instead of 8 and 4.

With PARENT, a checkout of an earlier commit (for instance unpacked with
``git archive`` under ``build/``), that checkout's kernel is timed the same
way in a process of its own, before and after the variants. Last, the
source as it is with ``%globaltimer`` marks in every block (``PHASES``),
one launch a shape after the flush; how many clusters of each plan the
card holds at once; and the source as it is under other grids than the
plan's (``GRIDS``).

Output: the card, then one line per build, plan, check and time.
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
from sea_tpu_torch.ops import decode_attention as DA

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "decode_probe"
SOURCE = REPO / "sea_tpu_torch" / "csrc" / "decode_attention.cu"
# (B, H, T, hd), cache dtype: the rollout's decodes (self-attention hd
# 256, exchange hd 128) at B=1 and B=8.
SHAPES = [((1, 8, 250, 256), torch.float32),
          ((1, 8, 250, 256), torch.bfloat16),
          ((1, 8, 250, 256), torch.int8),
          ((8, 8, 250, 256), torch.float32),
          ((8, 8, 250, 256), torch.int8),
          ((1, 8, 250, 128), torch.float32),
          ((8, 8, 250, 128), torch.float32)]
_CONFIGURE = """    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
"""
VARIANTS = {
    "as_is": [],
    "cluster16": [
        ("constexpr int kMaxCluster = 8;", "constexpr int kMaxCluster = 16;"),
        (_CONFIGURE, """    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(decode_cluster<Dt, HD>,
                               cudaFuncAttributeNonPortableClusterSizeAllowed,
                               1);
    if (err != cudaSuccess) return err;
    allowed[dev] = smem;
""")],
    "warps_swapped": [("kWarps = 8;", "kWarps = 0;"),
                      ("kWarps = 4;", "kWarps = 8;"),
                      ("kWarps = 0;", "kWarps = 4;")],
}
MAX_CLUSTER = {"cluster16": 16}
# %globaltimer marks per block, written by thread 0 of the source as it
# is: start; t read and the first two copies issued; the first stage's K
# landed (after the block barrier); the chunk's scores done; the tile
# maxima taken (and for bf16 and int8 exchanged over the cluster); p . V
# done; the cluster barrier of
# the merge passed; the end; then the SM the block ran on.
PHASES = ("t and issue", "K wait", "scores", "tile maxima", "p . V",
          "block sum, push and cluster wait", "rank sum")
_WRITE = ("  if (threadIdx.x == 0) {\n"
          "    const unsigned b = blockIdx.y * gridDim.x + blockIdx.x;\n"
          "    unsigned smid;\n"
          "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
          "    mk[7] = gtimer();\n"
          "    if (b < 4096) {\n"
          "      for (int i = 0; i < 8; ++i) g_marks[b][i] = mk[i];\n"
          "      g_marks[b][8] = smid;\n"
          "      g_marks[b][9] = 1;\n"
          "    }\n  }\n")
_MARKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_marks[4096][10];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    ("  cg::cluster_group cluster = cg::this_cluster();\n",
     "  unsigned long long mk[8] = {gtimer(), 0, 0, 0, 0, 0, 0, 0};\n"
     "  cg::cluster_group cluster = cg::this_cluster();\n"),
    ("  issue(0);\n  issue(1);\n",
     "  issue(0);\n  issue(1);\n  mk[1] = mk[2] = mk[3] = gtimer();\n"),
    ("    cp_async_wait<1>();\n    __syncthreads();\n    // Every lane",
     "    cp_async_wait<1>();\n    __syncthreads();\n"
     "    if (st == 0) mk[2] = gtimer();\n    // Every lane"),
    ("  // This block's row of tile maxima",
     "  mk[3] = gtimer();\n  // This block's row of tile maxima"),
    ("  // Pass 2: p = exp", "  mk[4] = gtimer();\n  // Pass 2: p = exp"),
    ("  __syncthreads();  // the ring is spent: the stream partials alias it\n",
     "  __syncthreads();  // the ring is spent: the stream partials alias it\n"
     "  mk[5] = gtimer();\n"),
    ("  cluster.sync();\n  // Warp 0 weighs",
     "  cluster.sync();\n  mk[6] = gtimer();\n  // Warp 0 weighs"),
    ("    out[static_cast<size_t>(bh) * HD + d0 + i] = a / denom;\n  }\n}\n",
     "    out[static_cast<size_t>(bh) * HD + d0 + i] = a / denom;\n  }\n"
     + _WRITE + "}\n"),
]
_MARK_ENTRIES = """
extern "C" int sea_marks_read(unsigned long long* host) {
  return cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks));
}
extern "C" int sea_marks_zero() {
  static const unsigned long long zero[4096 * 10] = {};
  return cudaMemcpyToSymbol(g_marks, zero, sizeof(zero));
}
"""


def inputs(shape, dtype):
    """(call of the wrapper, call of the plain version, cache bytes), with
    the cache and q from chip_smoke's seeded cases and the position in
    a one-element tensor ``t`` the caller may fill."""
    T = shape[2]
    t = torch.tensor([T - 1], dtype=torch.int32, device="cuda")
    if dtype == torch.int8:
        q, K, V, ks, vs = cs._q8_cases(shape)
        return (lambda: DA.decode_attention(q, K, V, t, k_scale=ks,
                                            v_scale=vs),
                lambda: DA.decode_attention_q8_ref(q, K, V, ks, vs, t),
                t, 2 * K.numel() + 2 * ks.numel() * 4)
    q, K, V = cs._cases(shape, dtype)
    return (lambda: DA.decode_attention(q, K, V, t),
            lambda: DA.decode_attention_ref(q, K, V, t), t,
            2 * K.numel() * K.element_size())


def time_shapes(label, runs=2):
    """Device ms of the wrapper at every SHAPES entry, t = T-1, `runs`
    times each; logs one line a shape."""
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    for shape, dtype in SHAPES:
        kernel, _, _, nbytes = inputs(shape, dtype)
        kernel()
        ms = [cs._device_ms(kernel, flush) for _ in range(runs)]
        log(f"[probe-time] {label} {shape} {str(dtype)[6:]}, L2 cold: "
            + " / ".join(f"{x:.4f}" for x in ms) + f" ms; bound "
            f"{1e3 * nbytes / cs.HBM_BYTES_PER_S:.4f} ms (cache bytes)")


_PARENT = """
import importlib.util, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("probe", sys.argv[2])
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
probe.time_shapes("parent", runs=1)
"""


def time_parent(parent):
    """time_shapes run in a process whose chip_smoke and sea_tpu_torch are
    the parent checkout's."""
    proc = subprocess.run([sys.executable, "-c", _PARENT, str(parent),
                           str(Path(__file__).resolve())], cwd=parent,
                          capture_output=True, text=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if line.startswith("[probe-time]") or proc.returncode:
            log(line)
    if proc.returncode:
        raise RuntimeError(f"parent timing failed (exit {proc.returncode})")


def check(name):
    """The variant against the plain versions at every SHAPES entry; two
    calls give the same bits. Logs each shape's plan."""
    dev = torch.device("cuda", 0)
    for shape, dtype in SHAPES:
        B, H, T, hd = shape
        plan = DA.device_plan(T, B * H, hd, dtype, dev)
        kernel, plain, t, _ = inputs(shape, dtype)
        tol = cs.Q8_TOL if dtype == torch.int8 else cs.KERNEL_TOL[dtype]
        worst = 0.0
        for pos in sorted({0, plan.chunk - 1, plan.chunk, T - 1}):
            t.fill_(pos)
            got = kernel()
            worst = max(worst, cs._err(got, plain()))
            if not torch.equal(got, kernel()):
                raise AssertionError(f"{name} {shape} {dtype} t={pos}: two "
                                     "calls differ")
        t.fill_(T - 1)
        if not worst <= tol:
            raise AssertionError(f"{name} {shape} {dtype}: max abs err "
                                 f"{worst} > {tol}")
        log(f"[probe-check] {name} {shape} {str(dtype)[6:]} {plan}: max abs "
            f"err {worst:.3g} <= {tol}; the same bits twice")


def marks(flush):
    """One launch at each SHAPES entry after the L2 flush, t = T-1, with
    each block's %globaltimer marks: the launch skew, each phase's median
    and max over blocks, the span, and how many blocks shared an SM."""
    lib = use(OUT, "as_is+marks", SOURCE.name, DA)
    DA.MAX_CLUSTER = 8
    DA.device_plan.cache_clear()
    buf = (ctypes.c_ulonglong * (4096 * 10))()
    for shape, dtype in SHAPES:
        kernel, _, _, _ = inputs(shape, dtype)
        kernel()
        torch.cuda.synchronize()
        lib.sea_marks_zero()
        flush.sum()
        kernel()
        torch.cuda.synchronize()
        lib.sea_marks_read(buf)
        rows = [buf[10 * b:10 * b + 10] for b in range(4096)
                if buf[10 * b + 9] == 1]
        t0 = min(r[0] for r in rows)
        per_sm = collections.Counter(r[8] for r in rows)

        def us(vals):
            vals = sorted(vals)
            return f"{vals[len(vals) // 2] / 1e3:.2f}/{vals[-1] / 1e3:.2f}"

        phases = ", ".join(f"{name} {us([r[i + 1] - r[i] for r in rows])}"
                           for i, name in enumerate(PHASES))
        log(f"[probe-marks] {shape} {str(dtype)[6:]}: {len(rows)} blocks on "
            f"{len(per_sm)} SMs (at most {max(per_sm.values())} a SM); "
            f"start skew {(max(r[0] for r in rows) - t0) / 1e3:.2f} us, span "
            f"{(max(r[7] for r in rows) - t0) / 1e3:.2f} us; us median/max "
            f"over blocks: {phases}")


def clusters_at_once():
    """How many clusters of each SHAPES entry's plan the card holds at
    once (cudaOccupancyMaxActiveClusters), against the clusters a call
    launches."""
    query = DA._library()[2]
    for shape, dtype in SHAPES:
        B, H, T, hd = shape
        plan = DA.device_plan(T, B * H, hd, dtype, torch.device("cuda", 0))
        log(f"[probe-slots] {shape} {str(dtype)[6:]} {plan}: "
            f"{query(DA._KIND[dtype], hd, T, *plan)} clusters at once, "
            f"{B * H} a call")


# Other grids than the plan's, for the source as it is: splits a cluster
# (the ring per RING_BYTES).
GRIDS = {((8, 8, 250, 256), torch.float32): (2, 4, 8),
         ((8, 8, 250, 256), torch.int8): (2, 4, 8),
         ((1, 8, 250, 256), torch.float32): (2, 4)}


def grids(flush):
    """The source as it is under the GRIDS splits, beside the plan's."""
    use_variant("as_is")
    plan_fn = DA.device_plan
    try:
        for (shape, dtype), choices in GRIDS.items():
            B, H, T, hd = shape
            kernel, plain, _, _ = inputs(shape, dtype)
            res = []
            for splits in (None,) + choices:
                if splits is None:
                    DA.device_plan = plan_fn
                    p = plan_fn(T, B * H, hd, dtype, torch.device("cuda", 0))
                else:
                    chunk = -(-T // splits)
                    row = DA.key_bytes(hd, dtype)
                    p = (DA.DecodePlan(splits, chunk, chunk, 1)
                         if chunk * row <= DA.RING_BYTES else
                         DA.DecodePlan(splits, chunk,
                                       DA.RING_BYTES // (2 * row), 2))
                    DA.device_plan = lambda *a, _p=p: _p
                err = cs._err(kernel(), plain())
                kernel()
                ms = cs._device_ms(kernel, flush)
                res.append(f"{p}: {ms:.4f} (err {err:.2g})")
            log(f"[probe-grid] {shape} {str(dtype)[6:]}, L2 cold, ms; plan "
                f"first: " + "; ".join(res))
    finally:
        DA.device_plan = plan_fn


def use_variant(name):
    use(OUT, name, SOURCE.name, DA)
    DA.MAX_CLUSTER = MAX_CLUSTER.get(name, 8)
    DA.device_plan.cache_clear()


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("chip_decode_probe.py: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    parent = Path(argv[0]).resolve() if argv else None
    base = SOURCE.read_text()
    texts = {name: edit(base, edits) for name, edits in VARIANTS.items()}
    texts["as_is+marks"] = edit(base, _MARKS) + _MARK_ENTRIES
    build_all(OUT, SOURCE.name, texts, "decode_cluster",
              "decode_cluster<Dt, HD>")
    for name in VARIANTS:
        use_variant(name)
        check(name)
        if name == "as_is":
            clusters_at_once()
    if parent:
        time_parent(parent)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        use_variant(name)
        time_shapes(name, runs=1)
    if parent:
        time_parent(parent)
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    tiny = torch.zeros(8, device="cuda")
    log(f"[probe-floor] one 8-float fill kernel timed the same way, L2 "
        f"cold: {cs._device_ms(tiny.zero_, flush):.4f} / "
        f"{cs._device_ms(tiny.zero_, flush):.4f} ms")
    grids(flush)
    marks(flush)


if __name__ == "__main__":
    main(sys.argv[1:])
