"""The fused AdaLN kernels alone, timed on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_adaln_probe.py [--check] [PARENT]

It builds ``sea_tpu_torch/csrc/fused_adaln.cu`` as it is, in the variants
of ``VARIANTS`` and with ``%globaltimer`` marks (text edits of that
source; an edit that no longer applies fails the script), one nvcc (with
``-Xptxas -v``: registers and spills of every kernel) each, started
together, and holds each variant against the plain versions at ``SHAPES``
(the forward within ``chip_smoke``'s ``ADALN_TOL["out"]``, the backward's
five outputs within ``ADALN_TOL["grad"]``; two calls must give the same
bits), logging each shape's plan and how many blocks (clusters) the card
holds at once. With ``--check`` it stops there.

Then the forward, the backward call (``adaln_bwd``, what
``[kernel-time]`` times) and the whole backward (for a parent whose
backward kernel leaves dw and db to its autograd backward, with those two
sums) are timed as ``chip_smoke.py``'s ``[kernel-time]`` times them (CUDA
events, L2 cold), and again with L2 as the previous call left it: the
variants in turn and back, and with PARENT, a checkout of an earlier
commit (for instance unpacked with ``git archive`` under ``build/``),
before and after them in a process whose ``chip_smoke`` and
``sea_tpu_torch`` are that checkout's. Last, a one-element fill kernel
timed the same way (the floor of the method), both kernels under other
grids than the plan's (``GRIDS``), and one launch of each kernel a shape
of the marked source after the flush: each block's marks by phase
(``PHASES``), the launch skew and the span.

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
from sea_tpu_torch.ops import fused_adaln as FAL

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "adaln_probe"
SOURCE = REPO / "sea_tpu_torch" / "csrc" / "fused_adaln.cu"
# (B, T, E): the train step's AdaLN sites, then eight trajectories.
SHAPES = [(2, 399, 1024), (2, 399, 512), (8, 399, 1024)]
# Grids other than the plan's at (2, 399, 1024): (elements a thread, warps
# a row, blocks a trajectory, blocks a cluster).
GRIDS = {"forward": [(32, 1, 132, 1), (16, 2, 66, 1), (16, 2, 132, 1),
                     (8, 4, 132, 1), (8, 4, 200, 1)],
         "backward": [(32, 1, 32, 8), (32, 1, 56, 4), (16, 2, 56, 8),
                      (16, 2, 112, 8), (8, 4, 56, 8)]}
# %globaltimer marks by thread 0 of every block: start; a (and c) in
# shared memory; the first row's data landed (its first sum done); the
# rows done; then, in the backward, the block's sums pushed (or written);
# the cluster's sums written to the scratch; past the slice's counter; the
# finish written. Then the SM the block ran on. A backward block that is
# not the last of its count leaves after the counter.
PHASES = {"backward": ("params", "first row", "rows", "block sums + push",
                       "cluster barrier + rank sums", "counter", "finish"),
          "forward": ("params", "first row", "rows")}
_WRITE = ("    if (threadIdx.x == 0) {{\n"
          "      const unsigned k = blockIdx.y * gridDim.x + blockIdx.x;\n"
          "      unsigned smid;\n"
          "      asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
          "      if (k < 4096) {{\n"
          "        for (int i = 0; i < 8; ++i) {arr}[k][i] = mk[i];\n"
          "        {arr}[k][8] = smid;\n"
          "        {arr}[k][9] = 1;\n"
          "      }}\n    }}\n")
_BWRITE = _WRITE.format(arr="g_marks")
_FWRITE = _WRITE.format(arr="g_fmarks")
_MK = "  unsigned long long mk[8] = {gtimer(), 0, 0, 0, 0, 0, 0, 0};\n"
_MARKS = [
    ("namespace cg = cooperative_groups;\n",
     "namespace cg = cooperative_groups;\n"
     "__device__ unsigned long long g_marks[4096][10];\n"
     "__device__ unsigned long long g_fmarks[4096][10];\n"
     "__device__ __forceinline__ unsigned long long gtimer() {\n"
     "  unsigned long long t;\n"
     "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
     "  return t;\n}\n"),
    # backward
    ("  cg::cluster_group cluster = cg::this_cluster();\n  const int cs =",
     _MK + "  cg::cluster_group cluster = cg::this_cluster();\n"
     "  const int cs ="),
    ("      store_sm<VEC>(acc_b + c, z);\n    }\n  }\n  __syncthreads();\n",
     "      store_sm<VEC>(acc_b + c, z);\n    }\n  }\n  __syncthreads();\n"
     "  mk[1] = gtimer();\n"),
    ("    row_sum(s, red, slot, group, wig, wpr, lane);\n",
     "    row_sum(s, red, slot, group, wig, wpr, lane);\n"
     "    if (!mk[2]) mk[2] = gtimer();\n"),
    ("  __syncthreads();\n\n  // The block's column sums",
     "  __syncthreads();\n  mk[3] = gtimer();\n\n  // The block's column sums"),
    ("  if (cs > 1) {\n    cluster.sync();\n",
     "  mk[4] = gtimer();\n  if (cs > 1) {\n    cluster.sync();\n"),
    ("  // Per column slice [c0, c0 + n), the last",
     "  mk[5] = gtimer();\n  // Per column slice [c0, c0 + n), the last"),
    ("  if (!last) return;\n  const int total",
     "  mk[6] = gtimer();\n  if (!last) {\n" + _BWRITE + "    return;\n  }\n"
     "  const int total"),
    ("    a.db[c0 + i] = tb;\n  }\n}\n",
     "    a.db[c0 + i] = tb;\n  }\n  mk[7] = gtimer();\n  {\n" + _BWRITE
     + "  }\n}\n"),
    # forward
    ("  S xs;\n  const int E = a.E", _MK + "  S xs;\n  const int E = a.E"),
    ("    pc.store(c_sm, a.b, a.cb, boff, E, a.p_kind);\n  }\n"
     "  __syncthreads();\n",
     "    pc.store(c_sm, a.b, a.cb, boff, E, a.p_kind);\n  }\n"
     "  __syncthreads();\n  mk[1] = gtimer();\n"),
    ("        store_row<Xt, VEC>(orow + c, o);\n      }\n    }\n  }\n}\n",
     "        store_row<Xt, VEC>(orow + c, o);\n      }\n    }\n  }\n"
     "  mk[3] = gtimer();\n  {\n" + _FWRITE + "  }\n}\n"),
]
# params_first: the parameters asked for before the first rows.
VARIANTS = {
    "as_is": [],
    "params_first": [
        ("    if (kPrefetch && r < r1)\n"
         "      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);\n"
         "    ParamSum<VEC> pa, pc;\n"
         "    pa.load(a.w, a.cw, boff, E, a.p_kind);\n"
         "    pc.load(a.b, a.cb, boff, E, a.p_kind);\n",
         "    ParamSum<VEC> pa, pc;\n"
         "    pa.load(a.w, a.cw, boff, E, a.p_kind);\n"
         "    pc.load(a.b, a.cb, boff, E, a.p_kind);\n"
         "    if (kPrefetch && r < r1)\n"
         "      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);\n"),
        ("    if (kPrefetch && r < r1) {\n"
         "      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);\n"
         "      gs.load(g + static_cast<size_t>(r) * E, j, tpr, E);\n"
         "    }\n"
         "    const size_t boff = static_cast<size_t>(b) * E;\n"
         "    ParamSum<VEC> pa;\n"
         "    pa.load(a.w, a.cw, boff, E, a.p_kind);\n",
         "    const size_t boff = static_cast<size_t>(b) * E;\n"
         "    ParamSum<VEC> pa;\n"
         "    pa.load(a.w, a.cw, boff, E, a.p_kind);\n"
         "    if (kPrefetch && r < r1) {\n"
         "      xs.load(x + static_cast<size_t>(r) * E, j, tpr, E);\n"
         "      gs.load(g + static_cast<size_t>(r) * E, j, tpr, E);\n"
         "    }\n")],
}
_MARK_ENTRIES = """
extern "C" int sea_marks_read(int forward, unsigned long long* host) {
  return forward ? cudaMemcpyFromSymbol(host, g_fmarks, sizeof(g_fmarks))
                 : cudaMemcpyFromSymbol(host, g_marks, sizeof(g_marks));
}
extern "C" int sea_marks_zero() {
  static const unsigned long long zero[4096 * 10] = {};
  cudaError_t err = cudaMemcpyToSymbol(g_marks, zero, sizeof(zero));
  if (err != cudaSuccess) return err;
  return cudaMemcpyToSymbol(g_fmarks, zero, sizeof(zero));
}
"""


def calls(shape):
    """(forward, backward call, whole backward) of the wrappers on
    chip_smoke's seeded inputs: the backward call is what `[kernel-time]`
    times; the whole backward of a parent whose ``adaln_bwd`` returns (dx,
    dgw, dgb) adds the sums over trajectories its autograd backward
    runs."""
    x, cw, cb, w, b, gy = cs._adaln_inputs(shape)

    def whole():
        out = FAL.adaln_bwd(x, cw, gy, w)
        if len(out) == 3:
            out[1].sum((0, 1))
            out[2].sum((0, 1))

    return (lambda: FAL.adaln_fwd(x, cw, cb, w, b),
            lambda: FAL.adaln_bwd(x, cw, gy, w), whole)


class _Busy:
    """In _device_ms's place of the L2 flush: keeps the card busy (~0.1
    ms of spinning) while the host enqueues the call, and leaves L2 as the
    last call left it."""

    @staticmethod
    def sum():
        torch.cuda._sleep(200_000)


def time_shapes(label):
    """Device ms of the forward, the backward call and the whole backward
    at every SHAPES entry (after a warm-up), L2 cold and warm; one line a
    shape."""
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    for shape in SHAPES:
        fns = calls(shape)
        for fn in fns:
            fn()
        torch.cuda.synchronize()
        cold = [cs._device_ms(fn, flush) for fn in fns]
        warm = [cs._device_ms(fn, _Busy) for fn in fns]
        log(f"[probe-time] {label} {shape}, ms L2 cold / warm: forward "
            f"{cold[0]:.4f} / {warm[0]:.4f}, backward call {cold[1]:.4f} / "
            f"{warm[1]:.4f}, whole backward {cold[2]:.4f} / {warm[2]:.4f}")


_PARENT = """
import importlib.util, sys
sys.path.insert(0, sys.argv[1])
spec = importlib.util.spec_from_file_location("probe", sys.argv[2])
probe = importlib.util.module_from_spec(spec)
spec.loader.exec_module(probe)
probe.time_shapes("parent")
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
    """The variant against the plain versions at every SHAPES entry, the
    same bits twice; each shape's plans and the card's slots."""
    dev = torch.device("cuda", 0)
    query = FAL._library()[2]
    for shape in SHAPES:
        B, T, E = shape
        x, cw, cb, w, b, gy = cs._adaln_inputs(shape)
        got = [FAL.adaln_fwd(x, cw, cb, w, b), *FAL.adaln_bwd(x, cw, gy, w)]
        again = [FAL.adaln_fwd(x, cw, cb, w, b),
                 *FAL.adaln_bwd(x, cw, gy, w)]
        want = [FAL.adaln_modulate_ref(x, cw, cb, w, b),
                *FAL.adaln_bwd_ref(x, cw, gy, w)]
        torch.cuda.synchronize()
        errs = [cs._err(a, r) for a, r in zip(got, want)]
        for i, (a, r) in enumerate(zip(got, want)):
            tol = cs.ADALN_TOL["out" if i == 0 else "grad"]
            if not cs._within(a, r, tol):
                raise AssertionError(f"adaln {shape} output {i}: max abs err "
                                     f"{errs[i]} outside {tol}")
        if not all(torch.equal(a, r) for a, r in zip(got, again)):
            raise AssertionError(f"adaln {shape}: two calls differ")
        plans = [FAL.device_plan(bw, B, T, E, torch.float32, True, dev)
                 for bw in (False, True)]
        slots = [query(0, 0, p.vec, p.n, E, p.wpr, 1) for p in plans[:1]]
        slots += [query(1, 0, plans[1].vec, plans[1].n, E, plans[1].wpr,
                        plans[1].cs)]
        log(f"[probe-check] {name} {shape}: max abs err out, dx, dcw, dcb, dw, db "
            f"{['%.3g' % e for e in errs]}; the same bits twice; forward "
            f"{plans[0]} ({slots[0]} blocks an SM), backward {plans[1]} "
            f"({slots[1]} {'clusters' if plans[1].cs > 1 else 'blocks an SM'}"
            f" at once)")


def grids(flush):
    """Each kernel at (2, 399, 1024) under the GRIDS grids, beside the
    plan's: device ms and the max abs error against the plain version."""
    shape = SHAPES[0]
    B, T, E = shape
    x, cw, cb, w, b, gy = cs._adaln_inputs(shape)
    plan_fn = FAL.device_plan
    dev = torch.device("cuda", 0)
    runs = {"forward": (lambda: [FAL.adaln_fwd(x, cw, cb, w, b)],
                        [FAL.adaln_modulate_ref(x, cw, cb, w, b)]),
            "backward": (lambda: FAL.adaln_bwd(x, cw, gy, w),
                         FAL.adaln_bwd_ref(x, cw, gy, w))}
    try:
        for name, (fn, want) in runs.items():
            base = plan_fn(name == "backward", B, T, E, torch.float32, True,
                           dev)
            res = []
            for n, wpr, nb, cl in [base[1:]] + GRIDS[name]:
                p = base._replace(n=n, wpr=wpr, nb=nb, cs=cl)
                FAL.device_plan = lambda *a, _p=p: _p
                err = max(cs._err(u, v) for u, v in zip(fn(), want))
                ms = cs._device_ms(fn, flush)
                res.append(f"(n {n}, wpr {wpr}, nb {nb}, cs {cl}): {ms:.4f} "
                           f"(err {err:.2g})")
            log(f"[probe-grid] {name} {shape}, L2 cold, ms; plan first: "
                + "; ".join(res))
    finally:
        FAL.device_plan = plan_fn


def marks(flush):
    """One launch of each kernel at each SHAPES entry after the L2 flush,
    with each block's %globaltimer marks: the launch skew, each phase's
    median and max over the blocks that reached it, the span, and the
    blocks a SM."""
    lib = use(OUT, "as_is+marks", SOURCE.name, FAL)
    FAL.device_plan.cache_clear()
    buf = (ctypes.c_ulonglong * (4096 * 10))()
    for shape in SHAPES:
        fwd, bwd, _ = calls(shape)
        for name, fn in (("forward", fwd), ("backward", bwd)):
            fn()
            torch.cuda.synchronize()
            lib.sea_marks_zero()
            flush.sum()
            fn()
            torch.cuda.synchronize()
            lib.sea_marks_read(int(name == "forward"), buf)
            rows = [buf[10 * k:10 * k + 10] for k in range(4096)
                    if buf[10 * k + 9] == 1]
            if name == "forward":  # marks 0-3
                rows = [r[:4] + [0] * 4 + r[8:] for r in rows]
            t0 = min(r[0] for r in rows)
            per_sm = collections.Counter(r[8] for r in rows)

            def us(vals):
                vals = sorted(vals)
                if not vals:
                    return "-"
                return (f"{vals[len(vals) // 2] / 1e3:.2f}/"
                        f"{vals[-1] / 1e3:.2f}")

            phases = ", ".join(
                f"{ph} {us([r[i + 1] - r[i] for r in rows if r[i + 1]])}"
                for i, ph in enumerate(PHASES[name]))
            end = max(max(v for v in r[:8] if v) for r in rows)
            log(f"[probe-marks] {name} {shape}: {len(rows)} blocks on "
                f"{len(per_sm)} SMs (at most {max(per_sm.values())} a SM); "
                f"start skew {(max(r[0] for r in rows) - t0) / 1e3:.2f} us, "
                f"span {(end - t0) / 1e3:.2f} us; us median/max over "
                f"blocks: {phases}")


def use_variant(name):
    use(OUT, name, SOURCE.name, FAL)
    FAL.device_plan.cache_clear()


def main(argv):
    if not torch.cuda.is_available():
        sys.exit("chip_adaln_probe.py: no CUDA device")
    log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True).stdout.strip())
    only_check = "--check" in argv
    argv = [a for a in argv if a != "--check"]
    parent = Path(argv[0]).resolve() if argv else None
    base = SOURCE.read_text()
    texts = {name: edit(base, edits) for name, edits in VARIANTS.items()}
    texts["as_is+marks"] = edit(base, _MARKS) + _MARK_ENTRIES
    build_all(OUT, SOURCE.name, texts, "adaln_",
              "adaln_{fwd,bwd}_kernel<X, VEC, N>")
    for name in VARIANTS:
        use_variant(name)
        check(name)
    if only_check:
        return
    if parent:
        time_parent(parent)
    for name in list(VARIANTS) + list(VARIANTS)[::-1]:
        use_variant(name)
        time_shapes(name)
    if parent:
        time_parent(parent)
    use_variant("as_is")
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    tiny = torch.zeros(8, device="cuda")
    log(f"[probe-floor] one 8-float fill kernel timed the same way, L2 "
        f"cold: {cs._device_ms(tiny.zero_, flush):.4f} / "
        f"{cs._device_ms(tiny.zero_, flush):.4f} ms")
    grids(flush)
    marks(flush)


if __name__ == "__main__":
    main(sys.argv[1:])
