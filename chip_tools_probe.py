"""Where the time of the tools/ int4 kernels goes, on one NVIDIA GPU:
matvec_p4 and its sibling nibble forms (p4_mma), _unpack_only_call
(unpack_sums) and stream_bytes' scratch.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_tools_probe.py [PARENT]

PARENT: the root of an earlier checkout (``git archive`` of a commit,
unpacked under ``build/``).

It builds ``sea_tpu_torch/csrc/quant_bench.cu`` as it is and in variants
made by text edits of that source (an edit that no longer applies fails
the script), one nvcc (with ``-Xptxas -v``) each, started together. Every
variant that computes the result is held against the plain versions as
``chip_smoke.py``'s ``[tools-quant]`` holds them, at ``chip_smoke``'s
``TOOLS_SHAPES`` and ``TOOLS_WIDE`` ((B, K, N) = (1 | 8, 2048, 16384) and
(1 | 8, 2048, 65536), block_n 512). Each variant is then timed as
``[kernel-time]`` times a kernel (CUDA events, L2 cold), in turns:
variants, variants reversed, variants; ``dma_only`` beside them.
Variants:

- ``scalar_x``: p4_mma reads x in 2-byte loads at every shape (its form
  for K/2 not a multiple of 4), not one 8-byte load in each half a step;
- ``arrive_all``: every block of unpack_sums fences and arrives on the
  counter, not only the blocks whose results the output reads (still
  right);
- ``no_arrive``: no block arrives, so none writes the result (wrong:
  timed only) — the stream and the unpack alone;
- ``rows2`` / ``rows8``: unpack_sums' threads load 2 / 8 rows each, not
  4 (8 / 32 KB a block, 2048 / 512 blocks at the tools' shape);
- ``x8``: unpack_sums' blocks sum x in chunks of 2048 elements (8 a
  thread), not 512 (2 a thread), so at B = 8 the first 8 blocks hold all
  of x, not the first 32.

Then stream_bytes at (1, 2048, 16384) with its scratch at offsets from a
4 KB page boundary of one buffer (0 to 3 KB, 4 KB, 64 KB) and where the
wrapper put it, each checked and timed: its 147,456 64-bit atomics onto
512 adjacent words take a time that follows where those words lie. With
PARENT, PARENT's ``quant_bench.cu`` is built beside the variants and its
stream_bytes kernel is called through its own C entry on the same bytes,
the same output and the same scratch words as this checkout's, in turns
(this, parent, parent, this) at each of those offsets, each result
checked: the two kernels' times on one scratch, whatever the wrappers'
allocation order.

The variants are text edits of the source as it stands: when unpack_sums
or p4_load change, update ``VARIANTS`` with them (an edit that no longer
applies fails the script).

Output: the card, then one line per build, check and time.
"""

import ctypes
import sys
from pathlib import Path

import torch

import chip_smoke as cs
from chip_smoke import log
from chip_variants import build_all, edit
from sea_tpu_torch.ops import _build
from sea_tpu_torch.tools import bench_quant_matvec as PQ

REPO = Path(__file__).resolve().parent
OUT = REPO / "build" / "tools_probe"
SOURCE = "quant_bench.cu"
ARRIVES = "  const bool arrives = blockIdx.y == 0 || block < chunks;"
ARRIVALS = ("      const int arrivals = max(static_cast<int>(gridDim.x),\n"
            "                               min(chunks, blocks));")
UNPACK_ROWS = "constexpr int kUnpackRows = 4;"
PARENT = "parent"
VARIANTS = {
    "as_is": [],
    "scalar_x": [("const bool vec_x =\n      K2 % 4 == 0 && "
                  "reinterpret_cast<uintptr_t>(x) % 8 == 0;",
                  "const bool vec_x = false;")],
    "arrive_all": [(ARRIVES, "  const bool arrives = true;"),
                   (ARRIVALS, "      const int arrivals = blocks;")],
    "no_arrive": [(ARRIVES, "  const bool arrives = false;")],
    "rows2": [(UNPACK_ROWS, "constexpr int kUnpackRows = 2;")],
    "rows8": [(UNPACK_ROWS, "constexpr int kUnpackRows = 8;")],
    "x8": [("constexpr int kXPerThread = 2;",
            "constexpr int kXPerThread = 8;")],
}
WRONG = {"no_arrive"}
P4 = ("matvec_p4", "matvec_p4b", "matvec_p4c")
P4_VARIANTS = ("as_is", "scalar_x")
SCRATCH_OFFSETS = (0, 128, 256, 512, 1024, 2048, 3072, 4096, 65536)


def _load(name):
    """Point bench_quant_matvec at variant `name`'s library, with zeroed
    scratch."""
    lib = ctypes.CDLL(str(OUT / name / "lib.so"))
    _build._LIBS["quant_bench"] = lib
    PQ._library.cache_clear()
    PQ._library()
    for t in PQ._SCRATCH.values():
        t.zero_()


def _kernels(name, B):
    names = ["_unpack_only_call"]
    if name in P4_VARIANTS:
        names += P4
    if name == "as_is" and B == 1:
        names.append("dma_only")
    return names


def _variants(flush):
    for B, K, N in cs.TOOLS_SHAPES + cs.TOOLS_WIDE:
        cases = cs._tools_cases(B, K, N, cs.TOOLS_BLOCK_N)
        for name in VARIANTS:
            if name in WRONG:
                continue
            _load(name)
            for k in _kernels(name, B):
                err, _ = cs._tools_check(cases[k], f"[probe] {name} {k}",
                                         1e-6)
                log(f"[probe-check] {(B, K, N)} {name} {k}: max abs err "
                    f"{err:.3g}, as [tools-quant] holds it")
        times = {}
        names = list(VARIANTS)
        for order in (names, names[::-1], names):
            for name in order:
                _load(name)
                for k in _kernels(name, B):
                    times.setdefault((name, k), []).append(
                        cs._device_ms(cases[k][0], flush))
        for (name, k), ms in times.items():
            log(f"[probe-time] {(B, K, N)} block_n {cs.TOOLS_BLOCK_N} "
                f"{name} {k}: " + ", ".join(f"{m:.4f}" for m in ms)
                + " ms")
        del cases


def _scratch_offsets(flush):
    _load("as_is")
    B, K, N = cs.TOOLS_SHAPES[0]
    cases = cs._tools_cases(B, K, N, cs.TOOLS_BLOCK_N)
    case = cases["stream_bytes"]
    case[0]()
    key = (torch.cuda.current_device(), "stream_bytes",
           1 + cs.TOOLS_BLOCK_N)
    own = PQ._SCRATCH[key]
    big = torch.zeros((SCRATCH_OFFSETS[-1] + 8192) // 8, dtype=torch.int64,
                      device="cuda")
    times = {}
    for _ in range(2):
        for off in ("own", *SCRATCH_OFFSETS):
            PQ._SCRATCH[key] = (own if off == "own"
                                else big[off // 8:off // 8 + key[2]])
            cs._tools_check(case, f"[probe] scratch at {off}", 1e-6)
            times.setdefault(off, []).append(cs._device_ms(case[0], flush))
    PQ._SCRATCH[key] = own
    log(f"[probe-scratch] the wrapper's own scratch (\"own\") at "
        f"{own.data_ptr() % 4096} bytes into a 4 KB page")
    for off, ms in times.items():
        log(f"[probe-scratch] stream_bytes {(B, K, N)} with its scratch "
            f"{off} bytes past a 4 KB page boundary: "
            + ", ".join(f"{m:.4f}" for m in ms) + " ms")


def _stream_entries():
    """stream_bytes' C entry in this checkout's library and in the
    parent's, each as a function of (wp, out, scratch, rows_per_block):
    the parent's entry also took x, xn and ints (null for stream_bytes)."""
    vp, i = ctypes.c_void_p, ctypes.c_int
    mine = ctypes.CDLL(str(OUT / "as_is" / "lib.so")).sea_qb_stream
    mine.argtypes = [i, vp, vp, vp, i, i, i, i, vp]
    old = ctypes.CDLL(str(OUT / PARENT / "lib.so")).sea_qb_stream
    old.argtypes = [i, vp, vp, i, vp, vp, vp, i, i, i, i, vp]
    return {
        "this": lambda wp, out, scr, K2, N, rows, st: mine(
            0, wp, out, scr, K2, N, cs.TOOLS_BLOCK_N, rows, st),
        PARENT: lambda wp, out, scr, K2, N, rows, st: old(
            0, wp, None, 0, out, None, scr, K2, N, cs.TOOLS_BLOCK_N, rows,
            st)}


def _parent_witness(flush):
    """stream_bytes' kernel of this checkout and of PARENT on the same
    bytes, output and scratch words, in turns, at each scratch offset."""
    entries = _stream_entries()
    B, K, N = cs.TOOLS_SHAPES[0]
    K2, bn = K // 2, cs.TOOLS_BLOCK_N
    g = torch.Generator(device="cuda").manual_seed(K + N)
    wp = torch.randint(0, 256, (K2, N), dtype=torch.uint8, device="cuda",
                       generator=g)
    want = PQ.stream_bytes_ref(wp, block_n=bn).view(bn)
    out = torch.empty(bn, dtype=torch.float32, device="cuda")
    big = torch.zeros((SCRATCH_OFFSETS[-1] + 8192) // 8, dtype=torch.int64,
                      device="cuda")
    tiles = N // bn
    splits = min(K2, max(1, -(-2 * PQ._sm_count(0) // tiles)))
    rows = -(-K2 // splits)
    st = torch.cuda.current_stream().cuda_stream
    times = {}
    for off in SCRATCH_OFFSETS:
        scr = big[off // 8:off // 8 + 1 + bn].data_ptr()
        for name in ("this", PARENT, PARENT, "this"):
            call = entries[name]

            def run():
                rc = call(wp.data_ptr(), out.data_ptr(), scr, K2, N, rows,
                          st)
                if rc:
                    raise RuntimeError(f"{name} stream_bytes: CUDA error "
                                       f"{rc}")

            run()
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"[probe-parent] {name} stream_bytes "
                                     f"at offset {off}: wrong column sums")
            times.setdefault((off, name), []).append(
                cs._device_ms(run, flush))
    for (off, name), ms in times.items():
        log(f"[probe-parent] stream_bytes {(B, K, N)} block_n {bn}, the "
            f"same scratch {off} bytes past a 4 KB page boundary: {name} "
            + ", ".join(f"{m:.4f}" for m in ms) + " ms (bit for bit)")


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_tools_probe.py: no CUDA device")
    log(cs._smi())
    text = (_build.CSRC / SOURCE).read_text()
    texts = {name: edit(text, edits) for name, edits in VARIANTS.items()}
    parent = sys.argv[1] if len(sys.argv) > 1 else None
    if parent:
        texts[PARENT] = (Path(parent) / "sea_tpu_torch" / "csrc"
                         / SOURCE).read_text()
    build_all(OUT, SOURCE, texts, ("unpack_sums", "p4_mma",
                                   "reduce_kernel"),
              "ptxas (unpack_sums, p4_mma<kP4c|kP4b|kP4>, reduce_kernel)")
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    if parent:
        _parent_witness(flush)
    _variants(flush)
    _scratch_offsets(flush)


if __name__ == "__main__":
    main()
