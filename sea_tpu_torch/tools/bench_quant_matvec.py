"""Microbench: the int4 serving matvec taken apart, on one NVIDIA GPU.

Counterpart of the JAX package's ``tools/bench_quant_matvec.py``. At the
multiphase MLP shape [2048 -> 16384] it times, in a dependent loop:

  noop_loop     the loop's own step (x * 1.0001)
  torch_int4    dequantise the packed nibbles in each step, then
                torch.matmul in bf16 (the library comparison; the JAX
                bench's xla_int4)
  torch_int8    the same with int8 weights (the JAX bench's xla_int8)
  matvec_p4     packed nibbles unpacked with 32-bit integer ops
  matvec_p4b    unpacked by byte-width sign extension
  matvec_p4c    unpacked by the bias form (lo + 8, 16 hi) with a rank-1
                correction
  matvec_s8     int8 weights, no unpack
  stream_bytes  column sums of the packed bytes: the byte stream alone
  dma_only      every byte copied into shared memory, nothing computed

Each of the six functions is a wrapper: a CPU tensor runs its plain
PyTorch version (``<name>_ref``, beside it); a CUDA tensor launches its
hand-written kernel (``sea_tpu_torch/csrc/quant_bench.cu``) or raises.
Each keeps the JAX function's signature, ``block_n`` included: it sets
what stream_bytes and dma_only return (their [1, block_n] result) and is
checked by every function (N must be a multiple of it: the TPU grid of
N // block_n tiles leaves the rest unwritten, the port raises).

Timing: R steps of ``timed_loop``, whose carry y feeds the next step's x,
captured in one CUDA graph and replayed between CUDA events (the jitted
``lax.scan`` of the JAX bench), minus R/2 steps, over R - R/2; best of 3.
The card's 50 MB L2 cache holds a whole int4 (16.8 MB) or int8 (33.6 MB)
weight, so the loop turns through copies of the weights, at least twice
the L2 in all, and each step reads its weight from device memory. Each
row gives its GB/s of weight bytes and their share of the H100's 3.35
TB/s; a reading above 1.05 x that rate fails the run (the loop then timed
a cache). The step's time includes the loop's own feedback ops
(``noop_loop``). ``--device cpu`` runs the plain versions under the host
clock.

    python -m sea_tpu_torch.tools.bench_quant_matvec [--K 2048] [--N 16384]
        [--B 1] [--repeats 100] [--block_n 512] [--device cuda]

It checks correctness first, then prints one line a row and, last, one
JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import json
import math
import time

import torch

# Launches of each kernel through its wrapper (a CPU call does not count,
# nor does a call captured into a CUDA graph: that records the kernel, and
# the graph's replays launch it). Read and reset by chip_smoke.py.
launches = {name: 0 for name in ("matvec_p4", "matvec_p4b", "matvec_p4c",
                                 "matvec_s8", "stream_bytes", "dma_only")}

# The kernels' forms (csrc/quant_bench.cu: Form, Stream).
MATVEC_FORMS = {"matvec_p4": 0, "matvec_p4b": 1, "matvec_p4c": 2,
                "matvec_s8": 3, "_mvt_call": 4}
STREAM_FORMS = {"stream_bytes": 0, "dma_only": 2}
# x rows the matvec kernels take; the widest column tile of the stream
# kernels.
MAX_ROWS = 8
MAX_BLOCK_N = 4096
# NVIDIA H100 SXM: HBM rate; a reading past MAX_READING times it timed a
# cache, not the memory.
HBM_BYTES_PER_S = 3.35e12
MAX_READING = 1.05


def pack_nibbles(q):
    """q: int8 [K, N] in [-8, 7] -> uint8 [K//2, N]; low nibble = rows
    [:K/2], high nibble = rows [K/2:]. Equals ops/quant_matmul.pack_int4."""
    K = q.shape[0]
    lo = (q[: K // 2] & 0xF).to(torch.uint8)
    hi = (q[K // 2:] & 0xF).to(torch.uint8)
    return lo | (hi << 4)


def quantize_int4(w):
    """The JAX bench's int4 quantiser: a scale per column, max|w| / 7, and
    q = clip(round(w / s), -7, 7). Returns (q int8 [K, N], s f32 [1, N])."""
    s = w.abs().amax(dim=0, keepdim=True) / 7.0
    return torch.clamp(torch.round(w / s), -7, 7).to(torch.int8), s


def quantize_int8(w):
    """The JAX bench's int8 quantiser: max|w| / 127, clip to +-127."""
    s = w.abs().amax(dim=0, keepdim=True) / 127.0
    return torch.clamp(torch.round(w / s), -127, 127).to(torch.int8), s


def check_tiles(N: int, block_n: int) -> int:
    """N // block_n, the TPU grid's tiles; raises where they leave columns
    out (the TPU grid would leave them unwritten)."""
    if block_n < 1 or N % block_n:
        raise ValueError(f"N={N} is not a multiple of block_n={block_n}: "
                         f"the TPU grid of N // block_n tiles leaves the "
                         f"last {N % max(block_n, 1)} columns unwritten")
    return N // block_n


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _two_dots(x, lo, hi):
    """x[:, :K/2] @ lo + x[:, K/2:] @ hi in f32."""
    K2 = lo.shape[0]
    xf = x.float()
    return xf[:, :K2] @ lo.float() + xf[:, K2:] @ hi.float()


def matvec_p4_ref(x, wp, s, *, block_n: int):
    """Plain matvec_p4: 32-bit unpack, ((w & 0xF) ^ 8) - 8 and
    ((w >> 4) ^ 8) - 8, two dots, then the scale."""
    check_tiles(wp.shape[1], block_n)
    w = wp.to(torch.int32)
    return _two_dots(x, ((w & 0xF) ^ 8) - 8, ((w >> 4) ^ 8) - 8) * s.float()


def matvec_p4b_ref(x, wp, s, *, block_n: int):
    """Plain matvec_p4b: byte-width shifts, (w8 << 4) >> 4 and w8 >> 4."""
    check_tiles(wp.shape[1], block_n)
    w8 = wp.view(torch.int8)
    return _two_dots(x, (w8 << 4) >> 4, w8 >> 4) * s.float()


def matvec_p4c_ref(x, wp, s, *, block_n: int):
    """Plain matvec_p4c: x's high half divided by 16 (exact in bf16), then
    (x_lo @ (lo + 8) + x_hi/16 @ 16 hi - 8 sum(x_lo)) * s."""
    check_tiles(wp.shape[1], block_n)
    K2 = wp.shape[0]
    xs = torch.cat([x[:, :K2], x[:, K2:] * (1.0 / 16.0)], dim=1)
    w8 = wp.view(torch.int8)
    acc = _two_dots(xs, (w8 & 0xF) ^ 8, w8 & -16)
    corr = 8.0 * xs[:, :K2].float().sum(dim=1, keepdim=True)
    return (acc - corr) * s.float()


def matvec_s8_ref(x, w8, s, *, block_n: int):
    """Plain matvec_s8: (x @ w8) * s in f32."""
    check_tiles(w8.shape[1], block_n)
    return (x.float() @ w8.float()) * s.float()


def stream_bytes_ref(wp, *, block_n: int):
    """Plain stream_bytes: o[0, c] = sum over tiles j and rows k of
    wp[k, j block_n + c], an exact integer sum, as f32 [1, block_n]. The
    TPU kernel folds the tiles in f32; the two agree while the sums stay
    below 2^24 (K/2 * 255 * N / block_n < 2^24: 8.4M at the tools'
    shape)."""
    K2, N = wp.shape
    tiles = check_tiles(N, block_n)
    return (wp.reshape(K2, tiles, block_n).to(torch.int64).sum(dim=(0, 1))
            .float().reshape(1, block_n))


def dma_only_ref(wp, *, block_n: int):
    """Plain dma_only: row 0 of the last column tile, f32 [1, block_n] (the
    TPU grid runs in order, so the last step's write stands)."""
    N = wp.shape[1]
    check_tiles(N, block_n)
    return wp[0:1, N - block_n:].float()


# ---------------------------------------------------------------------------
# The kernels
# ---------------------------------------------------------------------------

@functools.cache
def _library():
    """The C entries, built at first use; pointers and the stream are
    c_void_p (ctypes would otherwise pass a Python int as 32 bits)."""
    from sea_tpu_torch.ops._build import load_library
    lib = load_library("quant_bench")
    lib.sea_qb_matvec.restype = ctypes.c_int
    lib.sea_qb_matvec.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sea_qb_stream.restype = ctypes.c_int
    lib.sea_qb_stream.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                  + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.sea_qb_unpack.restype = ctypes.c_int
    lib.sea_qb_unpack.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int]
                                  + [ctypes.c_void_p] * 3
                                  + [ctypes.c_longlong]
                                  + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.sea_qb_unpack_scratch_words.restype = ctypes.c_longlong
    lib.sea_qb_unpack_scratch_words.argtypes = [ctypes.c_int] * 4
    return lib


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


# Per (device, kernel, words): a stream kernel's 64-bit scratch (an
# arrival counter and its sums), left as that kernel needs it by its last
# block: stream_bytes adds into words that must be zero, _unpack_only_call
# overwrites the words it reads, so the two never share one. Calls that
# share one must not overlap (one stream).
_SCRATCH: dict = {}


def _scratch(dev, name, words):
    key = (dev.index, name, words)
    if key not in _SCRATCH:
        _SCRATCH[key] = torch.zeros(words, dtype=torch.int64, device=dev)
    return _SCRATCH[key]


def _on_card(name, dev, tensors):
    """Raise unless every tensor is contiguous on ``dev``, the current
    CUDA device."""
    for label, t in tensors:
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name}: {label} must be contiguous on {dev}")
    if dev.index != torch.cuda.current_device():
        raise ValueError(f"{name}: tensors on {dev}, but the current CUDA "
                         f"device is {torch.cuda.current_device()}")


def _count(counts, name):
    """One launch of ``name``, unless the call was captured into a CUDA
    graph (a record, not a launch)."""
    if not torch.cuda.is_current_stream_capturing():
        counts[name] += 1


def matvec_kernel(name, x, w, s, block_n, counts, output_major=False):
    """Launch matvec form ``name`` on CUDA tensors: x bf16 [B, K] (B <= 8),
    w input-major (uint8 [K/2, N], or int8 [K, N] for matvec_s8) or, with
    ``output_major``, uint8 [N, K/2]; s f32 with N elements. Returns f32
    [B, N] and adds one to counts[name] (_count). The five are
    tensor-core kernels that stage nothing, so shared memory bounds no
    K."""
    B, K = x.shape
    N = w.shape[0] if output_major else w.shape[1]
    rows = K if name == "matvec_s8" else K // 2
    want = (N, rows) if output_major else (rows, N)
    wdtype = torch.int8 if name == "matvec_s8" else torch.uint8
    if (not 1 <= B <= MAX_ROWS or K % 2 or tuple(w.shape) != want
            or s.numel() != N):
        raise ValueError(f"{name}: x {tuple(x.shape)} (B <= {MAX_ROWS}, K "
                         f"even), w {tuple(w.shape)} (want {want}), s "
                         f"{tuple(s.shape)}")
    if x.dtype != torch.bfloat16 or w.dtype != wdtype \
            or s.dtype != torch.float32:
        raise ValueError(f"{name} takes bf16 x, {wdtype} w, f32 s; got "
                         f"{x.dtype}, {w.dtype}, {s.dtype}")
    check_tiles(N, block_n)
    dev = w.device
    _on_card(name, dev, (("x", x), ("w", w), ("s", s)))
    align, dim, width = (4, "K/2", rows) if output_major else (16, "N", N)
    if width % align or w.data_ptr() % align:
        raise ValueError(f"{name}: the kernel reads w in {align}-byte "
                         f"pieces: {dim} a multiple of {align}, w on {align} "
                         f"bytes; got {dim}={width}")
    out = torch.empty((B, N), dtype=torch.float32, device=dev)
    rc = _library().sea_qb_matvec(
        MATVEC_FORMS[name], x.data_ptr(), w.data_ptr(), s.data_ptr(),
        out.data_ptr(), B, K, N, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed at B={B}, K={K}, "
                           f"N={N}: CUDA error {rc}")
    _count(counts, name)
    return out


def stream_kernel(name, wp, block_n, counts, x=None):
    """Launch stream form ``name`` on a CUDA uint8 wp [K/2, N] (on 16
    bytes, block_n a multiple of 16 up to MAX_BLOCK_N); x: bf16, for
    _unpack_only_call. Returns f32 [1, block_n], or for _unpack_only_call
    its parts (out f32 [1, 1], the last tile's integer sums int64 [2],
    sum(x) f32 [1]); adds one to counts[name] (_count)."""
    K2, N = wp.shape
    tiles = check_tiles(N, block_n)
    if wp.dtype != torch.uint8 or block_n % 16 or block_n > MAX_BLOCK_N:
        raise ValueError(f"{name}: uint8 wp and block_n a multiple of 16 up "
                         f"to {MAX_BLOCK_N}; got {wp.dtype}, {block_n}")
    dev = wp.device
    tensors = [("wp", wp)] + ([("x", x)] if x is not None else [])
    _on_card(name, dev, tensors)
    if wp.data_ptr() % 16:
        raise ValueError(f"{name}: wp must start on a 16-byte boundary")
    if x is not None and x.dtype != torch.bfloat16:
        raise ValueError(f"{name} takes bf16 x, not {x.dtype}")
    stream = torch.cuda.current_stream(dev).cuda_stream
    if name == "_unpack_only_call":
        lib = _library()
        words = lib.sea_qb_unpack_scratch_words(K2, N, block_n, x.numel())
        if words < 0:
            raise ValueError(f"{name}: its kernel takes no wp {K2}x{N} at "
                             f"block_n {block_n}")
        out = torch.empty(2, dtype=torch.float32, device=dev)
        ints = torch.empty(2, dtype=torch.int64, device=dev)
        rc = lib.sea_qb_unpack(
            wp.data_ptr(), x.data_ptr(), x.numel(), out.data_ptr(),
            ints.data_ptr(), _scratch(dev, name, words).data_ptr(), words,
            K2, N, block_n, stream)
    else:
        # Enough row splits that the grid fills every SM twice.
        splits = min(K2, max(1, -(-2 * _sm_count(dev.index) // tiles)))
        out = torch.empty(block_n, dtype=torch.float32, device=dev)
        scratch = (_scratch(dev, name, 1 + block_n).data_ptr()
                   if name == "stream_bytes" else None)
        rc = _library().sea_qb_stream(
            STREAM_FORMS[name], wp.data_ptr(), out.data_ptr(), scratch, K2,
            N, block_n, -(-K2 // splits), stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")
    _count(counts, name)
    if name == "_unpack_only_call":
        return out[:1].view(1, 1), ints, out[1:]
    return out.view(1, block_n)


def route(device, plain, kernel):
    """plain() for a CPU tensor, kernel() for a CUDA one; else raise."""
    if device.type == "cpu":
        return plain()
    if device.type == "cuda":
        return kernel()
    raise ValueError(f"runs on CPU or CUDA tensors, not {device}")


def matvec_p4(x, wp, s, *, block_n: int):
    """x: [B, K] bf16; wp: uint8 [K//2, N]; s: f32 [1, N] -> [B, N] f32."""
    return route(wp.device,
                  lambda: matvec_p4_ref(x, wp, s, block_n=block_n),
                  lambda: matvec_kernel("matvec_p4", x, wp, s, block_n,
                                        launches))


def matvec_p4b(x, wp, s, *, block_n: int):
    """As matvec_p4, unpacking by byte-width sign extension."""
    return route(wp.device,
                  lambda: matvec_p4b_ref(x, wp, s, block_n=block_n),
                  lambda: matvec_kernel("matvec_p4b", x, wp, s, block_n,
                                        launches))


def matvec_p4c(x, wp, s, *, block_n: int):
    """As matvec_p4, by the bias form; the kernel reads x's high half
    divided by 16 itself (one launch)."""
    return route(wp.device,
                  lambda: matvec_p4c_ref(x, wp, s, block_n=block_n),
                  lambda: matvec_kernel("matvec_p4c", x, wp, s, block_n,
                                        launches))


def matvec_s8(x, w8, s, *, block_n: int):
    """x: [B, K] bf16; w8: int8 [K, N]; s: f32 [1, N] -> [B, N] f32."""
    return route(w8.device,
                  lambda: matvec_s8_ref(x, w8, s, block_n=block_n),
                  lambda: matvec_kernel("matvec_s8", x, w8, s, block_n,
                                        launches))


def stream_bytes(wp, *, block_n: int):
    """wp: uint8 [K2, N] -> f32 [1, block_n], the column sums folded over
    the column tiles."""
    return route(wp.device, lambda: stream_bytes_ref(wp, block_n=block_n),
                  lambda: stream_kernel("stream_bytes", wp, block_n,
                                        launches))


def dma_only(wp, *, block_n: int):
    """wp: uint8 [K2, N] -> f32 [1, block_n], row 0 of the last tile, after
    streaming every tile."""
    return route(wp.device, lambda: dma_only_ref(wp, block_n=block_n),
                  lambda: stream_kernel("dma_only", wp, block_n, launches))


# ---------------------------------------------------------------------------
# Timing
# ---------------------------------------------------------------------------

def weight_sets(tensors, device):
    """[one step's weight tensors, copies of them, ...]: on the card enough
    copies that they hold at least twice its L2 cache, so a loop turning
    through them reads each from device memory; on the CPU the one set."""
    tensors = tuple(t.to(device) for t in tensors)
    if device.type != "cuda" or not tensors:
        return [tensors]
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    props = torch.cuda.get_device_properties(device)
    l2 = getattr(props, "L2_cache_size", 50 * 2 ** 20)
    copies = max(1, math.ceil(2 * l2 / nbytes))
    return [tensors] + [tuple(t.clone() for t in tensors)
                        for _ in range(copies - 1)]


def step_seconds(run, repeats, device, trials=3):
    """Seconds a step of ``run(length)`` (which enqueues ``length`` steps):
    the best of ``trials`` at ``repeats`` steps minus the best at
    ``repeats // 2``, over the difference, which cancels the fixed cost of a
    call. On the card each length is one CUDA graph, replayed between CUDA
    events; on the CPU the host clock."""
    def best(length):
        if device.type == "cuda":
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                run(2)  # warm-up outside the capture
            torch.cuda.current_stream(device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                run(length)
            graph.replay()
            times = []
            for _ in range(trials):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                graph.replay()
                end.record()
                end.synchronize()
                times.append(start.elapsed_time(end) / 1e3)
            return min(times)
        run(2)
        times = []
        for _ in range(trials):
            t0 = time.perf_counter()
            run(length)
            times.append(time.perf_counter() - t0)
        return min(times)

    half = repeats // 2
    if half < 1:
        raise ValueError(f"repeats must be at least 2, got {repeats}")
    seconds = (best(repeats) - best(half)) / (repeats - half)
    if seconds <= 0:
        raise RuntimeError(f"the timing difference is not positive "
                           f"({seconds} s a step): raise --repeats")
    return seconds


def timed_loop(fn, x0, repeats, sets, trials=3):
    """The JAX bench's sequential loop: y = fn(x, *weights) and a slice of
    y, bounded, is the next x (no step can be hoisted). Step i takes the
    weights sets[i % len(sets)]."""
    def run(length):
        x = x0
        for i in range(length):
            y = fn(x, *sets[i % len(sets)])
            nxt = y[:, : x.shape[1]].to(x.dtype)
            x = nxt / (1.0 + nxt.abs())
        return x

    return step_seconds(run, repeats, x0.device, trials)


def stream_loop(fn, repeats, sets, trials=3):
    """The JAX bench's loop over the stream kernels: acc + fn(w).sum()."""
    device = sets[0][0].device

    def run(length):
        acc = torch.zeros((), device=device)
        for i in range(length):
            acc = acc + fn(*sets[i % len(sets)]).sum()
        return acc

    return step_seconds(run, repeats, device, trials)


class Report:
    """The rows of a run: each step's us, GB/s of weight bytes and, on the
    card, their share of the HBM rate; raises on a reading past
    MAX_READING times that rate."""

    def __init__(self, device):
        self.device = device
        self.results = {}

    def __call__(self, name, seconds, nbytes):
        rate = nbytes / seconds
        row = {"us": seconds * 1e6, "GB/s": rate / 1e9}
        if self.device.type == "cuda":
            row["hbm_share"] = rate / HBM_BYTES_PER_S
        self.results[name] = row
        print(name, row, flush=True)
        if self.device.type == "cuda" and rate > MAX_READING * HBM_BYTES_PER_S:
            raise RuntimeError(f"{name}: {rate / 1e9:.1f} GB/s is above "
                               f"{MAX_READING} x {HBM_BYTES_PER_S / 1e9:.0f} "
                               "GB/s: the loop timed a cache, not the "
                               "memory")

    def line(self, **head):
        name = (torch.cuda.get_device_name(self.device)
                if self.device.type == "cuda" else "cpu")
        return json.dumps({**head, "device": name,
                           "clock": "cuda events" if self.device.type
                           == "cuda" else "host",
                           "results": self.results})


def rel_err(got, want):
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def parse_device(name):
    device = torch.device(name)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        device = torch.device("cuda", torch.cuda.current_device()
                              if device.index is None else device.index)
        torch.cuda.set_device(device)
    return device


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--K", type=int, default=2048)
    ap.add_argument("--N", type=int, default=16384)
    ap.add_argument("--B", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=100)
    ap.add_argument("--block_n", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    K, N, B, bn = args.K, args.N, args.B, args.block_n
    device = parse_device(args.device)

    g = torch.Generator().manual_seed(0)
    w = torch.randn(K, N, generator=g) * 0.02
    q, s = quantize_int4(w)
    q8, s8 = quantize_int8(w)
    wp = pack_nibbles(q)
    x0 = torch.randn(B, K, generator=g).to(torch.bfloat16).to(device)
    int4_bytes = K * N // 2
    int8_bytes = K * N
    report = Report(device)

    # correctness first
    y4 = (x0.float() @ q.float().to(device)) * s.to(device)
    y8 = (x0.float() @ q8.float().to(device)) * s8.to(device)
    wp_d, s_d, q8_d, s8_d = (t.to(device) for t in (wp, s, q8, s8))
    for fn, want, ws in ((matvec_p4, y4, (wp_d, s_d)),
                         (matvec_p4b, y4, (wp_d, s_d)),
                         (matvec_p4c, y4, (wp_d, s_d)),
                         (matvec_s8, y8, (q8_d, s8_d))):
        err = rel_err(fn(x0, *ws, block_n=bn), want)
        print(f"{fn.__name__} rel err vs the dequantized product: {err}",
              flush=True)
        if not err < 2e-2:
            raise AssertionError(f"{fn.__name__}: rel err {err}")
    for fn, plain in ((stream_bytes, stream_bytes_ref),
                      (dma_only, dma_only_ref)):
        if not torch.equal(fn(wp_d, block_n=bn), plain(wp_d, block_n=bn)):
            raise AssertionError(f"{fn.__name__} differs from its plain "
                                 "version")
        print(f"{fn.__name__} equals its plain version", flush=True)
    del y4, y8, wp_d, s_d, q8_d, s8_d

    int4_sets = weight_sets((wp, s), device)
    int8_sets = weight_sets((q8, s8), device)
    report("noop_loop", timed_loop(lambda x: x * 1.0001, x0, args.repeats,
                                   [()]), 1)

    from sea_tpu_torch.ops.quant_matmul import unpack_int4
    report("torch_int4", timed_loop(
        lambda x, wq, ws: (x @ unpack_int4(wq, torch.bfloat16)) * ws,
        x0, args.repeats, int4_sets), int4_bytes)
    report("torch_int8", timed_loop(
        lambda x, wq, ws: (x @ wq.to(torch.bfloat16)) * ws,
        x0, args.repeats, int8_sets), int8_bytes)
    for fn, sets, nbytes in ((matvec_p4, int4_sets, int4_bytes),
                             (matvec_p4b, int4_sets, int4_bytes),
                             (matvec_p4c, int4_sets, int4_bytes),
                             (matvec_s8, int8_sets, int8_bytes)):
        report(fn.__name__, timed_loop(
            functools.partial(fn, block_n=bn), x0, args.repeats, sets),
            nbytes)
    wp_sets = [ws[:1] for ws in int4_sets]
    report("stream_bytes", stream_loop(
        functools.partial(stream_bytes, block_n=bn), args.repeats, wp_sets),
        int4_bytes)
    report("dma_only", stream_loop(
        functools.partial(dma_only, block_n=bn), args.repeats, wp_sets),
        int4_bytes)

    print(report.line(shape=[K, N], B=B, block_n=bn, repeats=args.repeats,
                      weight_copies={"int4": len(int4_sets),
                                     "int8": len(int8_sets)}))


if __name__ == "__main__":
    main()
