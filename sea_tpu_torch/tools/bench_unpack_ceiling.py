"""Take the int4 matvec's time apart: the unpack alone, and output-major
weights, on one NVIDIA GPU.

Counterpart of the JAX package's ``tools/bench_unpack_ceiling.py``, which
recorded on a TPU v5e that an output-major layout ran the matvec about
twice as slowly as the shipped input-major one, and that the unpack alone
reached a little more than the full kernel. Here, at [2048, 16384]:

  unpack  ``_unpack_only_call``: every column tile streamed and unpacked,
          no products; its result, the last tile's sums plus sum(x), feeds
          the loop's next x
  full    the port's serving int4 kernel (``ops/quant_matmul.int4_matmul``,
          input-major weights)
  fullT   ``_mvt_call``: the same product over output-major weights
          (``pack_int4_t``); the plain version keeps the JAX function's
          bias form (matvec_p4c's), the kernel runs the exact nibbles on
          the tensor cores as ``full`` does

``_unpack_only_call`` and ``_mvt_call`` are wrappers: a CPU tensor runs
the plain PyTorch version beside each (``<name>_ref``); a CUDA tensor
launches its hand-written kernel (``sea_tpu_torch/csrc/quant_bench.cu``)
or raises. They keep the JAX signatures; ``block_n`` comes from
``pick_block_n`` as in the JAX bench, and decides which tile
``_unpack_only_call`` returns. Timing is ``bench_quant_matvec``'s: a CUDA
graph of R dependent steps minus one of R/2, weights turned through
copies that hold twice the L2 cache, GB/s of weight bytes and their share
of 3.35 TB/s, failing above 1.05 x it.

    python -m sea_tpu_torch.tools.bench_unpack_ceiling [--k 2048]
        [--n 16384] [--b 1] [--repeats 2000] [--device cuda]

It checks correctness first, then prints one line a row and, last, one
JSON line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from sea_tpu_torch.ops.quant_matmul import int4_matmul, pack_int4
from sea_tpu_torch.tools.bench_quant_matvec import (Report, check_tiles,
                                                    matvec_kernel,
                                                    parse_device, rel_err,
                                                    route, stream_kernel,
                                                    timed_loop, weight_sets)

# Launches of each kernel through its wrapper (a CPU call does not count,
# nor does a call captured into a CUDA graph). Read and reset by
# chip_smoke.py.
launches = {"_unpack_only_call": 0, "_mvt_call": 0}

# The JAX bench's column tile: the widest of these dividing N whose
# packed block fits its TPU kernel's VMEM budget, 3 K block_n <= 13e6
# bytes (sea_tpu/ops/quant_matmul.py:_pick_block_n).
BLOCK_N_CHOICES = (2048, 1024, 512, 256, 128)
VMEM_BUDGET = 13_000_000
# _unpack_only_call's sum of x, f32 in any order, against its f64 value:
# within this share of sum|x|.
UNPACK_X_TOL = 1e-6


def pick_block_n(K: int, N: int) -> int:
    for bn in BLOCK_N_CHOICES:
        if N % bn == 0 and 3 * K * bn <= VMEM_BUDGET:
            return bn
    raise ValueError(f"no column tile of {BLOCK_N_CHOICES} divides N={N} "
                     f"within the budget at K={K}")


def pack_int4_t(q):
    """int8 [K, N] in [-8, 7] -> packed uint8 [N, K//2], output-major."""
    K = q.shape[0]
    qt = q.t()
    lo = (qt[:, : K // 2] & 0xF).to(torch.uint8)
    hi = (qt[:, K // 2:] & 0xF).to(torch.uint8)
    return (lo | (hi << 4)).contiguous()


def unpack_only_parts_ref(x, wp, *, block_n):
    """Plain _unpack_only_call with its parts: of the last column tile (the
    TPU grid runs in order, so the last step's write stands), the integer
    sums lo = sum((w & 0xF) ^ 8) and hi = sum(int8(w) & -16) as int64 [2];
    sum(x) as f32 [1]; and out = (f32(lo) + f32(hi)) + sum(x), f32 [1, 1].
    The TPU kernel's f32 partial sums of lo and hi are exact (below 2^24,
    or multiples of 16 below 2^28), so only sum(x) rounds."""
    N = wp.shape[1]
    check_tiles(N, block_n)
    w8 = wp[:, N - block_n:].view(torch.int8)
    ints = torch.stack([((w8 & 0xF) ^ 8).sum(dtype=torch.int64),
                        (w8 & -16).sum(dtype=torch.int64)])
    xsum = x.float().sum().reshape(1)
    out = (ints[0].float() + ints[1].float()) + xsum
    return out.reshape(1, 1), ints, xsum


def _unpack_only_call_ref(x, wp, *, block_n):
    """Plain _unpack_only_call: out of unpack_only_parts_ref."""
    return unpack_only_parts_ref(x, wp, block_n=block_n)[0]


def unpack_only_magnitude(x, wp, *, block_n):
    """The sum of the magnitudes of _unpack_only_call's terms."""
    N = wp.shape[1]
    w8 = wp[:, N - block_n:].view(torch.int8)
    return (((w8 & 0xF) ^ 8).float().sum() + (w8 & -16).float().abs().sum()
            + x.float().abs().sum()).item()


def unpack_only_parts(x, wp, *, block_n):
    """_unpack_only_call with its parts, (out f32 [1, 1], the last tile's
    integer sums int64 [2], sum(x) f32 [1]): the plain version on a CPU
    tensor, the kernel (one launch) on a CUDA one."""
    return route(wp.device,
                 lambda: unpack_only_parts_ref(x, wp, block_n=block_n),
                 lambda: stream_kernel("_unpack_only_call", wp, block_n,
                                       launches, x=x.contiguous()))


def _unpack_only_call(x, wp, *, block_n):
    """x: bf16 [B, K]; wp: uint8 [K//2, N] -> f32 [1, 1]."""
    return unpack_only_parts(x, wp, block_n=block_n)[0]


def unpack_only_faults(parts, x, wp, *, block_n):
    """What is wrong in _unpack_only_call's parts (out, ints, xsum), from
    the kernel or any other source, against exact arithmetic on the same
    inputs; an empty list if nothing. The integer sums must equal the
    plain version's (exact on both sides), sum(x) must lie within
    UNPACK_X_TOL x sum|x| of its f64 value, and out must be, bit for bit,
    the f32 sum the kernel forms of the two: (f32(lo) + f32(hi)) + sum(x).
    A looser check on out alone, 1e-6 of its terms' magnitudes, lets a
    kernel that drops sum(x) pass: the integer sums dwarf it."""
    out, ints, xsum = parts
    want_ints = unpack_only_parts_ref(x, wp, block_n=block_n)[1]
    faults = []
    if not torch.equal(ints.cpu(), want_ints.cpu()):
        faults.append(f"integer sums {ints.tolist()}, want "
                      f"{want_ints.tolist()}")
    x64 = x.double()
    xerr = abs(xsum.double().sum().item() - x64.sum().item())
    xlim = UNPACK_X_TOL * x64.abs().sum().item()
    if not xerr <= xlim:
        faults.append(f"sum(x) {xsum.item()!r} is {xerr:.3g} from its f64 "
                      f"value, over {xlim:.3g}")
    formed = (ints[0].float() + ints[1].float()) + xsum.float()
    if not torch.equal(out.reshape(1).cpu(), formed.reshape(1).cpu()):
        faults.append(f"out {out.item()!r} is not (f32(lo) + f32(hi)) + "
                      f"sum(x) = {formed.item()!r}")
    return faults


def _mvt_call_ref(x, wpt, s, *, block_n):
    """Plain _mvt_call: matvec_p4c's bias form over output-major wpt uint8
    [N, K//2]; x: bf16 [B, K]; s: f32 [N, 1] -> f32 [B, N]."""
    N, K2 = wpt.shape
    check_tiles(N, block_n)
    xt = x.t()
    w8 = wpt.view(torch.int8)
    xlo = xt[:K2].float()
    acc = (((w8 & 0xF) ^ 8).float() @ xlo
           + (w8 & -16).float() @ (xt[K2:] * (1.0 / 16.0)).float())
    corr = 8.0 * xlo.sum(dim=0)
    return ((acc - corr[None, :]) * s.float()).t().contiguous()


def _mvt_call(x, wpt, s, *, block_n):
    """x: bf16 [B, K]; wpt: uint8 [N, K//2]; s: f32 [N, 1] -> f32 [B, N]."""
    return route(wpt.device,
                 lambda: _mvt_call_ref(x, wpt, s, block_n=block_n),
                 lambda: matvec_kernel("_mvt_call", x, wpt, s, block_n,
                                       launches, output_major=True))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--n", type=int, default=16384)
    ap.add_argument("--b", type=int, default=1)
    ap.add_argument("--repeats", type=int, default=2000)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    K, N, B = args.k, args.n, args.b
    device = parse_device(args.device)

    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.integers(-8, 8, (K, N), dtype=np.int8))
    wp = pack_int4(q)
    wpt = pack_int4_t(q)
    x0 = torch.from_numpy(rng.standard_normal((B, K))).to(
        torch.bfloat16).to(device)
    s = torch.from_numpy(rng.standard_normal(N).astype(np.float32))
    bn = pick_block_n(K, N)
    nbytes = wp.numel()
    report = Report(device)

    # correctness first
    want = (x0.float() @ q.float().to(device)) * s.to(device)
    wp_d, wpt_d, s_d = wp.to(device), wpt.to(device), s.to(device)
    for name, got in (("full", int4_matmul(x0, wp_d, s_d)),
                      ("fullT", _mvt_call(x0, wpt_d, s_d.reshape(N, 1),
                                          block_n=bn))):
        err = rel_err(got, want)
        print(f"{name} rel-max-err vs dequant: {err:.2e}", flush=True)
        if not err < 2e-2:
            raise AssertionError(f"{name}: rel err {err}")
    faults = unpack_only_faults(unpack_only_parts(x0, wp_d, block_n=bn),
                                x0, wp_d, block_n=bn)
    if faults:
        raise AssertionError(f"unpack: {'; '.join(faults)}")
    print("unpack: integer sums exact, sum(x) within "
          f"{UNPACK_X_TOL} x sum|x|, out their f32 sum", flush=True)
    del want, wp_d, wpt_d, s_d

    report("unpack", timed_loop(
        lambda x, w: torch.broadcast_to(
            _unpack_only_call(x, w, block_n=bn), (B, K)).to(torch.bfloat16)
        * 1e-6 + x, x0, args.repeats, weight_sets((wp,), device)), nbytes)
    report("full", timed_loop(
        lambda x, w, ss: int4_matmul(x, w, ss), x0, args.repeats,
        weight_sets((wp, s), device)), nbytes)
    report("fullT", timed_loop(
        lambda x, w, ss: _mvt_call(x, w, ss, block_n=bn), x0, args.repeats,
        weight_sets((wpt, s.reshape(N, 1)), device)), nbytes)

    print(report.line(shape=[K, N], B=B, block_n=bn, repeats=args.repeats))


if __name__ == "__main__":
    main()
