"""torch.profiler's device events per session, through a whole run of
chip_smoke.py, on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_profiler_probe.py [--after cli|rollout|launches|idle]

chip_smoke.py counts device kernels a call under torch.profiler
(``_one_kernel_a_call``: a marker add, four calls, a synchronize, in one
session). Late in a run, such sessions have held no device event, or the
marker's and none of the kernel's. This script looks for when that starts
and what it touches. It runs ``chip_smoke.main()`` whole with every
``phase_*`` wrapped, so that after each phase that ``main`` calls two
such sessions run over ``matvec_s8`` (``csrc/quant_bench.cu``), the
serving int4 matvec (``csrc/quant_matmul.cu``) and a PyTorch kernel (an
in-place multiply).
Each session logs the marker's events, the kernel's events, and the
device events' start times against the marker's host op
(``[probe] <after phase>: <kernel> [(marker, kernel, lag us), ...]``).

After the run, each of the three runs SESSIONS sessions in three forms:
as chip_smoke.py has them, with the host asleep for SLEEP_S seconds after
the synchronize inside the session (a window that ends later), and with
it asleep before the marker (a window that starts earlier). Last, how
each built library links the CUDA runtime (``ldd``). Output: one line
per session set; exit 0 unless the run itself failed.

With ``--after``, a fresh process instead probes at its start, after one
piece of work and after a second one of the same kind (TRIGGERS): the
CLI's ``temporal test`` as ``chip_smoke``'s ``[serve]`` runs it, 250-step
f32 rollouts on the decode kernel without the CLI, LAUNCHES one-element
PyTorch kernels, or IDLE_S seconds of nothing.
"""

import argparse
import functools
import subprocess
import sys
import time
import traceback

import torch

import chip_smoke as cs
from chip_smoke import log

SESSIONS = 6
SLEEP_S = 0.2
CALLS = 4
LAUNCHES = 200_000
IDLE_S = 60
TRIGGERS = ("cli", "rollout", "launches", "idle")


def _cases():
    """{label: fn} of the three probed kernels on seeded inputs."""
    from sea_tpu_torch.ops import quant_matmul as QM
    from sea_tpu_torch.tools import bench_quant_matvec as PQ
    g = torch.Generator(device="cuda").manual_seed(0)
    K, N = 2048, 16384
    x = torch.randn(1, K, device="cuda", generator=g).to(torch.bfloat16)
    w8 = torch.randint(-128, 128, (K, N), device="cuda", generator=g,
                       dtype=torch.int8)
    q = torch.randint(-8, 8, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    s = torch.rand(1, N, device="cuda", generator=g) + 0.5
    wp = QM.pack_int4(q)
    y = torch.ones(1 << 20, device="cuda")
    return {"matvec_s8": functools.partial(PQ.matvec_s8, x, w8, s,
                                           block_n=512),
            "int4_matmul": functools.partial(QM.int4_matmul, x, wp,
                                             s.reshape(N)),
            "torch mul_": functools.partial(y.mul_, 1.0)}


def session(fn, sleep_after=0.0, sleep_before=0.0):
    """One session as chip_smoke._one_kernel_a_call runs it: (marker
    events, other device events, first device event's start less the
    marker's host op's start, in us; None without device events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    marker = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if sleep_before:
            time.sleep(sleep_before)
        marker.add_(1)
        for _ in range(CALLS):
            fn()
        torch.cuda.synchronize()
        if sleep_after:
            time.sleep(sleep_after)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host_add = [e.time_range.start for e in events
                if e.device_type == DeviceType.CPU and e.name == "aten::add_"]
    marks = sum(1 for e in device if "CUDAFunctorOnSelf" in e.name)
    lag = (round(min(e.time_range.start for e in device) - host_add[0], 1)
           if device and host_add else None)
    return marks, len(device) - marks, lag


def probe(label, cases, n=2, **kw):
    for name, fn in cases.items():
        log(f"[probe] {label}: {name} "
            f"{[session(fn, **kw) for _ in range(n)]}")


def after(name, cases):
    """Probe at the start, then after each of two rounds of work ``name``
    (TRIGGERS), in this process."""
    import tempfile
    from sea_tpu_torch import cli
    from sea_tpu_torch.utils.params import save_init_checkpoints
    case = cli.get_case(cs.CASE)
    probe("start", cases, n=3)
    with tempfile.TemporaryDirectory(dir=cs.REPO / "build") as save_dir:
        params_np = save_init_checkpoints(case, save_dir, seed=1)["temporal"]
        for round_ in (1, 2):
            t0 = time.perf_counter()
            if name == "cli":
                cli.main([cs.CASE, "temporal", "test", "--synthetic",
                          "--save_dir", save_dir, "--device", "cuda"])
            elif name == "rollout":
                cs._time_rollout(cs._reduced_params(params_np, "f32"),
                                 case.temporal, 1, torch.float32)
            elif name == "launches":
                y = torch.zeros(1, device="cuda")
                for _ in range(LAUNCHES):
                    y.add_(1)
            else:
                time.sleep(IDLE_S)
            torch.cuda.synchronize()
            probe(f"after {name} {round_} "
                  f"({time.perf_counter() - t0:.1f} s)", cases, n=3)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--after", choices=TRIGGERS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_profiler_probe.py: no CUDA device")
    log(f"[probe] torch {torch.__version__}, CUDA {torch.version.cuda}")
    cs.phase_build()
    cases = _cases()
    if args.after:
        after(args.after, cases)
        return
    probe("start", cases)

    depth = [0]

    def wrap(fn):
        """fn, probed after it returns unless another phase called it (its
        launch counts may still be read)."""
        @functools.wraps(fn)
        def run(*args, **kwargs):
            depth[0] += 1
            try:
                out = fn(*args, **kwargs)
            finally:
                depth[0] -= 1
            if depth[0] == 0:
                probe(f"after {fn.__name__}", cases)
            return out
        return run

    for name in [n for n in vars(cs) if n.startswith("phase_")
                 and n != "phase_build"]:
        setattr(cs, name, wrap(getattr(cs, name)))
    failed = False
    try:
        cs.main()
    except Exception:
        traceback.print_exc()
        failed = True
    for label, kw in (("end, as chip_smoke", {}),
                      (f"end, asleep {SLEEP_S} s after", {"sleep_after":
                                                          SLEEP_S}),
                      (f"end, asleep {SLEEP_S} s before", {"sleep_before":
                                                           SLEEP_S})):
        probe(label, cases, n=SESSIONS, **kw)
    from sea_tpu_torch.ops import _build
    for lib in sorted(_build.BUILD_DIR.glob("*.so")):
        linked = subprocess.run(["ldd", str(lib)], capture_output=True,
                                text=True).stdout
        cuda = [line.split()[0] for line in linked.splitlines()
                if "cuda" in line or "cupti" in line]
        log(f"[probe] {lib.name} links {', '.join(cuda)}" if cuda else
            f"[probe] {lib.name} links no shared CUDA library (the runtime "
            f"is static)")
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
