"""Time two or more checkouts of this repo on one card, in turn.

    python3 chip_ab.py [--kernels | --tools] ROOT [ROOT ...]

Each ROOT is a checkout that holds ``chip_smoke.py`` and ``sea_tpu_torch/``
(for instance a parent commit unpacked with ``git archive`` into
``build/``, which git ignores). For each ROOT in the order given, a process
of its own builds that checkout's kernels, makes the seeded weights and runs
its ``chip_smoke.py`` phases ``[train-time]`` (the full-recipe cylinder
train step, with its profile), ``[rollout]`` (250-step f32 multiphase
rollouts at B=1 and B=8), ``[profile]`` (those rollouts under
torch.profiler) and ``[rollout-int4|int8|bf16]`` (the reduced-precision
rollouts, with profiles of the int4 ones). Every root's rollouts are
profiled by this checkout's ``chip_smoke._profile_rollout``, so that each
prints the same lines (device events and busy time a step, and the int4
and decode kernels' time and count a step). Host-clock
rates move between machines more than between versions, so compare
versions only within one run of this script, and give the roots as
A B B A to see the drift within it. Each output line is printed behind
its root's index and path. Exits 1 if any run failed.

With ``--kernels`` each root's process instead builds that checkout's
flash-attention source, prints the registers, stack and local memory of
its kernels (``[ab-regs]``, from ``cuobjdump``), and runs its
``chip_smoke.py`` ``phase_time_flash()`` in f32 and in bf16: the
forward, dQ and dK/dV ``[kernel-time]`` lines of both forms, kernel
against kernel across the roots.

With ``--tools`` each root's process runs its ``chip_smoke.py``
``phase_tools_quant()`` (the eight kernels of the ``tools/`` int4
microbenchmarks checked and timed at B = 1 and 8, then both entry points
at B = 1) and ``bench_quant_matvec``'s entry point at B = 8.
"""

import subprocess
import sys
from pathlib import Path

_CHILD = """
import importlib.util, sys, tempfile
from pathlib import Path
import torch
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import chip_smoke as cs
spec = importlib.util.spec_from_file_location("chip_smoke_ab", sys.argv[2])
here = importlib.util.module_from_spec(spec)
spec.loader.exec_module(here)
cs._profile_rollout = here._profile_rollout
from sea_tpu_torch.cli import get_case
from sea_tpu_torch.utils.params import save_init_checkpoints
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
train_case, case = get_case(cs.TRAIN_CASE), get_case(cs.CASE)
(root / "build").mkdir(exist_ok=True)
with tempfile.TemporaryDirectory(dir=root / "build") as d:
    train_np = save_init_checkpoints(train_case, d, seed=1)["temporal"]
    serve_np = save_init_checkpoints(case, d, seed=1)["temporal"]
cs.phase_train_time(train_case, train_np)
cs.phase_time_rollout(case, serve_np)
cs.phase_profile(case, serve_np)
cs.phase_rollout_reduced(case, serve_np)
"""


_KERNELS_CHILD = """
import sys
from pathlib import Path
import torch
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import chip_smoke as cs
from sea_tpu_torch.ops import _build
from sea_tpu_torch.ops import flash_attention as FA
torch.backends.cuda.matmul.allow_tf32 = False
FA._library()
fn = None
for line in cs._cuobjdump("--dump-resource-usage",
                          _build.load_library("flash_attention")._name):
    if "Function" in line:
        fn = line.split("Function", 1)[1].strip(" :")
    elif "REG:" in line and fn:
        print("[ab-regs]", fn, " ".join(
            w for w in line.split() if w.startswith(("REG", "STACK",
                                                     "LOCAL"))))
cs.phase_time_flash()
cs.phase_time_flash(torch.bfloat16)
"""

_TOOLS_CHILD = """
import sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import chip_smoke as cs
from sea_tpu_torch.tools import bench_quant_matvec as PQ
cs.phase_tools_quant()
argv = ["--repeats", str(cs.TOOLS_REPEATS), "--B", "8"]
last = cs._tools_entry(PQ, argv)
print("[tools-quant] python -m sea_tpu_torch.tools.bench_quant_matvec "
      + " ".join(argv) + ": " + "; ".join(
          f"{k} {r['us']:.3f} us {r['GB/s']:.1f} GB/s"
          for k, r in last["results"].items()), flush=True)
"""
_CHILDREN = {"--kernels": _KERNELS_CHILD, "--tools": _TOOLS_CHILD}


def main(argv):
    mode = argv[0] if argv[:1] and argv[0] in _CHILDREN else None
    roots = argv[1:] if mode else argv
    if not roots:
        sys.exit(__doc__)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    failed = 0
    for i, root in enumerate(roots):
        root = Path(root).resolve()
        proc = subprocess.run(
            [sys.executable, "-c", _CHILDREN.get(mode, _CHILD),
             str(root), str(Path(__file__).resolve().parent /
                            "chip_smoke.py")],
            cwd=root, capture_output=True, text=True)
        for line in (proc.stdout + proc.stderr).splitlines():
            print(f"[{i} {root.name}] {line}", flush=True)
        print(f"[{i} {root.name}] exit {proc.returncode}", flush=True)
        failed |= proc.returncode != 0
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main(sys.argv[1:])
