"""Smoke test of the PyTorch/CUDA port (sea_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel of the port from the sources in the
checkout (the five CUDA sources with one nvcc each, started together)
and holds each against its
plain PyTorch version at the shapes its path gives it. Then it drives the
port's paths at full width, each with the launch counts set to 0 just
before and read just after:

- the dropout verification (a port of tools/verify_flash_dropout.py):
  the dense mask kernel's mask drives an autograd oracle that the flash
  kernels' output and gradients must match.
- serving: `multiphase_flow temporal test --synthetic` (E=2048, 8 heads,
  MLP x8; random weights from a seeded torch.Generator) at f32, at
  `--precision int4 --kv_cache int8` (the int4 matvec and int8-KV decode
  kernels), `int8` and `bf16`. It checks that every attention and every
  int4 linear of every rollout step ran its kernel, compares rollout steps
  on the card with the same steps on the CPU (f32, and int4 weights with
  an int8 cache), times 250-step rollouts and profiles them with
  torch.profiler (50-step rollouts, PROFILE_STEPS). `temporal test`
  runs on the engine select_engine picks
  and again with `--kv_cache f32` (the scan engine).
- the prefix engine: `rollout(engine="prefix")` at full width, B=1, 250
  steps (one flash forward per attention of each forward, no decode),
  against the scan engine; the masked prefix engine at the multiphase
  width with `ib_addition_mode="attention"` and `src_len=1`, 8 steps on
  the card against the CPU; scan against prefix in steps/s at the cells
  of select_engine's constants (`[engine-time]`).
- generation: `multiphase_flow temporal generate --synthetic --horizon
  500`, past the data's window: finite fields [500, N, F], one decode per
  attention a step.
- training: `cylinder_flow temporal train --synthetic --epochs 2` (E=1024,
  8 heads, MLP x8, dropout 0.1, AdaLN). It checks the loss and norms, the
  checkpoint, and that the launches of the flash-attention kernels
  (forward, dQ, dK/dV) and the fused AdaLN kernels (forward, backward)
  equal the model's count per step; compares one full-recipe step at
  B=2, T=399 on the card with the same step on the CPU; and times that
  step (median over 25 steps, peak memory, a torch.profiler pass).
- bf16 training: the same, with `--compute_dtype bf16_shadow
  --adam_mu_dtype bf16`: every train step through the bf16 flash kernels
  and the AdaLN kernels on bf16, the evaluation through the f32 ones,
  each count exact; the checkpoint's shadow is the bf16 cast of its
  parameters; one step on the card against the CPU within bf16 noise.

- the other exchange modes, ib scalings, remat and optimizers: the
  multiphase width in the pool, addition and simple exchanges (32 scan
  steps on the card against the CPU, exact decode counts; pool also at
  int4 weights with an int8 cache, exact q8 and int4 counts); one
  cylinder step on the card against the CPU in each of seven variants
  (pool's three updates, addition, simple, fourier and linear ib), exact
  flash and AdaLN counts; remat at 4 layers (the same gradients, the
  flash forwards doubled, a lower forward-and-backward peak under
  "full"); `cylinder_flow temporal train --optimizer adafactor` through
  the CLI, f32 and bf16_shadow, its state read back and resumed, an
  Adafactor step on the card against the CPU, the linear schedule's
  learning rates, and the Adafactor update and step timed beside
  AdamW's.
- stage 1: `cylinder_flow encoder train --synthetic --epochs 2` at full
  width (12 layers, B=128; it launches none of the port's kernels: its
  attention over 64 patches is the plain path, as in the JAX package),
  its checkpoint read back, and `temporal test` served on the encoder it
  wrote; one f32 step from the shipped trained weights at B=128 on the
  card against the CPU; `encoder test` on the card against the CPU; and
  the step timed (median of 25, device busy, events a step, peak
  memory).
- the rest of the CLI surface: the f32 `temporal train` run above is
  run again with `--profile` as a process of its own, and the port's
  flash and AdaLN kernels in its trace of epoch 2 are counted against
  the model's sites ([train-profile-cli]);
  the per-tensor norms of the card-vs-CPU step ([train-per-tensor]);
  `full_autoregressive_evaluation` against the fused evaluation at the
  multiphase width, with the rollout CSV and the plots or their one skip
  line ([serve-artifacts]); reference `.pt` state dicts through
  `--model_path`, the shipped stage-1 weights in `encoder test` and
  seeded cylinder weights in `temporal test`, equal to their npz's bit
  for bit ([checkpoint-pt]).

- the mesh (`--mesh DxM`, sea_tpu_torch/parallel): the six flash entries
  with a permuted bh_map and position offsets against their plain
  versions, a row block of an unsharded call bit-equal to the call on
  that block with its bh_map, both maps timed ([mesh-kernels]); the full
  cylinder recipe step in two ranks sharing the card over gloo at 2x1
  and 1x2 against one rank (STEP_TOL; every rank's flash launches and
  bh_maps), the stage-1 step at B=128 at 2x1, and `torchrun
  --nproc_per_node 2 -m sea_tpu_torch cylinder_flow encoder train --mesh
  2x1` ([train-mesh]); multiphase `temporal test --mesh 1x2` at int4
  with an int8 cache and `--mesh 2x1` at f32 against one device, rtol
  1e-4, every rank's decodes on its heads and its int4 count
  ([serve-mesh]).
- sequence parallelism and the pipeline (`--seq_parallel N`, `--pp S`):
  the causal ring attention (dropout 0.1, f32 and bf16, (2, 399, 8, 128)
  and hd 64) in three ranks sharing the card over gloo against the
  one-device flash kernels, rank r launching r + 1 forwards, dQ and dK/dV
  ([seq-ring]); the full cylinder recipe step on a ring of three ranks
  against one rank, and `torchrun ... temporal train --seq_parallel 2`
  ([train-seq]); 4 layers at E=1024 over two pipeline stages with two
  microbatches: the forward and a dropout-0 step against one rank, a
  dropout step against the one-stage pipeline, and `torchrun ...
  cylinder_flow_smoke_deep temporal train --pp 2` ([train-pipe]).

- the int4 matvec microbenchmarks (`sea_tpu_torch/tools/`, ports of
  tools/bench_quant_matvec.py and tools/bench_unpack_ceiling.py): each of
  their eight kernels against its plain version at (B, K, N) = (1, 2048,
  16384) and (8, 2048, 16384) (_unpack_only_call's integer sums exactly,
  its check shown to reject planted faults), one device kernel a call,
  timed; matvec_p4, _unpack_only_call and dma_only also at N = 65536, a
  weight past the L2, each with its GB/s and share of the HBM rate; and
  both entry points at a short loop, whose GB/s must stay within 1.05 x
  the HBM rate ([tools-quant]).

Last, every kernel is timed against its plain version, its bound and,
where one PyTorch call computes the same function, that call. Any failure
raises and the exit code is not 0; without CUDA, or without the rest of
the repository, it exits non-zero before printing any result.

Output: one line per check and timing, then a JSON line of the kernels
({"kernels": [...]}), then, as the last line, the JSON status
{"ok": true, "device": {...}}.
"""

import collections
import contextlib
import csv
import dataclasses
import functools
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
CASE = "multiphase_flow"
# (B, H, T, hd) of the decode checks: the rollouts' head dims, then the
# smoke presets' 16 and 8 (also in Q8_SHAPES).
KERNEL_SHAPES = [(1, 8, 250, 256), (1, 8, 250, 128), (8, 8, 250, 256),
                 (2, 8, 399, 64), (2, 2, 42, 16), (2, 2, 42, 8)]
# Kernel vs plain: f32 differs only in summation order; bf16 rounds q and
# each probability to bf16 at the same points in both versions (against
# the running max of the 256-key tiles), so they differ where an f32
# summation order tips a rounding: one bf16 ulp of one p.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Card vs CPU over the first rollout steps, f32 on both: cuBLAS and the
# CPU BLAS sum in different orders, and errors feed back through the
# autoregressive loop (8 steps of a 201M-parameter model).
ROLLOUT_STEPS_CHECKED = 8
ROLLOUT_ATOL = 1e-3
TIMED_STEPS = 250
# The profiled rollouts' depth: per-step figures need few steps, and the
# profiler's processing grows with them (at 250 steps each took ~50 s;
# the run has a time limit).
PROFILE_STEPS = 50
# int8-KV decode: both round p * v_scale to bf16 against the running max
# of the 256-key tiles (as for the bf16 cache).
Q8_SHAPES = [(1, 8, 250, 256), (8, 8, 250, 256), (8, 8, 250, 128),
             (2, 8, 399, 64), (2, 2, 42, 16), (2, 2, 42, 8)]
Q8_TOL = 2e-2
# int4 matvec: (K, N) of every int4 linear of the multiphase rollout step,
# with its launches a step (phase_serve_reduced checks these against the
# quantized model), each checked at M = 1 and M = 8 rows; and ragged
# shapes at M = 1, 3 and 8, where K/2 is not a multiple of the 128-row
# stage and N not one of the column tile: the kernel's byte-wise form
# (N=200 not a multiple of 16; K/2=2049 not one of 4) and its 16-byte
# form (K/2=1028 ends inside an 8-row k-step, N=4000 inside a tile).
INT4_SHAPES = {(2048, 6144): 2, (2048, 2048): 4, (2048, 1024): 4,
               (1024, 1024): 4, (1024, 2048): 4, (2048, 16384): 2,
               (16384, 2048): 2}
INT4_RAGGED = [(2000, 200), (4098, 4000), (2056, 4000)]
# Kernel vs plain: f32 sums in another order over K exact products, held
# to 1e-5 of the sum of the products' magnitudes (sum_k |x_k w_kn| s_n).
INT4_REL_TOL = 1e-5
# The dropout verification (tools/verify_flash_dropout.py): B, T, H, hd,
# rate, causal. Flash vs the mask oracle is f32 summation order, the
# bounds of the kernel check; a wrong mask bit is off by O(|v|).
DROPOUT_SHAPE = (2, 512, 4, 64)
DROPOUT_RATE = 0.1
DROPOUT_SEEDS = ((123, 456), (7, 8))
# Card vs CPU, 8 rollout steps with int4 weights and an int8 cache: the
# kernels round x and q to bf16, the int8-KV kernel rounds p * v_scale to
# bf16 against its streams' running maxima (2e-3 to 3e-3 from the plain
# version by itself, [kernel]), and the cache rounds k and v to int8, so
# f32 order noise that moves a value across a rounding boundary becomes a
# step of 2^-8 relative or of one int8 level, which the autoregressive
# loop carries on: measured 6e-4 after one step growing to 0.045 after
# eight on an H100 (|y| up to 4). Held to about twice that; a wrong scale
# or plane is off by O(|y|).
ROLLOUT_Q_ATOL = 0.1

TRAIN_CASE = "cylinder_flow"
TRAIN_EPOCHS = 2
# (B, Tq, Tk, H, hd, src_len, causal): the train step's self-attention
# (hd 128) and exchange (hd 64) at T=399, hd 256, one token, Tq != Tk with
# keys above the band, the smoke presets' hd 16 and 8 (square; ragged),
# and the prefix engine's: a 64-row chunk whose keys are cut to the
# prefix (Tq > Tk), causal at the multiphase self-attention's hd 256 and
# the exchange's hd 128 with src_len 1, and the ib-attention's unmasked.
FLASH_SHAPES = [(2, 399, 399, 8, 128, 0, True), (2, 399, 399, 8, 64, 0, True),
                (4, 199, 199, 8, 256, 0, True), (1, 1, 1, 8, 64, 0, True),
                (2, 70, 130, 8, 128, 5, True), (2, 41, 41, 2, 16, 0, True),
                (3, 37, 53, 2, 8, 5, True), (1, 64, 37, 8, 256, 0, True),
                (1, 64, 37, 8, 128, 1, True), (1, 64, 37, 8, 128, 0, False)]
FLASH_SEED = (123456789, -987654321)
# The mangled names of the bf16 kernels' wgmma forms (hd 64, 128 and 256;
# their mma.sync forms for hd 8 and 16 end in _bf16_mma): the forward, dQ
# and dK/dV.
FWD_WGMMA = "15fwd_kernel_bf16I"
BWD_WGMMA = ("14dq_kernel_bf16I", "15dkv_kernel_bf16I")
# f32, summation order only: the bounds of tests/test_flash_attention.py.
# A dropout bit the kernel and the plain version disagree on is off by
# about |v| / (1 - rate), far outside them.
FLASH_TOL = {"out": 2e-5, "grad": 5e-5}
# bf16 kernels vs their plain versions: rel x max|ref| + the f32 bound
# above (tests/test_torch_flash_attention.py's note: one bf16 ulp of the
# largest value for o, a binade more for the gradients, whose rounded
# terms are summed; the kernels round p under their key tiles' running
# max, the plain version under the row's max).
FLASH_BF16_REL = {"out": 2.0 ** -7, "grad": 2.0 ** -6}
# (B, T, E) of the train step's AdaLN sites. (atol, rtol) per element,
# |got - want| <= atol + rtol |want|: the bounds of
# tests/test_fused_adaln.py (its output check keeps numpy's default rtol
# 1e-7: outputs reach ~8, where an f32 ulp is ~1e-6, and the kernel's and
# PyTorch's row normalisations round rsqrt differently).
ADALN_SHAPES = [(2, 399, 1024), (2, 399, 512)]
ADALN_TOL = {"out": (2e-6, 1e-7), "grad": (1e-4, 1e-4)}
# Card vs CPU over one full-width train step from the same weights, batch
# and key (the dropout masks are bit-identical by construction): cuBLAS
# and the CPU BLAS sum in other orders over 86M parameters. The first
# AdamW step moves each parameter by lr * g / (|g| + eps), +-lr wherever
# |g| >> eps = 1e-8, so order noise changes a parameter only where |g| is
# near eps: held to a tenth of lr = 1e-4.
STEP_TOL = {"loss": 1e-5, "grad_norm": 1e-4, "params": 1e-5}
TRAIN_TIMED_STEPS = 25
# The bf16 recipe (CLI flags, TrainConfig fields). Card vs CPU, one step:
# the two round to bf16 at other points (the kernels under their tiles'
# running max, cuBLAS's bf16 products), so the loss and grad norm are held
# within BF16_NOISE times the other side's distance to the f32 step's
# (tests/test_torch_train.py holds the port to JAX so), plus STEP_TOL; a
# parameter to STEP_TOL["params"] + lr |u(g_card) - u(g_cpu)|, the two
# sides' first AdamW updates u(g) = g / (|g| + eps) from their own
# gradients (read from nu and the sign of mu): the first step moves each
# parameter by -lr u, so only gradients near eps or of opposite sign may
# move it apart.
BF16_FLAGS = ["--compute_dtype", "bf16_shadow", "--adam_mu_dtype", "bf16"]
BF16_RECIPE = {"compute_dtype": "bfloat16_shadow",
               "adam_mu_dtype": "bfloat16"}
BF16_NOISE = 4.0
# Stage 1: the CLI run's epochs, the shipped trained cylinder encoder
# (n_inp 51, from the dataset's partition), its step's batch. Card vs CPU,
# one f32 step from those weights on one random batch, TF32 off: the two
# BLAS sum in other orders, so the loss and grad norm are held to
# STEP_TOL's relative bounds and each parameter to STEP_TOL["params"] + lr
# |u(g_card) - u(g_cpu)| (the first AdamW step moves it by -lr u(g), see
# BF16_NOISE). `encoder test` card vs CPU: rtol 1e-4 on its three numbers.
ENCODER_EPOCHS = 2
SHIPPED_ENCODER = "checkpoints/encoder_decoder_cylinder_flow_run1.npz"
ENCODER_BATCH = 128
ENCODER_TEST_RTOL = 1e-4
# NVIDIA H100 SXM data sheet (dense rates): HBM rate, the f32 rate outside
# the tensor cores and the bf16 tensor-core rate. A bound takes the peak of
# its operands' type, whatever units the kernel itself runs them on. f32
# products at f32 accuracy also run on the tensor cores as three TF32
# products each (3xTF32, as the flash forward does): a third of the 495
# TFLOP/s TF32 peak, the flash kernels' operation rate.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12
TF32X3_FLOP_PER_S = 495e12 / 3


def log(msg):
    print(msg, flush=True)


def _smi():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()


def phase_build():
    """The five CUDA sources with one nvcc each, started together."""
    from sea_tpu_torch.ops import _build
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    from sea_tpu_torch.ops import quant_matmul as QM
    from sea_tpu_torch.tools import bench_quant_matvec as PQ
    log(_smi())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(5) as pool:
        for future in [pool.submit(lib._library)
                       for lib in (DA, FA, FAL, QM, PQ)]:
            future.result()
    log(f"[build] decode_attention.cu, flash_attention.cu, fused_adaln.cu, "
        f"quant_matmul.cu, quant_bench.cu -> {_build.BUILD_DIR} in "
        f"{time.perf_counter() - t0:.2f} s")
    # Registers and static shared memory of the int4 kernel, the flash
    # backward kernels and the bf16 forward's wgmma form (their tiles are
    # dynamic shared memory) and the AdaLN kernels at the train step's f32
    # layouts (16-byte vectors, 32 and 16 elements a thread: E = 1024 and
    # 512), and the flash kernels' SASS counts: the f32 backward's products
    # are tensor-core mma.sync (HMMA), not f32 FMAs (FFMA); the bf16
    # forward, dQ and dK/dV at hd 64, 128 and 256 must each be one
    # instance running wgmma (HGMMA) on tiles that TMA loads (UTMALDG),
    # the backward's with no mma.sync and no stack or local memory (a
    # spill); and the microbenchmark kernels of quant_bench.cu, whose
    # matvec_p4, p4b, p4c, s8 and _mvt_call kernels must run mma.sync
    # (HMMA) and _unpack_only_call's dp4a (IDP), each with no stack or
    # local memory.
    for name, kernels in (("quant_matmul", ("",)),
                          ("quant_bench", (*QB_MMA, QB_DP4A,
                                           "reduce_kernel", "copy_kernel")),
                          ("flash_attention", ("dq_kernel", "dkv_kernel",
                                               FWD_WGMMA)),
                          ("fused_adaln", ("3F32ELi4ELi32E",
                                           "3F32ELi4ELi16E"))):
        lib = _build.load_library(name)._name
        keep, fn, usage = False, None, {}
        for line in _cuobjdump("--dump-resource-usage", lib):
            if "Function" in line:
                keep = any(k in line for k in kernels)
                fn = line.split("Function", 1)[1].strip(" :")
            elif "REG:" in line and fn:
                usage[fn] = {k: int(v) for k, v in
                             re.findall(r"(REG|STACK|LOCAL):(\d+)", line)}
            if keep and ("Function" in line or "REG:" in line) \
                    or "failed" in line:
                log(f"[build] {name}.cu {line.strip()}")
        if name == "flash_attention":
            _wgmma_gate(_sass_counts(lib, kernels), usage)
        if name == "quant_bench":
            _hmma_gate(_sass_counts(lib, QB_MMA), usage)
            _dp4a_gate(_sass_counts(lib, (QB_DP4A,)), usage)


# The tensor-core kernels of quant_bench.cu: matvec_s8's, _mvt_call's two
# instances (16- and 8-byte loads, or words), and matvec_p4's, matvec_p4b's
# and matvec_p4c's (p4_mma<kP4|kP4b|kP4c>); and _unpack_only_call's kernel,
# which sums with dp4a.
QB_MMA = ("s8_mma", "mvt_mma", "p4_mma")
QB_MMA_INSTANCES = 6
QB_DP4A = "unpack_sums"


def _dp4a_gate(counts, usage):
    """Log the SASS counts of _unpack_only_call's kernel; raise unless it
    is one function with dp4a (IDP) in its SASS and STACK 0 and LOCAL 0."""
    for fn, n in counts.items():
        use = usage.get(fn, {})
        log(f"[build] quant_bench.cu SASS {fn}: IDP {n['IDP']}; "
            + ", ".join(f"{k} {use.get(k)}" for k in ("REG", "STACK",
                                                      "LOCAL")))
    if len(counts) != 1 or any(
            not n["IDP"] or usage.get(fn, {}).get("STACK") != 0
            or usage.get(fn, {}).get("LOCAL") != 0
            for fn, n in counts.items()):
        raise AssertionError(f"{QB_DP4A}: want one function with IDP, "
                             f"STACK 0 and LOCAL 0, got {counts}, "
                             f"{ {fn: usage.get(fn) for fn in counts} }")


def _hmma_gate(counts, usage):
    """Log the SASS counts of quant_bench.cu's tensor-core kernels; raise
    unless there are QB_MMA_INSTANCES (s8_mma, mvt_mma<true|false>,
    p4_mma<kP4|kP4b|kP4c>), each with HMMA and with STACK 0 and LOCAL 0."""
    for fn, n in counts.items():
        use = usage.get(fn, {})
        log(f"[build] quant_bench.cu SASS {fn}: "
            + ", ".join(f"{k} {v}" for k, v in n.items()) + "; "
            + ", ".join(f"{k} {use.get(k)}" for k in ("REG", "STACK",
                                                      "LOCAL")))
        if not n["HMMA"] or use.get("STACK") != 0 or use.get("LOCAL") != 0:
            raise AssertionError(f"{fn}: want HMMA, STACK 0 and LOCAL 0, "
                                 f"got HMMA {n['HMMA']}, {use}")
    if len(counts) != QB_MMA_INSTANCES:
        raise AssertionError(f"quant_bench.cu: want {QB_MMA_INSTANCES} "
                             f"tensor-core kernel instances {QB_MMA}, got "
                             f"{sorted(counts)}")


def _wgmma_gate(counts, usage):
    """Log the flash kernels' SASS counts; raise unless the bf16 forward,
    dQ and dK/dV at hd 64, 128 and 256 are each one instance with HGMMA
    and UTMALDG, and the backward's also with no HMMA, STACK 0 and
    LOCAL 0 (whose REG / STACK / LOCAL are logged)."""
    for fn, n in counts.items():
        log(f"[build] flash_attention.cu SASS {fn}: "
            + ", ".join(f"{k} {v}" for k, v in n.items()))
    for form in (FWD_WGMMA, *BWD_WGMMA):
        label = form.lstrip("0123456789").rstrip("I")
        for hd in (64, 128, 256):
            fns = [fn for fn in counts if form in fn and f"ILi{hd}E" in fn]
            n = [counts[fn] for fn in fns]
            if len(n) != 1 or not n[0]["HGMMA"] or not n[0]["UTMALDG"]:
                raise AssertionError(
                    f"{label} at hd {hd}: want one instance with HGMMA and "
                    f"UTMALDG in its SASS, got {n}")
            if form == FWD_WGMMA:
                continue
            use = usage.get(fns[0], {})
            log(f"[build] {label} at hd {hd}: HGMMA {n[0]['HGMMA']}, "
                f"UTMALDG {n[0]['UTMALDG']}, HMMA {n[0]['HMMA']}, "
                + ", ".join(f"{k} {use.get(k)}"
                            for k in ("REG", "STACK", "LOCAL")))
            if n[0]["HMMA"] or use.get("STACK") != 0 \
                    or use.get("LOCAL") != 0:
                raise AssertionError(
                    f"{label} at hd {hd}: want no HMMA, STACK 0 and LOCAL "
                    f"0, got HMMA {n[0]['HMMA']}, {use}")


def _cuobjdump(*args):
    """cuobjdump's output lines, or one line saying why it failed."""
    from sea_tpu_torch.ops import _build
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    try:
        return subprocess.run([str(cuobjdump), *args], capture_output=True,
                              text=True, check=True,
                              timeout=60).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError) as e:
        return [f"cuobjdump failed: {e}"]


def _sass_counts(lib, kernels):
    """{mangled function: {op: count}} of the tensor-core (mma.sync HMMA,
    wgmma HGMMA), f32 FMA, shared-load, cp.async, TMA-load and dp4a (IDP)
    instructions in the SASS of each function whose name holds one of
    `kernels`."""
    ops = ("HMMA", "HGMMA", "FFMA", "LDS", "LDGSTS", "UTMALDG", "IDP")
    counts, fn = {}, None
    for line in _cuobjdump("-sass", lib):
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            fn = name if any(k in name for k in kernels) else None
            if fn:
                counts[fn] = dict.fromkeys(ops, 0)
        elif fn and "/*" in line:
            op = line.split("*/", 1)[-1].split()
            for o in ops:
                if op and op[0].split(".")[0] == o:
                    counts[fn][o] += 1
    return counts


def _cases(shape, dtype):
    B, H, T, hd = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q = torch.randn(B, H, hd, device="cuda", generator=g)
    K = torch.randn(B, H, T, hd, device="cuda", generator=g).to(dtype)
    V = torch.randn(B, H, T, hd, device="cuda", generator=g).to(dtype)
    return q, K, V


def _positions(T, plan):
    """t at 0 (only rank 0 has keys), either side of the split and stage
    edges, the TPU kernel's 256-key block edge and T-1."""
    edges = {plan.chunk, 2 * plan.chunk, plan.stage, 2 * plan.stage, 256}
    return sorted(({0, T - 1} | edges | {e - 1 for e in edges})
                  & set(range(T)))


def _one_kernel_a_call(fn, label, calls=4):
    """torch.profiler over `calls` calls of fn (after one warm-up): each
    must run exactly one device kernel. Returns the kernels' names, the
    marker's among them.

    A marker kernel (an in-place add on a one-element tensor, made before
    the session) runs in the session too, first; its event's name is
    learned from a session of the marker alone. So a session whose trace
    holds no event of that name is the profiler's miss, not the kernel's:
    torch.profiler has returned empty traces between sessions that
    recorded every launch (for the AdaLN and the q8 decode checks, once
    each), and a trace of 2 events for a marker and 4 launches of
    _unpack_only_call, the marker's missing, where the same check in
    another process recorded all 5. Such a session is run again, at most
    twice, and logged; a third miss fails, as does a trace that holds the
    marker's event and any other count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def session(work):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            work()
            torch.cuda.synchronize()
        return [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]

    def marked():
        marker.add_(1)
        for _ in range(calls):
            fn()

    fn()
    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    for attempt in range(3):
        marker_names = {e.key for e in session(lambda: marker.add_(1))}
        events = session(marked)
        if marker_names and marker_names <= {e.key for e in events}:
            break
        log(f"[kernel] {label}: torch.profiler's trace missed the "
            f"marker's event ({len(events)} event names: "
            f"{sorted(e.key[:60] for e in events)}; session "
            f"{attempt + 1}); profiling again")
    else:
        raise AssertionError(f"{label}: torch.profiler's trace missed the "
                             "marker's event in 3 sessions, so it cannot "
                             "count one kernel a call")
    total = sum(e.count for e in events)
    n = total - 1  # the marker's add
    names = sorted({e.key[:80] for e in events})
    if n != calls:
        raise AssertionError(f"{label}: {n} device events over {calls} "
                             f"calls ({names}, the marker's among them), "
                             "want one a call")
    return names


def phase_kernel_check():
    """Kernel against decode_attention_ref at the path's shapes, f32 and
    bf16 caches, t at 0, the split and stage edges, the TPU kernel's
    256-key block edge and T-1; with NaN past t, which the kernel must
    never read; and, under the profiler, one device kernel a call."""
    from sea_tpu_torch.ops import decode_attention as DA
    dev = torch.device("cuda", 0)
    worst = 0.0
    for shape in KERNEL_SHAPES:
        B, H, T, hd = shape
        for dtype in KERNEL_TOL:
            plan = DA.device_plan(T, B * H, hd, dtype, dev)
            positions = _positions(T, plan)
            q, K, V = _cases(shape, dtype)
            errs = []
            for t in positions:
                tt = torch.tensor([t], dtype=torch.int32, device="cuda")
                got = DA.decode_attention(q, K, V, tt)
                want = DA.decode_attention_ref(q, K, V, tt)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                if not err <= KERNEL_TOL[dtype]:
                    raise AssertionError(f"decode_attention {shape} {dtype} "
                                         f"t={t}: max abs err {err}")
                Kp, Vp = K.clone(), V.clone()
                Kp[:, :, t + 1:] = float("nan")
                Vp[:, :, t + 1:] = float("nan")
                if not torch.equal(DA.decode_attention(q, Kp, Vp, tt), got):
                    raise AssertionError(f"decode_attention {shape} {dtype} "
                                         f"t={t}: NaN past t changed it")
                errs.append(err)
            worst = max(worst, max(errs))
            names = _one_kernel_a_call(
                lambda: DA.decode_attention(q, K, V, tt),
                f"decode_attention {shape} {dtype}")
            log(f"[kernel] {shape} {str(dtype)[6:]} {plan} t={positions}: "
                f"max abs err {max(errs):.3g} <= {KERNEL_TOL[dtype]}; NaN "
                f"past t ignored; one device kernel a call {names}")
    return worst


def _q8_cases(shape):
    """q [B,H,hd] and an int8 cache of quantized random tokens with their
    per-token scales, as mha_step writes it."""
    from sea_tpu_torch.ops.attention import _quantize_token
    B, H, T, hd = shape
    g = torch.Generator(device="cuda").manual_seed(7 + sum(shape))
    q = torch.randn(B, H, hd, device="cuda", generator=g)
    K8, ks = _quantize_token(torch.randn(B, H, T, hd, device="cuda",
                                         generator=g))
    V8, vs = _quantize_token(torch.randn(B, H, T, hd, device="cuda",
                                         generator=g))
    return q, K8, V8, ks, vs


def phase_q8_check():
    """The int8-KV kernel against decode_attention_q8_ref at the path's
    shapes, t at 0, the split and stage edges, the TPU kernel's 256-key
    block edge and T-1; NaN scales past t must leave the output
    bit-identical (the int8 planes cannot hold a NaN); one device kernel a
    call under the profiler."""
    from sea_tpu_torch.ops import decode_attention as DA
    dev = torch.device("cuda", 0)
    worst = 0.0
    for shape in Q8_SHAPES:
        B, H, T, hd = shape
        plan = DA.device_plan(T, B * H, hd, torch.int8, dev)
        positions = _positions(T, plan)
        q, K8, V8, ks, vs = _q8_cases(shape)
        errs = []
        for t in positions:
            tt = torch.tensor([t], dtype=torch.int32, device="cuda")
            got = DA.decode_attention(q, K8, V8, tt, k_scale=ks, v_scale=vs)
            want = DA.decode_attention_q8_ref(q, K8, V8, ks, vs, tt)
            torch.cuda.synchronize()
            err = _err(got, want)
            if not err <= Q8_TOL:
                raise AssertionError(f"decode q8 {shape} t={t}: max abs err "
                                     f"{err}")
            ksn, vsn = ks.clone(), vs.clone()
            ksn[:, :, t + 1:] = float("nan")
            vsn[:, :, t + 1:] = float("nan")
            if not torch.equal(DA.decode_attention(q, K8, V8, tt, k_scale=ksn,
                                                   v_scale=vsn), got):
                raise AssertionError(f"decode q8 {shape} t={t}: NaN scales "
                                     "past t changed it")
            errs.append(err)
        worst = max(worst, max(errs))
        names = _one_kernel_a_call(
            lambda: DA.decode_attention(q, K8, V8, tt, k_scale=ks,
                                        v_scale=vs), f"decode q8 {shape}")
        log(f"[kernel] decode q8 {shape} {plan} t={positions}: max abs err "
            f"{max(errs):.3g} <= {Q8_TOL}; NaN scales past t ignored; one "
            f"device kernel a call {names}")
    return worst


def _int4_cases(M, K, N, seed=0):
    from sea_tpu_torch.ops import quant_matmul as QM
    g = torch.Generator(device="cuda").manual_seed(seed + M + K + N)
    q = torch.randint(-7, 8, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    q[0, :8] = -8  # the nibble the quantizer never writes, but the format has
    wp = QM.pack_int4(q)
    s = torch.rand(N, device="cuda", generator=g) * 0.01 + 1e-3
    x = torch.randn(M, K, device="cuda", generator=g)
    return x, wp, s


def phase_int4_check():
    """The int4 kernel against int4_matvec_ref at every (K, N) of the
    rollout step, M = 1 and 8, and at the ragged shapes, M = 1, 3 and 8;
    the bound scales with the sum of the products' magnitudes. Each call is
    one launch, and a second call gives the same bits (the cluster sums in
    a fixed order)."""
    from sea_tpu_torch.ops import quant_matmul as QM
    worst = 0.0
    cases = ([(M, K, N) for K, N in INT4_SHAPES for M in (1, 8)]
             + [(M, K, N) for K, N in INT4_RAGGED for M in (1, 3, 8)])
    for M, K, N in cases:
        x, wp, s = _int4_cases(M, K, N)
        before = QM.launches
        got = QM.int4_matmul(x, wp, s)
        again = QM.int4_matmul(x, wp, s)
        if QM.launches != before + 2:
            raise AssertionError(f"int4 (M,K,N)=({M},{K},{N}): "
                                 f"{QM.launches - before} launches for 2 "
                                 "calls")
        want = QM.int4_matvec_ref(x, wp, s)
        mag = (x.to(torch.bfloat16).float().abs()
               @ QM.unpack_int4(wp, torch.float32).abs()) * s
        torch.cuda.synchronize()
        err = _err(got, want)
        if not bool(((got - want).abs() <= INT4_REL_TOL * mag).all()):
            raise AssertionError(f"int4 (M,K,N)=({M},{K},{N}): max abs "
                                 f"err {err}, magnitude {mag.max()}")
        if not torch.equal(got, again):
            raise AssertionError(f"int4 (M,K,N)=({M},{K},{N}): two calls "
                                 "differ")
        worst = max(worst, err)
        plan = QM.device_plan(K, N, "cuda")
        log(f"[kernel] int4 (M,K,N)=({M},{K},{N}) {plan} {plan.blocks} "
            f"blocks, {plan.smem_bytes} B shared: max abs err {err:.3g} "
            f"(|y| max {want.abs().max().item():.3g}) within "
            f"{INT4_REL_TOL} x sum|x w s|; repeat bit for bit")
    return worst


def phase_mask_check():
    """The dense dropout-mask kernel against its plain version, bit for
    bit, at the dropout verification's shape and a ragged one, with the
    default bh and with a bh_map."""
    from sea_tpu_torch.ops import flash_attention as FA
    B, T, H, _ = DROPOUT_SHAPE
    for BH, Tq, Tk in ((B * H, T, T), (3, 70, 130)):
        for bh_map in (None, torch.tensor([5, 2, 7, 0, 1, 3, 4, 6][:BH],
                                          dtype=torch.int32, device="cuda")):
            got = FA.dropout_mask_dense(BH, Tq, Tk, DROPOUT_SEEDS[0],
                                        DROPOUT_RATE, "cuda", bh_map=bh_map)
            want = FA.dropout_mask_dense_ref(
                torch.arange(BH, dtype=torch.int32, device="cuda")
                if bh_map is None else bh_map, Tq, Tk, DROPOUT_SEEDS[0],
                DROPOUT_RATE)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"dropout mask {(BH, Tq, Tk)} bh_map="
                                     f"{bh_map}: {(got != want).sum()} "
                                     "elements differ")
            log(f"[kernel] dropout mask (BH,Tq,Tk)={(BH, Tq, Tk)} bh_map="
                f"{'given' if bh_map is not None else 'default'}: bit for "
                f"bit, keep share {(got > 0).float().mean().item():.5f}")
    return 0.0


def phase_flash_dropout():
    """The dropout verification of tools/verify_flash_dropout.py on the
    card: the dense mask kernel's mask feeds an autograd oracle (softmax
    -> mask -> @ v); the flash kernels' output and dq/dk/dv must match it,
    the same seed must repeat the output bit for bit and another seed must
    change it, and the keep share must be within 4 sigma of 1 - rate."""
    from sea_tpu_torch.ops import flash_attention as FA
    B, T, H, hd = DROPOUT_SHAPE
    rate, seed = DROPOUT_RATE, DROPOUT_SEEDS[0]
    g = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, gy = (torch.randn(B, T, H, hd, device="cuda", generator=g)
                   for _ in range(4))
    _reset_launch_counts()

    def flash(seed_):
        ts = [a.clone().requires_grad_(True) for a in (q, k, v)]
        out = FA.flash_attention(*ts, True, 0, dropout_rate=rate,
                                 dropout_seed=seed_)
        out.backward(gy)
        return [out.detach()] + [a.grad for a in ts]

    mask = FA.dropout_mask_dense(B * H, T, T, seed, rate, "cuda")
    got = flash(seed)
    ts = [a.clone().requires_grad_(True) for a in (q, k, v)]
    s = torch.einsum("bqhd,bkhd->bhqk", ts[0], ts[1]) * hd ** -0.5
    causal = torch.ones(T, T, dtype=torch.bool, device="cuda").tril()
    p = torch.softmax(s.masked_fill(~causal, float("-inf")), dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p * mask.reshape(B, H, T, T),
                       ts[2])
    out.backward(gy)
    want = [out.detach()] + [a.grad for a in ts]
    again = flash(seed)[0]
    other = flash(DROPOUT_SEEDS[1])[0]
    torch.cuda.synchronize()
    launches = _launch_counts()
    errs = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        errs[name] = _err(a, b)
        tol = FLASH_TOL["out" if name == "out" else "grad"]
        if not errs[name] <= tol:
            raise AssertionError(f"flash dropout {name}: max abs err "
                                 f"{errs[name]} > {tol}")
    if not torch.equal(got[0], again):
        raise AssertionError("flash dropout: the same seed gave another "
                             "output")
    if torch.equal(got[0], other):
        raise AssertionError("flash dropout: another seed gave the same "
                             "output")
    keep = (mask > 0).float().mean().item()
    sigma = (rate * (1 - rate) / mask.numel()) ** 0.5
    if not abs(keep - (1 - rate)) < 4 * sigma:
        raise AssertionError(f"keep share {keep}, expected {1 - rate} +- "
                             f"4 x {sigma}")
    if launches["dropout_mask"] != 1 or launches["flash_fwd"] != 3:
        raise AssertionError(f"dropout verification launches {launches}")
    log(f"[flash-dropout] (B,T,H,hd)={DROPOUT_SHAPE} rate {rate} causal: "
        f"flash vs mask oracle max abs err out {errs['out']:.3g} <= "
        f"{FLASH_TOL['out']}, dq {errs['dq']:.3g}, dk {errs['dk']:.3g}, dv "
        f"{errs['dv']:.3g} <= {FLASH_TOL['grad']}; same seed bit-identical, "
        f"other seed differs; keep share {keep:.5f} (expected {1 - rate}, "
        f"sigma {sigma:.2e}); mask launches {launches['dropout_mask']}")
    return launches["dropout_mask"]


def _attentions(cfg):
    """(attentions a scan step, attentions a full forward) of a config:
    per layer G self decodes a step and the exchange's, G(G-1) for sea (a
    pair each), G for pool (a field each), none for addition and simple;
    a full forward's flash forwards are the same and, with attention-mode
    ib, G ib-attentions."""
    G, nl = cfg.num_fields, cfg.num_layers
    exchange = {"sea": G * (G - 1), "pool": G}.get(cfg.exchange_mode, 0)
    ib = G if cfg.ib_addition_mode == "attention" else 0
    return nl * (G + exchange), nl * (G + exchange + ib)


def _adaln_sites(cfg):
    """(forwards, backwards) of the AdaLN kernels a train step runs: per
    layer ln_exp[i][0] and [i][2] of each field and the exchange's norms
    (sea: one per field on its own side and one per pair on the other,
    G^2; pool and addition: G; simple: none), and the G final norms; pool
    also norms its dead token each forward (no backward: nothing reads
    it). 0 for a plain-LN config."""
    if cfg.ln_type.lower() != "adaln":
        return 0, 0
    G, nl = cfg.num_fields, cfg.num_layers
    cross = {"sea": G * G, "pool": G, "addition": G}.get(cfg.exchange_mode,
                                                          0)
    sites = nl * (2 * G + cross) + G
    return sites + (nl if cfg.exchange_mode == "pool" else 0), sites


def phase_serve(case, save_dir):
    """`temporal test` through the port's CLI on the card, on the engine
    select_engine picks (its launches: scan, one flash-decode a step per
    attention; prefix, one flash forward a forward per attention), then
    with --kv_cache f32, which forces the scan engine: every attention of
    every rollout step must have launched the flash-decode kernel."""
    from sea_tpu_torch import cli
    per_step, per_forward = _attentions(case.temporal)
    out = {}
    for flags in ([], ["--kv_cache", "f32"]):
        _reset_launch_counts()
        t0 = time.perf_counter()
        results = cli.main([CASE, "temporal", "test", "--synthetic",
                            "--save_dir", save_dir, "--device", "cuda"]
                           + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        engine = results["engine"]
        if flags and engine != "scan":
            raise AssertionError(f"--kv_cache f32 served on {engine}")
        T_roll = results["decoded_rel_mse_per_time"].shape[0]
        expected = dict.fromkeys(counts, 0)
        if engine == "scan":
            expected["decode_attention"] = per_step * T_roll
        else:
            expected["flash_fwd"] = per_forward * T_roll
        for key in ("encoded_rel_mse", "decoded_rel_mse"):
            if not np.isfinite(results[key]):
                raise AssertionError(f"{key} = {results[key]}")
        if not np.all(np.isfinite(results["decoded_rel_mse_per_time"])):
            raise AssertionError("non-finite decoded rel-MSE per time")
        if counts != expected:
            raise AssertionError(f"[serve] {engine} engine launched "
                                 f"{counts}, expected {expected}")
        what = (f"decode_attention launches {counts['decode_attention']} = "
                f"{per_step} attentions x {T_roll} steps" if engine == "scan"
                else f"flash_fwd launches {counts['flash_fwd']} = "
                f"{per_forward} attentions x {T_roll} forwards")
        log(f"[serve] {CASE} temporal test {' '.join(flags) or '(auto)'}: "
            f"{engine} engine, {T_roll} steps in {seconds:.2f} s (data, "
            f"encode, load, rollout, decode); encoded_rel_mse "
            f"{results['encoded_rel_mse']:.6g}, decoded_rel_mse "
            f"{results['decoded_rel_mse']:.6g}; {what}")
        out[engine] = counts
    return out["scan"]["decode_attention"]


GENERATE_HORIZON = 500


def phase_generate(case, save_dir):
    """`temporal generate --horizon 500` through the CLI: past the
    synthetic data's 40-step window, on the scan engine; finite fields
    [H, N, F] in the .npy and one flash-decode per attention a step."""
    from sea_tpu_torch import cli
    per_step, _ = _attentions(case.temporal)
    N, F = cli._load_data(case, synthetic=True)[0].shape[2:]
    path = Path(save_dir) / "generated.npy"
    _reset_launch_counts()
    t0 = time.perf_counter()
    fields = cli.main([CASE, "temporal", "generate", "--synthetic",
                       "--horizon", str(GENERATE_HORIZON), "--save_dir",
                       save_dir, "--output", str(path), "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected["decode_attention"] = per_step * GENERATE_HORIZON
    if counts != expected:
        raise AssertionError(f"[generate] launches {counts}, expected "
                             f"{expected}")
    saved = np.load(path)
    if saved.shape != (GENERATE_HORIZON, N, F) \
            or not np.isfinite(saved).all() \
            or not np.array_equal(saved, fields):
        raise AssertionError(f"[generate] {path.name}: shape {saved.shape}, "
                             f"finite {np.isfinite(saved).all()}")
    log(f"[generate] {CASE} temporal generate --horizon {GENERATE_HORIZON}: "
        f"fields {saved.shape}, finite, |x| max {np.abs(saved).max():.4g}, "
        f"in {seconds:.2f} s (data, encode, load, rollout, decode, save); "
        f"decode_attention launches {counts['decode_attention']} = "
        f"{per_step} attentions x {GENERATE_HORIZON} steps")


def _int4_sites_per_step(qparams, cfg):
    """The int4 linears one rollout step runs
    (models/temporal.temporal_step on int4-quantized params, fused or, as
    a mesh serves them, not): per layer and field the self-attention qkv
    (or q, k and v) and proj; the exchange's: for sea, cross_down of field
    i and, per partner j, cross_down of j and the cross-attention q, kv
    and proj and cross_up; for pool and addition, cross_down and cross_up
    of each field and, for pool, its cross-attention q, kv and proj and,
    once per layer, the pool update (linear, or the MLP's fc1 and fc2);
    the MLP and the block proj; once per layer the ib MLP unless the AdaLN
    cond tables carry it. A site counts where the quantizer rewrote it
    (w_p4), so the count follows min_size and the matrix shapes. Returns
    the count of each (K, N)."""
    G, mode = cfg.num_fields, cfg.exchange_mode
    sites = []
    for block in qparams["blocks"]:
        if cfg.ln_type.lower() != "adaln":
            sites += [lay["lin"] for lay in block["ib"]["layers"]]
        if mode == "pool" and cfg.pool_update_method != "pooling":
            update = block["pool_update"]
            sites += ([update] if cfg.pool_update_method == "linear"
                      else [update["fc1"], update["fc2"]])
        def attention(att):  # fused (qkv or q, kv) or not (q, k, v)
            return [att[k] for k in ("qkv", "q", "k", "v", "kv", "proj")
                    if k in att]
        for i in range(G):
            sites += attention(block["self_attn"][i])
            if mode == "sea":
                sites.append(block["cross_down"][i])
                for j in range(G):
                    if j != i:
                        sites += ([block["cross_down"][j]]
                                  + attention(block["cross_attn"][i][j])
                                  + [block["cross_up"][i]])
            elif mode in ("pool", "addition"):
                sites += [block["cross_down"][i], block["cross_up"][i]]
                if mode == "pool":
                    sites += attention(block["cross_attn"][i])
            sites += [lay["lin"] for lay in block["mlp"][i]["layers"]]
            sites.append(block["proj"][i])
    return collections.Counter((2 * p["w_p4"].shape[0], p["w_p4"].shape[1])
                               for p in sites if "w_p4" in p)


def phase_serve_reduced(case, save_dir, params_np):
    """`temporal test` through the CLI at --precision int4 --kv_cache int8,
    int8 and bf16. The weights are random, so the drift gate's budget is
    1.0: the drift is printed, not gated. Exact launch counts: every
    attention of every rollout step on the int8-KV kernel (int4) or the
    f32 decode kernel (int8, bf16: their auto caches are f32); every int4
    linear of every step on the int4 kernel; and the flash forwards of the
    teacher-forced forwards that calibration (one batch) and the drift
    gate (the f32 and the reduced model) run."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.utils import precision as prec
    from sea_tpu_torch.utils.params import from_numpy
    tcfg = case.temporal
    G, nl = tcfg.num_fields, tcfg.num_layers
    attn_per_step = nl * (G + G * (G - 1))
    attn_per_forward = nl * G * G
    qparams = prec.quantize_weights_int4(prec.fuse_attention_projections(
        from_numpy(params_np, "cuda")), scale="max")
    int4_shapes = _int4_sites_per_step(qparams, tcfg)
    del qparams
    if int4_shapes != collections.Counter(INT4_SHAPES):
        raise AssertionError(f"int4 linears a step {dict(int4_shapes)}, "
                             f"INT4_SHAPES says {INT4_SHAPES}")
    int4_per_step = sum(int4_shapes.values())
    out = {}
    for flags, forwards in (
            (["--precision", "int4", "--kv_cache", "int8"], 1 + 2),
            (["--precision", "int8"], 2), (["--precision", "bf16"], 0)):
        mode = flags[1]
        _reset_launch_counts()
        t0 = time.perf_counter()
        results = cli.main([CASE, "temporal", "test", "--synthetic",
                            "--save_dir", save_dir, "--drift_budget", "1.0",
                            "--device", "cuda"] + flags)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        T_roll = results["decoded_rel_mse_per_time"].shape[0]
        expected = {name: 0 for name in counts}
        expected["flash_fwd"] = attn_per_forward * forwards
        if mode == "int4":
            expected["decode_q8"] = attn_per_step * T_roll
            expected["int4_matvec"] = int4_per_step * T_roll
        else:
            expected["decode_attention"] = attn_per_step * T_roll
        if counts != expected:
            raise AssertionError(f"[serve-{mode}] launches {counts}, "
                                 f"expected {expected}")
        for key in ("encoded_rel_mse", "decoded_rel_mse"):
            if not np.isfinite(results[key]):
                raise AssertionError(f"[serve-{mode}] {key} = {results[key]}")
        if not np.all(np.isfinite(results["decoded_rel_mse_per_time"])):
            raise AssertionError(f"[serve-{mode}] non-finite rel-MSE")
        log(f"[serve-{mode}] {CASE} temporal test {' '.join(flags)}: "
            f"{T_roll} steps in {seconds:.2f} s (the whole CLI run); "
            f"encoded_rel_mse {results['encoded_rel_mse']:.6g}, "
            f"decoded_rel_mse {results['decoded_rel_mse']:.6g}; launches "
            f"{ {k: v for k, v in counts.items() if v} } = "
            f"{attn_per_step} attentions and "
            f"{int4_per_step if mode == 'int4' else 0} int4 linears x "
            f"{T_roll} steps, {attn_per_forward} flash forwards x "
            f"{forwards} teacher-forced forwards")
        out[mode] = counts
    return out


def _reduced_params(params_np, mode, fuse=True):
    """The multiphase params on the card in a serving mode of the port's
    own transforms (fused projections first, as the CLI does on one
    device; ``fuse`` False: unfused, as a mesh serves them; int4 with MSE
    scales, no calibration)."""
    from sea_tpu_torch.utils import precision as prec
    from sea_tpu_torch.utils.params import from_numpy
    params = from_numpy(params_np, "cuda")
    if mode == "f32":
        return params
    fused = prec.fuse_attention_projections(params) if fuse else params
    return {"bf16": prec.cast_weights_bf16, "int8": prec.quantize_weights_int8,
            "int4": prec.quantize_weights_int4}[mode](fused)


def _rollout_inputs(cfg, B, T, seed):
    rs = np.random.RandomState(seed)
    x0 = rs.randn(B, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = rs.rand(B, T, cfg.ib_num).astype(np.float32) + 0.5
    return torch.from_numpy(x0), torch.from_numpy(ib)


def phase_card_vs_cpu(case, params_np):
    from sea_tpu_torch.rollout.engine import rollout_scan
    from sea_tpu_torch.utils.params import from_numpy
    cfg = case.temporal
    x0, ib = _rollout_inputs(cfg, 1, ROLLOUT_STEPS_CHECKED, seed=0)
    on_card = rollout_scan(from_numpy(params_np, "cuda"), cfg, x0.cuda(),
                           ib.cuda()).cpu()
    on_cpu = rollout_scan(from_numpy(params_np, "cpu"), cfg, x0, ib)
    err = (on_card - on_cpu).abs().max().item()
    if not (torch.isfinite(on_card).all() and err <= ROLLOUT_ATOL):
        raise AssertionError(f"card vs CPU rollout: max abs err {err}")
    log(f"[card-vs-cpu] first {ROLLOUT_STEPS_CHECKED} rollout steps, "
        f"B=1, full width: max abs err {err:.3g} <= {ROLLOUT_ATOL} "
        f"(|y| max {on_cpu.abs().max().item():.3g})")


def phase_card_vs_cpu_int4(case, params_np):
    """8 full-width rollout steps with int4 weights (the port's quantizer,
    MSE scales) and an int8 KV cache, card against CPU from the same
    quantized tree."""
    from sea_tpu_torch.rollout.engine import rollout_scan
    from sea_tpu_torch.utils.params import tree_map
    cfg = case.temporal
    qparams = _reduced_params(params_np, "int4")
    x0, ib = _rollout_inputs(cfg, 1, ROLLOUT_STEPS_CHECKED, seed=0)
    on_card = rollout_scan(qparams, cfg, x0.cuda(), ib.cuda(),
                           cache_dtype=torch.int8).cpu()
    on_cpu = rollout_scan(tree_map(lambda a: a.cpu(), qparams), cfg, x0, ib,
                          cache_dtype=torch.int8)
    err = _err(on_card, on_cpu)
    per_step = [_err(on_card[:, t], on_cpu[:, t])
                for t in range(ROLLOUT_STEPS_CHECKED)]
    if not (torch.isfinite(on_card).all() and err <= ROLLOUT_Q_ATOL):
        raise AssertionError(f"card vs CPU int4/int8-KV rollout: max abs err "
                             f"{err}; per step {per_step}")
    log(f"[card-vs-cpu-int4] first {ROLLOUT_STEPS_CHECKED} rollout steps, "
        f"B=1, int4 weights, int8 KV cache: max abs err {err:.3g} <= "
        f"{ROLLOUT_Q_ATOL} (per step {[f'{e:.3g}' for e in per_step]}; "
        f"|y| max {on_cpu.abs().max().item():.3g})")


def phase_serve_prefix(case, params_np):
    """rollout(engine="prefix") at full width, B=1, T=250: one flash
    forward per attention of each of its 250 forwards (chunks of 64, 128,
    192 and 250 rows), no decode; its first 8 predictions against the
    scan engine's on the card."""
    from sea_tpu_torch.rollout.engine import rollout, rollout_scan
    from sea_tpu_torch.utils.params import from_numpy
    cfg = case.temporal
    _, per_forward = _attentions(cfg)
    params = from_numpy(params_np, "cuda")
    x0, ib = (a.cuda() for a in _rollout_inputs(cfg, 1, TIMED_STEPS, seed=0))
    _reset_launch_counts()
    t0 = time.perf_counter()
    ys = rollout(params, cfg, x0, ib, engine="prefix")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected["flash_fwd"] = per_forward * TIMED_STEPS
    if counts != expected:
        raise AssertionError(f"[serve-prefix] launches {counts}, expected "
                             f"{expected}")
    n = ROLLOUT_STEPS_CHECKED
    scan = rollout_scan(params, cfg, x0, ib[:, :n])
    err = _err(ys[:, :n], scan)
    if not (torch.isfinite(ys).all() and err <= ROLLOUT_ATOL):
        raise AssertionError(f"[serve-prefix] vs scan: max abs err {err}")
    log(f"[serve-prefix] {CASE} rollout(engine='prefix') B=1, "
        f"{TIMED_STEPS} steps in {seconds:.2f} s (first call); flash_fwd "
        f"launches {counts['flash_fwd']} = {per_forward} attentions x "
        f"{TIMED_STEPS} forwards, decode 0; first {n} predictions vs "
        f"rollout_scan on the card: max abs err {err:.3g} <= {ROLLOUT_ATOL}"
        f" (|y| max {scan.abs().max().item():.3g})")
    return counts["flash_fwd"]


def phase_serve_prefix_masked(case):
    """The multiphase width with ib_addition_mode="attention" and
    src_len=1 (random weights from a seeded generator), which only the
    masked prefix engine serves: 8 steps on the card (auto picks the
    prefix engine; 6 flash forwards a forward, the 2 ib-attentions
    unmasked, every one with its keys cut to the prefix) against the same
    steps on the CPU."""
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.rollout.engine import rollout, select_engine
    from sea_tpu_torch.utils.params import tree_map
    cfg = dataclasses.replace(case.temporal, ib_addition_mode="attention",
                              src_len=1)
    _, per_forward = _attentions(cfg)
    n = ROLLOUT_STEPS_CHECKED
    params = init_temporal(cfg, torch.Generator().manual_seed(2),
                           device="cpu")
    x0, ib = _rollout_inputs(cfg, 1, n, seed=3)
    on_cpu = rollout(params, cfg, x0, ib)
    params = tree_map(lambda a: a.cuda(), params)
    engine = select_engine(cfg, 1, n, params)
    _reset_launch_counts()
    on_card = rollout(params, cfg, x0.cuda(), ib.cuda()).cpu()
    counts = _launch_counts()
    expected = dict.fromkeys(counts, 0)
    expected["flash_fwd"] = per_forward * n
    if engine != "prefix" or counts != expected:
        raise AssertionError(f"[serve-prefix-masked] {engine} engine, "
                             f"launches {counts}, expected {expected}")
    err = _err(on_card, on_cpu)
    per_step = [_err(on_card[:, t], on_cpu[:, t]) for t in range(n)]
    if not (torch.isfinite(on_card).all() and err <= ROLLOUT_ATOL):
        raise AssertionError(f"[serve-prefix-masked] card vs CPU: max abs "
                             f"err {err}; per step {per_step}")
    log(f"[serve-prefix-masked] {CASE} width, ib_addition_mode=attention, "
        f"src_len=1, B=1: {engine} engine, {n} steps; flash_fwd launches "
        f"{counts['flash_fwd']} = {per_forward} attentions x {n} forwards; "
        f"card vs CPU max abs err {err:.3g} <= {ROLLOUT_ATOL} (per step "
        f"{[f'{e:.3g}' for e in per_step]}; |y| max "
        f"{on_cpu.abs().max().item():.3g})")


# The cells of select_engine's constants: (preset, B, T), f32 weights.
ENGINE_CELLS = [(CASE, 1, 250), (CASE, 2, 250), (TRAIN_CASE, 1, 399)]


def phase_engine_time(params_by_case):
    """Scan against prefix at f32, both engines in this process, at each
    ENGINE_CELLS cell: a warm-up rollout of each, then three of each in
    turns (scan, prefix, prefix, scan, scan, prefix), each ended by
    torch.cuda.synchronize(); medians in steps/s. Then one prefix rollout
    of the first cell under torch.profiler. Returns {cell: (scan steps/s,
    prefix steps/s)}."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.rollout.engine import (rollout_prefix_bucketed,
                                              rollout_scan)
    engines = {"scan": rollout_scan, "prefix": rollout_prefix_bucketed}
    out = {}
    for name, B, T in ENGINE_CELLS:
        cfg, params = get_case(name).temporal, params_by_case[name]
        x0, ib = (a.cuda() for a in _rollout_inputs(cfg, B, T, seed=B))
        times = {e: [] for e in engines}
        for e, run in engines.items():
            run(params, cfg, x0, ib)
        torch.cuda.synchronize()
        for e in ("scan", "prefix", "prefix", "scan", "scan", "prefix"):
            t0 = time.perf_counter()
            engines[e](params, cfg, x0, ib)
            torch.cuda.synchronize()
            times[e].append(time.perf_counter() - t0)
        rates = {e: T / statistics.median(ts) for e, ts in times.items()}
        out[(name, B, T)] = (rates["scan"], rates["prefix"])
        log(f"[engine-time] {name} f32 B={B} T={T}: scan "
            f"{rates['scan']:.1f} steps/s (s {[round(t, 4) for t in times['scan']]}), "
            f"prefix {rates['prefix']:.1f} steps/s (s "
            f"{[round(t, 4) for t in times['prefix']]}); prefix/scan "
            f"{rates['prefix'] / rates['scan']:.3f}")
    cfg = get_case(CASE).temporal
    _profile_rollout(params_by_case[CASE], cfg, 1, torch.float32,
                     "prefix f32 B=1", run=rollout_prefix_bucketed)
    return out


def _time_rollout(params, cfg, B, cache_dtype):
    """One warm-up 250-step rollout, then the median of 3, each ended by
    torch.cuda.synchronize(). Returns (median s, the three)."""
    from sea_tpu_torch.rollout.engine import rollout_scan
    x0, ib = (a.cuda() for a in _rollout_inputs(cfg, B, TIMED_STEPS, seed=B))
    y = rollout_scan(params, cfg, x0, ib, cache_dtype=cache_dtype)
    torch.cuda.synchronize()
    if not torch.isfinite(y).all():
        raise AssertionError(f"B={B} {cache_dtype} rollout is not finite")
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        rollout_scan(params, cfg, x0, ib, cache_dtype=cache_dtype)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def _profile_rollout(params, cfg, B, cache_dtype, label, run=None):
    """torch.profiler over one PROFILE_STEPS-step rollout after a warm-up
    one (per-step figures, so not those of a 250-step rollout): device
    events and busy time per step, their share of the profiled wall, and
    the kernels that take the most device time. run: the engine (default
    the scan engine, with cache_dtype; else run(params, cfg, x0, ib))."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.rollout.engine import rollout_scan
    if run is None:
        def run(params, cfg, x0, ib):
            return rollout_scan(params, cfg, x0, ib, cache_dtype=cache_dtype)
    x0, ib = (a.cuda() for a in _rollout_inputs(cfg, B, PROFILE_STEPS,
                                                 seed=B))
    run(params, cfg, x0, ib)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(params, cfg, x0, ib)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0) / PROFILE_STEPS
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / PROFILE_STEPS
    if not busy_us > 0:
        raise AssertionError(f"{label}: the profiler saw no device time")
    log(f"[profile] {CASE} {label}, {PROFILE_STEPS}-step rollout: "
        f"{sum(e.count for e in events) / PROFILE_STEPS:.1f} device "
        f"events/step, device busy {busy_us:.1f} us/step, profiled "
        f"wall {wall_us:.1f} us/step, busy share "
        f"{100 * busy_us / wall_us:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        us = e.self_device_time_total / PROFILE_STEPS
        log(f"[profile] {label} {us:8.2f} us/step "
            f"{e.count / PROFILE_STEPS:6.1f}/step {e.key[:100]}")
    for name in ("int4", "decode", "fwd_kernel"):
        mine = [e for e in events if name in e.key]
        if mine:
            us = sum(e.self_device_time_total for e in mine) / PROFILE_STEPS
            log(f"[profile] {label} {name} kernels "
                f"{sorted({e.key[:60] for e in mine})}: {us:.2f} us/step, "
                f"{sum(e.count for e in mine) / PROFILE_STEPS:.1f}/step")


def phase_time_rollout(case, params_np):
    """250-step f32 rollouts, B=1 and B=8."""
    cfg = case.temporal
    params = _reduced_params(params_np, "f32")
    rates = {}
    for B in (1, 8):
        med, times = _time_rollout(params, cfg, B, torch.float32)
        rates[B] = TIMED_STEPS / med
        log(f"[rollout] {CASE} f32 B={B}: {TIMED_STEPS} steps in median "
            f"{med:.4f} s of {[round(t, 4) for t in times]} -> "
            f"{TIMED_STEPS / med:.1f} steps/s, "
            f"{B * TIMED_STEPS / med:.1f} trajectory-steps/s, "
            f"{1e3 * med / TIMED_STEPS:.3f} ms/step")
    return rates


def phase_profile(case, params_np):
    """The f32 rollout at B=1 and B=8 under torch.profiler."""
    params = _reduced_params(params_np, "f32")
    for B in (1, 8):
        _profile_rollout(params, case.temporal, B, torch.float32,
                         f"f32 B={B}")


# (weights, KV cache, B) of the reduced-precision rollouts: the JAX CLI's
# int4 policy (bf16 cache) at B=1, int4 with the int8 cache at B=8, and
# int8 and bf16 weights with their auto f32 cache at B=1.
REDUCED_ROLLOUTS = [("int4", torch.bfloat16, 1), ("int4", torch.int8, 8),
                    ("int8", torch.float32, 1), ("bf16", torch.float32, 1)]


def phase_rollout_reduced(case, params_np):
    """250-step multiphase rollouts in the reduced-precision modes (median
    of 3 after a warm-up), and a torch.profiler pass over the two int4
    ones."""
    cfg = case.temporal
    trees = {}
    for mode, cache_dtype, B in REDUCED_ROLLOUTS:
        if mode not in trees:
            trees[mode] = _reduced_params(params_np, mode)
        med, times = _time_rollout(trees[mode], cfg, B, cache_dtype)
        label = f"{mode} weights, {str(cache_dtype)[6:]} cache, B={B}"
        log(f"[rollout-{mode}] {CASE} {label}: {TIMED_STEPS} steps in median "
            f"{med:.4f} s of {[round(t, 4) for t in times]} -> "
            f"{TIMED_STEPS / med:.1f} steps/s, "
            f"{B * TIMED_STEPS / med:.1f} trajectory-steps/s, "
            f"{1e3 * med / TIMED_STEPS:.3f} ms/step")
        if mode == "int4":
            _profile_rollout(trees[mode], cfg, B, cache_dtype, label)


# Clock cycles the card spins before a held timing (_device_ms): about
# 50 ms on an H100, longer than a slow host takes to enqueue 50 calls.
HOLD_CYCLES = 100_000_000


def _device_ms(fn, flush, iters=50, lead=1, hold=False):
    """Median device time of fn() in ms. Each call starts with L2 cold: a
    sum over 512 MB (~0.16 ms) runs first (a read, so no dirty lines are
    left to write back) and keeps the card busy while the host enqueues
    the call, so the events time the device, not the host. A call whose
    enqueue takes longer (autograd through a library op) asks for `lead`
    such sums in a row. `hold`: the card first spins for HOLD_CYCLES
    while the host enqueues every call, so no host delay can reach the
    events however slow the host is."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    for s, e in zip(starts, ends):
        for _ in range(lead):
            flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _library_ms(fn, flush):
    """_device_ms of a library call, warmed up, each call behind four
    flushes: SDPA's autograd backward (several kernels) can take longer to
    enqueue than one flush lasts, and its events then time the host."""
    _device_ms(fn, flush, iters=5, lead=4)
    return _device_ms(fn, flush, lead=4)


def _bound_ms(nbytes, flops, flop_rate=F32_FLOP_PER_S):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the operations over the peak of their type."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / flop_rate
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kernel_vs_plain(kernel, plain, flush):
    """Device ms of kernel and plain, warmed up, timed in turns plain,
    kernel, kernel, plain; returns (ms, plain_ms, the four runs)."""
    for fn in (plain, kernel):
        _device_ms(fn, flush, iters=5)  # warm-up
    runs = [_device_ms(fn, flush) for fn in (plain, kernel, kernel, plain)]
    return (runs[1] + runs[2]) / 2, (runs[0] + runs[3]) / 2, runs


def phase_time_kernel():
    """The decode kernel and its plain version at the check shapes, t = T-1
    (every key valid), in turns plain, kernel, kernel, plain; its bound and
    the one-query SDPA call."""
    from sea_tpu_torch.ops import decode_attention as DA
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    out = {}
    for shape in KERNEL_SHAPES:
        for dtype in KERNEL_TOL:
            q, K, V = _cases(shape, dtype)
            tt = torch.tensor([shape[2] - 1], dtype=torch.int32,
                              device="cuda")

            def kernel():
                DA.decode_attention(q, K, V, tt)

            def plain():
                DA.decode_attention_ref(q, K, V, tt)

            # The one-query SDPA call over the same cache (every key valid
            # at t = T-1): the library yardstick, never called by the port.
            q4, K4, V4 = q[:, :, None].to(dtype), K, V

            def library():
                torch.nn.functional.scaled_dot_product_attention(q4, K4, V4)

            ms, plain_ms, runs = _kernel_vs_plain(kernel, plain, flush)
            B, H, T, hd = shape
            nbytes = (2 * B * H * T * hd * K.element_size()
                      + 2 * B * H * hd * 4)
            bound, bound_by = _bound_ms(nbytes, 4 * B * H * T * hd)
            lib_ms = _device_ms(library, flush)
            out[(shape, dtype)] = dict(ms=ms, plain_ms=plain_ms,
                                       bound_ms=bound, bound_by=bound_by,
                                       library_ms=lib_ms)
            gbs = 2 * B * H * T * hd * K.element_size() / (ms * 1e-3) / 1e9
            log(f"[kernel-time] decode {shape} {str(dtype)[6:]} t=T-1, L2 "
                f"cold: kernel {ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}; "
                f"{gbs:.0f} GB/s of K/V), plain {plain_ms:.4f} ms "
                f"({runs[0]:.4f}, {runs[3]:.4f}), bound {bound:.4f} ms "
                f"({bound_by}), SDPA one query {lib_ms:.4f} ms")
    return out


# ---------------------------------------------------------------------------
# Training path: flash attention and fused AdaLN
# ---------------------------------------------------------------------------

def _flash_inputs(shape):
    B, Tq, Tk, H, hd = shape[:5]
    g = torch.Generator(device="cuda").manual_seed(B * Tq + Tk + hd)
    return [torch.randn(B, T, H, hd, device="cuda", generator=g)
            for T in (Tq, Tk, Tk, Tq)]


def _flash_kw(shape, rate):
    return dict(causal=shape[6], src_len=shape[5], dropout_rate=rate,
                dropout_seed=FLASH_SEED if rate else None)


def _err(a, b):
    return (a - b).abs().max().item()


def phase_flash_check():
    """Each flash kernel against its plain piece, and the autograd wrapper
    against autograd through the plain version: outputs, lse and
    dq/dk/dv, dropout 0 and 0.1."""
    from sea_tpu_torch.ops import flash_attention as FA
    worst = {"flash_fwd": 0.0, "flash_bwd_dq": 0.0, "flash_bwd_dkv": 0.0}
    for shape in FLASH_SHAPES:
        for rate in (0.0, 0.1):
            q, k, v, g = _flash_inputs(shape)
            kw = _flash_kw(shape, rate)
            o, lse = FA.flash_fwd(q, k, v, **kw)
            o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
            dsum = FA.row_dot(g, o_ref)
            dq = FA.flash_bwd_dq(q, k, v, g, lse_ref, dsum, **kw)
            dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse_ref, dsum, **kw)
            dq_ref = FA.flash_bwd_dq_ref(q, k, v, g, lse_ref, dsum, **kw)
            dk_ref, dv_ref = FA.flash_bwd_dkv_ref(q, k, v, g, lse_ref, dsum,
                                                  **kw)
            grads = []
            for fn in (FA.flash_attention, FA.flash_attention_ref):
                tq, tk, tv = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                out = fn(tq, tk, tv, **kw)
                out.backward(g)
                grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
            torch.cuda.synchronize()
            errs = {"flash_fwd": max(_err(o, o_ref), _err(lse, lse_ref),
                                     _err(grads[0][0], grads[1][0])),
                    "flash_bwd_dq": max(_err(dq, dq_ref),
                                        _err(grads[0][1], grads[1][1])),
                    "flash_bwd_dkv": max(_err(dk, dk_ref), _err(dv, dv_ref),
                                         _err(grads[0][2], grads[1][2]),
                                         _err(grads[0][3], grads[1][3]))}
            for name, err in errs.items():
                tol = FLASH_TOL["out" if name == "flash_fwd" else "grad"]
                if not err <= tol:
                    raise AssertionError(f"{name} {shape} rate={rate}: max "
                                         f"abs err {err} > {tol}")
                worst[name] = max(worst[name], err)
            log(f"[kernel] flash (B,Tq,Tk,H,hd,src_len,causal)={shape} "
                f"dropout={rate}: max abs err fwd {errs['flash_fwd']:.3g}"
                f" <= {FLASH_TOL['out']}, dq {errs['flash_bwd_dq']:.3g}, "
                f"dk/dv {errs['flash_bwd_dkv']:.3g} <= {FLASH_TOL['grad']}")
    return worst


# [mesh-kernels]: the global rows and positions a sharded call hashes with
# (``bh_map``, ``pos_off``), here a permutation of [0, 4 B H) cut to B H
# rows and offsets as a rank of a (data, model) grid or a ring step has.
MESH_POS_OFF = (37, 1001)


def _mesh_map(B, H, seed=0):
    g = torch.Generator().manual_seed(seed + B * H)
    return torch.randperm(4 * B * H, generator=g)[:B * H].to(
        torch.int32).cuda()


def phase_mesh_kernels():
    """The six flash entries (f32 and bf16 forward, dQ and dK/dV) with a
    permuted ``bh_map`` and position offsets against their plain versions
    on the same arguments, at FLASH_SHAPES, dropout 0.1: o, lse, dq, dk
    and dv within the kernels' tolerances (a dropout bit the two disagree
    on is off by about |v| / (1 - rate), far outside them); then one row
    block (batch row 1 of 2, the upper half of the heads) of an unsharded
    call against the call on that block alone with its bh_map, bit for
    bit; then the f32 and bf16 kernels at (2, 399, 8, 128) timed with the
    identity map and with the permuted one, in alternating rounds, each
    round's calls all enqueued before the card runs the first (the
    permuted call's argument checks take the host longer)."""
    from sea_tpu_torch.ops import flash_attention as FA
    worst = {}
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        for shape in FLASH_SHAPES:
            B, Tq, Tk, H = shape[:4]
            q, k, v, g = (x.to(dtype) for x in _flash_inputs(shape))
            kw = dict(_flash_kw(shape, 0.1), bh_map=_mesh_map(B, H),
                      pos_off=MESH_POS_OFF)
            o, lse = FA.flash_fwd(q, k, v, **kw)
            o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
            dsum = FA.row_dot(g, o_ref)
            dq = FA.flash_bwd_dq(q, k, v, g, lse_ref, dsum, **kw)
            dk, dv = FA.flash_bwd_dkv(q, k, v, g, lse_ref, dsum, **kw)
            dq_ref = FA.flash_bwd_dq_ref(q, k, v, g, lse_ref, dsum, **kw)
            dk_ref, dv_ref = FA.flash_bwd_dkv_ref(q, k, v, g, lse_ref, dsum,
                                                  **kw)
            torch.cuda.synchronize()
            pairs = {"flash_fwd": [(o, o_ref, "out")],
                     "flash_bwd_dq": [(dq, dq_ref, "grad")],
                     "flash_bwd_dkv": [(dk, dk_ref, "grad"),
                                       (dv, dv_ref, "grad")]}
            lse_err = _err(lse, lse_ref)
            if not lse_err <= 1e-5:
                raise AssertionError(f"[mesh-kernels] lse{sfx} {shape}: "
                                     f"{lse_err} > 1e-5")
            line = []
            for name, cases in pairs.items():
                errs = []
                for got, want, kind in cases:
                    if dtype == torch.bfloat16:
                        errs.append(_bf16_err(got, want, FLASH_BF16_REL[kind],
                                              FLASH_TOL[kind]))
                    else:
                        errs.append((_err(got, want), FLASH_TOL[kind]))
                for err, bound in errs:
                    if not err <= bound:
                        raise AssertionError(
                            f"[mesh-kernels] {name}{sfx} {shape} with a "
                            f"bh_map and pos_off {MESH_POS_OFF}: max abs "
                            f"err {err} > {bound}")
                key = name + sfx
                worst[key] = max(worst.get(key, 0.0), *(e for e, _ in errs))
                line.append(f"{key} {max(e for e, _ in errs):.3g}")
            # One row block of the unsharded call, alone with its bh_map.
            blk = None
            if B >= 2 and H % 2 == 0:
                full = dict(_flash_kw(shape, 0.1))
                o_f, lse_f = FA.flash_fwd(q, k, v, **full)
                dq_f = FA.flash_bwd_dq(q, k, v, g, lse_f, FA.row_dot(g, o_f),
                                       **full)
                dk_f, dv_f = FA.flash_bwd_dkv(q, k, v, g, lse_f,
                                              FA.row_dot(g, o_f), **full)
                h0 = H // 2
                part = [x[1:2, :, h0:].contiguous() for x in (q, k, v, g)]
                bh = (1 * H + torch.arange(h0, H, dtype=torch.int32)).cuda()
                sub = dict(full, bh_map=bh)
                o_b, lse_b = FA.flash_fwd(*part[:3], **sub)
                dsum_b = FA.row_dot(part[3], o_b)
                dq_b = FA.flash_bwd_dq(*part, lse_b, dsum_b, **sub)
                dk_b, dv_b = FA.flash_bwd_dkv(*part, lse_b, dsum_b, **sub)
                torch.cuda.synchronize()
                for got, whole in ((o_b, o_f), (dq_b, dq_f), (dk_b, dk_f),
                                   (dv_b, dv_f)):
                    if not torch.equal(got, whole[1:2, :, h0:]):
                        raise AssertionError(
                            f"[mesh-kernels] {dtype} {shape}: the block "
                            "call with its bh_map differs from the "
                            "unsharded call's block")
                lse_rows = lse_f.reshape(B, H, Tq)[1, h0:]
                if not torch.equal(lse_b, lse_rows):
                    raise AssertionError(f"[mesh-kernels] {dtype} {shape}: "
                                         "block lse differs")
                blk = "block (b=1, h>=H/2) bit-equal to the unsharded call"
            log(f"[mesh-kernels] {str(dtype)[6:]} (B,Tq,Tk,H,hd,src_len,"
                f"causal)={shape} dropout 0.1, permuted bh_map, pos_off "
                f"{MESH_POS_OFF}: max abs err {', '.join(line)}; lse "
                f"{lse_err:.3g}" + (f"; {blk}" if blk else ""))
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    shape = FLASH_SHAPES[0]
    B, H = shape[0], shape[3]
    for dtype, sfx in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        q, k, v, g = (x.to(dtype) for x in _flash_inputs(shape))
        ident = _flash_kw(shape, 0.1)
        perm = dict(ident, bh_map=_mesh_map(B, H), pos_off=MESH_POS_OFF)
        o, lse = FA.flash_forward_ref(q, k, v, **ident)
        dsum = FA.row_dot(g, o)
        fns = {"flash_fwd": lambda kw: FA.flash_fwd(q, k, v, **kw),
               "flash_bwd_dq": lambda kw: FA.flash_bwd_dq(
                   q, k, v, g, lse, dsum, **kw),
               "flash_bwd_dkv": lambda kw: FA.flash_bwd_dkv(
                   q, k, v, g, lse, dsum, **kw)}
        for name, fn in fns.items():
            for kw in (ident, perm):
                _device_ms(lambda kw=kw: fn(kw), flush, iters=5)
            # Four rounds, each map first in two of them (ABBA BAAB), so a
            # drift of the card's clock falls on both maps alike.
            runs = {"identity": [], "permuted": []}
            for first in (True, False, False, True):
                for which in (("identity", "permuted") if first else
                              ("permuted", "identity")):
                    kw = ident if which == "identity" else perm
                    runs[which].append(
                        _device_ms(lambda kw=kw: fn(kw), flush, hold=True))
            log(f"[mesh-kernels-time] {name}{sfx} (B,T,H,hd)=(2,399,8,128)"
                f" dropout 0.1, L2 cold, the card held while the host "
                f"enqueues, median of 4 rounds (each round's median of 50 "
                f"calls): " + ", ".join(
                    f"{which} {statistics.median(ms):.4f} ms ("
                    + ", ".join(f"{t:.4f}" for t in ms) + ")"
                    for which, ms in runs.items()))
    return worst


def _bf16_err(got, want, rel, atol):
    """(max abs err, its bound rel x max|want| + atol), bf16 read as f32."""
    if got.dtype != want.dtype:
        raise AssertionError(f"dtype {got.dtype}, plain {want.dtype}")
    return (_err(got.float(), want.float()),
            rel * want.float().abs().max().item() + atol)


def phase_flash_check_bf16():
    """The bf16 forms against their plain versions at FLASH_SHAPES (hd 8,
    16, 64, 128 and 256, square and ragged), dropout 0 and 0.1: each
    kernel alone and the autograd wrapper against autograd through the
    plain version (its bf16 pieces); a second backward call gives the
    same bits."""
    from sea_tpu_torch.ops import flash_attention as FA
    names = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")
    worst = dict.fromkeys(names, 0.0)
    for shape in FLASH_SHAPES:
        for rate in (0.0, 0.1):
            q, k, v, g = (x.to(torch.bfloat16) for x in _flash_inputs(shape))
            kw = _flash_kw(shape, rate)
            o, lse = FA.flash_fwd(q, k, v, **kw)
            o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
            dsum = FA.row_dot(g, o_ref)
            bwd = [(FA.flash_bwd_dq(q, k, v, g, lse_ref, dsum, **kw),
                    *FA.flash_bwd_dkv(q, k, v, g, lse_ref, dsum, **kw))
                   for _ in range(2)]
            ref = (FA.flash_bwd_dq_ref(q, k, v, g, lse_ref, dsum, **kw),
                   *FA.flash_bwd_dkv_ref(q, k, v, g, lse_ref, dsum, **kw))
            grads = []
            for fn in (FA.flash_attention, FA.flash_attention_ref):
                tq, tk, tv = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                out = fn(tq, tk, tv, **kw)
                out.backward(g)
                grads.append((out.detach(), tq.grad, tk.grad, tv.grad))
            torch.cuda.synchronize()
            if not all(torch.equal(a, b) for a, b in zip(*bwd)):
                raise AssertionError(f"bf16 flash backward {shape} "
                                     f"rate={rate}: a second call gave "
                                     "other bits")
            out_tol = (FLASH_BF16_REL["out"], FLASH_TOL["out"])
            grad_tol = (FLASH_BF16_REL["grad"], FLASH_TOL["grad"])
            pairs = {names[0]: [(o, o_ref, out_tol),
                                (grads[0][0], grads[1][0], out_tol)],
                     names[1]: [(bwd[0][0], ref[0], grad_tol),
                                (grads[0][1], grads[1][1], grad_tol)],
                     names[2]: [(bwd[0][1], ref[1], grad_tol),
                                (bwd[0][2], ref[2], grad_tol),
                                (grads[0][2], grads[1][2], grad_tol),
                                (grads[0][3], grads[1][3], grad_tol)]}
            lse_err = _err(lse, lse_ref)
            if not lse_err <= 1e-5:
                raise AssertionError(f"bf16 flash lse {shape} rate={rate}: "
                                     f"max abs err {lse_err} > 1e-5")
            line = []
            for name, cases in pairs.items():
                errs = [_bf16_err(a, b, *tol) for a, b, tol in cases]
                for err, bound in errs:
                    if not err <= bound:
                        raise AssertionError(
                            f"{name} {shape} rate={rate}: max abs err {err} "
                            f"> {bound}")
                worst[name] = max(worst[name], *(e for e, _ in errs))
                line.append(f"{name} {max(e for e, _ in errs):.3g} <= "
                            f"{min(b for _, b in errs):.3g}")
            log(f"[kernel] flash bf16 (B,Tq,Tk,H,hd,src_len,causal)={shape} "
                f"dropout={rate}: max abs err {', '.join(line)} (bounds "
                f"{FLASH_BF16_REL['out']:.3g} / {FLASH_BF16_REL['grad']:.3g}"
                f" x max|ref| + {FLASH_TOL['out']} / {FLASH_TOL['grad']}); "
                f"lse {lse_err:.3g} <= 1e-5; a second backward call "
                "bit-equal")
    return worst


def _adaln_inputs(shape, seed=0):
    B, T, E = shape
    g = torch.Generator(device="cuda").manual_seed(seed + E)
    x = torch.randn(B, T, E, device="cuda", generator=g) * 2 + 0.5
    cw = 1 + 0.1 * torch.randn(B, 1, E, device="cuda", generator=g)
    cb = 0.1 * torch.randn(B, 1, E, device="cuda", generator=g)
    w = 1 + 0.1 * torch.randn(E, device="cuda", generator=g)
    b = 0.1 * torch.randn(E, device="cuda", generator=g)
    gy = torch.randn(B, T, E, device="cuda", generator=g)
    return x, cw, cb, w, b, gy


def _within(got, want, tol):
    atol, rtol = tol
    return bool(((got - want).abs() <= atol + rtol * want.abs()).all())


def phase_adaln_check():
    """The fused AdaLN kernels against their plain versions: the output,
    the backward kernel's five outputs (dx, dcw, dcb, dw, db), and all
    five gradients through the autograd wrapper; a second call of each
    kernel gives the same bits, and each call is one device kernel
    (torch.profiler)."""
    from sea_tpu_torch.ops import fused_adaln as FAL
    worst = {"adaln_fwd": 0.0, "adaln_bwd": 0.0}
    for shape in ADALN_SHAPES:
        x, cw, cb, w, b, gy = _adaln_inputs(shape)
        first = [FAL.adaln_fwd(x, cw, cb, w, b),
                 *FAL.adaln_bwd(x, cw, gy, w)]
        again = [FAL.adaln_fwd(x, cw, cb, w, b),
                 *FAL.adaln_bwd(x, cw, gy, w)]
        if not all(torch.equal(a, r) for a, r in zip(first, again)):
            raise AssertionError(f"fused AdaLN {shape}: a second call gave "
                                 "other bits")
        pairs = {"adaln_fwd": [(first[0],
                                FAL.adaln_modulate_ref(x, cw, cb, w, b))],
                 "adaln_bwd": list(zip(first[1:],
                                       FAL.adaln_bwd_ref(x, cw, gy, w)))}
        grads = []
        for fn in (FAL.fused_adaln_modulate, FAL.adaln_modulate_ref):
            ts = [a.clone().requires_grad_(True) for a in (x, cw, cb, w, b)]
            fn(*ts).backward(gy)
            grads.append([a.grad for a in ts])
        pairs["adaln_bwd"] += list(zip(*grads))
        torch.cuda.synchronize()
        errs = {}
        for name, cases in pairs.items():
            tol = ADALN_TOL["out" if name == "adaln_fwd" else "grad"]
            if not all(_within(a, r, tol) for a, r in cases):
                raise AssertionError(f"{name} {shape}: outside (atol, rtol) "
                                     f"{tol}; max abs err "
                                     f"{max(_err(a, r) for a, r in cases)}")
            errs[name] = max(_err(a, r) for a, r in cases)
            worst[name] = max(worst[name], errs[name])
        names = [_one_kernel_a_call(lambda: FAL.adaln_fwd(x, cw, cb, w, b),
                                    f"adaln_fwd {shape}"),
                 _one_kernel_a_call(lambda: FAL.adaln_bwd(x, cw, gy, w),
                                    f"adaln_bwd {shape}")]
        log(f"[kernel] fused AdaLN (B,T,E)={shape}: max abs err fwd "
            f"{errs['adaln_fwd']:.3g} within (atol, rtol) "
            f"{ADALN_TOL['out']}, bwd (dx, dcw, dcb, dw, db, and the five "
            f"gradients through autograd) {errs['adaln_bwd']:.3g} within "
            f"{ADALN_TOL['grad']}; a second call bit-equal; one device "
            f"kernel a call {names}")
    return worst


def _launch_counts():
    """Every kernel's launch count, the microbenchmarks' (which no path
    runs) among them."""
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    from sea_tpu_torch.ops import quant_matmul as QM
    return {"decode_attention": DA.launches, "decode_q8": DA.launches_q8,
            "flash_fwd": FA.fwd_launches, "flash_bwd_dq": FA.dq_launches,
            "flash_bwd_dkv": FA.dkv_launches,
            "flash_fwd_bf16": FA.fwd_launches_bf16,
            "flash_bwd_dq_bf16": FA.dq_launches_bf16,
            "flash_bwd_dkv_bf16": FA.dkv_launches_bf16,
            "dropout_mask": FA.mask_launches, "int4_matvec": QM.launches,
            "adaln_fwd": FAL.fwd_launches, "adaln_bwd": FAL.bwd_launches,
            "adaln_fwd_bf16": FAL.fwd_launches_bf16,
            "adaln_bwd_bf16": FAL.bwd_launches_bf16,
            **{name: mod.launches[name] for mod in _tools_modules().values()
               for name in mod.launches}}


def _reset_launch_counts():
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    from sea_tpu_torch.ops import quant_matmul as QM
    DA.launches = DA.launches_q8 = 0
    FA.fwd_launches = FA.dq_launches = FA.dkv_launches = 0
    FA.fwd_launches_bf16 = FA.dq_launches_bf16 = FA.dkv_launches_bf16 = 0
    FA.mask_launches = 0
    QM.launches = 0
    FAL.fwd_launches = FAL.bwd_launches = 0
    FAL.fwd_launches_bf16 = FAL.bwd_launches_bf16 = 0
    for mod in _tools_modules().values():
        for name in mod.launches:
            mod.launches[name] = 0


def _train_schedule(case):
    """(train steps, evaluation forwards) of `temporal train --synthetic
    --epochs TRAIN_EPOCHS`, counted from the data's split and windows."""
    from sea_tpu_torch.cli import _load_data
    from sea_tpu_torch.data.datasets import (make_temporal_windows,
                                             split_indices)
    fields = _load_data(case, synthetic=True)[0]
    tr, T = fields.shape[:2]
    tt, split = case.temporal_train, case.temporal_split
    src_len = min(tt.dataset_src_len, T - 1)
    idx = split_indices(tr, split.train_fraction, split.val_fraction,
                        split.random_seed)

    def windows(n):
        z = np.zeros((n, T, 1, 1), np.float32)
        return len(make_temporal_windows(z, z, z[..., 0], src_len,
                                         tt.dataset_overlap))

    n_train = max(1, int(round(tr * split.train_fraction)))
    batch = min(tt.batch_size, n_train)
    steps = TRAIN_EPOCHS * (windows(len(idx[0])) // batch)
    val_epochs = [e for e in range(1, TRAIN_EPOCHS + 1)
                  if e % tt.validation_interval == 0 or e == TRAIN_EPOCHS]
    evals = len(val_epochs) * math.ceil(windows(len(idx[1]))
                                        / tt.eval_batch_size)
    if any(e % tt.full_eval_interval == 0 for e in val_epochs):
        raise AssertionError("the smoke run must not reach a full rollout "
                             "evaluation: its decode launches would mix in")
    return steps, evals


def _expected_train_launches(cfg, steps, evals, bf16):
    """The kernel launches of `temporal train` at ``steps`` train steps and
    ``evals`` evaluation forwards: each step's attentions through the
    flash forward, dQ and dK/dV (the bf16 forms under the bf16 policies)
    and its AdaLN sites through the AdaLN forward and backward (on bf16 x
    under those policies: the AdaLN counters count every launch and,
    apart, those on bf16 x), each evaluation forward's through the f32
    forwards."""
    attn = _attentions(cfg)[1]
    fwd, bwd = _adaln_sites(cfg)
    expected = dict.fromkeys(_launch_counts(), 0)
    if bf16:
        expected.update({"flash_fwd_bf16": attn * steps,
                         "flash_bwd_dq_bf16": attn * steps,
                         "flash_bwd_dkv_bf16": attn * steps,
                         "flash_fwd": attn * evals,
                         "adaln_fwd": fwd * (steps + evals),
                         "adaln_bwd": bwd * steps,
                         "adaln_fwd_bf16": fwd * steps,
                         "adaln_bwd_bf16": bwd * steps})
    else:
        expected.update({"flash_fwd": attn * (steps + evals),
                         "flash_bwd_dq": attn * steps,
                         "flash_bwd_dkv": attn * steps,
                         "adaln_fwd": fwd * (steps + evals),
                         "adaln_bwd": bwd * steps})
    return expected


def phase_train(case, save_dir, bf16=False):
    """`temporal train` through the port's CLI on the card. Per train step
    the G=2, one-layer model runs L*G^2 = 4 attentions (2 self, 2
    exchange) and L*(2G + G^2) + G = 10 AdaLN sites (ln_exp[i][0] x2,
    ln_cross x4, ln_exp[i][2] x2, ln_final x2), each forward and backward;
    an evaluation forward runs the forwards only. With bf16, the
    BF16_FLAGS recipe: a train step runs the bf16 flash kernels and the
    AdaLN kernels on bf16 x, an evaluation forward the f32 ones (f32 on
    the master weights), and the checkpoint's shadow is the bf16 cast of
    its parameters. After the f32 run, [train-profile-cli] runs the same
    command with --profile in a process of its own and reads the trace
    of its second epoch (``_profile_cli``). Returns the launch counts and
    that trace's (events, busy ms) a step (None under bf16)."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_full_checkpoint)
    from sea_tpu_torch.utils.params import to_numpy, tree_leaves
    label = "[train-bf16]" if bf16 else "[train]"
    tcfg = (dataclasses.replace(case.temporal_train, **BF16_RECIPE) if bf16
            else case.temporal_train)
    cfg = case.temporal
    attn, norms = _attentions(cfg)[1], _adaln_sites(cfg)[0]
    steps, evals = _train_schedule(case)
    argv = [TRAIN_CASE, "temporal", "train", "--synthetic", "--epochs",
            str(TRAIN_EPOCHS), "--save_dir", save_dir, "--device", "cuda"]
    _reset_launch_counts()
    t0 = time.perf_counter()
    params = cli.main(argv + (BF16_FLAGS if bf16 else []))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    expected = _expected_train_launches(cfg, steps, evals, bf16)
    if launches != expected:
        raise AssertionError(f"{label} launches {launches}, expected "
                             f"{expected}")
    logged = _read_metrics(Path(save_dir)
                           / f"{TRAIN_CASE}_temporal_train_metrics.csv")
    for e in range(1, TRAIN_EPOCHS + 1):
        for metric in ("Loss", "Grad_Norm", "Param_Norm"):
            if not np.isfinite(logged[("train", e, metric)]):
                raise AssertionError(f"epoch {e} train {metric} = "
                                     f"{logged[('train', e, metric)]}")
    if not np.isfinite(logged[("val", TRAIN_EPOCHS, "Loss")]):
        raise AssertionError("validation loss is not finite")
    path = checkpoint_path(save_dir, "temporal", case.run.case_name,
                           case.run.run_name)
    template = init_temporal(cfg, torch.Generator().manual_seed(0),
                             device="cpu")
    opt_template = to_numpy(make_optimizer(tcfg).init(template))
    loaded, opt, meta = load_full_checkpoint(path, to_numpy(template),
                                             opt_template)
    adam = None if opt is None else (opt.inner if bf16 else opt)[0]
    if adam is None or int(adam.count) != steps \
            or int(meta["epoch"]) != TRAIN_EPOCHS:
        raise AssertionError(f"checkpoint {path}: opt count "
                             f"{None if adam is None else adam.count}, "
                             f"meta {meta}")
    if not all(np.array_equal(a, b) for a, b in
               zip(tree_leaves(loaded), tree_leaves(params))):
        raise AssertionError("the checkpoint's params differ from the "
                             "returned best params")
    if bf16 and not all(
            np.array_equal(sh, torch.from_numpy(p).bfloat16().float().numpy())
            for sh, p in zip(tree_leaves(opt.shadow), tree_leaves(loaded))):
        raise AssertionError("the checkpoint's shadow is not the bf16 cast "
                             "of its params")
    per_step = (f"per step {attn} attentions x bf16 (fwd, dq, dkv) and "
                f"{norms} AdaLN sites x (fwd, bwd) on bf16" if bf16 else
                f"per step {attn} attentions x (fwd, dq, dkv) and {norms} "
                f"AdaLN sites x (fwd, bwd)")
    log(f"{label} {TRAIN_CASE} temporal train --synthetic --epochs "
        f"{TRAIN_EPOCHS}{' ' + ' '.join(BF16_FLAGS) if bf16 else ''}: "
        f"{steps} steps + {evals} evaluation forwards in "
        f"{seconds:.2f} s (data, encode, init, train, validate, save); "
        f"losses {[logged[('train', e, 'Loss')] for e in range(1, TRAIN_EPOCHS + 1)]}, "
        f"grad norms "
        f"{[logged[('train', e, 'Grad_Norm')] for e in range(1, TRAIN_EPOCHS + 1)]}, "
        f"val loss {logged[('val', TRAIN_EPOCHS, 'Loss')]}; checkpoint "
        f"{Path(path).name} read back (count {int(adam.count)}"
        f"{'; shadow = bf16(params)' if bf16 else ''}); launches "
        f"{launches} = {per_step}, per evaluation forward {attn} + {norms} "
        f"f32 forwards")
    if bf16:
        return launches, None
    return launches, _profile_cli(argv, Path(save_dir) / "profile", cfg,
                                  steps // TRAIN_EPOCHS)


# The port's kernels in a trace, by the function name nvcc gave them.
TRACE_KERNELS = {"flash_fwd": "fwd_kernel", "flash_bwd_dq": "dq_kernel",
                 "flash_bwd_dkv": "dkv_kernel",
                 "adaln_fwd": "adaln_fwd_kernel",
                 "adaln_bwd": "adaln_bwd_kernel"}
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _profile_cli(argv, profile_dir, cfg, steps):
    """[train-profile-cli]: `python -m sea_tpu_torch <argv> --profile
    <profile_dir>`, a fresh process as a user starts it (torch.profiler
    loses device events in a process that has run a while without a
    session, ROADMAP Queue 3), wrote one trace, of epoch 2 (its ``steps``
    train steps, no validation). Its device events of each of the port's
    f32 flash and AdaLN kernels (matched by their demangled names, as the
    trace gives them) must equal the per-step counts of
    _attentions/_adaln_sites times ``steps``. Returns (device events,
    busy ms) a step: kernels, copies and sets, as [train-profile] counts
    them."""
    cmd = [sys.executable, "-m", "sea_tpu_torch", *argv, "--profile",
           str(profile_dir)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300,
                          cwd=REPO)
    if proc.returncode != 0:
        raise AssertionError(f"[train-profile-cli] {' '.join(cmd[2:])} "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    files = sorted(p.name for p in profile_dir.iterdir())
    if files != ["train_epoch2.pt.trace.json"]:
        raise AssertionError(f"[train-profile-cli] {profile_dir} holds "
                             f"{files}, expected epoch 2's trace only")
    with open(profile_dir / files[0]) as fh:
        events = [e for e in json.load(fh)["traceEvents"]
                  if e.get("ph") == "X"
                  and e.get("cat") in DEVICE_CATEGORIES]
    attn = _attentions(cfg)[1]
    fwd, bwd = _adaln_sites(cfg)
    expected = {"flash_fwd": attn * steps, "flash_bwd_dq": attn * steps,
                "flash_bwd_dkv": attn * steps, "adaln_fwd": fwd * steps,
                "adaln_bwd": bwd * steps}
    found = {}
    for key, fn in TRACE_KERNELS.items():
        rx = re.compile(rf"(?<!\w){fn}(?!\w)")
        found[key] = sum(1 for e in events if e["cat"] == "kernel"
                         and rx.search(e["name"]))
    if found != expected:
        raise AssertionError(f"[train-profile-cli] kernels in the trace "
                             f"{found}, expected {expected}")
    per_step = len(events) / steps
    busy_ms = sum(e.get("dur", 0) for e in events) / steps / 1e3
    log(f"[train-profile-cli] python -m sea_tpu_torch {TRAIN_CASE} "
        f"temporal train --profile, a process of its own: "
        f"{files[0]} ({steps} steps, B x T of the synthetic windows); "
        f"port kernels {found} = per step {attn} attentions and "
        f"({fwd}, {bwd}) AdaLN sites x {steps}; {per_step:.1f} device "
        f"events/step, device busy {busy_ms:.3f} ms/step; {_smi()}")
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for e in events:
        by_name[e["name"]][0] += 1
        by_name[e["name"]][1] += e.get("dur", 0)
    for name, (n, us) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][1])[:8]:
        log(f"[train-profile-cli] {us / steps / 1e3:8.3f} ms/step "
            f"{n / steps:6.1f}/step {name[:90]}")
    return per_step, busy_ms


def _step_batch(cfg, B=2, T=399, seed=0):
    """Random latents [B, T, G, E], targets, and a constant ib."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*x.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, axis=1).astype(np.float32)
    return x, tgt, ib


def _step_fn(case, params_np, device, recipe=None, per_tensor=False):
    """A full-recipe train step of the case on device: time-constant ib
    (as the driver detects on the data), dropout on, AdamW; ``recipe``
    (BF16_RECIPE) overrides the TrainConfig's numerics; ``per_tensor``
    adds the per-tensor norms (log_per_tensor) to its stats."""
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_temporal import make_train_step
    from sea_tpu_torch.utils.params import from_numpy
    cfg = dataclasses.replace(case.temporal, ib_time_constant=True)
    tcfg = dataclasses.replace(case.temporal_train, **(recipe or {}))
    tx = make_optimizer(tcfg)
    params = from_numpy(params_np, device)
    state = tx.init(params)
    step = make_train_step(cfg, tx, compute_dtype=tcfg.compute_dtype,
                           per_tensor=per_tensor)
    batch = [torch.from_numpy(a).to(device) for a in _step_batch(cfg)]
    return cfg, step, params, state, batch


def phase_train_card_vs_cpu(case, params_np):
    """One full-width f32 step on the card and on the CPU, with the
    per-tensor norms of log_per_tensor ([train-per-tensor]); returns the
    card's stats (the bf16 check's reference)."""
    from sea_tpu_torch.train.metrics import read_norms
    from sea_tpu_torch.utils.params import to_numpy, tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    out, norms = {}, {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, step, params, state, batch = _step_fn(case, params_np, device,
                                                 per_tensor=True)
        params, state, stats = step(params, state, *batch, key)
        norms[device] = read_norms(stats.pop("tensors"))
        out[device] = (tree_leaves(to_numpy(params)),
                       {k: float(v) for k, v in stats.items()},
                       time.perf_counter() - t0)
    (pc, sc, _), (pp, sp, cpu_s) = out["cuda"], out["cpu"]
    loss_err = abs(sc["loss"] - sp["loss"]) / abs(sp["loss"])
    gn_err = abs(sc["grad_norm"] - sp["grad_norm"]) / sp["grad_norm"]
    p_err = max(float(np.abs(a - b).max()) for a, b in zip(pc, pp))
    moved = max(float(np.abs(a - b).max()) for a, b in
                zip(pp, tree_leaves(params_np)))
    if not (np.isfinite(sc["loss"]) and loss_err <= STEP_TOL["loss"]
            and gn_err <= STEP_TOL["grad_norm"]
            and p_err <= STEP_TOL["params"]):
        raise AssertionError(f"card vs CPU train step: loss rel err "
                             f"{loss_err}, grad_norm rel err {gn_err}, "
                             f"params max abs err {p_err}")
    log(f"[train-card-vs-cpu] one {TRAIN_CASE} step, B=2, T=399, dropout "
        f"{case.temporal.dropout}, {sum(a.size for a in pp)} parameters: "
        f"loss {sc['loss']:.7g} vs {sp['loss']:.7g} (rel {loss_err:.3g} <= "
        f"{STEP_TOL['loss']}), grad_norm {sc['grad_norm']:.7g} vs "
        f"{sp['grad_norm']:.7g} (rel {gn_err:.3g} <= "
        f"{STEP_TOL['grad_norm']}), updated params max abs err "
        f"{p_err:.3g} <= {STEP_TOL['params']} (largest move {moved:.3g}); "
        f"CPU step {cpu_s:.1f} s")
    _check_per_tensor(norms["cuda"], norms["cpu"], params_np, sp["grad_norm"])
    return sc


def _check_per_tensor(card, cpu, params_np, grad_norm):
    """[train-per-tensor]: the keys are Grad_Norm/ and Param_Norm/ over the
    npz paths of the checkpoint's params; each card norm is within
    STEP_TOL["grad_norm"] (relative) of the CPU's, plus 1e-7 of the
    global gradient norm (the gradient of a key projection's bias is
    zero up to rounding: softmax ignores a shift shared by every key)."""
    from sea_tpu_torch.utils.checkpoint import _flatten
    paths = set(_flatten(params_np))
    want = {f"{kind}/{p}" for kind in ("Grad_Norm", "Param_Norm")
            for p in paths}
    if set(card) != want or set(cpu) != want:
        raise AssertionError(f"[train-per-tensor] keys: card {len(card)}, "
                             f"CPU {len(cpu)}, npz paths {len(paths)}; "
                             f"{sorted(set(card) ^ want)[:5]}")
    atol = 1e-7 * grad_norm
    worst = max(((abs(card[k] - cpu[k]) - atol) / max(abs(cpu[k]), 1e-30),
                 k) for k in want)
    if worst[0] > STEP_TOL["grad_norm"]:
        raise AssertionError(f"[train-per-tensor] {worst[1]}: card "
                             f"{card[worst[1]]}, CPU {cpu[worst[1]]}")
    log(f"[train-per-tensor] one {TRAIN_CASE} step with per_tensor=True: "
        f"{len(want)} norms (Grad_Norm/ and Param_Norm/ over the "
        f"{len(paths)} npz paths), card vs CPU within rel "
        f"{STEP_TOL['grad_norm']} + {atol:.3g} (worst {worst[1]}: "
        f"{max(worst[0], 0.0):.3g})")


def _first_step_grads(state, b2):
    """[f64 gradient a leaf] of a first AdamW step's state: sign(mu)
    sqrt(nu / (1 - b2)), exact in f32 whatever mu's dtype."""
    from sea_tpu_torch.utils.params import tree_leaves
    adam = (state.inner if hasattr(state, "inner") else state)[0]
    return [np.sign(m.float().cpu().numpy()) * np.sqrt(
        n.cpu().numpy().astype(np.float64) / (1 - b2))
        for m, n in zip(tree_leaves(adam.mu), tree_leaves(adam.nu))]


def phase_train_card_vs_cpu_bf16(case, params_np, f32_stats):
    """One full-width step of the bf16 recipe on the card and on the CPU
    from the same weights, batch and key, held by BF16_NOISE and the
    first-step parameter bound (see BF16_NOISE); the card's shadow is the
    bf16 cast of its updated parameters bit for bit."""
    from sea_tpu_torch.utils.params import tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    tcfg = case.temporal_train
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, step, params, state, batch = _step_fn(case, params_np, device,
                                                 BF16_RECIPE)
        params, state, stats = step(params, state, *batch, key)
        shadow_ok = all(torch.equal(sh, p.to(torch.bfloat16)) for sh, p in
                        zip(tree_leaves(state.shadow), tree_leaves(params)))
        out[device] = ([p.cpu().numpy() for p in tree_leaves(params)],
                       {k: float(v) for k, v in stats.items()},
                       _first_step_grads(state, tcfg.betas[1]), shadow_ok,
                       time.perf_counter() - t0)
    (pc, sc, gc, shadow_ok, _), (pp, sp, gp, _, cpu_s) = (out["cuda"],
                                                        out["cpu"])
    errs = {}
    for k in ("loss", "grad_norm"):
        dc, dp = abs(sc[k] - f32_stats[k]), abs(sp[k] - f32_stats[k])
        tol = STEP_TOL[k] * abs(f32_stats[k])
        errs[k] = (dc, dp)
        if not (np.isfinite(sc[k]) and dc <= BF16_NOISE * dp + tol
                and dp <= BF16_NOISE * dc + tol):
            raise AssertionError(f"bf16 card vs CPU {k}: card {sc[k]}, CPU "
                                 f"{sp[k]}, f32 {f32_stats[k]}")
    lr, eps = tcfg.learning_rate, tcfg.eps
    worst, near = 0.0, 0
    for a, b, g_c, g_p in zip(pc, pp, gc, gp):
        du = np.abs(g_c / (np.abs(g_c) + eps) - g_p / (np.abs(g_p) + eps))
        diff = np.abs(a.astype(np.float64) - b)
        excess = diff - (STEP_TOL["params"] + lr * du)
        if (excess > 0).any():
            raise AssertionError(f"bf16 card vs CPU params: off by "
                                 f"{diff.max():.3g}, past the bound by "
                                 f"{excess.max():.3g}")
        worst = max(worst, float(diff.max()))
        near += int((du > 0.1).sum())
    if not shadow_ok:
        raise AssertionError("bf16 card step: the shadow is not the bf16 "
                             "cast of the updated params")
    log(f"[train-bf16-card-vs-cpu] one {TRAIN_CASE} step "
        f"{' '.join(BF16_FLAGS)}, B=2, T=399, dropout "
        f"{case.temporal.dropout}: loss {sc['loss']:.7g} vs "
        f"{sp['loss']:.7g} (f32 step {f32_stats['loss']:.7g}; distances "
        f"{errs['loss'][0]:.3g} / {errs['loss'][1]:.3g}, each <= "
        f"{BF16_NOISE} x the other + {STEP_TOL['loss']} rel), grad_norm "
        f"{sc['grad_norm']:.7g} vs {sp['grad_norm']:.7g} (f32 "
        f"{f32_stats['grad_norm']:.7g}); params max abs err {worst:.3g}, "
        f"each <= {STEP_TOL['params']} + lr |u(g_card) - u(g_cpu)| "
        f"({near} elements whose updates differ by over 0.1); shadow = "
        f"bf16(params) bit for bit; CPU step {cpu_s:.1f} s")


def phase_train_time(case, params_np, recipe=None, tag=None, what=None,
                     cli_trace=None):
    """Median wall ms of the full-recipe step over TRAIN_TIMED_STEPS steps
    after 3 warm-up steps, each ended by torch.cuda.synchronize(); peak
    device memory over them; then a torch.profiler pass over 5 steps.
    ``recipe`` (BF16_RECIPE): the bf16 step, as [train-time-bf16]; another
    recipe names its own ``tag`` and ``what``. ``cli_trace``: the (events,
    busy ms) a step of [train-profile-cli], logged beside this
    profile's."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.utils.prng import prng_key, split
    if tag is None:
        tag = "-bf16" if recipe else ""
        what = (" ".join(BF16_FLAGS) if recipe else "f32") + ", AdamW"
    _, step, params, state, batch = _step_fn(case, params_np, "cuda", recipe)
    B, T = batch[0].shape[:2]
    key = prng_key(0)

    def run(n):
        nonlocal params, state, key
        times = []
        for _ in range(n):
            key, step_key = split(key)
            t0 = time.perf_counter()
            params, state, stats = step(params, state, *batch, step_key)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        if not np.isfinite(float(stats["loss"])):
            raise AssertionError("train step loss is not finite")
        return times

    run(3)
    torch.cuda.reset_peak_memory_stats()
    times = run(TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    log(f"[train-time{tag}] {TRAIN_CASE} full-recipe step B={B}, T={T} "
        f"({what}, dropout {case.temporal.dropout}): median "
        f"{1e3 * med:.3f} "
        f"ms/step over {TRAIN_TIMED_STEPS} (min {1e3 * min(times):.3f}, "
        f"max {1e3 * max(times):.3f}) -> {B / med:.2f} windows/s, "
        f"{B * T / med:.1f} tokens/s (B x T positions, each G=2 fields); "
        f"peak device memory {peak / 2 ** 30:.3f} GiB")
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_prof)
        wall_us = 1e6 * (time.perf_counter() - t0) / n_prof
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / n_prof
    if not busy_us > 0:
        raise AssertionError("the profiler saw no device time")
    n_events = sum(e.count for e in events) / n_prof
    log(f"[train-profile{tag}] {n_events:.0f} "
        f"device events/step, device busy {busy_us / 1e3:.3f} ms/step, "
        f"profiled wall {wall_us / 1e3:.3f} ms/step, busy share "
        f"{100 * busy_us / wall_us:.1f}%")
    if cli_trace is not None:
        log(f"[train-profile-cli] the CLI's trace against this profile: "
            f"{cli_trace[0]:.1f} / {n_events:.1f} device events a step "
            f"(ratio {cli_trace[0] / n_events:.4f}), busy "
            f"{cli_trace[1]:.3f} / {busy_us / 1e3:.3f} ms a step (ratio "
            f"{cli_trace[1] * 1e3 / busy_us:.4f}); the CLI's steps run the "
            f"synthetic windows, this profile B={B}, T={T}")
    # The 14 largest, and the port's own kernels wherever they rank.
    ours = ("fwd_kernel", "bwd_kernel", "dq_kernel", "dkv_kernel")
    for i, e in enumerate(sorted(events,
                                 key=lambda e: -e.self_device_time_total)):
        if i >= 14 and not any(name in e.key for name in ours):
            continue
        us = e.self_device_time_total / n_prof
        log(f"[train-profile{tag}] {us / 1e3:8.3f} ms/step "
            f"{e.count / n_prof:6.1f}/step {100 * us / busy_us:5.1f}% "
            f"{e.key[:90]}")
    return med


def _read_metrics(path):
    """{(phase, epoch, metric): value} of a CSV tracker's file."""
    with open(path, newline="") as fh:
        return {(r["phase"], int(r["epoch"]), r["metric"]): float(r["value"])
                for r in csv.DictReader(fh)}


def phase_encoder_train(case, save_dir):
    """`encoder train` through the port's CLI on the card, then `temporal
    test` on the encoder it wrote (with random stage-2 weights). Stage 1
    launches none of the port's kernels; the serving run its decodes."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_spatial import process_data
    from sea_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_full_checkpoint,
                                                save_pytree)
    from sea_tpu_torch.utils.params import (opt_state_template, to_numpy,
                                            tree_leaves)
    _reset_launch_counts()
    t0 = time.perf_counter()
    params = cli.main([TRAIN_CASE, "encoder", "train", "--synthetic",
                       "--epochs", str(ENCODER_EPOCHS), "--save_dir",
                       save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    if any(launches.values()):
        raise AssertionError(f"[encoder-train] stage 1 launched {launches}")
    logged = _read_metrics(Path(save_dir)
                           / f"{TRAIN_CASE}_encoder_train_metrics.csv")
    checked = [("train", e, k) for e in range(1, ENCODER_EPOCHS + 1)
               for k in ("Loss", "Recon_Loss", "R2", "Grad_Norm",
                         "Param_Norm")]
    checked += [("val", ENCODER_EPOCHS, k) for k in ("Loss", "Recon_Loss",
                                                     "R2")]
    bad = [c for c in checked if not np.isfinite(logged[c])]
    if bad:
        raise AssertionError(f"[encoder-train] not finite: {bad}")
    sd = process_data(case, data=cli._load_data(case, synthetic=True))
    tcfg = case.spatial_train
    per_epoch = len(sd.train) // tcfg.batch_size
    template = to_numpy(init_spatial(sd.spatial_cfg,
                                     torch.Generator().manual_seed(0),
                                     device="cpu"))
    path = checkpoint_path(save_dir, "encoder_decoder", case.run.case_name,
                           case.run.run_name)
    loaded, opt, meta = load_full_checkpoint(
        path, template, opt_state_template(make_optimizer(tcfg), template))
    if opt is None or int(opt[0].count) != per_epoch * int(meta["epoch"]):
        raise AssertionError(f"[encoder-train] checkpoint {path}: opt "
                             f"{None if opt is None else opt[0].count}, "
                             f"meta {meta}")
    if not all(np.array_equal(a, b) for a, b in
               zip(tree_leaves(loaded), tree_leaves(params))):
        raise AssertionError("[encoder-train] the checkpoint's params "
                             "differ from the returned best params")
    save_pytree(checkpoint_path(save_dir, "temporal", case.run.case_name,
                                case.run.run_name),
                {"params": to_numpy(init_temporal(
                    case.temporal, torch.Generator().manual_seed(2),
                    device="cpu"))})
    _reset_launch_counts()
    results = cli.main([TRAIN_CASE, "temporal", "test", "--synthetic",
                        "--save_dir", save_dir, "--device", "cuda"])
    served = _launch_counts()
    if not (np.isfinite(results["encoded_rel_mse"])
            and np.isfinite(results["decoded_rel_mse"])
            and served["decode_attention"] > 0):
        raise AssertionError(f"[encoder-train] temporal test on the new "
                             f"encoder: {results}, launches {served}")
    epochs = range(1, ENCODER_EPOCHS + 1)
    log(f"[encoder-train] {TRAIN_CASE} encoder train --synthetic --epochs "
        f"{ENCODER_EPOCHS} (n_inp {sd.spatial_cfg.n_inp}, "
        f"{sum(a.size for a in tree_leaves(params))} parameters, "
        f"{per_epoch} steps of B={tcfg.batch_size} an epoch) in "
        f"{seconds:.2f} s; losses "
        f"{[logged[('train', e, 'Loss')] for e in epochs]}, R2 "
        f"{[logged[('train', e, 'R2')] for e in epochs]}, grad norms "
        f"{[logged[('train', e, 'Grad_Norm')] for e in epochs]}, val loss "
        f"{logged[('val', ENCODER_EPOCHS, 'Loss')]}; checkpoint "
        f"{Path(path).name} read back (epoch {int(meta['epoch'])}, count "
        f"{int(opt[0].count)}); port kernels launched: none. temporal test "
        f"on it: encoded rel-MSE {results['encoded_rel_mse']:.6g}, decoded "
        f"{results['decoded_rel_mse']:.6g}, {served['decode_attention']} "
        f"decodes")


def _encoder_step(device):
    """A full-recipe stage-1 step on device from the shipped trained
    weights: (step, params, state, batch, TrainConfig), the batch
    ENCODER_BATCH random tokens [B, 64, 3, n_inp]."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_spatial import make_train_step
    from sea_tpu_torch.utils.checkpoint import load_params
    from sea_tpu_torch.utils.params import from_numpy, to_numpy
    case = get_case(TRAIN_CASE)
    with np.load(REPO / SHIPPED_ENCODER) as f:
        n_inp = f["params/decoders/1/fc2/w"].shape[1]
    cfg = case.spatial.with_n_inp(n_inp)
    template = to_numpy(init_spatial(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    params = from_numpy(load_params(str(REPO / SHIPPED_ENCODER), template),
                        device)
    tx = make_optimizer(case.spatial_train)
    step = make_train_step(cfg, tx, compute_dtype="float32")
    n_patches = (case.mesh.m - 1) * (case.mesh.n - 1)
    n_fields = sum(len(g) for g in cfg.field_groups)
    x = np.random.RandomState(0).randn(ENCODER_BATCH, n_patches, n_fields,
                                       n_inp).astype(np.float32)
    return (step, params, tx.init(params), torch.from_numpy(x).to(device),
            case.spatial_train)


def phase_encoder_card_vs_cpu():
    """One f32 stage-1 step on the card and on the CPU from the same
    weights, batch and key (the bounds: the note above ENCODER_EPOCHS)."""
    from sea_tpu_torch.utils.params import tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        step, params, state, batch, tcfg = _encoder_step(device)
        params, state, stats = step(params, state, batch, key, 0)
        out[device] = ([p.detach().cpu().numpy()
                        for p in tree_leaves(params)],
                       {k: float(v) for k, v in stats.items()},
                       _first_step_grads(state, tcfg.betas[1]),
                       time.perf_counter() - t0)
    (pc, sc, gc, _), (pp, sp, gp, cpu_s) = out["cuda"], out["cpu"]
    errs = {k: abs(sc[k] - sp[k]) / abs(sp[k]) for k in ("loss",
                                                         "grad_norm")}
    if not (np.isfinite(sc["loss"]) and np.isfinite(sc["r2"])
            and errs["loss"] <= STEP_TOL["loss"]
            and errs["grad_norm"] <= STEP_TOL["grad_norm"]):
        raise AssertionError(f"[encoder-card-vs-cpu] card {sc}, CPU {sp}")
    lr, eps = tcfg.learning_rate, tcfg.eps
    worst, near = 0.0, 0
    for a, b, g_c, g_p in zip(pc, pp, gc, gp):
        du = np.abs(g_c / (np.abs(g_c) + eps) - g_p / (np.abs(g_p) + eps))
        diff = np.abs(a.astype(np.float64) - b)
        if (diff > STEP_TOL["params"] + lr * du).any():
            raise AssertionError(f"[encoder-card-vs-cpu] params off by "
                                 f"{diff.max():.3g}")
        worst = max(worst, float(diff.max()))
        near += int((du > 0.1).sum())
    log(f"[encoder-train] card vs CPU, one f32 step from {SHIPPED_ENCODER} "
        f"at B={ENCODER_BATCH}, TF32 off: loss {sc['loss']:.7g} vs "
        f"{sp['loss']:.7g} (rel {errs['loss']:.3g} <= {STEP_TOL['loss']}), "
        f"r2 {sc['r2']:.7g} vs {sp['r2']:.7g}, grad_norm "
        f"{sc['grad_norm']:.7g} vs {sp['grad_norm']:.7g} (rel "
        f"{errs['grad_norm']:.3g} <= {STEP_TOL['grad_norm']}), param_norm "
        f"{sc['param_norm']:.7g}; params max abs err {worst:.3g}, each <= "
        f"{STEP_TOL['params']} + lr |u(g_card) - u(g_cpu)| ({near} elements "
        f"whose updates differ by over 0.1); CPU step {cpu_s:.1f} s")


def phase_encoder_test(case, save_dir):
    """`encoder test` through the CLI on the card and on the CPU, on the
    encoder [encoder-train] wrote."""
    from sea_tpu_torch import cli
    got = {}
    for device in ("cuda", "cpu"):
        got[device] = cli.main([TRAIN_CASE, "encoder", "test", "--synthetic",
                                "--save_dir", save_dir, "--device", device])
    for k, v in got["cuda"].items():
        ref = got["cpu"][k]
        if not (np.isfinite(v) and abs(v - ref) <= ENCODER_TEST_RTOL
                * abs(ref)):
            raise AssertionError(f"[encoder-test] {k}: card {v}, CPU {ref}")
    log(f"[encoder-test] {TRAIN_CASE} encoder test --synthetic: card "
        f"{got['cuda']}, CPU {got['cpu']} (rtol {ENCODER_TEST_RTOL})")


def phase_encoder_train_time():
    """The f32 stage-1 step at the full cylinder recipe from the shipped
    weights: median wall ms over TRAIN_TIMED_STEPS after 3 warm-ups, each
    ended by torch.cuda.synchronize(); peak memory; a torch.profiler pass
    over 5 steps for device busy and events a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.utils.params import tree_leaves
    from sea_tpu_torch.utils.prng import prng_key, split
    step, params, state, batch, _ = _encoder_step("cuda")
    n_params = sum(p.numel() for p in tree_leaves(params))
    key, it = prng_key(0), 0

    def run(n):
        nonlocal params, state, key, it
        times = []
        for _ in range(n):
            key, step_key = split(key)
            t0 = time.perf_counter()
            params, state, stats = step(params, state, batch, step_key, it)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            it += 1
        if not np.isfinite(float(stats["loss"])):
            raise AssertionError("stage-1 train step loss is not finite")
        return times

    run(3)
    torch.cuda.reset_peak_memory_stats()
    times = run(TRAIN_TIMED_STEPS)
    peak = torch.cuda.max_memory_allocated()
    med = statistics.median(times)
    smi = _smi()
    B, P = batch.shape[:2]
    log(f"[encoder-train-time] {TRAIN_CASE} stage-1 f32 step B={B}, P={P}, "
        f"n_inp {batch.shape[-1]}, {n_params} parameters (pe table "
        f"included), AdamW: median {1e3 * med:.3f} ms/step over "
        f"{TRAIN_TIMED_STEPS} (min {1e3 * min(times):.3f}, max "
        f"{1e3 * max(times):.3f}) -> {B / med:.1f} snapshots/s; peak device "
        f"memory {peak / 2 ** 30:.3f} GiB; {smi}")
    n_prof = 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(n_prof)
        wall_us = 1e6 * (time.perf_counter() - t0) / n_prof
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in events) / n_prof
    if not busy_us > 0:
        raise AssertionError("the profiler saw no device time")
    log(f"[encoder-train-time] {sum(e.count for e in events) / n_prof:.0f} "
        f"device events/step, device busy {busy_us / 1e3:.3f} ms/step, "
        f"profiled wall {wall_us / 1e3:.3f} ms/step, busy share "
        f"{100 * busy_us / wall_us:.1f}%; {smi}")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
        us = e.self_device_time_total / n_prof
        log(f"[encoder-train-time] {us / 1e3:8.3f} ms/step "
            f"{e.count / n_prof:6.1f}/step {100 * us / busy_us:5.1f}% "
            f"{e.key[:90]}")
    return med


def _band_pairs(Tq, Tk, src_len):
    return sum(min(Tk, q + 1 + src_len) for q in range(Tq))


def _sdpa_backend(qt, kt, vt):
    """The backend PyTorch's dispatcher picks for this causal SDPA call
    (its forward and backward run the same backend's kernels)."""
    choose = getattr(torch, "_fused_sdp_choice", None)  # private API
    if choose is None:
        return "not reported by this PyTorch"
    from torch.nn.attention import SDPBackend
    return SDPBackend(choose(qt, kt, vt, is_causal=True)).name


def phase_time_flash(dtype=torch.float32):
    """The three flash kernels at the train step's shapes and the
    multiphase training shape (4, 199, 8, 256) against their plain pieces,
    their bounds and SDPA, at dropout 0 and 0.1 (the train step's). SDPA
    has no dropout here: its causal forward stands beside the forward
    kernel and its backward (dq, dk and dv in one call, over the graph of
    a forward taken outside the timing) beside the backward kernels, like
    for like at dropout 0. f32 bounds count the operations at the 3xTF32
    rate, with the count at the f32 CUDA-core peak beside it; the bf16
    forms' (dtype bfloat16, names with _bf16, SDPA on bf16) at the bf16
    tensor-core peak over 2-byte q, k, v, o and dO. The backend that
    served SDPA is named."""
    from sea_tpu_torch.ops import flash_attention as FA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    bf16 = dtype == torch.bfloat16
    suffix, elem = ("_bf16", 2) if bf16 else ("", 4)
    out = {}
    for shape in FLASH_SHAPES[:3]:
        B, Tq, Tk, H, hd, src_len, _ = shape
        q, k, v, g = (x.to(dtype) for x in _flash_inputs(shape))
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not g) for x in (q, k, v, g))
        graph_out = sdpa(qt, kt, vt, is_causal=True)

        def lib_forward():
            with torch.no_grad():
                sdpa(qt, kt, vt, is_causal=True)

        def lib_backward():
            torch.autograd.grad(graph_out, (qt, kt, vt), gt,
                                retain_graph=True)

        lib_fwd, lib_bwd = (_library_ms(fn, flush)
                            for fn in (lib_forward, lib_backward))
        pairs = B * H * _band_pairs(Tq, Tk, src_len)
        tensor = B * Tq * H * hd * elem
        rows = B * H * Tq * 4
        pieces = {}
        for rate in (0.0, 0.1):
            kw = _flash_kw(shape, rate)
            o, lse = FA.flash_forward_ref(q, k, v, **kw)
            dsum = FA.row_dot(g, o)
            pieces[("flash_fwd" + suffix, rate)] = (
                lambda kw=kw: FA.flash_fwd(q, k, v, **kw),
                lambda kw=kw: FA.flash_forward_ref(q, k, v, **kw),
                4 * tensor + rows, 4 * hd * pairs, lib_fwd)
            pieces[("flash_bwd_dq" + suffix, rate)] = (
                lambda kw=kw, lse=lse, dsum=dsum: FA.flash_bwd_dq(
                    q, k, v, g, lse, dsum, **kw),
                lambda kw=kw, lse=lse, dsum=dsum: FA.flash_bwd_dq_ref(
                    q, k, v, g, lse, dsum, **kw),
                5 * tensor + 2 * rows, 6 * hd * pairs, lib_bwd)
            pieces[("flash_bwd_dkv" + suffix, rate)] = (
                lambda kw=kw, lse=lse, dsum=dsum: FA.flash_bwd_dkv(
                    q, k, v, g, lse, dsum, **kw),
                lambda kw=kw, lse=lse, dsum=dsum: FA.flash_bwd_dkv_ref(
                    q, k, v, g, lse, dsum, **kw),
                6 * tensor + 2 * rows, 8 * hd * pairs, lib_bwd)
        for (name, rate), (kernel, plain, nbytes, flops, lib) in \
                pieces.items():
            ms, plain_ms, runs = _kernel_vs_plain(kernel, plain, flush)
            bound, bound_by = _bound_ms(
                nbytes, flops, BF16_FLOP_PER_S if bf16 else TF32X3_FLOP_PER_S)
            out[(name, hd, rate)] = dict(ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound, bound_by=bound_by,
                                         library_ms=lib)
            if bf16:
                beside = "bf16 tensor-core peak"
            else:
                f32_bound, f32_by = _bound_ms(nbytes, flops)
                beside = (f"3xTF32; at the f32 CUDA-core peak "
                          f"{f32_bound:.4f} ms, {f32_by}")
            log(f"[kernel-time] {name} (B,T,H,hd)=({B},{Tq},{H},{hd}) "
                f"dropout {rate}, L2 cold: kernel {ms:.4f} ms "
                f"({runs[1]:.4f}, {runs[2]:.4f}; "
                f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), plain "
                f"{plain_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}), bound "
                f"{bound:.4f} ms ({bound_by}; {beside}), SDPA "
                f"{'forward' if name.startswith('flash_fwd') else 'backward'}"
                f" {lib:.4f} ms")
        for rate in (0.0, 0.1):
            pair = (out[("flash_bwd_dq" + suffix, hd, rate)]["ms"]
                    + out[("flash_bwd_dkv" + suffix, hd, rate)]["ms"])
            log(f"[kernel-time] dQ + dK/dV{suffix} "
                f"(B,T,H,hd)=({B},{Tq},{H},{hd}) dropout {rate}: "
                f"{pair:.4f} ms "
                f"({14 * hd * pairs / (pair * 1e-3) / 1e12:.2f} TFLOP/s), "
                f"SDPA backward (no dropout) {lib_bwd:.4f} ms")
        log(f"[kernel-time] SDPA {str(dtype)[6:]} at "
            f"(B,T,H,hd)=({B},{Tq},{H},{hd}): backend "
            f"{_sdpa_backend(qt, kt, vt)}")
    return out


def phase_time_adaln():
    """The fused AdaLN kernels at the train step's shapes against their
    plain versions and their bounds (no single PyTorch call computes the
    modulate, so there is no library time)."""
    from sea_tpu_torch.ops import fused_adaln as FAL
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    out = {}
    for shape in ADALN_SHAPES:
        B, T, E = shape
        x, cw, cb, w, b, gy = _adaln_inputs(shape)
        row = B * T * E * 4
        pieces = {
            "adaln_fwd": (lambda: FAL.adaln_fwd(x, cw, cb, w, b),
                          lambda: FAL.adaln_modulate_ref(x, cw, cb, w, b),
                          2 * row + 2 * B * E * 4 + 2 * E * 4,
                          8 * B * T * E),
            "adaln_bwd": (lambda: FAL.adaln_bwd(x, cw, gy, w),
                          lambda: FAL.adaln_bwd_ref(x, cw, gy, w),
                          3 * row + 3 * B * E * 4 + 3 * E * 4,
                          16 * B * T * E)}
        for name, (kernel, plain, nbytes, flops) in pieces.items():
            ms, plain_ms, runs = _kernel_vs_plain(kernel, plain, flush)
            bound, bound_by = _bound_ms(nbytes, flops)
            out[(name, E)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                  bound_by=bound_by, library_ms=None)
            log(f"[kernel-time] {name} (B,T,E)={shape}, L2 cold: kernel "
                f"{ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}; "
                f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain "
                f"{plain_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}), bound "
                f"{bound:.4f} ms ({bound_by})")
    return out


def phase_time_reduced_kernels():
    """The int8-KV decode kernel at (1,8,250,256) and (8,8,250,256), t =
    T-1 (the JSON line keeps the second); the int4
    kernel at every (K, N) of the rollout step, M = 1 and 8, and its sum
    over a step's launches (the JSON line keeps (1,2048,16384), the MLP
    up-projection); the dense mask at the dropout verification's
    [8, 512, 512]: each against its plain version and its bound. Library calls: SDPA with one query over
    the dequantized bf16 cache; cuBLAS x_bf16 @ W_bf16 over the
    dequantized weight (the same product reading 4x the weight bytes); no
    single PyTorch call writes the mask."""
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import quant_matmul as QM
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    out = {}

    sdpa = torch.nn.functional.scaled_dot_product_attention
    for shape in Q8_SHAPES[:2]:
        B, H, T, hd = shape
        q, K8, V8, ks, vs = _q8_cases(shape)
        tt = torch.tensor([T - 1], dtype=torch.int32, device="cuda")
        q4 = q[:, :, None].to(torch.bfloat16)
        Kd = (K8.float() * ks[..., None]).to(torch.bfloat16)
        Vd = (V8.float() * vs[..., None]).to(torch.bfloat16)
        ms, plain_ms, runs = _kernel_vs_plain(
            lambda: DA.decode_attention(q, K8, V8, tt, k_scale=ks,
                                        v_scale=vs),
            lambda: DA.decode_attention_q8_ref(q, K8, V8, ks, vs, tt), flush)
        nbytes = 2 * B * H * T * hd + 2 * B * H * T * 4 + 2 * B * H * hd * 4
        # bf16 q times int8 keys, bf16 p*v_s times int8 values: bf16
        # operands.
        bound, bound_by = _bound_ms(nbytes, 4 * B * H * T * hd,
                                    BF16_FLOP_PER_S)
        lib = _device_ms(lambda: sdpa(q4, Kd, Vd), flush)
        if shape == Q8_SHAPES[1]:
            out["decode_q8"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                    bound_by=bound_by, library_ms=lib)
        log(f"[kernel-time] decode q8 {shape} t=T-1, L2 cold: kernel "
            f"{ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}; "
            f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain {plain_ms:.4f} "
            f"ms ({runs[0]:.4f}, {runs[3]:.4f}), bound {bound:.4f} ms "
            f"({bound_by}), SDPA one query over a bf16 dequantized cache "
            f"{lib:.4f} ms")

    step = {M: collections.Counter() for M in (1, 8)}
    for (K, N), per_step in INT4_SHAPES.items():
        for M in (1, 8):
            x, wp, s = _int4_cases(M, K, N)
            xb = x.to(torch.bfloat16)
            Wb = (QM.unpack_int4(wp, torch.float32) * s).to(torch.bfloat16)
            ms, plain_ms, runs = _kernel_vs_plain(
                lambda: QM.int4_matmul(x, wp, s),
                lambda: QM.int4_matvec_ref(x, wp, s), flush)
            nbytes = K // 2 * N + M * K * 4 + N * 4 + M * N * 4
            # bf16(x) times a nibble, exact in bf16: the bf16 tensor-core
            # peak.
            bound, bound_by = _bound_ms(nbytes, 2 * M * K * N,
                                        BF16_FLOP_PER_S)
            lib = _device_ms(lambda: xb @ Wb, flush)
            if (M, K, N) == (1, 2048, 16384):
                out["int4_matvec"] = dict(ms=ms, plain_ms=plain_ms,
                                          bound_ms=bound, bound_by=bound_by,
                                          library_ms=lib)
            step[M].update(ms=per_step * ms, bound=per_step * bound,
                           lib=per_step * lib,
                           weights=per_step * 1e3 * (K // 2) * N
                           / HBM_BYTES_PER_S)
            log(f"[kernel-time] int4 (M,K,N)=({M},{K},{N}), L2 cold: kernel "
                f"{ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}; "
                f"{nbytes / (ms * 1e-3) / 1e9:.0f} GB/s), plain "
                f"{plain_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}), bound "
                f"{bound:.4f} ms ({bound_by}), cuBLAS bf16 x bf16 over the "
                f"dequantized weight {lib:.4f} ms; {per_step} a step")
    for M, tot in step.items():
        log(f"[kernel-time] int4 a rollout step at M={M} "
            f"({sum(INT4_SHAPES.values())} launches): kernel "
            f"{1e3 * tot['ms']:.1f} us, bound {1e3 * tot['bound']:.1f} us "
            f"(the weights alone {1e3 * tot['weights']:.1f} us), cuBLAS "
            f"over the dequantized weights {1e3 * tot['lib']:.1f} us")

    B, T, H, _ = DROPOUT_SHAPE
    bh = torch.arange(B * H, dtype=torch.int32, device="cuda")
    seed = DROPOUT_SEEDS[0]
    ms, plain_ms, runs = _kernel_vs_plain(
        lambda: FA.dropout_mask_dense(B * H, T, T, seed, DROPOUT_RATE, "cuda",
                                      bh_map=bh),
        lambda: FA.dropout_mask_dense_ref(bh, T, T, seed, DROPOUT_RATE),
        flush)
    n = B * H * T * T
    # Bytes: the f32 mask written; operations: ~24 32-bit integer ops an
    # element (the keyed sum, two fmix32 rounds, the threshold), at the
    # CUDA cores' 32-bit rate.
    bound, bound_by = _bound_ms(4 * n + 4 * B * H, 24 * n)
    out["dropout_mask"] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                               bound_by=bound_by, library_ms=None)
    log(f"[kernel-time] dropout mask [{B * H}, {T}, {T}], L2 cold: kernel "
        f"{ms:.4f} ms ({runs[1]:.4f}, {runs[2]:.4f}; "
        f"{4 * n / (ms * 1e-3) / 1e9:.0f} GB/s), plain {plain_ms:.4f} ms "
        f"({runs[0]:.4f}, {runs[3]:.4f}), bound {bound:.4f} ms ({bound_by})")
    return out


# ---------------------------------------------------------------------------
# The exchange modes, the ib scalings, remat and the optimizers
# ---------------------------------------------------------------------------

# [serve-modes]: the multiphase width (E=2048, dd=1024, 8 heads) in the
# exchange modes other than sea, random seeded weights, B=1: every step of
# a MODE_ROLLOUT_STEPS rollout on the card against the CPU at
# ROLLOUT_ATOL, and pool at int4 weights with an int8 cache over the first
# ROLLOUT_STEPS_CHECKED at ROLLOUT_Q_ATOL (the bounds of [card-vs-cpu] and
# [card-vs-cpu-int4]).
MODE_ROLLOUT_STEPS = 32
SERVE_MODES = [("pool", {"exchange_mode": "pool",
                         "pool_update_method": "mlp"}),
               ("addition", {"exchange_mode": "addition"}),
               ("simple", {"exchange_mode": "simple"})]
# [train-modes]: the cylinder recipe's step (E=1024, T=399, B=2, dropout
# 0.1, AdaLN) in each variant, card against CPU at STEP_TOL.
TRAIN_MODES = [
    ("pool-linear", {"exchange_mode": "pool", "pool_update_method": "linear"}),
    ("pool-mlp", {"exchange_mode": "pool", "pool_update_method": "mlp"}),
    ("pool-pooling", {"exchange_mode": "pool",
                      "pool_update_method": "pooling"}),
    ("addition", {"exchange_mode": "addition"}),
    ("simple", {"exchange_mode": "simple"}),
    ("ib-fourier", {"ib_scale_mode": "fourier"}),
    ("ib-linear", {"ib_scale_mode": "linear"})]
# [train-remat]: the cylinder width at 4 layers (with one block the block
# recomputed is the whole peak, so remat could save nothing), B=4.
REMAT_LAYERS = 4
REMAT_BATCH = 4
REMAT_TIMED_STEPS = 5  # a median of 5: the run has a time limit
ADAFACTOR = {"optimizer": "adafactor"}


def _grads(params, cfg, batch, key):
    """(loss, [gradient a leaf]) of the train step's loss: the dropout
    forward's MSE, autograd to every leaf (zeros where none reaches)."""
    from sea_tpu_torch.models.temporal import temporal_forward
    from sea_tpu_torch.train import metrics as M
    from sea_tpu_torch.utils.params import tree_leaves
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    x, tgt, ib = batch
    loss = M.mse(temporal_forward(params, cfg, x, ib, rng=key,
                                  deterministic=False).float(), tgt)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for leaf in leaves:
        leaf.requires_grad_(False)
    return loss.detach(), [torch.zeros_like(p) if g is None else g
                           for p, g in zip(leaves, grads)]


def phase_serve_modes(case):
    """The scan rollout at the multiphase width in the pool (MLP update),
    addition and simple exchanges, card against CPU from the same seeded
    weights: every attention of every step one flash-decode launch (pool 4
    a step: 2 self, 2 pool; addition and simple 2), exact. Pool again with
    int4 weights (the port's quantizer, MSE scales, on the card) and an
    int8 cache: the decodes on the q8 kernel, every int4 linear (the pool
    update's fc1 [2048, 2048] and fc2 [2048, 1024] among them) on the int4
    matvec, exact."""
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.rollout.engine import rollout_scan
    from sea_tpu_torch.utils import precision as prec
    from sea_tpu_torch.utils.params import tree_map
    for name, change in SERVE_MODES:
        cfg = dataclasses.replace(case.temporal, **change)
        params = init_temporal(cfg, torch.Generator().manual_seed(3),
                               device="cpu")
        card = tree_map(lambda a: a.cuda(), params)
        runs = [(name, params, card, torch.float32, MODE_ROLLOUT_STEPS)]
        if name == "pool":
            q = prec.quantize_weights_int4(
                prec.fuse_attention_projections(card))
            runs.append(("pool int4 weights, int8 cache",
                         tree_map(lambda a: a.cpu(), q), q, torch.int8,
                         ROLLOUT_STEPS_CHECKED))
        per_step = _attentions(cfg)[0]
        for label, cpu_tree, card_tree, cache_dtype, n in runs:
            x0, ib = _rollout_inputs(cfg, 1, n, seed=5)
            on_cpu = rollout_scan(cpu_tree, cfg, x0, ib,
                                  cache_dtype=cache_dtype)
            _reset_launch_counts()
            t0 = time.perf_counter()
            on_card = rollout_scan(card_tree, cfg, x0.cuda(), ib.cuda(),
                                   cache_dtype=cache_dtype).cpu()
            seconds = time.perf_counter() - t0
            counts = _launch_counts()
            expected = dict.fromkeys(counts, 0)
            if cache_dtype == torch.int8:
                int4 = sum(_int4_sites_per_step(card_tree, cfg).values())
                expected["decode_q8"] = per_step * n
                expected["int4_matvec"] = int4 * n
                tol = ROLLOUT_Q_ATOL
            else:
                int4 = 0
                expected["decode_attention"] = per_step * n
                tol = ROLLOUT_ATOL
            if counts != expected:
                raise AssertionError(f"[serve-modes] {label}: launches "
                                     f"{counts}, expected {expected}")
            per_t = [_err(on_card[:, t], on_cpu[:, t]) for t in range(n)]
            err = max(per_t)
            if not (torch.isfinite(on_card).all() and err <= tol):
                raise AssertionError(f"[serve-modes] {label} card vs CPU: "
                                     f"max abs err {err}; per step {per_t}")
            log(f"[serve-modes] {CASE} width, {label}, B=1: {n} scan steps "
                f"in {seconds:.2f} s (first call); launches "
                f"{ {k: v for k, v in counts.items() if v} } = {per_step} "
                f"attentions and {int4} int4 linears x {n} steps; card vs "
                f"CPU max abs err {err:.3g} <= {tol} (steps 1, {n // 2}, "
                f"{n}: {per_t[0]:.3g}, {per_t[n // 2 - 1]:.3g}, "
                f"{per_t[-1]:.3g}; |y| max {on_cpu.abs().max().item():.3g})")
        del params, card, runs


def phase_train_modes(case):
    """One full-recipe cylinder step (B=2, T=399, dropout 0.1, AdaLN, time-
    constant ib, AdamW) in each TRAIN_MODES variant, seeded random weights,
    on the card and on the CPU: loss, grad norm and updated parameters at
    STEP_TOL, as [train-card-vs-cpu]; the card's flash forward, dQ and
    dK/dV launches (4 a step for pool and the sea variants, 2 for addition
    and simple) and AdaLN forwards and backwards exact."""
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.utils.params import to_numpy, tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    for name, change in TRAIN_MODES:
        mcase = case.replace(temporal=dataclasses.replace(case.temporal,
                                                          **change))
        params_np = to_numpy(init_temporal(
            mcase.temporal, torch.Generator().manual_seed(4), device="cpu"))
        out = {}
        for device in ("cuda", "cpu"):
            cfg, step, params, state, batch = _step_fn(mcase, params_np,
                                                       device)
            _reset_launch_counts()
            t0 = time.perf_counter()
            params, state, stats = step(params, state, *batch, key)
            out[device] = (tree_leaves(to_numpy(params)),
                           {k: float(v) for k, v in stats.items()},
                           _launch_counts(), time.perf_counter() - t0)
        (pc, sc, counts, card_s), (pp, sp, _, cpu_s) = (out["cuda"],
                                                        out["cpu"])
        attn = _attentions(cfg)[1]
        expected = _expected_train_launches(cfg, 1, 0, bf16=False)
        if counts != expected:
            raise AssertionError(f"[train-modes] {name}: launches {counts}, "
                                 f"expected {expected}")
        loss_err = abs(sc["loss"] - sp["loss"]) / abs(sp["loss"])
        gn_err = abs(sc["grad_norm"] - sp["grad_norm"]) / sp["grad_norm"]
        p_err = max(float(np.abs(a - b).max()) for a, b in zip(pc, pp))
        if not (np.isfinite(sc["loss"]) and loss_err <= STEP_TOL["loss"]
                and gn_err <= STEP_TOL["grad_norm"]
                and p_err <= STEP_TOL["params"]):
            raise AssertionError(f"[train-modes] {name} card vs CPU: loss "
                                 f"rel err {loss_err}, grad_norm rel err "
                                 f"{gn_err}, params max abs err {p_err}")
        log(f"[train-modes] {TRAIN_CASE} {name} ({change}), B=2, T=399, "
            f"{sum(a.size for a in pp)} parameters: loss {sc['loss']:.7g} "
            f"vs {sp['loss']:.7g} (rel {loss_err:.3g}), grad_norm "
            f"{sc['grad_norm']:.7g} vs {sp['grad_norm']:.7g} (rel "
            f"{gn_err:.3g}), params max abs err {p_err:.3g} (STEP_TOL "
            f"{STEP_TOL}); launches a step: flash fwd/dq/dkv {attn} each, "
            f"AdaLN fwd {expected['adaln_fwd']}, bwd "
            f"{expected['adaln_bwd']}; card step {card_s:.2f} s (first "
            f"call), CPU {cpu_s:.1f} s")


def phase_train_remat(case):
    """The cylinder width at REMAT_LAYERS layers, B=REMAT_BATCH, T=399,
    dropout 0.1, remat False, "full" and "dots": the loss and every
    gradient of one step from the same weights, batch and key against
    remat=False's on the card (reported; held to the gradient bounds of
    tests/test_torch_train.py); the flash forwards of a step doubled under
    both remat policies (the backward recomputes each block's forward),
    dQ and dK/dV not; the peak device memory of that forward and backward;
    then the AdamW step's median wall ms over REMAT_TIMED_STEPS (after 2
    warm-up steps), its peak memory and device busy ms a step
    (torch.profiler over 3). Both peaks must be lower under "full" than
    without remat: what remat trades time for. (AdamW updates in groups
    of leaves, train/optim.py, so its temporaries do not set the step's
    peak.)"""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_temporal import make_train_step
    from sea_tpu_torch.utils.params import from_numpy, to_numpy
    from sea_tpu_torch.utils.prng import fold_in, prng_key, split
    base = dataclasses.replace(case.temporal, num_layers=REMAT_LAYERS,
                               ib_time_constant=True)
    params_np = to_numpy(init_temporal(base, torch.Generator().manual_seed(5),
                                       device="cpu"))
    batch = [torch.from_numpy(a).cuda()
             for a in _step_batch(base, B=REMAT_BATCH)]  # x, tgt, ib
    key = fold_in(prng_key(0), 1)
    attn = _attentions(base)[1]
    ref = None
    rows = {}
    for remat in (False, "full", "dots"):
        cfg = dataclasses.replace(base, remat=remat)
        params = from_numpy(params_np, "cuda")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launch_counts()
        loss, grads = _grads(params, cfg, batch, key)
        torch.cuda.synchronize()
        fb_peak = torch.cuda.max_memory_allocated()
        counts = _launch_counts()
        want = {"flash_fwd": attn * (2 if remat else 1),
                "flash_bwd_dq": attn, "flash_bwd_dkv": attn}
        if any(counts[k] != v for k, v in want.items()):
            raise AssertionError(f"[train-remat] remat={remat!r}: launches "
                                 f"{counts}, expected {want}")
        grads = [g.cpu().numpy() for g in grads]
        if ref is None:
            ref = (float(loss), grads)
            diff = (0.0, 0.0)
        else:
            scale = float(np.sqrt(sum(float(np.sum(g.astype(np.float64)
                                                   ** 2)) for g in ref[1])))
            diff = (abs(float(loss) - ref[0]),
                    max(float(np.abs(a - b).max())
                        for a, b in zip(grads, ref[1])))
            bad = [i for i, (a, b) in enumerate(zip(grads, ref[1]))
                   if not np.allclose(a, b, rtol=1e-4, atol=1e-7 * scale)]
            if diff[0] > 1e-5 * abs(ref[0]) or bad:
                raise AssertionError(f"[train-remat] remat={remat!r}: loss "
                                     f"off by {diff[0]}, gradients of "
                                     f"{len(bad)} leaves off (max {diff[1]})")
        del params, grads, loss
        torch.cuda.empty_cache()
        tx = make_optimizer(case.temporal_train)
        params = from_numpy(params_np, "cuda")
        state = tx.init(params)
        step = make_train_step(cfg, tx)
        k = prng_key(1)

        def run(n):
            nonlocal params, state, k
            times = []
            for _ in range(n):
                k, sk = split(k)
                t0 = time.perf_counter()
                params, state, stats = step(params, state, *batch, sk)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t0)
            if not np.isfinite(float(stats["loss"])):
                raise AssertionError(f"[train-remat] remat={remat!r}: loss "
                                     f"{float(stats['loss'])}")
            return times
        run(2)
        torch.cuda.reset_peak_memory_stats()
        times = run(REMAT_TIMED_STEPS)
        peak = torch.cuda.max_memory_allocated()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run(3)
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA) / 3 / 1e3
        med = statistics.median(times)
        rows[remat] = (med, fb_peak, peak, busy)
        log(f"[train-remat] {TRAIN_CASE} width, {REMAT_LAYERS} layers, "
            f"B={REMAT_BATCH}, T=399, remat={remat!r}: loss and gradients "
            f"vs remat=False max abs diff {diff[0]:.3g} / {diff[1]:.3g}; "
            f"flash launches a step fwd {counts['flash_fwd']}, dq "
            f"{counts['flash_bwd_dq']}, dkv {counts['flash_bwd_dkv']}; "
            f"forward + backward peak device memory "
            f"{fb_peak / 2 ** 30:.3f} GiB; AdamW step median "
            f"{1e3 * med:.3f} ms over {REMAT_TIMED_STEPS} (min "
            f"{1e3 * min(times):.3f}, max {1e3 * max(times):.3f}), device "
            f"busy {busy:.3f} ms, step peak {peak / 2 ** 30:.3f} GiB")
        del params, state, step, tx
        torch.cuda.empty_cache()
    for i, what in ((1, "forward + backward"), (2, "AdamW step")):
        if not rows["full"][i] < rows[False][i]:
            raise AssertionError(f"[train-remat] {what} peak under 'full' "
                                 f"{rows['full'][i]} not below "
                                 f"remat=False's {rows[False][i]}")
    return rows


def _optimizer_time(case, params_np, recipe):
    """The optimizer's update alone on the card at the cylinder model's
    86M parameters (random gradients of each leaf's shape): device ms by
    CUDA events, median of TRAIN_TIMED_STEPS after 3 warm-up updates, and
    a torch.profiler pass over 5 (device events and busy ms an update).
    Returns (ms, events, busy ms)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.params import from_numpy, tree_leaves
    tx = make_optimizer(dataclasses.replace(case.temporal_train, **recipe))
    params = from_numpy(params_np, "cuda")
    state = tx.init(params)
    gen = torch.Generator(device="cuda").manual_seed(0)
    grads = [1e-3 * torch.randn(p.shape, generator=gen, device="cuda")
             for p in tree_leaves(params)]

    def update(n):
        nonlocal state
        for _ in range(n):
            state = tx.step(grads, state, params)
    update(3)
    torch.cuda.synchronize()
    ms = []
    for _ in range(TRAIN_TIMED_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        update(1)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        update(5)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 5 / 1e3
    return (statistics.median(ms), sum(e.count for e in events) / 5, busy)


def phase_train_optim(case, params_np):
    """Adafactor and the linear schedule on the card:

    - `temporal train --synthetic --epochs 2 --optimizer adafactor` through
      the CLI, then with `--compute_dtype bf16_shadow` too: launch counts
      as [train] and [train-bf16], the checkpoint's optimizer state read
      back through opt_state_template (its count the steps'), and a
      --model_path resume that prints "Restored optimizer state" and goes
      on counting;
    - one full-recipe Adafactor step on the card against the CPU: the loss,
      the grad norm and every gradient (at the bounds of
      tests/test_torch_train.py), then the card's update of the card's
      gradients against the CPU's update of the same gradients (the first
      Adafactor update turns a gradient's sign into +-lr down to |g| ~
      1e-15, so updates from two sides' own noise-level gradients may
      differ by 2 lr where the gradients agree);
    - scheduler="linear" (epoch_num 4): the learning rate of steps 0-2
      is 0.1 lr + 0.9 lr k / 4 to 1e-6 (the schedule rounds in f32, as
      optax does), and the first step equals a step at the formula's
      constant learning rate, every parameter within an f32 ulp of itself
      (a rounding-level change of lr moves p - lr u across a rounding
      boundary of p) plus 1e-6 lr;
    - the optimizer's update timed alone, Adafactor beside AdamW
      (_optimizer_time), and the whole Adafactor step as [train-time]."""
    import contextlib
    import io
    from sea_tpu_torch import cli
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_full_checkpoint)
    from sea_tpu_torch.utils.params import (from_numpy, opt_state_template,
                                            save_init_checkpoints, to_numpy,
                                            tree_leaves)
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    steps, evals = _train_schedule(case)
    template = to_numpy(init_temporal(case.temporal,
                                      torch.Generator().manual_seed(0),
                                      device="cpu"))
    for flags, recipe in (([], ADAFACTOR),
                          (["--compute_dtype", "bf16_shadow"],
                           {**ADAFACTOR,
                            "compute_dtype": "bfloat16_shadow"})):
        bf16 = bool(flags)
        tcfg = dataclasses.replace(case.temporal_train, **recipe)
        with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
            save_init_checkpoints(case, save_dir, seed=1)
            argv = [TRAIN_CASE, "temporal", "train", "--synthetic",
                    "--save_dir", save_dir, "--device", "cuda",
                    "--optimizer", "adafactor"] + flags
            _reset_launch_counts()
            t0 = time.perf_counter()
            cli.main(argv + ["--epochs", str(TRAIN_EPOCHS)])
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = _launch_counts()
            expected = _expected_train_launches(case.temporal, steps, evals,
                                                bf16)
            if launches != expected:
                raise AssertionError(f"[train-optim] {' '.join(flags)} "
                                     f"launches {launches}, expected "
                                     f"{expected}")
            path = checkpoint_path(save_dir, "temporal", case.run.case_name,
                                   case.run.run_name)

            def factored(p):
                _, opt, _ = load_full_checkpoint(
                    p, template, opt_state_template(make_optimizer(tcfg),
                                                    template))
                return (opt.inner if bf16 else opt)[0]
            count = int(factored(path).count)
            if count != steps:
                raise AssertionError(f"[train-optim] checkpoint count "
                                     f"{count}, {steps} steps")
            printed = io.StringIO()
            with contextlib.redirect_stdout(printed):
                cli.main(argv + ["--epochs", "1", "--model_path", path])
            resumed = int(factored(path).count)
            if "Restored optimizer state" not in printed.getvalue() \
                    or resumed != steps + steps // TRAIN_EPOCHS:
                raise AssertionError(f"[train-optim] resume: count "
                                     f"{resumed}; printed "
                                     f"{printed.getvalue()[-2000:]}")
        log(f"[train-optim] {TRAIN_CASE} temporal train --synthetic --epochs "
            f"{TRAIN_EPOCHS} --optimizer adafactor {' '.join(flags)}: "
            f"{steps} steps + {evals} evaluation forwards in {seconds:.2f} "
            f"s; launches as [train{'-bf16' if bf16 else ''}] "
            f"({ {k: v for k, v in launches.items() if v} }); checkpoint's "
            f"FactoredState read back through the template (count {count});"
            f" --model_path resume printed \"Restored optimizer state\", "
            f"count {count} -> {resumed}")

    # One full-recipe Adafactor step, card vs CPU.
    tcfg = dataclasses.replace(case.temporal_train, **ADAFACTOR)
    cfg = dataclasses.replace(case.temporal, ib_time_constant=True)
    key = fold_in(prng_key(0), 1)
    side = {}
    for device in ("cuda", "cpu"):
        params = from_numpy(params_np, device)
        batch = [torch.from_numpy(a).to(device) for a in _step_batch(cfg)]
        loss, grads = _grads(params, cfg, batch, key)
        side[device] = (float(loss), [g.cpu().numpy() for g in grads])
    (lc, gc), (lp, gp) = side["cuda"], side["cpu"]
    scale = float(np.sqrt(sum(float(np.sum(g.astype(np.float64) ** 2))
                              for g in gp)))
    bad = [i for i, (a, b) in enumerate(zip(gc, gp))
           if not np.allclose(a, b, rtol=1e-4, atol=1e-7 * scale)]
    loss_err = abs(lc - lp) / abs(lp)
    if loss_err > STEP_TOL["loss"] or bad:
        raise AssertionError(f"[train-optim] card vs CPU: loss rel err "
                             f"{loss_err}, {len(bad)} gradient leaves off")
    updated = {}
    for device in ("cuda", "cpu"):
        tx = make_optimizer(tcfg)
        params = from_numpy(params_np, device)
        state = tx.init(params)
        tx.step([torch.from_numpy(g).to(device) for g in gc], state, params)
        updated[device] = tree_leaves(to_numpy(params))
    p_err = max(float(np.abs(a - b).max())
                for a, b in zip(updated["cuda"], updated["cpu"]))
    moved = max(float(np.abs(a - b).max())
                for a, b in zip(updated["cpu"], tree_leaves(params_np)))
    if p_err > STEP_TOL["params"]:
        raise AssertionError(f"[train-optim] Adafactor update card vs CPU "
                             f"off by {p_err}")
    log(f"[train-optim] one {TRAIN_CASE} Adafactor step, B=2, T=399, dropout "
        f"{case.temporal.dropout}: loss {lc:.7g} vs {lp:.7g} (rel "
        f"{loss_err:.3g} <= {STEP_TOL['loss']}), every gradient within rtol "
        f"1e-4 + 1e-7 x |g| ({scale:.4g}); the update of the card's "
        f"gradients card vs CPU max abs err {p_err:.3g} <= "
        f"{STEP_TOL['params']} (largest move {moved:.3g})")

    # The linear schedule against the formula, three steps.
    lr = case.temporal_train.learning_rate
    sched_cfg = dataclasses.replace(case.temporal_train, scheduler="linear",
                                    epoch_num=4)
    runs = {}
    for kind in ("schedule", "formula"):
        tx = make_optimizer(sched_cfg if kind == "schedule"
                            else case.temporal_train)
        params = from_numpy(params_np, "cuda")
        state = tx.init(params)
        batch = [torch.from_numpy(a).cuda() for a in _step_batch(cfg)]
        used, first = [], None
        for k in range(3):
            if kind == "formula":
                tx.lr = 0.1 * lr + 0.9 * lr * k / sched_cfg.epoch_num
            used.append(tx.lr(k) if callable(tx.lr) else tx.lr)
            _, grads = _grads(params, cfg, batch, fold_in(key, k))
            state = tx.step(grads, state, params)
            if first is None:  # copies (a CPU tensor's numpy is a view)
                first = [a.copy() for a in tree_leaves(to_numpy(params))]
        runs[kind] = (first, used)
    lr_err = max(abs(a - b) / b for a, b in zip(runs["schedule"][1],
                                                 runs["formula"][1]))
    s_err, excess = 0.0, 0.0
    for a, b in zip(runs["schedule"][0], runs["formula"][0]):
        diff = np.abs(a - b)
        s_err = max(s_err, float(diff.max()))
        excess = max(excess, float((diff - np.spacing(np.abs(b))
                                    - 1e-6 * lr).max()))
    if lr_err > 1e-6 or excess > 0:
        raise AssertionError(f"[train-optim] linear schedule vs formula: "
                             f"lr {runs['schedule'][1]} vs "
                             f"{runs['formula'][1]}; first step's params "
                             f"off by {s_err}, past the bound by {excess}")
    log(f"[train-optim] scheduler=linear, epoch_num 4: learning rates of "
        f"steps 0-2 {runs['schedule'][1]} (0.1 lr + 0.9 lr k/4: "
        f"{runs['formula'][1]}; rel err {lr_err:.3g} <= 1e-6: optax's f32 "
        f"arithmetic); the first step's params vs the formula's max abs "
        f"err {s_err:.3g}, each within an f32 ulp of itself + 1e-6 lr")

    # The update alone, then the whole step.
    smi = _smi()
    times = {name: _optimizer_time(case, params_np, recipe) for name, recipe
             in (("AdamW", {}), ("Adafactor", ADAFACTOR))}
    for name, (ms, events, busy) in times.items():
        log(f"[train-optim-time] {name} update of the {TRAIN_CASE} model "
            f"({sum(a.size for a in tree_leaves(params_np))} parameters, "
            f"{len(tree_leaves(params_np))} leaves): {ms:.3f} ms by CUDA "
            f"events (median of {TRAIN_TIMED_STEPS}), {events:.0f} device "
            f"events, device busy {busy:.3f} ms; {smi}")
    phase_train_time(case, params_np, ADAFACTOR, tag="-adafactor",
                     what="f32, Adafactor")
    return times


ARTIFACT_RTOL = 1e-5


def _captured(fn, *args, **kwargs):
    """(fn's result, what it printed); the print is passed on."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    sys.stdout.write(buf.getvalue())
    return out, buf.getvalue()


def phase_serve_artifacts(case, save_dir, params_np):
    """[serve-artifacts]: at the multiphase width, on [serve]'s synthetic
    test split and weights, full_autoregressive_evaluation (rollout on the
    card, decode through the latent service, un-patch and score on the
    host) against fused_autoregressive_evaluation (all on the card): the
    rel MSEs within ARTIFACT_RTOL, each run's decode launches one a step
    per attention (scan engine, as [serve]), the rollout CSV written, and
    the plots drawn or their one skip line printed."""
    from sea_tpu_torch.cli import _load_data, fit_to_data
    from sea_tpu_torch.rollout.engine import select_engine
    from sea_tpu_torch.train import evaluate as E
    from sea_tpu_torch.train.train_temporal import process_data
    from sea_tpu_torch.utils.params import from_numpy
    case = case.replace(run=dataclasses.replace(case.run,
                                                save_dir=str(save_dir)))
    data = _load_data(case, synthetic=True)
    case = fit_to_data(case, data)
    td = process_data(case, data=data, device="cuda")
    params = from_numpy(params_np, "cuda")
    B, T_roll = td.test.src.shape[:2]
    engine = select_engine(case.temporal, B, T_roll, params)
    if engine != "scan":
        raise AssertionError(f"[serve-artifacts] auto picked {engine}")
    run = case.run
    csv_path = Path(save_dir) / (f"rollout_error_{run.case_name}_"
                                 f"{run.run_name}.csv")
    plots = [f"rollout_error_{run.case_name}_{run.run_name}.png"]
    results = {}
    for name in ("full", "fused"):
        csv_path.unlink(missing_ok=True)
        for p in Path(save_dir).glob("temporal_*_data_*_0.png"):
            p.unlink()
        fn = getattr(E, f"{name}_autoregressive_evaluation")
        _reset_launch_counts()
        t0 = time.perf_counter()
        res, printed = _captured(fn, params, case, td.test,
                                 td.latent_service, td.mesh_processor)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        counts = _launch_counts()
        expected = dict.fromkeys(counts, 0)
        expected["decode_attention"] = _attentions(case.temporal)[0] * T_roll
        if counts != expected:
            raise AssertionError(f"[serve-artifacts] {name} launched "
                                 f"{counts}, expected {expected}")
        drawn = sorted(p.name for p in Path(save_dir).glob(
            "temporal_*_data_*_0.png"))
        skipped = [line for line in printed.splitlines()
                   if "is not installed, so the plots" in line]
        if not csv_path.exists():
            raise AssertionError(f"[serve-artifacts] {name}: no {csv_path}")
        if not (len(drawn) == 10 and (Path(save_dir) / plots[0]).exists()
                or len(skipped) == 1 and plots[0] in skipped[0]
                and not drawn):
            raise AssertionError(f"[serve-artifacts] {name}: plots {drawn}, "
                                 f"skip lines {skipped}")
        results[name] = res
        log(f"[serve-artifacts] {name}_autoregressive_evaluation: {B} x "
            f"{T_roll} steps in {seconds:.2f} s, decode launches "
            f"{counts['decode_attention']}; {csv_path.name} written; "
            + (f"{len(drawn) + 1} plots drawn" if drawn else
               "plots skipped (one line printed)"))
    full, fused = results["full"], results["fused"]
    for key in ("encoded_rel_mse", "decoded_rel_mse",
                "decoded_rel_mse_per_time"):
        if not np.allclose(full[key], fused[key], rtol=ARTIFACT_RTOL,
                           atol=0):
            raise AssertionError(f"[serve-artifacts] {key}: full "
                                 f"{full[key]}, fused {fused[key]}")
    rel = float(np.max(np.abs(full["decoded_rel_mse_per_time"]
                              - fused["decoded_rel_mse_per_time"])
                       / np.abs(fused["decoded_rel_mse_per_time"])))
    log(f"[serve-artifacts] full vs fused: encoded_rel_mse "
        f"{full['encoded_rel_mse']:.9g} / {fused['encoded_rel_mse']:.9g}, "
        f"decoded_rel_mse {full['decoded_rel_mse']:.9g} / "
        f"{fused['decoded_rel_mse']:.9g}, per time max rel diff {rel:.3g} "
        f"<= {ARTIFACT_RTOL}")


def phase_checkpoint_pt():
    """[checkpoint-pt]: reference PyTorch state dicts through --model_path.
    Stage 1: the shipped trained weights written as a reference-named
    .pt (``module.`` prefixes, an extra ``freqs_cis`` buffer that the
    mapper must skip). Its sinusoidal ``pe`` is no key of a reference
    state dict (the reference keeps it as a buffer; the mapper rebuilds
    it), while the shipped npz carries the JAX run's trained table, so the
    .pt is held against its npz twin: the shipped weights with the
    mapper's table. `encoder test` from both must print the same three
    metrics, bit for bit (the transposes are exact); the shipped npz's own
    are logged beside. Stage 2: seeded cylinder temporal weights as .npz
    and as .pt; `temporal test` from both, the same decoded_rel_mse bit
    for bit."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.ops.layers import sinusoidal_pe_table
    from sea_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_params, save_pytree)
    from sea_tpu_torch.utils.params import save_init_checkpoints, to_numpy
    case = cli.get_case(TRAIN_CASE)
    with np.load(REPO / SHIPPED_ENCODER) as f:
        n_inp = f["params/decoders/1/fc2/w"].shape[1]
    scfg = case.spatial.with_n_inp(n_inp)
    template = to_numpy(init_spatial(scfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    shipped = load_params(str(REPO / SHIPPED_ENCODER), template)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        sd = _reference_state_dict(shipped, "spatial", prefix="module.")
        sd["module.encode.blocks.0.attn_1.freqs_cis"] = torch.zeros(64, 8)
        torch.save(sd, f"{d}/enc.pt")
        twin = dict(shipped, pe=sinusoidal_pe_table(
            scfg.token_dim, 5000, device="cpu").numpy())
        save_pytree(f"{d}/enc.npz", {"params": twin})
        got = {}
        for name, path in (("pt", f"{d}/enc.pt"), ("npz", f"{d}/enc.npz"),
                           ("shipped", str(REPO / SHIPPED_ENCODER))):
            got[name] = cli.main([TRAIN_CASE, "encoder", "test",
                                  "--synthetic", "--save_dir", d,
                                  "--device", "cuda", "--model_path", path])
        if got["pt"] != got["npz"] or not all(
                np.isfinite(v) for v in got["pt"].values()):
            raise AssertionError(f"[checkpoint-pt] encoder test: .pt "
                                 f"{got['pt']}, .npz {got['npz']}")
        log(f"[checkpoint-pt] {TRAIN_CASE} encoder test --model_path: .pt "
            f"({len(sd)} reference keys, module. prefixes, freqs_cis "
            f"skipped) {got['pt']} == npz twin {got['npz']} bit for bit; "
            f"the shipped npz (its trained pe) {got['shipped']}")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as d:
        tparams = save_init_checkpoints(case, d, seed=3)["temporal"]
        npz = checkpoint_path(d, "temporal", case.run.case_name,
                              case.run.run_name)
        torch.save(_reference_state_dict(tparams, "temporal"), f"{d}/t.pt")
        out = {}
        for path in (f"{d}/t.pt", npz):
            out[Path(path).suffix] = cli.main(
                [TRAIN_CASE, "temporal", "test", "--synthetic", "--save_dir",
                 d, "--device", "cuda", "--model_path", path])
        a, b = out[".pt"], out[".npz"]
        if not (np.isfinite(a["decoded_rel_mse"])
                and a["decoded_rel_mse"] == b["decoded_rel_mse"]
                and a["encoded_rel_mse"] == b["encoded_rel_mse"]):
            raise AssertionError(f"[checkpoint-pt] temporal test: .pt {a}, "
                                 f".npz {b}")
        log(f"[checkpoint-pt] {TRAIN_CASE} temporal test --model_path t.pt "
            f"== t.npz bit for bit: decoded_rel_mse "
            f"{a['decoded_rel_mse']!r}, encoded_rel_mse "
            f"{a['encoded_rel_mse']!r}")


def _reference_state_dict(tree, kind: str, prefix: str = ""):
    """The inverse of utils/torch_compat's mapping (a copy of
    tests/_reference_state_dict.py): {name: tensor} of a ``kind``
    ("spatial" or "temporal") numpy tree as the original SEA modules name
    their state dicts, every name under ``prefix`` ("module." for an
    nn.DataParallel export); the sinusoidal tables left out."""
    sd = {}

    def put(name, a):
        sd[prefix + name] = torch.from_numpy(np.ascontiguousarray(a))

    def lin(name, p):
        put(f"{name}.weight", p["w"].T)
        if "b" in p:
            put(f"{name}.bias", p["b"])

    def norm(name, p):
        put(f"{name}.weight", p["w"])
        if "b" in p:
            put(f"{name}.bias", p["b"])
        if "cond_fc1" in p:
            lin(f"{name}.cond_mlp.0", p["cond_fc1"])
            lin(f"{name}.cond_mlp.2", p["cond_fc2"])

    def attn(name, p):
        for k in ("q", "k", "v"):
            lin(f"{name}.{k}", p[k])
        lin(f"{name}.projection", p["proj"])

    def mlp(name, p):
        idx = 0  # [Linear, LayerNorm, GELU] per hidden layer, then Linear
        for layer in p["layers"]:
            lin(f"{name}.layers.{idx}", layer["lin"])
            if "ln" in layer:
                norm(f"{name}.layers.{idx + 1}", layer["ln"])
                idx += 3
            else:
                idx += 1

    def scale(name, p):
        lin(f"{name}.layer1", p["fc1"])
        lin(f"{name}.layer2", p["fc2"])

    if kind == "spatial":
        norm("encode.ln", tree["ln"])
        for i, b in enumerate(tree["blocks"]):
            norm(f"encode.blocks.{i}.ln_exp1_1", b["ln1"])
            norm(f"encode.blocks.{i}.ln_exp1_2", b["ln2"])
            attn(f"encode.blocks.{i}.attn_1", b["attn"])
            mlp(f"encode.blocks.{i}.mlp_1", b["mlp"])
        mu = "encoders_mu" if "encoders_logvar" in tree else "encoders"
        for g, p in enumerate(tree["encoders"]):
            scale(f"encode.{mu}.{g}", p)
        for g, p in enumerate(tree.get("encoders_logvar", [])):
            scale(f"encode.encoders_logvar.{g}", p)
        for g, p in enumerate(tree["decoders"]):
            scale(f"decode.decoders.{g}", p)
        return sd

    for i, p in enumerate(tree["ln_final"]):
        norm(f"ln.{i}", p)
    for l, b in enumerate(tree["blocks"]):
        n = f"blocks.{l}"
        ib = b["ib"]
        if "W" in ib:
            put(f"{n}.ib.W", ib["W"])
        elif "layers" in ib:
            mlp(f"{n}.ib", ib)
        else:
            lin(f"{n}.ib", ib)
        for i, field in enumerate(b["ln_exp"]):
            for j, p in enumerate(field):
                norm(f"{n}.ln.exp.{i}.{j}", p)
        for i in range(len(b["self_attn"])):
            attn(f"{n}.attn.self.{i}", b["self_attn"][i])
            mlp(f"{n}.mlp.{i}", b["mlp"][i])
            lin(f"{n}.proj.{i}", b["proj"][i])
        for i, p in enumerate(b.get("cross_attn_ib", [])):
            attn(f"{n}.cross_attn_ib.{i}", p)
        for i in range(len(b.get("cross_down", []))):
            lin(f"{n}.cross_down.{i}", b["cross_down"][i])
            lin(f"{n}.cross_up.{i}", b["cross_up"][i])
            norm(f"{n}.ln_cross.{i}", b["ln_cross"][i])
        for i, row in enumerate(b.get("cross_attn", [])):
            if isinstance(row, list):  # sea: the G x G lattice
                for j, p in enumerate(row):
                    attn(f"{n}.cross_attn.{i}.{j}", p)
            else:  # pool: one per field
                attn(f"{n}.cross_attn.{i}", row)
        if "pool_token" in b:
            put(f"{n}.pool_token", b["pool_token"])
            norm(f"{n}.ln_pool", b["ln_pool"])
            upd = b["pool_update"]
            if isinstance(upd, np.ndarray):  # pooling weights
                put(f"{n}.pool_update", upd)
            elif "fc1" in upd:
                lin(f"{n}.pool_update.0", upd["fc1"])
                lin(f"{n}.pool_update.2", upd["fc2"])
            else:
                lin(f"{n}.pool_update", upd)
    return sd


# [train-mesh] / [serve-mesh]: two ranks on cuda:0 over gloo (NCCL takes
# one rank a card), spawned by sea_tpu_torch.parallel.multihost.run_ranks
# (steps) or driving the CLI in each rank; torchrun for one CLI run.
MESH_SHAPES = [(2, 1), (1, 2)]
MESH_DEVICE = "cuda:0"


def _mesh_rank_setup():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _train_mesh_rank(shape, params_np, key):
    """One rank of [train-mesh]: the full-recipe cylinder step on its
    shard, twice more timed. Returns (stats, launches of the first step,
    the bh_maps its flash forwards took, the gathered params after it
    (rank 0), the wall ms of the third step)."""
    _mesh_rank_setup()
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.parallel.mesh import (make_mesh, temporal_param_dims,
                                             unshard)
    from sea_tpu_torch.parallel.multihost import is_primary
    from sea_tpu_torch.parallel.train_step import \
        make_sharded_temporal_train_step
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.params import to_numpy
    from sea_tpu_torch.cli import get_case
    case = get_case(TRAIN_CASE)
    cfg = dataclasses.replace(case.temporal, ib_time_constant=True)
    grid = make_mesh(*shape)
    step, p, o, place = make_sharded_temporal_train_step(
        grid, cfg, make_optimizer(case.temporal_train), params_np,
        device=MESH_DEVICE)
    batch = place(*_step_batch(cfg))
    maps, real = [], FA.flash_fwd

    def recording(*args, **kwargs):
        bh = kwargs.get("bh_map")
        maps.append(None if bh is None else bh.tolist())
        return real(*args, **kwargs)
    FA.flash_fwd = recording
    _reset_launch_counts()
    try:
        p, o, stats = step(p, o, *batch, key)
        torch.cuda.synchronize()
    finally:
        FA.flash_fwd = real
    counts = _launch_counts()
    full = unshard(grid, p, temporal_param_dims(params_np))
    full = to_numpy(full) if is_primary() else None
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        p, o, _ = step(p, o, *batch, key)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ({k: float(v) for k, v in stats.items()}, counts, maps, full,
            ms[-1])


def _encoder_mesh_rank(shape, params_np, batch, key):
    """One rank of the [train-mesh] stage-1 step: (stats, gathered params
    and AdamW mu after it (rank 0))."""
    _mesh_rank_setup()
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.parallel.mesh import (make_mesh, spatial_param_dims,
                                             unshard)
    from sea_tpu_torch.parallel.multihost import is_primary
    from sea_tpu_torch.parallel.train_step import \
        make_sharded_spatial_train_step
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.params import to_numpy
    case = get_case(TRAIN_CASE)
    n_inp = batch.shape[-1]
    cfg = case.spatial.with_n_inp(n_inp)
    grid = make_mesh(*shape)
    step, p, o, place = make_sharded_spatial_train_step(
        grid, cfg, make_optimizer(case.spatial_train), params_np,
        device=MESH_DEVICE)
    p, o, stats = step(p, o, place(batch), key, 0)
    dims = spatial_param_dims(params_np)
    full = (unshard(grid, p, dims), unshard(grid, o[0].mu, dims))
    return ({k: float(v) for k, v in stats.items()},
            to_numpy(full) if is_primary() else None)


def _serve_mesh_rank(argv):
    """One rank of [serve-mesh]: the CLI's `temporal test` on its shard;
    (its metrics, its launches, the head counts its decodes took)."""
    _mesh_rank_setup()
    from sea_tpu_torch import cli
    from sea_tpu_torch.ops import attention as A
    heads, real = collections.Counter(), A.decode_attention

    def recording(q, *args, **kwargs):
        heads[q.shape[1]] += 1
        return real(q, *args, **kwargs)
    A.decode_attention = recording
    _reset_launch_counts()
    try:
        results = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        A.decode_attention = real
    return ({k: np.asarray(results[k]) for k in (
        "encoded_rel_mse", "decoded_rel_mse", "decoded_rel_mse_per_time")},
        _launch_counts(), dict(heads))


def _u_close(got, want, got_mu, want_mu, tcfg):
    """The largest parameter gap and the largest left after the first
    AdamW step's ill-conditioning near eps: |a - b| - lr |u(g_a) - u(g_b)|
    (u(g) = g / (|g| + eps), g = mu / (1 - b1)), the rule of
    [encoder-card-vs-cpu]."""
    from sea_tpu_torch.utils.params import tree_leaves
    lr, eps, b1 = tcfg.learning_rate, tcfg.eps, tcfg.betas[0]
    worst = left = 0.0
    for a, b, ma, mb in zip(*(tree_leaves(t) for t in (got, want, got_mu,
                                                      want_mu))):
        ga, gb = (np.asarray(m, np.float64) / (1 - b1) for m in (ma, mb))
        diff = np.abs(np.asarray(a, np.float64) - b)
        worst = max(worst, float(diff.max()))
        left = max(left, float((diff - lr * np.abs(
            ga / (np.abs(ga) + eps) - gb / (np.abs(gb) + eps))).max()))
    return worst, left


def phase_train_mesh(case, params_np):
    """[train-mesh]: the full cylinder recipe step (E=1024, T=399, B=2,
    dropout 0.1) in two ranks sharing the card over gloo, at 2x1 and 1x2,
    against the one-rank step: loss, grad_norm and params within STEP_TOL;
    each rank launches the flash forward, dQ and dK/dV 4 times a step,
    each forward with the rank's own bh_map. Then the stage-1 step at
    B=128 from the shipped weights at 2x1 against one rank, and `encoder
    train --mesh 2x1` at B=128 through torchrun."""
    from sea_tpu_torch.parallel.mesh import make_mesh
    from sea_tpu_torch.parallel.multihost import run_ranks
    from sea_tpu_torch.utils.params import tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    per_step = _attentions(case.temporal)[1]  # flash calls of a forward
    t0 = time.perf_counter()
    # One rank: no process group here, so make_mesh gives a 1 x 1 grid.
    ref = _train_mesh_rank((1, 1), params_np, key)
    log(f"[train-mesh] one-rank step: {time.perf_counter() - t0:.1f} s "
        f"(build and first step); wall {ref[4]:.1f} ms a step after")
    H = case.temporal.n_heads
    for shape in MESH_SHAPES:
        t0 = time.perf_counter()
        ranks = run_ranks(_train_mesh_rank, 2, shape, params_np, key,
                          device=MESH_DEVICE)
        seconds = time.perf_counter() - t0
        stats, _, _, full, ms = ranks[0]
        loss_err = abs(stats["loss"] - ref[0]["loss"]) / abs(ref[0]["loss"])
        gn_err = abs(stats["grad_norm"] - ref[0]["grad_norm"]) / \
            ref[0]["grad_norm"]
        p_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(tree_leaves(full), tree_leaves(ref[3])))
        if not (loss_err <= STEP_TOL["loss"]
                and gn_err <= STEP_TOL["grad_norm"]
                and p_err <= STEP_TOL["params"]):
            raise AssertionError(
                f"[train-mesh] {shape}: loss rel err {loss_err}, grad_norm "
                f"rel err {gn_err}, params max abs err {p_err}")
        b_loc, h_loc = 2 // shape[0], H // shape[1]
        for rank, (_, counts, maps, _, _) in enumerate(ranks):
            for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
                if counts[name] != per_step:
                    raise AssertionError(
                        f"[train-mesh] {shape} rank {rank}: {name} launched "
                        f"{counts[name]} times a step, not {per_step}")
            d, m = rank // shape[1], rank % shape[1]
            want = [(b0 * b_loc + b) * H + m * h_loc + h
                    for b0 in (d,) for b in range(b_loc)
                    for h in range(h_loc)]
            if len(maps) != per_step or any(x != want for x in maps):
                raise AssertionError(
                    f"[train-mesh] {shape} rank {rank}: flash bh_maps "
                    f"{maps[:1]}..., want {want} at every forward")
        log(f"[train-mesh] {TRAIN_CASE} step {shape[0]}x{shape[1]} (2 ranks "
            f"on one card, gloo), B=2, T=399, dropout "
            f"{case.temporal.dropout}: loss {stats['loss']:.7g} vs one "
            f"rank {ref[0]['loss']:.7g} (rel {loss_err:.3g} <= "
            f"{STEP_TOL['loss']}), grad_norm rel {gn_err:.3g} <= "
            f"{STEP_TOL['grad_norm']}, params max abs err {p_err:.3g} <= "
            f"{STEP_TOL['params']}; every rank: flash fwd/dq/dkv "
            f"{per_step} each a step, its bh_map {want[:4]}...; wall "
            f"{ms:.1f} ms a step (rank 0, third step); {seconds:.1f} s "
            "with spawning")
    _encoder_mesh(case)
    return ref


def _encoder_mesh(case):
    """The stage-1 half of [train-mesh] (phase_train_mesh's docstring)."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.models.spatial import init_spatial
    from sea_tpu_torch.parallel.multihost import free_port, run_ranks
    from sea_tpu_torch.utils.checkpoint import load_params
    from sea_tpu_torch.utils.params import to_numpy
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    tcase = get_case(TRAIN_CASE)
    with np.load(REPO / SHIPPED_ENCODER) as f:
        n_inp = f["params/decoders/1/fc2/w"].shape[1]
    cfg = tcase.spatial.with_n_inp(n_inp)
    template = to_numpy(init_spatial(cfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    params = load_params(str(REPO / SHIPPED_ENCODER), template)
    n_patches = (tcase.mesh.m - 1) * (tcase.mesh.n - 1)
    n_fields = sum(len(g) for g in cfg.field_groups)
    batch = np.random.RandomState(0).randn(ENCODER_BATCH, n_patches,
                                           n_fields, n_inp).astype(np.float32)
    key = fold_in(prng_key(0), 2)
    ref_stats, ref_full = _encoder_mesh_rank((1, 1), params, batch, key)
    ranks = run_ranks(_encoder_mesh_rank, 2, (2, 1), params, batch, key,
                      device=MESH_DEVICE)
    stats, full = ranks[0]
    loss_err = abs(stats["loss"] - ref_stats["loss"]) / abs(ref_stats["loss"])
    gn_err = abs(stats["grad_norm"] - ref_stats["grad_norm"]) / \
        ref_stats["grad_norm"]
    worst, left = _u_close(full[0], ref_full[0], full[1], ref_full[1],
                           tcase.spatial_train)
    if not (loss_err <= STEP_TOL["loss"] and gn_err <= STEP_TOL["grad_norm"]
            and left <= STEP_TOL["params"]):
        raise AssertionError(f"[train-mesh] encoder 2x1: loss rel {loss_err},"
                             f" grad_norm rel {gn_err}, params {left}")
    log(f"[train-mesh] {TRAIN_CASE} stage-1 step 2x1, B={ENCODER_BATCH}, "
        f"shipped weights: loss {stats['loss']:.7g} vs one rank "
        f"{ref_stats['loss']:.7g} (rel {loss_err:.3g}), grad_norm rel "
        f"{gn_err:.3g}, params max abs err {worst:.3g} ({left:.3g} past "
        f"lr |u - u'| <= {STEP_TOL['params']})")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        cmd = [sys.executable, "-m", "torch.distributed.run",
               "--nproc_per_node", "2", "--master_port", str(free_port()),
               "-m", "sea_tpu_torch", TRAIN_CASE, "encoder", "train",
               "--synthetic", "--epochs", "1", "--batch_size",
               str(ENCODER_BATCH), "--mesh", "2x1", "--save_dir", save_dir,
               "--device", "cuda"]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600, cwd=REPO)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"[train-mesh] torchrun encoder train "
                                 f"--mesh 2x1 exited {proc.returncode}:\n"
                                 f"{proc.stdout[-3000:]}\n"
                                 f"{proc.stderr[-3000:]}")
        epoch = [l for l in proc.stdout.splitlines() if "Epoch 1/1" in l]
        path = os.path.join(save_dir,
                            "encoder_decoder_cylinder_flow_run1.npz")
        with np.load(path) as f:
            finite = all(np.isfinite(f[k]).all() for k in f.files)
        if len(epoch) != 1 or not finite:
            raise AssertionError(f"[train-mesh] torchrun encoder train: "
                                 f"epoch lines {epoch}, finite {finite}")
        log(f"[train-mesh] torchrun --nproc_per_node 2 -m sea_tpu_torch "
            f"{TRAIN_CASE} encoder train --mesh 2x1 --batch_size "
            f"{ENCODER_BATCH}: {epoch[0].strip()}; one line from rank 0; "
            f"the npz finite; {seconds:.1f} s")


# [seq-ring] / [train-seq] / [train-pipe]: sequence parallelism (ring
# attention) and the GPipe pipeline, ranks sharing the card over gloo.
SEQ_RANKS = 3  # T = 399 splits into 3 blocks of 133 (399 = 3 x 7 x 19)
SEQ_SHAPES = [(2, 399, 8, 128), (2, 399, 8, 64)]  # (B, T, H, hd)
SEQ_SEED = (1357, -2468)
# The CLI epoch's ring: the synthetic data's 40-step window splits over 2
# (not over 3).
SEQ_CLI_RANKS = 2
PIPE_LAYERS, PIPE_STAGES, PIPE_MICRO, PIPE_BATCH = 4, 2, 2, 4
# [train-pipe]'s AdamW mu (the step's gradient times 1 - b1) against the
# reference's: MU_RTOL of it plus MU_ATOL of the global grad_norm, the
# CPU test's bound (tests/test_torch_pipeline_step.py). A parameter
# within STEP_TOL["params"], plus lr |u(g) - u(g')| only where the
# reference's |g| <= NEAR_EPS eps: there the first AdamW update
# u(g) = g / (|g| + eps) is ill-conditioned.
MU_RTOL, MU_ATOL, NEAR_EPS = 1e-4, 1e-7, 100


def _seq_inputs(shape, dtype):
    """q, k, v and the cotangent [B, T, H, hd] on the card, from a seed."""
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    return [torch.randn(shape, device="cuda", generator=g).to(dtype)
            for _ in range(4)]


def _seq_ring_rank():
    """One rank of [seq-ring]: at each SEQ_SHAPES shape, f32 and bf16, the
    causal ring's forward and backward on this rank's time block, dropout
    0.1; per case (its launches, and on rank 0 the gathered out, dq, dk,
    dv on the CPU), and the fwd+bwd wall ms of a second call."""
    _mesh_rank_setup()
    from sea_tpu_torch.parallel.collectives import all_gather_cat
    from sea_tpu_torch.parallel.mesh import make_seq_mesh, shard_seq
    from sea_tpu_torch.parallel.multihost import is_primary
    from sea_tpu_torch.parallel.ring_attention import ring_attention
    grid = make_seq_mesh()
    out = {}
    for shape in SEQ_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, g = (shard_seq(grid, x).contiguous()
                          for x in _seq_inputs(shape, dtype))
            ms = []
            for _ in range(2):
                qb, kb, vb = (x.clone().requires_grad_(True)
                              for x in (q, k, v))
                torch.cuda.synchronize()
                _reset_launch_counts()
                t0 = time.perf_counter()
                o = ring_attention(qb, kb, vb, grid, causal=True,
                                   dropout_rate=DROPOUT_RATE,
                                   dropout_seed=SEQ_SEED)
                o.backward(g)
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
                counts = _launch_counts()
            full = [all_gather_cat(x.detach(), 1, grid.seq_group,
                                   grid.n_seq)
                    for x in (o, qb.grad, kb.grad, vb.grad)]
            # numpy (f32) across the process boundary: a CPU tensor would
            # travel as a shared-memory handle the rank takes with it.
            out[(shape, str(dtype))] = (
                counts, [x.float().cpu().numpy() for x in full]
                if is_primary() else None, ms[-1])
    return out


def phase_seq_ring():
    """[seq-ring]: the causal ring (dropout 0.1, f32 and bf16) in
    SEQ_RANKS ranks sharing the card over gloo, at SEQ_SHAPES, against the
    one-device flash kernels on the same inputs: out and dq/dk/dv within
    the kernels' tolerances (f32: FLASH_TOL; bf16: FLASH_BF16_REL x
    max|ref| + FLASH_TOL). Rank r launches r + 1 forwards and r + 1 dQ and
    dK/dV (the pairs at or below the diagonal; the others launch
    nothing), in the dtype's form."""
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.parallel.multihost import run_ranks
    t0 = time.perf_counter()
    ranks = run_ranks(_seq_ring_rank, SEQ_RANKS, device=MESH_DEVICE)
    seconds = time.perf_counter() - t0
    for shape in SEQ_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            sfx = "_bf16" if dtype == torch.bfloat16 else ""
            key = (shape, str(dtype))
            for r, result in enumerate(ranks):
                counts = result[key][0]
                want = {f"{n}{sfx}": r + 1 for n in (
                    "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")}
                got = {n: counts[n] for n in want}
                others = {n: c for n, c in counts.items()
                          if n not in want and c}
                if got != want or others:
                    raise AssertionError(f"[seq-ring] {shape} {dtype} rank "
                                         f"{r}: launches {got} {others}, "
                                         f"want {want}")
            q, k, v, g = (x.requires_grad_(True) if i < 3 else x
                          for i, x in enumerate(_seq_inputs(shape, dtype)))
            o = FA.flash_attention(q, k, v, True, 0,
                                   dropout_rate=DROPOUT_RATE,
                                   dropout_seed=SEQ_SEED)
            o.backward(g)
            torch.cuda.synchronize()
            ref = [o.detach(), q.grad, k.grad, v.grad]
            line = []
            for name, got, want in zip(("out", "dq", "dk", "dv"),
                                       ranks[0][key][1], ref):
                kind = "out" if name == "out" else "grad"
                got = torch.from_numpy(got).cuda().to(dtype)
                if dtype == torch.bfloat16:
                    err, bound = _bf16_err(got, want, FLASH_BF16_REL[kind],
                                           FLASH_TOL[kind])
                else:
                    err, bound = _err(got, want), FLASH_TOL[kind]
                if not err <= bound:
                    raise AssertionError(f"[seq-ring] {shape} {dtype} "
                                         f"{name}: max abs err {err} > "
                                         f"{bound}")
                line.append(f"{name} {err:.3g} <= {bound:.3g}")
            walls = [f"{res[key][2]:.2f}" for res in ranks]
            log(f"[seq-ring] (B,T,H,hd)={shape} {str(dtype)[6:]} causal "
                f"dropout {DROPOUT_RATE}, {SEQ_RANKS} ranks of "
                f"{shape[1] // SEQ_RANKS} steps: vs the one-device flash "
                f"kernels {', '.join(line)}; rank r launched r+1 fwd, dq "
                f"and dkv{sfx or ' (f32)'}, nothing else; fwd+bwd wall ms "
                f"by rank {walls}")
    log(f"[seq-ring] {seconds:.1f} s with spawning")


def _train_seq_rank(params_np, key):
    """One rank of [train-seq]: the full-recipe cylinder step on the seq
    ring; (stats, launches of the first step, the params after it (rank
    0), the wall ms of the third step)."""
    _mesh_rank_setup()
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.parallel.mesh import make_seq_mesh
    from sea_tpu_torch.parallel.multihost import is_primary
    from sea_tpu_torch.parallel.train_step import \
        make_seq_parallel_train_step
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.params import to_numpy
    case = get_case(TRAIN_CASE)
    grid = make_seq_mesh()
    step, p, o, place = make_seq_parallel_train_step(
        grid, case.temporal, make_optimizer(case.temporal_train), params_np,
        device=MESH_DEVICE)
    batch = place(*_step_batch(case.temporal))
    _reset_launch_counts()
    p, o, stats = step(p, o, *batch, key)
    torch.cuda.synchronize()
    counts = _launch_counts()
    full = to_numpy(p) if is_primary() else None
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        p, o, _ = step(p, o, *batch, key)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ({k: float(v) for k, v in stats.items()}, counts, full, ms[-1])


def _step_errors(stats, full, ref_stats, ref_full):
    """(loss rel err, grad_norm rel err, params max abs err)."""
    from sea_tpu_torch.utils.params import tree_leaves
    return (abs(stats["loss"] - ref_stats["loss"]) / abs(ref_stats["loss"]),
            abs(stats["grad_norm"] - ref_stats["grad_norm"])
            / ref_stats["grad_norm"],
            max(float(np.abs(a - b).max()) for a, b in
                zip(tree_leaves(full), tree_leaves(ref_full))))


def _within_step_tol(errs):
    return (errs[0] <= STEP_TOL["loss"] and errs[1] <= STEP_TOL["grad_norm"]
            and errs[2] <= STEP_TOL["params"])


def _torchrun_train(case_name, flags, save_dir, label):
    """`torchrun --nproc_per_node 2 -m sea_tpu_torch <case> temporal train
    --synthetic --epochs 1 <flags>` on the card: its one epoch line (rank
    0 prints), the written npz finite; returns (the line, seconds)."""
    from sea_tpu_torch.parallel.multihost import free_port
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc_per_node", "2", "--master_port", str(free_port()),
           "-m", "sea_tpu_torch", case_name, "temporal", "train",
           "--synthetic", "--epochs", "1", "--save_dir", save_dir,
           "--device", "cuda"] + flags
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"[{label}] torchrun temporal train {flags} "
                             f"exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    epoch = [l for l in proc.stdout.splitlines() if "Epoch 1/1" in l]
    with np.load(os.path.join(save_dir,
                              "temporal_cylinder_flow_run1.npz")) as f:
        finite = all(np.isfinite(f[k]).all() for k in f.files)
    if len(epoch) != 1 or not finite:
        raise AssertionError(f"[{label}] torchrun temporal train {flags}: "
                             f"epoch lines {epoch}, finite {finite}")
    return epoch[0].strip(), seconds


def phase_train_seq(case, params_np, ref):
    """[train-seq]: the full cylinder recipe step (E=1024, B=2, T=399,
    dropout 0.1) on a ring of SEQ_RANKS ranks sharing the card over gloo,
    133 steps a rank, against the one-rank step ``ref`` (from
    [train-mesh]): loss, grad_norm and params within STEP_TOL; rank r
    launches r + 1 flash forwards, dQ and dK/dV per attention. Then
    `torchrun ... temporal train --seq_parallel SEQ_CLI_RANKS` for one
    epoch on the synthetic data."""
    from sea_tpu_torch.parallel.multihost import run_ranks
    from sea_tpu_torch.utils.params import save_init_checkpoints
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    per_step = _attentions(case.temporal)[1]
    t0 = time.perf_counter()
    ranks = run_ranks(_train_seq_rank, SEQ_RANKS, params_np, key,
                      device=MESH_DEVICE)
    seconds = time.perf_counter() - t0
    stats, _, full, ms = ranks[0]
    errs = _step_errors(stats, full, ref[0], ref[3])
    if not _within_step_tol(errs):
        raise AssertionError(f"[train-seq] loss rel err {errs[0]}, "
                             f"grad_norm rel err {errs[1]}, params max abs "
                             f"err {errs[2]}")
    for r, (_, counts, _, _) in enumerate(ranks):
        for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            if counts[name] != per_step * (r + 1):
                raise AssertionError(
                    f"[train-seq] rank {r}: {name} launched {counts[name]} "
                    f"times a step, not {per_step} x {r + 1}")
    log(f"[train-seq] {TRAIN_CASE} step --seq_parallel {SEQ_RANKS} "
        f"({SEQ_RANKS} ranks on one card, gloo, {399 // SEQ_RANKS} steps a "
        f"rank), B=2, T=399, dropout {case.temporal.dropout}: loss "
        f"{stats['loss']:.7g} "
        f"vs one rank {ref[0]['loss']:.7g} (rel {errs[0]:.3g} <= "
        f"{STEP_TOL['loss']}), grad_norm rel {errs[1]:.3g} <= "
        f"{STEP_TOL['grad_norm']}, params max abs err {errs[2]:.3g} <= "
        f"{STEP_TOL['params']}; rank r: flash fwd/dq/dkv {per_step} x "
        f"(r+1) a step, AdaLN kernels "
        f"{[c['adaln_fwd'] for _, c, _, _ in ranks]} (per-token cond, as "
        f"in JAX); wall ms a step (third step) by rank "
        f"{[round(r[3], 1) for r in ranks]} vs one rank {ref[4]:.1f}; "
        f"{seconds:.1f} s with spawning")
    from sea_tpu_torch.cli import get_case
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        save_init_checkpoints(get_case(TRAIN_CASE), save_dir, seed=1)
        line, seconds = _torchrun_train(
            TRAIN_CASE, ["--seq_parallel", str(SEQ_CLI_RANKS)], save_dir,
            "train-seq")
    log(f"[train-seq] torchrun --nproc_per_node 2 -m sea_tpu_torch "
        f"{TRAIN_CASE} temporal train --seq_parallel {SEQ_CLI_RANKS}: "
        f"{line}; one line from rank 0; the npz finite; {seconds:.1f} s")


def _pipe_model():
    """(cfg, params as a numpy tree, batch) of [train-pipe]: the cylinder
    width at PIPE_LAYERS layers from a seed, B=PIPE_BATCH, T=399."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.utils.params import to_numpy
    cfg = dataclasses.replace(get_case(TRAIN_CASE).temporal,
                              num_layers=PIPE_LAYERS)
    params = to_numpy(init_temporal(cfg, torch.Generator().manual_seed(5),
                                    device="cpu"))
    return cfg, params, _step_batch(cfg, B=PIPE_BATCH)


def _samples(params, mu, first_layer=0):
    """{npz path: (params, AdamW mu)} of every leaf, each a strided sample
    of at most 4096 of its elements (numpy): what [train-pipe] compares,
    so that no 1.4 GB tree crosses a process. ``first_layer``: the global
    index of the tree's first block."""
    from sea_tpu_torch.utils.params import tree_leaves, tree_paths

    def flat(t):
        t = t.detach().reshape(-1)
        # A copy: the step updates the tree in place afterwards.
        return t[::max(1, t.numel() // 4096)].float().cpu().numpy().copy()
    out = {}
    for path, p, m in zip(tree_paths(params), tree_leaves(params),
                          tree_leaves(mu)):
        if path.startswith("blocks/"):
            i, rest = path[len("blocks/"):].split("/", 1)
            path = f"blocks/{int(i) + first_layer}/{rest}"
        out[path] = (flat(p), flat(m))
    return out


def _pipe_step(grid, cfg, params_np, batch, key):
    """One pipelined AdamW step on ``grid``: (stats, launches, this
    stage's ``_samples``, the wall ms of a third step)."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.parallel.pipeline import make_pipeline_train_step
    from sea_tpu_torch.train.optim import make_optimizer
    step, p, o, place = make_pipeline_train_step(
        grid, cfg, make_optimizer(get_case(TRAIN_CASE).temporal_train),
        params_np, device=MESH_DEVICE, n_microbatches=PIPE_MICRO)
    placed = place(*batch)
    _reset_launch_counts()
    p, o, stats = step(p, o, *placed, key)
    torch.cuda.synchronize()
    counts = _launch_counts()
    got = _samples(p, o[0].mu, grid.layers(cfg.num_layers).start)
    ms = []
    for _ in range(2):
        t0 = time.perf_counter()
        p, o, _ = step(p, o, *placed, key)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return ({k: float(v) for k, v in stats.items()}, counts, got, ms[-1])


def _pipe_rank(n_pipe, key):
    """One stage of [train-pipe] (n_pipe 1: the one-stage pipeline in
    this process): the deterministic pipelined forward (its launches and,
    from the first stage, the output), then one step at dropout 0 and one
    at the recipe's dropout (``_pipe_step``)."""
    _mesh_rank_setup()
    from sea_tpu_torch.parallel.pipeline import (make_pipe_mesh,
                                                 pipeline_forward,
                                                 stage_params)
    from sea_tpu_torch.utils.params import from_numpy
    cfg, params_np, batch = _pipe_model()
    grid = make_pipe_mesh(n_pipe)
    out = {}
    if n_pipe > 1:
        stage = from_numpy(stage_params(grid, params_np, cfg.num_layers),
                           MESH_DEVICE)
        _reset_launch_counts()
        y = pipeline_forward(stage, cfg, *(torch.from_numpy(a).to(
            MESH_DEVICE) for a in batch[::2]), grid=grid,
            n_microbatches=PIPE_MICRO)
        torch.cuda.synchronize()
        out["forward"] = (_launch_counts(), y.cpu().numpy()
                          if grid.pipe_rank == 0 else None)
        del stage
        out["step0"] = _pipe_step(grid, dataclasses.replace(
            cfg, dropout=0.0), params_np, batch, key)
    out["step"] = _pipe_step(grid, cfg, params_np, batch, key)
    return out


def _merged(stages):
    """One dict of ``_samples`` from every stage's."""
    return {k: v for part in stages for k, v in part.items()}


def _sample_errors(stats, got, ref_stats, want):
    """(loss rel err, grad_norm rel err, the largest params gap left past
    lr |u(g) - u(g')| where |g| <= NEAR_EPS eps, the largest mu gap over
    its bound MU_RTOL |mu| + MU_ATOL grad_norm, the raw params gap) over
    the samples."""
    from sea_tpu_torch.cli import get_case
    tcfg = get_case(TRAIN_CASE).temporal_train
    lr, eps, b1 = tcfg.learning_rate, tcfg.eps, tcfg.betas[0]
    if sorted(got) != sorted(want):
        raise AssertionError(f"[train-pipe] leaves {sorted(got)[:3]}... "
                             f"!= {sorted(want)[:3]}...")
    left = mu_ratio = raw = 0.0
    for path, (p, m) in want.items():
        gp, gm = (np.asarray(x, np.float64) for x in got[path])
        m = np.asarray(m, np.float64)
        mu_ratio = max(mu_ratio, float((np.abs(gm - m) / (
            MU_RTOL * np.abs(m) + MU_ATOL * ref_stats["grad_norm"])).max()))
        ga, gb = gm / (1 - b1), m / (1 - b1)
        diff = np.abs(gp - p)
        raw = max(raw, float(diff.max()))
        allow = np.where(np.abs(gb) > NEAR_EPS * eps, 0.0, lr * np.abs(
            ga / (np.abs(ga) + eps) - gb / (np.abs(gb) + eps)))
        left = max(left, float((diff - allow).max()))
    return (abs(stats["loss"] - ref_stats["loss"]) / abs(ref_stats["loss"]),
            abs(stats["grad_norm"] - ref_stats["grad_norm"])
            / ref_stats["grad_norm"], left, mu_ratio, raw)


def phase_train_pipe(case):
    """[train-pipe]: the cylinder width at PIPE_LAYERS layers, B=PIPE_BATCH,
    T=399, over PIPE_STAGES stages sharing the card over gloo, PIPE_MICRO
    microbatches: the deterministic forward against the one-device
    forward (max abs err within STEP_TOL["loss"] of max|out|), and a
    dropout-0 step against the one-rank step (loss, grad_norm within
    STEP_TOL; params and AdamW mu sampled, 4096 elements a leaf, mu
    within MU_RTOL plus MU_ATOL of grad_norm, params within STEP_TOL
    past lr |u - u'| where |g| <= NEAR_EPS eps); a dropout-0.1 step against the one-stage
    pipeline's (the keys do not depend on the stages); each stage's flash
    forwards, dQ and dK/dV = its layers' attentions x the microbatches.
    Then `torchrun ... temporal train --pp 2` for one epoch on
    cylinder_flow_smoke_deep."""
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.models.temporal import temporal_forward
    from sea_tpu_torch.parallel.multihost import run_ranks
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_temporal import make_train_step
    from sea_tpu_torch.utils.params import from_numpy, save_init_checkpoints
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    t0 = time.perf_counter()
    ranks = run_ranks(_pipe_rank, PIPE_STAGES, PIPE_STAGES, key,
                      device=MESH_DEVICE)
    spawned = time.perf_counter() - t0
    cfg, params_np, batch = _pipe_model()
    per_stage = (_attentions(cfg)[1] // PIPE_STAGES) * PIPE_MICRO
    x, tgt, ib = (torch.from_numpy(a).to(MESH_DEVICE) for a in batch)
    params = from_numpy(params_np, MESH_DEVICE)
    with torch.no_grad():
        want = temporal_forward(params, cfg, x, ib)
    # Relative to the output's scale, as STEP_TOL holds the loss: 4
    # layers of f32 sums in another order (2-row microbatches).
    f_err = (_err(torch.from_numpy(ranks[0]["forward"][1]).to(MESH_DEVICE),
                  want) / want.abs().max().item())
    if not f_err <= STEP_TOL["loss"]:
        raise AssertionError(f"[train-pipe] forward max abs err {f_err} of "
                             "max|out|")
    # dropout 0: the one-rank step (make_train_step) is the reference.
    tx = make_optimizer(case.temporal_train)
    state = tx.init(params)
    step = make_train_step(dataclasses.replace(cfg, dropout=0.0), tx)
    params, state, stats = step(params, state, x, tgt, ib, key)
    torch.cuda.synchronize()
    ref = ({k: float(v) for k, v in stats.items()},
           _samples(params, state[0].mu))
    del params, state
    errs0 = _sample_errors(ranks[0]["step0"][0],
                           _merged(r["step0"][2] for r in ranks), *ref)
    one = _pipe_rank(1, key)["step"]
    errs1 = _sample_errors(ranks[0]["step"][0],
                           _merged(r["step"][2] for r in ranks), one[0],
                           one[2])
    for label, errs in (("dropout-0 step vs one rank", errs0),
                        ("dropout step vs one stage", errs1)):
        if not (_within_step_tol(errs) and errs[3] <= 1.0):
            raise AssertionError(f"[train-pipe] {label}: {errs}")
    for r, result in enumerate(ranks):
        counts = {what: result[what][0 if what == "forward" else 1]
                  for what in ("forward", "step0", "step")}
        want_n = {"forward": {"flash_fwd": per_stage},
                  "step0": dict.fromkeys(
                      ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"),
                      per_stage)}
        want_n["step"] = want_n["step0"]
        for what, names in want_n.items():
            for name, n in names.items():
                if counts[what][name] != n:
                    raise AssertionError(
                        f"[train-pipe] stage {r} {what}: {name} launched "
                        f"{counts[what][name]} times, not {n}")
    seconds = time.perf_counter() - t0
    log(f"[train-pipe] {TRAIN_CASE} width, {PIPE_LAYERS} layers, "
        f"B={PIPE_BATCH}, T=399, {PIPE_STAGES} stages on one card (gloo), "
        f"{PIPE_MICRO} microbatches: deterministic forward max abs err "
        f"{f_err:.3g} of max|out| vs one device; dropout-0 step vs one "
        f"rank: loss rel {errs0[0]:.3g}, grad_norm rel {errs0[1]:.3g}, "
        f"mu gap {errs0[3]:.3g} of its bound, params {errs0[4]:.3g} "
        f"({errs0[2]:.3g} past lr |u - u'| near eps; 4096 samples a "
        f"leaf); dropout {case.temporal.dropout} step vs the one-stage "
        f"pipeline: loss rel {errs1[0]:.3g}, grad_norm rel "
        f"{errs1[1]:.3g}, mu gap {errs1[3]:.3g} of its bound, params "
        f"{errs1[4]:.3g} ({errs1[2]:.3g} past the allowance) (STEP_TOL "
        f"{STEP_TOL}); each stage: flash "
        f"fwd/dq/dkv {per_stage} a step; wall ms a step (third step) by "
        f"stage {[round(r['step'][3], 1) for r in ranks]} vs one stage "
        f"{one[3]:.1f}; {spawned:.1f} s with spawning, {seconds:.1f} s "
        "in all")
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        save_init_checkpoints(get_case("cylinder_flow_smoke_deep"), save_dir,
                              seed=1)
        line, seconds = _torchrun_train("cylinder_flow_smoke_deep",
                                        ["--pp", "2"], save_dir,
                                        "train-pipe")
    log(f"[train-pipe] torchrun --nproc_per_node 2 -m sea_tpu_torch "
        f"cylinder_flow_smoke_deep temporal train --pp 2: {line}; one line "
        f"from rank 0; the npz finite; {seconds:.1f} s")


def _one_device_unfused(argv):
    """`temporal test` on one device with the attention projections left
    unfused (as a mesh serves them): the same math, other launch shapes
    for the int4 kernel, so other orders of its sums."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.utils import precision as prec
    real = prec.fuse_attention_projections
    prec.fuse_attention_projections = lambda params: params
    try:
        return cli.main(argv)
    finally:
        prec.fuse_attention_projections = real


SERVE_MESH_KEYS = ("encoded_rel_mse", "decoded_rel_mse",
                   "decoded_rel_mse_per_time")
# [serve-mesh]'s int4 cells, by KV cache: the gap between the one-device
# runs with the projections fused and unfused, as recorded on an H100
# 80GB HBM3 at 700 W (the same to four digits in three runs; PERF.md
# section 6). A mesh run is held to 4 x the gap measured in the same call,
# capped at 4 x the recorded gap; a measured gap over twice its record
# fails on its own.
SERVE_MESH_GAP = {
    "f32": {"encoded_rel_mse": 8.128e-5, "decoded_rel_mse": 9.331e-5,
            "decoded_rel_mse_per_time": 1.7962e-3},
    "int8": {"encoded_rel_mse": 6.297e-5, "decoded_rel_mse": 1.5910e-4,
             "decoded_rel_mse_per_time": 1.7892e-3}}
SERVE_MESH_GAP_FACTOR = 2.0


def phase_serve_mesh(case, save_dir, params_np):
    """[serve-mesh]: multiphase `temporal test` (E=2048) through the CLI in
    two ranks sharing the card over gloo, against the one-device run:
    --mesh 1x2 at int4 weights with an f32 and with an int8 cache, and
    --mesh 2x1 at f32 (a trajectory a rank, every head), rtol 1e-4. Every
    rank's decodes run on its heads (H/2 at 1x2), its int4 matvecs on its
    slices, the unfused projections' count a step.
    The int4 kernel's split-K plan follows the matrix shape and it rounds
    its input to bf16, so a sum in another order can move an input by a
    bf16 ulp, and a random 40-step rollout carries that on: a one-device
    run with the projections unfused (other shapes, the same math) is
    1.8e-3 from the fused one in decoded_rel_mse_per_time (an H100 80GB
    HBM3 at 700 W), and tensor parallelism changes the shapes more. The
    int4 cells are held to 4 times that one-device fused/unfused gap,
    measured in the same call but at most 4 times its record
    (SERVE_MESH_GAP), or 1e-4, whichever is larger; a gap over
    SERVE_MESH_GAP_FACTOR times its record fails."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.parallel.multihost import run_ranks
    per_step = _attentions(case.temporal)[0]
    H = case.temporal.n_heads
    base = [CASE, "temporal", "test", "--synthetic", "--save_dir", save_dir,
            "--device", "cuda", "--no_drift_check"]
    int4 = ["--precision", "int4", "--no_calibrate"]
    cells = [("1x2", int4 + ["--kv_cache", "f32"]),
             ("1x2", int4 + ["--kv_cache", "int8"]), ("2x1", [])]
    # The int4 linears a step runs unfused, as a mesh serves them.
    int4_sites = sum(_int4_sites_per_step(_reduced_params(
        params_np, "int4", fuse=False), case.temporal).values())
    for spec, flags in cells:
        _reset_launch_counts()
        t0 = time.perf_counter()
        one = cli.main(base + flags)
        one_s = time.perf_counter() - t0
        one_counts = _launch_counts()
        rtol, noise = 1e-4, None
        bounds = dict.fromkeys(SERVE_MESH_KEYS, rtol)
        if "int4" in flags:
            unfused = _one_device_unfused(base + flags)
            noise = {k: float(np.max(np.abs(unfused[k] - one[k])
                                     / np.abs(one[k]))) for k in
                     SERVE_MESH_KEYS}
            record = SERVE_MESH_GAP[flags[flags.index("--kv_cache") + 1]]
            for k in SERVE_MESH_KEYS:
                if not noise[k] <= SERVE_MESH_GAP_FACTOR * record[k]:
                    raise AssertionError(
                        f"[serve-mesh] {' '.join(flags)}: the one-device "
                        f"fused/unfused gap in {k} is {noise[k]}, over "
                        f"{SERVE_MESH_GAP_FACTOR} x its record {record[k]}")
                bounds[k] = max(rtol, min(4 * noise[k], 4 * record[k]))
        t0 = time.perf_counter()
        ranks = run_ranks(_serve_mesh_rank, 2,
                          base + flags + ["--mesh", spec],
                          device=MESH_DEVICE)
        seconds = time.perf_counter() - t0
        T_roll = one["decoded_rel_mse_per_time"].shape[0]
        worst = {}
        for rank, (metrics, counts, heads) in enumerate(ranks):
            for key in SERVE_MESH_KEYS:
                bound = bounds[key]
                rel = float(np.max(np.abs(metrics[key] - one[key])
                                   / np.abs(one[key])))
                worst[key] = max(worst.get(key, 0.0), rel)
                if not rel <= bound:
                    raise AssertionError(
                        f"[serve-mesh] {spec} {' '.join(flags)} rank "
                        f"{rank}: {key} {metrics[key]} vs one device "
                        f"{one[key]}: rel {rel} > {bound}")
            q8 = "int8" in flags
            decodes = counts["decode_q8" if q8 else "decode_attention"]
            want_heads = {H // int(spec[-1]): per_step * T_roll}
            if decodes != per_step * T_roll or heads != want_heads:
                raise AssertionError(
                    f"[serve-mesh] {spec} rank {rank}: {decodes} decodes, "
                    f"heads {heads}; want {per_step * T_roll} on "
                    f"{want_heads}")
            if int4[1] in flags and \
                    counts["int4_matvec"] != int4_sites * T_roll:
                raise AssertionError(
                    f"[serve-mesh] {spec} rank {rank}: "
                    f"{counts['int4_matvec']} int4 launches, want "
                    f"{int4_sites} a step x {T_roll}")
        what = " ".join(flags[:2] + flags[3:]) or "f32"
        log(f"[serve-mesh] {CASE} temporal test --mesh {spec} {what} (2 "
            f"ranks on one card, gloo), {T_roll} steps: encoded_rel_mse "
            f"{ranks[0][0]['encoded_rel_mse']:.7g} vs one device "
            f"{one['encoded_rel_mse']:.7g}, decoded_rel_mse "
            f"{ranks[0][0]['decoded_rel_mse']:.7g} vs "
            f"{one['decoded_rel_mse']:.7g}; worst rel over every rank "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + (f" (bound 1e-4)" if noise is None else
               " (bound max(1e-4, 4 x min(the one-device fused/unfused "
               "gap, its record)): gap " + ", ".join(
                   f"{k} {v:.4g}" for k, v in noise.items())
               + "; bound " + ", ".join(
                   f"{k} {v:.4g}" for k, v in bounds.items()) + ")")
            + f"; every rank {per_step * T_roll} decodes on "
            f"{H // int(spec[-1])} heads"
            + (f", {ranks[0][1]['int4_matvec'] // T_roll} int4 matvecs a "
               f"step on its slices (one device, fused: "
               f"{one_counts['int4_matvec'] // T_roll})"
               if int4[1] in flags else "")
            + f"; {seconds:.1f} s with spawning, one device {one_s:.1f} s")


# ---------------------------------------------------------------------------
# The int4 matvec microbenchmarks (sea_tpu_torch/tools/)
# ---------------------------------------------------------------------------

# [tools-quant]: the eight kernels of csrc/quant_bench.cu at the tools'
# shape, B = 1 and 8 rows of x, block_n 512; both entry points at
# TOOLS_REPEATS steps (their defaults: 100 and 2000). At TOOLS_WIDE, a
# weight of 67 MB, past the 50 MB L2, whose byte bound (0.020 ms) stands
# well above [kernel-time]'s ~0.005 ms floor, the kernels of
# TOOLS_WIDE_KERNELS are checked and timed too (dma_only at B = 1 only).
TOOLS_SHAPES = [(1, 2048, 16384), (8, 2048, 16384)]
TOOLS_WIDE = [(1, 2048, 65536), (8, 2048, 65536)]
TOOLS_WIDE_KERNELS = ("matvec_p4", "_unpack_only_call", "dma_only")
TOOLS_BLOCK_N = 512
TOOLS_REPEATS = 100
TOOLS_KERNELS = [  # name, module, the TPU function it replaces
    ("matvec_p4", "bench_quant_matvec", "tools/bench_quant_matvec.py:56"),
    ("matvec_p4b", "bench_quant_matvec", "tools/bench_quant_matvec.py:85"),
    ("matvec_p4c", "bench_quant_matvec", "tools/bench_quant_matvec.py:118"),
    ("matvec_s8", "bench_quant_matvec", "tools/bench_quant_matvec.py:142"),
    ("stream_bytes", "bench_quant_matvec",
     "tools/bench_quant_matvec.py:169"),
    ("dma_only", "bench_quant_matvec", "tools/bench_quant_matvec.py:186"),
    ("_unpack_only_call", "bench_unpack_ceiling",
     "tools/bench_unpack_ceiling.py:73"),
    ("_mvt_call", "bench_unpack_ceiling",
     "tools/bench_unpack_ceiling.py:115"),
]


def _tools_modules():
    from sea_tpu_torch.tools import bench_quant_matvec as PQ
    from sea_tpu_torch.tools import bench_unpack_ceiling as PU
    return {"bench_quant_matvec": PQ, "bench_unpack_ceiling": PU}


def _tools_cases(B, K, N, bn):
    """{name: (kernel, plain, check, magnitude, bytes, library)} of the
    eight kernels on seeded inputs on the card: x bf16 [B, K], an int4 q
    (-8..7) packed input- and output-major, int8 w8, s f32 [1, N]. check is
    "rel" (|err| <= INT4_REL_TOL x sum|x w s|, elementwise; mag is sum|x w
    s|), "equal", or "parts" for _unpack_only_call, whose mag is then
    (parts, faults): its kernel's parts (bench_unpack_ceiling.
    unpack_only_parts) and the check that lists what is wrong in any
    parts (unpack_only_faults: integer sums exact, sum(x) within
    UNPACK_X_TOL x sum|x|, out their f32 sum bit for bit). The library
    call computes the same function in one PyTorch call (cuBLAS bf16 over
    the dequantized weight; torch.sum over the byte tiles), or is None."""
    mods = _tools_modules()
    PQ, PU = mods["bench_quant_matvec"], mods["bench_unpack_ceiling"]
    g = torch.Generator(device="cuda").manual_seed(B + K + N)
    q = torch.randint(-8, 8, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    w8 = torch.randint(-128, 128, (K, N), device="cuda", generator=g,
                       dtype=torch.int8)
    x = torch.randn(B, K, device="cuda", generator=g).to(torch.bfloat16)
    s = torch.rand(1, N, device="cuda", generator=g) * 0.01 + 1e-3
    wp, wpt, st = PQ.pack_nibbles(q), PU.pack_int4_t(q), s.reshape(N, 1)
    xa = x.float().abs()
    mag4, mag8 = (xa @ q.float().abs()) * s, (xa @ w8.float().abs()) * s
    W4 = (q.float() * s).to(torch.bfloat16)
    W8 = (w8.float() * s).to(torch.bfloat16)
    io = B * K * 2 + N * 4 + B * N * 4  # x read, s read, y written
    kw = {"block_n": bn}
    cases = {}
    for name, w, mag, W, nbytes in (
            ("matvec_p4", wp, mag4, W4, K * N // 2),
            ("matvec_p4b", wp, mag4, W4, K * N // 2),
            ("matvec_p4c", wp, mag4, W4, K * N // 2),
            ("matvec_s8", w8, mag8, W8, K * N)):
        cases[name] = (functools.partial(getattr(PQ, name), x, w, s, **kw),
                       functools.partial(getattr(PQ, name + "_ref"), x, w, s,
                                         **kw), "rel", mag, nbytes + io,
                       functools.partial(torch.matmul, x, W))
    cases["_mvt_call"] = (
        functools.partial(PU._mvt_call, x, wpt, st, **kw),
        functools.partial(PU._mvt_call_ref, x, wpt, st, **kw), "rel", mag4,
        K * N // 2 + io, functools.partial(torch.matmul, x, W4))
    tiles = wp.view(K // 2, N // bn, bn)
    cases["stream_bytes"] = (
        functools.partial(PQ.stream_bytes, wp, **kw),
        functools.partial(PQ.stream_bytes_ref, wp, **kw), "equal", None,
        K * N // 2 + bn * 4,
        lambda: torch.sum(tiles, dim=(0, 1), dtype=torch.int32))
    cases["dma_only"] = (
        functools.partial(PQ.dma_only, wp, **kw),
        functools.partial(PQ.dma_only_ref, wp, **kw), "equal", None,
        K * N // 2 + bn * 4, None)
    cases["_unpack_only_call"] = (
        functools.partial(PU._unpack_only_call, x, wp, **kw),
        functools.partial(PU._unpack_only_call_ref, x, wp, **kw), "parts",
        (functools.partial(PU.unpack_only_parts, x, wp, **kw),
         functools.partial(PU.unpack_only_faults, x=x, wp=wp, **kw)),
        K * N // 2 + B * K * 2 + 4, None)
    return cases


def _planted_unpack_faults(parts):
    """Wrong forms of _unpack_only_call's parts (out, ints, xsum), each as
    a faulty kernel would write it, out formed from its own parts where
    the fault would be upstream of it: out less sum(x); sum(x) dropped;
    one 0x0F byte too many in the sums (lo + 7)."""
    out, ints, xsum = parts

    def formed(i, xs):
        return ((i[0].float() + i[1].float()) + xs).reshape(1, 1)

    more = ints + torch.tensor([7, 0], device=ints.device)
    return {"out - sum(x)": (out - xsum, ints, xsum),
            "sum(x) dropped": (formed(ints, 0 * xsum), ints, 0 * xsum),
            "a byte too many": (formed(more, xsum), more, xsum)}


def _tools_entry(module, argv):
    """Run an entry point's main on the card; its last line, parsed."""
    _, printed = _captured(module.main, argv)
    last = json.loads(printed.strip().splitlines()[-1])
    if last["device"] != torch.cuda.get_device_name(0) or not last["results"]:
        raise AssertionError(f"[tools-quant] {module.__name__}: last line "
                             f"{last}")
    return last


def _tools_check(case, label, unpack_tol):
    """Run one tools kernel twice and its plain version once and raise
    unless they agree as its check says and the two calls give the same
    bits; for _unpack_only_call also unless the check rejects the planted
    faults. Returns (max abs err, what was held)."""
    kernel, plain, check, mag, _, _ = case
    got, again = kernel(), kernel()
    want = plain()
    torch.cuda.synchronize()
    err = _err(got, want)
    if check == "equal":
        ok = torch.equal(got, want)
        held = "bit for bit"
    elif check == "parts":
        parts_fn, faults_of = mag
        parts = parts_fn()
        faults = faults_of(parts)
        ok = not faults and torch.equal(parts[0], got)
        if not ok:
            raise AssertionError(f"{label}: {faults}; out as "
                                 f"_unpack_only_call's {got.item()!r}, as "
                                 f"its parts' {parts[0].item()!r}")
        planted = _planted_unpack_faults(parts)
        missed = [k for k, p in planted.items() if not faults_of(p)]
        if missed:
            raise AssertionError(f"{label}: the check passed the planted "
                                 f"faults {missed}")
        held = (f"integer sums exact, sum(x) within {unpack_tol} x sum|x|, "
                f"out their f32 sum; planted faults rejected "
                f"{sorted(planted)}")
    else:
        ok = bool(((got - want).abs() <= INT4_REL_TOL * mag).all())
        held = f"within {INT4_REL_TOL} x sum|x w s|"
    if not ok or not torch.equal(got, again):
        raise AssertionError(f"{label}: max abs err {err} ({check}), two "
                             f"calls equal {torch.equal(got, again)}")
    return err, held


def _tools_time(name, case, B, K, N, flush):
    """[kernel-time] of one tools kernel, L2 cold, in turns plain, kernel,
    kernel, plain, beside its bound, its plain version and the library call
    where there is one; the kernel's and the library's GB/s of the
    function's bytes and their share of 3.35 TB/s. Returns the kernels
    line's timing keys."""
    kernel, plain, check, _, nbytes, library = case
    ms, plain_ms, runs = _kernel_vs_plain(kernel, plain, flush)
    # Operations: a multiply-add a weight and row of x (bf16 x times an
    # exact small integer: the bf16 tensor-core peak); the stream kernels
    # an add or less a byte.
    flops = 2 * B * K * N if check == "rel" else K * N
    bound, bound_by = _bound_ms(nbytes, flops, BF16_FLOP_PER_S)
    lib = _library_ms(library, flush) if library else None

    def rate(t):
        r = nbytes / (t * 1e-3)
        return f"{r / 1e9:.0f} GB/s, {r / HBM_BYTES_PER_S:.3f} of 3.35 TB/s"

    log(f"[kernel-time] {name} (B,K,N)=({B},{K},{N}) block_n "
        f"{TOOLS_BLOCK_N}, L2 cold: kernel {ms:.4f} ms ({runs[1]:.4f}, "
        f"{runs[2]:.4f}; {rate(ms)}), plain {plain_ms:.4f} ms "
        f"({runs[0]:.4f}, {runs[3]:.4f}), bound {bound:.4f} ms "
        f"({bound_by}), "
        + (f"library {lib:.4f} ms ({rate(lib)})" if lib is not None
           else "no single PyTorch call"))
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=bound_by,
                library_ms=lib)


def phase_tools_quant():
    """[tools-quant]: each of the eight kernels of sea_tpu_torch/tools/
    against its plain version at TOOLS_SHAPES, block_n TOOLS_BLOCK_N, each
    call one device kernel (torch.profiler) and two calls the same bits;
    then each timed as [kernel-time] times the others (L2 cold, in turns
    plain, kernel, kernel, plain), beside its bound, its plain version and
    the library call where there is one; the same checks and timings of
    TOOLS_WIDE_KERNELS at TOOLS_WIDE; then both entry points at
    TOOLS_REPEATS steps, whose mains fail on a reading above 1.05 x the HBM
    rate. Returns (max abs err, times at B = 1 of TOOLS_SHAPES, launches in
    the phase before the entry points) by kernel name."""
    mods = _tools_modules()
    unpack_tol = mods["bench_unpack_ceiling"].UNPACK_X_TOL
    for mod in mods.values():
        for key in mod.launches:
            mod.launches[key] = 0
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    errors = dict.fromkeys((n for n, _, _ in TOOLS_KERNELS), 0.0)
    times = {}
    for B, K, N in TOOLS_SHAPES:
        cases = _tools_cases(B, K, N, TOOLS_BLOCK_N)
        for name, _, _ in TOOLS_KERNELS:
            label = f"[tools-quant] {name} (B,K,N)=({B},{K},{N})"
            err, held = _tools_check(cases[name], label, unpack_tol)
            errors[name] = max(errors[name], err)
            names = _one_kernel_a_call(cases[name][0], label)
            log(f"{label}: max abs err {err:.3g} {held}; repeat bit for "
                f"bit; one device kernel a call ({names})")
            if name in ("stream_bytes", "dma_only") and B != 1:
                continue  # no x: timed once
            timed = _tools_time(name, cases[name], B, K, N, flush)
            if B == 1:
                times[name] = timed
        del cases
    for B, K, N in TOOLS_WIDE:
        cases = _tools_cases(B, K, N, TOOLS_BLOCK_N)
        for name in TOOLS_WIDE_KERNELS:
            if name == "dma_only" and B != 1:
                continue
            label = f"[tools-quant] {name} (B,K,N)=({B},{K},{N})"
            err, held = _tools_check(cases[name], label, unpack_tol)
            errors[name] = max(errors[name], err)
            log(f"{label}: max abs err {err:.3g} {held}; repeat bit for bit")
            _tools_time(name, cases[name], B, K, N, flush)
        del cases
    # The kernels line's launches: the calls above, each a launch.
    launches = {name: mods[module].launches[name]
                for name, module, _ in TOOLS_KERNELS}
    log(f"[tools-quant] launches in the phase's checks and timings: "
        f"{launches}")
    for module in mods.values():
        last = _tools_entry(module, ["--repeats", str(TOOLS_REPEATS)])
        log(f"[tools-quant] python -m {module.__name__} --repeats "
            f"{TOOLS_REPEATS}: " + "; ".join(
                f"{k} {r['us']:.3f} us {r['GB/s']:.1f} GB/s "
                f"({r['hbm_share']:.3f} of 3.35 TB/s)"
                for k, r in last["results"].items()))
    # The mains' timed loops run as CUDA graphs: a captured call records
    # its kernel and counts nothing, and the replays pass no wrapper. What
    # the mains add is their correctness checks' direct launches.
    log("[tools-quant] launches in the entry points' checks (their graphs' "
        "replays uncounted): " + str({
            name: mods[module].launches[name] - launches[name]
            for name, module, _ in TOOLS_KERNELS}))
    return errors, times, launches


KERNELS = [  # name, route, source, the TPU kernel it replaces
    ("decode_attention", "cuda", "sea_tpu_torch/csrc/decode_attention.cu",
     "sea_tpu/ops/decode_attention.py:48"),
    ("decode_q8", "cuda", "sea_tpu_torch/csrc/decode_attention.cu",
     "sea_tpu/ops/decode_attention.py:96"),
    ("flash_fwd", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:181"),
    ("flash_bwd_dq", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:415"),
    ("flash_bwd_dkv", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:451"),
    ("dropout_mask", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:608"),
    ("int4_matvec", "cuda", "sea_tpu_torch/csrc/quant_matmul.cu",
     "sea_tpu/ops/quant_matmul.py:104"),
    ("adaln_fwd", "cuda", "sea_tpu_torch/csrc/fused_adaln.cu",
     "sea_tpu/ops/fused_adaln.py:46"),
    ("adaln_bwd", "cuda", "sea_tpu_torch/csrc/fused_adaln.cu",
     "sea_tpu/ops/fused_adaln.py:62"),
    ("flash_fwd_bf16", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:181"),
    ("flash_bwd_dq_bf16", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:415"),
    ("flash_bwd_dkv_bf16", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:451"),
] + [(name, "cuda", "sea_tpu_torch/csrc/quant_bench.cu", tpu)
     for name, _, tpu in TOOLS_KERNELS]


def _timed(fn, *args, **kwargs):
    """fn(*args, **kwargs), with its wall time logged."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    log(f"[time] {fn.__name__}: {time.perf_counter() - t0:.1f} s")
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false); it runs on a GPU machine")
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.utils.params import save_init_checkpoints

    phase_build()
    errors = {"decode_attention": phase_kernel_check(),
              "decode_q8": phase_q8_check(),
              "int4_matvec": phase_int4_check(),
              "dropout_mask": phase_mask_check(),
              **phase_flash_check(), **phase_flash_check_bf16(),
              **phase_adaln_check()}
    # Early, while torch.profiler records every launch: once the process
    # has run a while without a session (from [serve] on), sessions lose
    # device events at random, PyTorch's own kernels' too
    # (chip_profiler_probe.py), and this phase counts kernels under it.
    tools_errors, tools_times, tools_launches = _timed(phase_tools_quant)
    errors.update(tools_errors)
    for name, err in _timed(phase_mesh_kernels).items():
        errors[name] = max(errors[name], err)
    launches = {"dropout_mask": phase_flash_dropout()}
    case = get_case(CASE)
    train_case = get_case(TRAIN_CASE)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        params_np = save_init_checkpoints(case, save_dir,
                                          seed=1)["temporal"]
        launches["decode_attention"] = phase_serve(case, save_dir)
        _timed(phase_serve_artifacts, case, save_dir, params_np)
        _timed(phase_generate, case, save_dir)
        reduced = phase_serve_reduced(case, save_dir, params_np)
        _timed(phase_serve_mesh, case, save_dir, params_np)
    launches.update({k: reduced["int4"][k]
                     for k in ("decode_q8", "int4_matvec")})
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        train_np = save_init_checkpoints(train_case, save_dir,
                                         seed=1)["temporal"]
        train_launches, cli_trace = phase_train(train_case, save_dir)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        save_init_checkpoints(train_case, save_dir, seed=1)
        bf16_launches, _ = phase_train(train_case, save_dir, bf16=True)
    launches.update({k: train_launches[k] for k in (
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv", "adaln_fwd",
        "adaln_bwd")})
    launches.update({k: bf16_launches[k] for k in (
        "flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")})
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        _timed(phase_encoder_train, train_case, save_dir)
        _timed(phase_encoder_test, train_case, save_dir)
    _timed(phase_encoder_card_vs_cpu)
    _timed(phase_checkpoint_pt)
    _timed(phase_encoder_train_time)
    f32_step = _timed(phase_train_card_vs_cpu, train_case, train_np)
    _timed(phase_train_card_vs_cpu_bf16, train_case, train_np, f32_step)
    mesh_ref = _timed(phase_train_mesh, train_case, train_np)
    _timed(phase_seq_ring)
    _timed(phase_train_seq, train_case, train_np, mesh_ref)
    _timed(phase_train_pipe, train_case)
    _timed(phase_train_time, train_case, train_np, cli_trace=cli_trace)
    _timed(phase_train_time, train_case, train_np, BF16_RECIPE)
    _timed(phase_train_optim, train_case, train_np)
    _timed(phase_train_modes, train_case)
    _timed(phase_train_remat, train_case)
    _timed(phase_serve_modes, case)
    _timed(phase_card_vs_cpu, case, params_np)
    _timed(phase_serve_prefix, case, params_np)
    _timed(phase_serve_prefix_masked, case)
    _timed(phase_engine_time, {CASE: _reduced_params(params_np, "f32"),
                               TRAIN_CASE: _reduced_params(train_np, "f32")})
    _timed(phase_card_vs_cpu_int4, case, params_np)
    _timed(phase_time_rollout, case, params_np)
    _timed(phase_profile, case, params_np)
    _timed(phase_rollout_reduced, case, params_np)
    times = {"decode_attention": phase_time_kernel()[
        (KERNEL_SHAPES[0], torch.float32)], **phase_time_reduced_kernels()}
    flash, adaln = phase_time_flash(), phase_time_adaln()
    flash.update(phase_time_flash(torch.bfloat16))
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        times[name] = flash[(name, 128, 0.1)]
        times[name + "_bf16"] = flash[(name + "_bf16", 128, 0.1)]
    for name in ("adaln_fwd", "adaln_bwd"):
        times[name] = adaln[(name, 1024)]
    times.update(tools_times)
    launches.update(tools_launches)
    shapes = {"decode_attention": "(B,H,T,hd)=(1,8,250,256) f32, t=T-1",
              "decode_q8": "(B,H,T,hd)=(8,8,250,256) int8, t=T-1",
              "int4_matvec": "(M,K,N)=(1,2048,16384)",
              "dropout_mask": "(BH,Tq,Tk)=(8,512,512)",
              **{n + sfx: f"(B,T,H,hd)=(2,399,8,128) {dt} dropout 0.1"
                 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
                 for sfx, dt in (("", "f32"), ("_bf16", "bf16"))},
              **{n: "(B,T,E)=(2,399,1024)" for n in ("adaln_fwd",
                                                     "adaln_bwd")},
              **{n: f"(B,K,N)={TOOLS_SHAPES[0]} block_n {TOOLS_BLOCK_N}"
                 for n, _, _ in TOOLS_KERNELS}}
    log(f"[time] chip_smoke.py: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": tpu,
         "launches": launches[name], "max_abs_err": errors[name],
         **times[name], "shape": shapes[name]}
        for name, route, source, tpu in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
