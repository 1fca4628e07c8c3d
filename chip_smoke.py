"""Smoke test of the PyTorch/CUDA port (sea_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel of the port from the sources in the
checkout (the two CUDA sources with one nvcc each, started together; the
Triton kernels at their first launch) and holds each against its plain
PyTorch version at the shapes its path gives it. Then it drives the
port's two paths through its CLI at full width, each with the launch
counts set to 0 just before and read just after:

- serving: `multiphase_flow temporal test --synthetic` (E=2048, 8 heads,
  MLP x8; random weights from a seeded torch.Generator). It checks that
  every attention of every rollout step ran the flash-decode kernel,
  compares rollout steps on the card with the same steps on the CPU,
  times 250-step rollouts and profiles them with torch.profiler.
- training: `cylinder_flow temporal train --synthetic --epochs 2` (E=1024,
  8 heads, MLP x8, dropout 0.1, AdaLN). It checks the loss and norms, the
  checkpoint, and that the launches of the flash-attention kernels
  (forward, dQ, dK/dV) and the fused AdaLN kernels (forward, backward)
  equal the model's count per step; compares one full-recipe step at
  B=2, T=399 on the card with the same step on the CPU; and times that
  step (median over 25 steps, peak memory, a torch.profiler pass).

Last, every kernel is timed against its plain version, its bound and,
where one PyTorch call computes the same function, that call. Any failure
raises and the exit code is not 0; without CUDA, or without the rest of
the repository, it exits non-zero before printing any result.

Output: one line per check and timing, then a JSON line of the kernels
({"kernels": [...]}), then, as the last line, the JSON status
{"ok": true, "device": {...}}.
"""

import csv
import dataclasses
import json
import math
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
KERNEL_SHAPES = [(1, 8, 250, 256), (1, 8, 250, 128), (8, 8, 250, 256),
                 (2, 8, 399, 64)]
# Kernel vs plain: f32 differs only in summation order; bf16 rounds q and
# the probabilities to bf16 in both versions, at different points.
KERNEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# Card vs CPU over the first rollout steps, f32 on both: cuBLAS and the
# CPU BLAS sum in different orders, and errors feed back through the
# autoregressive loop (8 steps of a 201M-parameter model).
ROLLOUT_STEPS_CHECKED = 8
ROLLOUT_ATOL = 1e-3
TIMED_STEPS = 250

TRAIN_CASE = "cylinder_flow"
TRAIN_EPOCHS = 2
# (B, Tq, Tk, H, hd, src_len): the train step's self-attention (hd 128)
# and exchange (hd 64) at T=399, hd 256, one token, and Tq != Tk with
# keys above the band.
FLASH_SHAPES = [(2, 399, 399, 8, 128, 0), (2, 399, 399, 8, 64, 0),
                (4, 199, 199, 8, 256, 0), (1, 1, 1, 8, 64, 0),
                (2, 70, 130, 8, 128, 5)]
FLASH_SEED = (123456789, -987654321)
# f32, summation order only: the bounds of tests/test_flash_attention.py.
# A dropout bit the kernel and the plain version disagree on is off by
# about |v| / (1 - rate), far outside them.
FLASH_TOL = {"out": 2e-5, "grad": 5e-5}
# (B, T, E) of the train step's AdaLN sites. (atol, rtol) per element,
# |got - want| <= atol + rtol |want|: the bounds of
# tests/test_fused_adaln.py (its output check keeps numpy's default rtol
# 1e-7: outputs reach ~8, where an f32 ulp is ~1e-6, and the Triton and
# PyTorch row normalisations round rsqrt differently).
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
# NVIDIA H100 SXM data sheet: HBM rate and the f32 rate outside the
# tensor cores (the kernels here run f32 FMAs on the CUDA cores).
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def log(msg):
    print(msg, flush=True)


def phase_build():
    """Both CUDA sources with one nvcc each, started together; then the
    Triton kernels, compiled at their first launch."""
    from sea_tpu_torch.ops import _build
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    t0 = time.perf_counter()
    with ThreadPoolExecutor(2) as pool:
        for future in [pool.submit(DA._library), pool.submit(FA._library)]:
            future.result()
    log(f"[build] decode_attention.cu, flash_attention.cu -> "
        f"{_build.BUILD_DIR} in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    x = torch.randn(2, 8, 1024, device="cuda")
    cw = torch.randn(2, 1, 1024, device="cuda")
    w = torch.ones(1024, device="cuda")
    FAL.adaln_fwd(x, cw, cw, w, w)
    FAL.adaln_bwd(x, cw, x, w)
    torch.cuda.synchronize()
    log(f"[build] fused_adaln Triton kernels compiled and launched in "
        f"{time.perf_counter() - t0:.2f} s")


def _cases(shape, dtype):
    B, H, T, hd = shape
    g = torch.Generator(device="cuda").manual_seed(sum(shape))
    q = torch.randn(B, H, hd, device="cuda", generator=g)
    K = torch.randn(B, H, T, hd, device="cuda", generator=g).to(dtype)
    V = torch.randn(B, H, T, hd, device="cuda", generator=g).to(dtype)
    return q, K, V


def phase_kernel_check():
    """Kernel against decode_attention_ref at the path's shapes, f32 and
    bf16 caches, t at 0, the split edges, the TPU kernel's 256-key block
    edge and T-1; and with NaN past t, which the kernel must never read."""
    from sea_tpu_torch.ops import decode_attention as DA
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = 0.0
    for shape in KERNEL_SHAPES:
        B, H, T, hd = shape
        splits, chunk = DA.split_plan(T, B * H, sms)
        positions = sorted({0, chunk - 1, chunk, 2 * chunk, 255, 256, T - 1}
                           & set(range(T)))
        for dtype in KERNEL_TOL:
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
            log(f"[kernel] {shape} {str(dtype)[6:]} splits={splits}x{chunk} "
                f"t={positions}: max abs err {max(errs):.3g} <= "
                f"{KERNEL_TOL[dtype]}; NaN past t ignored")
    return worst


def phase_serve(case, save_dir):
    """`temporal test` through the port's CLI on the card. Every attention
    of every rollout step must have launched the flash-decode kernel."""
    from sea_tpu_torch import cli
    tcfg = case.temporal
    G = tcfg.num_fields
    _reset_launch_counts()
    t0 = time.perf_counter()
    results = cli.main([CASE, "temporal", "test", "--synthetic",
                        "--save_dir", save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    counts = _launch_counts()
    launches = counts.pop("decode_attention")
    if any(counts.values()):
        raise AssertionError(f"serving launched training kernels: {counts}")
    T_roll = results["decoded_rel_mse_per_time"].shape[0]
    expected = tcfg.num_layers * (G + G * (G - 1)) * T_roll
    for key in ("encoded_rel_mse", "decoded_rel_mse"):
        if not np.isfinite(results[key]):
            raise AssertionError(f"{key} = {results[key]}")
    if not np.all(np.isfinite(results["decoded_rel_mse_per_time"])):
        raise AssertionError("non-finite decoded rel-MSE per time")
    if launches != expected:
        raise AssertionError(f"decode_attention launched {launches} times, "
                             f"expected {expected}")
    log(f"[serve] {CASE} temporal test: {T_roll} steps in {seconds:.2f} s "
        f"(data, encode, load, rollout, decode); encoded_rel_mse "
        f"{results['encoded_rel_mse']:.6g}, decoded_rel_mse "
        f"{results['decoded_rel_mse']:.6g}; decode_attention launches "
        f"{launches} = {tcfg.num_layers} layer x ({G} self + {G * (G - 1)} "
        f"exchange) x {T_roll} steps")
    return launches


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


def phase_time_rollout(case, params_np):
    """250-step f32 rollouts, B=1 and B=8: one warm-up, then the median of
    3 runs, each ended by torch.cuda.synchronize()."""
    from sea_tpu_torch.rollout.engine import rollout_scan
    from sea_tpu_torch.utils.params import from_numpy
    cfg = case.temporal
    params = from_numpy(params_np, "cuda")
    rates = {}
    for B in (1, 8):
        x0, ib = (a.cuda() for a in _rollout_inputs(cfg, B, TIMED_STEPS,
                                                    seed=B))
        y = rollout_scan(params, cfg, x0, ib)
        torch.cuda.synchronize()
        if not torch.isfinite(y).all():
            raise AssertionError(f"B={B} rollout is not finite")
        times = []
        for _ in range(3):
            t0 = time.perf_counter()
            rollout_scan(params, cfg, x0, ib)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        rates[B] = TIMED_STEPS / med
        log(f"[rollout] {CASE} f32 B={B}: {TIMED_STEPS} steps in median "
            f"{med:.4f} s of {[round(t, 4) for t in times]} -> "
            f"{TIMED_STEPS / med:.1f} steps/s, "
            f"{B * TIMED_STEPS / med:.1f} trajectory-steps/s, "
            f"{1e3 * med / TIMED_STEPS:.3f} ms/step")
    return rates


def phase_profile(case, params_np):
    """torch.profiler over one 250-step rollout at B=1 and B=8, after a
    warm-up rollout: device events and device busy time per step, their
    share of the profiled wall, and the kernels that take the most device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.rollout.engine import rollout_scan
    from sea_tpu_torch.utils.params import from_numpy
    cfg = case.temporal
    params = from_numpy(params_np, "cuda")
    for B in (1, 8):
        x0, ib = (a.cuda() for a in _rollout_inputs(cfg, B, TIMED_STEPS,
                                                    seed=B))
        rollout_scan(params, cfg, x0, ib)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            rollout_scan(params, cfg, x0, ib)
            torch.cuda.synchronize()
            wall_us = 1e6 * (time.perf_counter() - t0) / TIMED_STEPS
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in events) / TIMED_STEPS
        if not busy_us > 0:
            raise AssertionError(f"B={B}: the profiler saw no device time")
        log(f"[profile] {CASE} f32 B={B}, {TIMED_STEPS}-step rollout: "
            f"{sum(e.count for e in events) / TIMED_STEPS:.1f} device "
            f"events/step, device busy {busy_us:.1f} us/step, profiled "
            f"wall {wall_us:.1f} us/step, busy share "
            f"{100 * busy_us / wall_us:.1f}%")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
            us = e.self_device_time_total / TIMED_STEPS
            log(f"[profile] B={B} {us:8.2f} us/step "
                f"{e.count / TIMED_STEPS:6.1f}/step {e.key[:100]}")


def _device_ms(fn, flush, iters=50):
    """Median device time of fn() in ms. Each call starts with L2 cold: a
    sum over 512 MB runs first (a read, so no dirty lines are left to
    write back) and keeps the card busy while the host enqueues the call,
    so the events time the device, not the host."""
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    for s, e in zip(starts, ends):
        flush.sum()
        s.record()
        fn()
        e.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in zip(starts, ends))


def _bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over
    the HBM rate and the f32 operations over the f32 peak."""
    by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    by_ops = 1e3 * flops / F32_FLOP_PER_S
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
    B, Tq, Tk, H, hd, _ = shape
    g = torch.Generator(device="cuda").manual_seed(B * Tq + Tk + hd)
    return [torch.randn(B, T, H, hd, device="cuda", generator=g)
            for T in (Tq, Tk, Tk, Tq)]


def _flash_kw(shape, rate):
    return dict(causal=True, src_len=shape[5], dropout_rate=rate,
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
            log(f"[kernel] flash (B,Tq,Tk,H,hd,src_len)={shape} "
                f"dropout={rate}: max abs err fwd {errs['flash_fwd']:.3g}"
                f" <= {FLASH_TOL['out']}, dq {errs['flash_bwd_dq']:.3g}, "
                f"dk/dv {errs['flash_bwd_dkv']:.3g} <= {FLASH_TOL['grad']}")
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
    dx/dgw/dgb of the backward kernel, and all five gradients through the
    autograd wrapper."""
    from sea_tpu_torch.ops import fused_adaln as FAL
    worst = {"adaln_fwd": 0.0, "adaln_bwd": 0.0}
    for shape in ADALN_SHAPES:
        x, cw, cb, w, b, gy = _adaln_inputs(shape)
        pairs = {"adaln_fwd": [(FAL.adaln_fwd(x, cw, cb, w, b),
                                FAL.adaln_modulate_ref(x, cw, cb, w, b))],
                 "adaln_bwd": list(zip(FAL.adaln_bwd(x, cw, gy, w),
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
        log(f"[kernel] fused AdaLN (B,T,E)={shape}: max abs err fwd "
            f"{errs['adaln_fwd']:.3g} within (atol, rtol) "
            f"{ADALN_TOL['out']}, bwd {errs['adaln_bwd']:.3g} within "
            f"{ADALN_TOL['grad']}")
    return worst


def _launch_counts():
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    return {"decode_attention": DA.launches, "flash_fwd": FA.fwd_launches,
            "flash_bwd_dq": FA.dq_launches, "flash_bwd_dkv": FA.dkv_launches,
            "adaln_fwd": FAL.fwd_launches, "adaln_bwd": FAL.bwd_launches}


def _reset_launch_counts():
    from sea_tpu_torch.ops import decode_attention as DA
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import fused_adaln as FAL
    DA.launches = 0
    FA.fwd_launches = FA.dq_launches = FA.dkv_launches = 0
    FAL.fwd_launches = FAL.bwd_launches = 0


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


def phase_train(case, save_dir):
    """`temporal train` through the port's CLI on the card. Per train step
    the G=2, one-layer model runs L*G^2 = 4 attentions (2 self, 2
    exchange) and L*(2G + G^2) + G = 10 AdaLN sites (ln_exp[i][0] x2,
    ln_cross x4, ln_exp[i][2] x2, ln_final x2), each forward and backward;
    an evaluation forward runs the forwards only."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.checkpoint import (checkpoint_path,
                                                load_full_checkpoint)
    from sea_tpu_torch.utils.params import (opt_state_to_numpy, to_numpy,
                                            tree_leaves)
    cfg = case.temporal
    G, nl = cfg.num_fields, cfg.num_layers
    attn, norms = nl * G * G, nl * (2 * G + G * G) + G
    steps, evals = _train_schedule(case)
    _reset_launch_counts()
    t0 = time.perf_counter()
    params = cli.main([TRAIN_CASE, "temporal", "train", "--synthetic",
                       "--epochs", str(TRAIN_EPOCHS), "--save_dir", save_dir,
                       "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _launch_counts()
    expected = {"decode_attention": 0,
                "flash_fwd": attn * (steps + evals),
                "flash_bwd_dq": attn * steps, "flash_bwd_dkv": attn * steps,
                "adaln_fwd": norms * (steps + evals),
                "adaln_bwd": norms * steps}
    if launches != expected:
        raise AssertionError(f"train launches {launches}, expected "
                             f"{expected}")
    with open(Path(save_dir) / f"{TRAIN_CASE}_temporal_train_metrics.csv",
              newline="") as fh:
        rows = list(csv.DictReader(fh))
    logged = {(r["phase"], int(r["epoch"]), r["metric"]): float(r["value"])
              for r in rows}
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
    opt_template = opt_state_to_numpy(
        make_optimizer(case.temporal_train).init(template))
    loaded, opt, meta = load_full_checkpoint(path, to_numpy(template),
                                             opt_template)
    if opt is None or int(opt[0].count) != steps \
            or int(meta["epoch"]) != TRAIN_EPOCHS:
        raise AssertionError(f"checkpoint {path}: opt count "
                             f"{None if opt is None else opt[0].count}, "
                             f"meta {meta}")
    if not all(np.array_equal(a, b) for a, b in
               zip(tree_leaves(loaded), tree_leaves(params))):
        raise AssertionError("the checkpoint's params differ from the "
                             "returned best params")
    log(f"[train] {TRAIN_CASE} temporal train --synthetic --epochs "
        f"{TRAIN_EPOCHS}: {steps} steps + {evals} evaluation forwards in "
        f"{seconds:.2f} s (data, encode, init, train, validate, save); "
        f"losses {[logged[('train', e, 'Loss')] for e in range(1, TRAIN_EPOCHS + 1)]}, "
        f"grad norms "
        f"{[logged[('train', e, 'Grad_Norm')] for e in range(1, TRAIN_EPOCHS + 1)]}, "
        f"val loss {logged[('val', TRAIN_EPOCHS, 'Loss')]}; checkpoint "
        f"{Path(path).name} read back (count {int(opt[0].count)}); "
        f"launches {launches} = per step {attn} attentions x (fwd, dq, "
        f"dkv) and {norms} AdaLN sites x (fwd, bwd), per evaluation "
        f"forward {attn} + {norms} forwards")
    return launches


def _step_batch(cfg, B=2, T=399, seed=0):
    """Random latents [B, T, G, E], targets, and a constant ib."""
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*x.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, axis=1).astype(np.float32)
    return x, tgt, ib


def _step_fn(case, params_np, device):
    """A full-recipe train step of the case on device: time-constant ib
    (as the driver detects on the data), dropout on, AdamW."""
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.train.train_temporal import make_train_step
    from sea_tpu_torch.utils.params import from_numpy
    cfg = dataclasses.replace(case.temporal, ib_time_constant=True)
    tx = make_optimizer(case.temporal_train)
    params = from_numpy(params_np, device)
    state = tx.init(params)
    step = make_train_step(cfg, tx)
    batch = [torch.from_numpy(a).to(device) for a in _step_batch(cfg)]
    return cfg, step, params, state, batch


def phase_train_card_vs_cpu(case, params_np):
    from sea_tpu_torch.utils.params import to_numpy, tree_leaves
    from sea_tpu_torch.utils.prng import fold_in, prng_key
    key = fold_in(prng_key(0), 1)
    out = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        _, step, params, state, batch = _step_fn(case, params_np, device)
        params, state, stats = step(params, state, *batch, key)
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


def phase_train_time(case, params_np):
    """Median wall ms of the full-recipe step over TRAIN_TIMED_STEPS steps
    after 3 warm-up steps, each ended by torch.cuda.synchronize(); peak
    device memory over them; then a torch.profiler pass over 5 steps."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from sea_tpu_torch.utils.prng import prng_key, split
    _, step, params, state, batch = _step_fn(case, params_np, "cuda")
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
    log(f"[train-time] {TRAIN_CASE} full-recipe step B={B}, T={T} (f32, "
        f"dropout {case.temporal.dropout}, AdamW): median {1e3 * med:.3f} "
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
    log(f"[train-profile] {sum(e.count for e in events) / n_prof:.0f} "
        f"device events/step, device busy {busy_us / 1e3:.3f} ms/step, "
        f"profiled wall {wall_us / 1e3:.3f} ms/step, busy share "
        f"{100 * busy_us / wall_us:.1f}%")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:14]:
        us = e.self_device_time_total / n_prof
        log(f"[train-profile] {us / 1e3:8.3f} ms/step "
            f"{e.count / n_prof:6.1f}/step {100 * us / busy_us:5.1f}% "
            f"{e.key[:90]}")
    return med


def _band_pairs(Tq, Tk, src_len):
    return sum(min(Tk, q + 1 + src_len) for q in range(Tq))


def phase_time_flash():
    """The three flash kernels at the train step's shapes, dropout 0.1,
    against their plain pieces, their bounds and SDPA: its causal forward
    for the forward kernel, and its backward (dq, dk and dv in one call,
    over the graph of a forward taken outside the timing) for the two
    backward kernels. SDPA has no dropout here."""
    from sea_tpu_torch.ops import flash_attention as FA
    sdpa = torch.nn.functional.scaled_dot_product_attention
    flush = torch.ones(128 << 20, dtype=torch.float32, device="cuda")
    out = {}
    for shape in FLASH_SHAPES[:2]:
        B, Tq, Tk, H, hd, src_len = shape
        q, k, v, g = _flash_inputs(shape)
        kw = _flash_kw(shape, 0.1)
        o, lse = FA.flash_forward_ref(q, k, v, **kw)
        dsum = FA.row_dot(g, o)
        qt, kt, vt, gt = (x.transpose(1, 2).contiguous().requires_grad_(
            x is not g) for x in (q, k, v, g))
        with torch.no_grad():
            lib_fwd = _device_ms(lambda: sdpa(qt, kt, vt, is_causal=True),
                                 flush)
        graph_out = sdpa(qt, kt, vt, is_causal=True)
        lib_bwd = _device_ms(lambda: torch.autograd.grad(
            graph_out, (qt, kt, vt), gt, retain_graph=True), flush)
        pairs = B * H * _band_pairs(Tq, Tk, src_len)
        tensor = B * Tq * H * hd * 4
        rows = B * H * Tq * 4
        pieces = {
            "flash_fwd": (lambda: FA.flash_fwd(q, k, v, **kw),
                          lambda: FA.flash_forward_ref(q, k, v, **kw),
                          4 * tensor + rows, 4 * hd * pairs, lib_fwd),
            "flash_bwd_dq": (
                lambda: FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw),
                lambda: FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw),
                5 * tensor + 2 * rows, 6 * hd * pairs, lib_bwd),
            "flash_bwd_dkv": (
                lambda: FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw),
                lambda: FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum, **kw),
                6 * tensor + 2 * rows, 8 * hd * pairs, lib_bwd)}
        for name, (kernel, plain, nbytes, flops, lib) in pieces.items():
            ms, plain_ms, runs = _kernel_vs_plain(kernel, plain, flush)
            bound, bound_by = _bound_ms(nbytes, flops)
            out[(name, hd)] = dict(ms=ms, plain_ms=plain_ms, bound_ms=bound,
                                   bound_by=bound_by, library_ms=lib)
            log(f"[kernel-time] {name} (B,T,H,hd)=({B},{Tq},{H},{hd}) "
                f"dropout 0.1, L2 cold: kernel {ms:.4f} ms ({runs[1]:.4f}, "
                f"{runs[2]:.4f}; {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s), "
                f"plain {plain_ms:.4f} ms ({runs[0]:.4f}, {runs[3]:.4f}), "
                f"bound {bound:.4f} ms ({bound_by}), SDPA "
                f"{'forward' if name == 'flash_fwd' else 'backward'} "
                f"{lib:.4f} ms")
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
                          3 * row + 3 * B * E * 4 + E * 4, 16 * B * T * E)}
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


KERNELS = [  # name, route, source, the TPU kernel it replaces
    ("decode_attention", "cuda", "sea_tpu_torch/csrc/decode_attention.cu",
     "sea_tpu/ops/decode_attention.py:48"),
    ("flash_fwd", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:181"),
    ("flash_bwd_dq", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:415"),
    ("flash_bwd_dkv", "cuda", "sea_tpu_torch/csrc/flash_attention.cu",
     "sea_tpu/ops/flash_attention.py:451"),
    ("adaln_fwd", "triton", "sea_tpu_torch/ops/fused_adaln.py",
     "sea_tpu/ops/fused_adaln.py:46"),
    ("adaln_bwd", "triton", "sea_tpu_torch/ops/fused_adaln.py",
     "sea_tpu/ops/fused_adaln.py:62"),
]


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false); it runs on a GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.utils.params import save_init_checkpoints

    phase_build()
    errors = {"decode_attention": phase_kernel_check(),
              **phase_flash_check(), **phase_adaln_check()}
    case = get_case(CASE)
    train_case = get_case(TRAIN_CASE)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        params_np = save_init_checkpoints(case, save_dir,
                                          seed=1)["temporal"]
        launches = {"decode_attention": phase_serve(case, save_dir)}
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        train_np = save_init_checkpoints(train_case, save_dir,
                                         seed=1)["temporal"]
        train_launches = phase_train(train_case, save_dir)
    launches.update({k: v for k, v in train_launches.items()
                     if k != "decode_attention"})
    phase_train_card_vs_cpu(train_case, train_np)
    phase_train_time(train_case, train_np)
    phase_card_vs_cpu(case, params_np)
    phase_time_rollout(case, params_np)
    phase_profile(case, params_np)
    times = {"decode_attention": phase_time_kernel()[
        (KERNEL_SHAPES[0], torch.float32)]}
    flash, adaln = phase_time_flash(), phase_time_adaln()
    for name in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
        times[name] = flash[(name, 128)]
    for name in ("adaln_fwd", "adaln_bwd"):
        times[name] = adaln[(name, 1024)]
    shapes = {"decode_attention": "(B,H,T,hd)=(1,8,250,256) f32, t=T-1",
              **{n: "(B,T,H,hd)=(2,399,8,128) dropout 0.1"
                 for n in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")},
              **{n: "(B,T,E)=(2,399,1024)" for n in ("adaln_fwd",
                                                     "adaln_bwd")}}
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
