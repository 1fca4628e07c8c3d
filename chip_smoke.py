"""Smoke test of the PyTorch/CUDA port (sea_tpu_torch) on one NVIDIA GPU.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

It builds every hand-written kernel of the serving path from the sources
in the checkout, holds each against its plain PyTorch version, serves
`multiphase_flow temporal test --synthetic` through the port's CLI at full
width (E=2048, 8 heads, MLP x8; random weights from a seeded
torch.Generator), checks that the path ran through the kernels, compares
rollout steps on the card with the same steps on the CPU, and times the
kernel and the 250-step rollout. A torch.profiler pass over one 250-step
rollout at B=1 and B=8 then prints device events and busy time per step
and the kernels that take the most device time. Any failure raises and
the exit code is not 0; without CUDA, or without the rest of the
repository, it exits non-zero before printing any result.

Output: one line per check and timing, then a JSON line of the kernels
({"kernels": [...]}), then, as the last line, the JSON status
{"ok": true, "device": {...}}.
"""

import json
import statistics
import subprocess
import sys
import tempfile
import time
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


def log(msg):
    print(msg, flush=True)


def phase_build():
    from sea_tpu_torch.ops import _build
    from sea_tpu_torch.ops import decode_attention as DA
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    log(smi.stdout.strip())
    t0 = time.perf_counter()
    DA._library()
    log(f"[build] decode_attention.cu -> {_build.BUILD_DIR} in "
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
    from sea_tpu_torch.ops import decode_attention as DA
    tcfg = case.temporal
    G = tcfg.num_fields
    DA.launches = 0
    t0 = time.perf_counter()
    results = cli.main([CASE, "temporal", "test", "--synthetic",
                        "--save_dir", save_dir, "--device", "cuda"])
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = DA.launches
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


def phase_time_kernel():
    """Kernel and plain version at the phase-2 shapes, t = T-1 (every key
    valid), in turns plain, kernel, kernel, plain."""
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

            for fn in (plain, kernel):
                _device_ms(fn, flush, iters=5)  # warm-up
            p1, k1, k2, p2 = (_device_ms(fn, flush)
                              for fn in (plain, kernel, kernel, plain))
            ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
            out[(shape, dtype)] = (ms, plain_ms)
            B, H, T, hd = shape
            gbs = 2 * B * H * T * hd * K.element_size() / (ms * 1e-3) / 1e9
            log(f"[kernel-time] {shape} {str(dtype)[6:]} t=T-1, L2 cold: "
                f"kernel {ms:.4f} ms ({k1:.4f}, {k2:.4f}; {gbs:.0f} GB/s of "
                f"K/V), plain {plain_ms:.4f} ms ({p1:.4f}, {p2:.4f})")
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA device (torch.cuda.is_available() "
                 "is false); it runs on a GPU machine")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sea_tpu_torch.cli import get_case
    from sea_tpu_torch.utils.params import save_init_checkpoints

    phase_build()
    worst = phase_kernel_check()
    case = get_case(CASE)
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as save_dir:
        params_np = save_init_checkpoints(case, save_dir,
                                          seed=1)["temporal"]
        launches = phase_serve(case, save_dir)
    phase_card_vs_cpu(case, params_np)
    phase_time_rollout(case, params_np)
    phase_profile(case, params_np)
    times = phase_time_kernel()
    ms, plain_ms = times[(KERNEL_SHAPES[0], torch.float32)]
    print(json.dumps({"kernels": [{
        "name": "decode_attention", "route": "cuda",
        "source": "sea_tpu_torch/csrc/decode_attention.cu",
        "replaces": "sea_tpu/ops/decode_attention.py:48",
        "launches": launches, "max_abs_err": worst,
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
