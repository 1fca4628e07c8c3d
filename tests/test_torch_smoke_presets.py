"""The port's attention at the smoke presets' head dims, and the smoke
preset on the card.

The flash and decode kernels take head dims 8, 16, 64, 128 and 256: the
smoke presets (cylinder_flow_smoke: E=32 with 2 heads, so self-attention
hd 16 and exchange hd 8) included. ``ops.attention`` enters the kernel
wrappers at every head dim; a wrapper runs its plain version only on a
CPU tensor and on the card launches its kernel or raises. On the CPU that
path is checked with spies on the wrappers and their plain versions; on
the card (marked ``gpu``, skipped here) `temporal train` and `temporal
test` of the smoke preset run with ``--device cuda`` against the same runs
on the CPU.

No JAX here: the card has none (``python -m pytest
tests/test_torch_smoke_presets.py --noconftest -m gpu`` there).
"""

import re

import numpy as np
import pytest
import torch

from sea_tpu_torch import cli
from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
from sea_tpu_torch.ops import attention as A
from sea_tpu_torch.ops import decode_attention as DA
from sea_tpu_torch.ops import flash_attention as FA
from sea_tpu_torch.utils.params import save_init_checkpoints

torch.set_num_threads(2)

HEAD_DIMS = [8, 16, 64, 128, 256]
N_HEADS = 2


def _spy(monkeypatch, module, names, calls):
    """Replace each module.<name> by a wrapper that records the name."""
    for name in names:
        fn = getattr(module, name)

        def spy(*args, _fn=fn, _name=name, **kwargs):
            calls.append(_name)
            return _fn(*args, **kwargs)

        monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_full_sequence_attention_routes_by_head_dim(hd, monkeypatch):
    """multihead_core enters the flash wrapper at every head dim the
    kernels take, the smoke presets' included, dropout too; on a CPU
    tensor the wrapper runs the plain version."""
    calls = []
    _spy(monkeypatch, A, ["flash_attention"], calls)
    _spy(monkeypatch, FA, ["flash_attention_ref"], calls)
    rs = np.random.RandomState(hd)
    q, k, v = (torch.from_numpy(rs.randn(2, 5, N_HEADS * hd)
                                .astype(np.float32)) for _ in range(3))
    out = A.multihead_core(q, k, v, n_heads=N_HEADS, causal=True, rope=True,
                           dropout_rate=0.1, dropout_key=(1, 2),
                           deterministic=False)
    assert out.shape == q.shape and torch.isfinite(out).all()
    assert hd in FA.HEAD_DIMS
    assert calls == ["flash_attention", "flash_attention_ref"]


@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.int8],
                         ids=["f32", "int8"])
@pytest.mark.parametrize("hd", HEAD_DIMS)
def test_decode_attention_routes_by_head_dim(hd, cache_dtype, monkeypatch):
    """mha_step enters the decode wrapper at every head dim the kernels
    take; on a CPU tensor the wrapper runs the plain version of the
    cache's kind."""
    calls = []
    _spy(monkeypatch, A, ["decode_attention"], calls)
    _spy(monkeypatch, DA, ["decode_attention_ref", "decode_attention_q8_ref"],
         calls)
    C = N_HEADS * hd
    params = A.init_attention(torch.Generator().manual_seed(hd), C, N_HEADS)
    cache = A.init_kv_cache(2, 6, N_HEADS, hd, device="cpu",
                            dtype=cache_dtype)
    x = torch.from_numpy(np.random.RandomState(hd).randn(2, C)
                         .astype(np.float32))
    t = torch.tensor([3], dtype=torch.int32)
    out = A.mha_step(params, x, x, cache, t, n_heads=N_HEADS, rope=True)
    assert out.shape == x.shape and torch.isfinite(out).all()
    assert hd in DA.HEAD_DIMS
    plain = ("decode_attention_q8_ref" if cache_dtype == torch.int8
             else "decode_attention_ref")
    assert calls == ["decode_attention", plain]


# Card vs CPU, one epoch of the smoke preset from the same seeded weights
# and data. The dropout masks are the same hash on both devices; cuBLAS and
# the CPU BLAS sum in other orders, and the first AdamW steps move each
# parameter by about +-lr wherever |g| >> eps, so order noise stays near
# f32 rounding in the losses and in the decoded error of the rollout
# (41 autoregressive steps) that follows. Measured on an H100 80GB HBM3
# through the kernels: both losses equal to the 8 decimals the CLI prints,
# the decoded error within 8.2e-8 (relative).
SMOKE_RTOL = {"train_loss": 1e-4, "val_loss": 1e-4, "decoded_rel_mse": 1e-3}


def _smoke_run(save_dir, device, capsys):
    """temporal train --epochs 1, then temporal test of its checkpoint."""
    save_init_checkpoints(get_case(), str(save_dir), seed=1)
    argv = ["cylinder_flow_smoke", "temporal"]
    tail = ["--synthetic", "--save_dir", str(save_dir), "--device", device]
    cli.main(argv + ["train", "--epochs", "1"] + tail)
    line = re.search(r"^Epoch 1/1 train Loss (\S+) \| val Loss (\S+)$",
                     capsys.readouterr().out, re.M)
    results = cli.main(argv + ["test"] + tail)
    capsys.readouterr()
    return {"train_loss": float(line.group(1)),
            "val_loss": float(line.group(2)),
            "decoded_rel_mse": float(results["decoded_rel_mse"])}


@pytest.mark.gpu
def test_smoke_preset_trains_and_serves_on_cuda_as_on_cpu(tmp_path, capsys):
    """Runs on the card only: cylinder_flow_smoke (hd 16 and 8) trains and
    serves with --device cuda, through the flash, decode and fused AdaLN
    kernels, and agrees with the CPU run."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    counts = [(FA, "fwd_launches"), (FA, "dq_launches"),
              (FA, "dkv_launches"), (DA, "launches")]
    before = [getattr(m, n) for m, n in counts]
    got = _smoke_run(tmp_path / "cuda", "cuda", capsys)
    for (m, n), b in zip(counts, before):
        assert getattr(m, n) > b, f"{m.__name__}.{n}: no launch on the card"
    want = _smoke_run(tmp_path / "cpu", "cpu", capsys)
    for key, rtol in SMOKE_RTOL.items():
        with capsys.disabled():
            print(f"smoke card vs CPU {key}: {got[key]!r} vs {want[key]!r}, "
                  f"rel {abs(got[key] - want[key]) / abs(want[key]):.3g}")
        assert np.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=rtol,
                                   err_msg=key)


# The bf16 recipe on the card against the same run on the CPU: the two
# round to bf16 at other points (the kernels under their tiles' running
# max, cuBLAS's bf16 products), so they may differ by bf16 noise, not f32
# order. Held as tests/test_torch_train.py holds the port to JAX: each
# side's distance to the CPU's f32 run within BF16_NOISE times the other's
# plus the f32 tolerance above.
BF16_FLAGS = ["--compute_dtype", "bf16_shadow", "--adam_mu_dtype", "bf16"]
BF16_NOISE = 4.0


def _smoke_train(save_dir, device, capsys, flags=()):
    """temporal train --epochs 1: (train loss, val loss)."""
    save_init_checkpoints(get_case(), str(save_dir), seed=1)
    cli.main(["cylinder_flow_smoke", "temporal", "train", "--epochs", "1",
              "--synthetic", "--save_dir", str(save_dir), "--device",
              device, *flags])
    line = re.search(r"^Epoch 1/1 train Loss (\S+) \| val Loss (\S+)$",
                     capsys.readouterr().out, re.M)
    return float(line.group(1)), float(line.group(2))


@pytest.mark.gpu
def test_smoke_preset_trains_bf16_shadow_on_cuda_as_on_cpu(tmp_path,
                                                            capsys):
    """Runs on the card only: cylinder_flow_smoke trains with
    --compute_dtype bf16_shadow --adam_mu_dtype bf16 on the card through
    the bf16 flash kernels (every train step) and the f32 ones (the f32
    evaluation), and its losses agree with the CPU's within bf16 noise."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    names = ["fwd_launches_bf16", "dq_launches_bf16", "dkv_launches_bf16",
             "fwd_launches"]
    before = [getattr(FA, n) for n in names]
    got = _smoke_train(tmp_path / "cuda", "cuda", capsys, BF16_FLAGS)
    for name, b in zip(names, before):
        assert getattr(FA, name) > b, f"{name}: no launch on the card"
    assert (FA.dq_launches_bf16 - before[1] == FA.dkv_launches_bf16
            - before[2] > 0)
    want = _smoke_train(tmp_path / "cpu", "cpu", capsys, BF16_FLAGS)
    ref = _smoke_train(tmp_path / "f32", "cpu", capsys)
    for key, a, b, r in zip(("train_loss", "val_loss"), got, want, ref):
        f32_tol = SMOKE_RTOL[key] * abs(r)
        with capsys.disabled():
            print(f"smoke bf16 {key}: card {a!r}, CPU {b!r}, CPU f32 {r!r}")
        assert np.isfinite(a), key
        assert abs(a - r) <= BF16_NOISE * abs(b - r) + f32_tol, key
        assert abs(b - r) <= BF16_NOISE * abs(a - r) + f32_tol, key
