"""Port parity end to end: stage-1 model, the fused rollout evaluation and
the `temporal test` CLI of sea_tpu_torch against the JAX package, on the
CPU.

- The spatial encoder/decoder runs the checked-in trained cylinder stage-1
  weights, restored into the port's own template.
- make_e2e_rollout_eval runs the port's seeded init on a tiny partition
  with min-max scalers, so the inverse affine is exercised.
- The two CLIs serve cylinder_flow_smoke's synthetic test split from the
  same checkpoints (the port's seeded init, written with save_pytree);
  their printed rel-MSEs agree to rtol 1e-4 although the JAX CLI rolls
  out on its prefix engine (f32, batch 1) and the port on the scan engine
  (tests/test_rollout.py proves the engines equal).
- The same at reduced precision (`--precision int4 --kv_cache int8`,
  `int8`, `bf16`; both CLIs on the scan engine), rtol 1e-4. Every smoke
  matrix is below the quantizers' default min_size (2^16), so both sides
  run with min_size 64. The port computes int4 matvecs and int8-cache
  attention with its kernels' math on the CPU too (bf16-rounded x and q),
  so for int4 the JAX CLI runs its kernels, forced on and in interpret
  mode. The runs skip the drift gate (`--no_drift_check`; its eager JAX
  forwards take most of a run's time): tests/test_torch_quant.py holds
  teacher_forced_drift to JAX's, and the gate's abort is tested here.

Tolerances: atol 1e-5 for the stage-1 model (f32, summation order), 2e-4
for anything downstream of a rollout (the bound of tests/test_rollout.py).
"""

import ast
import dataclasses
import functools
import os
import re
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sea_tpu.configs.cylinder_flow import get_case as cylinder_case
from sea_tpu.configs.cylinder_flow_smoke import get_case as smoke_case
from sea_tpu.data.mesh import MeshProcessor
from sea_tpu.data.synthetic import cylinder_like
from sea_tpu.utils.checkpoint import load_params
from sea_tpu_torch import cli as torch_cli
from sea_tpu_torch.data.latents import LatentService
from sea_tpu_torch.models import spatial as TS
from sea_tpu_torch.rollout.e2e import make_e2e_rollout_eval
from sea_tpu_torch.utils.params import (from_numpy, save_init_checkpoints,
                                        to_numpy)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAINED_STAGE1 = os.path.join(REPO, "checkpoints",
                              "encoder_decoder_cylinder_flow_run1.npz")
ROLLOUT_ATOL = 2e-4


def _close(got, want, atol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=atol)


def test_spatial_encode_decode_trained_weights():
    from sea_tpu.models import spatial as JS
    scfg = cylinder_case().spatial.with_n_inp(51)
    template = to_numpy(TS.init_spatial(scfg, torch.Generator(),
                                         device="cpu"))
    params_np = load_params(TRAINED_STAGE1, template)
    params = from_numpy(params_np, "cpu")
    x = np.random.RandomState(0).rand(3, 64, 3, 51).astype(np.float32)
    x[:, :, :, -5:] = TS.PAD_SENTINEL  # padded cells are masked to 0

    want_z = jax.jit(lambda p, x: JS.spatial_encode(
        p, scfg, JS.apply_padding_mask(x)))(params_np, x)
    got_z = TS.spatial_encode(params, scfg,
                              TS.apply_padding_mask(torch.from_numpy(x)))
    _close(got_z, want_z, 1e-5)

    z = np.array(want_z)  # a writable copy for torch.from_numpy
    want_x = jax.jit(lambda p, z: JS.spatial_decode(p, scfg, z))(params_np, z)
    _close(TS.spatial_decode(params, scfg, torch.from_numpy(z)), want_x,
           1e-5)

    # The latent service pads the last batch (3 = 2 + 1 padded) and trims.
    svc = LatentService(scfg, params, batch_size=2, device="cpu")
    np.testing.assert_allclose(svc.encode_dataset(x), want_z, rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(svc.decode_dataset(z), want_x, rtol=0,
                               atol=1e-5)
    # The module: decode(encode(mask(x))).
    _close(TS.SpatialModel(scfg, params).to("cpu")(torch.from_numpy(x)),
           want_x, 1e-5)


def test_spatial_variational_encode_matches_jax():
    """Variational stage 1 serves z = mu; (z, mu, logvar) all match. The
    weights are the port's own init (torch-default trunk, logvar heads),
    which the JAX functions must accept as they are."""
    from sea_tpu.models import spatial as JS
    scfg = dataclasses.replace(smoke_case().spatial, variational=True,
                               n_inp=10)
    params_np = to_numpy(TS.init_spatial(
        scfg, torch.Generator().manual_seed(3), device="cpu"))
    x = np.random.RandomState(1).rand(2, 4, 3, 10).astype(np.float32)
    want = jax.jit(lambda p, x: JS.spatial_encode(p, scfg, x))(params_np, x)
    got = TS.spatial_encode(from_numpy(params_np, "cpu"), scfg,
                            torch.from_numpy(x))
    for g, w in zip(got, want):
        _close(g, w, 1e-5)


def test_e2e_rollout_eval_matches_jax(tmp_path):
    """The weights are the port's seeded init, handed to both packages
    (test_torch_temporal holds that init to JAX's): random inits compile
    slowly in JAX on the CPU."""
    from sea_tpu_torch.models.temporal import init_temporal
    from sea_tpu.rollout.e2e import make_e2e_rollout_eval as jax_e2e
    case = smoke_case()
    mesh = dataclasses.replace(case.mesh, scale_feature_range=(-1.0, 1.0))
    fields, coords, ib = cylinder_like(tr=2, T=9, n_nodes=120, seed=3)
    mp = MeshProcessor(mesh, case.spatial.field_groups, coords,
                       save_dir=str(tmp_path))
    mp.patchify_and_scale(fields.reshape(-1, *fields.shape[2:]))
    scfg = case.spatial.with_n_inp(mp.cells_per_patch)
    tcfg = dataclasses.replace(case.temporal, num_layers=1)
    sparams = to_numpy(TS.init_spatial(
        scfg, torch.Generator().manual_seed(1), device="cpu"))
    tparams = to_numpy(init_temporal(
        tcfg, torch.Generator().manual_seed(2), device="cpu"))

    rs = np.random.RandomState(4)
    B, T, G, E = 2, 8, tcfg.num_fields, tcfg.embed_dim
    x0 = rs.randn(B, G, E).astype(np.float32)
    ib = ib[:, :T]
    truth = fields[:, 1:T + 1]
    tgt_lat = rs.randn(B, T, G, E).astype(np.float32)
    kw = dict(sea_layout=case.run.sea_layout, scalers=mp.scalers,
              field_groups=mp.field_groups)
    want = jax_e2e(tcfg, scfg, mp.partition, **kw)(
        tparams, sparams, x0, ib, truth, tgt_lat)
    got = make_e2e_rollout_eval(tcfg, scfg, mp.partition, **kw)(
        from_numpy(tparams, "cpu"), from_numpy(sparams, "cpu"),
        *map(torch.from_numpy, (x0, ib, truth, tgt_lat)))
    assert got[0].shape == (B, T, mp.partition.num_nodes, 3)
    for g, w in zip(got, want):
        _close(g, w, ROLLOUT_ATOL)


def _printed_metrics(out: str):
    return {k: float(re.search(rf"^{k}: (\S+)$", out, re.M).group(1))
            for k in ("encoded_rel_mse", "decoded_rel_mse")}


def test_cli_temporal_test_matches_jax_cli(tmp_path, capsys, monkeypatch):
    from sea_tpu import cli as jax_cli
    from sea_tpu.train import evaluate as jax_evaluate
    # The JAX CLI's field and error plots enter no printed metric and take
    # most of its run on the CPU: drawing them is left out on its side;
    # the port draws its own.
    for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                 "plot_rollout_error"):
        monkeypatch.setattr(jax_evaluate, name, lambda *a, **k: None)
    save = str(tmp_path)
    written = save_init_checkpoints(smoke_case(), save, seed=1)
    assert sorted(written) == ["encoder_decoder", "temporal"]
    argv = ["cylinder_flow_smoke", "temporal", "test", "--synthetic",
            "--save_dir", save]
    jax_cli.main(argv + ["--platform", "cpu"])
    want = _printed_metrics(capsys.readouterr().out)
    os.remove(os.path.join(save, "rollout_error_cylinder_flow_run1.csv"))
    torch_cli.main(argv + ["--device", "cpu"])
    got = _printed_metrics(capsys.readouterr().out)
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    assert os.path.exists(
        os.path.join(save, "rollout_error_cylinder_flow_run1.csv"))
    # The port draws its 5 field-plot pairs and the error plot.
    assert len([n for n in os.listdir(save) if n.endswith(".png")]) == 11


QUANT_MIN_SIZE = 64


def _small_min_size(monkeypatch, module):
    for name in ("quantize_weights_int8", "quantize_weights_int4",
                 "cast_weights_bf16"):
        monkeypatch.setattr(module, name, functools.partial(
            getattr(module, name), min_size=QUANT_MIN_SIZE))


@pytest.fixture(scope="module")
def smoke_checkpoints(tmp_path_factory):
    save = str(tmp_path_factory.mktemp("smoke_ckpt"))
    save_init_checkpoints(smoke_case(), save, seed=1)
    return save


def _drift_line(out):
    found = re.search(r"^Per-checkpoint teacher-forced drift .*$", out, re.M)
    return found and found.group(0)


@pytest.mark.parametrize("flags", [
    ["--precision", "int4", "--kv_cache", "int8"], ["--precision", "int8"],
    ["--precision", "bf16"]], ids=["int4-kv_int8", "int8", "bf16"])
def test_cli_reduced_precision_matches_jax_cli(flags, smoke_checkpoints,
                                               capsys, monkeypatch):
    from sea_tpu import cli as jax_cli
    from sea_tpu.ops import decode_attention as jax_decode
    from sea_tpu.ops import quant_matmul as jax_quant
    from sea_tpu.train import evaluate as jax_evaluate
    from sea_tpu.utils import precision as jax_precision
    from sea_tpu_torch.utils import plotting
    from sea_tpu_torch.utils import precision as torch_precision
    # The plots enter no printed metric; neither side draws them here.
    for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                 "plot_rollout_error"):
        monkeypatch.setattr(jax_evaluate, name, lambda *a, **k: None)
        monkeypatch.setattr(plotting, name, lambda *a, **k: None)
    _small_min_size(monkeypatch, jax_precision)
    _small_min_size(monkeypatch, torch_precision)
    if flags[1] == "int4":
        # JAX's kernels on, in interpret mode, at every shape the port's
        # kernel math takes (M <= 8 rows; any head dim). The f32 caches of
        # the other modes need no kernel: its math is the XLA path's.
        pick = jax_quant._pick_block_n
        monkeypatch.setattr(jax_quant, "kernel_supported",
                            lambda M, K, N, backend=None:
                            M <= 8 and K % 2 == 0)
        monkeypatch.setattr(jax_quant, "_pick_block_n",
                            lambda K, N: pick(K, N) or N)
        monkeypatch.setattr(jax_quant, "_FORCE_INTERPRET", True)
        monkeypatch.setattr(jax_decode, "decode_supported",
                            lambda *a, **k: True)
        monkeypatch.setattr(jax_decode, "_FORCE_INTERPRET", True)
    argv = ["cylinder_flow_smoke", "temporal", "test", "--synthetic",
            "--save_dir", smoke_checkpoints, "--no_drift_check"] + flags
    jax_cli.main(argv + ["--platform", "cpu"])
    jax_out = capsys.readouterr().out
    torch_cli.main(argv + ["--device", "cpu"])
    torch_out = capsys.readouterr().out
    want, got = _printed_metrics(jax_out), _printed_metrics(torch_out)
    for key in want:
        assert np.isfinite(got[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    assert f"Serving precision: {flags[1]} weights" in torch_out
    assert ("int4 calibration" in torch_out) == (flags[1] == "int4")
    assert ("int4 calibration" in jax_out) == (flags[1] == "int4")


def test_cli_drift_gate_aborts_over_budget(smoke_checkpoints, capsys,
                                           monkeypatch):
    from sea_tpu_torch.utils import precision as torch_precision
    _small_min_size(monkeypatch, torch_precision)
    with pytest.raises(SystemExit):
        torch_cli.main(["cylinder_flow_smoke", "temporal", "test",
                        "--synthetic", "--save_dir", smoke_checkpoints,
                        "--precision", "int8", "--drift_budget", "0",
                        "--device", "cpu"])
    captured = capsys.readouterr()
    line = _drift_line(captured.out)
    assert line and line.endswith("(budget 0.0)")
    assert float(line.split(": ")[1].split()[0]) > 0
    assert "exceeds the budget 0.0" in captured.err
    assert "Test Results" not in captured.out


def test_cli_no_calibrate_no_drift_check(smoke_checkpoints, capsys,
                                         monkeypatch):
    """--no_calibrate quantizes int4 with plain MSE scales (no stats, no
    bias correction); --no_drift_check skips the gate even at budget 0.
    The auto cache of int4 is bf16."""
    from sea_tpu_torch.rollout import e2e
    from sea_tpu_torch.utils import plotting
    from sea_tpu_torch.utils import precision as torch_precision
    _small_min_size(monkeypatch, torch_precision)
    for name in ("plot_all_fields_2d", "plot_rollout_error"):
        monkeypatch.setattr(plotting, name, lambda *a, **k: None)
    seen = []
    make = e2e.make_e2e_rollout_eval

    def spy(*a, **k):
        seen.append(k["cache_dtype"])
        return make(*a, **k)

    monkeypatch.setattr(e2e, "make_e2e_rollout_eval", spy)
    monkeypatch.setattr(
        sys.modules["sea_tpu_torch.train.evaluate"],
        "make_e2e_rollout_eval", spy)
    results = torch_cli.main([
        "cylinder_flow_smoke", "temporal", "test", "--synthetic",
        "--save_dir", smoke_checkpoints, "--precision", "int4",
        "--no_calibrate", "--no_drift_check", "--drift_budget", "0",
        "--device", "cpu"])
    out = capsys.readouterr().out
    assert "int4 calibration" not in out and _drift_line(out) is None
    assert "Serving precision: int4 weights" in out
    assert seen == [torch.bfloat16]
    assert np.isfinite(results["decoded_rel_mse"])


def test_cli_generate_writes_the_trajectory(smoke_checkpoints, tmp_path,
                                            capsys, monkeypatch):
    """`temporal generate --device cpu` on cylinder_flow_smoke --synthetic,
    past the 40-step window: the .npy holds finite fields [H, N, F] equal
    to the port's generate_trajectory on the CLI's own inputs, and its
    first 40 steps equal a window-long generation (the held ib changes
    nothing before the window ends)."""
    from sea_tpu_torch.train import evaluate
    real = evaluate.generate_trajectory
    calls = []

    def spy(*args, **kwargs):
        calls.append((args, kwargs))
        return real(*args, **kwargs)

    monkeypatch.setattr(evaluate, "generate_trajectory", spy)
    out, H = tmp_path / "gen.npy", 50
    torch_cli.main(["cylinder_flow_smoke", "temporal", "generate",
                    "--synthetic", "--save_dir", smoke_checkpoints,
                    "--horizon", str(H), "--output", str(out),
                    "--device", "cpu"])
    fields = np.load(out)
    assert fields.shape == (H, 800, 3) and np.isfinite(fields).all()
    assert f"Generated {H} steps x 800 nodes x 3 fields" in \
        capsys.readouterr().out
    (args, kwargs), = calls
    assert kwargs["horizon"] == H and kwargs["trajectory"] == 0
    np.testing.assert_array_equal(fields, real(*args, **kwargs))
    W = args[2].ib.shape[1]
    assert W < H
    window = real(*args, **{**kwargs, "horizon": W})
    np.testing.assert_allclose(fields[:W], window, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("argv,message", [
    (["temporal", "test", "--horizon", "5"], "only apply to `temporal gen"),
    (["temporal", "train", "--output", "x.npy"], "only apply to `temporal g"),
    (["temporal", "generate", "--horizon", "0"], "--horizon must be >= 1"),
    (["encoder", "generate"], "generate is a temporal"),
    (["temporal", "train", "--kv_cache", "f32"], "only apply to `temporal t")])
def test_generate_flag_checks(argv, message, capsys):
    """The JAX parser's checks of the generate flags."""
    with pytest.raises(SystemExit):
        torch_cli.main(["cylinder_flow_smoke"] + argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("CUDA is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        torch_cli.main(["cylinder_flow_smoke", "temporal", "test",
                        "--synthetic", "--device", "cuda"])


@pytest.mark.parametrize("argv,message", [
    (["encoder", "train", "--mesh", "2x1"], "needs 2 ranks"),
    (["temporal", "train", "--seq_parallel", "2"], "needs 2 ranks"),
    (["temporal", "train", "--pp", "2"], "--pp 2 needs 2 devices; 1 "
     "visible"),
    (["temporal", "test", "--mesh", "2x1"], "needs 2 ranks"),
    (["temporal", "train", "--pp", "2", "--pp_microbatches", "4"],
     "--pp 2 needs 2 devices; 1 visible")])
def test_unported_modes_and_flags_name_the_roadmap(argv, message, capsys):
    """--mesh, --seq_parallel and --pp run over ranks
    (tests/test_torch_cli_mesh.py); in one process a grid of 2 is
    refused before any work: it needs 2 ranks (--pp: the JAX CLI's
    message for too few devices)."""
    with pytest.raises(SystemExit):
        torch_cli.main(["cylinder_flow_smoke"] + argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flag", [["--compute_dtype", "bf16"],
                                  ["--adam_mu_dtype", "bf16"],
                                  ["--optimizer", "adafactor"]])
def test_train_precision_flags_refused_outside_train(flag, capsys):
    """As in the JAX CLI: the training numerics flags apply to train
    modes only."""
    with pytest.raises(SystemExit):
        torch_cli.main(["cylinder_flow_smoke", "temporal", "test",
                        "--synthetic", "--device", "cpu"] + flag)
    assert "only apply to train modes" in capsys.readouterr().err


def test_cli_bf16_shadow_train_checkpoint_loads_in_jax(tmp_path, capsys):
    """`temporal train --compute_dtype bf16_shadow --adam_mu_dtype bf16` on
    the CPU writes the JAX driver's checkpoint: it loads in the JAX
    package's load_full_checkpoint with its tx.init template (the shadow
    and a bf16 mu included), every value as the port wrote it, and the
    shadow is the bf16 cast of the saved parameters."""
    import jax
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal as jax_init
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.utils.checkpoint import _flatten, load_full_checkpoint
    from sea_tpu_torch.utils.checkpoint import checkpoint_path
    save = str(tmp_path)
    case = torch_cli.get_case("cylinder_flow_smoke")
    save_init_checkpoints(case, save, seed=2)
    params = torch_cli.main(
        ["cylinder_flow_smoke", "temporal", "train", "--synthetic",
         "--epochs", "1", "--save_dir", save, "--device", "cpu",
         "--compute_dtype", "bf16_shadow", "--adam_mu_dtype", "bf16"])
    assert "New Best Model Saved" in capsys.readouterr().out
    tcfg = dataclasses.replace(jax_case().temporal_train,
                               compute_dtype="bfloat16_shadow",
                               adam_mu_dtype="bfloat16")
    template = jax_init(jax.random.PRNGKey(0), jax_case().temporal)
    path = checkpoint_path(save, "temporal", case.run.case_name,
                           case.run.run_name)
    got, opt, meta = load_full_checkpoint(
        path, template, jax_optimizer(tcfg).init(template))
    assert int(meta["epoch"]) == 1 and int(opt.inner[0].count) >= 1
    saved = np.load(path)
    restored = _flatten({"opt_state": opt})
    assert restored.keys() == {k for k in saved.files
                               if k.startswith("opt_state/")}
    for key, leaf in restored.items():
        np.testing.assert_array_equal(leaf, saved[key], err_msg=key)
    assert {np.asarray(x).dtype.name for x in jax.tree.leaves(
        (opt.inner[0].mu, opt.shadow))} == {"bfloat16"}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), b)
    for s, a in zip(jax.tree.leaves(opt.shadow), jax.tree.leaves(params)):
        assert np.array_equal(np.asarray(s, np.float32),
                              torch.from_numpy(a).bfloat16().float().numpy())


def test_port_imports_no_jax():
    """Every module of sea_tpu_torch and the chip scripts (chip_smoke.py,
    chip_ab.py, chip_flash_probe.py, chip_int4_probe.py,
    chip_decode_probe.py, chip_adaln_probe.py, chip_variants.py,
    chip_profiler_probe.py, chip_tools_probe.py) import with jax and the
    JAX package made unimportable."""
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['sea_tpu'] = None\n"
        "import sea_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    sea_tpu_torch.__path__, 'sea_tpu_torch.')\n"
        "    if not m.name.endswith('__main__')]\n"
        "for name in names + ['chip_smoke', 'chip_ab', 'chip_flash_probe',\n"
        "                     'chip_int4_probe', 'chip_decode_probe',\n"
        "                     'chip_adaln_probe', 'chip_variants',\n"
        "                     'chip_profiler_probe', 'chip_tools_probe']:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m.split('.')[0] in ('jax', 'sea_tpu') for m in\n"
        "               sys.modules if sys.modules[m] is not None)\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout) >= 30


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    names |= {n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    return names


def test_port_sources_name_no_jax_module():
    """No import statement in sea_tpu_torch/ or the chip scripts, at any
    depth (lazy imports inside functions included), names jax, jaxlib or a
    module of the JAX package."""
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "chip_ab.py",
                                             "chip_flash_probe.py",
                                             "chip_int4_probe.py",
                                             "chip_decode_probe.py",
                                             "chip_adaln_probe.py",
                                             "chip_variants.py",
                                             "chip_profiler_probe.py",
                                             "chip_tools_probe.py")]
    for root, _, names in os.walk(os.path.join(REPO, "sea_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) >= 30
    for path in files:
        bad = {m for m in _imported_modules(path)
               if m.split(".")[0] in ("jax", "jaxlib", "sea_tpu")}
        assert not bad, (path, bad)


@pytest.mark.parametrize("name", ["cylinder_flow", "cylinder_flow_smoke",
                                  "cylinder_flow_smoke_deep",
                                  "multiphase_flow"])
def test_copied_configs_equal_jax_configs(name):
    """The port's copy of each shipped config equals the JAX package's,
    field for field."""
    import importlib
    want = importlib.import_module(f"sea_tpu.configs.{name}").get_case()
    got = torch_cli.get_case(name)
    assert type(got).__module__ == "sea_tpu_torch.configs.base"
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    for section in ("temporal", "spatial", "mesh"):
        for prop in ("num_patches", "num_groups", "internal_embed_dim",
                     "down_dim", "ib_dim"):
            if hasattr(getattr(want, section), prop):
                assert getattr(getattr(got, section), prop) == \
                    getattr(getattr(want, section), prop)
