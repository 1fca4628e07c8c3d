"""`--mesh` through the port's CLI: gloo ranks on the CPU.

The JAX CLI's parse errors for the parallel flags, message for message
(tests/test_cli_mesh.py is the model): each argv is refused by both CLIs
with the same error line, before any work. Then `python -m
sea_tpu_torch.cli cylinder_flow_smoke ... --mesh DxM` in 2 gloo ranks on
synthetic data (``multihost.run_ranks`` running ``cli.main`` in each
rank, plots stubbed), against the same command on one device in this
process: `encoder train --mesh 2x1` and `temporal train --mesh 1x2` write
the one-device checkpoints (params within 1e-5, the optimizer state's
npz paths and shapes equal), and `temporal test --mesh 2x1` and `--mesh
1x2` give the one-device metrics within rtol 1e-4. `temporal train
--seq_parallel 2` writes the one-device run's checkpoint, and `--pp 2`
(with 2 or 4 microbatches, on the 4-layer ``cylinder_flow_smoke_deep``)
that of an in-process one-stage pipeline with the same microbatches, the
params within 1e-5; each prints one epoch line.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch import cli as torch_cli
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.utils import plotting

torch.set_num_threads(2)

PARAM_ATOL = 1e-5
METRIC_RTOL = 1e-4
CASE = "cylinder_flow_smoke"
DEEP = "cylinder_flow_smoke_deep"


def _error_line(main, argv, capsys):
    with pytest.raises(SystemExit):
        main([CASE] + argv)
    err = capsys.readouterr().err
    return [line for line in err.splitlines() if "error:" in line][-1]


@pytest.mark.parametrize("argv", [
    ["temporal", "train", "--mesh", "4by2"],
    ["temporal", "test", "--seq_parallel", "4"],
    ["temporal", "train", "--mesh", "4x2", "--seq_parallel", "4"],
    ["temporal", "test", "--pp", "2"],
    ["temporal", "train", "--pp", "2", "--seq_parallel", "4"],
    ["temporal", "train", "--pp", "2", "--mesh", "4x2"],
    ["temporal", "train", "--pp", "1"],
    ["temporal", "train", "--pp_microbatches", "2"],
    ["temporal", "generate", "--mesh", "2x1"]])
def test_parse_errors_are_the_jax_clis(argv, capsys):
    from sea_tpu import cli as jax_cli
    want = _error_line(jax_cli.main, argv + ["--synthetic"], capsys)
    got = _error_line(torch_cli.main,
                      argv + ["--synthetic", "--device", "cpu"], capsys)
    assert got.split("error:", 1)[1] == want.split("error:", 1)[1]


# --seq_parallel and --pp through the CLI in 2 ranks: argv, ranks, the
# case, and the in-process run each must equal (None: the one-device
# `temporal train` of the dirs fixture; else the pipeline's microbatches
# for an in-process one-stage pipeline, PipeGrid(1)).
PARALLEL_RUNS = {
    "seq2": (["--seq_parallel", "2"], CASE, None),
    "pp2": (["--pp", "2"], DEEP, 2),
    "pp2-mb4": (["--pp", "2", "--pp_microbatches", "4"], DEEP, 4)}


def _cli(argv):
    """cli.main on this process, plots stubbed (as the ranks do)."""
    return R.cli(None, argv)


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """Both stages trained on one device (dir "one") and over 2 ranks
    (dir "mesh": encoder 2x1; temporal 1x2 from the one-device encoder),
    and the test metrics of the one-device checkpoint on one device and
    on 2x1 and 1x2."""
    with pytest.MonkeyPatch.context() as mp:
        for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                     "plot_rollout_error"):
            mp.setattr(plotting, name, lambda *a, **k: None)
        one = str(tmp_path_factory.mktemp("one"))
        mesh = str(tmp_path_factory.mktemp("mesh"))
        common = ["--synthetic", "--epochs", "1", "--device", "cpu"]
        _cli([CASE, "encoder", "train", "--save_dir", one] + common)
        run_ranks(R.run_grid, 2, None, {"cli": ("cli", (
            [CASE, "encoder", "train", "--save_dir", mesh, "--mesh", "2x1"]
            + common,))})
        _cli([CASE, "temporal", "train", "--save_dir", one] + common)
        enc = "encoder_decoder_cylinder_flow_run1.npz"
        os.rename(os.path.join(mesh, enc), os.path.join(mesh, "mesh_" + enc))
        shutil.copy(os.path.join(one, enc), os.path.join(mesh, enc))
        run_ranks(R.run_grid, 2, None, {"cli": ("cli", (
            [CASE, "temporal", "train", "--save_dir", mesh, "--mesh", "1x2"]
            + common,))})
        test = [CASE, "temporal", "test", "--synthetic", "--save_dir", one,
                "--device", "cpu"]
        metrics = {"one": _cli(test)}
        for spec in ("2x1", "1x2"):
            ranks = run_ranks(R.run_grid, 2, None,
                              {"cli": ("cli", (test + ["--mesh", spec],))})
            metrics[spec] = [r["cli"] for r in ranks]
    return one, mesh, metrics


@pytest.fixture(scope="module")
def parallel_runs(dirs, tmp_path_factory):
    """{name: (rank 0's printed lines, the checkpoint's params, the params
    it must equal)} of each PARALLEL_RUNS entry."""
    from sea_tpu_torch.parallel.pipeline import PipeGrid
    from sea_tpu_torch.train.train_temporal import train
    one = dirs[0]
    enc = "encoder_decoder_cylinder_flow_run1.npz"
    ckpt = "temporal_cylinder_flow_run1.npz"
    out = {}
    for name, (flags, case_name, mb) in PARALLEL_RUNS.items():
        d = str(tmp_path_factory.mktemp(name))
        shutil.copy(os.path.join(one, enc), os.path.join(d, enc))
        ranks = run_ranks(R.run_grid, 2, None, {"cli": ("cli_printed", (
            [case_name, "temporal", "train", "--synthetic", "--epochs", "1",
             "--device", "cpu", "--save_dir", d] + flags,))})
        if mb is None:
            want = _npz(os.path.join(one, ckpt))
        else:
            case = torch_cli.get_case(case_name)
            case = case.replace(run=dataclasses.replace(case.run,
                                                        save_dir=d))
            data = torch_cli._load_data(case, True)
            params, _ = train(torch_cli.fit_to_data(case, data),
                              device="cpu", data=data, epochs=1,
                              pipe_mesh=PipeGrid(1), pipe_microbatches=mb,
                              save_artifacts=False)
            from sea_tpu_torch.utils.checkpoint import _flatten
            want = {f"params/{k}": v for k, v in _flatten(params).items()}
        got = _npz(os.path.join(d, ckpt))
        out[name] = (ranks[0]["cli"], got, want)
    return out


@pytest.mark.parametrize("name", sorted(PARALLEL_RUNS))
def test_parallel_flags_train_through_the_cli(name, parallel_runs):
    """`temporal train --seq_parallel 2`, `--pp 2` and `--pp 2
    --pp_microbatches 4` in 2 ranks: one epoch line from rank 0 and a
    finite checkpoint of the one-device layout, whose params equal the
    one-device step's (seq) or an in-process one-stage pipeline's with
    the same microbatches (pp: the dropout keys are per microbatch and
    global layer, so the stages do not change them)."""
    printed, got, want = parallel_runs[name]
    assert sum(line.startswith("Epoch 1/1 train Loss")
               for line in printed.splitlines()) == 1
    params = sorted(k for k in want if k.startswith("params/"))
    assert params and params == sorted(k for k in got
                                       if k.startswith("params/"))
    for key in params:
        assert np.isfinite(got[key]).all(), key
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=PARAM_ATOL, err_msg=key)


def _npz(path):
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


@pytest.mark.parametrize("kind,mesh_name", [
    ("encoder_decoder", "mesh_encoder_decoder"), ("temporal", "temporal")])
def test_mesh_train_writes_the_one_device_checkpoint(kind, mesh_name, dirs):
    one, mesh, _ = dirs
    got = _npz(os.path.join(mesh, f"{mesh_name}_cylinder_flow_run1.npz"))
    want = _npz(os.path.join(one, f"{kind}_cylinder_flow_run1.npz"))
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert got[key].shape == value.shape, key
        if key.startswith("params/"):
            np.testing.assert_allclose(got[key], value, rtol=0,
                                       atol=PARAM_ATOL, err_msg=key)


@pytest.mark.parametrize("spec", ["2x1", "1x2"])
def test_mesh_temporal_test_matches_one_device(spec, dirs):
    _, _, metrics = dirs
    for rank in metrics[spec]:
        for key in ("encoded_rel_mse", "decoded_rel_mse"):
            np.testing.assert_allclose(rank[key], metrics["one"][key],
                                       rtol=METRIC_RTOL, err_msg=key)
