"""The port's driver surface against the JAX package, on the CPU: the
per-tensor norms (log_per_tensor) and the profiler capture (--profile) of
both training loops, the rollout evaluations and their artifacts, the
stage-1 test's artifacts, set_seed, StepTimer and trace, the
verification API and inverse_transform_latents.

Sizes: the cylinder_flow_smoke preset (E=32, 2 heads, G=2) with dropout
off where a step is compared, 120 synthetic nodes and 2 windows of 6
steps for the evaluations (as tests/test_torch_rollout.py), the smoke
CLI's synthetic data (8 trajectories of 41 steps, 800 nodes) for the
training loops. Inputs and data come from numpy with fixed seeds.

Tolerances, stated per test:
- inverse_transform_latents and the verification stats: bit for bit
  (numpy copies of the same numpy code);
- per-tensor norms of one train step: rtol 1e-5, plus 1e-7 of the global
  gradient norm for a gradient (the gradient of a key projection's bias
  is zero up to rounding: softmax ignores a shift shared by every key);
- the evaluations: rtol 1e-4, the CLI parity tolerance (anything
  downstream of a rollout);
- the artifacts: the same sorted file names; the CSVs the same header
  and time column, and values within rtol 1e-4.
Plots are stubbed to empty files where only their names are compared
(drawing 11 scatters takes ~7 s on the CPU); the port's plotting
functions draw for real in test_plotting_functions_write_files and in
the CLI runs of tests/test_torch_e2e.py.
"""

import csv
import dataclasses
import json
import os
import random
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
from sea_tpu_torch import cli as torch_cli
from sea_tpu_torch.configs.cylinder_flow_smoke import get_case as port_case
from sea_tpu_torch.train import evaluate as TE
from sea_tpu_torch.train import metrics as TM
from sea_tpu_torch.utils import plotting
from sea_tpu_torch.utils.params import (from_numpy, save_init_checkpoints,
                                        to_numpy, tree_paths)

torch.set_num_threads(2)

EVAL_RTOL = 1e-4
NORM_RTOL = 1e-5
GRAD_ATOL_OF_NORM = 1e-7


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _touch(*args, filename=None, **kwargs):
    """A plot stub: the file it would draw, empty."""
    path = filename if filename is not None else args[-1]
    open(path, "wb").close()


@pytest.fixture
def stub_plots(monkeypatch):
    from sea_tpu.train import evaluate as jax_evaluate
    for module in (plotting, jax_evaluate):
        for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                     "plot_rollout_error"):
            monkeypatch.setattr(module, name, _touch)


def _pngs(path):
    return sorted(n for n in os.listdir(path) if n.endswith(".png"))


def _rows(path):
    with open(path, newline="") as fh:
        return list(csv.reader(fh))


def _assert_csvs_equal(got_path, want_path):
    got, want = _rows(got_path), _rows(want_path)
    assert got[0] == want[0] and len(got) == len(want)
    assert [r[0] for r in got] == [r[0] for r in want]
    np.testing.assert_allclose(np.array([r[1:] for r in got[1:]], float),
                               np.array([r[1:] for r in want[1:]], float),
                               rtol=EVAL_RTOL)


# ---------------------------------------------------------------------------
# Numpy helpers, seeding, timing, tracing, verification
# ---------------------------------------------------------------------------

def test_inverse_transform_latents_bit_equal():
    from sea_tpu.data.latents import inverse_transform_latents as jax_inv
    from sea_tpu_torch.data.latents import (inverse_transform_latents,
                                            transform_latents_to_temporal)
    x = np.random.RandomState(0).randn(3, 5, 2, 4 * 6).astype(np.float32)
    got = inverse_transform_latents(x, 4)
    np.testing.assert_array_equal(got, jax_inv(x, 4))
    assert got.shape == (15, 4, 2, 6)
    np.testing.assert_array_equal(
        transform_latents_to_temporal(got, 3, 5, 4, 2), x)


def test_set_seed_seeds_all_host_rngs():
    """As tests/test_utils.py's: one switch seeds random, numpy and torch
    and returns the key of the same seed (the port's PRNGKey)."""
    from sea_tpu_torch.utils.prng import prng_key
    from sea_tpu_torch.utils.seeding import set_seed
    key1 = set_seed(123)
    a_py, a_np, a_t = random.random(), np.random.rand(), torch.rand(3)
    key2 = set_seed(123)
    assert random.random() == a_py and np.random.rand() == a_np
    assert torch.equal(torch.rand(3), a_t)
    assert key1 == key2 == prng_key(123)
    assert np.array_equal(np.asarray(jax.random.PRNGKey(123)), key1)
    assert os.environ["PYTHONHASHSEED"] == "123"


def test_step_timer():
    """As tests/test_utils.py's: the first step is left out."""
    import time
    from sea_tpu_torch.utils.profiling import StepTimer
    t = StepTimer(skip=1)
    for _ in range(4):
        with t:
            time.sleep(0.01)
    s = t.summary()
    assert s["steps"] == 3 and s["mean_s"] > 0.005
    assert s["steps_per_sec"] > 0 and s["first_step_s"] > 0.005
    assert StepTimer().summary() == {"steps": 0}


def test_trace_writes_profile(tmp_path):
    from sea_tpu_torch.utils.profiling import annotate, trace
    with trace(str(tmp_path), name="mul"):
        with annotate("matmul-span"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    (name,) = os.listdir(tmp_path)
    assert name == "mul.pt.trace.json"
    with open(tmp_path / name) as fh:
        events = json.load(fh)["traceEvents"]
    assert any(e.get("name") == "matmul-span" for e in events)


def _swap_two_nodes(part):
    """part's index_map with the nodes of two valid slots swapped: the
    first valid slot of the first patch that has one, and the first valid
    slot of a later patch whose coordinates differ from it."""
    index_map = part.index_map.copy()
    slots = np.argwhere(part.valid_mask)
    first = tuple(slots[0])
    second = next(tuple(s) for s in slots
                  if s[0] != first[0]
                  and not np.array_equal(part.coords[tuple(s)],
                                         part.coords[first]))
    index_map[first], index_map[second] = (part.index_map[second],
                                           part.index_map[first])
    return index_map


def test_verification_matches_jax():
    """Both packages' round-trip stats on the same data are equal, and a
    corrupted partition raises VerificationError (an AssertionError) in
    both.

    The corruption swaps the nodes of two valid slots in different
    patches, so the map stays a permutation: the fields' gather and
    scatter agree and every node is written, while the coordinates land
    on the wrong nodes. A corruption that leaves a node unwritten would
    read it from unpatchify's np.empty buffer, and a NaN there compares
    False against atol, so the check would pass or fail by chance."""
    from sea_tpu.configs.base import MeshConfig as JMeshConfig
    from sea_tpu.data.mesh import MeshProcessor as JMP
    from sea_tpu.data.partitioner import build_partition_index as jbuild
    from sea_tpu.utils import verification as JV
    from sea_tpu_torch.configs.base import MeshConfig
    from sea_tpu_torch.data.mesh import MeshProcessor
    from sea_tpu_torch.data.partitioner import build_partition_index
    from sea_tpu_torch.utils import verification as PV
    rng = np.random.RandomState(0)
    coords = rng.rand(200, 2).astype(np.float32)
    fields = rng.randn(12, 200, 3).astype(np.float32)
    sides = {"jax": (JV, jbuild(coords, 9, 9), JMP(JMeshConfig(),
                                                    [[0, 1], [2]], coords.T)),
             "port": (PV, build_partition_index(coords, 9, 9),
                      MeshProcessor(MeshConfig(), [[0, 1], [2]], coords.T))}
    stats = {}
    for side, (V, part, mp) in sides.items():
        mp.patchify_and_scale(fields)
        stats[side] = (V.verify_partition_roundtrip(part, fields, coords),
                       V.verify_mesh_processor(mp, fields))
        bad = dataclasses.replace(part, index_map=_swap_two_nodes(part))
        written = np.sort(bad.index_map[bad.valid_mask])
        assert np.array_equal(written, np.arange(len(coords))), side
        with pytest.raises(V.VerificationError, match="round-trip failed"):
            V.verify_partition_roundtrip(bad, fields, coords)
        assert issubclass(V.VerificationError, AssertionError)
    assert stats["port"] == stats["jax"]
    assert all(s["passed"] for s in stats["port"])


def test_plotting_functions_write_files(tmp_path):
    """Every plot entry point draws a file without a display."""
    rng = np.random.RandomState(0)
    data = rng.randn(3, 50, 2).astype(np.float32)
    x, y, z = rng.rand(3, 50).astype(np.float32)
    paths = [str(tmp_path / f"{n}.png") for n in range(5)]
    plotting.plot_fields_2d(data, x, y, 1, 2, filename=paths[0])
    plotting.plot_fields_3d(data, x, y, z, 0, 0, filename=paths[1])
    plotting.plot_all_fields_2d(data, x, y, 1, filename=paths[2])
    plotting.plot_all_fields_3d(data, x, y, z, 1, filename=paths[3])
    plotting.plot_rollout_error(rng.rand(7, 2), paths[4])
    assert all(os.path.getsize(p) > 0 for p in paths)
    assert plotting.matplotlib_missing() is None


# ---------------------------------------------------------------------------
# Per-tensor norms: the metric and both train steps
# ---------------------------------------------------------------------------

def test_per_tensor_norms_names_and_values():
    """The JAX function's names and values on a hand-built tree."""
    from sea_tpu.train import metrics as JM
    tree = {"a": {"w": np.arange(3.0, dtype=np.float32)},
            "b": [np.full((2, 2), 2.0, np.float32)]}
    want = JM.per_tensor_norms(jax.tree.map(jnp.asarray, tree), "G/")
    got = TM.per_tensor_norms(from_numpy(tree, "cpu"), "G/")
    assert set(got) == set(want) == {"G/a/w", "G/b/0"}
    read = TM.read_norms(got)
    for k in want:
        np.testing.assert_allclose(read[k], float(want[k]), rtol=1e-6)
    assert read["G/b/0"] == 4.0


def _assert_norms_match(got, want, grad_norm):
    assert set(got) == set(want)
    for k, w in want.items():
        atol = GRAD_ATOL_OF_NORM * grad_norm if k.startswith("Grad") else 0
        np.testing.assert_allclose(got[k], float(w), rtol=NORM_RTOL,
                                   atol=atol, err_msg=k)


@pytest.mark.parametrize("stage", ["temporal", "spatial"])
def test_train_step_per_tensor_matches_jax(stage):
    """make_train_step(per_tensor=True) of each stage, one step from the
    same weights and batch, dropout off: stats["tensors"] has the JAX
    step's keys (Grad_Norm/ and Param_Norm/ over the npz paths) and
    values."""
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu_torch.train.optim import make_optimizer
    from sea_tpu_torch.utils.prng import prng_key
    jcase, pcase = jax_case(), port_case()
    rs = np.random.RandomState(1)
    if stage == "temporal":
        from sea_tpu.models.temporal import init_temporal as jinit
        from sea_tpu.train.train_temporal import make_train_step as jstep
        from sea_tpu_torch.train.train_temporal import make_train_step
        jcfg = dataclasses.replace(jcase.temporal, dropout=0.0)
        pcfg = dataclasses.replace(pcase.temporal, dropout=0.0)
        tcfg = (jcase.temporal_train, pcase.temporal_train)
        params = _np(jinit(jax.random.PRNGKey(0), jcfg))
        shape = (2, 6, jcfg.num_fields, jcfg.embed_dim)
        batch = [rs.randn(*shape).astype(np.float32),
                 rs.randn(*shape).astype(np.float32),
                 rs.randn(2, 6, jcfg.ib_num).astype(np.float32)]
        jargs, pargs = (jax.random.PRNGKey(2),), (prng_key(2),)
    else:
        from sea_tpu.models.spatial import init_spatial as jinit
        from sea_tpu.train.train_spatial import make_train_step as jstep
        from sea_tpu_torch.train.train_spatial import make_train_step
        jcfg = dataclasses.replace(jcase.spatial, dropout=0.0, n_inp=10)
        pcfg = dataclasses.replace(pcase.spatial, dropout=0.0, n_inp=10)
        tcfg = (jcase.spatial_train, pcase.spatial_train)
        params = _np(jinit(jax.random.PRNGKey(0), jcfg))
        batch = [rs.randn(4, 64, 3, 10).astype(np.float32)]
        jargs = (jax.random.PRNGKey(2), jnp.asarray(0))
        pargs = (prng_key(2), 0)
    jtx = jax_optimizer(tcfg[0])
    jp = jax.tree.map(jnp.asarray, params)
    _, _, want = jax.jit(jstep(jcfg, jtx, per_tensor=True))(
        jp, jtx.init(jp), *map(jnp.asarray, batch), *jargs)
    tx = make_optimizer(tcfg[1])
    pp = from_numpy(params, "cpu")
    _, _, got = make_train_step(pcfg, tx, per_tensor=True)(
        pp, tx.init(pp), *map(torch.from_numpy, batch), *pargs)
    keys = {f"{kind}/{p}" for kind in ("Grad_Norm", "Param_Norm")
            for p in tree_paths(pp)}
    assert set(got["tensors"]) == keys
    _assert_norms_match(TM.read_norms(got["tensors"]), want["tensors"],
                        float(want["grad_norm"]))


class _Tracker:
    def __init__(self):
        self.rows = {}

    def record_error(self, phase, epoch, metrics):
        self.rows[(phase, epoch)] = dict(metrics)

    def log_model(self, *a, **k):
        pass

    def finish(self):
        pass


def _smoke(tmp_path, **temporal_train):
    case = port_case()
    case = case.replace(
        run=dataclasses.replace(case.run, save_dir=str(tmp_path)),
        spatial_train=dataclasses.replace(case.spatial_train,
                                          log_per_tensor=True),
        temporal_train=dataclasses.replace(case.temporal_train,
                                           log_per_tensor=True,
                                           **temporal_train))
    return case, torch_cli._load_data(case, synthetic=True)


def _norm_keys(params_np):
    return {f"{kind}/{p}" for kind in ("Grad_Norm", "Param_Norm")
            for p in tree_paths(params_np)}


def test_spatial_train_writes_tensor_rows_and_epoch2_trace(tmp_path):
    """train_spatial.train with log_per_tensor and profile_dir, 2 epochs:
    a "tensors" row per epoch over every npz path, and one trace, of
    epoch 2."""
    from sea_tpu_torch.train.train_spatial import train
    case, data = _smoke(tmp_path)
    tracker = _Tracker()
    best, _ = train(case, tracker, device="cpu", data=data, epochs=2,
                    profile_dir=str(tmp_path / "trace"))
    for epoch in (1, 2):
        row = tracker.rows[("tensors", epoch)]
        assert set(row) == _norm_keys(best)
        assert all(np.isfinite(v) and v >= 0 for v in row.values())
    assert os.listdir(tmp_path / "trace") == ["train_epoch2.pt.trace.json"]


def test_temporal_train_tensor_rows_trace_and_epoch_artifacts(
        tmp_path, stub_plots, capsys):
    """train_temporal.train with log_per_tensor, profile_dir and a full
    evaluation at epoch 2: "tensors" rows per epoch, the trace of epoch 2
    only, and the JAX loop's artifact names for that epoch (the JAX
    loop's writer, given the validation windows' shapes)."""
    from sea_tpu.configs.cylinder_flow_smoke import get_case
    from sea_tpu.train.evaluate import _write_rollout_artifacts
    from sea_tpu_torch.train.train_temporal import train
    case, data = _smoke(tmp_path / "port", full_eval_interval=2)
    save_init_checkpoints(case, case.run.save_dir, seed=1)
    tracker = _Tracker()
    best, td = train(case, tracker, device="cpu", data=data, epochs=2,
                     profile_dir=str(tmp_path / "trace"))
    assert "profiler trace (epoch 2) written to" in capsys.readouterr().out
    for epoch in (1, 2):
        assert set(tracker.rows[("tensors", epoch)]) == _norm_keys(best)
    assert os.listdir(tmp_path / "trace") == ["train_epoch2.pt.trace.json"]
    assert "Full_Decoded_Rel_MSE" in tracker.rows[("val", 2)]
    jcase = get_case().replace(run=dataclasses.replace(
        get_case().run, save_dir=str(tmp_path / "jax")))
    B, T, N, F = td.val.tgt_original.shape
    _write_rollout_artifacts(jcase, td.mesh_processor,
                             np.zeros((T, F), np.float32),
                             np.zeros((B, T, N, F), np.float32),
                             np.zeros((B, T, N, F), np.float32), epoch=2,
                             plot_traj=True)
    want = _pngs(tmp_path / "jax")
    assert len(want) == 11 and all(n.endswith("_2.png") or
                                   n.startswith("rollout") for n in want)
    assert _pngs(tmp_path / "port") == want


def test_cli_temporal_train_profile_writes_epoch2_trace(tmp_path, capsys):
    """`temporal train --profile DIR --epochs 2` in process: DIR holds the
    trace of epoch 2 only, and the run says so."""
    save = str(tmp_path)
    save_init_checkpoints(port_case(), save, seed=1)
    torch_cli.main(["cylinder_flow_smoke", "temporal", "train",
                    "--synthetic", "--epochs", "2", "--save_dir", save,
                    "--device", "cpu", "--profile", str(tmp_path / "p")])
    assert os.listdir(tmp_path / "p") == ["train_epoch2.pt.trace.json"]
    assert (f"profiler trace (epoch 2) written to {tmp_path / 'p'}"
            in capsys.readouterr().out)


# ---------------------------------------------------------------------------
# The rollout evaluations and their artifacts
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def eval_side(tmp_path_factory):
    """The smoke case on both sides (dropout off), a min-max-scaled
    partition of 120 synthetic nodes fitted by each package, seeded
    stage-1 weights and JAX temporal weights as numpy, each package's
    LatentService, and 2 windows of 6 steps with their fields."""
    from sea_tpu.configs.base import MeshConfig
    from sea_tpu.data.latents import LatentService as JLS
    from sea_tpu.data.mesh import MeshProcessor as JMP
    from sea_tpu.data.synthetic import cylinder_like
    from sea_tpu.models.temporal import init_temporal
    from sea_tpu_torch.data.latents import LatentService
    from sea_tpu_torch.data.mesh import MeshProcessor
    from sea_tpu_torch.models.spatial import init_spatial
    root = tmp_path_factory.mktemp("eval")
    fields, coords, ib = cylinder_like(tr=2, T=9, n_nodes=120, seed=3)
    out = {}
    for side, case, MP in (("jax", jax_case(), JMP),
                           ("port", port_case(), MeshProcessor)):
        case = case.replace(
            temporal=dataclasses.replace(case.temporal, dropout=0.0),
            mesh=dataclasses.replace(case.mesh,
                                     scale_feature_range=(-1.0, 1.0)),
            run=dataclasses.replace(case.run, save_dir=str(root / side)))
        mp = MP(case.mesh, case.spatial.field_groups, coords,
                save_dir=str(root / side))
        mp.patchify_and_scale(fields.reshape(-1, *fields.shape[2:]))
        out[side] = types.SimpleNamespace(
            case=case, mp=mp, scfg=case.spatial.with_n_inp(
                mp.cells_per_patch))
    sparams = to_numpy(init_spatial(out["port"].scfg,
                                    torch.Generator().manual_seed(1),
                                    device="cpu"))
    out["jax"].svc = JLS(out["jax"].scfg, jax.tree.map(jnp.asarray,
                                                       sparams))
    out["port"].svc = LatentService(out["port"].scfg,
                                    from_numpy(sparams, "cpu"), device="cpu")
    tcfg = out["jax"].case.temporal
    out["jax"].params = _np(init_temporal(jax.random.PRNGKey(2), tcfg))
    out["port"].params = from_numpy(out["jax"].params, "cpu")
    rs = np.random.RandomState(6)
    W, shape = 6, (2, 6, tcfg.num_fields, tcfg.embed_dim)
    windows = types.SimpleNamespace(
        src=rs.randn(*shape).astype(np.float32),
        tgt=rs.randn(*shape).astype(np.float32),
        tgt_original=fields[:, 1:W + 1], ib=ib[:, :W])
    return out, windows


@pytest.fixture(scope="module")
def jax_full(eval_side):
    """JAX's full_autoregressive_evaluation on eval_side, plots stubbed:
    its metrics, CSV rows and artifact names."""
    from sea_tpu.train import evaluate as JE
    side, windows = eval_side
    j = side["jax"]
    with pytest.MonkeyPatch.context() as mpatch:
        for name in ("plot_all_fields_2d", "plot_rollout_error"):
            mpatch.setattr(JE, name, _touch)
        res = JE.full_autoregressive_evaluation(
            j.params, j.case, windows, j.svc, j.mp, epoch=3)
    save = j.case.run.save_dir
    return res, _pngs(save), os.path.join(
        save, "rollout_error_cylinder_flow_run1.csv")


@pytest.mark.parametrize("fn", ["full", "fused"])
def test_rollout_evaluation_matches_jax_with_artifacts(fn, eval_side,
                                                       jax_full, tmp_path,
                                                       stub_plots):
    """full_ and fused_autoregressive_evaluation(epoch=3) against JAX's
    full_autoregressive_evaluation from the same weights, windows and
    partition: the metrics within rtol 1e-4, the artifact names equal,
    the CSVs equal."""
    side, windows = eval_side
    p = side["port"]
    case = p.case.replace(run=dataclasses.replace(p.case.run,
                                                  save_dir=str(tmp_path)))
    got = getattr(TE, f"{fn}_autoregressive_evaluation")(
        p.params, case, windows, p.svc, p.mp, epoch=3)
    want, want_pngs, want_csv = jax_full
    for key in ("encoded_rel_mse", "decoded_rel_mse"):
        np.testing.assert_allclose(got[key], want[key], rtol=EVAL_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(got["decoded_rel_mse_per_time"],
                               want["decoded_rel_mse_per_time"],
                               rtol=EVAL_RTOL)
    assert len(want_pngs) == 11 and _pngs(tmp_path) == want_pngs
    _assert_csvs_equal(tmp_path / "rollout_error_cylinder_flow_run1.csv",
                       want_csv)


def test_autoregressive_validation_matches_jax(eval_side):
    from sea_tpu.train.evaluate import autoregressive_validation as jav
    side, windows = eval_side
    for sample in (0, 1):
        want = jav(side["jax"].params, side["jax"].case, windows,
                   sample=sample)
        got = TE.autoregressive_validation(side["port"].params,
                                           side["port"].case, windows,
                                           sample=sample)
        np.testing.assert_allclose(got, want, rtol=EVAL_RTOL)


def test_full_evaluation_mesh_raises(eval_side, jax_full):
    """full_autoregressive_evaluation(mesh=...) no longer raises: in 2
    gloo ranks on a 2x1 grid each rolls out one of the 2 windows and
    gathers both, and the metrics equal JAX's one-device evaluation
    within rtol 1e-4 on every rank (tests/test_torch_parallel.py holds
    the sharded rollout itself to the one-device one)."""
    import _torch_ranks as R
    from sea_tpu_torch.parallel.multihost import run_ranks
    side, windows = eval_side
    p = side["port"]
    args = (p.case, to_numpy(p.params), windows, to_numpy(p.svc.params),
            p.mp, p.scfg)
    got = run_ranks(R.run_grid, 2, (2, 1),
                    {"eval": ("evaluation", args)})
    want = jax_full[0]
    for rank in got:
        for key in ("encoded_rel_mse", "decoded_rel_mse",
                    "decoded_rel_mse_per_time"):
            np.testing.assert_allclose(rank["eval"][key], want[key],
                                       rtol=EVAL_RTOL, err_msg=key)


def test_plots_skipped_without_matplotlib(eval_side, tmp_path, monkeypatch,
                                          capsys):
    """With matplotlib unimportable the writers print one line naming
    the plots they skip and the missing module, and write the CSV."""
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    side, windows = eval_side
    p = side["port"]
    case = p.case.replace(run=dataclasses.replace(p.case.run,
                                                  save_dir=str(tmp_path)))
    TE.fused_autoregressive_evaluation(p.params, case, windows, p.svc, p.mp)
    lines = [l for l in capsys.readouterr().out.splitlines()
             if "matplotlib is not installed" in l]
    assert len(lines) == 1
    assert "rollout_error_cylinder_flow_run1.png" in lines[0]
    assert lines[0].count("temporal_") == 10
    assert os.listdir(tmp_path) == ["rollout_error_cylinder_flow_run1.csv"]
    tokens = np.zeros((3, p.mp.num_patches, 3, p.scfg.n_inp), np.float32)
    TE.test_encoder_decoder(p.svc.params, case, tokens, p.mp, device="cpu",
                            spatial_cfg=p.scfg)
    (line,) = [l for l in capsys.readouterr().out.splitlines()
               if "matplotlib is not installed" in l]
    assert line.count("original_data_") == 3
    assert os.listdir(tmp_path) == ["rollout_error_cylinder_flow_run1.csv"]


def test_encoder_artifacts_match_jax(eval_side, tmp_path, stub_plots):
    """test_encoder_decoder(save_artifacts=True): the JAX function's file
    names and metrics on the same snapshots and weights."""
    from sea_tpu.train.evaluate import test_encoder_decoder as jax_test
    side, _ = eval_side
    tokens = np.random.RandomState(2).randn(
        7, side["port"].mp.num_patches, 3,
        side["port"].scfg.n_inp).astype(np.float32)
    res = {}
    for name in ("jax", "port"):
        s = side[name]
        case = s.case.replace(run=dataclasses.replace(
            s.case.run, save_dir=str(tmp_path / name)))
        if name == "jax":
            res[name] = jax_test(s.svc.params, case, tokens, s.mp,
                                 spatial_cfg=s.scfg)
        else:
            res[name] = TE.test_encoder_decoder(s.svc.params, case, tokens,
                                                s.mp, device="cpu",
                                                spatial_cfg=s.scfg)
    assert len(_pngs(tmp_path / "jax")) == 10
    assert _pngs(tmp_path / "port") == _pngs(tmp_path / "jax")
    for k, v in res["jax"].items():
        np.testing.assert_allclose(res["port"][k], v, rtol=1e-5, err_msg=k)
