"""Reference PyTorch checkpoints (``.pt`` state dicts) in the port,
against the JAX package, on the CPU.

State dicts are written in the test (tests/_reference_state_dict.py, the
inverse of the mapping) from the port's seeded init at the
cylinder_flow_smoke widths (E=32, 2 heads, G=2), in every exchange mode,
pool update, ib scaling and the attention ib, and for the plain and the
variational stage-1 model. Tolerances:
- the mapped trees: every leaf taken from the state dict bit for bit in
  both mappers (np.array_equal: transposes and copies); the sinusoidal
  ``pe`` and ``pool_pe``, which each package computes with its own sin
  and cos, within 1e-6 (f32 ulps, as tests/test_torch_modes.py);
- forwards on the mapped trees: rtol 1e-5, atol 1e-6 (f32 summation
  order; outputs of order 1);
- the CLI from a ``.pt`` against the same weights as ``.npz``: equal bit
  for bit (the same floats reach the same computation).
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _reference_state_dict import reference_state_dict
from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
from sea_tpu.utils import torch_compat as JC
from sea_tpu.utils.checkpoint import _flatten
from sea_tpu_torch import cli as torch_cli
from sea_tpu_torch.configs.cylinder_flow_smoke import get_case as port_case
from sea_tpu_torch.models import spatial as TS
from sea_tpu_torch.models import temporal as TT
from sea_tpu_torch.utils import plotting
from sea_tpu_torch.utils import torch_compat as PC
from sea_tpu_torch.utils.checkpoint import checkpoint_path
from sea_tpu_torch.utils.params import (from_numpy, save_init_checkpoints,
                                        to_numpy)

torch.set_num_threads(2)

TABLE_ATOL = 1e-6
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6

TEMPORAL = {
    "sea": {},
    "sea_ln": dict(ln_type="ln"),
    "addition": dict(exchange_mode="addition"),
    "simple": dict(exchange_mode="simple"),
    "pool_linear": dict(exchange_mode="pool", pool_update_method="linear"),
    "pool_mlp": dict(exchange_mode="pool", pool_update_method="mlp"),
    "pool_pooling": dict(exchange_mode="pool",
                         pool_update_method="pooling"),
    "ib_fourier": dict(ib_scale_mode="fourier"),
    "ib_linear": dict(ib_scale_mode="linear"),
    "ib_attention": dict(ib_addition_mode="attention"),
}
CASES = ([("spatial", "plain"), ("spatial", "variational")]
         + [("temporal", name) for name in TEMPORAL])
N_INP = 7


def _cfgs(kind, name):
    """(JAX config, port config) of a case."""
    out = []
    for case in (jax_case(), port_case()):
        if kind == "spatial":
            out.append(dataclasses.replace(
                case.spatial, n_inp=N_INP,
                variational=name == "variational"))
        else:
            out.append(dataclasses.replace(case.temporal, **TEMPORAL[name]))
    return out


def _state_dict_file(tmp_path, kind, name):
    """A reference-named .pt of the port's seeded init of the case: with
    ``module.`` prefixes (an nn.DataParallel export) and a freqs_cis
    buffer for the plain spatial and the sea temporal case."""
    _, cfg = _cfgs(kind, name)
    gen = torch.Generator().manual_seed(3)
    tree = to_numpy(TS.init_spatial(cfg, gen, device="cpu")
                    if kind == "spatial"
                    else TT.init_temporal(cfg, gen, device="cpu"))
    prefixed = name in ("plain", "sea")
    sd = reference_state_dict(tree, kind, "module." if prefixed else "")
    if prefixed:  # a RoPE buffer of the reference's attention
        attn = ("encode.blocks.0.attn_1" if kind == "spatial"
                else "blocks.0.attn.self.0")
        sd[f"module.{attn}.freqs_cis"] = torch.randn(16, 4)
    path = str(tmp_path / f"{kind}_{name}.pt")
    torch.save(sd, path)
    return path, tree


def _mapped(path, kind, name):
    """(JAX mapper's tree, port mapper's tree) of a .pt."""
    jcfg, pcfg = _cfgs(kind, name)
    fn = f"{kind}_params_from_torch"
    want = getattr(JC, fn)(JC.state_dict_to_numpy(
        torch.load(path, map_location="cpu", weights_only=True)), jcfg)
    got = getattr(PC, fn)(PC.load_torch_state_dict(path), pcfg)
    return want, got


@pytest.mark.parametrize("kind,name", CASES)
def test_mapper_matches_jax(kind, name, tmp_path):
    """The same reference-named state dict gives the same tree in the JAX
    mapper and the port's, leaf for leaf, and the port's tree is the one
    the state dict was written from."""
    path, tree = _state_dict_file(tmp_path, kind, name)
    want, got = _mapped(path, kind, name)
    want, got, src = _flatten(want), _flatten(got), _flatten(tree)
    assert sorted(got) == sorted(want) == sorted(src)
    for key, w in want.items():
        assert got[key].dtype == w.dtype and got[key].shape == w.shape, key
        if key.split("/")[-1] in ("pe", "pool_pe"):
            np.testing.assert_allclose(got[key], w, rtol=0, atol=TABLE_ATOL,
                                       err_msg=key)
        else:
            assert np.array_equal(got[key], w), key
        assert np.array_equal(got[key], src[key]), key


@pytest.mark.parametrize("kind,name", [("spatial", "plain"),
                                       ("temporal", "sea")])
def test_mapped_forward_matches_jax(kind, name, tmp_path):
    """The port's forward on its mapped tree against JAX's forward on its
    own mapped tree."""
    from sea_tpu.models import spatial as JS
    from sea_tpu.models import temporal as JT
    path, _ = _state_dict_file(tmp_path, kind, name)
    want_tree, got_tree = _mapped(path, kind, name)
    jcfg, pcfg = _cfgs(kind, name)
    rs = np.random.RandomState(4)
    if kind == "spatial":
        x = rs.randn(3, 64, 3, N_INP).astype(np.float32)
        want = JS.spatial_forward(want_tree, jcfg, jnp.asarray(x))
        got = TS.spatial_forward(from_numpy(got_tree, "cpu"), pcfg,
                                 torch.from_numpy(x))
    else:
        x = rs.randn(2, 7, pcfg.num_fields, pcfg.embed_dim).astype(
            np.float32)
        ib = rs.randn(2, 7, pcfg.ib_num).astype(np.float32)
        want = JT.temporal_forward(want_tree, jcfg, jnp.asarray(x),
                                   jnp.asarray(ib))
        got = TT.temporal_forward(from_numpy(got_tree, "cpu"), pcfg,
                                  torch.from_numpy(x), torch.from_numpy(ib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FWD_RTOL,
                               atol=FWD_ATOL)


# ---------------------------------------------------------------------------
# --model_path x.pt through the CLI, in every mode
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke_pt(tmp_path_factory):
    """The smoke preset's seeded checkpoints in a save_dir, and both as
    reference-named .pt files beside them (the encoder's with
    ``module.`` prefixes)."""
    save = tmp_path_factory.mktemp("pt")
    case = port_case()
    trees = save_init_checkpoints(case, str(save), seed=1)
    paths = {}
    for kind, tree, prefix in (("encoder_decoder", "spatial", "module."),
                               ("temporal", "temporal", "")):
        paths[kind] = str(save / f"{kind}.pt")
        torch.save(reference_state_dict(trees[kind], tree, prefix),
                   paths[kind])
        paths[kind + ".npz"] = checkpoint_path(
            str(save), kind, case.run.case_name, case.run.run_name)
    return str(save), paths


@pytest.fixture
def no_plots(monkeypatch):
    """The metrics are compared; drawing the plots is left out."""
    for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                 "plot_rollout_error"):
        monkeypatch.setattr(plotting, name, lambda *a, **k: None)


def _run(save, *argv):
    return torch_cli.main(["cylinder_flow_smoke", *argv, "--synthetic",
                           "--save_dir", save, "--device", "cpu"])


@pytest.mark.parametrize("mode", ["temporal test", "encoder test",
                                  "temporal generate"])
def test_cli_pt_equals_npz(mode, smoke_pt, no_plots, capsys):
    """`--model_path x.pt` serves, tests and generates exactly as the same
    weights from their .npz."""
    save, paths = smoke_pt
    kind = "encoder_decoder" if mode.startswith("encoder") else "temporal"
    out = {}
    for suffix, path in ((".pt", paths[kind]), (".npz", paths[kind + ".npz"])):
        argv = mode.split() + ["--model_path", path]
        if mode.endswith("generate"):
            argv += ["--horizon", "12", "--output", f"{save}/gen{suffix}.npy"]
        out[suffix] = _run(save, *argv)
    assert f"model: {paths[kind]}" in capsys.readouterr().out
    if mode.endswith("generate"):
        assert out[".pt"].shape[0] == 12
        np.testing.assert_array_equal(out[".pt"], out[".npz"])
        return
    for key in out[".npz"]:
        if key not in ("engine", "decoded_rel_mse_per_time"):
            assert np.isfinite(out[".pt"][key]), key
        np.testing.assert_array_equal(out[".pt"][key], out[".npz"][key])


@pytest.mark.parametrize("model_type", ["temporal", "encoder"])
def test_cli_train_from_pt_starts_a_fresh_optimizer(model_type, smoke_pt,
                                                    tmp_path, capsys):
    """A train mode resumes a .pt's params with a fresh optimizer and
    says so; the run trains one epoch from them."""
    save, paths = smoke_pt
    kind = "encoder_decoder" if model_type == "encoder" else "temporal"
    out_dir = str(tmp_path)
    if model_type == "temporal":  # the frozen stage-1 model it encodes with
        os.link(paths["encoder_decoder.npz"],
                os.path.join(out_dir, os.path.basename(
                    paths["encoder_decoder.npz"])))
    params = _run(out_dir, model_type, "train", "--epochs", "1",
                  "--model_path", paths[kind])
    out = capsys.readouterr().out
    assert re.search(r"\.pt is a reference state dict with no optimizer "
                     r"state: resuming its params with a FRESH optimizer",
                     out)
    assert f"Continuing training from model: {paths[kind]}" in out
    assert "Restored optimizer state" not in out
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(params))


@pytest.mark.parametrize("argv,message", [
    (["temporal", "test", "--model_path", "model.ckpt"],
     "expected an .npz checkpoint or a reference PyTorch .pt"),
    (["temporal", "test", "--profile", "d"],
     "--profile only applies to train modes")])
def test_model_path_and_profile_flag_checks(argv, message, capsys):
    with pytest.raises(SystemExit):
        torch_cli.main(["cylinder_flow_smoke"] + argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err


def test_pt_of_another_config_is_refused(smoke_pt, tmp_path):
    """A state dict whose mapped tree does not fit the configured model
    is refused before any forward, naming the differing leaves."""
    _, paths = smoke_pt
    cfg = port_case().temporal
    template = to_numpy(TT.init_temporal(
        cfg, torch.Generator().manual_seed(0), device="cpu"))
    template["blocks"][0]["proj"][0]["w"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="differs from the configured"):
        torch_cli.load_any_checkpoint(paths["temporal"], template, cfg,
                                      kind="temporal")
