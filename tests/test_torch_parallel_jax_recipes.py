"""The port's sharded steps against the JAX package's under the other
recipes, one mesh shape each (tests/test_torch_parallel_jax.py has the
f32 AdamW step at every shape, tests/test_torch_parallel_jax_adafactor.py
the Adafactor step; tests/test_torch_parallel.py holds every recipe at
every shape to the port's one-device step):

- bf16_shadow with bf16 first moments on 2x2: both sides round to bf16
  at their own points (JAX's GSPMD partial sums, the port's
  row-parallel halves summed in f32 then rounded), so the loss and norms
  are held to one bf16 ulp (2^-8) relative and a parameter to 1e-5 + lr
  |u(g_port) - u(g_jax)|, the two first AdamW updates u(g) = g / (|g| +
  eps) from each side's own gradient (|g| from nu, its sign from mu);
- the variational stage-1 step on 2x1 (dropout 0.1 on the attention's
  probabilities and the MLPs, the reparameterization noise): loss, the
  reconstruction and KL terms and R^2 rtol 1e-5 (XLA's erfinv is another
  polynomial than PyTorch's: the noise differs by ulps), norms rtol 1e-4,
  a parameter within 1e-5, or 1e-5 + 2 lr where JAX's gradient is
  within 100 eps of 0 (AdamW's first update g / (|g| + eps) is
  ill-conditioned there).
"""

import concurrent.futures
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.checkpoint import _flatten

torch.set_num_threads(2)

FWD_ATOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
BF16_RTOL = 2.0 ** -8
NEAR_EPS = 100
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
BF16 = {"compute_dtype": "bfloat16_shadow", "adam_mu_dtype": "bfloat16"}
ADAFACTOR = {"optimizer": "adafactor"}
CELLS = {"bf16": ((2, 2), BF16, 32), "adafactor": ((1, 2), ADAFACTOR, 128)}


def _cases(E):
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    out = []
    for case in (get_case(), jax_case()):
        out.append(case.replace(
            temporal=dataclasses.replace(case.temporal, embed_dim=E),
            spatial=dataclasses.replace(case.spatial, embed_dim=E // 4)))
    return out


def _temporal(E):
    from sea_tpu.models.temporal import init_temporal
    case, jcase = _cases(E)
    params = jax.tree.map(np.asarray, init_temporal(
        jax.random.PRNGKey(0), jcase.temporal))
    rs = np.random.RandomState(0)
    src = rs.randn(4, 8, 2, E).astype(np.float32)
    tgt = rs.randn(*src.shape).astype(np.float32)
    ib = np.repeat(rs.rand(4, 1, 1), 8, 1).astype(np.float32)
    return case, jcase, params, (src, tgt, ib)


def _spatial():
    from sea_tpu.models.spatial import init_spatial
    case, jcase = _cases(32)
    cfgs = [dataclasses.replace(c.spatial, variational=True, dropout=0.1,
                                n_inp=6) for c in (case, jcase)]
    tcfgs = [dataclasses.replace(c.spatial_train, kl_weight_min=0.1,
                                 kl_weight_max=1.0) for c in (case, jcase)]
    params = jax.tree.map(np.asarray, init_spatial(jax.random.PRNGKey(2),
                                                   cfgs[1]))
    batch = np.random.RandomState(5).randn(4, 4, 3, 6).astype(np.float32)
    return cfgs, tcfgs, params, batch


def _jax_temporal(name):
    from sea_tpu.ops import flash_attention as jfa
    from sea_tpu.parallel.mesh import make_mesh
    from sea_tpu.parallel.train_step import make_sharded_temporal_train_step
    from sea_tpu.train.optim import make_optimizer
    shape, recipe, E = CELLS[name]
    _, jcase, params, batch = _temporal(E)
    tcfg = dataclasses.replace(jcase.temporal_train, **recipe)
    tx = make_optimizer(tcfg)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the idle virtual devices
        mp.setattr(jfa, "_FORCE_INTERPRET", True)
        mp.setattr(jfa, "flash_supported", lambda *a, **k: True)
        step, p, o, place = make_sharded_temporal_train_step(
            make_mesh(*shape), jcase.temporal, tx,
            jax.tree.map(jnp.asarray, params),
            compute_dtype=tcfg.compute_dtype)
        p, o, stats = step(p, o, *place(*batch),
                           jax.random.fold_in(jax.random.PRNGKey(3), 0))
    return ({k: float(v) for k, v in stats.items()},
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o))


def _jax_spatial():
    from sea_tpu.parallel.mesh import make_mesh
    from sea_tpu.parallel.train_step import make_sharded_spatial_train_step
    from sea_tpu.train.optim import make_optimizer
    (_, cfg), (_, tcfg), params, batch = _spatial()
    tx = make_optimizer(tcfg)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        step, p, o, place = make_sharded_spatial_train_step(
            make_mesh(2, 1), cfg, tx, jax.tree.map(jnp.asarray, params),
            kl_weight_min=tcfg.kl_weight_min,
            kl_weight_max=tcfg.kl_weight_max, total_steps=10)
        p, o, stats = step(p, o, place(batch),
                           jax.random.fold_in(jax.random.PRNGKey(3), 0), 3)
    return ({k: float(v) for k, v in stats.items()},
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o))


def run_cells(names):
    """{cell: (port, jax)} of the named cells (of CELLS, or "spatial");
    the port's ranks run while JAX compiles."""
    key = prng.fold_in(prng.prng_key(3), 0)
    jobs = {}
    for name in names:
        if name == "spatial":
            (cfg, _), (tcfg, _), sparams, sbatch = _spatial()
            jobs[name] = ((2, 1), {name: ("spatial_step", (
                cfg, tcfg, sparams, sbatch, key, 3, 10))})
            continue
        shape, recipe, E = CELLS[name]
        case, _, params, batch = _temporal(E)
        jobs[name] = (shape, {name: ("temporal_steps", (
            case.temporal, dataclasses.replace(case.temporal_train,
                                               **recipe),
            params, batch, [key]))})
    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
        port = {name: pool.submit(run_ranks, R.run_grid,
                                  shape[0] * shape[1], shape, job)
                for name, (shape, job) in jobs.items()}
        want = {name: _jax_spatial() if name == "spatial" else
                _jax_temporal(name) for name in jobs}
        return {name: (port[name].result()[0][name], want[name])
                for name in jobs}


@pytest.fixture(scope="module")
def runs():
    return run_cells(("bf16", "spatial"))


def _paths(params, state):
    return _flatten({"p": params, "o": state})


@requires_8
def test_bf16_shadow_step_matches_jax(runs):
    (pstats, pp, po), (jstats, jp, jo) = runs["bf16"]
    tcfg = _temporal(32)[0].temporal_train
    b2, lr, eps = tcfg.betas[1], tcfg.learning_rate, tcfg.eps
    for k in ("loss", "grad_norm", "param_norm"):
        np.testing.assert_allclose(pstats[0][k], jstats[k], rtol=BF16_RTOL,
                                   err_msg=k)
    got, want = _paths(pp, po), _paths(jp, jo)
    assert sorted(got) == sorted(want)
    u = lambda g: g / (np.abs(g) + eps)  # noqa: E731

    def grad(tree, key):  # |g| from nu, the sign from mu (the inner state)
        nu = tree[f"o/0/0/2/{key}"].astype(np.float64)
        return np.sign(tree[f"o/0/0/1/{key}"]) * np.sqrt(nu / (1 - b2))
    for key in (k[2:] for k in want if k.startswith("p/")):
        tol = PARAM_ATOL + lr * np.abs(u(grad(got, key)) - u(grad(want,
                                                                  key)))
        diff = np.abs(got["p/" + key].astype(np.float64) - want["p/" + key])
        assert (diff <= tol).all(), (key, diff.max())
        # the shadow is the bf16 cast of the updated params on both sides
        np.testing.assert_array_equal(
            got[f"o/1/{key}"],
            torch.from_numpy(got["p/" + key]).bfloat16().float().numpy())


@requires_8
def test_variational_spatial_step_matches_jax(runs):
    (pstats, pp), (jstats, jp, jo) = runs["spatial"]
    tcfg = _spatial()[1][0]
    b1, lr, eps = tcfg.betas[0], tcfg.learning_rate, tcfg.eps
    for k in ("loss", "recon_loss", "kl_loss", "r2", "param_norm"):
        np.testing.assert_allclose(pstats[k], jstats[k], rtol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(pstats["grad_norm"], jstats["grad_norm"],
                               rtol=NORM_RTOL)
    got, want = _flatten(pp), _flatten(jp)
    jmu = _flatten(jo[0].mu)
    assert sorted(got) == sorted(want)
    for key in want:
        gj = jmu[key].astype(np.float64) / (1 - b1)
        near = np.abs(gj) <= NEAR_EPS * eps
        tol = np.where(near, PARAM_ATOL + 2 * lr, PARAM_ATOL)
        diff = np.abs(got[key] - want[key])
        assert (diff <= tol).all(), (key, diff.max())
