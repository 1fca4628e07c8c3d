"""The port's pipeline-parallel temporal train step
(``parallel.pipeline.make_pipeline_train_step``) against the JAX
package's ``make_pipeline_train_step``.

``cylinder_flow_smoke`` cut to 2 layers (one a stage), dropout 0.1,
AdamW in f32, B=4, T=8, 2 microbatches, one step from the same npz
weights (JAX's init), numpy batch and key, at (data, pipe) 1x2 (here)
and 2x2 (tests/test_torch_pipeline_step_dp.py, which takes this
module's helpers):
the port in 2 or 4 gloo ranks (tests/_torch_ranks.py ``run_pipe``), JAX
on its ('data', 'pipe') mesh over the 8 virtual devices. Both draw one
key per (microbatch, global layer), and inside a stage both see the
stage's own microbatch block. The JAX pipeline attends through XLA (a
pallas_call inside its shard_map is refused), whose dropout hashes the
flat index of the probabilities; so here the port's attentions take
their plain path, whose dropout is that hash (on the card they run the
flash kernels, whose hash is the JAX kernels': the same distribution,
other bits; ROADMAP.md Queue 3). The bounds are
tests/test_torch_parallel_jax.py's (loss 1e-5, norms rtol 1e-4, the
gradients as mu = (1 - b1) g rtol 1e-4 plus 1e-7 of the gradient norm,
the parameters within 1e-5 + lr |u(g_port) - u(g_jax)| where |g| is
near AdamW's eps). With the flash path, the step at S=2 equals the
step at S=1 (the dropout does not depend on the stages).
"""

import concurrent.futures
import dataclasses

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

SHAPE = (1, 2)  # (data, pipe)
M_ = 2
FWD_ATOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
NEAR_EPS = 100
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _setup():
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    case, jcase = get_case(), jax_case()
    cfg = dataclasses.replace(case.temporal, num_layers=2)
    jcfg = dataclasses.replace(jcase.temporal, num_layers=2)
    params = jax.tree.map(np.asarray, init_temporal(jax.random.PRNGKey(0),
                                                    jcfg))
    rs = np.random.RandomState(0)
    B, T = 4, 8
    src = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*src.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, 1).astype(np.float32)
    return case, cfg, jcase, jcfg, params, (src, tgt, ib)


def _jax_step(shape, jcase, jcfg, params, batch):
    from sea_tpu.parallel.pipeline import (make_pipe_mesh,
                                           make_pipeline_train_step,
                                           unstack_pipeline_params)
    from sea_tpu.train.optim import make_optimizer
    step, p, o, place = make_pipeline_train_step(
        make_pipe_mesh(n_pipe=shape[1], n_data=shape[0]), jcfg,
        make_optimizer(jcase.temporal_train),
        jax.tree.map(jnp.asarray, params), n_microbatches=M_)
    p, o, stats = step(p, o, *place(*batch),
                       jax.random.fold_in(jax.random.PRNGKey(3), 0))
    mu = o[0].mu
    return ({k: float(v) for k, v in stats.items()},
            jax.tree.map(np.asarray, unstack_pipeline_params(
                p, jcfg.num_layers)),
            jax.tree.map(np.asarray, unstack_pipeline_params(
                mu, jcfg.num_layers)))


def port_and_jax(shape, flash_shapes=()):
    """(the port's step, JAX's) at ``shape`` and the port's flash-path
    steps at ``flash_shapes``; the port's ranks run while JAX compiles."""
    case, cfg, jcase, jcfg, params, batch = _setup()
    key = [prng.fold_in(prng.prng_key(3), 0)]

    def job(plain):
        return {"s": ("pipe_steps", (cfg, case.temporal_train, params,
                                     batch, key, M_, plain))}
    with concurrent.futures.ThreadPoolExecutor(1 + len(flash_shapes)) as pool:
        port = pool.submit(run_ranks, R.run_pipe, shape[0] * shape[1],
                           shape, job(True))
        flash = {s: pool.submit(run_ranks, R.run_pipe, s[0] * s[1], s,
                                job(False)) for s in flash_shapes}
        want = _jax_step(shape, jcase, jcfg, params, batch)
        return ((port.result()[0]["s"], want),
                {s: f.result()[0]["s"] for s, f in flash.items()})


def one_stage_flash_step():
    """The flash path's step on one stage, in this process."""
    from sea_tpu_torch.parallel.pipeline import PipeGrid
    case, cfg, _, _, params, batch = _setup()
    return R.pipe_steps(PipeGrid(1), cfg, case.temporal_train, params,
                        batch, [prng.fold_in(prng.prng_key(3), 0)], M_,
                        False)


@pytest.fixture(scope="module")
def steps():
    return port_and_jax(SHAPE, [(1, 2)])


def check_against_jax(port, want):
    """The bounds of the module docstring."""
    (pstats, pp, pmu), (jstats, jp, jmu) = port, want
    tcfg = _setup()[0].temporal_train
    b1, lr, eps = tcfg.betas[0], tcfg.learning_rate, tcfg.eps
    np.testing.assert_allclose(pstats[0]["loss"], jstats["loss"], rtol=0,
                               atol=FWD_ATOL)
    for k in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(pstats[0][k], jstats[k], rtol=NORM_RTOL,
                                   err_msg=k)
    gscale = jstats["grad_norm"]
    got_p, want_p, got_mu, want_mu = map(_flatten, (pp, jp, pmu, jmu))
    assert sorted(got_p) == sorted(want_p) == sorted(want_mu)
    u = lambda g: g / (np.abs(g) + eps)  # noqa: E731
    for key in want_p:
        np.testing.assert_allclose(got_mu[key], want_mu[key],
                                   rtol=NORM_RTOL, atol=1e-7 * gscale,
                                   err_msg=key)
        gp = got_mu[key].astype(np.float64) / (1 - b1)
        gj = want_mu[key].astype(np.float64) / (1 - b1)
        tol = np.where(np.abs(gj) > NEAR_EPS * eps, PARAM_ATOL,
                       PARAM_ATOL + lr * np.abs(u(gp) - u(gj)))
        diff = np.abs(got_p[key].astype(np.float64) - want_p[key])
        assert (diff <= tol).all(), (key, diff.max())


@requires_8
def test_pipeline_step_matches_jax(steps):
    check_against_jax(*steps[0])


def test_pipeline_step_is_stage_invariant(steps):
    """The flash path's step with dropout: 2 stages give 1 stage's
    params (the keys are per microbatch and global layer)."""
    one, two = one_stage_flash_step(), steps[1][(1, 2)]
    assert one[0] == two[0]
    for a, b in ((one[1], two[1]), (one[2], two[2])):
        a, b = _flatten(a), _flatten(b)
        assert sorted(a) == sorted(b)
        for key in a:
            np.testing.assert_allclose(b[key], a[key], rtol=0, atol=1e-6,
                                       err_msg=key)
