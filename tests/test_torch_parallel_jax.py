"""The port's sharded temporal train step against the JAX package's on the
same mesh shapes.

JAX's ``make_sharded_temporal_train_step`` runs on ``make_mesh(D, M)``
over the 8 virtual CPU devices tests/conftest.py sets up (6 or 4 of them
idle: JAX warns and goes on), its flash kernels in interpret mode, so
its attention dropout is the kernels' hash with their global ``bh_map``
(``parallel/kernel_shard.py``). The port's step runs in D x M gloo ranks
(tests/_torch_ranks.py) from the same npz weights (JAX's init), numpy
batch and key, ``cylinder_flow_smoke`` with dropout 0.1, AdamW in f32, at
2x1, 1x2 and 2x2; one step each. The bounds are those of
tests/test_torch_train.py's one-device comparison: the loss within 1e-5,
the norms rtol 1e-4, the gradients (as mu = (1 - b1) g) rtol 1e-4 plus
1e-7 of the gradient norm, nu rtol 1e-3, and the parameters within 1e-5
except where |g| is near AdamW's eps (the first update g / (|g| + eps) is
ill-conditioned there): within 1e-5 + lr |u(g_port) - u(g_jax)|.
"""

import concurrent.futures
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

SHAPES = [(2, 1), (1, 2), (2, 2)]
FWD_ATOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
NEAR_EPS = 100
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _setup():
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    case = get_case()
    params = jax.tree.map(np.asarray, init_temporal(
        jax.random.PRNGKey(0), jax_case().temporal))
    rs = np.random.RandomState(0)
    B, T, cfg = 4, 8, case.temporal
    src = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*src.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, 1).astype(np.float32)
    return case, jax_case(), params, (src, tgt, ib)


def _jax_step(shape, jcase, params, batch):
    from sea_tpu.ops import flash_attention as jfa
    from sea_tpu.parallel.mesh import make_mesh
    from sea_tpu.parallel.train_step import make_sharded_temporal_train_step
    from sea_tpu.train.optim import make_optimizer
    tx = make_optimizer(jcase.temporal_train)
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the idle virtual devices
        mp.setattr(jfa, "_FORCE_INTERPRET", True)
        mp.setattr(jfa, "flash_supported", lambda *a, **k: True)
        step, p, o, place = make_sharded_temporal_train_step(
            make_mesh(*shape), jcase.temporal, tx,
            jax.tree.map(jnp.asarray, params))
        p, o, stats = step(p, o, *place(*batch),
                           jax.random.fold_in(jax.random.PRNGKey(3), 0))
    return ({k: float(v) for k, v in stats.items()},
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o))


@pytest.fixture(scope="module")
def steps():
    """{shape: (port, jax)} one-step results; the port's ranks run while
    JAX compiles."""
    case, jcase, params, batch = _setup()
    key = [prng.fold_in(prng.prng_key(3), 0)]
    jobs = {"step": ("temporal_steps", (case.temporal, case.temporal_train,
                                        params, batch, key))}
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        port = {s: pool.submit(run_ranks, R.run_grid, s[0] * s[1], s, jobs)
                for s in SHAPES}
        want = {s: _jax_step(s, jcase, params, batch) for s in SHAPES}
        return {s: (port[s].result()[0]["step"], want[s]) for s in SHAPES}


@requires_8
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_sharded_step_matches_jax(shape, steps):
    (pstats, pp, po), (jstats, jp, jo) = steps[shape]
    tcfg = _setup()[0].temporal_train
    b1, lr, eps = tcfg.betas[0], tcfg.learning_rate, tcfg.eps
    np.testing.assert_allclose(pstats[0]["loss"], jstats["loss"], rtol=0,
                               atol=FWD_ATOL)
    for k in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(pstats[0][k], jstats[k], rtol=NORM_RTOL,
                                   err_msg=k)
    gscale = jstats["grad_norm"]
    got, want = (_flatten({"p": p, "o": o}) for p, o in ((pp, po), (jp, jo)))
    assert sorted(got) == sorted(want)
    u = lambda g: g / (np.abs(g) + eps)  # noqa: E731
    for key in (k for k in want if k.startswith("p/")):
        mu, nu = (f"o/0/{i}/{key[2:]}" for i in (1, 2))
        np.testing.assert_allclose(got[mu], want[mu], rtol=NORM_RTOL,
                                   atol=1e-7 * gscale, err_msg=mu)
        np.testing.assert_allclose(got[nu], want[nu], rtol=1e-3,
                                   atol=1e-7 * gscale ** 2, err_msg=nu)
        gp = got[mu].astype(np.float64) / (1 - b1)
        gj = want[mu].astype(np.float64) / (1 - b1)
        tol = np.where(np.abs(gj) > NEAR_EPS * eps, PARAM_ATOL,
                       PARAM_ATOL + lr * np.abs(u(gp) - u(gj)))
        diff = np.abs(got[key].astype(np.float64) - want[key])
        assert (diff <= tol).all(), (key, diff.max())
