"""The port's sequence-parallel temporal train step
(``parallel.train_step.make_seq_parallel_train_step``) against the JAX
package's ``make_seq_parallel_train_step``.

``cylinder_flow_smoke`` (dropout 0.1, AdamW in f32), B=2, T=40, one step
from the same npz weights (JAX's init), numpy batch and key. The port
runs a ring of 2 or 4 gloo ranks (tests/_torch_ranks.py ``run_seq``),
JAX a 'seq' mesh over 2 or 4 of the 8 virtual devices; both shard the
time axis and hash every dropout mask at global positions, so the step
is one device's. The bounds are tests/test_torch_parallel_jax.py's: the
loss within 1e-5, the norms rtol 1e-4, the gradients (as mu = (1 - b1)
g) rtol 1e-4 plus 1e-7 of the gradient norm, nu rtol 1e-3, the
parameters within 1e-5 except where |g| is near AdamW's eps: within
1e-5 + lr |u(g_port) - u(g_jax)|. The port's ring step also equals its
one-device step (one process) within the same bounds.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch.parallel.collectives import Grid
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.checkpoint import _flatten

torch.set_num_threads(2)

RINGS = (2, 4)
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
    B, T, cfg = 2, 40, case.temporal
    src = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*src.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, 1).astype(np.float32)
    return case, jax_case(), params, (src, tgt, ib)


def _jax_step(n, jcase, params, batch):
    from jax.sharding import Mesh
    from sea_tpu.parallel.train_step import make_seq_parallel_train_step
    from sea_tpu.train.optim import make_optimizer
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))
    step, p, o, place = make_seq_parallel_train_step(
        mesh, jcase.temporal, make_optimizer(jcase.temporal_train),
        jax.tree.map(jnp.asarray, params))
    p, o, stats = step(p, o, *place(*batch),
                       jax.random.fold_in(jax.random.PRNGKey(3), 0))
    return ({k: float(v) for k, v in stats.items()},
            jax.tree.map(np.asarray, p), jax.tree.map(np.asarray, o))


@pytest.fixture(scope="module")
def steps():
    """{n: (port, jax)} and the port's one-device step under "one"."""
    case, jcase, params, batch = _setup()
    key = [prng.fold_in(prng.prng_key(3), 0)]
    jobs = {"step": ("seq_steps", (case.temporal, case.temporal_train,
                                   params, batch, key))}
    with concurrent.futures.ThreadPoolExecutor(len(RINGS)) as pool:
        port = {n: pool.submit(run_ranks, R.run_seq, n, jobs) for n in RINGS}
        want = {n: _jax_step(n, jcase, params, batch) for n in RINGS}
        out = {n: (port[n].result()[0]["step"], want[n]) for n in RINGS}
    out["one"] = R.temporal_steps(Grid(1, 1), case.temporal,
                                  case.temporal_train, params, batch, key)
    return out


def _compare(port, want, tcfg):
    (pstats, pp, po), (jstats, jp, jo) = port, want
    jstats = jstats[0] if isinstance(jstats, list) else jstats
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


@requires_8
@pytest.mark.parametrize("n", RINGS)
def test_seq_step_matches_jax(n, steps):
    _compare(*steps[n], _setup()[0].temporal_train)


@pytest.mark.parametrize("n", RINGS)
def test_seq_step_matches_one_device(n, steps):
    _compare(steps[n][0], steps["one"], _setup()[0].temporal_train)
