"""The port's pipelined forward (``parallel.pipeline``) against the JAX
package's ``pipeline_forward`` and the one-device forward.

``cylinder_flow_smoke`` cut to 4 layers, B=4, T=8, inputs from numpy,
JAX's init handed over as npz trees. Deterministic: the port's forward
in 2 or 4 gloo ranks (tests/_torch_ranks.py ``run_pipe``) at (data,
pipe) 1x2 with 2 microbatches, 1x4 with 4 and 2x2 with 2 equals JAX's
``pipeline_forward`` on its ('data', 'pipe') mesh of the 8 virtual
devices, and the port's one-device ``temporal_forward``, within 1e-5 (f32
order). With dropout 0.1 the forward at 2 and 4 stages equals the one at
1 stage: the keys are drawn per (microbatch, global layer). The grid and
batch errors are the JAX function's.
"""

import concurrent.futures
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch.parallel import pipeline as P
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.utils import prng

torch.set_num_threads(2)

ATOL = 1e-5
# (data, pipe): microbatches
SHAPES = {(1, 2): 2, (1, 4): 4, (2, 2): 2}
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _setup():
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    cfg = dataclasses.replace(get_case().temporal, num_layers=4)
    jcfg = dataclasses.replace(jax_case().temporal, num_layers=4)
    params = jax.tree.map(np.asarray, init_temporal(jax.random.PRNGKey(0),
                                                    jcfg))
    rs = np.random.RandomState(1)
    x = rs.randn(4, 8, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = np.repeat(rs.rand(4, 1, cfg.ib_num), 8, 1).astype(np.float32)
    return cfg, jcfg, params, x, ib


def _jax_forward(shape, jcfg, params, x, ib):
    from sea_tpu.parallel.pipeline import (make_pipe_mesh, pipeline_forward,
                                           stack_pipeline_params)
    mesh = make_pipe_mesh(n_pipe=shape[1], n_data=shape[0])
    return np.asarray(pipeline_forward(
        stack_pipeline_params(jax.tree.map(jnp.asarray, params)), jcfg,
        jnp.asarray(x), jnp.asarray(ib), mesh=mesh,
        n_microbatches=SHAPES[shape]))


@pytest.fixture(scope="module")
def forwards():
    """{shape: (every rank's output, JAX's)}, the dropout forwards at 1, 2
    and 4 stages under "dropout" (each rank's outputs; 1 stage in this
    process), and the one-device forward under "one"."""
    from sea_tpu_torch.models.temporal import temporal_forward
    from sea_tpu_torch.utils.params import from_numpy
    cfg, jcfg, params, x, ib = _setup()
    key = prng.fold_in(prng.prng_key(5), 0)
    drop = dataclasses.replace(cfg, dropout=0.1)

    def jobs(shape):
        out = {"f": ("pipe_forward", (cfg, params, x, ib, SHAPES[shape],
                                      None))}
        if shape[0] == 1:  # the dropout forward over these stages too
            out["drop"] = ("pipe_forward", (drop, params, x, ib, 4, key))
        return out
    with concurrent.futures.ThreadPoolExecutor(len(SHAPES)) as pool:
        port = {s: pool.submit(run_ranks, R.run_pipe, s[0] * s[1], s,
                               jobs(s)) for s in SHAPES}
        want = {s: _jax_forward(s, jcfg, params, x, ib)
                for s in [(1, 2), (1, 4)]}
        ranks = {s: port[s].result() for s in SHAPES}
    out = {s: ([r["f"] for r in ranks[s]], want.get(s)) for s in SHAPES}
    out["dropout"] = {(1, n): [r["drop"] for r in ranks[(1, n)]]
                      for n in (2, 4)}
    out["dropout"][(1, 1)] = [R.pipe_forward(P.PipeGrid(1), drop, params,
                                             x, ib, 4, key)]
    with torch.no_grad():
        out["one"] = temporal_forward(from_numpy(params, "cpu"), cfg,
                                      torch.from_numpy(x),
                                      torch.from_numpy(ib)).numpy()
    return out


@requires_8
@pytest.mark.parametrize("shape", [(1, 2), (1, 4)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_forward_matches_jax(shape, forwards):
    ranks, want = forwards[shape]
    for got in ranks:  # every rank holds the global output
        assert got.shape == want.shape == (4, 8, 2, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape", sorted(SHAPES),
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_pipeline_forward_matches_one_device(shape, forwards):
    for got in forwards[shape][0]:
        np.testing.assert_allclose(got, forwards["one"], rtol=0, atol=ATOL)


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_dropout_is_stage_invariant(stages, forwards):
    one = forwards["dropout"][(1, 1)][0]
    assert not np.allclose(one, forwards["one"], atol=1e-3)  # it dropped
    for got in forwards["dropout"][(1, stages)]:
        np.testing.assert_allclose(got, one, rtol=0, atol=ATOL)


@pytest.mark.parametrize("shape,batch,mb", [
    ((1, 2), 4, 3), ((2, 2), 6, 2), ((1, 3), 4, 2)])
def test_pipeline_batch_errors_are_jaxs(shape, batch, mb):
    """B % microbatches, the microbatch over the data axis and the layers
    over the stages: the JAX function's messages."""
    from sea_tpu.parallel.pipeline import make_pipe_mesh, pipeline_forward
    cfg, jcfg, _, _, _ = _setup()
    with pytest.raises(ValueError) as want:
        pipeline_forward({}, jcfg, jnp.zeros((batch, 8, 2, 32)),
                         jnp.zeros((batch, 8, 1)),
                         mesh=make_pipe_mesh(shape[1], shape[0]),
                         n_microbatches=mb)
    grid = P.PipeGrid(shape[1], shape[0])
    with pytest.raises(ValueError) as got:
        P.pipeline_forward({}, cfg, torch.zeros(batch, 8, 2, 32),
                           torch.zeros(batch, 8, 1), grid=grid,
                           n_microbatches=mb)
    assert str(got.value) == str(want.value)


def test_pipe_grid_and_layout():
    """One process: only a 1 x 1 grid; a stage's blocks and the gathered
    one-device tree."""
    with pytest.raises(ValueError, match="needs 2 ranks"):
        P.make_pipe_mesh(2)
    grid = P.make_pipe_mesh(1)
    assert (grid.n_pipe, grid.n_data, grid.size) == (1, 1, 1)
    cfg, _, params, _, _ = _setup()
    stage = P.stage_params(P.PipeGrid(2, 1, pipe_rank=1), params, 4)
    assert stage["blocks"] == params["blocks"][2:]
    assert stage["ln_final"] is params["ln_final"]
    assert P.gather_params(grid, params, 4) is params
    with pytest.raises(ValueError, match="not divisible by pipe=3"):
        P.PipeGrid(3).layers(4)
