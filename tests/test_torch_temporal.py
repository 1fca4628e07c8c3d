"""Port parity: sea_tpu_torch.models.temporal and rollout.engine against
the JAX package on the CPU.

Configs are the cylinder_flow_smoke temporal preset cut further with
dataclasses.replace (E=32, 2 heads, 1-2 layers); weights are
JAX-initialised and handed over through jax.tree.map(np.asarray, .) and
from_numpy; inputs come from numpy with a fixed seed. Tolerances: 1e-5
for one forward or one step (f32, summation order), and 2e-4 for a
rollout, the bound tests/test_rollout.py holds the JAX engines to (errors
feed back through the autoregressive loop); bf16 caches are stated at
their test.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.configs.cylinder_flow_smoke import get_case
from sea_tpu.models import temporal as JT
from sea_tpu.rollout.engine import rollout_jit
from sea_tpu.utils.checkpoint import _flatten
from sea_tpu_torch.models import temporal as TT
from sea_tpu_torch.rollout.engine import rollout_scan
from sea_tpu_torch.utils.params import from_numpy, to_numpy

torch.set_num_threads(2)

STEP_ATOL = 1e-5
ROLLOUT_ATOL = 2e-4

VARIANTS = {
    # cylinder's temporal block: AdaLN, ib added after the exchange
    "adaln": dict(num_layers=2),
    # multiphase's: plain LN, dropout off; ib added before the exchange
    "ln": dict(ln_type="ln", dropout=0.0, add_info_after_cross=False),
    # three fields: a 6-pair lattice with the sequential update
    "adaln_g3": dict(num_fields=3),
}


# The two preset blocks; the G=3 lattice is held to JAX by init and rollout.
PRESET_BLOCKS = ("adaln", "ln")


def _cfg(name):
    return dataclasses.replace(get_case().temporal, **VARIANTS[name])


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    # Eager: one jit of the whole init compiles for several times longer.
    return JT.init_temporal(jax.random.PRNGKey(0), _cfg(name))


def _port_params(name):
    return from_numpy(jax.tree.map(np.asarray, _jax_params(name)), "cpu")


def _inputs(cfg, B, T, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = rs.randn(B, T, cfg.ib_num).astype(np.float32)
    return x, ib


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_init_tree_matches_jax(name):
    """Same keys, shapes and dtypes; the constant leaves (norm weights,
    biases) equal; the random leaves are N(0, 0.02)."""
    cfg = _cfg(name)
    want = _flatten(jax.tree.map(np.asarray, _jax_params(name)))
    got = _flatten(to_numpy(TT.init_temporal(
        cfg, torch.Generator().manual_seed(0), device="cpu")))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g = got[key]
        assert (g.shape, g.dtype) == (w.shape, w.dtype), key
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(g, w, err_msg=key)
        elif w.size >= 1000:
            assert 0.018 < g.std() < 0.022, (key, g.std())


@pytest.mark.parametrize("name", PRESET_BLOCKS)
def test_forward_matches_jax(name):
    cfg = _cfg(name)
    x, ib = _inputs(cfg, B=2, T=6)
    want = jax.jit(lambda p, x, ib: JT.temporal_forward(p, cfg, x, ib))(
        _jax_params(name), x, ib)
    got = TT.temporal_forward(_port_params(name), cfg, torch.from_numpy(x),
                              torch.from_numpy(ib))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STEP_ATOL)


@pytest.mark.parametrize("name", PRESET_BLOCKS)
def test_step_matches_jax(name):
    """Teacher-forced steps t = 0..T-1, each against the JAX step with its
    own functional caches."""
    cfg = _cfg(name)
    B, T = 2, 5
    x, ib = _inputs(cfg, B, T, seed=1)
    jstep = jax.jit(functools.partial(JT.temporal_step, cfg=cfg))
    jparams, jcache = _jax_params(name), JT.init_temporal_cache(cfg, B, T)
    params, cache = _port_params(name), TT.init_temporal_cache(
        cfg, B, T, device="cpu")
    for t in range(T):
        want, jcache = jstep(jparams, x_t=x[:, t], ib_t=ib[:, t],
                             cache=jcache, t=jnp.int32(t))
        got = TT.temporal_step(params, cfg, torch.from_numpy(x[:, t]),
                               torch.from_numpy(ib[:, t]), cache,
                               torch.tensor([t], dtype=torch.int32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=STEP_ATOL, err_msg=f"t={t}")


@pytest.mark.parametrize("name", PRESET_BLOCKS)
def test_step_equals_forward(name):
    """temporal_step at t reproduces temporal_forward(x[:, :t+1])[:, t]
    (the port's own oracle, as tests/test_rollout.py checks the JAX one)."""
    cfg = _cfg(name)
    B, T = 2, 6
    x, ib = map(torch.from_numpy, _inputs(cfg, B, T, seed=2))
    params = _port_params(name)
    full = TT.temporal_forward(params, cfg, x, ib)
    cache = TT.init_temporal_cache(cfg, B, T, device="cpu")
    for t in range(T):
        y = TT.temporal_step(params, cfg, x[:, t], ib[:, t], cache,
                             torch.tensor([t], dtype=torch.int32))
        torch.testing.assert_close(y, full[:, t], rtol=0, atol=ROLLOUT_ATOL)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_rollout_scan_matches_jax(name):
    cfg = _cfg(name)
    x, ib = _inputs(cfg, B=2, T=12, seed=3)
    want = rollout_jit(_jax_params(name), cfg, x[:, 0], ib)
    got = rollout_scan(_port_params(name), cfg, torch.from_numpy(x[:, 0]),
                       torch.from_numpy(ib))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ROLLOUT_ATOL)


@pytest.mark.parametrize("name", PRESET_BLOCKS)
def test_rollout_scan_bf16_cache_matches_jax(name):
    """bf16 KV caches: both round K/V to bf16, and the port also rounds q
    and p as the flash-decode kernel does. atol 5e-3 holds the port to the
    JAX bf16 rollout (gap ~1e-3) yet fails an f32 cache (~6e-3 away)."""
    cfg = _cfg(name)
    x, ib = _inputs(cfg, B=2, T=12, seed=3)
    want = rollout_jit(_jax_params(name), cfg, x[:, 0], ib, jnp.bfloat16)
    got = rollout_scan(_port_params(name), cfg, torch.from_numpy(x[:, 0]),
                       torch.from_numpy(ib), cache_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-3)


def test_module_owns_and_moves_params():
    cfg = _cfg("ln")
    x, ib = map(torch.from_numpy, _inputs(cfg, B=1, T=3))
    params = _port_params("ln")
    model = TT.TemporalModel(cfg, params).to("cpu")
    torch.testing.assert_close(model(x, ib),
                               TT.temporal_forward(params, cfg, x, ib))
    model = model.to(torch.float64)
    assert model.params["blocks"][0]["mlp"][0]["layers"][0]["lin"][
        "w"].dtype == torch.float64
