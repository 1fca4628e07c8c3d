"""The port's sharded rollout against the JAX package's
``make_sharded_rollout`` on the same mesh shapes: trajectories over the
data axis, the serving tree (f32, int8 or packed int4 weights, every
matrix of at least 64 elements quantized, as tests/test_torch_e2e.py does
at the smoke preset) tensor-parallel over the model axis, the scan
engine's caches local to each rank. JAX runs on 8 virtual CPU devices
with its int4 and decode kernels on in interpret mode at the shapes the
port's kernels take (tests/test_torch_e2e.py's switches), inside its
shard_map decompositions (``parallel/kernel_shard.py``); the port in
gloo ranks (tests/_torch_ranks.py). Cells: f32 on 2x1, int8 weights on
1x2, int4 weights with an int8 cache on 1x2 and with a bf16 cache on 2x2,
``cylinder_flow_smoke`` over 6 steps from 4 trajectories. Bounds: f32 and
int8 atol 2e-4, the one-device rollout's against JAX
(tests/test_torch_temporal.py); int4 with an int8 or a bf16 cache atol
5e-3. The port's one-device scan rollout with a bf16 cache is held to
JAX's ``rollout_scan`` with its decode kernel on (interpret mode) within
1e-5 with f32 weights and with int4 ones: both round each unnormalised
probability to bf16 against the running max of the TPU kernel's 256-key
tiles (``ops/decode_attention._tile_softmax_terms``), and q to the cache
dtype.
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
from sea_tpu_torch.utils import precision as prec
from sea_tpu_torch.utils.params import from_numpy, to_numpy

torch.set_num_threads(2)

requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")
# name: (mesh shape, weights, the port's cache dtype, the JAX one, atol)
CELLS = {
    "f32-2x1": ((2, 1), "f32", torch.float32, jnp.float32, 2e-4),
    "int8-1x2": ((1, 2), "int8", torch.float32, jnp.float32, 2e-4),
    "int4-int8cache-1x2": ((1, 2), "int4", torch.int8, jnp.int8, 5e-3),
    "int4-bf16cache-2x2": ((2, 2), "int4", torch.bfloat16, jnp.bfloat16,
                           5e-3),
}
# One device, bf16 cache: weights -> atol against JAX's rollout_scan.
ONE_DEVICE_BF16 = {"f32": 1e-5, "int4": 1e-5}


def _setup():
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    params = jax.tree.map(np.asarray, init_temporal(
        jax.random.PRNGKey(0), jax_case().temporal))
    t = from_numpy(params, "cpu")
    trees = {"f32": params,
             "int8": to_numpy(prec.quantize_weights_int8(t, min_size=64)),
             "int4": to_numpy(prec.quantize_weights_int4(t, min_size=64))}
    rs = np.random.RandomState(3)
    x0 = rs.randn(4, 2, 32).astype(np.float32)
    ib = np.repeat(rs.rand(4, 1, 1), 6, 1).astype(np.float32)
    return get_case().temporal, jax_case().temporal, trees, x0, ib


def _kernels_on(mp):
    """JAX's int4 and decode kernels on, in interpret mode, at the shapes
    the port's kernels take (tests/test_torch_e2e.py's switches)."""
    from sea_tpu.ops import decode_attention as jax_decode
    from sea_tpu.ops import quant_matmul as jax_quant
    pick = jax_quant._pick_block_n
    mp.setattr(jax_quant, "kernel_supported",
               lambda M, K, N, backend=None: M <= 8 and K % 2 == 0)
    mp.setattr(jax_quant, "_pick_block_n", lambda K, N: pick(K, N) or N)
    mp.setattr(jax_quant, "_FORCE_INTERPRET", True)
    mp.setattr(jax_decode, "decode_supported", lambda *a, **k: True)
    mp.setattr(jax_decode, "_FORCE_INTERPRET", True)


def _jax_rollout(shape, cfg, tree, x0, ib, cache_dtype):
    from sea_tpu.parallel.mesh import make_mesh
    from sea_tpu.parallel.train_step import make_sharded_rollout
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the idle virtual devices
        _kernels_on(mp)
        run, placed, place = make_sharded_rollout(
            make_mesh(*shape), cfg, jax.tree.map(jnp.asarray, tree),
            cache_dtype=cache_dtype)
        return np.asarray(run(placed, *place(x0, ib)))


@pytest.fixture(scope="module")
def rollouts():
    cfg, jcfg, trees, x0, ib = _setup()
    with concurrent.futures.ThreadPoolExecutor(len(CELLS)) as pool:
        port = {name: pool.submit(
            run_ranks, R.run_grid, shape[0] * shape[1], shape,
            {"r": ("rollout", (cfg, trees[w], x0, ib, cache))})
            for name, (shape, w, cache, _, _) in CELLS.items()}
        want = {name: _jax_rollout(shape, jcfg, trees[w], x0, ib, jcache)
                for name, (shape, w, _, jcache, _) in CELLS.items()}
        return {name: (port[name].result()[0]["r"], want[name])
                for name in CELLS}


@requires_8
@pytest.mark.parametrize("name", sorted(CELLS))
def test_sharded_rollout_matches_jax(name, rollouts):
    got, want = rollouts[name]
    assert got.shape == want.shape == (4, 6, 2, 32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=CELLS[name][4])


@pytest.mark.parametrize("weights", sorted(ONE_DEVICE_BF16))
def test_one_device_bf16_cache_rollout_matches_jax(weights):
    """The scan rollout on one device with a bf16 KV cache against JAX's
    rollout_scan with its kernels on: the two round at the same points."""
    from sea_tpu.rollout.engine import rollout_scan as jax_rollout_scan
    from sea_tpu_torch.rollout.engine import rollout_scan
    cfg, jcfg, trees, x0, ib = _setup()
    with pytest.MonkeyPatch.context() as mp:
        _kernels_on(mp)
        want = np.asarray(jax.jit(lambda p, x, i: jax_rollout_scan(
            p, jcfg, x, i, cache_dtype=jnp.bfloat16))(
                jax.tree.map(jnp.asarray, trees[weights]), x0, ib))
    got = rollout_scan(from_numpy(trees[weights], "cpu"), cfg,
                       torch.from_numpy(x0), torch.from_numpy(ib),
                       cache_dtype=torch.bfloat16).numpy()
    assert got.shape == want.shape == (4, 6, 2, 32)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=ONE_DEVICE_BF16[weights])
