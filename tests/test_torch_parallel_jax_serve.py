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
(tests/test_torch_temporal.py); int4 with an int8 cache atol 5e-3, the
bf16-cache rollout's there. int4 with a bf16 cache: 2^-7 of the largest
|value|. There the int4 kernel's bf16 rounding of its input turns the
bf16 cache's own gap (the port and the kernels round p and q at their
own points: ~2e-4, as with f32 weights) into whole bf16 ulps of the
projections' inputs: the port's ONE-device rollout is 2.6e-2 from JAX's
at step 5 (values up to 7.3), 1.6e-4 to 2.4e-4 with that rounding off on
both sides, while the JAX sharded rollouts equal JAX's one-device one bit
for bit and the port's equal the port's within 2e-4
(tests/test_torch_parallel.py).
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
                           None),  # 2^-7 x max|value|: the note above
}


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


def _jax_rollout(shape, cfg, tree, x0, ib, cache_dtype):
    from sea_tpu.ops import decode_attention as jax_decode
    from sea_tpu.ops import quant_matmul as jax_quant
    from sea_tpu.parallel.mesh import make_mesh
    from sea_tpu.parallel.train_step import make_sharded_rollout
    pick = jax_quant._pick_block_n
    with pytest.MonkeyPatch.context() as mp, warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the idle virtual devices
        mp.setattr(jax_quant, "kernel_supported",
                   lambda M, K, N, backend=None: M <= 8 and K % 2 == 0)
        mp.setattr(jax_quant, "_pick_block_n",
                   lambda K, N: pick(K, N) or N)
        mp.setattr(jax_quant, "_FORCE_INTERPRET", True)
        mp.setattr(jax_decode, "decode_supported", lambda *a, **k: True)
        mp.setattr(jax_decode, "_FORCE_INTERPRET", True)
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
    atol = CELLS[name][4]
    if atol is None:
        atol = 2.0 ** -7 * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)
