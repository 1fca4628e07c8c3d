"""Reduced-precision serving of the port against the JAX package, on the
CPU: ops/quant_matmul (packing, the int4 kernel's plain version, the
large-M route), utils/precision (casts, quantizers, fused projections,
teacher-forced drift) and utils/calibration.

Weights are the port's seeded init of the cylinder_flow_smoke temporal
model (E=32), handed to both packages as numpy; the quantizers run with
an explicit small ``min_size``, since every smoke matrix is below the
default 2^16. Inputs come from numpy with a fixed seed. Tolerances:
- packing, bf16 casts, int8, max-scaled int4 and the fused projections:
  bit for bit (elementwise integer and rounding ops);
- the int4 kernel's plain version against the TPU kernel in interpret
  mode: atol 1e-5 (f32 summation order over bf16-exact products);
- the large-M route against the JAX fallback: atol 5e-5, the bound of
  tests/test_quant_matmul.py;
- activation statistics: rtol 1e-5 (f32 sums in another order);
- MSE-searched and calibrated int4 scales: the 13-ratio search keeps the
  least error, and two errors that differ in the last bits of an f32 sum
  can rank the other way. The measured count of such near-tie flips is
  stated at each test; every other column is bit for bit;
- teacher-forced drift: rtol 1e-4.

The CUDA kernel runs only on the card: its test is marked ``gpu`` and
skips here (``python -m pytest tests/test_torch_quant.py --noconftest -m
gpu`` there; JAX is imported only inside the tests that need it).
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
from sea_tpu_torch.ops import quant_matmul as QM
from sea_tpu_torch.utils import precision as P
from sea_tpu_torch.utils.params import from_numpy, to_numpy

torch.set_num_threads(2)

MIN_SIZE = 64
# The calibrated quantizer compiles per weight shape in JAX: the five
# shapes of at least 1024 elements (qkv, projections, MLP, AdaLN cond).
CAL_MIN_SIZE = 1024
# Near-tie scale flips measured on these weights (port vs JAX): none of
# 1472 MSE-searched columns, none of 1088 calibrated ones. See the module
# docstring.
MSE_FLIPS_MAX = 0
CAL_FLIPS_MAX = 0


def _rand_q(rs, K, N):
    return rs.randint(-8, 8, size=(K, N)).astype(np.int8)


def test_pack_unpack_roundtrip_matches_jax():
    from sea_tpu.ops import quant_matmul as JQ
    rs = np.random.RandomState(0)
    q = _rand_q(rs, 64, 96)
    q[0, :4] = [-8, -7, 0, 7]  # the full nibble range, -8 included
    wp = QM.pack_int4(torch.from_numpy(q))
    assert wp.dtype == torch.uint8 and wp.shape == (32, 96)
    np.testing.assert_array_equal(wp.numpy(), np.asarray(JQ.pack_int4(q)))
    np.testing.assert_array_equal(
        QM.unpack_int4(wp, torch.int32).numpy(), q)
    lo, hi = QM.unpack_planes(wp, torch.float32)
    jlo, jhi = JQ.unpack_planes(np.asarray(wp.numpy()), np.float32)
    np.testing.assert_array_equal(lo.numpy(), np.asarray(jlo))
    np.testing.assert_array_equal(hi.numpy(), np.asarray(jhi))
    with pytest.raises(ValueError):
        QM.pack_int4(torch.from_numpy(q[:63]))


@pytest.mark.parametrize("M", [1, 8])
def test_matvec_ref_matches_jax_kernel(M):
    """Against the TPU kernel in interpret mode (it takes bf16 x, as the
    JAX int4_matmul hands it)."""
    import jax.numpy as jnp
    from sea_tpu.ops import quant_matmul as JQ
    K, N = 96, 256
    rs = np.random.RandomState(M)
    q = _rand_q(rs, K, N)
    s = rs.uniform(0.01, 0.1, N).astype(np.float32)
    x = rs.randn(M, K).astype(np.float32)
    wp = QM.pack_int4(torch.from_numpy(q))
    want = JQ._mv_call(jnp.asarray(x, jnp.bfloat16), wp.numpy(),
                       s.reshape(1, N), block_n=128, interpret=True)
    got = QM.int4_matvec_ref(torch.from_numpy(x), wp, torch.from_numpy(s))
    assert got.dtype == torch.float32 and got.shape == (M, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)
    # On the CPU int4_matmul is that plain version and counts no launch.
    before = QM.launches
    torch.testing.assert_close(
        QM.int4_matmul(torch.from_numpy(x), wp, torch.from_numpy(s)), got,
        rtol=0, atol=0)
    assert QM.launches == before


def test_large_m_route_matches_jax_fallback():
    """M > 8: the two-plane dequantized product, x not rounded; leading
    dims flatten and come back."""
    from sea_tpu.ops import quant_matmul as JQ
    K, N = 128, 256
    rs = np.random.RandomState(1)
    q = _rand_q(rs, K, N)
    s = rs.uniform(0.01, 0.1, N).astype(np.float32)
    x = rs.randn(2, 5, K).astype(np.float32)
    wp = QM.pack_int4(torch.from_numpy(q))
    want = JQ.int4_matmul(x, wp.numpy(), s, force="jnp")
    got = QM.int4_matmul(torch.from_numpy(x), wp, torch.from_numpy(s))
    assert got.shape == (2, 5, N)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=5e-5)


# (K, N) of every int4 linear of the multiphase rollout step
# (chip_smoke.INT4_SHAPES), beside small and ragged shapes.
ROLLOUT_INT4_SHAPES = [(2048, 6144), (2048, 2048), (2048, 1024), (1024, 1024),
                       (1024, 2048), (2048, 16384), (16384, 2048)]


@pytest.mark.parametrize("K,N", [(64, 512), (512, 1000)]
                         + ROLLOUT_INT4_SHAPES)
def test_int4_plan_covers_k(K, N):
    """The kernel's grid on an H100's 132 SMs: every packed row in exactly
    one split of the cluster, none empty, whole MMA k-steps a split; at
    most 8 blocks a cluster; one wave; shared memory within 227 KB."""
    plan = QM.int4_plan(K, N, 132)
    K2 = K // 2
    assert plan.cluster * plan.rows >= K2 > (plan.cluster - 1) * plan.rows
    assert plan.rows % QM.STEP_ROWS == 0
    assert 1 <= plan.cluster <= QM.MAX_CLUSTER
    assert plan.cols in QM.COL_TILE_WIDTHS
    assert plan.tiles * plan.cols >= N > (plan.tiles - 1) * plan.cols
    assert plan.blocks <= 132
    assert plan.smem_bytes <= QM.MAX_SMEM_BYTES


def test_int4_plan_keeps_clusters_in_their_slots():
    """A cluster runs inside one GPC, so a card may hold fewer clusters of
    8 than 132 // 8 (15 on the H100 of PERF.md): with 16 column tiles the
    plan then takes smaller clusters in one wave, not 16 clusters of 8 of
    which one would share SMs with another."""
    slots = tuple(((cols, c), 15 if c == 8 else 132 // c)
                  for cols in QM.COL_TILE_WIDTHS for c in range(1, 9))
    plan = QM.int4_plan(16384, 2048, 132, slots)
    assert QM.int4_plan(16384, 2048, 132).cluster == 8
    assert plan.cluster < 8 and plan.blocks <= 132
    assert plan.tiles <= dict(slots)[(plan.cols, plan.cluster)]
    assert plan.cluster * plan.rows >= 8192 > (plan.cluster - 1) * plan.rows


def test_kernel_wrapper_refuses_misaligned_weight():
    """The kernel reads wp as 16-byte vectors: a contiguous view at an odd
    offset is refused before any launch, not left to fault on the card."""
    K, N = 64, 32
    base = torch.zeros(K // 2 * N + 1, dtype=torch.uint8)
    wp = base[1:].view(K // 2, N)
    assert wp.is_contiguous() and wp.data_ptr() % 16
    with pytest.raises(ValueError, match="16-byte"):
        QM.int4_matvec(torch.zeros(1, K), wp, torch.ones(N))


# ---------------------------------------------------------------------------
# utils/precision and utils/calibration
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _params_np():
    from sea_tpu_torch.models.temporal import init_temporal
    cfg = get_case().temporal
    return to_numpy(init_temporal(cfg, torch.Generator().manual_seed(5),
                                  device="cpu"))


def _windows(n=3, T=12, seed=0):
    cfg = get_case().temporal
    rs = np.random.RandomState(seed)
    src = rs.randn(n, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = (rs.rand(n, T, cfg.ib_num) + 0.5).astype(np.float32)
    return src, ib


def _flat(tree):
    from sea_tpu.utils.checkpoint import _flatten
    return _flatten(tree)


def _np(tree):
    """The port's tree as numpy; bf16 leaves as their int16 bits."""
    from sea_tpu_torch.utils.params import tree_map
    return tree_map(lambda t: (t.view(torch.int16) if t.dtype ==
                               torch.bfloat16 else t).numpy(), tree)


def _jnp(tree):
    """The JAX tree as numpy; bf16 leaves as their int16 bits."""
    import jax
    import jax.numpy as jnp
    return jax.tree.map(lambda a: np.asarray(
        a.view(jnp.int16) if a.dtype == jnp.bfloat16 else a), tree)


def _assert_trees_equal(got, want):
    g = _flat(_np(got))
    w = _flat(_jnp(want))
    assert sorted(g) == sorted(w)
    for key in w:
        assert g[key].dtype == w[key].dtype, key
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)


@functools.lru_cache(maxsize=None)
def _both(fn_name, scale=None):
    """(port result, JAX result) of utils.precision.<fn_name> on the
    fused smoke params (cached: the JAX quantizers run eagerly, slowly)."""
    from sea_tpu.utils import precision as JP
    fused = P.fuse_attention_projections(from_numpy(_params_np(), "cpu"))
    jfused = JP.fuse_attention_projections(_params_np())
    kw = {"min_size": MIN_SIZE, **({"scale": scale} if scale else {})}
    return (getattr(P, fn_name)(fused, **kw),
            getattr(JP, fn_name)(jfused, **kw))


def test_fuse_attention_projections_matches_jax():
    from sea_tpu.utils import precision as JP
    got = P.fuse_attention_projections(from_numpy(_params_np(), "cpu"))
    _assert_trees_equal(got, JP.fuse_attention_projections(_params_np()))
    assert "qkv" in got["blocks"][0]["self_attn"][0]
    assert "kv" in got["blocks"][0]["cross_attn"][0][1]


@pytest.mark.parametrize("fn_name,scale", [
    ("cast_weights_bf16", None), ("quantize_weights_int8", None),
    ("quantize_weights_int4", "max")])
def test_elementwise_transforms_match_jax_bit_for_bit(fn_name, scale):
    got, want = _both(fn_name, scale)
    _assert_trees_equal(got, want)
    leaves = _flat(_np(got))
    layout = {"cast_weights_bf16": "w", "quantize_weights_int8": "w_q",
              "quantize_weights_int4": "w_p4"}[fn_name]
    assert any(k.endswith("qkv/" + layout) for k in leaves)


def _scale_flips(got, want):
    """Columns whose int4 scale differs, and the total quantized; packed
    nibbles must agree wherever the scale does."""
    import jax
    g = _flat(to_numpy(got))
    w = _flat(jax.tree.map(np.asarray, want))
    assert sorted(g) == sorted(w)
    flips = cols = 0
    for key in w:
        if not key.endswith("w_s"):
            continue
        same = g[key] == w[key]
        flips += int((~same).sum())
        cols += same.size
        packed = key[:-3] + "w_p4"
        np.testing.assert_array_equal(g[packed][:, same], w[packed][:, same],
                                      err_msg=packed)
    return flips, cols


def test_int4_mse_scales_match_jax_up_to_near_ties():
    got, want = _both("quantize_weights_int4")
    flips, cols = _scale_flips(got, want)
    assert cols > 500
    assert flips <= MSE_FLIPS_MAX, (flips, cols)


def test_calibration_and_calibrated_int4_match_jax():
    """Activation stats from calibrate_temporal (rtol 1e-5); then int4 with
    those stats and bias correction, each side on its own stats."""
    from sea_tpu.utils import calibration as JC
    from sea_tpu.utils import precision as JP
    from sea_tpu_torch.utils.calibration import calibrate_temporal
    cfg = get_case().temporal
    src, ib = _windows()
    fused = P.fuse_attention_projections(from_numpy(_params_np(), "cpu"))
    jfused = JP.fuse_attention_projections(_params_np())
    stats = calibrate_temporal(fused, cfg, [(src, ib)])
    jstats = JC.calibrate_temporal(jfused, cfg, [(src, ib)])
    assert sorted(stats) == sorted(jstats) and len(stats) >= 10
    for path, want in jstats.items():
        # The JAX package runs the ib MLP once per field on the same ib,
        # the port once per block: same moments, 1/G of the count.
        per_field = cfg.num_fields if path[2] == "ib" else 1
        assert stats[path]["count"] * per_field == want["count"], path
        for name in ("mean", "sq"):
            np.testing.assert_allclose(stats[path][name].numpy(),
                                       np.asarray(want[name]), rtol=1e-5,
                                       atol=1e-7, err_msg=str(path))
    got = P.quantize_weights_int4(fused, min_size=CAL_MIN_SIZE,
                                  act_stats=stats)
    want = JP.quantize_weights_int4(jfused, min_size=CAL_MIN_SIZE,
                                    act_stats=jstats)
    flips, cols = _scale_flips(got, want)
    assert flips <= CAL_FLIPS_MAX, (flips, cols)
    # Bias correction created the bias the attention projection lacked.
    assert "b" in got["blocks"][0]["self_attn"][0]["proj"]


def test_teacher_forced_drift_matches_jax():
    from sea_tpu.utils import precision as JP
    cfg = dataclasses.replace(get_case().temporal)
    src, ib = _windows(n=2)
    got_q, want_q = _both("quantize_weights_int8")
    got = P.teacher_forced_drift(from_numpy(_params_np(), "cpu"), got_q, cfg,
                                 src, ib)
    want = JP.teacher_forced_drift(_params_np(), want_q, cfg, src, ib)
    assert 0 < got < 0.1
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 3, 8])
@pytest.mark.parametrize("K,N", [(2048, 6144), (16384, 2048), (1024, 1024),
                                 (64, 200), (2000, 200), (2002, 208),
                                 (4098, 4000), (4098, 4004), (2056, 4000)])
def test_cuda_kernel_matches_ref(M, K, N):
    """Runs on the card only (no CUDA here): the kernel against its plain
    version (f32 summation order), at a shape of the multiphase rollout,
    the K-split down-projection, a small one, and ragged ones: K/2 not a
    multiple of the 128-row stage or of the 8-row k-step, N not a multiple
    of the column tile (64 or 128); in the byte-wise form (N not a
    multiple of 16 or K/2 not one of 4) and in the 16-byte one
    (2056, 4000)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    g = torch.Generator(device="cuda").manual_seed(K + N + M)
    q = torch.randint(-8, 8, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    wp = QM.pack_int4(q)
    s = torch.rand(N, device="cuda", generator=g) * 0.1 + 0.01
    x = torch.randn(M, K, device="cuda", generator=g)
    before = QM.launches
    got = QM.int4_matmul(x, wp, s)
    assert QM.launches == before + 1
    want = QM.int4_matvec_ref(x, wp, s)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-3 * (K / 1024))
