"""Port parity: the prefix engine, the engine dispatch, the ib-addition
modes and generation of sea_tpu_torch against the JAX package, on the
CPU.

Configs are the cylinder_flow_smoke temporal preset (E=32, 2 heads, G=2)
cut further with dataclasses.replace, dropout off; weights are
JAX-initialised and handed over through jax.tree.map(np.asarray, .) and
from_numpy; inputs come from numpy with a fixed seed.

Tolerances: 1e-5 for one forward or one step (f32, summation order);
2e-5 for a prefix-engine rollout against the JAX prefix engines, the
bound tests/test_rollout.py holds the JAX masked engine to (both run the
same forwards); 2e-4 for anything downstream of a scan rollout (the
bound of tests/test_rollout.py, errors feeding back through the loop).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.configs.cylinder_flow_smoke import get_case as smoke_case
from sea_tpu.data.mesh import MeshProcessor
from sea_tpu.data.synthetic import cylinder_like
from sea_tpu.models import temporal as JT
from sea_tpu.rollout import engine as JE
from sea_tpu_torch.models import temporal as TT
from sea_tpu_torch.models.spatial import init_spatial
from sea_tpu_torch.rollout import engine as TE
from sea_tpu_torch.utils.params import from_numpy, to_numpy

torch.set_num_threads(2)

STEP_ATOL = 1e-5
PREFIX_ATOL = 2e-5
ROLLOUT_ATOL = 2e-4

VARIANTS = {
    # the cylinder block (AdaLN, ib added after the exchange), causal
    "adaln": dict(),
    # the non-causal configs only the masked prefix engine serves
    "src_len2": dict(src_len=2),
    "ib_attention": dict(ib_addition_mode="attention"),
    # the other ib injections; concat widens the stream by 64 and needs
    # the ib added before the exchange
    "concat": dict(ib_addition_mode="concat", add_info_after_cross=False),
    "none": dict(ib_addition_mode="none", ln_type="ln"),
}


def _cfg(name):
    return dataclasses.replace(smoke_case().temporal, dropout=0.0,
                               **VARIANTS[name])


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return JT.init_temporal(jax.random.PRNGKey(7), _cfg(name))


def _port_params(name):
    return from_numpy(jax.tree.map(np.asarray, _jax_params(name)), "cpu")


def _inputs(cfg, B, T, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = rs.randn(B, T, cfg.ib_num).astype(np.float32)
    return x, ib


@pytest.mark.parametrize("bucket", [4, 64])
def test_prefix_bucketed_matches_jax(bucket):
    """The causal chunk (unmasked) against the JAX bucketed engine, with
    chunks that end at bucket edges (bucket 4, T=10) and one chunk."""
    cfg = _cfg("adaln")
    x, ib = _inputs(cfg, B=2, T=10, seed=1)
    want = JE.rollout_prefix_bucketed(_jax_params("adaln"), cfg,
                                      jnp.asarray(x[:, 0]), jnp.asarray(ib),
                                      bucket=bucket)
    got = TE.rollout_prefix_bucketed(_port_params("adaln"), cfg,
                                     torch.from_numpy(x[:, 0]),
                                     torch.from_numpy(ib), bucket=bucket)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=PREFIX_ATOL)


@pytest.mark.parametrize("name", ["src_len2", "ib_attention"])
def test_masked_prefix_matches_jax_recompute(name):
    """The non-causal configs: the port's dispatch sends them to the
    masked prefix engine, which must equal the JAX reference oracle (a
    forward on the growing prefix) at the default bucket and across the
    edges of bucket 4 (T=9: chunks of 4, 8 and 9)."""
    cfg = _cfg(name)
    x, ib = _inputs(cfg, B=2, T=9, seed=2)
    # One jitted program of the oracle's T forwards: eager, each op would
    # compile once per prefix length.
    want = np.asarray(jax.jit(functools.partial(
        JE.rollout_prefix_recompute, cfg=cfg))(
            _jax_params(name), x0=jnp.asarray(x[:, 0]), ib=jnp.asarray(ib)))
    params = _port_params(name)
    x0, ibt = torch.from_numpy(x[:, 0]), torch.from_numpy(ib)
    assert TE.select_engine(cfg, 2, 9, params) == "prefix"
    got = TE.rollout(params, cfg, x0, ibt)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PREFIX_ATOL)
    got4 = TE.rollout_prefix_bucketed(params, cfg, x0, ibt, bucket=4)
    np.testing.assert_allclose(got4.numpy(), want, rtol=0, atol=PREFIX_ATOL)


def test_masked_forward_matches_jax_valid_len():
    """temporal_forward with valid_len against the JAX one over the whole
    length, garbage rows included: the port cuts the keys to the prefix,
    JAX masks them, and the two admit the same keys to every row."""
    cfg = _cfg("ib_attention")
    x, ib = _inputs(cfg, B=2, T=8, seed=3)
    want = JT.temporal_forward(_jax_params("ib_attention"), cfg,
                               jnp.asarray(x), jnp.asarray(ib), valid_len=5)
    got = TT.temporal_forward(_port_params("ib_attention"), cfg,
                              torch.from_numpy(x), torch.from_numpy(ib),
                              valid_len=5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=STEP_ATOL)


def test_valid_len_refuses_dropout_and_gradients():
    from sea_tpu_torch.ops.attention import multihead_core
    from sea_tpu_torch.utils.prng import prng_key
    q = torch.randn(1, 4, 8)
    with pytest.raises(ValueError, match="no dropout, no gradient"):
        multihead_core(q, q, q, n_heads=2, causal=True, rope=True,
                       dropout_rate=0.1, dropout_key=prng_key(0),
                       deterministic=False, valid_len=2)
    with pytest.raises(ValueError, match="no dropout, no gradient"):
        multihead_core(q.requires_grad_(True), q, q, n_heads=2, causal=True,
                       rope=True, valid_len=2)


@pytest.mark.parametrize("name", ["concat", "none"])
def test_ib_modes_forward_and_step_match_jax(name):
    """concat and none: the forward against JAX's, each teacher-forced
    step against JAX's step and against the port's own forward (step ==
    forward), and the scan rollout with its hoisted cond tables against
    the port's prefix engine."""
    cfg = _cfg(name)
    B, T = 2, 5
    x, ib = _inputs(cfg, B, T, seed=4)
    jparams, params = _jax_params(name), _port_params(name)
    want = JT.temporal_forward(jparams, cfg, jnp.asarray(x), jnp.asarray(ib))
    full = TT.temporal_forward(params, cfg, torch.from_numpy(x),
                               torch.from_numpy(ib))
    np.testing.assert_allclose(full.numpy(), np.asarray(want), rtol=0,
                               atol=STEP_ATOL)
    jstep = jax.jit(functools.partial(JT.temporal_step, cfg=cfg))
    jcache = JT.init_temporal_cache(cfg, B, T)
    cache = TT.init_temporal_cache(cfg, B, T, device="cpu")
    for t in range(T):
        want_t, jcache = jstep(jparams, x_t=x[:, t], ib_t=ib[:, t],
                               cache=jcache, t=jnp.int32(t))
        got_t = TT.temporal_step(params, cfg, torch.from_numpy(x[:, t]),
                                 torch.from_numpy(ib[:, t]), cache,
                                 torch.tensor([t], dtype=torch.int32))
        np.testing.assert_allclose(got_t.numpy(), np.asarray(want_t),
                                   rtol=0, atol=STEP_ATOL, err_msg=f"t={t}")
        torch.testing.assert_close(got_t, full[:, t], rtol=0,
                                   atol=ROLLOUT_ATOL)
    x0, ibt = torch.from_numpy(x[:, 0]), torch.from_numpy(ib)
    torch.testing.assert_close(
        TE.rollout_scan(params, cfg, x0, ibt),
        TE.rollout_prefix_bucketed(params, cfg, x0, ibt), rtol=0,
        atol=ROLLOUT_ATOL)


def test_fused_projections_serve_ib_attention():
    """fuse_attention_projections gives cross_attn_ib a fused "kv"; the
    masked prefix engine serves it as the unfused params."""
    from sea_tpu_torch.utils.precision import fuse_attention_projections
    cfg = _cfg("ib_attention")
    params = _port_params("ib_attention")
    fused = fuse_attention_projections(params)
    assert "kv" in fused["blocks"][0]["cross_attn_ib"][0]
    x, ib = map(torch.from_numpy, _inputs(cfg, B=1, T=6, seed=5))
    torch.testing.assert_close(TE.rollout(fused, cfg, x[:, 0], ib),
                               TE.rollout(params, cfg, x[:, 0], ib),
                               rtol=0, atol=STEP_ATOL)


def test_select_engine_policy_at_the_port_constants():
    """One assertion per rule of select_engine, at the port's constants
    (measured on an H100, PERF.md): non-incremental -> prefix at any
    batch; incremental f32 -> prefix only within PREFIX_MAX_BATCH and
    PREFIX_MAX_T; reduced-precision weights -> scan; engine='scan'
    refuses a non-incremental config."""
    from sea_tpu_torch.utils.precision import (cast_weights_bf16,
                                               quantize_weights_int8)
    assert (TE.PREFIX_MAX_BATCH, TE.PREFIX_MAX_T) == (0, 512)
    cfg, params = _cfg("adaln"), _port_params("adaln")
    assert TE.weights_f32(params)
    for name in ("src_len2", "ib_attention"):
        assert TE.select_engine(_cfg(name), 8, 4096, params) == "prefix"
    assert TE.select_engine(cfg, 1, 250, params) == "scan"
    assert TE.select_engine(cfg, 1, 1, params) == "scan"
    assert TE.select_engine(cfg, 2, 250, params) == "scan"
    bf16 = cast_weights_bf16(params, min_size=1)
    int8 = quantize_weights_int8(params, min_size=1)
    assert not TE.weights_f32(bf16) and not TE.weights_f32(int8)
    assert TE.select_engine(cfg, 1, 250, bf16) == "scan"
    assert TE.select_engine(cfg, 1, 250, int8) == "scan"
    x0 = torch.zeros(1, cfg.num_fields, cfg.embed_dim)
    ib = torch.zeros(1, 4, cfg.ib_num)
    with pytest.raises(ValueError, match="scan-incremental"):
        TE.rollout(params, _cfg("src_len2"), x0, ib, engine="scan")
    with pytest.raises(ValueError, match="scan-incremental"):
        TE.rollout_scan(params, _cfg("ib_attention"), x0, ib)
    with pytest.raises(ValueError, match="unknown engine"):
        TE.rollout(params, cfg, x0, ib, engine="prefix_recompute")


def _spatial_side(tmp_path, **temporal):
    """The cylinder_flow_smoke case (dropout off, ``temporal`` changes),
    a min-max-scaled partition of 120 synthetic nodes (JAX MeshProcessor,
    which the port's functions take as it is), seeded stage-1 and JAX
    temporal weights as numpy, and 2 windows of 6 steps with their
    fields."""
    case = smoke_case()
    case = case.replace(
        temporal=dataclasses.replace(case.temporal, dropout=0.0, **temporal),
        run=dataclasses.replace(case.run, save_dir=str(tmp_path)))
    mesh = dataclasses.replace(case.mesh, scale_feature_range=(-1.0, 1.0))
    fields, coords, ib = cylinder_like(tr=2, T=9, n_nodes=120, seed=3)
    mp = MeshProcessor(mesh, case.spatial.field_groups, coords,
                       save_dir=str(tmp_path))
    mp.patchify_and_scale(fields.reshape(-1, *fields.shape[2:]))
    scfg = case.spatial.with_n_inp(mp.cells_per_patch)
    sparams = to_numpy(init_spatial(scfg, torch.Generator().manual_seed(1),
                                    device="cpu"))
    tparams = jax.tree.map(np.asarray, JT.init_temporal(
        jax.random.PRNGKey(2), case.temporal))
    tcfg = case.temporal
    rs = np.random.RandomState(6)
    W, shape = 6, (2, 6, tcfg.num_fields, tcfg.embed_dim)
    windows = types.SimpleNamespace(
        src=rs.randn(*shape).astype(np.float32),
        tgt=rs.randn(*shape).astype(np.float32),
        tgt_original=fields[:, 1:W + 1], ib=ib[:, :W])
    jax_svc = types.SimpleNamespace(cfg=scfg, params=sparams)
    port_svc = types.SimpleNamespace(cfg=scfg,
                                     params=from_numpy(sparams, "cpu"),
                                     device=torch.device("cpu"))
    return case, mp, tparams, windows, jax_svc, port_svc


def test_generate_trajectory_matches_jax(tmp_path):
    """generate_trajectory at a horizon past the window (ib held at its
    last value) on the cylinder_flow_smoke spatial side, against the JAX
    function from the same weights, windows and partition."""
    from sea_tpu.train.evaluate import generate_trajectory as jax_generate
    from sea_tpu_torch.train.evaluate import generate_trajectory
    case, mp, tparams, windows, jax_svc, port_svc = _spatial_side(tmp_path)
    kw = dict(trajectory=1, horizon=10)
    want = jax_generate(tparams, case, windows, jax_svc, mp, **kw)
    got = generate_trajectory(from_numpy(tparams, "cpu"), case, windows,
                              port_svc, mp, **kw)
    assert got.shape == (10, mp.partition.num_nodes, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0,
                               atol=ROLLOUT_ATOL)
    with pytest.raises(ValueError, match="out of range"):
        generate_trajectory(from_numpy(tparams, "cpu"), case, windows,
                            None, mp, trajectory=2)


def test_evaluation_serves_ib_attention_as_jax(tmp_path):
    """fused_autoregressive_evaluation (the CLI's and the training loop's
    rollout evaluation) on an ib-attention, src_len=1 config: both
    packages dispatch it to the masked prefix engine and decode and score
    the same; generation refuses it, as in the JAX package."""
    from sea_tpu.train.evaluate import \
        fused_autoregressive_evaluation as jax_eval
    from sea_tpu_torch.train.evaluate import (fused_autoregressive_evaluation,
                                              generate_trajectory)
    case, mp, tparams, windows, jax_svc, port_svc = _spatial_side(
        tmp_path, ib_addition_mode="attention", src_len=1)
    want = jax_eval(tparams, case, windows, jax_svc, mp, plot_traj=False,
                    save_artifacts=False)
    got = fused_autoregressive_evaluation(from_numpy(tparams, "cpu"), case,
                                          windows, port_svc, mp,
                                          save_artifacts=False)
    assert got["engine"] == "prefix"
    for key in ("encoded_rel_mse", "decoded_rel_mse"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
    np.testing.assert_allclose(got["decoded_rel_mse_per_time"],
                               want["decoded_rel_mse_per_time"], rtol=1e-4)
    with pytest.raises(ValueError, match="scan-incremental"):
        generate_trajectory(from_numpy(tparams, "cpu"), case, windows,
                            port_svc, mp)
