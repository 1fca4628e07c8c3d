"""The port's exchange modes, ib scalings, remat, optimizers and time
shifting against the JAX package on the CPU.

Configs are the cylinder_flow_smoke temporal preset (E=32, 2 heads, G=2)
cut or varied with dataclasses.replace; weights are JAX-initialised and
handed over through jax.tree.map(np.asarray, .) and from_numpy; inputs
come from numpy with a fixed seed. Tolerances are those of
tests/test_torch_temporal.py and tests/test_torch_train.py for the sea
mode: 1e-5 for one forward or one step (f32, summation order), 2e-4 for
a 12-step rollout (the steps' errors compound); for a dropout train
step the loss to 1e-5 and each gradient to rtol 1e-4 with atol 1e-7 x
the gradient norm; the optimizers' parameters to 1e-6 (f32
ulps of values up to ~4) and their statistics to rtol 1e-5 over three
steps. Within the port, remat's gradients equal the plain step's bit for
bit: the recomputation runs the same ops on the same inputs.
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
from sea_tpu_torch.train import metrics as TM
from sea_tpu_torch.train import optim as TO
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.params import (from_numpy, opt_state_from_numpy,
                                        opt_state_template, to_numpy,
                                        tree_leaves, tree_map)

torch.set_num_threads(2)

STEP_ATOL = 1e-5
ROLLOUT_ATOL = 2e-4
GRAD_RTOL = 1e-4
OPT_ATOL = 1e-6
OPT_RTOL = 1e-5

MODES = {
    "pool_mlp": dict(exchange_mode="pool"),
    "pool_linear_ln": dict(exchange_mode="pool", pool_update_method="linear",
                           ln_type="ln"),
    "pool_pooling": dict(exchange_mode="pool",
                         pool_update_method="pooling"),
    "addition": dict(exchange_mode="addition"),
    "addition_ln": dict(exchange_mode="addition", ln_type="ln",
                        add_info_after_cross=False),
    "simple": dict(exchange_mode="simple"),
    "simple_ln": dict(exchange_mode="simple", ln_type="ln"),
    "fourier": dict(ib_scale_mode="fourier"),
    "fourier_ln": dict(ib_scale_mode="fourier", ln_type="ln",
                       add_info_after_cross=False),
    "linear": dict(ib_scale_mode="linear"),
    "linear_ln": dict(ib_scale_mode="linear", ln_type="ln"),
}
STEP_MODES = ("pool_mlp", "pool_pooling", "addition", "simple_ln")


def _cfg(name, **extra):
    return dataclasses.replace(get_case().temporal, **MODES[name], **extra)


@functools.lru_cache(maxsize=None)
def _jax_params(name):
    return jax.tree.map(np.asarray,
                        JT.init_temporal(jax.random.PRNGKey(0), _cfg(name)))


def _inputs(cfg, B, T, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    ib = rs.randn(B, T, cfg.ib_num).astype(np.float32)
    return x, ib


@pytest.mark.parametrize("name", sorted(MODES))
def test_init_and_forward_match_jax(name):
    """The port's own init has JAX's tree (keys, shapes, dtypes, constant
    leaves); from JAX's weights the forward equals JAX's."""
    cfg = _cfg(name)
    want = _flatten(_jax_params(name))
    got = _flatten(to_numpy(TT.init_temporal(
        cfg, torch.Generator().manual_seed(0), device="cpu")))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert (got[key].shape, got[key].dtype) == (w.shape, w.dtype), key
        if np.all(w == w.flat[0]):
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        elif key.endswith("pool_pe"):  # sin/cos: f32 ulps apart
            np.testing.assert_allclose(got[key], w, rtol=0, atol=1e-6,
                                       err_msg=key)
    x, ib = _inputs(cfg, B=2, T=6)
    ref = JT.temporal_forward(_jax_params(name), cfg, jnp.asarray(x),
                              jnp.asarray(ib))
    out = TT.temporal_forward(from_numpy(_jax_params(name), "cpu"), cfg,
                              torch.from_numpy(x), torch.from_numpy(ib))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=STEP_ATOL)


@pytest.mark.parametrize("name", STEP_MODES)
def test_step_equals_forward(name):
    """temporal_step at t, over 6 steps with its caches (pool: one per
    field) and the cond tables of precompute_cond_tables where the config
    is AdaLN, against JAX's temporal_step with JAX's caches on the same
    inputs, and against the port's own temporal_forward(x[:, :t+1])[:, t]."""
    cfg = _cfg(name)
    B, T = 2, 6
    x_np, ib_np = _inputs(cfg, B, T, seed=2)
    x, ib = torch.from_numpy(x_np), torch.from_numpy(ib_np)
    params = from_numpy(_jax_params(name), "cpu")
    full = TT.temporal_forward(params, cfg, x, ib)
    cache = TT.init_temporal_cache(cfg, B, T, device="cpu")
    jcache = JT.init_temporal_cache(cfg, B, T)
    for caches in (cache, jcache):
        assert ("pool" in caches[0]) == (cfg.exchange_mode == "pool")
        assert "cross" not in caches[0]
    jstep = jax.jit(functools.partial(JT.temporal_step, cfg=cfg))
    tables = (TT.precompute_cond_tables(params, cfg, ib)
              if cfg.ln_type == "adaln" else None)
    for t in range(T):
        want, jcache = jstep(_jax_params(name), x_t=x_np[:, t],
                             ib_t=ib_np[:, t], cache=jcache, t=jnp.int32(t))
        cond_t = (None if tables is None else
                  tree_map(lambda a: a[t], tables))
        y = TT.temporal_step(params, cfg, x[:, t], ib[:, t], cache,
                             torch.tensor([t], dtype=torch.int32),
                             cond_t=cond_t)
        np.testing.assert_allclose(y.numpy(), np.asarray(want), rtol=0,
                                   atol=STEP_ATOL, err_msg=f"t={t}")
        torch.testing.assert_close(y, full[:, t], rtol=0, atol=STEP_ATOL)


@pytest.mark.parametrize("name", ["pool_mlp", "simple"])
def test_rollout_scan_matches_jax(name):
    """The port's scan engine (its per-field pool caches; simple's AdaLN
    cond tables, which have no ln_cross) against JAX's rollout_jit over 12
    autoregressive steps, at tests/test_torch_temporal.py's rollout
    tolerance."""
    cfg = _cfg(name)
    x, ib = _inputs(cfg, B=2, T=12, seed=3)
    want = rollout_jit(_jax_params(name), cfg, x[:, 0], ib)
    got = rollout_scan(from_numpy(_jax_params(name), "cpu"), cfg,
                       torch.from_numpy(x[:, 0]), torch.from_numpy(ib))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ROLLOUT_ATOL)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's flash and fused AdaLN kernels in interpret mode,
    dispatched at every T, so both sides draw the same (bh, q, k)
    attention-dropout masks. As on a TPU, an attention with dropout on and
    no key (the pool exchange's) takes the XLA path, which then drops
    nothing."""
    from sea_tpu.ops import flash_attention as jfa
    from sea_tpu.ops import fused_adaln as jfal
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jfal, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(
        jfa, "flash_supported",
        lambda q, k, *, causal, dropout_rate, deterministic,
        has_dropout_key=False: (has_dropout_key or deterministic
                                or dropout_rate == 0.0))


def _jax_loss_grads(params, cfg, x, tgt, ib, seed):
    from sea_tpu.train import metrics as JM

    def loss(p):
        out = JT.temporal_forward(p, cfg, jnp.asarray(x), jnp.asarray(ib),
                                  rng=jax.random.fold_in(
                                      jax.random.PRNGKey(seed), 2),
                                  deterministic=False)
        return JM.mse(out, jnp.asarray(tgt))
    value, grads = jax.jit(jax.value_and_grad(loss))(
        jax.tree.map(jnp.asarray, params))
    return float(value), _flatten(jax.tree.map(np.asarray, grads))


def _port_loss_grads(params, cfg, x, tgt, ib, seed):
    """The train step's loss and gradients (make_train_step's autograd:
    a leaf the forward never reads, or reads detached, gets zeros)."""
    tparams = from_numpy(params, "cpu")
    leaves = tree_leaves(tparams)
    for leaf in leaves:
        leaf.requires_grad_(True)
    out = TT.temporal_forward(tparams, cfg, torch.from_numpy(x),
                              torch.from_numpy(ib),
                              rng=prng.fold_in(prng.prng_key(seed), 2),
                              deterministic=False)
    loss = TM.mse(out.float(), torch.from_numpy(tgt))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g
             for p, g in zip(leaves, grads)]
    it = iter(grads)
    tree = jax.tree.map(lambda _: next(it).numpy(), tparams,
                        is_leaf=lambda a: isinstance(a, torch.Tensor))
    return float(loss.detach()), _flatten(tree)


def _assert_grads_close(got, want):
    scale = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2)
                              for g in want.values())))
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        np.testing.assert_allclose(got[key], w, rtol=GRAD_RTOL,
                                   atol=1e-7 * scale, err_msg=key)


def _batch(cfg, B=2, T=12, seed=1):
    x, ib = _inputs(cfg, B, T, seed)
    tgt = np.random.RandomState(seed + 100).randn(*x.shape).astype(
        np.float32)
    return x, tgt, ib


@pytest.mark.parametrize("name", ["pool_mlp", "fourier"])
def test_dropout_train_step_matches_jax(name, jax_kernels):
    """The dropout loss and every gradient of one train step against
    jax.value_and_grad: pool_pe is a trained leaf in both (its gradient is
    not zero), the Fourier W takes none (stop_gradient, detach)."""
    cfg = _cfg(name)
    params = _jax_params(name)
    batch = _batch(cfg)
    want_loss, want = _jax_loss_grads(params, cfg, *batch, seed=5)
    got_loss, got = _port_loss_grads(params, cfg, *batch, seed=5)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=STEP_ATOL)
    _assert_grads_close(got, want)
    if name == "pool_mlp":
        assert np.abs(got["blocks/0/pool_pe"]).max() > 0
        assert not got["blocks/0/pool_pe"][12:].any()  # rows past T
    else:
        assert not got["blocks/0/ib/W"].any()


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_grads(remat):
    """Two sea blocks, each checkpointed: with dropout, the port's loss and
    gradients under remat equal its plain step's bit for bit (the
    recomputation draws the same masks); without it, they equal JAX's
    jax.checkpoint step's within the tolerances (JAX's XLA attention
    there: its dropout masks are the kernels' only under the interpret
    fixture, which the dropout train step tests use)."""
    base = dataclasses.replace(get_case().temporal, num_layers=2)
    params = jax.tree.map(np.asarray,
                          JT.init_temporal(jax.random.PRNGKey(0), base))
    batch = _batch(base, seed=3)
    plain_loss, plain = _port_loss_grads(params, base, *batch, seed=7)
    cfg = dataclasses.replace(base, remat=remat)
    got_loss, got = _port_loss_grads(params, cfg, *batch, seed=7)
    assert got_loss == plain_loss
    for key in plain:
        np.testing.assert_array_equal(got[key], plain[key], err_msg=key)
    cfg = dataclasses.replace(cfg, dropout=0.0)
    want_loss, want = _jax_loss_grads(params, cfg, *batch, seed=7)
    got_loss, got = _port_loss_grads(params, cfg, *batch, seed=7)
    np.testing.assert_allclose(got_loss, want_loss, rtol=0, atol=STEP_ATOL)
    _assert_grads_close(got, want)


def test_remat_recomputes_each_block(monkeypatch):
    """Under remat the backward runs each block's forward again (and only
    the blocks'): the flash attention's forward is called twice a step
    for every attention of every block; without remat, once."""
    from sea_tpu_torch.ops import attention as TA
    calls = []
    real = TA.flash_attention

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(TA, "flash_attention", counted)
    base = dataclasses.replace(get_case().temporal, num_layers=2)
    params = jax.tree.map(np.asarray,
                          JT.init_temporal(jax.random.PRNGKey(0), base))
    batch = _batch(base, seed=3)
    per_forward = base.num_layers * base.num_fields ** 2
    for remat, want in ((False, 1), (True, 2), ("full", 2), ("dots", 2)):
        calls.clear()
        _port_loss_grads(params, dataclasses.replace(base, remat=remat),
                         *batch, seed=7)
        assert len(calls) == want * per_forward, remat


# ---------------------------------------------------------------------------
# Optimizers
# ---------------------------------------------------------------------------

OPT_RECIPES = {
    "adafactor": dict(optimizer="adafactor"),
    "adafactor_linear_wd": dict(optimizer="adafactor", scheduler="linear",
                                epoch_num=2, weight_decay=0.1),
    "adamw_linear": dict(scheduler="linear", epoch_num=4),
    "adafactor_shadow": dict(optimizer="adafactor",
                             compute_dtype="bfloat16_shadow"),
    "adamw_linear_shadow": dict(scheduler="linear", epoch_num=4,
                                compute_dtype="bfloat16_shadow"),
}


def _opt_tree():
    """Factored leaves (both dims >= 128, equal dims, a 3-D stack) and
    unfactored ones (a vector, a matrix with a dim under 128)."""
    rs = np.random.RandomState(0)
    return {"a": rs.randn(256, 130).astype(np.float32),
            "b": [rs.randn(5).astype(np.float32)],
            "c": (0.1 * rs.randn(3, 140, 128)).astype(np.float32),
            "d": rs.randn(128, 128).astype(np.float32),
            "e": rs.randn(300, 7).astype(np.float32)}


def _assert_states_close(got, want):
    got, want = _flatten(got), _flatten(want)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        assert got[key].shape == w.shape, key
        np.testing.assert_allclose(got[key], w, rtol=OPT_RTOL,
                                   atol=OPT_RTOL * np.abs(w).max(),
                                   err_msg=key)


@pytest.mark.parametrize("recipe", sorted(OPT_RECIPES))
def test_optimizer_matches_optax(recipe, tmp_path):
    """Three updates of make_optimizer's adafactor or linear-schedule AdamW
    (alone or under the bf16 shadow) against the JAX package's optax
    chain on the same gradients: the parameters and every statistic after
    each; then each side's state written as an npz checkpoint and read by
    the other (JAX's load_full_checkpoint with tx.init as the template;
    the port's opt_state_template), a fourth update from the crossed
    states equal again."""
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.utils import checkpoint as JC
    from sea_tpu_torch.configs.cylinder_flow import get_case as port_case
    from sea_tpu_torch.utils import checkpoint as TC
    tcfg = dataclasses.replace(port_case().temporal_train,
                               **OPT_RECIPES[recipe])
    shadow = tcfg.compute_dtype == "bfloat16_shadow"
    params = _opt_tree()
    rs = np.random.RandomState(1)
    grads = [jax.tree.map(lambda a: (rs.randn(*a.shape)
                                     * 10 ** rs.uniform(-3, 1)).astype(
                                         np.float32), params)
             for _ in range(4)]
    if shadow:  # the shadow's gradients are bf16
        grads = [jax.tree.map(lambda g: np.asarray(
            jnp.asarray(g, jnp.bfloat16)), g) for g in grads]
    jtx, ttx = jax_optimizer(tcfg), TO.make_optimizer(tcfg)
    jp = jax.tree.map(jnp.asarray, params)
    js = jtx.init(jp)
    tp = from_numpy(params, "cpu")
    ts = ttx.init(tp)

    def jax_step(p, s, g):
        import optax
        u, s = jtx.update(jax.tree.map(jnp.asarray, g), s, p)
        return optax.apply_updates(p, u), s

    def port_step(p, s, g):
        return ttx.step([torch.from_numpy(np.asarray(x, np.float32)).to(
            torch.bfloat16 if shadow else torch.float32)
            for x in jax.tree.leaves(g)], s, p)

    for g in grads[:3]:
        jp, js = jax_step(jp, js, g)
        ts = port_step(tp, ts, g)
        np.testing.assert_allclose(
            np.concatenate([a.ravel() for a in tree_leaves(to_numpy(tp))]),
            np.concatenate([np.asarray(a).ravel()
                            for a in jax.tree.leaves(jp)]),
            rtol=0, atol=OPT_ATOL)
        _assert_states_close(to_numpy(ts),
                             jax.tree.map(np.asarray, js))
    # Port -> JAX and JAX -> port through the npz files.
    port_path = TC.save_checkpoint(str(tmp_path), "port", "c", "r",
                                   to_numpy(tp), to_numpy(ts))
    jax_path = JC.save_checkpoint(str(tmp_path), "jax", "c", "r",
                                  jax.tree.map(np.asarray, jp),
                                  jax.tree.map(np.asarray, js))
    params_np = jax.tree.map(np.asarray, jp)
    _, js_from_port, _ = JC.load_full_checkpoint(
        port_path, params_np, jax.tree.map(np.asarray, jtx.init(jp)))
    _, ts_from_jax, _ = TC.load_full_checkpoint(
        jax_path, params_np, opt_state_template(ttx, params_np))
    ts_from_jax = opt_state_from_numpy(ts_from_jax, "cpu")
    _assert_states_close(to_numpy(ts_from_jax),
                         jax.tree.map(np.asarray, js))
    jp, _ = jax_step(jp, jax.tree.map(jnp.asarray, js_from_port), grads[3])
    port_step(tp, ts_from_jax, grads[3])
    np.testing.assert_allclose(
        np.concatenate([a.ravel() for a in tree_leaves(to_numpy(tp))]),
        np.concatenate([np.asarray(a).ravel() for a in jax.tree.leaves(jp)]),
        rtol=0, atol=OPT_ATOL)


@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16])
def test_adamw_groups_change_no_bit(mu_dtype, monkeypatch):
    """AdamW's update in groups of leaves (each at most a quarter of the
    elements, or one leaf) equals the update over every leaf at once bit
    for bit, with an f32 and a bf16 first moment, over three steps."""
    params = _opt_tree()
    leaves = tree_leaves(from_numpy(params, "cpu"))
    n = TO.UPDATE_GROUPS
    groups = TO.leaf_groups(leaves, n)
    assert len(groups) > 1
    assert [i for g in groups for i in g] == list(range(len(leaves)))
    budget = max(sum(x.numel() for x in leaves) / n,
                 max(x.numel() for x in leaves))
    assert all(sum(leaves[i].numel() for i in g) <= budget for g in groups)
    rs = np.random.RandomState(2)
    grads = [[torch.from_numpy(rs.randn(*x.shape).astype(np.float32))
              for x in leaves] for _ in range(3)]
    out = {}
    for n_groups in (n, 1):
        monkeypatch.setattr(TO, "UPDATE_GROUPS", n_groups)
        tx = TO.AdamW(1e-3, weight_decay=0.1, mu_dtype=mu_dtype)
        p = from_numpy(params, "cpu")
        state = tx.init(p)
        for g in grads:
            state = tx.step(g, state, p)
        out[n_groups] = tree_leaves(to_numpy(p)) + tree_leaves(
            to_numpy(state))
    assert len(out) == 2
    for a, b in zip(out[n], out[1]):
        np.testing.assert_array_equal(a, b)


def test_linear_schedule_lr():
    """The linear schedule's learning rate at update k is 0.1 lr + 0.9 lr
    k / epoch_num (optimizer steps, not epochs), held at lr after."""
    import optax
    sched = TO.linear_schedule(1e-5, 1e-4, 7)
    ref = optax.linear_schedule(1e-5, 1e-4, 7)
    for k in range(10):
        assert sched(k) == float(ref(k)), k
        assert sched(k) == pytest.approx(1e-5 + 9e-5 * min(k, 7) / 7,
                                         rel=1e-6)


# ---------------------------------------------------------------------------
# Data, serving transforms, the CLI
# ---------------------------------------------------------------------------

def test_time_shifted_windows_match_jax():
    from sea_tpu.data.datasets import make_temporal_windows as jax_windows
    from sea_tpu_torch.data.datasets import make_temporal_windows
    rs = np.random.RandomState(0)
    lat = rs.randn(3, 41, 2, 4).astype(np.float32)
    orig = rs.randn(3, 41, 5, 3).astype(np.float32)
    ib = rs.randn(3, 41, 1).astype(np.float32)
    for src_len, overlap in ((10, 0), (12, 4), (40, 0)):
        got = make_temporal_windows(lat, orig, ib, src_len, overlap,
                                    time_shift_rng=np.random.RandomState(9))
        want = jax_windows(lat, orig, ib, src_len, overlap,
                           time_shift_rng=np.random.RandomState(9))
        for k in ("src", "tgt", "tgt_original", "ib"):
            np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    plain = make_temporal_windows(lat, orig, ib, 10)
    assert not np.array_equal(got.src[:1], plain.src[:1]) or \
        len(got.src) != len(plain.src)


def test_serving_transforms_walk_the_new_modes():
    """Fused projections, bf16 casts and int4 quantization (max scales,
    min_size 64 so the smoke preset's matrices qualify) reach the pool
    and addition linears as in the JAX package, bit for bit; the pool's
    tables, token and weights stay as they are."""
    from sea_tpu.utils import precision as JP
    from sea_tpu_torch.utils import precision as TP
    for name in ("pool_mlp", "pool_linear_ln", "pool_pooling", "addition"):
        jparams = _jax_params(name)
        tparams = from_numpy(jparams, "cpu")
        for jfn, tfn in (
                (JP.cast_weights_bf16, TP.cast_weights_bf16),
                (functools.partial(JP.quantize_weights_int4, scale="max"),
                 functools.partial(TP.quantize_weights_int4, scale="max"))):
            want = _flatten(jax.tree.map(np.asarray, jfn(
                JP.fuse_attention_projections(jparams), min_size=64)))
            got = _flatten(to_numpy(tfn(
                TP.fuse_attention_projections(tparams), min_size=64)))
            assert sorted(got) == sorted(want), name
            for key, w in want.items():
                np.testing.assert_array_equal(got[key], w, err_msg=key)
        assert any(k.startswith("blocks/0/cross_down/0/w_p4") for k in got)
        if name == "pool_mlp":
            assert "blocks/0/pool_update/fc1/w_p4" in got


def test_calibration_records_the_new_modes():
    """Activation-aware int4 calibration records the pool and addition
    linears at JAX's paths, with JAX's moments."""
    from sea_tpu.utils.calibration import calibrate_temporal as jax_cal
    from sea_tpu_torch.utils.calibration import calibrate_temporal
    for name in ("pool_mlp", "addition"):
        cfg = _cfg(name)
        x, ib = _inputs(cfg, B=2, T=6, seed=4)
        want = jax_cal(jax.tree.map(jnp.asarray, _jax_params(name)), cfg,
                       [(x, ib)])
        got = calibrate_temporal(from_numpy(_jax_params(name), "cpu"), cfg,
                                 [(x, ib)])
        assert set(got) == set(want), name
        for path, w in want.items():
            for k in ("mean", "sq"):
                np.testing.assert_allclose(got[path][k].numpy(),
                                           np.asarray(w[k]), rtol=1e-5,
                                           atol=1e-6, err_msg=str(path))


def test_pool_gru_raises():
    with pytest.raises(NotImplementedError, match="gru"):
        TT.init_temporal(_cfg("pool_mlp", pool_update_method="gru"),
                         torch.Generator(), device="cpu")


def test_cli_adafactor_trains_and_resumes(tmp_path, capsys):
    """`temporal train --optimizer adafactor` on cylinder_flow_smoke: the
    checkpoint carries adafactor's state, which JAX's load_full_checkpoint
    reads with the JAX optimizer's template; --model_path resume restores
    it and goes on counting; time shifting trains too."""
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.utils import checkpoint as JC
    from sea_tpu_torch import cli
    from sea_tpu_torch.configs.cylinder_flow_smoke import \
        get_case as port_case
    from sea_tpu_torch.train import train_temporal as TTR
    from sea_tpu_torch.utils.params import save_init_checkpoints
    case = port_case()
    save = str(tmp_path / "run")
    params_np = save_init_checkpoints(case, save, seed=1)["temporal"]
    argv = ["cylinder_flow_smoke", "temporal", "train", "--synthetic",
            "--epochs", "2", "--save_dir", save, "--device", "cpu",
            "--optimizer", "adafactor"]
    cli.main(argv)
    path = f"{save}/temporal_cylinder_flow_run1.npz"
    tcfg = dataclasses.replace(case.temporal_train, optimizer="adafactor")
    jtx = jax_optimizer(tcfg)
    _, opt, _ = JC.load_full_checkpoint(
        path, params_np, jax.tree.map(np.asarray, jtx.init(params_np)))
    count = int(opt[0].count)
    assert count > 0 and len(opt) == 4
    # The smoke preset's leaves are all under 128 wide: none is factored.
    lin = ("blocks", 0, "mlp", 0, "layers", 0, "lin", "w")
    stats = [functools.reduce(lambda n, k: n[k], lin, tree)
             for tree in opt[0][1:]]
    assert [a.shape for a in stats] == [(1,), (1,), (32, 64)]
    capsys.readouterr()
    cli.main(argv[:5] + ["1"] + argv[6:] + ["--model_path", path])
    out = capsys.readouterr().out
    assert "Restored optimizer state" in out
    with np.load(path) as d:
        assert int(d["opt_state/0/0"]) > count
    # dataset_time_shifting: each epoch's windows cut anew from the seeds.
    calls = []
    real = TTR.make_temporal_windows

    def recorded(*a, **k):
        calls.append(k.get("time_shift_rng"))
        return real(*a, **k)
    shifted = case.replace(
        run=dataclasses.replace(case.run, save_dir=save),
        temporal_train=dataclasses.replace(
            case.temporal_train, dataset_time_shifting=True,
            dataset_src_len=20))
    TTR.make_temporal_windows = recorded
    try:
        best, _ = TTR.train(shifted, device="cpu",
                            data=cli._load_data(case, True), epochs=2)
    finally:
        TTR.make_temporal_windows = real
    assert sum(c is not None for c in calls) == 2
    assert all(np.isfinite(a).all() for a in tree_leaves(best))


@pytest.mark.parametrize("what", ["log_per_tensor", "profile_dir"])
def test_still_unported_options_raise(what):
    """The per-tensor norms and the profiler train beside a sequence- or
    pipeline-parallel mesh too (they train, tests/test_torch_cli_mesh.py):
    with one that does not fit the config (a ring that does not split the
    window, stages that do not split the layers) only the mesh raises,
    before any work, and the error does not name the option."""
    from sea_tpu_torch.configs.cylinder_flow_smoke import \
        get_case as port_case
    from sea_tpu_torch.train import train_temporal as TTR
    case, kw = port_case(), {}
    if what == "log_per_tensor":
        case = case.replace(
            temporal_train=dataclasses.replace(case.temporal_train,
                                               log_per_tensor=True))
    else:
        kw["profile_dir"] = "trace"
    from sea_tpu_torch.parallel.collectives import Grid
    from sea_tpu_torch.parallel.pipeline import PipeGrid
    for mesh, grid, why in (
            ("seq_mesh", Grid(1, 1, n_seq=3, seq_rank=0), "ring size"),
            ("pipe_mesh", PipeGrid(2), "pipe size")):
        with pytest.raises(ValueError, match=why) as e:
            TTR.train(case, device="cpu", **kw, **{mesh: grid})
        assert what not in str(e.value)
