"""The port's temporal training path against the JAX package, on the CPU.

- utils.prng against jax.random (PRNGKey, fold_in, split, key_data) and
  the dropout hash against the JAX functions: bit for bit.
- The dropout forward and one make_train_step step of a cut-down cylinder
  model (E=128, 8 heads, T=40, dropout 0.1, AdaLN with time-constant ib,
  stacked fields) against the JAX ones, from the same params and key. The
  JAX package runs its Pallas kernels in interpret mode with the dispatch
  gates forced open (as tests/test_kernel_shard.py does), so both sides
  draw the same (bh, q, k) attention masks and flat-position MLP masks.
- train(epochs=1) on cylinder_flow_smoke with synthetic data and the same
  initial weights, against JAX's train; the port's checkpoint loads with
  the JAX load_full_checkpoint and serves in the JAX CLI.

Tolerances. The forward and the loss: atol 1e-5 (f32, summation order).
Gradients (read through the first Adam moment, mu = 0.1 g) and norms:
rtol 1e-4 with atol 1e-7 x the gradient scale. Updated parameters after
the first AdamW step, p - lr (u(g) + wd p) with u(g) = g / (|g| + eps):
- where the JAX gradient is well above eps, |g| > NEAR_EPS x eps (100
  eps = 1e-6), u is within eps/|g| of sign(g) and moves by at most
  |dg| eps / |g|^2 for a change dg of g, so summation-order noise (~1e-9
  on g, ~1e-3 of the checked gradient tolerance) leaves the parameters
  within PARAM_ATOL = 2e-6, a fiftieth of lr = 1e-4;
- where |g| <= 100 eps, u turns a sub-ulp change of g into a whole
  fraction of lr (a port g of 2.00e-9 against JAX's 1.37e-9 moves u by
  0.05). There the bound is PARAM_ATOL plus lr times |u(g_port) -
  u(g_jax)|, the two sides' updates from their own checked gradients;
  with the gradients within their tolerance dg it is at most lr times
  the most u can move over [g - dg, g + dg] (u is monotone), and it is
  far tighter (dg, 1e-6 x the gradient norm, spans many eps). Every
  element is held to one of the two bounds.
The bf16 policies ("bfloat16", "bfloat16_mixed", "bfloat16_shadow", each
with f32 and bf16 first moments), one step on the same cut-down model:
the port rounds to bf16 at other points than XLA does (a fused bias add,
the norms' outputs, the matmuls' own roundings), so its step cannot equal
JAX's bf16 step to f32 order; what it must do is round no worse than JAX.
The loss and each gradient tensor are held to JAX's f32 step within
BF16_NOISE = 4 times JAX's own bf16-vs-f32 distance for that quantity,
plus the f32 tolerances above: measured up to 2.9 times for one tensor
(blocks[0].ib.layers[0].ln.w, bfloat16_mixed), 1 or less for the loss
and under "bfloat16". A dropped cast, a gradient that misses the masters,
or a kernel piece rounded where JAX does not is off by orders more. The
gradients are read as sign(mu) sqrt(nu / (1 - b2)) (exact in f32 for
either mu dtype); the parameters are held to PARAM_ATOL + lr |u(g_port) -
u(g_jax)| as above, from those gradients; a bf16 mu to one bf16 ulp of
JAX's (at the larger of the two) plus (1 - b1) times the two sides'
gradient difference (rounding two values to bf16 moves them apart by at
most their difference and one ulp); and the
shadow to to_bf16 of the updated parameters bit for bit.

The two-step train() comparison meets such elements too (at the smoke
preset, a fifth of the parameters have a gradient within 100 eps on some
step). It records both sides' gradients at every step, holds them to the
gradient tolerance above, and holds each parameter to PARAM_ATOL plus lr
times the summed differences of the two sides' Adam updates, replayed in
f64 from each side's own gradients: the parameters agree wherever the
gradients do, and a near-eps gradient may move them only as far as Adam
itself turns its recorded difference.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu_torch.models import temporal as TT
from sea_tpu_torch.ops import layers as L
from sea_tpu_torch.train import optim as TO
from sea_tpu_torch.train import train_temporal as TTR
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.params import (from_numpy, opt_state_from_numpy,
                                        to_numpy, tree_leaves)

torch.set_num_threads(2)

FWD_ATOL = 1e-5
PARAM_ATOL = 2e-6
BF16_NOISE = 4.0
NEAR_EPS = 100  # |g| <= NEAR_EPS x eps: the first Adam step is ill-conditioned


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture
def jax_kernels(monkeypatch):
    """The JAX package's flash and fused AdaLN kernels in interpret mode,
    dispatched wherever it would take them on a TPU."""
    from sea_tpu.ops import flash_attention as jfa
    from sea_tpu.ops import fused_adaln as jfal
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jfal, "_FORCE_INTERPRET", True)
    monkeypatch.setattr(jfa, "flash_supported", lambda *a, **k: True)


@pytest.mark.parametrize("seed", [0, 42, 2 ** 32 - 1])
def test_prng_matches_jax_random(seed):
    key = jax.random.PRNGKey(seed)
    port = prng.prng_key(seed)
    assert tuple(int(w) for w in np.asarray(jax.random.key_data(key))) \
        == port
    for d in (0, 1, 5, 2 ** 31 + 3):
        assert tuple(int(w) for w in np.asarray(jax.random.fold_in(key, d))) \
            == prng.fold_in(port, d)
    assert [tuple(int(w) for w in k) for k in
            np.asarray(jax.random.split(key, 5))] == prng.split(port, 5)
    from sea_tpu.ops.attention import _key_to_seed
    assert tuple(int(w) for w in np.asarray(_key_to_seed(
        jax.random.fold_in(key, 9)))) == prng.key_to_seed(
            prng.fold_in(port, 9))


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_hash_matches_jax(rate):
    from sea_tpu.ops import layers as JL
    from sea_tpu.ops.flash_attention import dropout_scale_from_positions
    q = np.arange(-3, 300, dtype=np.int32)[:, None]
    k = np.arange(257, dtype=np.int32)[None, :]
    for s0, s1 in ((0, 0), (-5, 123456), (2 ** 31 - 1, -2 ** 31)):
        with np.errstate(over="ignore"):
            want = np.asarray(dropout_scale_from_positions(
                np.int32(s0), np.int32(s1), np.int32(13), q, k, rate=rate))
        got = L.dropout_scale_from_positions(
            s0, s1, 13, torch.from_numpy(q).long(), torch.from_numpy(k).long(),
            rate=rate).numpy()
        np.testing.assert_array_equal(got, want)
    x = np.random.RandomState(0).randn(2, 5, 33).astype(np.float32)
    key = prng.fold_in(prng.prng_key(7), 3)
    want = JL.dropout(jnp.asarray(x), rate,
                      jax.random.fold_in(jax.random.PRNGKey(7), 3), False)
    np.testing.assert_array_equal(L.dropout(torch.from_numpy(x), rate,
                                            key).numpy(), np.asarray(want))


def _small_cylinder_cfg():
    from sea_tpu.configs.cylinder_flow import get_case
    return dataclasses.replace(get_case().temporal, embed_dim=128,
                               ib_time_constant=True)


def _batch(cfg, B=2, T=40, seed=0):
    rs = np.random.RandomState(seed)
    x = rs.randn(B, T, cfg.num_fields, cfg.embed_dim).astype(np.float32)
    tgt = rs.randn(*x.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, axis=1).astype(np.float32)
    return x, tgt, ib


def test_dropout_forward_matches_jax(jax_kernels):
    from sea_tpu.models import temporal as JT
    cfg = _small_cylinder_cfg()
    params = _np(JT.init_temporal(jax.random.PRNGKey(0), cfg))
    x, _, ib = _batch(cfg)
    key = prng.fold_in(prng.prng_key(3), 11)
    want = JT.temporal_forward(params, cfg, jnp.asarray(x), jnp.asarray(ib),
                               rng=jax.random.fold_in(
                                   jax.random.PRNGKey(3), 11),
                               deterministic=False)
    got = TT.temporal_forward(from_numpy(params, "cpu"), cfg,
                              torch.from_numpy(x), torch.from_numpy(ib),
                              rng=key, deterministic=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=FWD_ATOL)
    # Dropout is on: the deterministic forward differs.
    det = TT.temporal_forward(from_numpy(params, "cpu"), cfg,
                              torch.from_numpy(x), torch.from_numpy(ib))
    assert (det - got).abs().max() > 1e-2


def _assert_tree_close(got, want, atol, rtol=0.0):
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        np.testing.assert_allclose(np.asarray(a), np.asarray(flat_want[path]),
                                   rtol=rtol, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


def _assert_first_step_params_close(got, want, got_mu, want_mu, tcfg):
    """Parameters after one AdamW step against JAX's, by the module's rule:
    PARAM_ATOL where the JAX gradient g = mu / (1 - b1) exceeds NEAR_EPS x
    eps; elsewhere PARAM_ATOL + lr x |u(g_port) - u(g_jax)|, the two
    sides' first Adam updates u(g) = g / (|g| + eps) from their own
    gradients (read through mu). With the gradients inside their checked
    tolerance dg, u being monotone, that never exceeds the most u can move
    over [g - dg, g + dg]."""
    lr, eps, b1 = tcfg.learning_rate, tcfg.eps, tcfg.betas[0]

    def grads(tree):
        return {jax.tree_util.keystr(p): np.asarray(m, np.float64) / (1 - b1)
                for p, m in jax.tree_util.tree_flatten_with_path(tree)[0]}

    def u(x):
        return x / (np.abs(x) + eps)

    g_got, g_want = grads(got_mu), grads(want_mu)
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    flat_want = dict(jax.tree_util.tree_flatten_with_path(want)[0])
    assert len(flat_got) == len(flat_want) == len(g_got) == len(g_want)
    for path, a in flat_got:
        key = jax.tree_util.keystr(path)
        g = g_want[key]
        tol = np.where(np.abs(g) > NEAR_EPS * eps, PARAM_ATOL,
                       PARAM_ATOL + lr * np.abs(u(g_got[key]) - u(g)))
        diff = np.abs(np.asarray(a, np.float64)
                      - np.asarray(flat_want[path], np.float64))
        bad = diff > tol
        assert not bad.any(), (
            f"{key}: {int(bad.sum())} of {bad.size} elements off by up to "
            f"{diff[bad].max():.3g} (their |g| {np.abs(g[bad]).min():.3g}"
            f"..{np.abs(g[bad]).max():.3g})")


def test_train_step_matches_jax(jax_kernels):
    """One step from the same params, batch and key: loss, norms, the
    gradients (as mu = 0.1 g), nu and the updated parameters."""
    _check_train_step(_small_cylinder_cfg())


def test_ib_attention_src_len_train_step_matches_jax(jax_kernels):
    """The same for a config only the masked prefix engine serves:
    ib_addition_mode="attention" (an unmasked attention over the ib stream
    per field, with its own dropout keys) and src_len=1 (every causal
    attention admits one key ahead)."""
    _check_train_step(dataclasses.replace(
        _small_cylinder_cfg(), ib_addition_mode="attention", src_len=1))


def _check_train_step(cfg):
    from sea_tpu.configs.cylinder_flow import get_case
    from sea_tpu.models import temporal as JT
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.train.train_temporal import make_train_step as jax_step
    tcfg = get_case().temporal_train
    params = _np(JT.init_temporal(jax.random.PRNGKey(0), cfg))
    x, tgt, ib = _batch(cfg, seed=1)
    tx = jax_optimizer(tcfg)
    step = jax_step(cfg, tx)
    jp, jstate, jstats = step(jax.tree.map(jnp.asarray, params),
                              tx.init(params), jnp.asarray(x),
                              jnp.asarray(tgt), jnp.asarray(ib),
                              jax.random.fold_in(jax.random.PRNGKey(5), 2))
    ttx = TO.make_optimizer(tcfg)
    tparams = from_numpy(params, "cpu")
    tp, tstate, tstats = TTR.make_train_step(cfg, ttx)(
        tparams, ttx.init(tparams), torch.from_numpy(x),
        torch.from_numpy(tgt), torch.from_numpy(ib),
        prng.fold_in(prng.prng_key(5), 2))
    np.testing.assert_allclose(float(tstats["loss"]), float(jstats["loss"]),
                               rtol=0, atol=FWD_ATOL)
    for k in ("grad_norm", "param_norm"):
        np.testing.assert_allclose(float(tstats[k]), float(jstats[k]),
                                   rtol=1e-4, err_msg=k)
    got_state = to_numpy(tstate)
    want_state = _np(jstate)
    assert int(got_state[0].count) == int(want_state[0].count) == 1
    gscale = float(jstats["grad_norm"])
    _assert_tree_close(got_state[0].mu, want_state[0].mu,
                       atol=1e-7 * gscale, rtol=1e-4)
    _assert_tree_close(got_state[0].nu, want_state[0].nu,
                       atol=1e-7 * gscale ** 2, rtol=1e-3)
    _assert_first_step_params_close(to_numpy(tp), _np(jp), got_state[0].mu,
                                    want_state[0].mu, tcfg)


def test_optimizer_state_has_optax_layout():
    """The port's AdamW state flattens to tx.init's npz paths and crosses
    to and from the optax tree unchanged."""
    import optax
    from sea_tpu.utils.checkpoint import _flatten
    params = {"a": np.ones((3, 2), np.float32),
              "b": [np.zeros(4, np.float32)]}
    want = _np(optax.adamw(1e-4).init(params))
    state = TO.AdamW(1e-4).init(from_numpy(params, "cpu"))
    got = to_numpy(state)
    assert {k: (v.shape, v.dtype) for k, v in _flatten(got).items()} == \
        {k: (v.shape, v.dtype) for k, v in _flatten(want).items()}
    back = to_numpy(opt_state_from_numpy(want, "cpu"))
    _assert_tree_close(back, got, atol=0)


def test_unported_options_raise():
    """A sequence-parallel mesh whose ring does not split the window
    raises, as in the JAX driver; the linear schedule, adafactor (alone
    and under the shadow), bf16 first moments and the bf16 shadow
    build."""
    from sea_tpu_torch.configs.cylinder_flow import get_case
    tcfg = get_case().temporal_train
    tx = TO.make_optimizer(dataclasses.replace(tcfg, scheduler="linear"))
    assert isinstance(tx, TO.AdamW) and callable(tx.lr)
    assert tx.lr(0) == pytest.approx(0.1 * tcfg.learning_rate)
    tx = TO.make_optimizer(dataclasses.replace(tcfg, optimizer="adafactor"))
    assert isinstance(tx, TO.Adafactor)
    tx = TO.make_optimizer(dataclasses.replace(
        tcfg, optimizer="adafactor", compute_dtype="bfloat16_shadow"))
    assert isinstance(tx, TO.with_bf16_shadow)
    assert isinstance(tx.inner, TO.Adafactor)
    tx = TO.make_optimizer(dataclasses.replace(tcfg,
                                               adam_mu_dtype="bfloat16"))
    assert isinstance(tx, TO.AdamW) and tx.mu_dtype == torch.bfloat16
    tx = TO.make_optimizer(dataclasses.replace(
        tcfg, compute_dtype="bfloat16_shadow"))
    assert isinstance(tx, TO.with_bf16_shadow)
    assert tx.inner.mu_dtype == torch.float32
    from sea_tpu_torch.parallel.collectives import Grid
    with pytest.raises(ValueError, match="divisible by the ring size"):
        TTR.train(get_case(), device="cpu",
                  seq_mesh=Grid(1, 1, n_seq=2, seq_rank=0))


_BF16_STEPS = {}  # (compute_dtype, adam_mu_dtype) -> both sides' step


def _bf16_step(compute_dtype, mu_dtype):
    """One step of JAX's make_train_step and the port's under a policy
    (the jax_kernels fixture active): {"jax": (params, state, stats),
    "port": (...), "init": params}, numpy trees, cached per process."""
    key = (compute_dtype, mu_dtype)
    if key in _BF16_STEPS:
        return _BF16_STEPS[key]
    from sea_tpu.configs.cylinder_flow import get_case
    from sea_tpu.models import temporal as JT
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.train.train_temporal import make_train_step as jax_step
    cfg = _small_cylinder_cfg()
    tcfg = dataclasses.replace(get_case().temporal_train,
                               compute_dtype=compute_dtype,
                               adam_mu_dtype=mu_dtype)
    params = _np(JT.init_temporal(jax.random.PRNGKey(0), cfg))
    x, tgt, ib = _batch(cfg, seed=1)
    tx = jax_optimizer(tcfg)
    jp, jstate, jstats = jax_step(cfg, tx, compute_dtype=compute_dtype)(
        jax.tree.map(jnp.asarray, params),
        tx.init(jax.tree.map(jnp.asarray, params)), jnp.asarray(x),
        jnp.asarray(tgt), jnp.asarray(ib),
        jax.random.fold_in(jax.random.PRNGKey(5), 2))
    ttx = TO.make_optimizer(tcfg)
    tparams = from_numpy(params, "cpu")
    tp, tstate, tstats = TTR.make_train_step(
        cfg, ttx, compute_dtype=compute_dtype)(
            tparams, ttx.init(tparams), torch.from_numpy(x),
            torch.from_numpy(tgt), torch.from_numpy(ib),
            prng.fold_in(prng.prng_key(5), 2))
    out = {"jax": (_np(jp), jstate, {k: float(v) for k, v in
                                     jstats.items()}),
           "port": (to_numpy(tp), tstate, {k: float(v) for k, v in
                                           tstats.items()}),
           "init": params, "tcfg": tcfg}
    _BF16_STEPS[key] = out
    return out


def _adam(state):
    """The ScaleByAdamState of an optimizer state, shadow or not."""
    return (state.inner if hasattr(state, "inner") else state)[0]


def _grads_from_moments(adam, b2):
    """{keystr: f64 gradient} of a first step: sign(mu) sqrt(nu/(1-b2))."""
    mu = {jax.tree_util.keystr(p): np.asarray(m, np.float64) for p, m in
          jax.tree_util.tree_flatten_with_path(
              jax.tree.map(lambda a: np.asarray(a, np.float32),
                           adam.mu))[0]}
    return {jax.tree_util.keystr(p): np.sign(mu[jax.tree_util.keystr(p)])
            * np.sqrt(np.asarray(n, np.float64) / (1 - b2))
            for p, n in jax.tree_util.tree_flatten_with_path(adam.nu)[0]}


def _bf16_ulp(x):
    """The spacing of bf16 numbers at |x| (the least subnormal at 0)."""
    x = np.abs(np.asarray(x, np.float64))
    e = np.floor(np.log2(np.where(x > 0, x, 1.0)))
    return np.where(x > 0, 2.0 ** (np.maximum(e, -126) - 7), 2.0 ** -133)


@pytest.mark.parametrize("mu_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("compute_dtype", ["bfloat16", "bfloat16_mixed",
                                           "bfloat16_shadow"])
def test_bf16_train_step_matches_jax(compute_dtype, mu_dtype, jax_kernels):
    """One step under a bf16 policy against JAX's make_train_step (flash
    and AdaLN kernels in interpret mode on bf16 inputs): the loss, the
    gradients, the parameters, a bf16 mu and the shadow, by the module's
    bf16 rules; JAX's f32 step is the reference of the noise."""
    steps = _bf16_step(compute_dtype, mu_dtype)
    f32 = _bf16_step("float32", "float32")
    tcfg = steps["tcfg"]
    b1, b2, lr, eps = (tcfg.betas[0], tcfg.betas[1], tcfg.learning_rate,
                       tcfg.eps)
    (jp, jstate, jstats), (tp, tstate, tstats) = steps["jax"], steps["port"]
    ref_loss = f32["jax"][2]["loss"]
    assert abs(tstats["loss"] - ref_loss) <= BF16_NOISE * abs(
        jstats["loss"] - ref_loss) + FWD_ATOL
    got_state = to_numpy(tstate)
    assert int(_adam(got_state).count) == 1
    g_port = _grads_from_moments(_adam(got_state), b2)
    g_jax = _grads_from_moments(_adam(jstate), b2)
    g_ref = _grads_from_moments(_adam(f32["jax"][1]), b2)
    gscale = f32["jax"][2]["grad_norm"]
    for path, g in g_port.items():
        noise = np.abs(g_jax[path] - g_ref[path]).max()
        bound = (BF16_NOISE * noise + 1e-4 * np.abs(g_ref[path])
                 + 1e-7 * gscale)
        err = np.abs(g - g_ref[path])
        assert (err <= bound).all(), (
            f"{path}: gradient off JAX's f32 one by up to {err.max():.3g}, "
            f"JAX's bf16 one by {noise:.3g}")
    u = lambda g: g / (np.abs(g) + eps)  # noqa: E731
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(tp)[0]:
        key = jax.tree_util.keystr(path)
        diff = np.abs(np.asarray(a, np.float64) - flat_want[path])
        tol = PARAM_ATOL + lr * np.abs(u(g_port[key]) - u(g_jax[key]))
        assert (diff <= tol).all(), f"{key}: off by up to {diff.max():.3g}"
    want_mu = dict(jax.tree_util.tree_flatten_with_path(
        _adam(jstate).mu)[0])
    for path, m in jax.tree_util.tree_flatten_with_path(
            _adam(tstate).mu)[0]:
        key = jax.tree_util.keystr(path)
        assert m.dtype == (torch.bfloat16 if mu_dtype == "bfloat16"
                           else torch.float32), key
        if mu_dtype == "bfloat16":
            mj = np.asarray(want_mu[path], np.float64)
            mp = m.float().numpy().astype(np.float64)
            diff = np.abs(mp - mj)
            tol = ((1 - b1) * np.abs(g_port[key] - g_jax[key])
                   + _bf16_ulp(np.maximum(np.abs(mp), np.abs(mj))))
            assert (diff <= tol).all(), f"mu {key}: off by {diff.max():.3g}"
    if compute_dtype == "bfloat16_shadow":
        params = from_numpy(tp, "cpu")
        for s, p in zip(tree_leaves(tstate.shadow), tree_leaves(params)):
            assert s.dtype == torch.bfloat16
            assert torch.equal(s, p.to(torch.bfloat16))


def test_bf16_shadow_checkpoint_crosses_from_jax(tmp_path, jax_kernels):
    """A JAX bfloat16_shadow + bf16-mu state, written by the JAX package's
    save_checkpoint, loads in the port's load_full_checkpoint with the
    port's template and comes back with the JAX values bit for bit: a
    bf16 mu, the bf16 shadow, the f32 nu and the count."""
    from sea_tpu.utils.checkpoint import save_checkpoint as jax_save
    from sea_tpu_torch.utils.checkpoint import load_full_checkpoint
    steps = _bf16_step("bfloat16_shadow", "bfloat16")
    jp, jstate, _ = steps["jax"]
    jax_save(str(tmp_path), "temporal", "case", "run", jp, opt_state=jstate,
             meta={"epoch": 1})
    tx = TO.make_optimizer(steps["tcfg"])
    template = from_numpy(steps["init"], "cpu")
    params, opt, _ = load_full_checkpoint(
        str(tmp_path / "temporal_case_run.npz"), to_numpy(template),
        to_numpy(tx.init(template)))
    state = opt_state_from_numpy(opt, "cpu", torch.bfloat16)
    assert isinstance(state, TO.ShadowOptState)
    want = jax.tree.map(lambda a: np.asarray(a, np.float32), jstate)
    assert int(_adam(state).count) == int(_adam(want).count) == 1
    for got, ref in ((_adam(state).mu, _adam(want).mu),
                     (_adam(state).nu, _adam(want).nu),
                     (state.shadow, want.shadow)):
        pairs = list(zip(tree_leaves(got), jax.tree.leaves(ref)))
        assert pairs and all(torch.equal(a.float(), torch.from_numpy(np.array(b)))
                             for a, b in pairs)
    assert all(a.dtype == torch.bfloat16
               for a in tree_leaves(_adam(state).mu)
               + tree_leaves(state.shadow))
    _assert_tree_close(params, jp, atol=0)


def _keystr_leaves(tree):
    """[(jax keystr path, leaf)] of a dict/list tree in its own order (the
    order the port's optimizer takes its gradients in)."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]" + p, x) for k, v in tree.items()
                for p, x in _keystr_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]" + p, x) for i, v in enumerate(tree)
                for p, x in _keystr_leaves(v)]
    return [] if tree is None else [("", tree)]


def _record_step_grads(monkeypatch):
    """Per-step gradients of both trainers, as {keystr: f64 array} lists:
    the port's from AdamW.step, JAX's from a debug callback in front of
    its optimizer's update."""
    import optax
    from sea_tpu.train import train_temporal as JTT
    port, jax_side = [], []
    step = TO.AdamW.step

    def port_step(self, grads, state, params):
        port.append({p: np.asarray(g.detach(), np.float64)
                     for (p, _), g in zip(_keystr_leaves(params), grads)})
        return step(self, grads, state, params)

    def record(grads):
        jax_side.append({jax.tree_util.keystr(p): np.asarray(g, np.float64)
                         for p, g in
                         jax.tree_util.tree_flatten_with_path(grads)[0]})

    make = JTT.make_optimizer

    def make_recording(*args, **kwargs):
        tx = make(*args, **kwargs)

        def update(grads, state, params=None):
            jax.debug.callback(record, grads)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(TO.AdamW, "step", port_step)
    monkeypatch.setattr(JTT, "make_optimizer", make_recording)
    return port, jax_side


def _adam_directions(steps, tcfg):
    """[{path: u_s}] for each step s, u_s = mu_hat / (sqrt(nu_hat) + eps),
    Adam's update direction replayed in f64 from one side's per-step
    gradients."""
    b1, b2, eps = tcfg.betas[0], tcfg.betas[1], tcfg.eps
    mu, nu, us = {}, {}, []
    for n, grads in enumerate(steps, start=1):
        u = {}
        for p, g in grads.items():
            mu[p] = b1 * mu.get(p, 0.0) + (1 - b1) * g
            nu[p] = b2 * nu.get(p, 0.0) + (1 - b2) * g * g
            u[p] = (mu[p] / (1 - b1 ** n)) / (
                np.sqrt(nu[p] / (1 - b2 ** n)) + eps)
        us.append(u)
    return us


def test_train_matches_jax_and_checkpoint_crosses(tmp_path, jax_kernels,
                                                  capsys, monkeypatch):
    """train(epochs=1) from the same weights on the same synthetic data:
    per-step gradients and the parameters (see the module's note); the
    port's checkpoint then loads in JAX's load_full_checkpoint."""
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.models.temporal import init_temporal as jax_init
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.train.train_temporal import train as jax_train
    from sea_tpu.utils.checkpoint import load_full_checkpoint
    from sea_tpu_torch.cli import _load_data
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    from sea_tpu_torch.utils.params import save_init_checkpoints

    case = get_case()
    data = _load_data(case, synthetic=True)
    T = data[0].shape[1]
    dirs = {}
    for side in ("jax", "port"):
        dirs[side] = str(tmp_path / side)
        save_init_checkpoints(case, dirs[side], seed=1)

    def cut(c, side):
        return c.replace(
            temporal_train=dataclasses.replace(c.temporal_train,
                                               dataset_src_len=T - 1),
            run=dataclasses.replace(c.run, save_dir=dirs[side]))

    jcase = cut(jax_case(), "jax")
    init = _np(jax_init(jax.random.PRNGKey(4), jcase.temporal))
    port_grads, jax_grads = _record_step_grads(monkeypatch)
    want, _ = jax_train(jcase, data=data, epochs=1, init_params=init)
    got, _ = TTR.train(cut(case, "port"), device="cpu", data=data, epochs=1,
                       init_params=init)
    assert len(port_grads) == len(jax_grads) == 2
    for n, (pg, jg) in enumerate(zip(port_grads, jax_grads)):
        assert pg.keys() == jg.keys()
        gscale = np.sqrt(sum((g ** 2).sum() for g in jg.values()))
        for path, g in pg.items():
            np.testing.assert_allclose(g, jg[path], rtol=1e-4,
                                       atol=1e-7 * gscale,
                                       err_msg=f"step {n} grad {path}")
    tcfg = jcase.temporal_train
    port_u = _adam_directions(port_grads, tcfg)
    jax_u = _adam_directions(jax_grads, tcfg)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(_np(want))[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        key = jax.tree_util.keystr(path)
        du = sum(np.abs(pu[key] - ju[key]) for pu, ju in zip(port_u, jax_u))
        diff = np.abs(np.asarray(a, np.float64)
                      - np.asarray(flat_want[path], np.float64))
        tol = PARAM_ATOL + tcfg.learning_rate * du
        assert (diff <= tol).all(), (
            f"{key}: off by up to {(diff - tol).max():.3g} past "
            f"PARAM_ATOL + lr x the Adam update difference")
    out = capsys.readouterr().out
    assert out.count("Epoch 1/1") == 2

    template = jax_init(jax.random.PRNGKey(0), jcase.temporal)
    path = os.path.join(dirs["port"], "temporal_cylinder_flow_run1.npz")
    params, opt, meta = load_full_checkpoint(
        path, template, jax_optimizer(jcase.temporal_train).init(template))
    _assert_tree_close(_np(params), got, atol=0)
    jpath = os.path.join(dirs["jax"], "temporal_cylinder_flow_run1.npz")
    _, jopt, jmeta = load_full_checkpoint(
        jpath, template, jax_optimizer(jcase.temporal_train).init(template))
    assert int(meta["epoch"]) == int(jmeta["epoch"]) == 1
    np.testing.assert_allclose(meta["val_loss"], jmeta["val_loss"],
                               rtol=1e-5)
    assert int(opt[0].count) == int(jopt[0].count) == 2
    _assert_tree_close(_np(opt[0].nu), _np(jopt[0].nu), atol=1e-12,
                       rtol=2e-3)


def test_jax_cli_serves_port_trained_checkpoint(tmp_path, capsys,
                                                monkeypatch):
    """`temporal train` through the port's CLI writes a checkpoint that the
    JAX CLI's `temporal test` serves; both CLIs print the same metrics
    from it (rtol 1e-4, the bound of tests/test_torch_e2e.py)."""
    import re

    from sea_tpu import cli as jax_cli
    from sea_tpu.train import evaluate as jax_evaluate
    from sea_tpu_torch import cli as torch_cli
    from sea_tpu_torch.utils.params import save_init_checkpoints
    for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                 "plot_rollout_error"):
        monkeypatch.setattr(jax_evaluate, name, lambda *a, **k: None)
    save = str(tmp_path)
    save_init_checkpoints(torch_cli.get_case("cylinder_flow_smoke"), save,
                          seed=2)
    base = ["cylinder_flow_smoke", "temporal"]
    common = ["--synthetic", "--save_dir", save]
    params = torch_cli.main(base + ["train", "--epochs", "1"] + common
                            + ["--device", "cpu"])
    assert "New Best Model Saved" in capsys.readouterr().out
    assert all(np.isfinite(a).all() for a in jax.tree.leaves(params))

    def metrics(out):
        return {k: float(re.search(rf"^{k}: (\S+)$", out, re.M).group(1))
                for k in ("encoded_rel_mse", "decoded_rel_mse")}

    jax_cli.main(base + ["test"] + common + ["--platform", "cpu"])
    want = metrics(capsys.readouterr().out)
    torch_cli.main(base + ["test"] + common + ["--device", "cpu"])
    got = metrics(capsys.readouterr().out)
    for key in want:
        assert np.isfinite(want[key])
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4,
                                   err_msg=key)
