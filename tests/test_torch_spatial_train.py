"""The port's stage-1 (spatial autoencoder) training and test against the
JAX package, on the CPU, at the cylinder_flow_smoke widths (2 layers,
embed 8, 2 heads, MLP hidden 32) with dropout 0.1 where training runs.

Tolerances, stated per test:
- metrics, data helpers: float32 summation order (rtol 1e-6), numpy
  copies exact;
- the dropout masks (attention probabilities, PE, MLP) and the uniform
  under the variational noise: bit for bit; the noise itself within
  rtol 1e-5: XLA's f32 erfinv is up to 91 ulps from the exact value in
  the tails (measured over 2^20 draws against scipy in f64; PyTorch's
  within 1.5), 2.2e-5 absolute at |z| = 3.76, 5.8e-6 relative;
- forwards: atol 1e-5 (f32 summation order);
- one AdamW step and two epochs of ``train()``: the bounds of
  tests/test_torch_train.py, whose module note derives them: gradients
  rtol 1e-4 with atol 1e-7 x the gradient norm, parameters within
  PARAM_ATOL plus lr times the two sides' Adam update difference,
  replayed in f64 from each side's own gradients; a bf16 step within
  BF16_NOISE times JAX's own bf16-vs-f32 distance of the f32 step;
- the tracker's metrics: rtol 1e-4; the stage-1 test's three numbers:
  rtol 1e-5.
"""

import dataclasses
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu_torch.models import spatial as TS
from sea_tpu_torch.ops import attention as TA
from sea_tpu_torch.train import evaluate as TE
from sea_tpu_torch.train import metrics as TM
from sea_tpu_torch.train import optim as TO
from sea_tpu_torch.train import train_spatial as TTS
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.params import from_numpy, to_numpy, tree_leaves

torch.set_num_threads(2)

FWD_ATOL = 1e-5
PARAM_ATOL = 2e-6
BF16_NOISE = 4.0
N_INP = 10


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _keys(seed, fold):
    return (jax.random.fold_in(jax.random.PRNGKey(seed), fold),
            prng.fold_in(prng.prng_key(seed), fold))


# ---------------------------------------------------------------------------
# Metrics and data helpers
# ---------------------------------------------------------------------------

def test_metrics_match_jax():
    from sea_tpu.train import metrics as JM
    rs = np.random.RandomState(0)
    pred, truth = rs.randn(2, 6, 5, 3, 7).astype(np.float32)
    mu, logvar = 0.5 * rs.randn(2, 6, 4, 2, 8).astype(np.float32)
    tp, tt, tmu, tlv = map(torch.from_numpy, (pred, truth, mu, logvar))
    close = dict(rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(TM.r2(tp, tt), JM.r2(pred, truth), **close)
    for n_valid in (1, 4, 6):
        for port, jaxf, args in (
                (TM.masked_r2, JM.masked_r2, (pred, truth)),
                (TM.masked_mse, JM.masked_mse, (pred, truth)),
                (TM.masked_kl, JM.masked_kl, (mu, logvar))):
            np.testing.assert_allclose(
                port(*map(torch.from_numpy, args), n_valid),
                jaxf(*args, jnp.int32(n_valid)), **close)
    for it, total, lo, hi in ((0, 10, 0.0, 1.0), (7, 30, 1e-4, 3e-3),
                              (29, 30, 0.1, 0.7)):
        want = JM.kl_anneal_weight(lo, hi, jnp.int32(it), total)
        assert TM.kl_anneal_weight(lo, hi, it, total) == float(want)
        kw = dict(kl_weight_min=lo, kl_weight_max=hi, total_steps=total)
        got = TM.vloss(tt, tp, tmu, tlv, iteration=it, **kw)
        ref = JM.vloss(truth, pred, mu, logvar, iteration=jnp.int32(it),
                       **kw)
        for g, w in zip(got, ref):
            np.testing.assert_allclose(g, w, **close)


@pytest.mark.parametrize("layout", ["isolate", "mixed"])
def test_invert_layout_and_unpatch_match_jax(layout, tmp_path):
    """invert_sea_layout and MeshProcessor.inverse_scale_and_unpatch (with
    min-max scaling on) against JAX's, exactly: the same numpy ops."""
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu.data import datasets as JD
    from sea_tpu.data.mesh import MeshProcessor as JMP
    from sea_tpu_torch.cli import _load_data
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    from sea_tpu_torch.data import datasets as TD
    from sea_tpu_torch.data.mesh import MeshProcessor as TMP
    fields, coords, _ = _load_data(get_case(), synthetic=True)
    snaps = fields[:2].reshape(-1, *fields.shape[2:])
    out = {}
    for name, case, cls, D in (("jax", jax_case(), JMP, JD),
                               ("port", get_case(), TMP, TD)):
        mesh = dataclasses.replace(case.mesh,
                                   scale_feature_range=(-1.0, 1.0))
        mp = cls(mesh, case.spatial.field_groups, coords,
                 save_dir=str(tmp_path / name))
        _, patched = mp.patchify_and_scale(snaps)
        tokens = D.apply_sea_layout(patched, layout)
        back = D.invert_sea_layout(tokens + 0.01, layout)
        out[name] = (back, mp.inverse_scale_and_unpatch(back))
    for got, want in zip(out["port"], out["jax"]):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# Dropout and noise
# ---------------------------------------------------------------------------

def test_plain_attention_dropout_matches_jax():
    """attention_core at rate 0.1 with v the identity over the keys, so the
    output is the dropped probabilities [B, Tq, H, Tk]: JAX's zeros bit for
    bit, the kept values within f32 order."""
    from sea_tpu.ops.attention import attention_core as jax_core
    rs = np.random.RandomState(3)
    B, T, H = 2, 64, 3
    q, k = rs.randn(2, B, T, H, T).astype(np.float32)
    v = np.broadcast_to(np.eye(T, dtype=np.float32)[None, :, None, :],
                        (B, T, H, T)).copy()
    jkey, tkey = _keys(11, 2)
    want = np.asarray(jax_core(q, k, v, causal=False, dropout_rate=0.1,
                               dropout_key=jkey, deterministic=False))
    got = TA.attention_core(*map(torch.from_numpy, (q, k, v)), causal=False,
                            dropout_rate=0.1, dropout_key=tkey).numpy()
    assert 0.05 < (want == 0).mean() < 0.15
    np.testing.assert_array_equal(got == 0, want == 0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("seed,fold,shape", [
    (0, 0, (7,)), (42, 3, (3, 5, 1, 8)), (2 ** 32 - 1, 9, (16, 64, 1, 16))])
def test_prng_normal_matches_jax(seed, fold, shape):
    jkey, tkey = _keys(seed, fold)
    np.testing.assert_array_equal(
        prng.random_bits(tkey, shape, device="cpu").numpy(),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        lo = np.nextafter(np.array(-1.0, jdt), np.array(0.0, jdt), dtype=jdt)
        np.testing.assert_array_equal(
            prng.uniform_open(tkey, shape, tdt, device="cpu").float(),
            np.asarray(jax.random.uniform(jkey, shape, jdt, lo, 1.0),
                       np.float32))
        got = prng.normal(tkey, shape, tdt, device="cpu")
        want = np.asarray(jax.random.normal(jkey, shape, jdt), np.float32)
        assert got.dtype == tdt and got.shape == shape
        if tdt == torch.bfloat16:  # erfinv's ulps vanish in bf16 here
            np.testing.assert_array_equal(got.float(), want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)


# ---------------------------------------------------------------------------
# The model in training mode, one train step
# ---------------------------------------------------------------------------

def _cfgs(variational=False, dropout=0.1):
    """(jax cfg, port cfg): the smoke preset's spatial model, n_inp set."""
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    return tuple(dataclasses.replace(c().spatial, dropout=dropout,
                                     variational=variational, n_inp=N_INP)
                 for c in (jax_case, get_case))


def _init(cfg, seed=0):
    from sea_tpu.models.spatial import init_spatial
    return _np(init_spatial(jax.random.PRNGKey(seed), cfg))


def _tokens(cfg, B=6, P=4, seed=1):
    F = sum(len(g) for g in cfg.field_groups)
    return np.random.RandomState(seed).randn(B, P, F, N_INP).astype(
        np.float32)


@pytest.mark.parametrize("variational", [False, True])
def test_spatial_forward_training_matches_jax(variational):
    """spatial_forward with dropout 0.1 and a key (and, variational, the
    reparameterized noise) against JAX's; the deterministic forward too."""
    from sea_tpu.models.spatial import spatial_forward as jax_forward
    jcfg, tcfg = _cfgs(variational)
    params = _init(jcfg)
    x = _tokens(jcfg)
    jkey, tkey = _keys(5, 1)
    tparams = from_numpy(params, "cpu")
    for train in (True, False):
        kw_j = dict(rng=jkey, deterministic=False) if train else {}
        kw_t = dict(rng=tkey, deterministic=False) if train else {}
        want = jax_forward(params, jcfg, jnp.asarray(x), **kw_j)
        got = TS.spatial_forward(tparams, tcfg, torch.from_numpy(x), **kw_t)
        want = want if variational else (want,)
        got = got if variational else (got,)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=FWD_ATOL)
    # Training changes the output: the dropout (and the noise) act.
    det = TS.spatial_forward(tparams, tcfg, torch.from_numpy(x))
    trained = TS.spatial_forward(tparams, tcfg, torch.from_numpy(x),
                                 rng=tkey, deterministic=False)
    first = (lambda o: o[0]) if variational else (lambda o: o)
    assert (first(det) - first(trained)).abs().max() > 1e-3


_STEPS = {}


def _step(compute_dtype, mu_dtype, variational):
    """One step of JAX's make_train_step and the port's, from the same
    params, batch, key and iteration, cached per process."""
    key = (compute_dtype, mu_dtype, variational)
    if key in _STEPS:
        return _STEPS[key]
    from sea_tpu.configs.cylinder_flow_smoke import get_case
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.train.train_spatial import make_train_step as jax_step
    jcfg, tcfg = _cfgs(variational)
    tc = dataclasses.replace(get_case().spatial_train, weight_decay=1e-2,
                             compute_dtype=compute_dtype,
                             adam_mu_dtype=mu_dtype)
    kl = dict(kl_weight_min=1e-3, kl_weight_max=1e-2, total_steps=10)
    params = _init(jcfg, seed=2)
    x = _tokens(jcfg, B=8, seed=3)
    jkey, tkey = _keys(7, 4)
    tx = jax_optimizer(tc)
    jp, jstate, jstats = jax_step(jcfg, tx, compute_dtype=compute_dtype,
                                  **kl)(
        jax.tree.map(jnp.asarray, params),
        tx.init(jax.tree.map(jnp.asarray, params)), jnp.asarray(x), jkey,
        jnp.asarray(3))
    ttx = TO.make_optimizer(tc)
    tparams = from_numpy(params, "cpu")
    tp, tstate, tstats = TTS.make_train_step(
        tcfg, ttx, compute_dtype=compute_dtype, **kl)(
            tparams, ttx.init(tparams), torch.from_numpy(x), tkey, 3)
    out = {"jax": (_np(jp), jstate, {k: float(v) for k, v in
                                     jstats.items()}),
           "port": (to_numpy(tp), tstate, {k: float(v) for k, v in
                                           tstats.items()}),
           "tc": tc}
    _STEPS[key] = out
    return out


def _adam(state):
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


@pytest.mark.parametrize("compute_dtype,mu_dtype,variational", [
    ("float32", "float32", False), ("float32", "float32", True),
    ("bfloat16_shadow", "bfloat16", False)])
def test_spatial_train_step_matches_jax(compute_dtype, mu_dtype,
                                        variational):
    """The loss, R^2, norms, gradients (read from the moments) and the
    updated parameters of one step; under bf16_shadow with a bf16 mu the
    distances to JAX's f32 step are held to BF16_NOISE times JAX's own,
    and the shadow is the bf16 cast of the updated parameters."""
    steps = _step(compute_dtype, mu_dtype, variational)
    f32 = _step("float32", "float32", variational)
    tc = steps["tc"]
    lr, eps, b2 = tc.learning_rate, tc.eps, tc.betas[1]
    (jp, jstate, jstats), (tp, tstate, tstats) = steps["jax"], steps["port"]
    ref = f32["jax"][2]
    bf16 = compute_dtype != "float32"
    for k in ("loss", "recon_loss", "kl_loss", "r2", "grad_norm",
              "param_norm"):
        tol = 1e-5 * abs(ref[k]) + 1e-7
        if bf16:
            tol += BF16_NOISE * abs(jstats[k] - ref[k])
        assert abs(tstats[k] - ref[k]) <= tol, (k, tstats[k], jstats[k])
    if variational:
        assert tstats["kl_loss"] > 0
    g_port = _grads_from_moments(_adam(to_numpy(tstate)), b2)
    g_jax = _grads_from_moments(_adam(jstate), b2)
    g_ref = _grads_from_moments(_adam(f32["jax"][1]), b2)
    gscale = ref["grad_norm"]
    for path, g in g_port.items():
        noise = np.abs(g_jax[path] - g_ref[path]).max() if bf16 else 0.0
        bound = BF16_NOISE * noise + 1e-4 * np.abs(g_ref[path]) \
            + 1e-7 * gscale
        err = np.abs(g - g_ref[path])
        assert (err <= bound).all(), (path, err.max())
    u = lambda g: g / (np.abs(g) + eps)  # noqa: E731
    flat_want = dict(jax.tree_util.tree_flatten_with_path(jp)[0])
    for path, a in jax.tree_util.tree_flatten_with_path(tp)[0]:
        key = jax.tree_util.keystr(path)
        diff = np.abs(np.asarray(a, np.float64) - flat_want[path])
        tol = PARAM_ATOL + lr * np.abs(u(g_port[key]) - u(g_jax[key]))
        assert (diff <= tol).all(), f"{key}: off by up to {diff.max():.3g}"
    if bf16:
        assert all(m.dtype == torch.bfloat16
                   for m in tree_leaves(_adam(tstate).mu))
        params = from_numpy(tp, "cpu")
        for s, p in zip(tree_leaves(tstate.shadow), tree_leaves(params)):
            assert torch.equal(s, p.to(torch.bfloat16))


# ---------------------------------------------------------------------------
# train(), the checkpoint, the stage-1 test
# ---------------------------------------------------------------------------

class _Tracker:
    def __init__(self):
        self.rows = {}

    def record_error(self, phase, epoch, metrics):
        self.rows[(phase, epoch)] = {k: float(v) for k, v in
                                     metrics.items()}

    def log_model(self, *args, **kwargs):
        pass

    def finish(self):
        pass


def _keystr_leaves(tree):
    if isinstance(tree, dict):
        return [(f"[{k!r}]" + p, x) for k, v in tree.items()
                for p, x in _keystr_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]" + p, x) for i, v in enumerate(tree)
                for p, x in _keystr_leaves(v)]
    return [] if tree is None else [("", tree)]


def _record_step_grads(monkeypatch):
    """Per-step gradients of both trainers as {keystr: f64} lists: the
    port's from AdamW.step, JAX's from a debug callback in front of its
    optimizer's update."""
    import optax
    from sea_tpu.train import train_spatial as JTS
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

    make = JTS.make_optimizer

    def make_recording(*args, **kwargs):
        tx = make(*args, **kwargs)

        def update(grads, state, params=None):
            jax.debug.callback(record, grads)
            return tx.update(grads, state, params)

        return optax.GradientTransformation(tx.init, update)

    monkeypatch.setattr(TO.AdamW, "step", port_step)
    monkeypatch.setattr(JTS, "make_optimizer", make_recording)
    return port, jax_side


def _adam_directions(steps, tc):
    b1, b2, eps = tc.betas[0], tc.betas[1], tc.eps
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


def _smoke_cases(tmp_path, dropout=0.1):
    from sea_tpu.configs.cylinder_flow_smoke import get_case as jax_case
    from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
    out = {}
    for side, c in (("jax", jax_case()), ("port", get_case())):
        out[side] = c.replace(
            spatial=dataclasses.replace(c.spatial, dropout=dropout),
            run=dataclasses.replace(c.run, save_dir=str(tmp_path / side)))
    return out


def test_train_matches_jax_and_checkpoint_crosses(tmp_path, monkeypatch,
                                                  capsys):
    """train(epochs=2) on the smoke preset's synthetic data, dropout 0.1,
    from the same initial weights: per-step gradients, the best params,
    the tracker's train and validation metrics; the port's checkpoint,
    optimizer state included, loads in JAX's load_full_checkpoint."""
    from sea_tpu.models.spatial import init_spatial as jax_init
    from sea_tpu.train.optim import make_optimizer as jax_optimizer
    from sea_tpu.train.train_spatial import train as jax_train
    from sea_tpu.utils.checkpoint import load_full_checkpoint
    from sea_tpu_torch.cli import _load_data
    cases = _smoke_cases(tmp_path)
    data = _load_data(cases["port"], synthetic=True)
    sd = TTS.process_data(cases["port"], data=data)
    init = _np(jax_init(jax.random.PRNGKey(4), dataclasses.replace(
        cases["jax"].spatial, n_inp=sd.spatial_cfg.n_inp)))
    port_grads, jax_grads = _record_step_grads(monkeypatch)
    trackers = {"jax": _Tracker(), "port": _Tracker()}
    want, _ = jax_train(cases["jax"], trackers["jax"], data=data, epochs=2,
                        init_params=init)
    got, _ = TTS.train(cases["port"], trackers["port"], device="cpu",
                       data=data, epochs=2, init_params=init)
    n_steps = 2 * (len(sd.train) // cases["port"].spatial_train.batch_size)
    assert len(port_grads) == len(jax_grads) == n_steps
    for n, (pg, jg) in enumerate(zip(port_grads, jax_grads)):
        assert pg.keys() == jg.keys()
        gscale = np.sqrt(sum((g ** 2).sum() for g in jg.values()))
        for path, g in pg.items():
            np.testing.assert_allclose(g, jg[path], rtol=1e-4,
                                       atol=1e-7 * gscale,
                                       err_msg=f"step {n} grad {path}")
    tc = cases["jax"].spatial_train
    port_u = _adam_directions(port_grads, tc)
    jax_u = _adam_directions(jax_grads, tc)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(_np(want))[0])
    flat_got = jax.tree_util.tree_flatten_with_path(got)[0]
    assert len(flat_got) == len(flat_want)
    for path, a in flat_got:
        key = jax.tree_util.keystr(path)
        du = sum(np.abs(pu[key] - ju[key]) for pu, ju in zip(port_u, jax_u))
        diff = np.abs(np.asarray(a, np.float64)
                      - np.asarray(flat_want[path], np.float64))
        assert (diff <= PARAM_ATOL + tc.learning_rate * du).all(), key
    rows = trackers["port"].rows
    assert rows.keys() == trackers["jax"].rows.keys() == {
        ("train", 1), ("train", 2), ("val", 1), ("val", 2)}
    for where, metrics in trackers["jax"].rows.items():
        assert rows[where].keys() == metrics.keys()
        for k, v in metrics.items():
            np.testing.assert_allclose(rows[where][k], v, rtol=1e-4,
                                       err_msg=f"{where} {k}")
    assert capsys.readouterr().out.count("Epoch 2/2") == 2

    scfg = dataclasses.replace(cases["jax"].spatial,
                               n_inp=sd.spatial_cfg.n_inp)
    template = jax_init(jax.random.PRNGKey(0), scfg)
    tx = jax_optimizer(tc)
    paths = {side: os.path.join(str(tmp_path / side),
                                "encoder_decoder_cylinder_flow_run1.npz")
             for side in ("jax", "port")}
    params, opt, meta = load_full_checkpoint(paths["port"], template,
                                             tx.init(template))
    _, jopt, jmeta = load_full_checkpoint(paths["jax"], template,
                                          tx.init(template))
    for a, b in zip(jax.tree.leaves(_np(params)), jax.tree.leaves(got)):
        np.testing.assert_array_equal(a, b)
    assert int(meta["epoch"]) == int(jmeta["epoch"])
    np.testing.assert_allclose(meta["val_loss"], jmeta["val_loss"],
                               rtol=1e-4)
    assert int(opt[0].count) == int(jopt[0].count) == n_steps
    for a, b in zip(jax.tree.leaves(_np(opt[0].nu)),
                    jax.tree.leaves(_np(jopt[0].nu))):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-12)


def test_encoder_test_metrics_match_jax(tmp_path, capsys, monkeypatch):
    """test_encoder_decoder's three numbers against JAX's on the smoke
    preset's synthetic test split, from the same weights."""
    from sea_tpu.models.spatial import init_spatial as jax_init
    from sea_tpu.train import evaluate as JE
    from sea_tpu.train.train_spatial import process_data as jax_process
    from sea_tpu_torch.cli import _load_data
    cases = _smoke_cases(tmp_path, dropout=0.0)
    data = _load_data(cases["port"], synthetic=True)
    jsd = jax_process(cases["jax"], data=data)
    sd = TTS.process_data(cases["port"], data=data)
    np.testing.assert_array_equal(sd.test, jsd.test)
    params = _np(jax_init(jax.random.PRNGKey(6), jsd.spatial_cfg))
    want = JE.test_encoder_decoder(params, cases["jax"], jsd.test,
                                   jsd.mesh_processor, save_artifacts=False,
                                   spatial_cfg=jsd.spatial_cfg)
    got = TE.test_encoder_decoder(from_numpy(params, "cpu"), cases["port"],
                                  sd.test, sd.mesh_processor, device="cpu",
                                  save_artifacts=False,
                                  spatial_cfg=sd.spatial_cfg)
    assert got.keys() == want.keys() == {"mse_patched", "mse_unpatched",
                                         "relative_mse"}
    for k in want:
        assert np.isfinite(got[k])
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
    out = capsys.readouterr().out
    assert out.count("Test Relative MSE after inverse scaling") == 2
    # save_artifacts=True draws the original and decoded fields of 5
    # snapshots into the save_dir (recorded here, not drawn).
    from sea_tpu_torch.utils import plotting
    drawn = []
    monkeypatch.setattr(plotting, "plot_all_fields_2d",
                        lambda *a, filename, **k: drawn.append(
                            os.path.basename(filename)))
    TE.test_encoder_decoder(from_numpy(params, "cpu"), cases["port"],
                            sd.test, sd.mesh_processor, device="cpu",
                            spatial_cfg=sd.spatial_cfg, save_artifacts=True)
    assert len(drawn) == 10 and len(set(drawn)) == 10
    assert sum(n.startswith("original_data_") for n in drawn) == 5


# ---------------------------------------------------------------------------
# The port alone: data -> stage 1 -> stage 2 -> rollout, and resume
# ---------------------------------------------------------------------------

def _count(path):
    with np.load(path) as d:
        key = "opt_state/0/0" if "opt_state/0/0" in d.files \
            else "opt_state/0/0/0"
        return int(d[key])


def test_port_pipeline_and_resume(tmp_path, capsys, monkeypatch):
    """`encoder train` -> `temporal train` -> `temporal test` through the
    port's CLI alone, the temporal steps on the encoder it wrote; then
    `--model_path` resume of both trains: the Adam moments restored (the
    step count goes on), and a checkpoint of another recipe resuming its
    params with fresh moments and the JAX CLI's warning."""
    from sea_tpu_torch import cli
    from sea_tpu_torch.train import train_temporal as TTT
    from sea_tpu_torch.utils import plotting
    from sea_tpu_torch.utils.params import opt_state_template
    # The test and the stage-1 test draw their plots: left out here.
    monkeypatch.setattr(plotting, "plot_all_fields_2d", lambda *a, **k: None)
    monkeypatch.setattr(plotting, "plot_rollout_error", lambda *a, **k: None)
    save = str(tmp_path / "run")
    common = ["--synthetic", "--save_dir", save, "--device", "cpu"]
    enc = cli.main(["cylinder_flow_smoke", "encoder", "train", "--epochs",
                    "1"] + common)
    enc_path = os.path.join(save, "encoder_decoder_cylinder_flow_run1.npz")
    assert os.path.exists(enc_path)
    case = cli.get_case("cylinder_flow_smoke").replace(
        run=dataclasses.replace(cli.get_case("cylinder_flow_smoke").run,
                                save_dir=save))
    td = TTT.process_data(case, data=cli._load_data(case, True),
                          device="cpu")
    for a, b in zip(tree_leaves(to_numpy(td.latent_service.params)),
                    tree_leaves(enc)):
        np.testing.assert_array_equal(a, b)
    cli.main(["cylinder_flow_smoke", "temporal", "train", "--epochs", "1"]
             + common)
    results = cli.main(["cylinder_flow_smoke", "temporal", "test"] + common)
    assert np.isfinite(results["decoded_rel_mse"])
    metrics = cli.main(["cylinder_flow_smoke", "encoder", "test"] + common)
    out = capsys.readouterr().out
    assert f"Using pretrained encoder model: {enc_path}" in out
    printed = [float(v) for v in re.findall(
        r"^Test (?:Loss|Relative MSE) [^:]*: (\S+)$", out, re.M)]
    assert len(printed) == 3
    for k, v in zip(("mse_patched", "mse_unpatched", "relative_mse"),
                    printed):
        assert np.isfinite(metrics[k])
        assert v == pytest.approx(metrics[k], abs=1e-6)

    # Resume: the restored state is the checkpoint's, and the count goes on.
    tcfg = case.spatial_train
    template = to_numpy(TS.init_spatial(
        TTS.process_data(case, data=cli._load_data(case, True)).spatial_cfg,
        torch.Generator().manual_seed(0), device="cpu"))
    _, opt = cli.load_train_checkpoint(enc_path, template, tcfg)
    with np.load(enc_path) as d:
        assert int(opt[0].count) == int(d["opt_state/0/0"])
        np.testing.assert_array_equal(
            opt[0].nu["blocks"][0]["attn"]["q"]["w"],
            d["opt_state/0/2/blocks/0/attn/q/w"])
    assert "Restored optimizer state" in capsys.readouterr().out
    steps = _count(enc_path)
    for stage, path, extra, count in (
            ("encoder", enc_path, [], 2 * steps),
            ("temporal", os.path.join(save, "temporal_cylinder_flow_run1.npz"),
             [], None),
            ("encoder", enc_path, ["--compute_dtype", "bf16_shadow",
                                   "--adam_mu_dtype", "bf16"], steps)):
        before = _count(path)
        resumed = str(tmp_path / f"resume_{stage}_{len(extra)}")
        if stage == "temporal":
            import shutil
            os.makedirs(resumed)
            shutil.copy(enc_path, resumed)
        cli.main(["cylinder_flow_smoke", stage, "train", "--epochs", "1",
                  "--model_path", path, "--synthetic", "--save_dir",
                  resumed, "--device", "cpu"] + extra)
        out = capsys.readouterr().out
        assert f"Continuing training from model: {path}" in out
        name = "encoder_decoder" if stage == "encoder" else "temporal"
        new = os.path.join(resumed, f"{name}_cylinder_flow_run1.npz")
        if extra:
            assert "does not match the configured optimizer structure" in out
            assert "Restored optimizer state" not in out
            assert _count(new) == count
        else:
            assert "Restored optimizer state" in out
            assert _count(new) == 2 * before
    assert int(opt_state_template(TO.make_optimizer(tcfg),
                                  template)[0].count) == 0
