"""The port's data- and tensor-parallel mesh on the CPU: gloo ranks.

The flash kernels' sharding interface first: the plain versions (the CPU
path of every flash entry), f32 and bf16, with a permuted ``bh_map`` and
global position offsets, against the JAX package's ``_flash_forward`` and
``_flash_backward`` with the same map and offsets in interpret mode: o
and lse to the flash-parity tolerances of
tests/test_torch_flash_attention.py, the dropout masks bit for bit.

Then the sharded paths (``sea_tpu_torch/parallel``) in 2 (2x1, 1x2) and 4
(2x2) gloo ranks spawned on the CPU (``multihost.run_ranks``; the rank
side is tests/_torch_ranks.py), each against the one-device port, which
runs the same functions on a 1 x 1 grid in this process:

- the temporal train step of ``cylinder_flow_smoke`` (dropout 0.1) with
  AdamW in f32, two steps: loss rtol 1e-5, grad_norm rtol 1e-4, params
  atol 1e-5 (the bounds tests/test_parallel.py holds the JAX package's
  sharded step to); under bf16_shadow with bf16 first moments the forward
  rounds to bf16 where the one device rounds once (a row-parallel sum of
  two rounded halves), so loss and grad_norm are held to one bf16 ulp
  (2^-8) and a parameter to 1e-5 + 2 lr a step (a gradient near 0 whose
  sign the rounding flips moves its parameter by up to 2 lr); Adafactor
  at E=128 under 1x2 and 2x2, where the MLP's leaves are factored and
  split, with the f32 bounds;
- the variational stage-1 step (dropout 0.1, the KL term summed over the
  global batch);
- the dropout a rank draws (elementwise, the flash kernels' mask for its
  bh_map, the plain attention's, the variational noise), gathered: bit
  for bit the one device's;
- the sharded scan rollout, f32, int8 and int4 weights (int4 also with an
  int8 cache), tensor-parallel: atol 1e-5 (f32, int8) and 2e-4 (int4,
  whose row-parallel halves sum in another order before the bf16-rounded
  x meets them: held to its quantization noise at these widths);
- a 1x2 checkpoint: rank 0's npz is the one-device layout (read back
  through the one-device template, equal to the one-device step's
  params and state) and every rank resumes from it.

The JAX package's own sharded functions on the same mesh shapes are the
subject of tests/test_torch_parallel_jax.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch.configs.cylinder_flow_smoke import get_case
from sea_tpu_torch.models.spatial import init_spatial
from sea_tpu_torch.models.temporal import init_temporal
from sea_tpu_torch.ops import flash_attention as FA
from sea_tpu_torch.parallel.mesh import make_mesh
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.utils import precision as prec
from sea_tpu_torch.utils import prng
from sea_tpu_torch.utils.params import from_numpy, to_numpy, tree_leaves

torch.set_num_threads(2)

SHAPES = [(2, 1), (1, 2), (2, 2)]
LOSS_RTOL, NORM_RTOL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
BF16_RTOL = 2.0 ** -8
OUT_ATOL, GRAD_ATOL = 2e-5, 5e-5
BF16_TOL_OUT, BF16_TOL_GRAD = 2.0 ** -7, 2.0 ** -6
SEED = (123456789, -987654321)
POS_OFF = (37, 1001)


# ---------------------------------------------------------------------------
# The flash kernels' sharding interface against JAX's
# ---------------------------------------------------------------------------

def _flash_arrays(B, Tq, Tk, H, hd, seed=0):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, T, H, hd).astype(np.float32)
            for T in (Tq, Tk, Tk, Tq)]


def _bh_map(B, H):
    return np.random.RandomState(1).permutation(4 * B * H)[:B * H].astype(
        np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 40, 40, 2, 16, True, 0),
                                   (2, 24, 40, 2, 16, True, 5)])
def test_flash_interface_matches_jax(dtype, shape, monkeypatch):
    """flash_forward_ref and the backward pieces with a permuted bh_map and
    pos_off against JAX's _flash_forward/_flash_backward with the same,
    in interpret mode, dropout 0.1: o, lse, dq, dk, dv."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, Tq, Tk, H, hd, causal, src_len = shape
    bh = _bh_map(B, H)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    arrays = [jnp.asarray(a, jdt) for a in _flash_arrays(B, Tq, Tk, H, hd)]
    kw = dict(causal=causal, src_len=src_len, block_q=jfa.DEFAULT_BLOCK_Q,
              block_k=jfa.DEFAULT_BLOCK_K, dropout_rate=0.1,
              seed=jnp.asarray(SEED, jnp.int32), bh_map=jnp.asarray(bh),
              pos_off=POS_OFF)
    o, lse = jfa._flash_forward(*arrays[:3], return_lse=True, **kw)
    dq, dk, dv = jfa._flash_backward(*arrays[:3], o, lse, arrays[3], **kw)
    tdt = getattr(torch, dtype)
    q, k, v, g = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(tdt)
                  for a in arrays)
    pkw = dict(causal=causal, src_len=src_len, dropout_rate=0.1,
               dropout_seed=SEED, bh_map=torch.from_numpy(bh),
               pos_off=POS_OFF)
    got_o, got_lse = FA.flash_forward_ref(q, k, v, **pkw)
    dsum = FA.row_dot(g, got_o)
    got_dq = FA.flash_bwd_dq_ref(q, k, v, g, got_lse, dsum, **pkw)
    got_dk, got_dv = FA.flash_bwd_dkv_ref(q, k, v, g, got_lse, dsum, **pkw)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    np.testing.assert_allclose(got_lse.numpy(), f32(lse)[:, :Tq, 0],
                               rtol=0, atol=1e-5)
    pairs = [(got_o, o, "o"), (got_dq, dq, "dq"), (got_dk, dk, "dk"),
             (got_dv, dv, "dv")]
    for got, want, what in pairs:
        got, want = got.float().numpy(), f32(want)
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=OUT_ATOL if what == "o"
                                       else GRAD_ATOL, err_msg=what)
        else:
            rel = BF16_TOL_OUT if what == "o" else BF16_TOL_GRAD
            err = np.abs(got - want).max()
            assert err <= rel * np.abs(want).max(), (what, err)


def test_flash_interface_masks_match_jax(monkeypatch):
    """The keep pattern bit for bit: JAX's kernel and the port's plain
    version on q = 0 and v = I (each output row is its mask row over Tk),
    and the port's dropout_mask, all with the permuted bh_map and
    pos_off; the identity map and zero offsets give another mask."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, T, H = 2, 40, 2
    bh = _bh_map(B, H)
    q = np.zeros((B, T, H, T), np.float32)
    v = np.broadcast_to(np.eye(T, dtype=np.float32)[None, :, None, :],
                        (B, T, H, T)).copy()
    o = jfa._flash_forward(jnp.asarray(q), jnp.asarray(q), jnp.asarray(v),
                           causal=False, src_len=0, block_q=128,
                           block_k=128, dropout_rate=0.1,
                           seed=jnp.asarray(SEED, jnp.int32),
                           bh_map=jnp.asarray(bh), pos_off=POS_OFF)
    want = np.asarray(o).transpose(0, 2, 1, 3) != 0  # [B, H, Tq, Tk]
    got = FA.flash_forward_ref(
        torch.from_numpy(q), torch.from_numpy(q), torch.from_numpy(v),
        causal=False, dropout_rate=0.1, dropout_seed=SEED,
        bh_map=torch.from_numpy(bh), pos_off=POS_OFF)[0]
    mask = FA.dropout_mask(B, H, T, T, SEED, 0.1, "cpu",
                           bh_map=torch.from_numpy(bh), pos_off=POS_OFF)
    np.testing.assert_array_equal(got.permute(0, 2, 1, 3).numpy() != 0, want)
    np.testing.assert_array_equal(mask.numpy() != 0, want)
    plain = FA.dropout_mask(B, H, T, T, SEED, 0.1, "cpu")
    assert (plain.numpy() != 0).tolist() != want.tolist()
    assert 0.07 < (~want).mean() < 0.13


def test_flash_defaults_are_the_identity_map():
    """bh_map = arange(B*H) and pos_off = (0, 0) compute what no
    arguments compute, bit for bit."""
    B, T, H, hd = 2, 24, 2, 16
    q, k, v, g = (torch.from_numpy(a) for a in _flash_arrays(B, T, T, H, hd))
    kw = dict(causal=True, dropout_rate=0.1, dropout_seed=SEED)
    o, lse = FA.flash_forward_ref(q, k, v, **kw)
    o2, lse2 = FA.flash_forward_ref(
        q, k, v, bh_map=torch.arange(B * H, dtype=torch.int32),
        pos_off=(0, 0), **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    with pytest.raises(ValueError, match="bh_map must be"):
        FA._check_bh_map(torch.arange(3), q)


# ---------------------------------------------------------------------------
# The sharded steps, rollout and checkpoint against the one device
# ---------------------------------------------------------------------------

def _case(E=32):
    case = get_case()
    return case.replace(
        temporal=dataclasses.replace(case.temporal, embed_dim=E),
        spatial=dataclasses.replace(case.spatial, embed_dim=E // 4))


def _temporal(E=32, B=4, T=8):
    cfg = _case(E).temporal
    params = to_numpy(init_temporal(cfg, torch.Generator().manual_seed(0),
                                    device="cpu"))
    rs = np.random.RandomState(0)
    src = rs.randn(B, T, cfg.num_fields, E).astype(np.float32)
    tgt = rs.randn(*src.shape).astype(np.float32)
    ib = np.repeat(rs.rand(B, 1, cfg.ib_num), T, 1).astype(np.float32)
    return cfg, params, (src, tgt, ib)


def _spatial():
    case = _case()
    cfg = dataclasses.replace(case.spatial, variational=True, dropout=0.1,
                              n_inp=6)
    params = to_numpy(init_spatial(cfg, torch.Generator().manual_seed(2),
                                   device="cpu"))
    batch = np.random.RandomState(5).randn(
        4, 4, 3, 6).astype(np.float32)  # [B, P, F, C]
    tcfg = dataclasses.replace(case.spatial_train, kl_weight_min=0.1,
                               kl_weight_max=1.0)
    return cfg, tcfg, params, batch


def _serving(params, cfg):
    """(f32, int8, int4) global serving trees, every matrix of at least 64
    elements quantized (the smoke preset's are below the default
    min_size)."""
    p = from_numpy(params, "cpu")
    return {"f32": params,
            "int8": to_numpy(prec.quantize_weights_int8(p, min_size=64)),
            "int4": to_numpy(prec.quantize_weights_int4(p, min_size=64))}


KEYS = [prng.fold_in(prng.prng_key(3), i) for i in range(2)]
RECIPES = {
    "f32": {},
    "bf16": {"compute_dtype": "bfloat16_shadow",
             "adam_mu_dtype": "bfloat16"},
    "adafactor": {"optimizer": "adafactor"},
}
ROLLOUTS = [("f32", torch.float32), ("int8", torch.float32),
            ("int4", torch.bfloat16), ("int4", torch.int8)]


def _jobs(shape, tmp):
    case = _case()
    cfg, params, batch = _temporal()
    jobs = {}
    for name, recipe in RECIPES.items():
        if name == "adafactor":
            if shape[1] == 1:
                continue
            wcfg, wparams, wbatch = _temporal(E=128)
            jobs[name] = ("temporal_steps", (
                wcfg, dataclasses.replace(case.temporal_train, **recipe),
                wparams, wbatch, KEYS))
        else:
            jobs[name] = ("temporal_steps", (
                cfg, dataclasses.replace(case.temporal_train, **recipe),
                params, batch, KEYS))
    scfg, stcfg, sparams, sbatch = _spatial()
    jobs["spatial"] = ("spatial_step", (scfg, stcfg, sparams, sbatch,
                                        KEYS[0], 3, 10))
    jobs["masks"] = ("masks", (4, 8, 16, 2, 7, 0.1))
    serving = _serving(params, cfg)
    x0, ib = batch[0][:, 0], batch[2][:, :6]
    for name, cache in ROLLOUTS:
        jobs[f"rollout_{name}_{cache}"] = ("rollout", (
            cfg, serving[name], x0, ib, cache))
    if shape == (1, 2):
        jobs["checkpoint"] = ("checkpoint_resume", (
            cfg, case.temporal_train, params, batch, KEYS,
            (str(tmp), "temporal", "cylinder_flow", "run1")))
    return jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{shape: rank 0's results} for every sharded shape, and the one
    device's ("1x1": every job of the largest job set, in-process)."""
    out = {}
    for shape in SHAPES:
        tmp = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
        results = run_ranks(R.run_grid, shape[0] * shape[1], shape,
                            _jobs(shape, tmp))
        out[shape] = results[0]
        out[(shape, "ranks")] = results
    tmp = tmp_path_factory.mktemp("mesh1x1")
    jobs = _jobs((1, 2), tmp)
    one = make_mesh(1, 1)
    out["1x1"] = {name: getattr(R, fn)(one, *args)
                  for name, (fn, args) in jobs.items()}
    return out


def _assert_steps(got, want, bf16=False, lr=1e-4):
    (gs, gp, go), (ws, wp, wo) = got, want
    for a, b in zip(gs, ws):
        rtol = BF16_RTOL if bf16 else LOSS_RTOL
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=rtol)
        np.testing.assert_allclose(a["grad_norm"], b["grad_norm"],
                                   rtol=BF16_RTOL if bf16 else NORM_RTOL)
        np.testing.assert_allclose(a["param_norm"], b["param_norm"],
                                   rtol=rtol)
    atol = PARAM_ATOL + (2 * lr * len(gs) if bf16 else 0.0)
    for a, b in zip(tree_leaves(gp), tree_leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)
    assert len(tree_leaves(go)) == len(tree_leaves(wo))
    for a, b in zip(tree_leaves(go), tree_leaves(wo)):
        assert np.shape(a) == np.shape(b)


STEP_CASES = [(recipe, shape) for recipe in sorted(RECIPES)
              for shape in SHAPES
              if recipe != "adafactor" or shape[1] > 1]


@pytest.mark.parametrize("recipe,shape", STEP_CASES,
                         ids=[f"{r}-{s[0]}x{s[1]}" for r, s in STEP_CASES])
def test_temporal_step_matches_one_device(recipe, shape, runs):
    """Adafactor runs where a model axis splits its statistics."""
    _assert_steps(runs[shape][recipe], runs["1x1"][recipe],
                  bf16=recipe == "bf16")


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_rank_gathers_the_same_params(shape, runs):
    ranks = runs[(shape, "ranks")]
    for other in ranks[1:]:
        for a, b in zip(tree_leaves(other["f32"][1]),
                        tree_leaves(ranks[0]["f32"][1])):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_spatial_variational_step_matches_one_device(shape, runs):
    (gs, gp), (ws, wp) = runs[shape]["spatial"], runs["1x1"]["spatial"]
    for key in ("loss", "recon_loss", "kl_loss", "r2", "param_norm"):
        np.testing.assert_allclose(gs[key], ws[key], rtol=LOSS_RTOL,
                                   err_msg=key)
    np.testing.assert_allclose(gs["grad_norm"], ws["grad_norm"],
                               rtol=NORM_RTOL)
    for a, b in zip(tree_leaves(gp), tree_leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_dropout_is_the_one_devices_bit_for_bit(shape, runs):
    got, want = runs[shape]["masks"], runs["1x1"]["masks"]
    for key in want:
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert 0.07 < (want["elementwise"] == 0).mean() < 0.13


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name,cache", ROLLOUTS,
                         ids=[f"{n}-{str(c)[6:]}" for n, c in ROLLOUTS])
def test_sharded_rollout_matches_one_device(name, cache, shape, runs):
    key = f"rollout_{name}_{cache}"
    got, want = runs[shape][key], runs["1x1"][key]
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2e-4 if name == "int4" else 1e-5)


def test_checkpoint_round_trips_to_the_one_device_layout(runs):
    """1x2: the npz rank 0 writes reads back through the one-device
    templates as the one-device step's params and state; both ranks
    resume from it and the next step is the one device's second."""
    rp, ro, stats, p2 = runs[(1, 2)]["checkpoint"]
    cfg, params, batch = _temporal()
    one = make_mesh(1, 1)
    tcfg = _case().temporal_train
    _, wp, wo = R.temporal_steps(one, cfg, tcfg, params, batch, KEYS[:1])
    for a, b in zip(tree_leaves(rp), tree_leaves(wp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    ws, wp2, _ = runs["1x1"]["f32"]
    # mu and nu are (1 - b) g and (1 - b) g^2 of gradients summed in
    # another order: f32 noise of 1e-7 of the global gradient norm.
    atol = 1e-7 * ws[0]["grad_norm"]
    for a, b in zip(tree_leaves(ro), tree_leaves(wo)):
        assert np.shape(a) == np.shape(b)
        np.testing.assert_allclose(a, b, rtol=NORM_RTOL, atol=atol)
    np.testing.assert_allclose(stats[0]["loss"], ws[1]["loss"],
                               rtol=LOSS_RTOL)
    for a, b in zip(tree_leaves(p2), tree_leaves(wp2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


def test_uneven_splits_raise():
    """3 heads over 2 model ranks, and a split dim of odd size: a
    ValueError naming the divisibility (the JAX package falls back to
    unsharded XLA there)."""
    from sea_tpu_torch.parallel.collectives import Grid
    from sea_tpu_torch.parallel.mesh import shard, temporal_param_dims
    grid = Grid(1, 2, 0, 1)
    with pytest.raises(ValueError, match="n_heads % n_model"):
        grid.local_heads(3)
    cfg, params, _ = _temporal()
    bad = params["blocks"][0]["mlp"][0]["layers"][0]["lin"]
    bad["w"] = bad["w"][:, :63]
    with pytest.raises(ValueError, match="divide evenly"):
        shard(grid, params, temporal_param_dims(params))
    with pytest.raises(ValueError, match="needs 2 ranks"):
        make_mesh(2, 1)


def test_seq_mesh_still_raises():
    """The JAX driver's refusals of the seq and pipe meshes, before any
    work: a window that does not split over the ring, a layer stack that
    does not split over the stages, two meshes at once."""
    from sea_tpu_torch.parallel.collectives import Grid
    from sea_tpu_torch.parallel.pipeline import PipeGrid
    from sea_tpu_torch.train import train_temporal as TTR
    ring3 = Grid(1, 1, n_seq=3, seq_rank=0)
    with pytest.raises(ValueError, match=r"dataset_src_len \(40\) "
                       r"divisible by the ring size \(3\)"):
        TTR.train(get_case(), device="cpu", seq_mesh=ring3)
    with pytest.raises(ValueError, match=r"num_layers \(1\) divisible "
                       r"by the pipe size \(2\)"):
        TTR.train(get_case(), device="cpu", pipe_mesh=PipeGrid(2))
    with pytest.raises(ValueError, match="at most one"):
        TTR.train(get_case(), device="cpu", mesh=object(), seq_mesh=object())

