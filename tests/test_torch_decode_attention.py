"""The flash-decode wrapper of the port (sea_tpu_torch/ops/decode_attention).

On the CPU: the plain version ``decode_attention_ref`` against the JAX
Pallas kernel in interpret mode and against the XLA path of JAX
``mha_step`` it replaces, for every head dim the kernel takes, f32 and bf16
caches, at the first position, both sides of the TPU kernel's 256-key
block edge, and the last position. Tolerances: atol 1e-5 for f32 (summation
order), 2e-2 for bf16 against the XLA path (which rounds the normalised
probabilities and not q); against the TPU kernel the bf16 plain version
is held to 1e-5 as well: both round q to bf16 and each unnormalised
probability against the running max of the 256-key tiles up to its own.

The int8 cache: ``attention._quantize_token`` bit for bit against JAX's;
``decode_attention_q8_ref`` against the TPU kernel ``_decode_kernel_q8``
in interpret mode at the same head dims and positions, atol 1e-5 (both
round q and each p * v_scale to bf16, p against the running max of the
256-key tiles up to its own); and eight int8-cache
``mha_step``s against JAX's with its kernel forced (interpret mode): the
same bound for the outputs; the scales written within an f32 ulp and the
planes within one step on under 1% of entries (the tokens themselves
differ in the last bits: BLAS and RoPE order).

The CUDA kernel itself runs only on the card: its test is marked ``gpu``
and skips here. The card has no JAX, so this module imports JAX only
inside the tests that compare against it; there,
``python -m pytest tests/test_torch_decode_attention.py --noconftest -m gpu``
runs the kernel test (tests/conftest.py imports JAX).
"""

import functools
import inspect

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops import decode_attention as DA

torch.set_num_threads(2)

B, H, T = 1, 2, 260
POSITIONS = (0, 255, 256, T - 1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2, "int8": 1e-5}


def _inputs(hd, dtype, t):
    """q [B,H,hd], caches [B,H,T,hd] in `dtype` whose slot t holds the
    token kv [B,H,hd], as mha_step writes it."""
    rs = np.random.RandomState(hd + t)
    q = rs.randn(B, H, hd).astype(np.float32)
    kv = rs.randn(B, H, hd).astype(np.float32)
    K = rs.randn(B, H, T, hd).astype(np.float32)
    V = rs.randn(B, H, T, hd).astype(np.float32)
    K[:, :, t], V[:, :, t] = kv, kv
    tdt = getattr(torch, dtype)
    return (q, kv, K, V, torch.from_numpy(K).to(tdt),
            torch.from_numpy(V).to(tdt))


@functools.lru_cache(maxsize=None)
def _jax_paths(hd, dtype):
    """Jitted (interpret-mode kernel, mha_step XLA path) for one shape."""
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops import attention as JA
    from sea_tpu.ops.decode_attention import decode_attention as jax_decode
    C = H * hd
    eye = jnp.eye(C, dtype=jnp.float32)
    zero = jnp.zeros((C,), jnp.float32)
    # Identity projections: q, k and v are the inputs themselves, so the
    # step's output is the cache attention alone.
    params = {"q": {"w": eye, "b": zero}, "k": {"w": eye, "b": zero},
              "v": {"w": eye, "b": zero}, "proj": {"w": eye}}
    jdt = getattr(jnp, dtype)

    @jax.jit
    def kernel(q, K, V, t):
        return jax_decode(q, K.astype(jdt), V.astype(jdt), t,
                          interpret=True)

    @jax.jit
    def xla(q, kv, K, V, t):
        cache = {"k": K.astype(jdt), "v": V.astype(jdt)}
        out, _ = JA.mha_step(params, q.reshape(B, C), kv.reshape(B, C),
                             cache, t, n_heads=H, rope=False)
        return out.reshape(B, H, hd)

    return kernel, xla


@pytest.mark.parametrize("t", POSITIONS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hd", DA.HEAD_DIMS)
def test_ref_matches_jax_kernel_and_xla_path(hd, dtype, t):
    jnp = pytest.importorskip("jax.numpy")
    q, kv, K, V, tK, tV = _inputs(hd, dtype, t)
    got = DA.decode_attention_ref(torch.from_numpy(q), tK, tV,
                                  torch.tensor([t], dtype=torch.int32))
    assert got.dtype == torch.float32 and got.shape == (B, H, hd)
    kernel, xla = _jax_paths(hd, dtype)
    for want in (kernel(q, K, V, jnp.int32(t)),
                 xla(q, kv, K, V, jnp.int32(t))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL[dtype])


@pytest.mark.parametrize("t", POSITIONS)
@pytest.mark.parametrize("hd", DA.HEAD_DIMS)
def test_bf16_ref_rounds_where_the_jax_kernel_rounds(hd, t):
    jnp = pytest.importorskip("jax.numpy")
    q, _, K, V, tK, tV = _inputs(hd, "bfloat16", t)
    got = DA.decode_attention_ref(torch.from_numpy(q), tK, tV,
                                  torch.tensor([t], dtype=torch.int32))
    kernel, _ = _jax_paths(hd, "bfloat16")
    np.testing.assert_allclose(got.numpy(), np.asarray(kernel(
        q, K, V, jnp.int32(t))), rtol=0, atol=1e-5)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the wrapper is the reference and counts no launch; a
    device it has no path for raises."""
    _, _, _, _, tK, tV = _inputs(64, "float32", 7)
    q = torch.randn(B, H, 64)
    before = DA.launches
    got = DA.decode_attention(q, tK, tV, torch.tensor([7], dtype=torch.int32))
    torch.testing.assert_close(got, DA.decode_attention_ref(q, tK, tV, 7),
                               rtol=0, atol=0)
    assert DA.launches == before
    with pytest.raises(ValueError):
        DA.decode_attention(q.to("meta"), tK.to("meta"), tV.to("meta"), 7)


PLAN_CASES = ([(250, 8, 132), (250, 64, 132), (399, 16, 132), (1, 1, 132),
               (17, 1000, 132)]
              + [(T_, bh, 132) for bh in (1, 8, 16, 64, 128)
                 for T_ in (1, 2, 15, 16, 17, 42, 250, 399, 1000, 4096)])


@pytest.mark.parametrize("T_,bh,sms", PLAN_CASES)
def test_split_plan_covers_every_key(T_, bh, sms):
    """The cluster plan: splits * chunk >= T with no empty split, at most
    MAX_CLUSTER splits (the portable cluster size), a split holds at least
    MIN_KEYS_PER_SPLIT keys unless T is shorter, and the ring holds a
    whole chunk in one slot or streams it through two, within RING_BYTES.
    The plan takes no position: every step of a rollout launches the same
    grid."""
    assert "t" not in inspect.signature(DA.decode_plan).parameters
    for hd in DA.HEAD_DIMS:
        for dtype in (torch.float32, torch.bfloat16, torch.int8):
            plan = DA.decode_plan(T_, bh, hd, dtype, sms)
            splits, chunk, stage, slots = plan
            assert 1 <= splits <= DA.MAX_CLUSTER
            assert splits * chunk >= T_ > (splits - 1) * chunk
            assert chunk >= min(T_, DA.MIN_KEYS_PER_SPLIT)
            row = DA.key_bytes(hd, dtype)
            if slots == 1:
                assert stage == chunk and chunk * row <= DA.RING_BYTES
            else:
                assert slots == 2 and 1 <= stage < chunk
                assert 2 * stage * row <= DA.RING_BYTES < chunk * row
            assert plan == DA.decode_plan(T_, bh, hd, dtype, sms)


@pytest.mark.parametrize("limit", [1, 3, 7])
def test_split_plan_shrinks_to_the_cards_clusters(limit):
    """The plan asks the card how many of its clusters run at once
    (cudaOccupancyMaxActiveClusters): the splits shrink until all B*H
    clusters run in one wave; where none does, to the most splits that
    fit at all; where nothing fits, it raises. Every plan still covers
    every key."""
    asked = []

    def slots(plan):
        asked.append(plan.splits)
        return 100 if plan.splits <= limit else 0

    plan = DA.decode_plan(250, 8, 256, torch.float32, 132, slots)
    assert plan.splits == limit and asked[0] == DA.MAX_CLUSTER
    assert plan.splits * plan.chunk >= 250 > (plan.splits - 1) * plan.chunk
    # One wave: 64 clusters (5 splits wanted), of which the card holds
    # 200 // splits.
    plan = DA.decode_plan(250, 64, 256, torch.float32, 132,
                          lambda p: 200 // p.splits)
    assert plan.splits == 3
    # No plan runs all 64 at once: the most splits that fit at all.
    plan = DA.decode_plan(250, 64, 256, torch.float32, 132,
                          lambda p: 10 if p.splits <= limit else 0)
    assert plan.splits == min(limit, 5)
    with pytest.raises(RuntimeError):
        DA.decode_plan(250, 8, 256, torch.float32, 132, lambda p: 0)


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


def _plan_positions(T_, plan):
    """t at 0 (only rank 0 has keys), either side of the split and stage
    edges, the TPU kernel's 256-key block edge, and T-1."""
    edges = {plan.chunk, 2 * plan.chunk, plan.stage, 2 * plan.stage, 256}
    return sorted(({0, T_ - 1} | edges | {e - 1 for e in edges})
                  & set(range(T_)))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 250, 256), (8, 8, 250, 128),
                                   (2, 8, 399, 64), (2, 2, 42, 16),
                                   (2, 2, 42, 8), (1, 8, 4096, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(shape, dtype):
    """Runs on the card only (no CUDA here). Kernel against the plain
    version at t = 0, the split and stage edges and T-1 (T = 4096 at hd
    256 streams each chunk through the two-stage ring), and with NaN past
    t."""
    dev = _cuda_or_skip()
    Bq, Hq, Tq, hd = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    tdt = getattr(torch, dtype)
    q = torch.randn(Bq, Hq, hd, device="cuda", generator=g)
    K = torch.randn(Bq, Hq, Tq, hd, device="cuda", generator=g).to(tdt)
    V = torch.randn(Bq, Hq, Tq, hd, device="cuda", generator=g).to(tdt)
    plan = DA.device_plan(Tq, Bq * Hq, hd, tdt, dev)
    if Tq == 4096:
        assert plan.slots == 2
    for t in _plan_positions(Tq, plan):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        got = DA.decode_attention(q, K, V, tt)
        want = DA.decode_attention_ref(q, K, V, tt)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL[dtype])
        Kp, Vp = K.clone(), V.clone()
        Kp[:, :, t + 1:] = float("nan")
        Vp[:, :, t + 1:] = float("nan")
        torch.testing.assert_close(DA.decode_attention(q, Kp, Vp, tt), got,
                                   rtol=0, atol=0)


def _forced_plan(monkeypatch, splits):
    """Make the wrapper run `splits` blocks a cluster, whatever T."""
    def plan(T_, bh, hd, dtype, dev):
        chunk = -(-T_ // splits)
        row = DA.key_bytes(hd, dtype)
        if chunk * row <= DA.RING_BYTES:
            return DA.DecodePlan(splits, chunk, chunk, 1)
        return DA.DecodePlan(splits, chunk, DA.RING_BYTES // (2 * row), 2)
    monkeypatch.setattr(DA, "device_plan", plan)


@pytest.mark.gpu
@pytest.mark.parametrize("splits", range(1, 9))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_every_cluster_size(monkeypatch, splits, dtype):
    """Every cluster size the plan can give (1..8), at the rollout's
    self-attention shape (1, 8, 250, 256): kernel against the plain
    version at t = 0, at the last key of rank 0 and T-1."""
    _cuda_or_skip()
    _forced_plan(monkeypatch, splits)
    g = torch.Generator(device="cuda").manual_seed(splits)
    shape = (1, 8, 250, 256)
    q = torch.randn(shape[0], shape[1], shape[3], device="cuda", generator=g)
    if dtype == "int8":
        K, V, ks, vs = _cuda_q8_cache(shape, g)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        tdt = getattr(torch, dtype)
        K = torch.randn(shape, device="cuda", generator=g).to(tdt)
        V = torch.randn(shape, device="cuda", generator=g).to(tdt)
        kw = {}
    chunk = -(-shape[2] // splits)
    for t in sorted({0, chunk - 1, chunk, shape[2] - 1}):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        got = DA.decode_attention(q, K, V, tt, **kw)
        if dtype == "int8":
            want = DA.decode_attention_q8_ref(q, K, V, ks, vs, tt)
        else:
            want = DA.decode_attention_ref(q, K, V, tt)
        torch.testing.assert_close(got, want, rtol=0,
                                   atol=TOL["bfloat16" if dtype == "int8"
                                            else dtype])


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 250, 256), (8, 8, 250, 256),
                                   (2, 2, 42, 8), (1, 8, 4096, 256)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_cuda_kernel_is_deterministic(shape, dtype):
    """Two calls give the same bits: the cluster merges its ranks in rank
    order and each block its key streams in stream order."""
    _cuda_or_skip()
    g = torch.Generator(device="cuda").manual_seed(2)
    q = torch.randn(shape[0], shape[1], shape[3], device="cuda", generator=g)
    if dtype == "int8":
        K, V, ks, vs = _cuda_q8_cache(shape, g)
        kw = dict(k_scale=ks, v_scale=vs)
    else:
        tdt = getattr(torch, dtype)
        K = torch.randn(shape, device="cuda", generator=g).to(tdt)
        V = torch.randn(shape, device="cuda", generator=g).to(tdt)
        kw = {}
    for t in (0, shape[2] // 2, shape[2] - 1):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        first = DA.decode_attention(q, K, V, tt, **kw)
        assert torch.equal(first, DA.decode_attention(q, K, V, tt, **kw))


# ---------------------------------------------------------------------------
# int8 cache
# ---------------------------------------------------------------------------

def _q8_inputs(hd, seed, B_=B):
    """q [B,H,hd] f32 and an int8 cache of quantized random tokens with
    their scales, as mha_step writes it."""
    from sea_tpu_torch.ops.attention import _quantize_token
    rs = np.random.RandomState(seed)
    q = rs.randn(B_, H, hd).astype(np.float32)
    toks = torch.from_numpy(rs.randn(2, T, B_, H, hd).astype(np.float32))
    planes, scales = [], []
    for x in toks:
        qs = [_quantize_token(x[i]) for i in range(T)]
        planes.append(torch.stack([a for a, _ in qs], dim=2))
        scales.append(torch.stack([b for _, b in qs], dim=2))
    return q, planes, scales


def test_quantize_token_matches_jax_bit_for_bit():
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops.attention import _quantize_token as jax_quantize
    from sea_tpu_torch.ops.attention import _quantize_token
    rs = np.random.RandomState(0)
    x = (rs.randn(3, 4, 64) * rs.rand(3, 4, 1) * 5).astype(np.float32)
    x[0, 0] = 0.0  # a zero token: scale 0, planes 0
    x[1, 1, :3] = [1.5, -2.5, 127.0]  # halves round to even
    got_q, got_s = _quantize_token(torch.from_numpy(x))
    # jitted, as the JAX rollout runs it (XLA folds the division by the
    # constant int_max into a multiply by its reciprocal)
    want_q, want_s = jax.jit(jax_quantize)(jnp.asarray(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert float(got_s[0, 0]) == 0.0 and not got_q[0, 0].any()


@functools.lru_cache(maxsize=None)
def _jax_q8(hd):
    import jax
    from sea_tpu.ops.decode_attention import decode_attention as jax_decode

    @jax.jit
    def kernel(q, K, V, ks, vs, t):
        return jax_decode(q, K, V, t, k_scale=ks, v_scale=vs,
                          interpret=True)

    return kernel


@pytest.mark.parametrize("hd", DA.HEAD_DIMS)
def test_q8_ref_matches_jax_kernel(hd):
    jnp = pytest.importorskip("jax.numpy")
    q, (K, V), (ks, vs) = _q8_inputs(hd, seed=hd)
    kernel = _jax_q8(hd)
    for t in POSITIONS:
        got = DA.decode_attention_q8_ref(
            torch.from_numpy(q), K, V, ks, vs,
            torch.tensor([t], dtype=torch.int32))
        # the wrapper on the CPU is the plain version
        torch.testing.assert_close(
            DA.decode_attention(torch.from_numpy(q), K, V,
                                torch.tensor([t], dtype=torch.int32),
                                k_scale=ks, v_scale=vs), got, rtol=0, atol=0)
        want = kernel(q, K.numpy(), V.numpy(), ks.numpy(), vs.numpy(),
                      jnp.int32(t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL["int8"], err_msg=f"t={t}")


def test_int8_cache_mha_steps_match_jax(monkeypatch):
    """Eight one-token steps of self-attention with RoPE on an int8 cache,
    port against JAX mha_step with its q8 kernel forced (interpret mode):
    outputs, and the planes and scales written. The same steps on f32
    caches give the rotated k/v tokens each side quantizes."""
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops import attention as JA
    from sea_tpu.ops import decode_attention as JDA
    from sea_tpu_torch.ops import attention as TA
    from sea_tpu_torch.utils.params import from_numpy
    monkeypatch.setattr(JDA, "decode_supported", lambda *a, **k: True)
    monkeypatch.setattr(JDA, "_FORCE_INTERPRET", True)
    hd, steps, C = 64, 8, H * 64
    rs = np.random.RandomState(3)
    params = {n: {"w": (rs.randn(C, C) * 0.05).astype(np.float32),
                  "b": (rs.randn(C) * 0.05).astype(np.float32)}
              for n in ("q", "k", "v")}
    params["proj"] = {"w": (rs.randn(C, C) * 0.05).astype(np.float32)}
    xs = rs.randn(steps, 2, C).astype(np.float32)
    jstep = jax.jit(lambda p, x, c, t: JA.mha_step(p, x, x, c, t,
                                                   n_heads=H, rope=True))
    jcache = JA.init_kv_cache(2, 16, H, hd, dtype=jnp.int8)
    jcache32 = JA.init_kv_cache(2, 16, H, hd)
    tparams = from_numpy(params, "cpu")
    tcache = TA.init_kv_cache(2, 16, H, hd, device="cpu", dtype=torch.int8)
    tcache32 = TA.init_kv_cache(2, 16, H, hd, device="cpu")
    for t in range(steps):
        want, jcache = jstep(params, xs[t], jcache, jnp.int32(t))
        _, jcache32 = jstep(params, xs[t], jcache32, jnp.int32(t))
        x = torch.from_numpy(xs[t])
        tt = torch.tensor([t], dtype=torch.int32)
        got = TA.mha_step(tparams, x, x, tcache, tt, n_heads=H, rope=True)
        TA.mha_step(tparams, x, x, tcache32, tt, n_heads=H, rope=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=TOL["int8"], err_msg=f"step {t}")
    # The projected and rotated tokens differ in the last f32 bits (BLAS
    # and RoPE order): a plane entry on a rounding boundary may move by
    # one. A scale is amax/127 of its token, and amax moves by at most the
    # token's largest difference, so a scale may differ by that over 127
    # plus an ulp of the rounding (each side rounds amax x (1/127) once).
    inv = np.float32(1.0 / 127.0)
    for name in ("k", "v", "k_s", "v_s"):
        got, want = tcache[name].numpy(), np.asarray(jcache[name])
        if name.endswith("_s"):
            tok = name[0]
            dtok = np.abs(tcache32[tok].numpy().astype(np.float64)
                          - np.asarray(jcache32[tok], np.float64)).max(-1)
            tol = dtok * inv + np.spacing(np.maximum(np.abs(got),
                                                     np.abs(want)))
            diff = np.abs(got.astype(np.float64) - want)
            assert (diff <= tol).all(), (
                f"{name}: off by {diff.max():.3g} where the tokens allow "
                f"{tol[diff > tol].min():.3g}")
        else:
            diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() < 0.01, name


def _cuda_q8_cache(shape, g):
    """Random int8 planes and small positive per-token scales on the
    card."""
    K = torch.randint(-127, 128, shape, device="cuda", generator=g,
                      dtype=torch.int8)
    V = torch.randint(-127, 128, shape, device="cuda", generator=g,
                      dtype=torch.int8)
    ks = torch.rand(shape[:3], device="cuda", generator=g) * 0.02
    vs = torch.rand(shape[:3], device="cuda", generator=g) * 0.02
    return K, V, ks, vs


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 250, 256), (8, 8, 250, 256),
                                   (8, 8, 250, 128), (2, 8, 399, 64),
                                   (2, 2, 42, 16), (2, 2, 42, 8),
                                   (1, 8, 4096, 256)])
def test_cuda_q8_kernel_matches_ref(shape):
    """Runs on the card only. The int8 kernel against its plain version at
    t = 0, the split and stage edges and T-1, and at odd t (at hd 8 a key
    row is 8 bytes, so a block's copies start off 16 bytes); NaN scales
    past t must not change it."""
    dev = _cuda_or_skip()
    Bq, Hq, Tq, hd = shape
    g = torch.Generator(device="cuda").manual_seed(1)
    q = torch.randn(Bq, Hq, hd, device="cuda", generator=g)
    K, V, ks, vs = _cuda_q8_cache(shape, g)
    plan = DA.device_plan(Tq, Bq * Hq, hd, torch.int8, dev)
    odd = {1, 3, 17, 41} if hd == 8 else set()
    for t in sorted(set(_plan_positions(Tq, plan)) | (odd & set(range(Tq)))):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        got = DA.decode_attention(q, K, V, tt, k_scale=ks, v_scale=vs)
        want = DA.decode_attention_q8_ref(q, K, V, ks, vs, tt)
        # The kernel rounds p * v_scale against each stream's running max,
        # the plain version against the global max: bf16 order, as for the
        # bf16 cache.
        torch.testing.assert_close(got, want, rtol=0, atol=TOL["bfloat16"])
        ksn, vsn = ks.clone(), vs.clone()
        ksn[:, :, t + 1:] = float("nan")
        vsn[:, :, t + 1:] = float("nan")
        torch.testing.assert_close(
            DA.decode_attention(q, K, V, tt, k_scale=ksn, v_scale=vsn), got,
            rtol=0, atol=0)
