"""The flash-decode wrapper of the port (sea_tpu_torch/ops/decode_attention).

On the CPU: the plain version ``decode_attention_ref`` against the JAX
Pallas kernel in interpret mode and against the XLA path of JAX
``mha_step`` it replaces, for every head dim the kernel takes, f32 and bf16
caches, at the first position, both sides of the TPU kernel's 256-key
block edge, and the last position. Tolerances: atol 1e-5 for f32 (summation
order), 2e-2 for bf16 (the kernel and the reference round q and the
probabilities to bf16; the XLA path does not round q).

The CUDA kernel itself runs only on the card: its test is marked ``gpu``
and skips here. The card has no JAX, so this module imports JAX only
inside the tests that compare against it; there,
``python -m pytest tests/test_torch_decode_attention.py --noconftest -m gpu``
runs the kernel test (tests/conftest.py imports JAX).
"""

import functools

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops import decode_attention as DA

torch.set_num_threads(2)

B, H, T = 1, 2, 260
POSITIONS = (0, 255, 256, T - 1)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


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


@pytest.mark.parametrize("T_,bh,sms", [(250, 8, 132), (250, 64, 132),
                                       (399, 16, 132), (1, 1, 132),
                                       (17, 1000, 132)])
def test_split_plan_covers_every_key(T_, bh, sms):
    """The merge kernel assumes splits * chunk >= T with no empty split;
    a split holds at least MIN_KEYS_PER_SPLIT keys unless T is shorter."""
    splits, chunk = DA.split_plan(T_, bh, sms)
    assert splits * chunk >= T_ > (splits - 1) * chunk
    assert chunk >= min(T_, DA.MIN_KEYS_PER_SPLIT)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 8, 250, 256), (8, 8, 250, 128),
                                   (2, 8, 399, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_ref(shape, dtype):
    """Runs on the card only (no CUDA here). Kernel against the plain
    version at every position class, and with NaN past t."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    Bq, Hq, Tq, hd = shape
    g = torch.Generator(device="cuda").manual_seed(0)
    tdt = getattr(torch, dtype)
    q = torch.randn(Bq, Hq, hd, device="cuda", generator=g)
    K = torch.randn(Bq, Hq, Tq, hd, device="cuda", generator=g).to(tdt)
    V = torch.randn(Bq, Hq, Tq, hd, device="cuda", generator=g).to(tdt)
    chunk = DA.split_plan(Tq, Bq * Hq, torch.cuda.get_device_properties(
        0).multi_processor_count)[1]
    for t in sorted({0, chunk - 1, chunk, 255, Tq - 1} & set(range(Tq))):
        tt = torch.tensor([t], dtype=torch.int32, device="cuda")
        got = DA.decode_attention(q, K, V, tt)
        want = DA.decode_attention_ref(q, K, V, tt)
        torch.testing.assert_close(got, want, rtol=0, atol=TOL[dtype])
        Kp, Vp = K.clone(), V.clone()
        Kp[:, :, t + 1:] = float("nan")
        Vp[:, :, t + 1:] = float("nan")
        torch.testing.assert_close(DA.decode_attention(q, Kp, Vp, tt), got,
                                   rtol=0, atol=0)
