"""The flash-attention wrapper of the port (sea_tpu_torch/ops/flash_attention).

On the CPU: the plain version ``flash_attention_ref`` and its gradients
against the JAX package's Pallas kernels (forward, dQ, dK/dV) run in
interpret mode through their public custom-VJP entry, with dropout off
and at rate 0.1, causal and not, Tq != Tk with src_len > 0, and a T past
the TPU kernel's 128-row block. The dropout mask is held bit for bit to
the TPU mask kernel's dense output. The plain forward/backward pieces the
card compares its kernels with (lse, dQ, dK/dV from D) are held to
autograd. Tolerances: atol 2e-5 for outputs and 5e-5 for gradients, the
bounds of tests/test_flash_attention.py (f32, summation order); a
dropped or kept element the other side disagrees on is off by about
|v|/(1-rate), far outside them.

The CUDA kernels run only on the card: their tests are marked ``gpu`` and
skip here. The card has no JAX, so JAX is imported only inside the tests
that compare against it; there,
``python -m pytest tests/test_torch_flash_attention.py --noconftest -m gpu``
runs the kernel tests.
"""

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops import flash_attention as FA

torch.set_num_threads(2)

OUT_ATOL = 2e-5
GRAD_ATOL = 5e-5
SEED = (123456789, -987654321)

# (B, Tq, Tk, H, hd, causal, src_len, rate)
CASES = {
    "causal": (2, 40, 40, 2, 16, True, 0, 0.0),
    "causal_dropout": (2, 40, 40, 2, 16, True, 0, 0.1),
    "past_block_dropout": (1, 131, 131, 2, 8, True, 0, 0.1),
    "src_len_tq_ne_tk": (2, 24, 40, 2, 16, True, 5, 0.1),
    "full_tq_ne_tk": (1, 40, 24, 2, 16, False, 0, 0.1),
}


def _inputs(B, Tq, Tk, H, hd, seed=0):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, Tq, H, hd).astype(np.float32)
    k = rs.randn(B, Tk, H, hd).astype(np.float32)
    v = rs.randn(B, Tk, H, hd).astype(np.float32)
    g = rs.randn(B, Tq, H, hd).astype(np.float32)
    return q, k, v, g


def _port(q, k, v, g, causal, src_len, rate):
    t = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = FA.flash_attention(*t, causal, src_len, dropout_rate=rate,
                             dropout_seed=SEED if rate else None)
    out.backward(torch.from_numpy(g))
    return out.detach().numpy(), [x.grad.numpy() for x in t]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ref_matches_jax_kernels(name, monkeypatch):
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, Tq, Tk, H, hd, causal, src_len, rate = CASES[name]
    q, k, v, g = _inputs(B, Tq, Tk, H, hd)
    seed = jnp.asarray(SEED, jnp.int32) if rate else None

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal, src_len,
                                   dropout_rate=rate, dropout_seed=seed)

    want, vjp = jax.vjp(f, *map(jnp.asarray, (q, k, v)))
    want_grads = vjp(jnp.asarray(g))
    got, got_grads = _port(q, k, v, g, causal, src_len, rate)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=OUT_ATOL)
    for gname, a, b in zip("qkv", got_grads, want_grads):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=GRAD_ATOL,
                                   err_msg=f"d{gname}")


def test_dropout_mask_matches_jax_mask_kernel(monkeypatch):
    """Bit for bit against the TPU kernel's dense mask (interpret mode),
    over two 128-blocks of queries and keys."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    B, H, Tq, Tk, rate = 2, 3, 150, 140, 0.1
    want = np.asarray(jfa._dropout_mask_dense(
        B * H, Tq, Tk, jnp.asarray(SEED, jnp.int32), rate, block_q=128,
        block_k=128, interpret=True))[:, :Tq, :Tk]
    got = FA.dropout_mask(B, H, Tq, Tk, SEED, rate, "cpu").reshape(
        B * H, Tq, Tk).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0.08 < (got == 0).mean() < 0.12


def test_dense_mask_with_bh_map_matches_jax_mask_kernel():
    """dropout_mask_dense on the CPU (the mask kernel's plain version) with
    a bh_map, bit for bit against the TPU mask kernel in interpret mode;
    the port returns the logical region, the TPU kernel a padded one."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    BH, Tq, Tk, rate = 4, 20, 33, 0.2
    bh_map = np.array([6, 1, 3, 0], np.int32)
    want = np.asarray(jfa._dropout_mask_dense(
        BH, Tq, Tk, jnp.asarray(SEED, jnp.int32), rate, interpret=True,
        bh_map=jnp.asarray(bh_map)))
    before = FA.mask_launches
    got = FA.dropout_mask_dense(BH, Tq, Tk, SEED, rate, "cpu",
                                bh_map=torch.from_numpy(bh_map))
    assert got.shape == (BH, Tq, Tk) and FA.mask_launches == before
    np.testing.assert_array_equal(got.numpy(), want[:, :Tq, :Tk])


@pytest.mark.parametrize("name", ["causal_dropout", "src_len_tq_ne_tk",
                                  "full_tq_ne_tk"])
def test_plain_kernel_pieces_match_autograd(name):
    """lse, D, dQ and dK/dV of the plain pieces the card holds its
    kernels to equal autograd through flash_attention_ref."""
    B, Tq, Tk, H, hd, causal, src_len, rate = CASES[name]
    q, k, v, g = _inputs(B, Tq, Tk, H, hd, seed=1)
    kw = dict(causal=causal, src_len=src_len, dropout_rate=rate,
              dropout_seed=SEED)
    got, grads = _port(q, k, v, g, causal, src_len, rate)
    q, k, v, g = map(torch.from_numpy, (q, k, v, g))
    o, lse = FA.flash_forward_ref(q, k, v, **kw)
    np.testing.assert_allclose(o.numpy(), got, rtol=0, atol=0)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * hd ** -0.5
    s = s.masked_fill(~FA._valid(Tq, Tk, causal, src_len, "cpu"),
                      float("-inf"))
    np.testing.assert_allclose(
        lse.numpy(), torch.logsumexp(s, -1).reshape(B * H, Tq).numpy(),
        rtol=0, atol=1e-6)
    dsum = FA.row_dot(g, o)
    dq = FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw)
    dk, dv = FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum, **kw)
    for a, b in zip((dq, dk, dv), grads):
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=GRAD_ATOL)


def test_cpu_tensors_take_the_plain_version():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 8, 8, 2, 64))
    before = (FA.fwd_launches, FA.dq_launches, FA.dkv_launches)
    got = FA.flash_attention(q, k, v, dropout_rate=0.1, dropout_seed=SEED)
    torch.testing.assert_close(got, FA.flash_attention_ref(
        q, k, v, dropout_rate=0.1, dropout_seed=SEED), rtol=0, atol=0)
    assert (FA.fwd_launches, FA.dq_launches, FA.dkv_launches) == before
    with pytest.raises(ValueError, match="dropout_seed"):
        FA.flash_attention(q, k, v, dropout_rate=0.1)
    with pytest.raises(ValueError):
        FA.flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))


def _projection(rs, E, n):
    return {"w": torch.from_numpy(rs.randn(E, n * E).astype(np.float32)),
            "b": torch.from_numpy(rs.randn(n * E).astype(np.float32))}


@pytest.mark.parametrize("layout", ["unfused", "qkv", "kv"])
def test_mha_views_keep_the_alignment_rule(layout):
    """The q, k, v views ops.attention.mha hands the kernels, fused qkv and
    kv column slices of one projection included, keep the forward
    kernel's 16-byte rule (start and strides in whole 4-float steps)."""
    from sea_tpu_torch.ops import attention as A
    B, T, E, H = 2, 5, 64, 2
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(B, T, E).astype(np.float32))
    params = {"unfused": {n: _projection(rs, E, 1) for n in "qkv"},
              "qkv": {"qkv": _projection(rs, E, 3)},
              "kv": {"q": _projection(rs, E, 1),
                     "kv": _projection(rs, E, 2)}}[layout]
    views = A._project_qkv(params, x, x)
    if layout != "unfused":
        assert not views[-1].is_contiguous()
    for name, y in zip("qkv", views):
        FA._check_aligned(name, y.reshape(B, T, H, E // H))


def _strided_view(case, device="cpu"):
    """[2, 6, 2, 64] views: aligned, or breaking the 16-byte rule."""
    def zeros(*shape):
        return torch.zeros(shape, device=device)
    return {
        "offset_16_bytes": lambda: zeros(2, 6, 2, 72)[..., 4:68],
        "size_1_dim_any_stride": lambda: zeros(2, 1, 2, 64).as_strided(
            (2, 1, 2, 64), (128, 3, 64, 1)),
        "offset_4_bytes": lambda: zeros(2, 6, 2, 72)[..., 1:65],
        "time_stride_130": lambda: zeros(2, 6, 130)[..., :128].reshape(
            2, 6, 2, 64),
        "head_stride_66": lambda: zeros(2, 6, 2, 66)[..., :64],
    }[case]()


@pytest.mark.parametrize("case", ["offset_16_bytes", "size_1_dim_any_stride",
                                  "offset_4_bytes", "time_stride_130",
                                  "head_stride_66"])
def test_alignment_rule(case):
    x = _strided_view(case)
    if case in ("offset_16_bytes", "size_1_dim_any_stride"):
        FA._check_aligned("q", x)
    else:
        with pytest.raises(ValueError, match="16-byte"):
            FA._check_aligned("q", x)


@pytest.mark.parametrize("case", ["offset_16_bytes", "size_1_dim_any_stride",
                                  "offset_4_bytes", "time_stride_130",
                                  "head_stride_66"])
def test_grad_alignment_rule(case):
    """dO reaches the backward kernels' 16-byte copies as it is when it
    keeps the rule, and as a contiguous copy of the same values when it
    breaks it (autograd picks its layout, so it is not refused)."""
    x = _strided_view(case)
    x.copy_(torch.arange(x.numel(), dtype=torch.float32).reshape(x.shape))
    got = FA._grad_input(x)
    if case in ("offset_16_bytes", "size_1_dim_any_stride"):
        assert got is x
    else:
        assert got.is_contiguous() and got.data_ptr() != x.data_ptr()
        assert FA._misaligned(got) is None
        torch.testing.assert_close(got, x, rtol=0, atol=0)
    assert FA._grad_input(x.double()).dtype == torch.float32


def _cuda_inputs(B, Tq, Tk, H, hd):
    g = torch.Generator(device="cuda").manual_seed(B * Tq + Tk + hd)
    return [torch.randn(B, T, H, hd, device="cuda", generator=g)
            for T in (Tq, Tk, Tk, Tq)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 399, 8, 128, 0),
                                   (2, 399, 399, 8, 64, 0),
                                   (4, 199, 199, 8, 256, 0),
                                   (1, 1, 1, 8, 64, 0),
                                   (2, 70, 130, 8, 128, 5),
                                   (3, 37, 53, 8, 128, 5),
                                   (2, 37, 53, 8, 256, 5),
                                   (2, 41, 41, 2, 16, 0),
                                   (2, 41, 41, 2, 8, 0),
                                   (3, 37, 53, 2, 16, 5),
                                   (3, 37, 53, 2, 8, 5)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_kernels_match_ref(shape, rate):
    """Runs on the card only. Output and dq/dk/dv through the autograd
    wrapper, and each kernel alone against its plain piece. The last
    three wide shapes are Tq != Tk with src_len 5 (keys past Tq + 4 get no
    gradient), the last two with a Tq that ends inside a warp's 16 rows,
    at hd 128 and 256; then the smoke presets' hd 16 and 8, square and
    ragged."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, Tq, Tk, H, hd, src_len = shape
    q, k, v, g = _cuda_inputs(B, Tq, Tk, H, hd)
    kw = dict(causal=True, src_len=src_len, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    grads = []
    for fn in (FA.flash_attention, FA.flash_attention_ref):
        t = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*t, **kw)
        out.backward(g)
        grads.append([out.detach()] + [x.grad for x in t])
    torch.testing.assert_close(grads[0][0], grads[1][0], rtol=0,
                               atol=OUT_ATOL)
    for a, b in zip(grads[0][1:], grads[1][1:]):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_ATOL)
    o, lse = FA.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
    dsum = FA.row_dot(g, o_ref)
    torch.testing.assert_close(
        FA.flash_bwd_dq(q, k, v, g, lse_ref, dsum, **kw),
        FA.flash_bwd_dq_ref(q, k, v, g, lse_ref, dsum, **kw), rtol=0,
        atol=GRAD_ATOL)
    for a, b in zip(FA.flash_bwd_dkv(q, k, v, g, lse_ref, dsum, **kw),
                    FA.flash_bwd_dkv_ref(q, k, v, g, lse_ref, dsum, **kw)):
        torch.testing.assert_close(a, b, rtol=0, atol=GRAD_ATOL)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(1, 517, 517, 2, 128, True, 0),
                                   (1, 517, 517, 2, 64, True, 0),
                                   (1, 263, 300, 2, 256, True, 37),
                                   (2, 301, 150, 2, 64, False, 0),
                                   (1, 130, 517, 2, 16, True, 3)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_backward_long_band_is_deterministic(shape, rate):
    """Runs on the card only. Bands long enough that the two warp groups
    of a block split the walk over many tiles (the first key tile walks
    all 517 queries, the last q tile all its keys), with Tq and Tk not
    multiples of any tile, src_len > 0, and the full (non-causal) form:
    dQ and dK/dV against their plain pieces; a second call gives the same
    bits (the groups' sums meet in a fixed order, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, Tq, Tk, H, hd, causal, src_len = shape
    q, k, v, g = _cuda_inputs(B, Tq, Tk, H, hd)
    kw = dict(causal=causal, src_len=src_len, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    o, lse = FA.flash_forward_ref(q, k, v, **kw)
    dsum = FA.row_dot(g, o)
    runs = [(FA.flash_bwd_dq(q, k, v, g, lse, dsum, **kw),
             *FA.flash_bwd_dkv(q, k, v, g, lse, dsum, **kw))
            for _ in range(2)]
    want = (FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw),
            *FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum, **kw))
    for name, a, b, c in zip(("dq", "dk", "dv"), *runs, want):
        assert torch.equal(a, b), f"{name}: a second call differs"
        torch.testing.assert_close(a, c, rtol=0, atol=GRAD_ATOL,
                                   msg=lambda m, n=name: f"{n}: {m}")


@pytest.mark.gpu
def test_cuda_rejects_unported_head_dim():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, _ = _cuda_inputs(1, 16, 16, 2, 32)
    with pytest.raises(ValueError, match="head dim"):
        FA.flash_attention(q, k, v)


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["offset_4_bytes", "time_stride_130"])
def test_cuda_refuses_misaligned_views(case):
    """A view the forward kernel's 16-byte copies cannot take raises
    ValueError on the card; nothing is copied to fix it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q = _strided_view(case, "cuda")
    k, v = _cuda_inputs(2, 6, 6, 2, 64)[1:3]
    assert q.data_ptr() % 16 == (4 if case == "offset_4_bytes" else 0)
    before = FA.fwd_launches
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, k, v)
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_fwd(q, k, v)
    assert FA.fwd_launches == before


@pytest.mark.gpu
@pytest.mark.parametrize("with_map", [False, True])
def test_cuda_dense_mask_matches_ref(with_map):
    """Runs on the card only: the mask kernel against its plain version,
    bit for bit, at the dropout verification's shape and a ragged one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for BH, Tq, Tk in ((8, 512, 512), (3, 70, 130)):
        bh_map = (torch.randperm(BH, device="cuda").to(torch.int32)
                  if with_map else None)
        got = FA.dropout_mask_dense(BH, Tq, Tk, SEED, 0.1, "cuda",
                                    bh_map=bh_map)
        ref_map = (bh_map if with_map else
                   torch.arange(BH, dtype=torch.int32, device="cuda"))
        want = FA.dropout_mask_dense_ref(ref_map, Tq, Tk, SEED, 0.1)
        assert torch.equal(got, want)
