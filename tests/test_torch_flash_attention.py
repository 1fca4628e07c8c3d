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

bf16: the plain versions (their rounding points: the unnormalised p to
v's dtype, dS to k's and q's, P.M to dO's) against the JAX kernels on bf16
inputs in interpret mode, and the bf16 kernels against the plain versions
on the card. Tolerances there, relative to the largest |value| of the
reference: BF16_TOL_OUT = 2^-7 for o and BF16_TOL_GRAD = 2^-6 for dq, dk
and dv (on the card plus the f32 bounds above, for the order of the f32
sums where the values are near 0). A bf16 value carries 8 significant bits, so rounding it once is
off by up to 2^-9 of the largest value and one ulp of it by up to 2^-8
(2^-7 of a value in the top binade's lower half); the kernels round p
under the running max of their key tiles, the plain version under the
row's final max, which moves a bf16 result by an ulp here and there, and
the gradients sum such rounded terms over the keys or queries before
their own rounding, hence a binade more. On the CPU the plain versions
meet the JAX kernels within 4e-7 of the largest value (a JAX key tile
spans up to 512 keys, so at these T it takes the row's max, as the plain
version does); a missed rounding point shows as a spread of rounding
errors of up to 2^-9 over the elements.

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
BF16_TOL_OUT = 2.0 ** -7
BF16_TOL_GRAD = 2.0 ** -6
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


def _close_to_max(got, want, rel, what):
    """|got - want| <= rel * max|want| (both read as f32)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    err = np.abs(got - want).max()
    bound = rel * np.abs(want).max()
    assert err <= bound, f"{what}: max abs err {err} > {rel} x max|ref|"


# (B, Tq, Tk, H, hd, causal, src_len, rate) of the bf16 cases: hd 16 and 64,
# causal, dropout 0 and 0.1, one past the JAX kernels' 128-key tile.
BF16_CASES = {
    "hd16": (2, 40, 40, 2, 16, True, 0, 0.0),
    "hd16_dropout": (2, 40, 40, 2, 16, True, 0, 0.1),
    "hd64_dropout_past_block": (1, 150, 150, 2, 64, True, 0, 0.1),
    "hd64_src_len_tq_ne_tk": (2, 24, 40, 2, 64, True, 5, 0.0),
}


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_ref_matches_jax_kernels(name, monkeypatch):
    """The bf16 plain versions (the CPU path: forward and backward pieces
    in the kernels' autograd Function) against the JAX kernels on the same
    bf16 inputs in interpret mode: o, lse, dq, dk, dv, each returned in
    bf16."""
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, Tq, Tk, H, hd, causal, src_len, rate = BF16_CASES[name]
    arrays = [jnp.asarray(a, jnp.bfloat16)
              for a in _inputs(B, Tq, Tk, H, hd)]
    seed = jnp.asarray(SEED, jnp.int32) if rate else None

    def f(q, k, v):
        return jfa.flash_attention(q, k, v, causal, src_len,
                                   dropout_rate=rate, dropout_seed=seed)

    want, vjp = jax.vjp(f, *arrays[:3])
    want_grads = vjp(arrays[3])
    _, want_lse = jfa._flash_forward(
        *arrays[:3], causal=causal, src_len=src_len,
        block_q=jfa.DEFAULT_BLOCK_Q, block_k=jfa.DEFAULT_BLOCK_K,
        return_lse=True, dropout_rate=rate, seed=seed)
    q, k, v, g = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in arrays)
    t = [x.clone().requires_grad_(True) for x in (q, k, v)]
    kw = dict(dropout_rate=rate, dropout_seed=SEED if rate else None)
    out = FA.flash_attention(*t, causal, src_len, **kw)
    out.backward(g)
    assert out.dtype == torch.bfloat16
    assert all(x.grad.dtype == torch.bfloat16 for x in t)
    f32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))  # noqa: E731
    _close_to_max(out.detach().float().numpy(), f32(want), BF16_TOL_OUT, "o")
    _, lse = FA.flash_forward_ref(q, k, v, causal=causal, src_len=src_len,
                                  **kw)
    np.testing.assert_allclose(
        lse.numpy(), f32(want_lse)[:, :Tq, 0], rtol=0, atol=1e-5)
    for gname, a, b in zip("qkv", t, want_grads):
        _close_to_max(a.grad.float().numpy(), f32(b), BF16_TOL_GRAD,
                      f"d{gname}")


def _split_walk_forward(q, k, v, causal, src_len, rate, bk=64):
    """A model of the bf16 forward kernel's wgmma form (hd 64 to 256): two
    consumer groups walk the even and the odd key tiles of bk keys, each
    rounding p = exp(s - m) M to bf16 under its own running max, and their
    (m, l, O) meet in f32, group 0's first. Returns (o bf16, lse f32
    [B*H, Tq])."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    valid = FA._valid(Tq, Tk, causal, src_len, "cpu")
    s = FA._scores(q, k, causal, src_len).masked_fill(~valid, -1e30)
    mask = (FA.dropout_mask(B, H, Tq, Tk, SEED, rate, "cpu") if rate
            else torch.ones_like(s))
    vf = v.float().permute(0, 2, 1, 3)  # [B, H, Tk, hd]
    walks = []
    for group in (0, 1):
        m = torch.full((B, H, Tq, 1), -1e30)
        l = torch.zeros((B, H, Tq, 1))
        acc = torch.zeros((B, H, Tq, hd))
        for k0 in range(group * bk, Tk, 2 * bk):
            st, ok = s[..., k0:k0 + bk], valid[:, k0:k0 + bk]
            m_new = torch.maximum(m, st.amax(-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.where(ok, torch.exp(st - m_new), 0.0)
            l = l * alpha + p.sum(-1, keepdim=True)
            pm = (p * mask[..., k0:k0 + bk]).to(torch.bfloat16).float()
            acc = acc * alpha + pm @ vf[:, :, k0:k0 + bk]
            m = m_new
        walks.append((m, l, acc))
    (m0, l0, o0), (m1, l1, o1) = walks
    m = torch.maximum(m0, m1)
    a0, a1 = torch.exp(m0 - m), torch.exp(m1 - m)
    l = l0 * a0 + l1 * a1
    o = (o0 * a0 + o1 * a1) / torch.where(l == 0, 1.0, l)
    lse = (m + torch.log(torch.where(l == 0, 1.0, l))).reshape(B * H, Tq)
    return o.permute(0, 2, 1, 3).to(torch.bfloat16), lse


@pytest.mark.parametrize("name", sorted(BF16_CASES))
def test_bf16_split_walk_matches_jax_kernel(name, monkeypatch):
    """The rounding of the bf16 forward kernel's two-group walk (a model of
    it, _split_walk_forward) against the JAX forward kernel on the same
    bf16 inputs in interpret mode: o within BF16_TOL_OUT x max|ref|, lse
    within 1e-5. p rounded under each group's running max over its even
    or odd 64-key tiles, and the f32 merge, stay within the bound the
    card holds the kernel to."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, Tq, Tk, H, hd, causal, src_len, rate = BF16_CASES[name]
    arrays = [jnp.asarray(a, jnp.bfloat16)
              for a in _inputs(B, Tq, Tk, H, hd)[:3]]
    seed = jnp.asarray(SEED, jnp.int32) if rate else None
    want, want_lse = jfa._flash_forward(
        *arrays, causal=causal, src_len=src_len,
        block_q=jfa.DEFAULT_BLOCK_Q, block_k=jfa.DEFAULT_BLOCK_K,
        return_lse=True, dropout_rate=rate, seed=seed)
    q, k, v = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in arrays)
    o, lse = _split_walk_forward(q, k, v, causal, src_len, rate)
    assert o.dtype == torch.bfloat16
    _close_to_max(o.float().numpy(),
                  np.asarray(jnp.asarray(want, jnp.float32)), BF16_TOL_OUT,
                  "o")
    np.testing.assert_allclose(
        lse.numpy(), np.asarray(want_lse, np.float32)[:, :Tq, 0], rtol=0,
        atol=1e-5)


# (keys a dQ tile walks, queries a dK/dV tile walks, dK/dV's d split
# between its two consumer groups) of the bf16 backward kernels' wgmma
# forms, by head dim: the dispatch in csrc/flash_attention.cu.
BWD_WALK = {64: (64, 64, False), 128: (64, 32, False), 256: (32, 32, True)}
# (B, Tq, Tk, H, hd, causal, src_len, rate): three or more walked tiles a
# block, so both consumer groups walk two or more.
BWD_WALK_CASES = {
    "hd64": (1, 150, 150, 2, 64, True, 0, 0.0),
    "hd64_dropout": (1, 150, 150, 2, 64, True, 0, 0.1),
    "hd128": (1, 150, 150, 2, 128, True, 0, 0.0),
    "hd128_dropout_src_len": (1, 150, 130, 2, 128, True, 5, 0.1),
    "hd256": (1, 150, 150, 2, 256, True, 0, 0.0),
    "hd256_dropout": (1, 150, 150, 2, 256, True, 0, 0.1),
}


def _split_walk_backward(q, k, v, g, o, lse, causal, src_len, rate):
    """A model of the order of the f32 sums in the bf16 backward kernels'
    wgmma forms (hd 64 to 256), from the forward's o and lse [B*H, Tq]: P,
    P M and dS = P (M dP - D) as the plain pieces form them, P M and dS
    rounded to bf16. A dQ block (64 q rows) has its two consumer groups
    walk the even and the odd key tiles of its band, a dK/dV block (64
    keys) the even and the odd q tiles from the first in its band, each
    group summing its tiles' products in f32 in walk order and group 1's
    sum added to group 0's; where dK/dV splits d (hd 256), each group walks
    every q tile for its half of the columns, so a column sums all tiles
    in order. Returns (dq, dk, dv) in bf16."""
    B, Tq, H, hd = q.shape
    Tk = k.shape[1]
    bk, bq, dsplit = BWD_WALK[hd]
    pm, ds = FA._bwd_ref_pieces(q, k, v, g, lse, FA.row_dot(g, o), causal,
                                src_len, rate, SEED if rate else None)
    pm, ds = (x.to(torch.bfloat16).float() for x in (pm, ds))
    qf, kf, gf = (x.float().permute(0, 2, 1, 3) for x in (q, k, g))
    dq = torch.zeros(B, H, Tq, hd)
    for q0 in range(0, Tq, 64):
        end = min(Tk, q0 + 64 + src_len) if causal else Tk
        sums = [torch.zeros(B, H, min(64, Tq - q0), hd) for _ in range(2)]
        for j, k0 in enumerate(range(0, end, bk)):
            sums[j % 2] += ds[:, :, q0:q0 + 64, k0:k0 + bk] @ \
                kf[:, :, k0:k0 + bk]
        dq[:, :, q0:q0 + 64] = sums[0] + sums[1]
    dk = torch.zeros(B, H, Tk, hd)
    dv = torch.zeros(B, H, Tk, hd)
    for k0 in range(0, Tk, 64):
        first = (max(0, k0 - src_len) if causal else 0) // bq * bq
        n = min(64, Tk - k0)
        gk = [torch.zeros(B, H, n, hd) for _ in range(2)]
        gv = [torch.zeros(B, H, n, hd) for _ in range(2)]
        for j, t0 in enumerate(range(first, Tq, bq)):
            grp = 0 if dsplit else j % 2
            gk[grp] += ds[:, :, t0:t0 + bq, k0:k0 + 64].transpose(2, 3) @ \
                qf[:, :, t0:t0 + bq]
            gv[grp] += pm[:, :, t0:t0 + bq, k0:k0 + 64].transpose(2, 3) @ \
                gf[:, :, t0:t0 + bq]
        dk[:, :, k0:k0 + 64] = gk[0] if dsplit else gk[0] + gk[1]
        dv[:, :, k0:k0 + 64] = gv[0] if dsplit else gv[0] + gv[1]
    scale = hd ** -0.5
    return tuple(x.permute(0, 2, 1, 3).to(torch.bfloat16)
                 for x in (dq * scale, dk * scale, dv))


@pytest.mark.parametrize("name", sorted(BWD_WALK_CASES))
def test_bf16_split_walk_backward_matches_jax_kernels(name, monkeypatch):
    """The order of sums of the bf16 backward kernels' two-group walks (a
    model of it, _split_walk_backward: even and odd tiles a group, group
    1's sum added to group 0's, the d split at hd 256) against JAX's
    _flash_backward on the same bf16 inputs, o and lse in interpret mode:
    dq, dk and dv within BF16_TOL_GRAD x max|ref|, the bound
    test_bf16_ref_matches_jax_kernels holds the plain versions to."""
    import jax.numpy as jnp
    from sea_tpu.ops import flash_attention as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    B, Tq, Tk, H, hd, causal, src_len, rate = BWD_WALK_CASES[name]
    arrays = [jnp.asarray(a, jnp.bfloat16)
              for a in _inputs(B, Tq, Tk, H, hd)]
    seed = jnp.asarray(SEED, jnp.int32) if rate else None
    kw = dict(causal=causal, src_len=src_len, block_q=jfa.DEFAULT_BLOCK_Q,
              block_k=jfa.DEFAULT_BLOCK_K, dropout_rate=rate, seed=seed)
    o, lse = jfa._flash_forward(*arrays[:3], return_lse=True, **kw)
    want = jfa._flash_backward(*arrays[:3], o, lse, arrays[3], **kw)
    q, k, v, g, o = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        torch.bfloat16) for a in (*arrays, o))
    lse = torch.from_numpy(np.array(lse, np.float32)[:, :Tq, 0])
    got = _split_walk_backward(q, k, v, g, o, lse, causal, src_len, rate)
    for gname, a, b in zip("qkv", got, want):
        assert a.dtype == torch.bfloat16
        _close_to_max(a.float().numpy(),
                      np.asarray(jnp.asarray(b, jnp.float32)),
                      BF16_TOL_GRAD, f"d{gname}")


def test_bf16_pieces_round_where_the_kernels_do():
    """The bf16 plain forward rounds exp(s - m) M to bf16 before P.V and
    divides by the f32 denominator after; the backward pieces round dS and
    P.M before their products: the same formulas with those roundings
    written out in f32 give the same values."""
    B, Tq, Tk, H, hd = 1, 12, 12, 2, 16
    q, k, v, g = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(B, Tq, Tk, H, hd, seed=3))
    kw = dict(causal=True, src_len=0, dropout_rate=0.1, dropout_seed=SEED)
    o, lse = FA.flash_forward_ref(q, k, v, **kw)
    s = FA._scores(q, k, True, 0)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    m = FA.dropout_mask(B, H, Tq, Tk, SEED, 0.1, "cpu")
    pv = torch.einsum("bhqk,bkhd->bqhd", (p * m).to(torch.bfloat16).float(),
                      v.float())
    want = (pv / p.sum(-1, keepdim=True).permute(0, 2, 1, 3)).to(
        torch.bfloat16)
    assert o.dtype == torch.bfloat16 and torch.equal(o, want)
    dsum = FA.row_dot(g, o)
    pm, ds = FA._bwd_ref_pieces(q, k, v, g, lse, dsum, True, 0, 0.1, SEED)
    dq = FA.flash_bwd_dq_ref(q, k, v, g, lse, dsum, **kw)
    dk, dv = FA.flash_bwd_dkv_ref(q, k, v, g, lse, dsum, **kw)
    scale = hd ** -0.5
    rounded = ds.to(torch.bfloat16).float()
    assert torch.equal(dq, (torch.einsum("bhqk,bkhd->bqhd", rounded,
                                         k.float()) * scale).bfloat16())
    assert torch.equal(dk, (torch.einsum("bhqk,bqhd->bkhd", rounded,
                                         q.float()) * scale).bfloat16())
    assert torch.equal(dv, torch.einsum(
        "bhqk,bqhd->bkhd", pm.to(torch.bfloat16).float(),
        g.float()).bfloat16())


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
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_backward_long_band_is_deterministic(shape, rate, dtype):
    """Runs on the card only. Bands long enough that the two warp groups
    of a block split the walk over many tiles (the first key tile walks
    all 517 queries, the last q tile all its keys), with Tq and Tk not
    multiples of any tile, src_len > 0, and the full (non-causal) form:
    dQ and dK/dV against their plain pieces; a second call gives the same
    bits (the groups' sums meet in a fixed order, no atomics). f32 and
    bf16 (the bf16 bound of the module's note)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, Tq, Tk, H, hd, causal, src_len = shape
    q, k, v, g = (x.to(getattr(torch, dtype))
                  for x in _cuda_inputs(B, Tq, Tk, H, hd))
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
        if dtype == "bfloat16":
            _bf16_close(a, c, BF16_TOL_GRAD, GRAD_ATOL, name)
        else:
            torch.testing.assert_close(a, c, rtol=0, atol=GRAD_ATOL,
                                       msg=lambda m, n=name: f"{n}: {m}")


def _bf16_close(got, want, rel, atol, what):
    """|got - want| <= rel * max|want| + atol on the card (read as f32):
    the bf16 bound of the module's note over the f32 bound of the sums'
    order (OUT_ATOL, GRAD_ATOL), which alone holds where the values are
    0 (a single key: dS = P (dP - D) = 0 up to the order of the sums)."""
    err = (got.float() - want.float()).abs().max().item()
    bound = rel * want.float().abs().max().item() + atol
    assert got.dtype == want.dtype == torch.bfloat16, what
    assert err <= bound, (f"{what}: max abs err {err} > {rel} x max|ref| + "
                          f"{atol}")


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 399, 8, 128, True, 0),
                                   (2, 399, 399, 8, 64, True, 0),
                                   (4, 199, 199, 8, 256, True, 0),
                                   (1, 1, 1, 8, 64, True, 0),
                                   (2, 70, 130, 8, 128, True, 5),
                                   (3, 37, 53, 8, 256, True, 5),
                                   (1, 517, 517, 2, 128, True, 0),
                                   (2, 301, 150, 2, 64, False, 0),
                                   (2, 41, 41, 2, 16, True, 0),
                                   (2, 41, 41, 2, 8, True, 0),
                                   (3, 37, 53, 2, 16, True, 5),
                                   (3, 37, 53, 2, 8, True, 5),
                                   (2, 384, 384, 2, 128, True, 0),
                                   (2, 65, 65, 2, 64, True, 0),
                                   (2, 50, 50, 2, 128, True, 0),
                                   (1, 399, 399, 2, 256, True, 0),
                                   (2, 301, 130, 2, 128, False, 0),
                                   (2, 150, 77, 2, 64, True, 5),
                                   (2, 128, 128, 2, 64, True, 0),
                                   (1, 256, 256, 2, 256, True, 0),
                                   (2, 30, 30, 2, 64, True, 0),
                                   (2, 20, 20, 2, 128, True, 0),
                                   (1, 24, 24, 2, 256, True, 0),
                                   (1, 129, 129, 2, 128, True, 0),
                                   (1, 97, 97, 2, 256, True, 0),
                                   (2, 150, 77, 2, 128, True, 5),
                                   (2, 150, 77, 2, 256, True, 5),
                                   (2, 77, 150, 2, 64, False, 0),
                                   (2, 130, 301, 2, 256, False, 0)])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_bf16_kernels_match_ref(shape, rate):
    """Runs on the card only. The bf16 kernels against their plain
    versions: through the autograd wrapper (o, dq, dk, dv) and each alone
    (lse, dQ, dK/dV from the plain lse and D), square and ragged, causal
    with src_len > 0 and the full form, at hd 8, 16, 64, 128 and 256;
    then a second forward and a second backward call give the same bits.
    Shapes 13-18 reach the edges of the forward's wgmma form at hd 64, 128
    and 256 (its two consumer groups walk the even and the odd key
    tiles): T a whole number of tiles, a last q tile of one row, a band of
    one key tile (the odd group walks nothing), its 32-key tiles at hd
    256, the full form with Tk < Tq, and src_len 5 with Tk < Tq. The last
    eleven reach those of the backward's wgmma forms (dQ walking key
    tiles of 64 keys, 32 at hd 256; dK/dV q tiles of 64 rows at hd 64, 32
    at 128 and 256, d split between its groups at 256): T a whole number
    of tiles, walks of one tile (the odd group walks nothing), a last tile
    of one row, src_len 5 with Tk < Tq at hd 128 and 256, and the full
    form with Tk > Tq. Tolerances: the module's note."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    B, Tq, Tk, H, hd, causal, src_len = shape
    q, k, v, g = (x.to(torch.bfloat16)
                  for x in _cuda_inputs(B, Tq, Tk, H, hd))
    kw = dict(causal=causal, src_len=src_len, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    runs = []
    for fn in (FA.flash_attention, FA.flash_attention_ref):
        t = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = FA.fwd_launches_bf16
        out = fn(*t, **kw)
        out.backward(g)
        runs.append([out.detach()] + [x.grad for x in t])
        if fn is FA.flash_attention:
            assert FA.fwd_launches_bf16 == before + 1
    _bf16_close(runs[0][0], runs[1][0], BF16_TOL_OUT, OUT_ATOL, "o")
    for name, a, b in zip(("dq", "dk", "dv"), runs[0][1:], runs[1][1:]):
        _bf16_close(a, b, BF16_TOL_GRAD, GRAD_ATOL,
                    f"{name} through autograd")
    o, lse = FA.flash_fwd(q, k, v, **kw)
    o2, lse2 = FA.flash_fwd(q, k, v, **kw)
    assert torch.equal(o, o2) and torch.equal(lse, lse2), \
        "a second forward call differs"
    o_ref, lse_ref = FA.flash_forward_ref(q, k, v, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
    _bf16_close(o, o_ref, BF16_TOL_OUT, OUT_ATOL, "o")
    dsum = FA.row_dot(g, o_ref)
    calls = [(FA.flash_bwd_dq(q, k, v, g, lse_ref, dsum, **kw),
              *FA.flash_bwd_dkv(q, k, v, g, lse_ref, dsum, **kw))
             for _ in range(2)]
    want = (FA.flash_bwd_dq_ref(q, k, v, g, lse_ref, dsum, **kw),
            *FA.flash_bwd_dkv_ref(q, k, v, g, lse_ref, dsum, **kw))
    for name, a, b, c in zip(("dq", "dk", "dv"), *calls, want):
        assert torch.equal(a, b), f"{name}: a second call differs"
        _bf16_close(a, c, BF16_TOL_GRAD, GRAD_ATOL, name)


@pytest.mark.gpu
@pytest.mark.parametrize("layout", ["unfused", "qkv", "kv"])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_cuda_bf16_mha_views_through_the_kernel(layout, rate):
    """Runs on the card only. The q, k, v views ops.attention.mha hands
    the kernels in bf16 (fused qkv and kv column slices of one projection
    included, as test_mha_views_keep_the_alignment_rule makes them) go
    through the bf16 forward as they are: its tensor maps read the
    strided rows, o and lse as the plain version's on the same views."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    from sea_tpu_torch.ops import attention as A
    B, T, E, H = 2, 77, 256, 2
    rs = np.random.RandomState(0)
    x = torch.from_numpy(rs.randn(B, T, E).astype(np.float32)).cuda()
    params = {"unfused": {n: _projection(rs, E, 1) for n in "qkv"},
              "qkv": {"qkv": _projection(rs, E, 3)},
              "kv": {"q": _projection(rs, E, 1),
                     "kv": _projection(rs, E, 2)}}[layout]
    params = {n: {w: a.cuda().bfloat16() * E ** -0.5 for w, a in p.items()}
              for n, p in params.items()}
    x = x.bfloat16()
    views = [y.reshape(B, T, H, E // H)
             for y in A._project_qkv(params, x, x)]
    if layout != "unfused":
        assert not views[-1].is_contiguous()
    kw = dict(causal=True, src_len=0, dropout_rate=rate,
              dropout_seed=SEED if rate else None)
    before = FA.fwd_launches_bf16
    o, lse = FA.flash_fwd(*views, **kw)
    assert FA.fwd_launches_bf16 == before + 1
    o_ref, lse_ref = FA.flash_forward_ref(*views, **kw)
    torch.testing.assert_close(lse, lse_ref, rtol=0, atol=1e-5)
    _bf16_close(o, o_ref, BF16_TOL_OUT, OUT_ATOL, "o")


@pytest.mark.gpu
def test_cuda_rejects_mixed_dtypes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    q, k, v, _ = _cuda_inputs(1, 16, 16, 2, 64)
    before = (FA.fwd_launches, FA.fwd_launches_bf16)
    for args in ((q.bfloat16(), k, v), (q, k.bfloat16(), v),
                 (q.bfloat16(), k.bfloat16(), v), (q.half(), k.half(),
                                                   v.half())):
        with pytest.raises(ValueError, match="dtype|float32"):
            FA.flash_attention(*args)
    assert (FA.fwd_launches, FA.fwd_launches_bf16) == before


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["offset_8_bytes", "time_stride_132",
                                  "offset_16_bytes"])
def test_cuda_bf16_alignment_rule(case):
    """bf16 views: 16 bytes are 8 elements, so a start 4 elements in or a
    time stride of 132 raise; a start 8 elements in is taken."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    def view(width, start):
        z = torch.zeros(2, 6, width, dtype=torch.bfloat16, device="cuda")
        return z[..., start:start + 128].unflatten(2, (2, 64))

    q = {"offset_8_bytes": view(144, 4), "time_stride_132": view(132, 0),
         "offset_16_bytes": view(144, 8)}[case]
    k, v = (x.bfloat16() for x in _cuda_inputs(2, 6, 6, 2, 64)[1:3])
    if case == "offset_16_bytes":
        assert q.data_ptr() % 16 == 0
        FA.flash_attention(q, k, v)
        return
    before = FA.fwd_launches_bf16
    with pytest.raises(ValueError, match="16-byte"):
        FA.flash_attention(q, k, v)
    assert FA.fwd_launches_bf16 == before


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
