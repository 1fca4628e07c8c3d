"""The fused AdaLN-modulate wrapper of the port (sea_tpu_torch/ops/fused_adaln).

On the CPU: the plain version ``adaln_modulate_ref`` and its VJP, and the
backward kernel's plain version ``adaln_bwd_ref`` with its five outputs
(dx, dcw, dcb, dw, db), against the JAX package's Pallas kernels run in
interpret mode (``fused_adaln_modulate`` and its custom VJP), a T that is
not a multiple of the TPU kernel's 128-row block and a single row
included; the plain backward against autograd; the kernels' grid
(``adaln_plan``: every row and column covered once, one wave, whole
clusters); and the dispatch of ``layers.adaln_modulate``. Tolerances: atol
2e-6 for the output and 1e-4 for the gradients, the bounds of
tests/test_fused_adaln.py (f32, the gradient sums over T and B run in
another order).

The CUDA kernels (``sea_tpu_torch/csrc/fused_adaln.cu``) run only on the
card: their tests are marked ``gpu`` and skip here; there,
``python -m pytest tests/test_torch_fused_adaln.py --noconftest -m gpu``
runs them (the card has no JAX; it is imported only inside the tests that
compare against it).
"""

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops import fused_adaln as FAL
from sea_tpu_torch.ops import layers as L

torch.set_num_threads(2)

OUT_ATOL = 2e-6
GRAD_ATOL = 1e-4
# bf16 x (and dx, out): kernel and plain version compute the same f32
# values up to summation order (the f32 bounds above), then round to bf16,
# where order noise can move a value across a rounding boundary: one bf16
# ulp, at most 2^-7 of the value. So rtol 2^-7 beside the f32 atol. The
# f32 column sums see the same bf16 inputs on both sides: f32 bounds.
BF16_RTOL = 2.0 ** -7
NAMES = ("dx", "dcw", "dcb", "dw", "db")


def _inputs(B, T, E, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, T, E) * 2 + 0.5).astype(np.float32)
    cw = (1 + 0.1 * rs.randn(B, 1, E)).astype(np.float32)
    cb = (0.1 * rs.randn(B, 1, E)).astype(np.float32)
    w = (1 + 0.1 * rs.randn(E)).astype(np.float32)
    b = (0.1 * rs.randn(E)).astype(np.float32)
    g = rs.randn(B, T, E).astype(np.float32)
    return x, cw, cb, w, b, g


@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 131, 256), (1, 1, 128)])
def test_ref_matches_jax_kernels(shape, monkeypatch):
    import jax
    import jax.numpy as jnp
    from sea_tpu.ops import fused_adaln as jfa
    monkeypatch.setattr(jfa, "_FORCE_INTERPRET", True)
    x, cw, cb, w, b, g = _inputs(*shape)
    want, vjp = jax.vjp(lambda *a: jfa.fused_adaln_modulate(*a),
                        *map(jnp.asarray, (x, cw, cb, w, b)))
    want_grads = vjp(jnp.asarray(g))
    t = [torch.from_numpy(a).requires_grad_(True) for a in (x, cw, cb, w, b)]
    got = FAL.fused_adaln_modulate(*t)
    got.backward(torch.from_numpy(g))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=0, atol=OUT_ATOL)
    for name, a, w_ in zip(("x", "cw", "cb", "w", "b"), t, want_grads):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w_), rtol=0,
                                   atol=GRAD_ATOL, err_msg=f"d{name}")
    # The backward kernel's plain version, all five outputs.
    pieces = FAL.adaln_bwd_ref(*map(torch.from_numpy, (x, cw, g, w)))
    for name, got_, want_ in zip(NAMES, pieces, want_grads):
        np.testing.assert_allclose(got_.numpy(), np.asarray(want_), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def test_plain_backward_pieces_match_autograd():
    x, cw, cb, w, b, g = map(torch.from_numpy, _inputs(2, 37, 64, seed=1))
    t = [a.clone().requires_grad_(True) for a in (x, cw, cb, w, b)]
    FAL.adaln_modulate_ref(*t).backward(g)
    pieces = FAL.adaln_bwd_ref(x, cw, g, w)
    assert [p.dtype for p in pieces] == [torch.float32] * 5
    for name, got, want in zip(NAMES, pieces, [a.grad for a in t]):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_ATOL, err_msg=name)


def test_cpu_tensors_take_the_plain_version():
    """On the CPU the kernel wrappers are their plain versions and count
    no launch; what the kernels refuse raises on either device."""
    x, cw, cb, w, b, g = map(torch.from_numpy, _inputs(2, 9, 32, seed=3))
    before = (FAL.fwd_launches, FAL.bwd_launches)
    torch.testing.assert_close(FAL.adaln_fwd(x, cw, cb, w, b),
                               FAL.adaln_modulate_ref(x, cw, cb, w, b),
                               rtol=0, atol=0)
    for got, want in zip(FAL.adaln_bwd(x, cw, g, w),
                         FAL.adaln_bwd_ref(x, cw, g, w)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert (FAL.fwd_launches, FAL.bwd_launches) == before
    with pytest.raises(ValueError):  # g of another dtype than x
        FAL.adaln_bwd(x, cw, g.double(), w)
    with pytest.raises(ValueError):  # cond and base of two dtypes
        FAL.adaln_fwd(x, cw.bfloat16(), cb.bfloat16(), w, b)
    with pytest.raises(ValueError):  # per-token cond
        FAL.adaln_fwd(x, cw.expand(2, 9, 32), cb, w, b)


PLAN_SHAPES = [(2, 399, 1024), (2, 399, 512), (8, 399, 1024), (1, 1, 1024),
               (3, 5, 96), (2, 7, 100), (2, 40, 32), (2, 40, 16),
               (1, 3, 16384), (1, 2, 16383), (4, 9, 2048), (2, 13, 8192),
               (2, 3, 8200), (300, 2, 64)]


@pytest.mark.parametrize("shape", PLAN_SHAPES)
@pytest.mark.parametrize("itemsize,aligned", [(4, True), (2, True),
                                              (4, False), (2, False)])
def test_plan_covers_every_row_and_column(shape, itemsize, aligned):
    """The grid the kernels take: a row's columns split over wpr warps of
    n elements a thread, each column in exactly one 16-byte vector (or one
    scalar) of one thread; each trajectory's rows over nb blocks, every
    row in exactly one, none empty; the backward's blocks in whole
    clusters of at most 8 (one past CLUSTER_MAX_E columns); one wave of
    the card's slots unless a trajectory needs a block of its own. The
    plan takes the shape only, so every call of a shape launches the same
    grid."""
    B, T, E = shape
    for slots in (1, 7, 128, 264):
        plan = FAL.adaln_plan(B, T, E, itemsize, aligned, slots)
        assert plan == FAL.adaln_plan(B, T, E, itemsize, aligned, slots)
        vec, n, wpr, nb, cs = plan
        assert vec == (16 // itemsize if aligned and E % (16 // itemsize)
                       == 0 else 1)
        assert n in FAL.ELEMS[vec] or (n == 64 and E > 8 * 32 * 32)
        assert wpr in (1, 2, 4, 8) and (wpr == 1 or n >= 32)
        cols = [(k * 32 * wpr + j) * vec + v for j in range(32 * wpr)
                for k in range(n // vec) for v in range(vec)]
        assert sorted(c for c in cols if c < E) == list(range(E))
        assert 1 <= cs <= FAL.MAX_CLUSTER and nb % cs == 0
        assert cs == 1 or E <= FAL.CLUSTER_MAX_E
        assert 1 <= nb <= T and B * nb <= max(slots, B)
        rows = [list(range(i * T // nb, (i + 1) * T // nb))
                for i in range(nb)]
        assert all(rows) and sum(rows, []) == list(range(T))


def test_layers_dispatch():
    """layers.adaln_modulate sends [B, T, E] with [B, 1, E] cond to the
    fused wrapper (on the CPU its plain version, no launch counted) and
    keeps the plain formula for per-token cond and the 2-D rollout step;
    all three agree."""
    x, cw, cb, w, b, _ = map(torch.from_numpy, _inputs(2, 9, 32, seed=2))
    params = {"w": w, "b": b}
    before = (FAL.fwd_launches, FAL.bwd_launches)
    assert FAL.fused_supported(x, cw, cb)
    fused = L.adaln_modulate(params, x, cw, cb)
    assert not FAL.fused_supported(x, cw.expand(2, 9, 32),
                                   cb.expand(2, 9, 32))
    per_token = L.adaln_modulate(params, x, cw.expand(2, 9, 32),
                                 cb.expand(2, 9, 32))
    np.testing.assert_allclose(fused.numpy(), per_token.numpy(), rtol=0,
                               atol=1e-6)
    step = L.adaln_modulate(params, x[:, 3], cw[:, 0], cb[:, 0])
    np.testing.assert_allclose(step.numpy(), fused[:, 3].numpy(), rtol=0,
                               atol=1e-6)
    assert (FAL.fwd_launches, FAL.bwd_launches) == before
    with pytest.raises(ValueError):
        FAL.fused_adaln_modulate(x.to("meta"), cw.to("meta"), cb.to("meta"),
                                 w.to("meta"), b.to("meta"))


def _cuda_or_skip():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")


def _cuda_inputs(shape, x_dtype=torch.float32, p_dtype=torch.float32,
                 seed=0):
    x, cw, cb, w, b, g = (torch.from_numpy(a).cuda()
                          for a in _inputs(*shape, seed=seed))
    return (x.to(x_dtype), cw.to(p_dtype), cb.to(p_dtype), w.to(p_dtype),
            b.to(p_dtype), g.to(x_dtype))


def _compare(inputs, out_tol, dx_tol, param_tol=(GRAD_ATOL, 1e-4)):
    """The output and the five gradients through the autograd wrapper
    against autograd through the plain version, and the backward kernel's
    five outputs (f32 sums: f32 bounds) against its plain version; (atol,
    rtol) each. For parameters of another dtype than f32 the parameters'
    gradients are held to the plain version's f32 sums rounded once to
    that dtype, as the JAX package's VJP rounds them (autograd through
    the plain version adds bf16 gradients in bf16, a second rounding)."""
    x, cw, cb, w, b, g = inputs
    results = []
    for fn in (FAL.fused_adaln_modulate, FAL.adaln_modulate_ref):
        t = [a.clone().requires_grad_(True) for a in (x, cw, cb, w, b)]
        out = fn(*t)
        out.backward(g)
        results.append([out.detach()] + [a.grad for a in t])
    torch.testing.assert_close(results[0][0], results[1][0], atol=out_tol[0],
                               rtol=out_tol[1])
    want = FAL.adaln_bwd_ref(x, cw, g, w)
    if w.dtype != torch.float32:
        results[1][2:] = [p.to(w.dtype) for p in want[1:]]
    tols = [dx_tol] + [param_tol] * 4
    for name, a, b_, tol in zip(NAMES, results[0][1:], results[1][1:], tols):
        assert a.dtype == b_.dtype, name
        torch.testing.assert_close(a, b_, atol=tol[0], rtol=tol[1], msg=name)
    for name, a, b_, tol in zip(NAMES, FAL.adaln_bwd(x, cw, g, w), want,
                                [dx_tol] + [(GRAD_ATOL, 1e-4)] * 4):
        assert a.dtype == b_.dtype and a.shape == b_.shape, name
        torch.testing.assert_close(a, b_, atol=tol[0], rtol=tol[1], msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 1024), (2, 399, 512),
                                   (3, 5, 96), (2, 7, 100), (2, 40, 32),
                                   (2, 40, 16), (1, 1, 1024), (8, 399, 1024),
                                   (1, 3, 16384)])
def test_cuda_kernels_match_ref(shape):
    """Runs on the card only: output and all five gradients through the
    autograd wrapper, and the backward kernel alone against its plain
    version. numpy's assert_allclose defaults of tests/test_fused_adaln.py:
    rtol 1e-7 beside atol 2e-6 for the output, 1e-4 beside 1e-4 for the
    gradients (outputs reach ~8, where an f32 ulp is ~1e-6)."""
    _cuda_or_skip()
    _compare(_cuda_inputs(shape), (OUT_ATOL, 1e-7), (GRAD_ATOL, 1e-4))


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 1024), (2, 7, 100)])
@pytest.mark.parametrize("p_dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernels_match_ref_bf16(shape, p_dtype):
    """bf16 x (16-byte vectors at E=1024, scalars at E=100, which is no
    whole number of 8-element vectors), with f32 or bf16 parameters (a =
    w + cw rounded to bf16 first on both sides): out and dx within one
    bf16 ulp (BF16_RTOL) beside the f32 atol, the f32 sums within the f32
    bounds; bf16 parameter gradients, f32 sums rounded once to bf16,
    within one bf16 ulp too."""
    _cuda_or_skip()
    param_tol = (GRAD_ATOL, 1e-4 if p_dtype == torch.float32 else BF16_RTOL)
    _compare(_cuda_inputs(shape, torch.bfloat16, p_dtype),
             (OUT_ATOL, BF16_RTOL), (GRAD_ATOL, BF16_RTOL), param_tol)


@pytest.mark.gpu
def test_cuda_unaligned_rows_take_the_scalar_path():
    """f32 rows whose pointers are not on 16 bytes (a view one element
    into its storage) are read one element at a time, with the same
    results."""
    _cuda_or_skip()
    x, cw, cb, w, b, g = _cuda_inputs((2, 7, 96))
    xs = torch.empty(x.numel() + 1, device="cuda")[1:].view_as(x)
    xs.copy_(x)
    assert xs.data_ptr() % 16 and xs.is_contiguous()
    assert FAL.device_plan(True, 2, 7, 96, torch.float32, False,
                           x.device).vec == 1
    torch.testing.assert_close(FAL.adaln_fwd(xs, cw, cb, w, b),
                               FAL.adaln_modulate_ref(x, cw, cb, w, b),
                               atol=OUT_ATOL, rtol=1e-7)
    for got, want in zip(FAL.adaln_bwd(xs, cw, g, w),
                         FAL.adaln_bwd_ref(x, cw, g, w)):
        torch.testing.assert_close(got, want, atol=GRAD_ATOL, rtol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 1024), (8, 399, 1024),
                                   (2, 40, 16), (1, 3, 16384)])
def test_cuda_kernels_are_deterministic(shape):
    """Two calls give the same bits, all five backward outputs included:
    every sum runs in a fixed order (rows, groups, cluster ranks,
    clusters, trajectories) and no float atomic is used; the arrival
    counters are back at 0 after each call."""
    _cuda_or_skip()
    x, cw, cb, w, b, g = _cuda_inputs(shape, seed=4)
    first = [FAL.adaln_fwd(x, cw, cb, w, b), *FAL.adaln_bwd(x, cw, g, w)]
    for _ in range(2):
        again = [FAL.adaln_fwd(x, cw, cb, w, b), *FAL.adaln_bwd(x, cw, g, w)]
        for name, a, b_ in zip(("out",) + NAMES, first, again):
            assert torch.equal(a, b_), name
    torch.cuda.synchronize()
    assert not any(c.any() for c in FAL._COUNTERS.values())


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 1024), (2, 399, 512)])
def test_cuda_one_device_kernel_a_call(shape):
    """torch.profiler sees exactly one device kernel for each forward and
    each backward call: the backward's sums over chunks and trajectories
    run inside it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    _cuda_or_skip()
    x, cw, cb, w, b, g = _cuda_inputs(shape)
    for fn in (lambda: FAL.adaln_fwd(x, cw, cb, w, b),
               lambda: FAL.adaln_bwd(x, cw, g, w)):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if e.device_type == DeviceType.CUDA]
        assert sum(e.count for e in events) == 3, [e.key for e in events]


@pytest.mark.gpu
def test_cuda_rejects_rows_past_the_kernels_width():
    """E > 16384 raises on a CUDA tensor (the kernels take rows up to
    MAX_E); it is not sent to the plain version."""
    _cuda_or_skip()
    x, cw, cb, w, b, g = _cuda_inputs((1, 2, FAL.MAX_E + 1))
    before = (FAL.fwd_launches, FAL.bwd_launches)
    with pytest.raises(ValueError):
        FAL.adaln_fwd(x, cw, cb, w, b)
    with pytest.raises(ValueError):
        FAL.adaln_bwd(x, cw, g, w)
    with pytest.raises(ValueError):
        FAL.fused_adaln_modulate(x, cw, cb, w, b)
    assert (FAL.fwd_launches, FAL.bwd_launches) == before
