"""The fused AdaLN-modulate wrapper of the port (sea_tpu_torch/ops/fused_adaln).

On the CPU: the plain version ``adaln_modulate_ref`` and its VJP against
the JAX package's Pallas kernels run in interpret mode
(``fused_adaln_modulate`` and its custom VJP), a T that is not a multiple
of the TPU kernel's 128-row block included; the plain backward pieces the
card compares its kernel with against autograd; and the dispatch of
``layers.adaln_modulate``. Tolerances: atol 2e-6 for the output and 1e-4
for the gradients, the bounds of tests/test_fused_adaln.py (f32, the
gradient sums over T and B run in another order).

The Triton kernels run only on the card: their tests are marked ``gpu``
and skip here; there,
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


def _inputs(B, T, E, seed=0):
    rs = np.random.RandomState(seed)
    x = (rs.randn(B, T, E) * 2 + 0.5).astype(np.float32)
    cw = (1 + 0.1 * rs.randn(B, 1, E)).astype(np.float32)
    cb = (0.1 * rs.randn(B, 1, E)).astype(np.float32)
    w = (1 + 0.1 * rs.randn(E)).astype(np.float32)
    b = (0.1 * rs.randn(E)).astype(np.float32)
    g = rs.randn(B, T, E).astype(np.float32)
    return x, cw, cb, w, b, g


@pytest.mark.parametrize("shape", [(2, 40, 128), (3, 131, 256)])
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


def test_plain_backward_pieces_match_autograd():
    x, cw, cb, w, b, g = map(torch.from_numpy, _inputs(2, 37, 64, seed=1))
    t = [a.clone().requires_grad_(True) for a in (x, cw, cb, w, b)]
    FAL.adaln_modulate_ref(*t).backward(g)
    dx, dgw, dgb = FAL.adaln_bwd_ref(x, cw, g, w)
    np.testing.assert_allclose(dx.numpy(), t[0].grad.numpy(), rtol=0,
                               atol=GRAD_ATOL)
    for got, want in ((dgw, t[1].grad), (dgb, t[2].grad),
                      (dgw.sum((0, 1)), t[3].grad),
                      (dgb.sum((0, 1)), t[4].grad)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=GRAD_ATOL)


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 399, 1024), (2, 399, 512),
                                   (3, 5, 96)])
def test_cuda_kernels_match_ref(shape):
    """Runs on the card only: output and all five gradients through the
    autograd wrapper, and the backward kernel alone against its plain
    piece."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    inputs = [torch.from_numpy(a).cuda() for a in _inputs(*shape)]
    x, cw, cb, w, b, g = inputs
    results = []
    for fn in (FAL.fused_adaln_modulate, FAL.adaln_modulate_ref):
        t = [a.clone().requires_grad_(True) for a in (x, cw, cb, w, b)]
        out = fn(*t)
        out.backward(g)
        results.append([out.detach()] + [a.grad for a in t])
    # numpy's assert_allclose defaults of tests/test_fused_adaln.py: rtol
    # 1e-7 beside atol 2e-6 for the output, 1e-4 beside 1e-4 for the
    # gradients (outputs reach ~8, where an f32 ulp is ~1e-6).
    torch.testing.assert_close(results[0][0], results[1][0], rtol=1e-7,
                               atol=OUT_ATOL)
    for a, b_ in zip(results[0][1:], results[1][1:]):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=GRAD_ATOL)
    for a, b_ in zip(FAL.adaln_bwd(x, cw, g, w),
                     FAL.adaln_bwd_ref(x, cw, g, w)):
        torch.testing.assert_close(a, b_, rtol=1e-4, atol=GRAD_ATOL)
