"""The port's ring attention (``parallel/ring_attention.py``) against the
JAX package's ``ring_attention`` on the CPU.

The port runs a ring of 2 or 4 gloo ranks (tests/_torch_ranks.py
``run_seq``), each holding one time block; JAX runs its ring over 2 or 4
of the 8 virtual devices of tests/conftest.py. The flash form (causal
with src_len 0, or non-causal) is compared with JAX's flash ring, its
flash kernels in interpret mode; the dense form (causal, src_len 3) with
JAX's dense ring. Inputs from numpy (B=2, T=16, 2 heads, hd 8), dropout
0 and 0.1 with one seed: the output and the gradients of q, k and v for
one cotangent, gathered over the ranks, within 1e-5 (f32 summation
order; both hash the same global positions). A ring also equals the
port's one-device plain flash attention within 1e-5. The divisibility
and the form errors are the JAX function's.
"""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ranks as R
from sea_tpu_torch.ops import flash_attention as FA
from sea_tpu_torch.parallel.collectives import Grid
from sea_tpu_torch.parallel.mesh import make_seq_mesh, shard_seq
from sea_tpu_torch.parallel.multihost import run_ranks
from sea_tpu_torch.parallel.ring_attention import ring_attention

torch.set_num_threads(2)

ATOL = 1e-5
B, T, H, HD = 2, 16, 2, 8
SEED = (123, -45)
RINGS = (2, 4)
# name: (causal, src_len, dropout rate); "dense" is the src_len != 0 form.
CASES = {"causal": (True, 0, 0.0), "causal-drop": (True, 0, 0.1),
         "full-drop": (False, 0, 0.1), "dense-drop": (True, 3, 0.1)}
requires_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                                reason="needs 8 virtual devices")


def _inputs():
    rs = np.random.RandomState(0)
    return tuple(rs.randn(B, T, H, HD).astype(np.float32) for _ in range(4))


def _kw(name):
    causal, src_len, rate = CASES[name]
    return dict(causal=causal, src_len=src_len, dropout_rate=rate,
                dropout_seed=SEED if rate else None)


def _form(name):
    """The form both sides take (the JAX ring's choice)."""
    return "dense" if CASES[name][1] else "flash"


def _jax_ring(n, name, impl, q, k, v, g):
    from jax.sharding import Mesh
    from sea_tpu.ops import flash_attention as jfa
    from sea_tpu.parallel.ring_attention import ring_attention as jring
    mesh = Mesh(np.asarray(jax.devices()[:n]), axis_names=("seq",))
    kw = dict(_kw(name), impl=impl)
    if kw["dropout_seed"] is not None:
        kw["dropout_seed"] = jnp.asarray(SEED, jnp.int32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jfa, "_FORCE_INTERPRET", True)
        @jax.jit
        def run(q, k, v, g):
            out, vjp = jax.vjp(lambda a, b, c: jring(a, b, c, mesh, **kw),
                               q, k, v)
            return (out,) + vjp(g)
        return tuple(map(np.asarray, run(*map(jnp.asarray, (q, k, v, g)))))


@pytest.fixture(scope="module")
def rings():
    """{(n, name): (port, jax)}: (out, dq, dk, dv) of each side; the
    port's ranks run while JAX compiles."""
    q, k, v, g = _inputs()
    jobs = {name: ("ring", (q, k, v, g, _kw(name))) for name in CASES}
    keys = [(n, name) for n in RINGS for name in CASES]
    with concurrent.futures.ThreadPoolExecutor(len(RINGS)) as pool:
        port = {n: pool.submit(run_ranks, R.run_seq, n, jobs) for n in RINGS}
        want = {(n, name): _jax_ring(n, name, _form(name), q, k, v, g)
                for n, name in keys}
        return {key: (port[key[0]].result()[0][key[1]], value)
                for key, value in want.items()}


@requires_8
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("n", RINGS)
def test_ring_matches_jax(n, name, rings):
    got, want = rings[(n, name)]
    for what, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        assert a.shape == b.shape == (B, T, H, HD)
        np.testing.assert_allclose(a, b, rtol=0, atol=ATOL, err_msg=what)


@pytest.mark.parametrize("name", sorted(CASES))
def test_ring_matches_one_device(name, rings):
    """Gathered over the ring of 4, the port's ring is its one-device
    plain flash attention (same band, same dropout positions)."""
    q, k, v, g = _inputs()
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    kw = _kw(name)
    out = FA.flash_attention_ref(qt, kt, vt, **kw)
    out.backward(torch.from_numpy(g))
    got = rings[(4, name)][0]
    for what, a, b in zip(("out", "dq", "dk", "dv"), got,
                          (out, qt.grad, kt.grad, vt.grad)):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=ATOL,
                                   err_msg=what)


def test_ring_errors():
    """The JAX function's refusals, and the seq grid's divisibility."""
    q = torch.zeros(1, 4, 1, 8)
    grid = Grid(1, 1, n_seq=2, seq_rank=0)
    with pytest.raises(ValueError, match="needs dropout_seed"):
        ring_attention(q, q, q, grid, dropout_rate=0.1)
    with pytest.raises(ValueError, match="do not split over the 2 ranks"):
        shard_seq(grid, np.zeros((1, 5, 3)))
    with pytest.raises(ValueError, match="needs 3 ranks"):
        make_seq_mesh(3)
    np.testing.assert_array_equal(
        shard_seq(Grid(1, 1, n_seq=2, seq_rank=1), np.arange(8)[None]),
        [[4, 5, 6, 7]])
