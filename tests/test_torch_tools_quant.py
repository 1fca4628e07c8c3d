"""The port's int4 matvec microbenchmarks (sea_tpu_torch/tools/) against the
JAX package's tools/bench_quant_matvec.py and tools/bench_unpack_ceiling.py,
on the CPU.

Each of the eight functions that reach pl.pallas_call in tools/ runs in
interpret mode (pallas_call patched to interpret=True for this module only;
tools/ imported through sys.path, with SEA_BENCH_XLA_CACHE="" so that
bench_unpack_ceiling turns on no persistent compilation cache) beside the
port's wrapper, which on a CPU tensor runs its plain version. Inputs come
from numpy with a fixed seed at K=64, N=256, B in {1, 3}, block_n 128.
Tolerances:
- the matvecs: 1e-5 x max|y| (f32 sums of exact products in another
  order; the bias forms subtract 8 sum(x_lo) after);
- stream_bytes and dma_only: bit for bit (integer sums, exact in f32 here);
- _unpack_only_call: 1e-6 x the sum of its terms' magnitudes against JAX
  (its f32 sum of x in another order); on the card, and for the plain
  version here, its parts are held exactly (unpack_only_faults: integer
  sums equal, sum(x) within 1e-6 x sum|x| of its f64 value, out their f32
  sum bit for bit), a check that rejects planted faults.

The CUDA kernels run only on the card: test_cuda_kernels_match_plain is
marked gpu and skips here (``python -m pytest
tests/test_torch_tools_quant.py --noconftest -m gpu`` there; JAX is
imported only inside the fixture the CPU tests use).
"""

import functools
import importlib
import json
import os

import numpy as np
import pytest
import torch

from sea_tpu_torch.ops.quant_matmul import pack_int4
from sea_tpu_torch.tools import bench_quant_matvec as PQ
from sea_tpu_torch.tools import bench_unpack_ceiling as PU

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
K, N, BLOCK_N = 64, 256, 128
MATVEC_RTOL = 1e-5
UNPACK_RTOL = 1e-6

FUNCTIONS = ["matvec_p4", "matvec_p4b", "matvec_p4c", "matvec_s8",
             "stream_bytes", "dma_only", "_unpack_only_call", "_mvt_call"]


@pytest.fixture(scope="module")
def jax_tools():
    """(tools/bench_quant_matvec, tools/bench_unpack_ceiling, jnp) with
    every pallas_call in interpret mode, for this module only."""
    import jax.numpy as jnp
    from jax.experimental import pallas
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas, "pallas_call",
                   functools.partial(pallas.pallas_call, interpret=True))
        mp.setenv("SEA_BENCH_XLA_CACHE", "")
        mp.syspath_prepend(os.path.join(REPO, "tools"))
        yield (importlib.import_module("bench_quant_matvec"),
               importlib.import_module("bench_unpack_ceiling"), jnp)


def _inputs(B, seed=0):
    rs = np.random.RandomState(seed + B)
    return {"q": rs.randint(-8, 8, size=(K, N)).astype(np.int8),
            "w8": rs.randint(-128, 128, size=(K, N)).astype(np.int8),
            "x": rs.standard_normal((B, K)).astype(np.float32),
            "s": (rs.rand(1, N) * 0.1 + 0.01).astype(np.float32)}


def _both(jq, ju, jnp, name, B):
    """(JAX tools result, port result) of ``name`` on the same inputs, as
    f32 numpy."""
    d = _inputs(B)
    xj = jnp.asarray(d["x"]).astype(jnp.bfloat16)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        torch.bfloat16)
    wpj = jq.pack_nibbles(jnp.asarray(d["q"]))
    wpt = PQ.pack_nibbles(torch.from_numpy(d["q"]))
    sj, st = jnp.asarray(d["s"]), torch.from_numpy(d["s"])
    kw = {"block_n": BLOCK_N}
    if name in ("matvec_p4", "matvec_p4b", "matvec_p4c"):
        got = getattr(PQ, name)(xt, wpt, st, **kw)
        want = getattr(jq, name)(xj, wpj, sj, **kw)
    elif name == "matvec_s8":
        got = PQ.matvec_s8(xt, torch.from_numpy(d["w8"]), st, **kw)
        want = jq.matvec_s8(xj, jnp.asarray(d["w8"]), sj, **kw)
    elif name in ("stream_bytes", "dma_only"):
        got = getattr(PQ, name)(wpt, **kw)
        want = getattr(jq, name)(wpj, **kw)
    elif name == "_unpack_only_call":
        got = PU._unpack_only_call(xt, wpt, **kw)
        want = ju._unpack_only_call(xj, wpj, **kw)
    else:
        qt = jnp.asarray(d["q"])
        got = PU._mvt_call(xt, PU.pack_int4_t(torch.from_numpy(d["q"])),
                           st.reshape(N, 1), **kw)
        want = ju._mvt_call(xj, ju.pack_int4_t(qt), sj.reshape(N, 1), **kw)
    return np.asarray(want, np.float32), got.numpy(), (xt, wpt)


@pytest.mark.parametrize("name", FUNCTIONS)
def test_port_matches_jax_tools(jax_tools, name):
    """Each port function (its plain version on the CPU) against the JAX
    tools function in interpret mode, at B = 1 and 3, to the module's
    tolerances."""
    for B in (1, 3):
        want, got, (xt, wpt) = _both(*jax_tools, name, B)
        assert got.shape == want.shape and got.dtype == np.float32, B
        if name in ("stream_bytes", "dma_only"):
            np.testing.assert_array_equal(got, want, err_msg=f"B={B}")
        elif name == "_unpack_only_call":
            scale = PU.unpack_only_magnitude(xt, wpt, block_n=BLOCK_N)
            assert abs(got - want).max() <= UNPACK_RTOL * scale, (B, got,
                                                                   want)
        else:
            err = np.abs(got - want).max()
            assert err <= MATVEC_RTOL * np.abs(want).max(), (B, err)


def test_pack_nibbles_equals_pack_int4(jax_tools):
    """The port's copies of the packers: pack_nibbles equals
    ops/quant_matmul.pack_int4 and the JAX tools' pack_nibbles, and
    pack_int4_t the JAX tools' pack_int4_t, on every nibble."""
    jq, ju, jnp = jax_tools
    q = _inputs(1)["q"]
    q[0, :16] = np.arange(-8, 8)
    got = PQ.pack_nibbles(torch.from_numpy(q))
    assert got.dtype == torch.uint8
    assert torch.equal(got, pack_int4(torch.from_numpy(q)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jq.pack_nibbles(jnp.asarray(q))))
    np.testing.assert_array_equal(
        PU.pack_int4_t(torch.from_numpy(q)).numpy(),
        np.asarray(ju.pack_int4_t(jnp.asarray(q))))


def test_quantizers_match_the_jax_main(jax_tools):
    """quantize_int4 / quantize_int8 against the JAX bench main's inline
    formulas (tools/bench_quant_matvec.py, main)."""
    _, _, jnp = jax_tools
    w = np.random.RandomState(3).standard_normal((K, N)).astype(
        np.float32) * 0.02
    wj = jnp.asarray(w)
    for fn, top in ((PQ.quantize_int4, 7), (PQ.quantize_int8, 127)):
        sj = jnp.max(jnp.abs(wj), axis=0, keepdims=True) / float(top)
        qj = jnp.clip(jnp.round(wj / sj), -top, top).astype(jnp.int8)
        q, s = fn(torch.from_numpy(w))
        np.testing.assert_array_equal(s.numpy(), np.asarray(sj))
        np.testing.assert_array_equal(q.numpy(), np.asarray(qj))


def test_ragged_block_n_raises():
    """N not a multiple of block_n raises in each of the eight (the TPU
    grid leaves the tail unwritten; a documented divergence)."""
    d = _inputs(1)
    x = torch.from_numpy(d["x"]).to(torch.bfloat16)
    wp = PQ.pack_nibbles(torch.from_numpy(d["q"]))
    s = torch.from_numpy(d["s"])
    calls = {
        "matvec_p4": lambda: PQ.matvec_p4(x, wp, s, block_n=96),
        "matvec_p4b": lambda: PQ.matvec_p4b(x, wp, s, block_n=96),
        "matvec_p4c": lambda: PQ.matvec_p4c(x, wp, s, block_n=96),
        "matvec_s8": lambda: PQ.matvec_s8(x, torch.from_numpy(d["w8"]), s,
                                          block_n=96),
        "stream_bytes": lambda: PQ.stream_bytes(wp, block_n=96),
        "dma_only": lambda: PQ.dma_only(wp, block_n=96),
        "_unpack_only_call": lambda: PU._unpack_only_call(x, wp,
                                                          block_n=96),
        "_mvt_call": lambda: PU._mvt_call(
            x, PU.pack_int4_t(torch.from_numpy(d["q"])), s.reshape(N, 1),
            block_n=96)}
    assert set(calls) == set(FUNCTIONS)
    for name, call in calls.items():
        with pytest.raises(ValueError, match="not a multiple of block_n"):
            call()


def test_unpack_only_check_rejects_planted_faults():
    """unpack_only_faults passes the plain version's parts and rejects a
    kernel's likely faults, which a bound of 1e-6 of the terms' magnitudes
    on out alone lets through: out less sum(x), sum(x) dropped, one 0x0F
    byte too many (lo + 7)."""
    for B in (1, 3):
        d = _inputs(B)
        x = torch.from_numpy(d["x"]).to(torch.bfloat16)
        wp = PQ.pack_nibbles(torch.from_numpy(d["q"]))
        kw = {"block_n": BLOCK_N}
        out, ints, xsum = parts = PU.unpack_only_parts(x, wp, **kw)
        assert ints.dtype == torch.int64 and xsum.dtype == torch.float32
        assert torch.equal(out, PU._unpack_only_call(x, wp, **kw))
        assert PU.unpack_only_faults(parts, x, wp, **kw) == []

        def formed(i, xs):
            return ((i[0].float() + i[1].float()) + xs).reshape(1, 1)

        more = ints + torch.tensor([7, 0])
        planted = {"out - sum(x)": (out - xsum, ints, xsum),
                   "sum(x) dropped": (formed(ints, 0 * xsum), ints,
                                      0 * xsum),
                   "a byte too many": (formed(more, xsum), more, xsum)}
        for fault, bad in planted.items():
            assert PU.unpack_only_faults(bad, x, wp, **kw), (B, fault)


@pytest.mark.parametrize("module,argv", [
    (PQ, ["--K", "64", "--N", "256", "--block_n", "128", "--B", "3"]),
    (PU, ["--k", "64", "--n", "256", "--b", "2"])])
def test_entry_points_run_on_cpu(module, argv, capsys):
    """Both entry points at a tiny shape on the CPU: the correctness checks
    pass, every row is timed (host clock) and the last line is their JSON."""
    module.main(argv + ["--repeats", "4", "--device", "cpu"])
    last = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert last["device"] == "cpu" and last["clock"] == "host"
    want = ({"noop_loop", "torch_int4", "torch_int8", "matvec_p4",
             "matvec_p4b", "matvec_p4c", "matvec_s8", "stream_bytes",
             "dma_only"} if module is PQ else {"unpack", "full", "fullT"})
    assert set(last["results"]) == want
    assert all(r["us"] > 0 and "hbm_share" not in r
               for r in last["results"].values())


@pytest.mark.gpu
def test_cuda_kernels_match_plain():
    """Runs on the card only (no CUDA here): each of the eight kernels
    against its plain version on the same CUDA tensors, one launch a call,
    at the tools' shape, a small one and one whose K/2 is not a multiple
    of the matvec's row slices, B = 1, 3 and 8; the matvecs to 1e-5 x
    sum|x w s| (f32 order), stream_bytes and dma_only bit for bit (twice),
    _unpack_only_call's parts by unpack_only_faults. The tensor-core
    kernels (matvec_p4, p4b, p4c, s8, _mvt_call) also at K = 72, N = 400: a
    k tail shorter than one MMA step in each, _mvt_call's word-wise form
    (K/2 not a multiple of 8; also at K = 520), and a last column tile cut
    by N; _unpack_only_call there too, block_n 16: one column group a row,
    a block's rows past K/2. The p4 forms also at K = 68, where K/2 = 34 is
    not a multiple of 4 and they read x in 2-byte loads. Last
    _unpack_only_call, then stream_bytes, at K = 64, N = 240, block_n 16,
    where both kernels' scratch is 17 words: stream_bytes adds into its
    words, so it must not be given the words _unpack_only_call left."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    for K, N, block_n, only in ((2048, 16384, 512, None),
                                (64, 256, 128, None),
                                (520, 4096, 2048, None),
                                (72, 400, 16, ("matvec_p4", "matvec_p4b",
                                               "matvec_p4c", "matvec_s8",
                                               "_mvt_call",
                                               "_unpack_only_call")),
                                (68, 400, 16, ("matvec_p4", "matvec_p4b",
                                               "matvec_p4c", "matvec_s8",
                                               "_unpack_only_call")),
                                (64, 240, 16, ("_unpack_only_call",)),
                                (64, 240, 16, ("stream_bytes",))):
        for B in (1, 3, 8):
            _check_kernels(K, N, block_n, B, only)


def _check_kernels(K, N, block_n, B, only=None):
    g = torch.Generator(device="cuda").manual_seed(K + N + B)
    q = torch.randint(-8, 8, (K, N), device="cuda", generator=g,
                      dtype=torch.int8)
    w8 = torch.randint(-128, 128, (K, N), device="cuda", generator=g,
                       dtype=torch.int8)
    x = torch.randn(B, K, device="cuda", generator=g).to(torch.bfloat16)
    s = torch.rand(1, N, device="cuda", generator=g) * 0.1 + 0.01
    wp, wpt = PQ.pack_nibbles(q), PU.pack_int4_t(q)
    mag4 = (x.float().abs() @ q.float().abs()) * s
    mag8 = (x.float().abs() @ w8.float().abs()) * s
    kw = {"block_n": block_n}
    s_t = s.reshape(N, 1)
    cases = [
        (name, PQ.launches, functools.partial(getattr(PQ, name), x, w, s,
                                              **kw),
         functools.partial(getattr(PQ, name + "_ref"), x, w, s, **kw), mag)
        for name, w, mag in (("matvec_p4", wp, mag4),
                             ("matvec_p4b", wp, mag4),
                             ("matvec_p4c", wp, mag4),
                             ("matvec_s8", w8, mag8))]
    cases += [
        (name, PQ.launches, functools.partial(getattr(PQ, name), wp, **kw),
         functools.partial(getattr(PQ, name + "_ref"), wp, **kw), None)
        for name in ("stream_bytes", "dma_only")]
    cases += [
        ("_mvt_call", PU.launches,
         functools.partial(PU._mvt_call, x, wpt, s_t, **kw),
         functools.partial(PU._mvt_call_ref, x, wpt, s_t, **kw), mag4),
        ("_unpack_only_call", PU.launches,
         functools.partial(PU.unpack_only_parts, x, wp, **kw),
         functools.partial(PU.unpack_only_faults, x=x, wp=wp, **kw), None)]
    for name, counts, kernel, plain, mag in cases:
        if only is not None and name not in only:
            continue
        before = counts[name]
        got, again = kernel(), kernel()
        assert counts[name] == before + 2, (name, K, N, block_n, B)
        where = (name, K, N, block_n, B)
        if name == "_unpack_only_call":
            assert plain(got) == [] and plain(again) == [], where
            continue
        want = plain()
        torch.cuda.synchronize()
        if mag is None:
            assert torch.equal(got, want) and torch.equal(again, want), where
        else:
            assert bool(((got - want).abs() <= 1e-5 * mag).all()), where
