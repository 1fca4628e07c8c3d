"""Port parity: sea_tpu_torch.ops.{layers, rope, attention} against the JAX
functions of sea_tpu.ops on the CPU.

Inputs come from numpy with a fixed seed; weights are JAX-initialised and
handed to the port through jax.tree.map(np.asarray, .) and from_numpy.
Tolerance: atol 1e-5 in f32 (the two frameworks sum in different orders;
every value here is O(1)). The bf16-cache case of mha_step uses 2e-2:
the port rounds q to the cache dtype as the flash-decode kernel does,
which the JAX XLA path does not.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sea_tpu.ops import attention as JA
from sea_tpu.ops import layers as JL
from sea_tpu.ops import rope as JR
from sea_tpu_torch.ops import attention as TA
from sea_tpu_torch.ops import layers as TL
from sea_tpu_torch.ops import rope as TR
from sea_tpu_torch.utils.params import from_numpy

torch.set_num_threads(2)

ATOL = 1e-5


def J(f, *arrays, **static):
    """f(*arrays, **static) through jax.jit: one compile instead of one
    per primitive, which keeps these tests fast on the CPU."""
    return jax.jit(functools.partial(f, **static))(*arrays)


def _t(tree):
    """JAX params (or an array) -> the port's tensors."""
    return from_numpy(jax.tree.map(np.asarray, tree), "cpu")


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, dtype=np.float32),
                               rtol=0, atol=atol)


def _x(*shape, seed=0):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _key(i):
    return jax.random.PRNGKey(i)


@functools.lru_cache(maxsize=None)
def _weights():
    """The JAX-initialised weights of every case, from one jit: random
    inits compile slowly on the CPU, and one compile is several times
    cheaper than one per case."""
    def init():
        return {
            "linear": JL.init_linear(_key(0), d_in=16, d_out=8,
                                     init="torch_default"),
            "linear_nobias": JL.init_linear(_key(1), d_in=16, d_out=8,
                                            bias=False),
            "mlp_1": JL.init_mlp(_key(2), dim_in=12, scale_ratio=2,
                                 dim_out=10, num_layers=1,
                                 init="torch_default"),
            "mlp_3": JL.init_mlp(_key(2), dim_in=12, scale_ratio=2,
                                 dim_out=10, num_layers=3,
                                 init="torch_default"),
            "scale_mlp": JL.init_scale_mlp(_key(3), d_in=20, d_out=6,
                                           hidden=24),
            "adaln": JL.init_adaln(_key(4), embed_dim=16, cond_dim=3,
                                   init="torch_default"),
            "mha": JA.init_attention(_key(5), embed_dim=16, n_heads=2,
                                     init="torch_default"),
            "mha_step": JA.init_attention(_key(6), embed_dim=32, n_heads=2,
                                          init="torch_default"),
        }
    return jax.jit(init)()


def _case_linear():
    p = _weights()["linear"]
    x = _x(3, 5, 16)
    return TL.linear(_t(p), torch.from_numpy(x)), J(JL.linear, p, x)


def _case_linear_nobias():
    p = _weights()["linear_nobias"]
    x = _x(4, 16)
    return TL.linear(_t(p), torch.from_numpy(x)), J(JL.linear, p, x)


def _case_layernorm(bias):
    p = {"w": _x(16, seed=1) + 1.0}
    if bias:
        p["b"] = _x(16, seed=2)
    x = _x(3, 5, 16) * 3.0 + 1.0
    return TL.layernorm(_t(p), torch.from_numpy(x)), J(JL.layernorm, p, x)


def _case_gelu():
    x = _x(7, 9) * 3.0
    return TL.gelu(torch.from_numpy(x)), J(JL.gelu, x)


def _case_mlp(num_layers):
    p = _weights()[f"mlp_{num_layers}"]
    x = _x(2, 3, 12)
    return TL.mlp(_t(p), torch.from_numpy(x)), J(JL.mlp, p, x)


def _case_scale_mlp():
    p = _weights()["scale_mlp"]
    x = _x(2, 4, 20)
    return TL.scale_mlp(_t(p), torch.from_numpy(x)), J(JL.scale_mlp, p, x)


def _adaln_params():
    p = dict(_weights()["adaln"])
    p["w"] = jnp.asarray(_x(16, seed=5))
    p["b"] = jnp.asarray(_x(16, seed=6))
    return p


def _case_adaln_cond():
    p, c = _adaln_params(), _x(2, 5, 3, seed=7)
    got = TL.adaln_cond(_t(p), torch.from_numpy(c))
    want = J(JL.adaln_cond, p, c)
    return torch.cat(got, -1), jnp.concatenate(want, -1)


def _case_adaln_modulate():
    p, x = _adaln_params(), _x(2, 5, 16)
    cw, cb = _x(2, 5, 16, seed=8), _x(2, 5, 16, seed=9)
    got = TL.adaln_modulate(_t(p), *map(torch.from_numpy, (x, cw, cb)))
    return got, J(JL.adaln_modulate, p, x, cw, cb)


def _case_apply_norm_adaln():
    p, x, c = _adaln_params(), _x(2, 5, 16), _x(2, 5, 3, seed=7)
    got = TL.apply_norm(_t(p), torch.from_numpy(x), torch.from_numpy(c))
    return got, J(JL.apply_norm, p, x, c)


def _case_apply_norm_ln():
    p, x = {"w": _x(16, seed=1)}, _x(2, 5, 16)
    got = TL.apply_norm(_t(p), torch.from_numpy(x), None)
    return got, J(JL.apply_norm, p, x)


def _case_pe_table():
    return TL.sinusoidal_pe_table(15, max_len=300, device="cpu"), \
        J(JL.sinusoidal_pe_table, d_model=15, max_len=300)


def _case_positional_encoding():
    table = J(JL.sinusoidal_pe_table, d_model=16, max_len=50)
    x = _x(2, 7, 16)
    return (TL.positional_encoding(_t(table), torch.from_numpy(x)),
            J(JL.positional_encoding, table, x))


def _case_rope_cos_sin():
    pos = np.arange(0, 400, 7, dtype=np.int32)
    got = TR.rope_cos_sin(64, torch.from_numpy(pos))
    want = J(lambda p: JR.rope_cos_sin(64, p), jnp.asarray(pos))
    return torch.cat(got, -1), jnp.concatenate(want, -1)


def _case_apply_rope():
    x = _x(2, 9, 3, 16)
    cos, sin = J(lambda pos: JR.rope_cos_sin(16, pos), jnp.arange(9))
    got = TR.apply_rope(torch.from_numpy(x), _t(cos), _t(sin))
    return got, J(JR.apply_rope, x, cos, sin)


def _case_attention_core(causal, src_len, Tk):
    q, k, v = _x(2, 6, 2, 8), _x(2, Tk, 2, 8, seed=1), _x(2, Tk, 2, 8, seed=2)
    got = TA.attention_core(*map(torch.from_numpy, (q, k, v)),
                            causal=causal, src_len=src_len)
    return got, J(JA.attention_core, q, k, v, causal=causal,
                    src_len=src_len)


def _case_mha(causal, rope, Tk):
    p = _weights()["mha"]
    xq, xkv = _x(2, 6, 16), _x(2, Tk, 16, seed=3)
    got = TA.mha(_t(p), torch.from_numpy(xq), torch.from_numpy(xkv),
                 n_heads=2, causal=causal, rope=rope)
    want = J(JA.mha, p, xq, xkv, n_heads=2, causal=causal, rope=rope,
             impl="xla")
    return got, want


CASES = {
    "linear": _case_linear,
    "linear_nobias": _case_linear_nobias,
    "layernorm": lambda: _case_layernorm(True),
    "layernorm_nobias": lambda: _case_layernorm(False),
    "gelu": _case_gelu,
    "mlp_1": lambda: _case_mlp(1),
    "mlp_3": lambda: _case_mlp(3),
    "scale_mlp": _case_scale_mlp,
    "adaln_cond": _case_adaln_cond,
    "adaln_modulate": _case_adaln_modulate,
    "apply_norm_adaln": _case_apply_norm_adaln,
    "apply_norm_ln": _case_apply_norm_ln,
    "pe_table_odd": _case_pe_table,
    "positional_encoding": _case_positional_encoding,
    "rope_cos_sin": _case_rope_cos_sin,
    "apply_rope": _case_apply_rope,
    "attention_causal": lambda: _case_attention_core(True, 0, 6),
    "attention_causal_src2": lambda: _case_attention_core(True, 2, 6),
    "attention_full_cross": lambda: _case_attention_core(False, 0, 4),
    "mha_causal_rope": lambda: _case_mha(True, True, 6),
    "mha_cross": lambda: _case_mha(False, False, 4),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_op_matches_jax(name):
    got, want = CASES[name]()
    _close(got, want)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_mha_step_matches_jax(cache_dtype):
    """One step at t=5 against a pre-filled cache: the output and the
    in-place cache write equal the JAX step's output and new cache."""
    B, T, C, H, t = 2, 8, 32, 2, 5
    p = _weights()["mha_step"]
    jdt = getattr(jnp, cache_dtype)
    kc, vc = _x(B, H, T, C // H, seed=4), _x(B, H, T, C // H, seed=5)
    cache = {"k": jnp.asarray(kc, jdt), "v": jnp.asarray(vc, jdt)}
    xq, xkv = _x(B, C, seed=6), _x(B, C, seed=7)
    want, want_cache = J(JA.mha_step, p, xq, xkv, cache, jnp.int32(t),
                         n_heads=H, rope=True)

    tdt = getattr(torch, cache_dtype)
    tcache = {"k": torch.from_numpy(kc).to(tdt),
              "v": torch.from_numpy(vc).to(tdt)}
    got = TA.mha_step(_t(p), torch.from_numpy(xq), torch.from_numpy(xkv),
                      tcache, torch.tensor([t], dtype=torch.int32),
                      n_heads=H, rope=True)
    atol = ATOL if cache_dtype == "float32" else 2e-2
    _close(got, want, atol=atol)
    for name in ("k", "v"):
        _close(tcache[name], want_cache[name].astype(jnp.float32), atol=atol)
