"""Multi-head attention over parameter trees of tensors.

Counterpart of ``sea_tpu/ops/attention.py``: q/k/v linears with bias and a
bias-free output projection, RoPE on [B, T, H, hd], softmax statistics in
f32. The full-sequence path (``mha``) runs ``ops.flash_attention`` — on a
CUDA tensor the hand-written flash kernels at any T, with the
attention-probability dropout hashed inside them; on the CPU their plain
version. The JAX package sends only T >= 256 (with dropout) or T >= 1024
to its kernel, thresholds measured on a TPU; below them its XLA path keys
dropout on the flat index of the probabilities instead of (bh, q, k), so
the bits differ there while the distribution is the same (ROADMAP.md,
Queue 3). ``impl="plain"`` keeps the einsum path for the stage-1 encoder,
which the JAX package never sends to a kernel either; its dropout is the
JAX XLA path's, the position hash over the flat index of the
probabilities [B, H, Tq, Tk] (``layers.dropout``), so its masks are
JAX's bit for bit.

``mha_step``, the one-token form the rollout runs, attends over a
head-major [B, H, T, hd] KV cache through ``ops.decode_attention`` — the
hand-written flash-decode kernel on a CUDA tensor, its plain version on
the CPU. The cache is f32, bf16, or int8 planes with a per-token f32
scale beside them (``_quantize_token``), read by the int8 variant of the
kernel. The fused "qkv"/"kv" projections of the serving transform
``utils.precision.fuse_attention_projections`` are taken as in the JAX
package.

``valid_len`` (``mha``, ``multihead_core``) keeps only the first
``valid_len`` keys, as the JAX package's key mask in ``attention_core``
does for its masked prefix engine: after RoPE, k and v are cut to that
prefix (views, no copy) and the attention, flash or plain, runs with
Tk = valid_len, so on the card the flash forward kernel bounds every
row's key walk there with no argument of its own. Serving only: with
dropout or a gradient it raises.

Under a tensor-parallel grid (``parallel.collectives.sharded``) the
attention params are this rank's H/M heads (``parallel.mesh``): q, k and
v column-parallel, the output projection row-parallel and summed over the
model ranks. ``mha`` then runs the flash kernels on (B/D, H/M) with
``bh_map`` = (b0 + b) H + (h0 + h), so the dropout hashes the global rows
(the plain path hashes the probabilities' global flat positions), and
``mha_step`` attends over this rank's caches [B/D, H/M, T, hd].

Under a seq grid (``parallel.mesh.make_seq_mesh``, ``--seq_parallel``)
every full-sequence attention runs as ring attention
(``parallel.ring_attention``) on this rank's time block, with RoPE at the
block's global positions, as the JAX package's ``impl="ring"`` does under
its ``seq_mesh``.

Not ported: ``src_len != 0`` in ``mha_step`` (the non-causal configs
serve on the masked prefix engine, as in the JAX package).
"""

from __future__ import annotations

import torch

from sea_tpu_torch.ops.decode_attention import decode_attention
from sea_tpu_torch.ops.flash_attention import flash_attention
from sea_tpu_torch.ops.layers import (block_positions, dropout, init_linear,
                                      linear)
from sea_tpu_torch.ops.rope import apply_rope, rope_cos_sin
from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.utils.prng import key_to_seed


def init_attention(gen: torch.Generator, embed_dim: int, n_heads: int, *,
                   init: str = "normal002", dtype=torch.float32):
    if embed_dim % n_heads:
        raise ValueError(f"embed_dim {embed_dim} is not divisible by "
                         f"n_heads {n_heads}")
    return {
        "q": init_linear(gen, embed_dim, embed_dim, init=init, dtype=dtype),
        "k": init_linear(gen, embed_dim, embed_dim, init=init, dtype=dtype),
        "v": init_linear(gen, embed_dim, embed_dim, init=init, dtype=dtype),
        "proj": init_linear(gen, embed_dim, embed_dim, bias=False, init=init,
                            dtype=dtype),
    }


def _project_qkv(params, x_q, x_kv):
    """q/k/v projections, unfused or in the fused serving layouts: "qkv"
    (self-attention: x_q and x_kv must be the same tensor) or "kv" (the
    shared key/value input). Per output column the math is the unfused
    projections'."""
    if "qkv" in params:
        if x_q is not x_kv:
            raise ValueError(
                "fused 'qkv' projections are only valid for self-attention "
                "(query and key/value inputs must be the same tensor); "
                "cross-attention params should carry fused 'kv' instead "
                "(utils.precision.fuse_attention_projections)")
        return torch.chunk(linear(params["qkv"], x_q), 3, dim=-1)
    q = linear(params["q"], x_q, tp_role="col")
    if "kv" in params:
        k, v = torch.chunk(linear(params["kv"], x_kv), 2, dim=-1)
    else:
        k, v = (linear(params["k"], x_kv, tp_role="col"),
                linear(params["v"], x_kv, tp_role="col"))
    return q, k, v


def local_heads(n_heads: int) -> int:
    """The heads this rank holds: n_heads, or its share under a
    tensor-parallel grid."""
    grid = collectives.tensor_parallel()
    return n_heads if grid is None else grid.local_heads(n_heads)


def attention_core(q, k, v, *, causal: bool, src_len: int = 0,
                   dropout_rate: float = 0.0, dropout_key=None):
    """q: [B,Tq,H,hd], k/v: [B,Tk,H,hd] -> [B,Tq,H,hd]. The causal mask
    admits key j for query i when j <= i + src_len. With a rate and a key
    (``utils.prng``) the f32 probabilities are dropped by ``layers.
    dropout``, at their global flat positions under a grid (the rank's
    batch block and heads of [B, H, Tq, Tk])."""
    hd = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                          k.float()) * hd ** -0.5
    if causal:
        Tq, Tk = q.shape[1], k.shape[1]
        qi = torch.arange(Tq, device=q.device)[:, None]
        kj = torch.arange(Tk, device=q.device)[None, :]
        scores = scores.masked_fill(kj > qi + src_len, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    grid = collectives.current()
    positions = None
    if grid is not None and dropout_rate and dropout_key is not None:
        B, H = probs.shape[:2]  # this rank's batch block and heads
        positions = block_positions(
            probs.shape, (grid.data_rank * B, grid.model_rank * H, 0, 0),
            (B * grid.n_data, H * grid.n_model) + tuple(probs.shape[2:]),
            probs.device)
    probs = dropout(probs, dropout_rate, dropout_key, positions)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)


def multihead_core(q, k, v, *, n_heads: int, causal: bool, rope: bool,
                   src_len: int = 0, dropout_rate: float = 0.0,
                   dropout_key=None, deterministic: bool = True,
                   impl: str = "flash", valid_len=None):
    """Between the projections and the output projection: head split,
    RoPE, attention, head merge. q: [B, Tq, C]; k, v: [B, Tk, C].

    Dropout applies when training (``deterministic`` False) with a rate
    and a key (``utils.prng``), as in the JAX package. impl: "flash" (the
    kernels on CUDA) or "plain" (einsum; dropout on the probabilities'
    flat index, as JAX's XLA path); a current seq grid
    (``collectives.seq_parallel``) runs ring attention whatever impl
    says. ``valid_len`` (an int): only keys at positions < valid_len are
    attended (the masked prefix engine); it raises with dropout or a
    gradient."""
    B, Tq, C = q.shape
    hd = C // n_heads
    q = q.reshape(B, Tq, n_heads, hd)
    k = k.reshape(B, k.shape[1], n_heads, hd)
    v = v.reshape(B, v.shape[1], n_heads, hd)
    seq = collectives.seq_parallel()
    if rope:  # global positions: this rank's time block under a seq grid
        def positions(t):
            t0 = collectives.time_offset(t)
            return torch.arange(t0, t0 + t, device=q.device)
        cos_q, sin_q = rope_cos_sin(hd, positions(Tq))
        q = apply_rope(q, cos_q, sin_q)
        cos_k, sin_k = rope_cos_sin(hd, positions(k.shape[1]))
        k = apply_rope(k, cos_k, sin_k)
    rate = (dropout_rate if dropout_rate > 0.0 and not deterministic
            and dropout_key is not None else 0.0)
    if seq is not None:
        if valid_len is not None:
            raise ValueError("valid_len (masked prefix rollout) is not "
                             "supported under ring attention")
        from sea_tpu_torch.parallel.ring_attention import ring_attention
        out = ring_attention(
            q, k, v, seq, causal=causal, src_len=src_len, dropout_rate=rate,
            dropout_seed=key_to_seed(dropout_key) if rate else None)
        return out.reshape(B, Tq, C)
    if valid_len is not None:
        if rate or (torch.is_grad_enabled()
                    and (q.requires_grad or k.requires_grad
                         or v.requires_grad)):
            raise ValueError("valid_len is for serving (the masked prefix "
                             "engine): no dropout, no gradient")
        if not 1 <= valid_len <= k.shape[1]:
            raise ValueError(f"valid_len {valid_len} not in "
                             f"[1, {k.shape[1]}]")
        # Views with the strides kept: the flash kernels take them as
        # they are. Query rows past the prefix stay finite, never read.
        k, v = k[:, :valid_len], v[:, :valid_len]
    if impl == "flash":
        grid = collectives.current()
        bh_map = None
        if grid is not None and rate:  # n_heads: this rank's heads
            bh_map = grid.bh_map(B, n_heads, n_heads * grid.n_model,
                                 q.device)
        out = flash_attention(
            q, k, v, causal, src_len, dropout_rate=rate,
            dropout_seed=key_to_seed(dropout_key) if rate else None,
            bh_map=bh_map)
    elif impl == "plain":
        out = attention_core(q, k, v, causal=causal, src_len=src_len,
                             dropout_rate=rate, dropout_key=dropout_key)
    else:
        raise ValueError(f"impl {impl!r}: want 'flash' or 'plain'")
    return out.reshape(B, Tq, C)


def mha(params, x_q, x_kv, *, n_heads: int, causal: bool, rope: bool,
        src_len: int = 0, dropout_rate: float = 0.0, dropout_key=None,
        deterministic: bool = True, impl: str = "flash", valid_len=None):
    """Full-sequence multi-head attention. x_q: [B, Tq, C]; x_kv:
    [B, Tk, C]; ``valid_len``: see ``multihead_core``."""
    q, k, v = _project_qkv(params, x_q, x_kv)
    out = multihead_core(q, k, v, n_heads=local_heads(n_heads), causal=causal,
                         rope=rope, src_len=src_len,
                         dropout_rate=dropout_rate, dropout_key=dropout_key,
                         deterministic=deterministic, impl=impl,
                         valid_len=valid_len)
    return linear(params["proj"], out, tp_role="row")


def init_kv_cache(batch: int, t_max: int, n_heads: int, head_dim: int, *,
                  device, dtype=torch.float32):
    """Head-major [B, H, T, hd] planes of ``dtype`` (f32, bf16 or int8).
    An int8 cache also holds "k_s"/"v_s", f32 [B, H, T]: each token is
    quantized when it is written, with its own per-(b, h) scale."""
    if dtype not in (torch.float32, torch.bfloat16, torch.int8):
        raise ValueError(f"KV cache dtype {dtype}: want float32, bfloat16 "
                         "or int8")
    shape = (batch, n_heads, t_max, head_dim)
    cache = {"k": torch.zeros(shape, dtype=dtype, device=device),
             "v": torch.zeros(shape, dtype=dtype, device=device)}
    if dtype == torch.int8:
        for name in ("k_s", "v_s"):
            cache[name] = torch.zeros(shape[:3], dtype=torch.float32,
                                      device=device)
    return cache


def _quantize_token(x, int_max: float = 127.0):
    """x: [B, H, hd] f32 -> (int8 [B, H, hd], scale f32 [B, H]): symmetric
    per-(b, h) max-abs scale, rounded half to even; a zero token gets scale
    0 (its slot dequantizes to exact zeros). Bit for bit the JAX package's
    as its jitted rollout computes it: XLA turns "/ int_max" into a
    multiply by the f32 reciprocal, and so does this."""
    inv = float(torch.tensor(1.0 / int_max, dtype=torch.float32))
    scale = x.abs().amax(dim=-1) * inv
    q = torch.where(scale[..., None] > 0.0,
                    x / torch.clamp(scale[..., None], min=1e-30), 0.0)
    return torch.round(q).to(torch.int8), scale


def mha_step(params, x_q_t, x_kv_t, cache, t, *, n_heads: int, rope: bool):
    """One-token attention at absolute position ``t`` against a KV cache.

    x_q_t, x_kv_t: [B, C]; cache: from init_kv_cache; t: int32 tensor of
    shape [1] on the cache's device (kept on the device so the step never
    reads it back on the host).

    Unlike the JAX package, which rebuilds the cache functionally, this
    writes position t of the preallocated cache IN PLACE (the int8 planes
    and their scales alike) and returns only the output [B, C]. Causal
    with src_len == 0: the attention reads positions <= t.
    """
    B, C = x_q_t.shape
    hd = C // n_heads
    n_heads = local_heads(n_heads)
    C = n_heads * hd
    q, k, v = _project_qkv(params, x_q_t, x_kv_t)
    q = q.reshape(B, 1, n_heads, hd)
    k = k.reshape(B, 1, n_heads, hd)
    if rope:
        cos, sin = rope_cos_sin(hd, t)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k = k.reshape(B, n_heads, 1, hd)  # [B, 1, H, hd] -> head-major
    v = v.reshape(B, n_heads, 1, hd)
    cache_k, cache_v = cache["k"], cache["v"]
    scales = {}
    if "k_s" in cache:
        kq, ks = _quantize_token(k[:, :, 0])
        vq, vs = _quantize_token(v[:, :, 0])
        cache_k[:, :, t] = kq[:, :, None]
        cache_v[:, :, t] = vq[:, :, None]
        cache["k_s"][:, :, t] = ks[:, :, None]
        cache["v_s"][:, :, t] = vs[:, :, None]
        scales = {"k_scale": cache["k_s"], "v_scale": cache["v_s"]}
    else:
        cache_k[:, :, t] = k.to(cache_k.dtype)
        cache_v[:, :, t] = v.to(cache_v.dtype)
    out = decode_attention(q.reshape(B, n_heads, hd), cache_k, cache_v, t,
                           **scales)
    return linear(params["proj"], out.to(x_q_t.dtype).reshape(B, C),
                  tp_role="row")
