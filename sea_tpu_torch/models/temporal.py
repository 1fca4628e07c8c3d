"""Stage-2 temporal model: causal transformer with State-Exchange Attention.

Counterpart of ``sea_tpu/models/temporal.py`` with the same parameter tree
(npz paths such as ``blocks/0/cross_attn/0/1/q/w``). Token contract: x
[B, T, G, E], ib [B, T, ib_num]; each of the G field streams runs causal
RoPE self-attention over time, then the exchange between the streams
(``exchange_mode``):

- "sea": for each ordered pair (i, j != i), down-project both streams,
  normalize, causally cross-attend i <- j, GELU, up-project, and add the
  sum over j to x_i. The update is sequential, as in the reference: field
  i exchanges against the already-updated fields j < i.
- "pool": every stream down-projects and normalizes (plus the sinusoidal
  table ``pool_pe``, a trained leaf as in the JAX package); a pool stream
  built from all of them (``pool_update_method``: a learned weighting,
  a linear or an MLP over their concatenation) is what each field
  causally cross-attends to. Parallel update. The learned ``pool_token``
  goes through ``ln_pool`` and the table and is then overwritten, as in
  the reference: dead computation, kept.
- "addition": each stream adds GELU of the sum of every field's
  normalized down-projection, up-projected. Parallel update.
- "simple": no exchange.

The ib conditioning is embedded by an MLP, a linear or Gaussian Fourier
features (``ib_scale_mode``) and added, concatenated or attended to
(``ib_addition_mode``), before or after the exchange.

``temporal_step`` is the one-token form the rollout runs, with a KV cache
per (layer, field) for self-attention, per (layer, ordered pair) for the
sea exchange and per (layer, field) for the pool exchange; every attention
in it goes through the flash-decode kernel (ops/decode_attention.py) on
the card. It serves the incremental configs only (no attention-mode ib,
src_len == 0), as in the JAX package: the others are not causal, and only
the prefix engine is exact for them.

``temporal_forward`` trains with dropout from the JAX package's key tree,
and takes ``valid_len`` for the masked prefix engine (rollout/engine.py).
``remat`` recomputes each block in the backward pass
(``torch.utils.checkpoint``, non-reentrant): True or "full" keeps only the
block's inputs, "dots" also keeps the outputs of the matrix products.
The stacked per-field path (``stack_fields``) is the same math as the
per-field loop.

Under a seq grid (``parallel.mesh.make_seq_mesh``) the same code runs on
this rank's time block: every attention over time as ring attention
(``ops.attention``), RoPE, the ``pool_pe`` rows and every dropout mask at
global positions (``ops.layers``), ``ib_time_constant`` off, as under the
JAX package's ``seq_mesh``.

Under a ``--mesh`` grid (``parallel.collectives.sharded``) the same code
runs on this rank's shards (``parallel.mesh.temporal_param_dims``): every
attention on its H/M heads, each field's MLP Megatron-split (``tp=True``),
the batch on its B/D rows; the caches of ``init_temporal_cache`` hold
the rank's heads.
"""

from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from sea_tpu_torch.configs.base import TemporalModelConfig
from sea_tpu_torch.ops import layers as L
from sea_tpu_torch.ops.attention import (init_attention, init_kv_cache,
                                         local_heads, mha, mha_step)
from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.utils.params import tree_map
from sea_tpu_torch.utils.prng import fold_in, split


def is_scan_incremental(cfg: TemporalModelConfig) -> bool:
    """True when the model is incrementally computable (the scan engine,
    ``temporal_step``): no attention-mode ib conditioning (unmasked over
    the ib stream) and src_len == 0 (with src_len > 0 token p attends
    p+1..p+src_len, so earlier states change as the prefix grows)."""
    return cfg.ib_addition_mode != "attention" and cfg.src_len == 0


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_norm(gen, dim: int, cond_dim: int, ln_type: str, dtype):
    if ln_type.lower() == "adaln":
        return L.init_adaln(gen, dim, cond_dim, init="normal002", dtype=dtype)
    # The reference's temporal LayerNorms carry no bias.
    return L.init_layernorm(dim, bias=False, dtype=dtype, device=gen.device)


def _init_ib_layer(gen, cfg: TemporalModelConfig, dtype):
    """The ib embedding: Gaussian Fourier features ({"W"}, ib_dim // 2
    frequencies), a linear, or the ib MLP."""
    if cfg.ib_scale_mode == "fourier":
        return L.init_gaussian_fourier(gen, cfg.ib_num, int(cfg.ib_dim // 2),
                                       dtype=dtype)
    if cfg.ib_scale_mode == "linear":
        return L.init_linear(gen, cfg.ib_num, cfg.ib_dim, dtype=dtype)
    return L.init_mlp(gen, cfg.ib_num, scale_ratio=cfg.scale_ratio,
                      dim_out=cfg.ib_dim, num_layers=cfg.ib_mlp_layers,
                      dtype=dtype)


def _init_pool_update(gen, cfg: TemporalModelConfig, dtype):
    G, dd = cfg.num_fields, cfg.down_dim
    if cfg.pool_update_method == "linear":
        return L.init_linear(gen, dd * G, dd, dtype=dtype)
    if cfg.pool_update_method == "mlp":
        return {"fc1": L.init_linear(gen, dd * G, dd * 2, dtype=dtype),
                "fc2": L.init_linear(gen, dd * 2, dd, dtype=dtype)}
    if cfg.pool_update_method == "pooling":
        return torch.ones((G,), dtype=dtype, device=gen.device) / G
    # The reference builds a GRU for "gru" but its pool update rejects it.
    raise NotImplementedError(
        f"pool_update_method={cfg.pool_update_method!r}: the reference's "
        "GRU variant is unreachable (its pool update rejects it); use "
        "linear, mlp or pooling")


def init_temporal_block(gen: torch.Generator, cfg: TemporalModelConfig,
                        dtype=torch.float32):
    G, D, dd = cfg.num_fields, cfg.internal_embed_dim, cfg.down_dim

    def norm(dim):
        return _init_norm(gen, dim, cfg.ib_num, cfg.ln_type, dtype)

    def attn(dim):
        return init_attention(gen, dim, cfg.n_heads, dtype=dtype)

    block = {
        "ib": _init_ib_layer(gen, cfg, dtype),
        # 3 norms per field; index 1 is unused by the reference forward and
        # kept for checkpoint parity.
        "ln_exp": [[norm(D) for _ in range(3)] for _ in range(G)],
        "self_attn": [attn(D) for _ in range(G)],
        "mlp": [L.init_mlp(gen, D, scale_ratio=cfg.scale_ratio, dtype=dtype)
                for _ in range(G)],
        "proj": [L.init_linear(gen, D, cfg.embed_dim, dtype=dtype)
                 for _ in range(G)],
    }
    if cfg.ib_addition_mode == "attention":
        block["cross_attn_ib"] = [attn(D) for _ in range(G)]
    if cfg.exchange_mode in ("sea", "addition", "pool"):
        block["cross_down"] = [L.init_linear(gen, D, dd, dtype=dtype)
                               for _ in range(G)]
        block["cross_up"] = [L.init_linear(gen, dd, D, dtype=dtype)
                             for _ in range(G)]
        block["ln_cross"] = [norm(dd) for _ in range(G)]
    if cfg.exchange_mode == "sea":
        # Full G x G lattice, unused diagonal included (checkpoint parity).
        block["cross_attn"] = [[attn(dd) for _ in range(G)]
                               for _ in range(G)]
    elif cfg.exchange_mode == "pool":
        block["pool_token"] = torch.randn((1, 1, dd), generator=gen,
                                          dtype=dtype, device=gen.device)
        block["cross_attn"] = [attn(dd) for _ in range(G)]
        block["ln_pool"] = norm(dd)
        block["pool_update"] = _init_pool_update(gen, cfg, dtype)
        block["pool_pe"] = L.sinusoidal_pe_table(dd, 5000, device=gen.device,
                                                 dtype=dtype)
    return block


def init_temporal(cfg: TemporalModelConfig, gen: torch.Generator, *,
                  device, dtype=torch.float32):
    """Same tree, shapes and N(0, 0.02) families as the JAX init_temporal,
    drawn from ``gen`` on its device and moved to ``device``."""
    params = {
        "blocks": [init_temporal_block(gen, cfg, dtype)
                   for _ in range(cfg.num_layers)],
        "ln_final": [_init_norm(gen, cfg.embed_dim, cfg.ib_num, cfg.ln_type,
                                dtype) for _ in range(cfg.num_fields)],
    }
    return tree_map(lambda a: a.to(device), params)


class TemporalModel(nn.Module):
    """Owns a temporal parameter tree; ``.to(device)`` moves every tensor.
    The functions of this module are the API; ``forward`` is
    ``temporal_forward``."""

    def __init__(self, cfg: TemporalModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = params

    def _apply(self, fn, recurse=True):
        self.params = tree_map(fn, self.params)
        return self

    def forward(self, x, ib):
        return temporal_forward(self.params, self.cfg, x, ib)


# ---------------------------------------------------------------------------
# Forward (full sequence): the teacher-forced training path, and the oracle
# that temporal_step is held to
# ---------------------------------------------------------------------------

def _fold(key, data):
    return None if key is None else fold_in(key, data)


def _sea_exchange(block, cfg: TemporalModelConfig, x_vars, ib, rng,
                  deterministic, valid_len=None):
    G = cfg.num_fields
    x_vars = list(x_vars)
    for i in range(G):
        x_i = L.apply_norm(block["ln_cross"][i],
                           L.linear(block["cross_down"][i], x_vars[i]), ib)
        acc = 0.0  # empty sum for G == 1
        for j in range(G):
            if i == j:
                continue
            x_j = L.apply_norm(block["ln_cross"][j],
                               L.linear(block["cross_down"][j], x_vars[j]), ib)
            attn = mha(block["cross_attn"][i][j], x_i, x_j,
                       n_heads=cfg.n_heads, causal=True, rope=True,
                       src_len=cfg.src_len, dropout_rate=cfg.dropout,
                       dropout_key=_fold(rng, i * G + j),
                       deterministic=deterministic, valid_len=valid_len)
            acc = acc + L.linear(block["cross_up"][i], L.gelu(attn))
        # Sequential update: field i+1 sees the updated field i.
        x_vars[i] = x_vars[i] + acc
    return x_vars


def _normed_down(block, x_vars, ib):
    """ln_cross(cross_down(x_i)) of every field."""
    return [L.apply_norm(block["ln_cross"][i],
                         L.linear(block["cross_down"][i], x), ib)
            for i, x in enumerate(x_vars)]


def _addition_update(block, x_vars, normed):
    """The addition exchange's parallel update from every field's
    normalized down-projection (forward and step alike)."""
    G = len(x_vars)
    out = []
    for i in range(G):
        others = sum(normed[j] for j in range(G) if j != i)
        out.append(x_vars[i] + L.linear(block["cross_up"][i],
                                        L.gelu(normed[i] + others)))
    return out


def _pool_stream(block, cfg: TemporalModelConfig, normed):
    """The pool stream from every field's normed down-projection:
    a learned weighting, a linear or an MLP over their concatenation."""
    update = block["pool_update"]
    if cfg.pool_update_method == "pooling":
        w = update.reshape((-1,) + (1,) * normed[0].dim())
        return torch.sum(torch.stack(normed) * w, dim=0)
    cat = torch.cat(normed, dim=-1)
    if cfg.pool_update_method == "linear":
        return L.linear(update, cat)
    return L.linear(update["fc2"], L.gelu(L.linear(update["fc1"], cat)))


def _pool_exchange(block, cfg: TemporalModelConfig, x_vars, ib,
                   deterministic, valid_len=None):
    """The pool exchange: each field's normed down-projection (plus the
    sinusoidal table) cross-attends causally to the pool stream; parallel
    update. Its attention has no dropout (no key), as in the JAX
    package."""
    normed = [L.positional_encoding(block["pool_pe"], n)
              for n in _normed_down(block, x_vars, ib)]
    # Dead computation kept from the reference: the learned token, its
    # norm (on the first step's cond) and the table, then overwritten by
    # the pool stream; nothing reads it.
    pool = block["pool_token"].expand(x_vars[0].shape[0], -1, -1)
    pool = L.apply_norm(block["ln_pool"], pool,
                        ib[:, :1] if ib is not None else None)
    L.positional_encoding(block["pool_pe"], pool)
    pool = _pool_stream(block, cfg, normed)
    out = []
    for i in range(cfg.num_fields):
        attn = mha(block["cross_attn"][i], normed[i], pool,
                   n_heads=cfg.n_heads, causal=True, rope=True,
                   src_len=cfg.src_len, dropout_rate=cfg.dropout,
                   dropout_key=None, deterministic=deterministic,
                   valid_len=valid_len)
        out.append(x_vars[i] + L.linear(block["cross_up"][i],
                                        L.gelu(normed[i] + attn)))
    return out


def _exchange(block, cfg: TemporalModelConfig, x_vars, ib, rng,
              deterministic, valid_len=None):
    mode = cfg.exchange_mode
    if mode == "simple":
        return x_vars
    if mode == "sea":
        return _sea_exchange(block, cfg, x_vars, ib, rng, deterministic,
                             valid_len)
    if mode == "addition":
        return _addition_update(block, x_vars,
                                _normed_down(block, x_vars, ib))
    return _pool_exchange(block, cfg, x_vars, ib, deterministic, valid_len)


def _ib_output(block, cfg: TemporalModelConfig, ib, dropout_key=None):
    """The ib embedding; only the MLP carries (training) dropout."""
    if cfg.ib_scale_mode == "fourier":
        return L.gaussian_fourier(block["ib"], ib)
    if cfg.ib_scale_mode == "linear":
        return L.linear(block["ib"], ib)
    return L.mlp(block["ib"], ib, dropout_rate=cfg.dropout,
                 dropout_key=dropout_key)


def _add_info(block, cfg: TemporalModelConfig, x, ib_out, i, key,
              deterministic, valid_len):
    """The ib injection of field i (``_add_info`` of the JAX package):
    ``ib_out`` is the ib embedding for this field; ``key`` the field's
    dropout key (the ib-attention's; the ib MLP took fold_in(key, 1))."""
    mode = cfg.ib_addition_mode
    if mode == "none":
        return x
    if mode == "add":
        return x + ib_out  # broadcasts over T for time-constant ib
    if mode == "concat":
        return torch.cat([x, ib_out.expand(x.shape[0], x.shape[1],
                                           ib_out.shape[2])], dim=-1)
    # attention: unmasked cross-attention over the ib embedding stream.
    return x + mha(block["cross_attn_ib"][i], x, ib_out,
                   n_heads=cfg.n_heads, causal=False, rope=False,
                   dropout_rate=cfg.dropout, dropout_key=key,
                   deterministic=deterministic, valid_len=valid_len)


def temporal_block(block, cfg: TemporalModelConfig, x_vars, ib, ib_cond, *,
                   rng=None, deterministic=True, valid_len=None):
    """One block. ``ib`` is the full [B, T, ib_num] stream, ``ib_cond``
    the one the ib-only sites see ([B, 1] rows when the conditioning is
    time-constant). ``rng``: the block's key; its four sub-keys drive the
    ib injection, self-attention, exchange and MLP dropout, with the JAX
    package's fold_in tree. ``valid_len``: see ``temporal_forward``."""
    G = cfg.num_fields
    x_vars = list(x_vars)
    train = rng is not None and not deterministic
    rngs = split(rng, 4) if train else [None] * 4
    # The ib MLP's trailing dropout keeps a mask per token (and per field),
    # so with it on the MLP sees the full stream, not the [B, 1] rows; so
    # does the ib-attention, whose keys run over time.
    ib_dropout = train and cfg.ib_scale_mode == "mlp" and cfg.dropout > 0.0
    ib_inject = (ib if ib_dropout or cfg.ib_addition_mode == "attention"
                 else ib_cond)

    def add_info(xs):
        if cfg.ib_addition_mode == "none":
            return xs
        keys = [_fold(rngs[0], i) for i in range(len(xs))]
        if ib_dropout:
            outs = [_ib_output(block, cfg, ib_inject, fold_in(key, 1))
                    for key in keys]
        else:
            outs = [_ib_output(block, cfg, ib_inject)] * len(xs)
        return [_add_info(block, cfg, x, o, i, key, deterministic, valid_len)
                for i, (x, o, key) in enumerate(zip(xs, outs, keys))]

    if not cfg.add_info_after_cross:
        x_vars = add_info(x_vars)
    for i in range(G):
        h = L.apply_norm(block["ln_exp"][i][0], x_vars[i], ib_cond)
        x_vars[i] = x_vars[i] + mha(block["self_attn"][i], h, h,
                                    n_heads=cfg.n_heads, causal=True,
                                    rope=True, src_len=cfg.src_len,
                                    dropout_rate=cfg.dropout,
                                    dropout_key=_fold(rngs[1], i),
                                    deterministic=deterministic,
                                    valid_len=valid_len)
    x_vars = _exchange(block, cfg, x_vars, ib_cond, rngs[2], deterministic,
                       valid_len)
    if cfg.add_info_after_cross:
        x_vars = add_info(x_vars)
    for i in range(G):
        h = L.apply_norm(block["ln_exp"][i][2], x_vars[i], ib_cond)
        x_vars[i] = x_vars[i] + L.mlp(block["mlp"][i], h,
                                      dropout_rate=cfg.dropout,
                                      dropout_key=_fold(rngs[3], i), tp=True)
        x_vars[i] = L.linear(block["proj"][i], x_vars[i])
    return x_vars


# remat="dots": the ops whose outputs are kept, as JAX's dots_saveable
# keeps its dot products. The flash forward is none of them (neither is a
# pallas_call a dot there), so both policies recompute it.
_MATMULS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
            torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default)


def _save_matmuls(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(block, cfg: TemporalModelConfig, x_vars, ib, ib_cond,
                 **kw):
    """temporal_block under torch.utils.checkpoint: the backward recomputes
    the block's forward from its inputs (True, "full"), keeping the matrix
    products' outputs ("dots"). Non-reentrant, so the train step's
    torch.autograd.grad reaches the parameters the block's closure
    captures; the dropout keys are the same, so the recomputation draws
    the same masks, and nothing in a block draws from torch's RNG."""
    context_fn = (functools.partial(create_selective_checkpoint_contexts,
                                    _save_matmuls)
                  if cfg.remat == "dots" else noop_context_fn)
    return checkpoint(functools.partial(temporal_block, block, cfg, **kw),
                      x_vars, ib, ib_cond, use_reentrant=False,
                      preserve_rng_state=False, context_fn=context_fn)


def temporal_forward(params, cfg: TemporalModelConfig, x, ib, *, rng=None,
                     deterministic: bool = True, valid_len=None):
    """x: [B, T, G, E], ib: [B, T, ib_num] -> [B, T, G, E].

    ``rng``: a PRNG key (``utils.prng``); with ``deterministic=False`` it
    drives dropout, block ``li`` taking ``fold_in(rng, li)`` as in the JAX
    package, so the masks are the JAX package's. Under a seq grid it runs
    on this rank's time block (module docstring); the stacked per-field
    path of the JAX package (``stack_fields``) is the same math as this
    per-field loop. ``cfg.remat`` checkpoints each block where a
    gradient is being taken (``_remat_block``).

    ``valid_len`` (an int, serving only): every attention reads the keys
    at positions < valid_len alone (``ops.attention.mha``), so the first
    valid_len outputs equal the forward of the valid_len-long prefix, for
    the non-causal configs too (ib-attention, src_len != 0). Everything
    outside attention is per token: positions past the prefix hold finite
    values that never feed back. As in the JAX package, the ib-only sites
    then see the full ib stream even for time-constant conditioning."""
    G = cfg.num_fields
    if x.shape[2] != G:
        raise ValueError(f"x has {x.shape[2]} fields, the config {G}")
    # ib_time_constant: ib-only sites compute on [B, 1] rows (same values);
    # off under a seq grid, as in the JAX package.
    ib_cond = (ib[:, :1] if cfg.ib_time_constant and valid_len is None
               and collectives.seq_parallel() is None else ib)
    train = rng is not None and not deterministic
    block_fn = (_remat_block if cfg.remat and torch.is_grad_enabled()
                else temporal_block)
    x_vars = [x[:, :, i, :] for i in range(G)]
    for li, block in enumerate(params["blocks"]):
        x_vars = block_fn(block, cfg, x_vars, ib, ib_cond,
                          rng=fold_in(rng, li) if train else None,
                          deterministic=deterministic, valid_len=valid_len)
    x_vars = [L.apply_norm(params["ln_final"][i], x_vars[i], ib_cond)
              for i in range(G)]
    return torch.stack(x_vars, dim=2)


# ---------------------------------------------------------------------------
# Incremental step (KV caches) — run by rollout/engine.rollout_scan
# ---------------------------------------------------------------------------

def init_temporal_cache(cfg: TemporalModelConfig, batch: int, t_max: int,
                        *, device, dtype=torch.float32):
    """Per layer: {"self": [cache per field]}, plus for the sea exchange
    "cross": G x G caches, None on the diagonal, and for the pool exchange
    "pool": a cache per field (each field's cross-attention has its own
    key/value projections of the shared pool stream). The addition and
    simple exchanges attend to nothing. Each cache {"k", "v"} [B, H,
    t_max, hd] of ``dtype`` (f32, bf16, or int8 with per-token scales
    "k_s"/"v_s" [B, H, t_max]; ops/attention.init_kv_cache)."""
    G = cfg.num_fields
    hd_self = cfg.internal_embed_dim // cfg.n_heads
    hd_cross = cfg.down_dim // cfg.n_heads

    def kv(hd):  # this rank's heads under a tensor-parallel grid
        return init_kv_cache(batch, t_max, local_heads(cfg.n_heads), hd,
                             device=device, dtype=dtype)

    layers = []
    for _ in range(cfg.num_layers):
        entry = {"self": [kv(hd_self) for _ in range(G)]}
        if cfg.exchange_mode == "sea":
            entry["cross"] = [[kv(hd_cross) if i != j else None
                               for j in range(G)] for i in range(G)]
        elif cfg.exchange_mode == "pool":
            entry["pool"] = [kv(hd_cross) for _ in range(G)]
        layers.append(entry)
    return layers


def precompute_cond_tables(params, cfg: TemporalModelConfig, ib):
    """Every ib-only activation of a rollout horizon at once: AdaLN cond
    nets and the ib embedding depend only on ib, not on the state.

    ib: [B, T, ib_num]. Returns TIME-MAJOR [T, B, dim] tensors: per block
    {"ln_exp": [[site0, site2] per field], "ln_cross": [...], "ib_out"},
    plus "ln_final". Plain-LN sites hold None, and so do "ln_cross" where
    the block has no exchange norms (simple) and "ib_out" where the ib is
    not added or concatenated."""
    def norm_cond(p):
        if "cond_fc1" not in p:
            return None
        cw, cb = L.adaln_cond(p, ib)  # [B, T, dim]
        return (cw.transpose(0, 1).contiguous(),
                cb.transpose(0, 1).contiguous())

    G = cfg.num_fields
    blocks = [{"ln_exp": [[norm_cond(block["ln_exp"][i][s]) for s in (0, 2)]
                          for i in range(G)],
               "ln_cross": ([norm_cond(p) for p in block["ln_cross"]]
                            if "ln_cross" in block else None),
               "ib_out": (_ib_output(block, cfg, ib).transpose(0, 1)
                          .contiguous()
                          if cfg.ib_addition_mode in ("add", "concat")
                          else None)}
              for block in params["blocks"]]
    return {"blocks": blocks,
            "ln_final": [norm_cond(p) for p in params["ln_final"]]}


def _norm_t(p, x, ib_t, c):
    """Per-step norm: a precomputed AdaLN cond when there is one, else the
    full apply (plain LN ignores ib_t)."""
    if c is not None:
        return L.adaln_modulate(p, x, c[0], c[1])
    return L.apply_norm(p, x, ib_t)


def _get(tree, *path):
    """tree[path[0]][path[1]]..., or None where a level is missing."""
    for key in path:
        if tree is None:
            return None
        tree = tree[key]
    return tree


def temporal_step(params, cfg: TemporalModelConfig, x_t, ib_t, cache, t,
                  cond_t=None):
    """One autoregressive step at absolute position ``t``.

    x_t: [B, G, E]; ib_t: [B, ib_num]; cache: from init_temporal_cache,
    updated IN PLACE at position t; t: int32 tensor of shape [1] on the
    device; cond_t: optional step-t slice of precompute_cond_tables.
    Returns y_t [B, G, E] = temporal_forward(x[:, :t+1])[:, t]. Raises
    ValueError for a config that is not incremental (``is_scan_incremental``).
    """
    if not is_scan_incremental(cfg):
        raise ValueError(
            "temporal_step requires a scan-incremental config (no attention "
            "ib-conditioning, src_len == 0); the others serve on the masked "
            "prefix engine (rollout.engine.rollout_prefix_bucketed)")
    G = cfg.num_fields
    x_vars = [x_t[:, i, :] for i in range(G)]

    def add_info(block, bc, xs):
        if cfg.ib_addition_mode == "none":
            return xs
        ib_out = _get(bc, "ib_out")
        if ib_out is None:
            ib_out = _ib_output(block, cfg, ib_t)
        if cfg.ib_addition_mode == "concat":
            return [torch.cat([x, ib_out], dim=-1) for x in xs]
        return [x + ib_out for x in xs]

    def normed_down(block, bc, xs):
        return [_norm_t(block["ln_cross"][i],
                        L.linear(block["cross_down"][i], x), ib_t,
                        _get(bc, "ln_cross", i)) for i, x in enumerate(xs)]

    for li, block in enumerate(params["blocks"]):
        bc = _get(cond_t, "blocks", li)
        lcache = cache[li]
        if not cfg.add_info_after_cross:
            x_vars = add_info(block, bc, x_vars)

        for i in range(G):
            h = _norm_t(block["ln_exp"][i][0], x_vars[i], ib_t,
                        _get(bc, "ln_exp", i, 0))
            x_vars[i] = x_vars[i] + mha_step(
                block["self_attn"][i], h, h, lcache["self"][i], t,
                n_heads=cfg.n_heads, rope=True)

        if cfg.exchange_mode == "sea":
            for i in range(G):
                # x_vars[i] is constant over the j loop: its side is hoisted.
                x_i = _norm_t(block["ln_cross"][i],
                              L.linear(block["cross_down"][i], x_vars[i]),
                              ib_t, _get(bc, "ln_cross", i))
                acc = 0.0  # empty sum for G == 1
                for j in range(G):
                    if i == j:
                        continue
                    x_j = _norm_t(block["ln_cross"][j],
                                  L.linear(block["cross_down"][j], x_vars[j]),
                                  ib_t, _get(bc, "ln_cross", j))
                    attn = mha_step(block["cross_attn"][i][j], x_i, x_j,
                                    lcache["cross"][i][j], t,
                                    n_heads=cfg.n_heads, rope=True)
                    acc = acc + L.linear(block["cross_up"][i], L.gelu(attn))
                # Sequential update, as in temporal_forward.
                x_vars[i] = x_vars[i] + acc
        elif cfg.exchange_mode == "addition":
            x_vars = _addition_update(block, x_vars,
                                      normed_down(block, bc, x_vars))
        elif cfg.exchange_mode == "pool":
            # The table's row t, read on the device at the position t; the
            # pool token's dead computation is skipped (nothing reads it).
            pe_t = block["pool_pe"].index_select(0, t)
            normed = [n + pe_t for n in normed_down(block, bc, x_vars)]
            pool = _pool_stream(block, cfg, normed)
            x_vars = [x + L.linear(block["cross_up"][i], L.gelu(
                normed[i] + mha_step(block["cross_attn"][i], normed[i], pool,
                                     lcache["pool"][i], t,
                                     n_heads=cfg.n_heads, rope=True)))
                      for i, x in enumerate(x_vars)]

        if cfg.add_info_after_cross:
            x_vars = add_info(block, bc, x_vars)

        for i in range(G):
            h = _norm_t(block["ln_exp"][i][2], x_vars[i], ib_t,
                        _get(bc, "ln_exp", i, 1))
            x_vars[i] = x_vars[i] + L.mlp(block["mlp"][i], h, tp=True)
            x_vars[i] = L.linear(block["proj"][i], x_vars[i])

    x_vars = [_norm_t(params["ln_final"][i], x_vars[i], ib_t,
                      _get(cond_t, "ln_final", i)) for i in range(G)]
    return torch.stack(x_vars, dim=1)
