"""Functional NN primitives over parameter trees of tensors.

Counterpart of ``sea_tpu/ops/layers.py`` with the same parameter layout
(linear ``w`` is ``[d_in, d_out]``, ``y = x @ w + b``) and numerics:

- GELU is the exact erf form.
- LayerNorm: eps 1e-5, biased variance, statistics in f32, result in the
  input dtype.
- AdaLN keeps the reference's ``cond_weight + 1`` and additive-base quirks.

Two init families, as in the JAX package: ``normal002`` (N(0, 0.02)
weights, zero bias) and ``torch_default`` (uniform +-1/sqrt(fan_in)).
Init draws from an explicit ``torch.Generator`` on the generator's device.

The Gaussian Fourier features of the ib scaling (``gaussian_fourier``)
read their fixed matrix detached, as the JAX package's stop_gradient.
Dropout is the JAX package's position hash (``dropout``), so the masks
equal its masks from the same key. ``linear`` serves the reduced-precision
layouts of ``utils.precision`` as the JAX package does: bf16 ``w`` (up-cast
per call), int8 ``w_q`` with a per-column ``w_s``, and packed int4
``w_p4`` through ``ops.quant_matmul`` (the hand-written int4 kernel on the
card).

Inside ``parallel.collectives.sharded`` (a rank of a ``--mesh`` grid) the
leaves are this rank's shards (``parallel.mesh``): ``linear(tp_role=)``
runs a column- or row-parallel linear with Megatron's operators, ``mlp``
(``tp=True``) its distributed hidden LayerNorm, whose mean and variance
run over the global hidden width, and ``dropout`` hashes each element's
global flat position: its batch block's row offset included, so a rank
drops what one device drops.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from sea_tpu_torch.ops import fused_adaln, quant_matmul
from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.utils.prng import key_to_seed

LN_EPS = 1e-5


def gelu(x):
    return F.gelu(x)  # approximate="none": the exact erf form


# ---------------------------------------------------------------------------
# Linear
# ---------------------------------------------------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int, *,
                bias: bool = True, init: str = "normal002",
                dtype=torch.float32):
    """init: 'normal002' (N(0,.02)/zero-bias) or 'torch_default'."""
    if init == "normal002":
        w = 0.02 * torch.randn((d_in, d_out), generator=gen, dtype=dtype,
                               device=gen.device)
        b = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    elif init == "torch_default":
        bound = 1.0 / math.sqrt(d_in)
        w = torch.empty((d_in, d_out), dtype=dtype, device=gen.device
                        ).uniform_(-bound, bound, generator=gen)
        b = torch.empty((d_out,), dtype=dtype, device=gen.device
                        ).uniform_(-bound, bound, generator=gen)
    else:
        raise ValueError(f"unknown init {init!r}")
    p = {"w": w}
    if bias:
        p["b"] = b
    return p


# Activation-statistics hook (utils/calibration.py): None except inside
# capture_activation_stats(), when every linear call reports its input.
_CALIBRATION = None


def linear(params, x, tp_role=None):
    """y = x @ w + b over the layouts of a linear param dict (below).

    ``tp_role``, under a tensor-parallel grid (``parallel.collectives``):
    how this weight is split over the model ranks (``parallel.mesh``).
    "col": w's output columns, so the replicated x enters through
    ``copy_to_model`` and y is this rank's columns. "row": w's input rows,
    so x is this rank's slice of the input, the partial products are
    summed over the model ranks (``reduce_from_model``) and the
    replicated bias is added once, after the sum. A row-parallel packed
    int4 weight holds packed rows [m K/2M, (m+1) K/2M) of [K/2, N], each
    pairing inputs k and k + K/2: its x is the two slices of the gathered
    input at those offsets (the scales, linear, apply before the sum).
    None, or no grid: the plain linear."""
    grid = collectives.tensor_parallel() if tp_role else None
    if grid is None:
        return _linear(params, x)
    if tp_role == "col":
        return _linear(params, collectives.copy_to_model(x))
    if tp_role != "row":
        raise ValueError(f"tp_role {tp_role!r}: want 'col', 'row' or None")
    if "w_p4" in params:
        x = _int4_row_input(x, grid)
    y = collectives.reduce_from_model(
        _linear({k: v for k, v in params.items() if k != "b"}, x))
    return y + params["b"] if "b" in params else y


def _int4_row_input(x, grid):
    """The x slices a row-parallel packed int4 shard multiplies: of the
    input gathered over the model ranks, [m K/2M, (m+1) K/2M) and the
    same offset by K/2 (``parallel/kernel_shard.py``'s decomposition)."""
    full = collectives.all_gather_cat(x, x.dim() - 1, grid.model_group,
                                      grid.n_model)
    K = full.shape[-1]
    if (K // 2) % grid.n_model or K % 2:
        raise ValueError(f"a row-parallel int4 linear needs (K/2) % n_model "
                         f"== 0; got K={K} over {grid.n_model} model ranks")
    s = K // (2 * grid.n_model)
    lo = grid.model_rank * s
    return torch.cat([full[..., lo:lo + s],
                      full[..., K // 2 + lo:K // 2 + lo + s]], dim=-1)


def _linear(params, x):
    """y = x @ w + b over the layouts of a linear param dict:
    - "w" f32: one GEMM (F.linear takes [d_out, d_in]; the transposed view
      of the JAX-layout weight costs no copy and fuses the bias add);
    - "w" bf16 (``cast_weights_bf16``): both operands in their promoted
      type (f32 for f32 activations), as JAX's mixed-dtype matmul
      computes;
    - "w_q" int8 + "w_s" (``quantize_weights_int8``): (x @ w_q) * w_s,
      int8 values being exact in f32 as in bf16;
    - "w_p4" packed int4 + "w_s" (``quantize_weights_int4``):
      ``quant_matmul.int4_matmul``."""
    if _CALIBRATION is not None:
        _CALIBRATION.record(params, x)
    w = params.get("w")
    if w is not None:
        if w.dtype != x.dtype:
            dt = torch.promote_types(x.dtype, w.dtype)
            x, w = x.to(dt), w.to(dt)
        return F.linear(x, w.T, params.get("b"))
    if "w_p4" in params:
        y = quant_matmul.int4_matmul(x, params["w_p4"], params["w_s"])
    else:
        y = (x @ params["w_q"].float()) * params["w_s"]
    if "b" in params:
        y = y + params["b"]
    return y


# ---------------------------------------------------------------------------
# LayerNorm family
# ---------------------------------------------------------------------------

def init_layernorm(dim: int, *, device, bias: bool = True,
                   dtype=torch.float32):
    p = {"w": torch.ones((dim,), dtype=dtype, device=device)}
    if bias:
        p["b"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def _normalize(x, eps: float):
    """(x - mean) / sqrt(biased var + eps) over the last axis, in f32."""
    xf = x.float()
    return F.layer_norm(xf, (xf.shape[-1],), eps=eps)


def layernorm(params, x, eps: float = LN_EPS):
    y = _normalize(x, eps) * params["w"]
    if "b" in params:
        y = y + params["b"]
    return y.to(x.dtype)


def init_adaln(gen: torch.Generator, embed_dim: int, cond_dim: int, *,
               init: str = "normal002", dtype=torch.float32):
    return {
        "w": torch.ones((embed_dim,), dtype=dtype, device=gen.device),
        "b": torch.zeros((embed_dim,), dtype=dtype, device=gen.device),
        "cond_fc1": init_linear(gen, cond_dim, 2 * embed_dim, init=init,
                                dtype=dtype),
        "cond_fc2": init_linear(gen, 2 * embed_dim, 2 * embed_dim,
                                init=init, dtype=dtype),
    }


def adaln_cond(params, cond):
    """The ib-only half of AdaLN: cond -> (cond_weight + 1, cond_bias).
    Depends only on the conditioning, so a rollout computes it once for the
    whole horizon (models/temporal.precompute_cond_tables)."""
    h = linear(params["cond_fc1"], cond)
    h = F.silu(h)
    h = linear(params["cond_fc2"], h)
    cw, cb = torch.chunk(h, 2, dim=-1)
    return cw + 1.0, cb


def adaln_modulate(params, x, cw, cb, eps: float = LN_EPS):
    """The x half of AdaLN: normalize, then apply (base + cond) scale and
    shift. Where the JAX package takes its fused Pallas kernel — x
    [B, T, E] with time-constant cond cw/cb [B, 1, E], the teacher-forced
    training shape — this takes ``ops.fused_adaln`` (the CUDA kernels of
    ``csrc/fused_adaln.cu`` on a CUDA tensor). Everything else, such as the 2-D rollout step, is the
    plain formula, as in the JAX package."""
    if fused_adaln.fused_supported(x, cw, cb):
        return fused_adaln.fused_adaln_modulate(x, cw, cb, params["w"],
                                                params["b"], eps)
    out = _normalize(x, eps) * (params["w"] + cw) + (params["b"] + cb)
    return out.to(x.dtype)


def adaln(params, x, cond, eps: float = LN_EPS):
    cw, cb = adaln_cond(params, cond)
    return adaln_modulate(params, x, cw, cb, eps)


def apply_norm(params, x, cond=None):
    """AdaLN if the params carry a cond net, else LayerNorm (which ignores
    ``cond``)."""
    if "cond_fc1" in params:
        return adaln(params, x, cond)
    return layernorm(params, x)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, dim_in: int, *, scale_ratio: float = 4,
             dim_out=None, num_layers=None, init: str = "normal002",
             dtype=torch.float32):
    """Same layer sequence as sea_tpu.ops.layers.init_mlp:
    [Linear -> LN -> GELU] x (L-1) -> Linear, with L = max(num_layers, 2)."""
    if dim_out is None:
        dim_out = dim_in
    scaled = max(1, int(dim_in * scale_ratio))
    n = 1 if num_layers is None else num_layers
    dev = gen.device

    def hidden(d_in):
        return {"lin": init_linear(gen, d_in, scaled, init=init, dtype=dtype),
                "ln": init_layernorm(scaled, dtype=dtype, device=dev)}

    if n == 1:
        layers = [hidden(dim_in),
                  {"lin": init_linear(gen, scaled, dim_out, init=init,
                                      dtype=dtype)}]
    else:
        layers = ([hidden(dim_in)] + [hidden(scaled) for _ in range(n - 2)]
                  + [{"lin": init_linear(gen, scaled, dim_out, init=init,
                                         dtype=dtype)}])
    return {"layers": layers}


def mlp(params, x, *, dropout_rate: float = 0.0, dropout_key=None,
        tp: bool = False):
    """``dropout_key``: a PRNG key (``utils.prng``) for the trailing
    dropout of training; None (or rate 0) leaves the output as it is.
    ``tp``: the params are tensor-parallel (``parallel.mesh``'s MLP
    layout: first linear column-, last row-parallel), so under a
    tensor-parallel grid the hidden activation stays split over the model
    ranks and its LayerNorm is the distributed one."""
    layers = params["layers"]
    grid = collectives.tensor_parallel() if tp else None
    if grid is not None and len(layers) != 2:
        raise ValueError(f"a tensor-parallel MLP has two linears; this one "
                         f"has {len(layers)} (the middle ones would need the "
                         "hidden activation gathered)")
    for i, entry in enumerate(layers):
        role = None if grid is None else ("col" if i == 0 else "row")
        x = linear(entry["lin"], x, tp_role=role)
        if "ln" in entry:
            # GELU always follows a hidden LayerNorm (the reference MLP).
            norm = layernorm if grid is None else distributed_layernorm
            x = gelu(norm(entry["ln"], x))
    return dropout(x, dropout_rate, dropout_key)


def distributed_layernorm(params, x, eps: float = LN_EPS):
    """LayerNorm of a hidden activation split over the model ranks, x and
    the weights being this rank's columns: the mean, then the biased
    variance of the deviations, over the global width, each a per-row sum
    all-reduced over the model group (in f32)."""
    xf = x.float()
    n = xf.shape[-1] * collectives.tensor_parallel().n_model
    mean = collectives.all_reduce_model(xf.sum(-1, keepdim=True)) / n
    d = xf - mean
    var = collectives.all_reduce_model((d * d).sum(-1, keepdim=True)) / n
    y = d * torch.rsqrt(var + eps) * params["w"]
    if "b" in params:
        y = y + params["b"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# Dropout: the position hash of the JAX package
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF


def _mul32(u, c: int):
    """(u * c) mod 2**32 for int64 u in [0, 2**32), without int64
    overflow: c is split into 16-bit halves."""
    lo, hi = c & 0xFFFF, c >> 16
    return (u * lo + (((u * hi) & 0xFFFF) << 16)) & _M32


def dropout_keep_threshold(rate: float) -> int:
    """Hash values at or above this keep their element."""
    return min(2 ** 32 - 1, int(round(rate * 2.0 ** 32)))


def dropout_scale_from_positions(seed0: int, seed1: int, bh, q_pos, k_pos, *,
                                 rate: float):
    """{0, 1/(1-rate)} f32 dropout scale from global logical positions.

    Bit for bit ``dropout_scale_from_positions`` of
    ``sea_tpu/ops/flash_attention.py`` (and of the CUDA flash kernels):
    an int32 multiply-add of (q, k, bh, seed words) with wrap-around, then
    murmur3 fmix32 twice in uint32. Computed here in int64 masked to 32
    bits. seed0/seed1 are ints (int32 or uint32 words); bh, q_pos and
    k_pos are ints or integer tensors, broadcast together."""
    def term(x, c):
        return _mul32(torch.as_tensor(x, dtype=torch.int64) & _M32, c)

    u = (term(q_pos, 0x9E3779B9) + term(k_pos, 0x3243F6A9)
         + term(bh, 0x27D4EB2F) + ((seed0 * 0x165667B1 + seed1) & _M32))
    u = u & _M32
    for mult in (0x85EBCA6B, 0xC2B2AE35, 0x85EBCA6B, 0xC2B2AE35):
        u = u ^ (u >> 16)
        u = _mul32(u, mult)
    u = u ^ (u >> 16)
    inv = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32)
    keep = u >= dropout_keep_threshold(rate)
    return torch.where(keep, inv.to(keep.device),
                       torch.zeros((), dtype=torch.float32,
                                   device=keep.device))


def dropout(x, rate: float, key, positions=None):
    """Inverted dropout with the JAX package's flat-position hash
    (``sea_tpu/ops/layers.py::dropout``): element i of x in row-major
    order keeps when hash(s0=key[0], s1=key[1], bh=0, q=i, k=0) passes.
    ``key`` None or rate 0 returns x. ``positions``: each element's
    global flat position (``block_positions``); by default its flat index,
    offset under a grid by the rank's batch block (x split over the data
    ranks on its leading dim, as every activation of the models is), or
    under a seq grid the positions of its time block (x [B, Tl, ...]
    split over the seq ranks on dim 1)."""
    if rate == 0.0 or key is None:
        return x
    s0, s1 = key_to_seed(key)
    seq = collectives.seq_parallel()
    if positions is None and seq is not None:
        B, tl = x.shape[:2]
        positions = block_positions(
            x.shape, (0, collectives.time_offset(tl)) + (0,) * (x.dim() - 2),
            (B, tl * seq.n_seq) + tuple(x.shape[2:]), x.device)
    if positions is None:
        grid = collectives.current()
        start = 0 if grid is None else grid.data_rank * x.numel()
        positions = torch.arange(start, start + x.numel(), dtype=torch.int64,
                                 device=x.device).reshape(x.shape)
    scale = dropout_scale_from_positions(s0, s1, 0, positions, 0, rate=rate)
    return x * scale.to(x.dtype)


def block_positions(shape, starts, global_shape, device):
    """int64 [shape]: the row-major flat position in a tensor of
    ``global_shape`` of each element of its block of ``shape`` starting
    at index ``starts``."""
    pos = torch.zeros((), dtype=torch.int64, device=device)
    stride = 1
    for dim in reversed(range(len(shape))):
        idx = torch.arange(starts[dim], starts[dim] + shape[dim],
                           dtype=torch.int64, device=device)
        view = [1] * len(shape)
        view[dim] = shape[dim]
        pos = pos + idx.reshape(view) * stride
        stride *= global_shape[dim]
    return pos


def init_scale_mlp(gen: torch.Generator, d_in: int, d_out: int, hidden: int,
                   *, init: str = "torch_default", dtype=torch.float32):
    """up/downScaleMLP: Linear(no bias) -> GELU -> Linear."""
    return {
        "fc1": init_linear(gen, d_in, hidden, bias=False, init=init,
                           dtype=dtype),
        "fc2": init_linear(gen, hidden, d_out, init=init, dtype=dtype),
    }


def scale_mlp(params, x):
    return linear(params["fc2"], gelu(linear(params["fc1"], x)))


# ---------------------------------------------------------------------------
# Positional encodings
# ---------------------------------------------------------------------------

def sinusoidal_pe_table(d_model: int, max_len: int = 5000, *, device,
                        dtype=torch.float32):
    """Fixed sinusoidal table, including the odd-dim guard where cos uses
    only the first d_model//2 frequencies."""
    position = torch.arange(max_len, dtype=torch.float32,
                            device=device)[:, None]
    div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32,
                                      device=device)
                         * (-math.log(10000.0) / d_model))
    pe = torch.zeros((max_len, d_model), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div_term)
    pe[:, 1::2] = torch.cos(position * div_term[: d_model // 2])
    return pe.to(dtype)


def positional_encoding(pe_table, x, *, dropout_rate: float = 0.0,
                        dropout_key=None):
    """x: [..., T, D]; adds pe_table[:T] (under a seq grid the rows of
    this rank's time block), result in x's dtype, then the training
    dropout when given a key."""
    T = x.shape[-2]
    t0 = collectives.time_offset(T)
    return dropout((x + pe_table[t0:t0 + T]).to(x.dtype), dropout_rate,
                   dropout_key)


def init_gaussian_fourier(gen: torch.Generator, input_dim: int,
                          half_dim: int = 256, scale: float = 1.0,
                          dtype=torch.float32):
    """GaussianFourierProjection: a fixed N(0, scale^2) matrix W
    [input_dim, half_dim]."""
    return {"W": torch.randn((input_dim, half_dim), generator=gen,
                             dtype=dtype, device=gen.device) * scale}


def gaussian_fourier(params, x):
    """[sin(2 pi x W), cos(2 pi x W)] over the last axis. W is read
    detached, as the JAX package's stop_gradient: it takes no gradient
    (the train step hands the optimizer zeros for it)."""
    proj = (x @ params["W"].detach()) * (2.0 * math.pi)
    return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)
