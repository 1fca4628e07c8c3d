"""Reduced-precision serving transforms of parameter trees.

Counterpart of ``sea_tpu/utils/precision.py`` (its serving half): the
same walks over the JAX package's param layout, with the same results bit
for bit where the arithmetic is elementwise (casts, int8 and max-scaled
int4, the fused projections). Each big 2-D linear weight (``{"w": [in,
out], ...}`` with at least ``min_size`` elements) becomes

- bf16 ``w`` (``cast_weights_bf16``),
- ``{"w_q": int8 [in, out], "w_s": f32 [out]}`` (``quantize_weights_int8``),
- ``{"w_p4": uint8 [in/2, out], "w_s": f32 [out]}``
  (``quantize_weights_int4``: packed nibbles, ``ops.quant_matmul``),

and ``ops.layers.linear`` serves each layout. Norms, biases, tables and
small matrices stay as they are. Apply ``fuse_attention_projections``
first, so a fused weight is cast or quantized as one matrix.

The bf16 training policies (``train_cast``, ``POLICY_BY_FLAG``) and the
whole-tree cast they use (``to_bf16``) follow
``sea_tpu/utils/precision.py`` too.
"""

from __future__ import annotations

import torch

from sea_tpu_torch.ops.quant_matmul import pack_int4, unpack_int4
from sea_tpu_torch.utils.params import tree_map

# The 13 clip ratios of the int4 scale search (fractions of the column max).
INT4_CLIP_RATIOS = (0.4, 0.45, 0.5, 0.55, 0.6, 0.65, 0.7, 0.75, 0.8, 0.85,
                    0.9, 0.95, 1.0)
_INV7 = float(torch.tensor(1.0 / 7.0, dtype=torch.float32))


def _is_big_weight(node, min_size):
    w = node.get("w")
    return (isinstance(w, torch.Tensor) and w.dim() == 2
            and w.numel() >= min_size and w.is_floating_point())


def _quantize_weights(tree, min_size, quantize_leaf, q_key="w_q",
                      extra_pred=None, post=None):
    """Shared walk of the weight-only quantizers: rewrite each big 2-D
    linear weight to ``{q_key: quantized, "w_s": f32 [out], ...}``.
    quantize_leaf(w, path) -> (q, s); post(out, w, q, s, path), if given,
    may change the rewritten dict (bias correction). Paths are tuples of
    dict keys and list indices, the address space of
    ``utils.calibration``."""
    def walk(node, path=()):
        if isinstance(node, dict):
            if _is_big_weight(node, min_size) and (
                    extra_pred is None or extra_pred(node["w"])):
                w = node["w"].float()
                q, s = quantize_leaf(w, path)
                out = {k: walk(v, path + (k,))
                       for k, v in node.items() if k != "w"}
                out[q_key] = q
                out["w_s"] = s
                if post is not None:
                    post(out, w, q, s, path)
                return out
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (i,))
                              for i, v in enumerate(node))
        return node

    return walk(tree)


def quantize_weights_int8(tree, min_size: int = 1 << 16):
    """Weight-only int8: symmetric per-output-channel, [-127, 127]."""
    def leaf(w, path):
        s = w.abs().amax(dim=0) / 127.0
        s = torch.where(s == 0.0, torch.ones_like(s), s)
        q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
        return q, s
    return _quantize_weights(tree, min_size, leaf)


def _int4_leaf(w, d, scale: str):
    """(packed uint8 [K/2, N], f32 scale [N]) of one weight; d [K, 1] is
    the per-input-channel weight of the clip search's error."""
    # XLA compiles the JAX package's jitted "/ 7.0" into a multiply by the
    # f32 reciprocal; so does this, for the same scales bit for bit.
    s_max = w.abs().amax(dim=0) * _INV7
    s_max = torch.where(s_max == 0.0, torch.ones_like(s_max), s_max)
    if scale == "max":
        q = torch.clamp(torch.round(w / s_max), -7, 7)
        return pack_int4(q.to(torch.int8)), s_max
    best_s = s_max
    best_err = torch.full_like(s_max, float("inf"))
    for r in INT4_CLIP_RATIOS:
        cand = s_max * r
        q_c = torch.clamp(torch.round(w / cand), -7, 7)
        err = torch.sum(d * (q_c * cand - w) ** 2, dim=0)
        best_s = torch.where(err < best_err, cand, best_s)
        best_err = torch.minimum(err, best_err)
    q = torch.clamp(torch.round(w / best_s), -7, 7)
    return pack_int4(q.to(torch.int8)), best_s


def quantize_weights_int4(tree, min_size: int = 1 << 16,
                          scale: str = "mse", act_stats=None):
    """Weight-only int4, symmetric per-output-channel in [-7, 7], packed
    two per byte along the input dim.

    scale: "mse" sweeps INT4_CLIP_RATIOS of the column max and keeps the
    scale with the least squared reconstruction error per column; "max"
    takes the column max. act_stats (``utils.calibration``, on the same
    tree layout) weights that error by E[x_k^2] per input channel and
    folds the systematic output error E[x] @ (w - q s) into the bias
    (creating one where the linear had none). Odd input dims cannot pack
    and stay as they are."""
    if scale not in ("mse", "max"):
        raise ValueError(f"scale must be 'mse' or 'max', got {scale!r}")

    def leaf(w, path):
        stats = act_stats.get(path) if act_stats else None
        d = (stats["sq"].float().reshape(-1, 1) if stats is not None
             else torch.ones((w.shape[0], 1), dtype=torch.float32,
                             device=w.device))
        return _int4_leaf(w, d, scale)

    def post(out, w, q, s, path):
        stats = act_stats.get(path) if act_stats else None
        if stats is None:
            return
        w_hat = unpack_int4(out["w_p4"], torch.float32) * s
        db = stats["mean"].float() @ (w - w_hat)
        out["b"] = (out["b"] + db) if "b" in out else db

    return _quantize_weights(tree, min_size, leaf, q_key="w_p4",
                             extra_pred=lambda w: w.shape[0] % 2 == 0,
                             post=post)


def fuse_attention_projections(temporal_params):
    """Serving transform of TEMPORAL params: self-attention q+k+v -> one
    "qkv" linear, cross-attention k+v -> one "kv" linear (columns
    concatenated in that order), so a rollout step runs fewer matvecs.
    Per output column the math is unchanged."""
    def fuse(att, keys, name):
        merged = {"w": torch.cat([att[k]["w"] for k in keys], dim=1)}
        if "b" in att[keys[0]]:
            merged["b"] = torch.cat([att[k]["b"] for k in keys], dim=0)
        out = {k: v for k, v in att.items() if k not in keys}
        out[name] = merged
        return out

    def fuse_list(lst, keys, name):
        return [fuse_list(a, keys, name) if isinstance(a, list)
                else (fuse(a, keys, name) if a is not None else None)
                for a in lst]

    out = dict(temporal_params)
    blocks = []
    for block in temporal_params["blocks"]:
        b = dict(block)
        b["self_attn"] = fuse_list(block["self_attn"], ("q", "k", "v"),
                                   "qkv")
        for key in ("cross_attn", "cross_attn_ib"):
            if key in block and isinstance(block[key], list):
                b[key] = fuse_list(block[key], ("k", "v"), "kv")
        blocks.append(b)
    out["blocks"] = blocks
    return out


def to_bf16(tree):
    """Every floating leaf of a tree cast to bf16 (round to nearest even);
    other leaves as they are."""
    return tree_map(lambda x: x.to(torch.bfloat16)
                    if x.is_floating_point() else x, tree)


# Short CLI flag -> TrainConfig.compute_dtype policy name.
POLICY_BY_FLAG = {"f32": "float32", "bf16": "bfloat16",
                  "bf16_mixed": "bfloat16_mixed",
                  "bf16_shadow": "bfloat16_shadow"}


def train_cast(compute_dtype: str):
    """(cast_params, cast_inputs) of a TrainConfig.compute_dtype policy,
    as the JAX package's:

    - "float32": identity;
    - "bfloat16": weight-only, the big matmul weights bf16 inside the loss
      (``cast_weights_bf16``), activations f32;
    - "bfloat16_mixed": every floating parameter and the batch inputs
      bf16; softmax and norm statistics, and the loss, stay f32 inside the
      ops. The f32 master parameters take the gradients through the cast;
    - "bfloat16_shadow": the casts of "bfloat16_mixed"; the train step
      skips cast_params and differentiates the bf16 shadow the optimizer
      state keeps (``train.optim.with_bf16_shadow``)."""
    if compute_dtype == "float32":
        return (lambda p: p), (lambda *xs: xs)
    if compute_dtype == "bfloat16":
        return cast_weights_bf16, (lambda *xs: xs)
    if compute_dtype in ("bfloat16_mixed", "bfloat16_shadow"):
        return to_bf16, (lambda *xs: tuple(x.to(torch.bfloat16) for x in xs))
    raise ValueError(
        f"unknown compute_dtype {compute_dtype!r}; expected 'float32', "
        "'bfloat16' (weight-only), 'bfloat16_mixed', or 'bfloat16_shadow' "
        "(mixed + persistent bf16 weight copy in the optimizer state)")


def cast_weights_bf16(tree, min_size: int = 1 << 16):
    """Weight-only bf16: the big 2-D linear weights to bf16; norms,
    biases, tables and small matrices stay f32."""
    def walk(node):
        if isinstance(node, dict):
            out = {k: walk(v) for k, v in node.items()}
            if _is_big_weight(node, min_size):
                out["w"] = node["w"].to(torch.bfloat16)
            return out
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        return node

    return walk(tree)


@torch.inference_mode()
def teacher_forced_drift(params_ref, params_reduced, cfg, src, ib, *,
                         max_windows: int = 2) -> float:
    """Teacher-forced relative L2 between a reference and a reduced-
    precision temporal model on the same windows (at most
    ``max_windows``): the CLI's per-checkpoint drift gate. src: [B, T, G,
    E]; ib: [B, T, ib_num], numpy or tensors; they run on the params'
    device."""
    from sea_tpu_torch.models.temporal import temporal_forward
    device = _device_of(params_ref)
    s = torch.as_tensor(src[:max_windows]).to(device)
    i = torch.as_tensor(ib[:max_windows]).to(device)
    ref = temporal_forward(params_ref, cfg, s, i).float()
    red = temporal_forward(params_reduced, cfg, s, i).float()
    return float(torch.linalg.vector_norm(red - ref)
                 / (torch.linalg.vector_norm(ref) + 1e-8))


def _device_of(tree):
    """The device of the first tensor leaf of a tree."""
    if isinstance(tree, torch.Tensor):
        return tree.device
    children = (tree.values() if isinstance(tree, dict)
                else tree if isinstance(tree, (list, tuple)) else ())
    for child in children:
        device = _device_of(child)
        if device is not None:
            return device
    return None
