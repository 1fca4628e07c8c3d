"""Reference PyTorch checkpoints into the port's parameter trees: a copy of
``sea_tpu/utils/torch_compat.py``.

A user of the original SEA can load their trained ``encoder_decoder_*.pt``
and ``temporal_*.pt`` state dicts into the port in every mode. The result
is a numpy tree in the npz layout (``params/blocks/0/attn/q/w``), which
``utils.params.from_numpy`` carries to the device as it carries an npz.
Key mapping follows the reference module trees (SpatialModel: ``encode``,
``decode``; TemporalModel: ``blocks``, ``ln``).

Conventions, as in the JAX package:
- torch Linear stores weight as [out, in]; the tree's is [in, out], so the
  mapping transposes (exactly: a copy of the same floats).
- ``module.``-prefixed keys (``nn.DataParallel`` exports) are stripped, as
  the reference loader strips them.
- Registered buffers (``freqs_cis``, ``tril``, positional-encoding ``pe``)
  are skipped: masks and RoPE tables are recomputed, and the tree's
  sinusoidal ``pe`` and ``pool_pe`` come from the port's own
  ``ops.layers.sinusoidal_pe_table`` (PyTorch's sin and cos: a few f32
  ulps from the JAX package's table).

The mappers take a plain ``{key: np.ndarray}`` dict; only
``load_torch_state_dict`` reads a file.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from sea_tpu_torch.configs.base import SpatialModelConfig, TemporalModelConfig

Array = np.ndarray
StateDict = Dict[str, Array]


def load_torch_state_dict(path: str) -> StateDict:
    """A .pt state dict as numpy arrays. ``weights_only``: a state dict is
    tensors and containers, so no pickled code runs."""
    import torch
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return state_dict_to_numpy(sd)


def state_dict_to_numpy(sd) -> StateDict:
    out = {}
    for key, value in sd.items():
        key = key.replace("module.", "")  # nn.DataParallel exports
        if hasattr(value, "detach"):
            value = value.detach().cpu()
            if str(value.dtype) == "torch.bfloat16":
                value = value.float()  # numpy has no bf16; exact
            value = value.numpy()
        out[key] = np.asarray(value)
    return out


def _pe_table(d_model: int) -> Array:
    import torch

    from sea_tpu_torch.ops.layers import sinusoidal_pe_table
    with torch.no_grad():
        return sinusoidal_pe_table(d_model, 5000, device="cpu").numpy()


def _lin(sd: StateDict, prefix: str, bias: bool = True):
    p = {"w": sd[f"{prefix}.weight"].T.copy()}
    if bias and f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _ln(sd: StateDict, prefix: str):
    p = {"w": sd[f"{prefix}.weight"].copy()}
    if f"{prefix}.bias" in sd:
        p["b"] = sd[f"{prefix}.bias"].copy()
    return p


def _adaln(sd: StateDict, prefix: str):
    return {
        "w": sd[f"{prefix}.weight"].copy(),
        "b": sd[f"{prefix}.bias"].copy(),
        "cond_fc1": _lin(sd, f"{prefix}.cond_mlp.0"),
        "cond_fc2": _lin(sd, f"{prefix}.cond_mlp.2"),
    }


def _norm(sd: StateDict, prefix: str):
    if f"{prefix}.cond_mlp.0.weight" in sd:
        return _adaln(sd, prefix)
    return _ln(sd, prefix)


def _attention(sd: StateDict, prefix: str):
    return {
        "q": _lin(sd, f"{prefix}.q"),
        "k": _lin(sd, f"{prefix}.k"),
        "v": _lin(sd, f"{prefix}.v"),
        "proj": _lin(sd, f"{prefix}.projection", bias=False),
    }


def _mlp(sd: StateDict, prefix: str, num_layers=None):
    """The reference MLP's ModuleList layout:
    L==1: [Linear, LayerNorm, GELU, Linear];
    L>1:  [Linear, LN, GELU] * (L-1) + [Linear]."""
    n = 1 if num_layers is None else num_layers
    layers: List[dict] = []
    idx = 0
    if n == 1:
        layers.append({"lin": _lin(sd, f"{prefix}.layers.0"),
                       "ln": _ln(sd, f"{prefix}.layers.1")})
        layers.append({"lin": _lin(sd, f"{prefix}.layers.3")})
        return {"layers": layers}
    for i in range(n):
        entry = {"lin": _lin(sd, f"{prefix}.layers.{idx}")}
        idx += 1
        if i != n - 1:
            entry["ln"] = _ln(sd, f"{prefix}.layers.{idx}")
            idx += 2  # skip GELU (no params)
        layers.append(entry)
    return {"layers": layers}


def _scale_mlp(sd: StateDict, prefix: str):
    """up/downScaleMLP: layer1 (no bias), layer2."""
    return {"fc1": _lin(sd, f"{prefix}.layer1", bias=False),
            "fc2": _lin(sd, f"{prefix}.layer2")}


# ---------------------------------------------------------------------------
# SpatialModel
# ---------------------------------------------------------------------------

def spatial_params_from_torch(sd: StateDict, cfg: SpatialModelConfig):
    enc = "encode"
    params = {
        "blocks": [],
        "ln": _ln(sd, f"{enc}.ln"),
        "decoders": [_scale_mlp(sd, f"decode.decoders.{g}")
                     for g in range(cfg.num_groups)],
        "pe": _pe_table(cfg.token_dim),
    }
    for i in range(cfg.num_layers):
        b = f"{enc}.blocks.{i}"
        params["blocks"].append({
            "ln1": _ln(sd, f"{b}.ln_exp1_1"),
            "ln2": _ln(sd, f"{b}.ln_exp1_2"),
            "attn": _attention(sd, f"{b}.attn_1"),
            "mlp": _mlp(sd, f"{b}.mlp_1"),
        })
    if cfg.variational:
        params["encoders"] = [_scale_mlp(sd, f"{enc}.encoders_mu.{g}")
                              for g in range(cfg.num_groups)]
        params["encoders_logvar"] = [
            _scale_mlp(sd, f"{enc}.encoders_logvar.{g}")
            for g in range(cfg.num_groups)]
    else:
        params["encoders"] = [_scale_mlp(sd, f"{enc}.encoders.{g}")
                              for g in range(cfg.num_groups)]
    return params


# ---------------------------------------------------------------------------
# TemporalModel
# ---------------------------------------------------------------------------

def _ib_layer(sd: StateDict, prefix: str, cfg: TemporalModelConfig):
    if cfg.ib_scale_mode == "fourier":
        return {"W": sd[f"{prefix}.W"].copy()}
    if cfg.ib_scale_mode == "linear":
        return _lin(sd, prefix)
    return _mlp(sd, prefix, num_layers=cfg.ib_mlp_layers)


def temporal_params_from_torch(sd: StateDict, cfg: TemporalModelConfig):
    G = cfg.num_fields
    params = {"blocks": [], "ln_final": [_norm(sd, f"ln.{i}")
                                         for i in range(G)]}
    for l in range(cfg.num_layers):
        b = f"blocks.{l}"
        block = {
            "ib": _ib_layer(sd, f"{b}.ib", cfg),
            "ln_exp": [[_norm(sd, f"{b}.ln.exp.{i}.{j}") for j in range(3)]
                       for i in range(G)],
            "self_attn": [_attention(sd, f"{b}.attn.self.{i}")
                          for i in range(G)],
            "mlp": [_mlp(sd, f"{b}.mlp.{i}") for i in range(G)],
            "proj": [_lin(sd, f"{b}.proj.{i}") for i in range(G)],
        }
        if cfg.ib_addition_mode == "attention":
            block["cross_attn_ib"] = [_attention(sd, f"{b}.cross_attn_ib.{i}")
                                      for i in range(G)]
        if cfg.exchange_mode in ("sea", "addition", "pool"):
            block["cross_down"] = [_lin(sd, f"{b}.cross_down.{i}")
                                   for i in range(G)]
            block["cross_up"] = [_lin(sd, f"{b}.cross_up.{i}")
                                 for i in range(G)]
            block["ln_cross"] = [_norm(sd, f"{b}.ln_cross.{i}")
                                 for i in range(G)]
        if cfg.exchange_mode == "sea":
            block["cross_attn"] = [
                [_attention(sd, f"{b}.cross_attn.{i}.{j}") for j in range(G)]
                for i in range(G)]
        elif cfg.exchange_mode == "pool":
            block["pool_token"] = sd[f"{b}.pool_token"].copy()
            block["cross_attn"] = [_attention(sd, f"{b}.cross_attn.{i}")
                                   for i in range(G)]
            block["ln_pool"] = _norm(sd, f"{b}.ln_pool")
            if cfg.pool_update_method == "linear":
                block["pool_update"] = _lin(sd, f"{b}.pool_update")
            elif cfg.pool_update_method == "mlp":
                block["pool_update"] = {
                    "fc1": _lin(sd, f"{b}.pool_update.0"),
                    "fc2": _lin(sd, f"{b}.pool_update.2")}
            elif cfg.pool_update_method == "pooling":
                block["pool_update"] = sd[f"{b}.pool_update"].copy()
            block["pool_pe"] = _pe_table(cfg.down_dim)
        params["blocks"].append(block)
    return params
