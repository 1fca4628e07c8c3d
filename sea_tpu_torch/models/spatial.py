"""Stage-1 spatial model: ViT-style mesh-field autoencoder.

Counterpart of ``sea_tpu/models/spatial.py`` with the same parameter tree
(``blocks``, ``ln``, ``encoders``, ``decoders``, ``pe`` and, when
variational, ``encoders_logvar``). Encoder: per field group a downScaleMLP
head, concatenated group latents -> [B, P, G*D] tokens, sinusoidal PE over
the patch axis, pre-LN transformer blocks with full attention across the P
patch tokens, final LayerNorm. Decoder: per group an upScaleMLP, no
attention.

Init keeps the reference's construction-order split: the transformer trunk
is N(0, 0.02) (torch default when variational), the encoder/decoder heads
keep PyTorch's default init.

The encoder's attention over the 64 patches is the plain path
(``impl="plain"``): the JAX package never sends it to a kernel either
(T < 1024), and its head dim of 4 is not one the flash kernels take.
"""

from __future__ import annotations

import torch
from torch import nn

from sea_tpu_torch.configs.base import SpatialModelConfig
from sea_tpu_torch.ops import layers as L
from sea_tpu_torch.ops.attention import init_attention, mha
from sea_tpu_torch.utils.params import tree_map

PAD_SENTINEL = -9999.0


def init_encoder_block(gen: torch.Generator, embed_dim: int, n_heads: int, *,
                       init: str = "normal002", dtype=torch.float32):
    """Pre-LN attention + pre-LN MLP; the LNs are weight-only."""
    return {
        "ln1": L.init_layernorm(embed_dim, bias=False, dtype=dtype,
                                device=gen.device),
        "ln2": L.init_layernorm(embed_dim, bias=False, dtype=dtype,
                                device=gen.device),
        "attn": init_attention(gen, embed_dim, n_heads, init=init,
                               dtype=dtype),
        "mlp": L.init_mlp(gen, embed_dim, scale_ratio=4, init=init,
                          dtype=dtype),
    }


def encoder_block(params, x, *, n_heads: int):
    h = L.layernorm(params["ln1"], x)
    x = x + mha(params["attn"], h, h, n_heads=n_heads, causal=False,
                rope=False, impl="plain")
    return x + L.mlp(params["mlp"], L.layernorm(params["ln2"], x))


def init_spatial(cfg: SpatialModelConfig, gen: torch.Generator, *,
                 device, dtype=torch.float32):
    if cfg.n_inp is None:
        raise ValueError("n_inp must be derived before init (run the "
                         "partitioner first: SpatialModelConfig.with_n_inp)")
    token_dim = cfg.token_dim
    trunk_init = "torch_default" if cfg.variational else "normal002"
    blocks = [init_encoder_block(gen, token_dim, cfg.n_heads,
                                 init=trunk_init, dtype=dtype)
              for _ in range(cfg.num_layers)]
    encoders, encoders_logvar, decoders = [], [], []
    for group in cfg.field_groups:
        d_field = cfg.n_inp * len(group)
        encoders.append(L.init_scale_mlp(gen, d_field, cfg.embed_dim,
                                         cfg.mlp_hidden, dtype=dtype))
        if cfg.variational:
            encoders_logvar.append(L.init_scale_mlp(
                gen, d_field, cfg.embed_dim, cfg.mlp_hidden, dtype=dtype))
        decoders.append(L.init_scale_mlp(gen, cfg.embed_dim, d_field,
                                         cfg.mlp_hidden, dtype=dtype))
    params = {
        "blocks": blocks,
        # The final LN is a full nn.LayerNorm (weight and bias).
        "ln": L.init_layernorm(token_dim, bias=True, dtype=dtype,
                               device=gen.device),
        "encoders": encoders,
        "decoders": decoders,
        "pe": L.sinusoidal_pe_table(token_dim, max_len=5000, dtype=dtype,
                                    device=gen.device),
    }
    if cfg.variational:
        params["encoders_logvar"] = encoders_logvar
    return tree_map(lambda a: a.to(device), params)


class SpatialModel(nn.Module):
    """Owns a spatial parameter tree; ``.to(device)`` moves every tensor.
    ``forward`` encodes then decodes (deterministic)."""

    def __init__(self, cfg: SpatialModelConfig, params):
        super().__init__()
        self.cfg = cfg
        self.params = params

    def _apply(self, fn, recurse=True):
        self.params = tree_map(fn, self.params)
        return self

    def forward(self, x):
        z = spatial_encode(self.params, self.cfg, apply_padding_mask(x))
        if self.cfg.variational:
            z = z[0]
        return spatial_decode(self.params, self.cfg, z)


def apply_padding_mask(x, pad_idx: float = PAD_SENTINEL):
    """Zero entries equal to the padding sentinel."""
    return x.masked_fill(x == pad_idx, 0.0)


def spatial_encode(params, cfg: SpatialModelConfig, x):
    """x: [B, P, F, C] -> z [B, P, G, D]; variational models return
    (z, mu, logvar) with z = mu (serving is deterministic)."""
    B, P, F, C = x.shape

    def heads(name):
        return torch.cat([
            L.scale_mlp(params[name][i],
                        x[:, :, list(group), :].reshape(B, P, 1,
                                                        len(group) * C))
            for i, group in enumerate(cfg.field_groups)], dim=-2)

    z = heads("encoders")  # [B, P, G, D]
    mu = logvar = None
    if cfg.variational:
        mu, logvar = z, heads("encoders_logvar")
    z = z.reshape(B, P, cfg.num_groups * cfg.embed_dim)
    z = L.positional_encoding(params["pe"], z)
    for block in params["blocks"]:
        z = encoder_block(block, z, n_heads=cfg.n_heads)
    z = L.layernorm(params["ln"], z)
    z = z.reshape(B, P, cfg.num_groups, cfg.embed_dim)
    if cfg.variational:
        return z, mu, logvar
    return z


def spatial_decode(params, cfg: SpatialModelConfig, z):
    """z: [B, P, G, D] -> x [B, P, F, C]; per-group upScaleMLP."""
    B, P = z.shape[:2]
    return torch.cat([
        L.scale_mlp(params["decoders"][i], z[:, :, i:i + 1, :]).reshape(
            B, P, len(group), cfg.n_inp)
        for i, group in enumerate(cfg.field_groups)], dim=2)
