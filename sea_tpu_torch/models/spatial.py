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

Training mode (``rng`` a ``utils.prng`` key and ``deterministic``
False) follows the JAX key tree: ``split(rng, 2 + num_layers)``; key 0,
folded with the group index, draws the variational noise
(``prng.normal``); key 1 drops the positional encoding's output; key
2 + i drives block i, split into its attention and MLP dropout keys.
Every dropout is the JAX package's position hash, so the masks and the
noise's uniforms are JAX's bit for bit. Under a ``--mesh`` grid
(``parallel.collectives.sharded``) the blocks' attention runs on this
rank's heads (``parallel.mesh.spatial_param_dims``), and the dropout and
the noise take the global positions of the rank's batch block.
"""

from __future__ import annotations

import torch
from torch import nn

from sea_tpu_torch.configs.base import SpatialModelConfig
from sea_tpu_torch.ops import layers as L
from sea_tpu_torch.ops.attention import init_attention, mha
from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.utils import prng
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


def encoder_block(params, x, *, n_heads: int, dropout_rate: float = 0.0,
                  rng=None, deterministic: bool = True):
    k1 = k2 = None
    if rng is not None and not deterministic:
        k1, k2 = prng.split(rng)
    h = L.layernorm(params["ln1"], x)
    x = x + mha(params["attn"], h, h, n_heads=n_heads, causal=False,
                rope=False, dropout_rate=dropout_rate, dropout_key=k1,
                deterministic=deterministic, impl="plain")
    return x + L.mlp(params["mlp"], L.layernorm(params["ln2"], x),
                     dropout_rate=dropout_rate, dropout_key=k2)


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
        out = spatial_forward(self.params, self.cfg, x)
        return out[0] if self.cfg.variational else out


def apply_padding_mask(x, pad_idx: float = PAD_SENTINEL):
    """Zero entries equal to the padding sentinel."""
    return x.masked_fill(x == pad_idx, 0.0)


def spatial_encode(params, cfg: SpatialModelConfig, x, *, rng=None,
                   deterministic: bool = True):
    """x: [B, P, F, C] -> z [B, P, G, D]; variational models return
    (z, mu, logvar), z = mu when deterministic, else reparameterized."""
    B, P, F, C = x.shape
    n_split = 2 + cfg.num_layers
    training = rng is not None and not deterministic
    rngs = prng.split(rng, n_split) if training else [None] * n_split

    def heads(name):
        return [L.scale_mlp(params[name][i],
                            x[:, :, list(group), :].reshape(
                                B, P, 1, len(group) * C))
                for i, group in enumerate(cfg.field_groups)]

    zs = heads("encoders")  # G x [B, P, 1, D]
    mu = logvar = None
    if cfg.variational:
        logvars = heads("encoders_logvar")
        mu, logvar = torch.cat(zs, dim=-2), torch.cat(logvars, dim=-2)
        if training:
            # Under a grid, this rank's rows of the global noise.
            grid = collectives.current()
            first = 0 if grid is None else grid.data_rank
            zs = [m + torch.exp(0.5 * lv) * prng.normal(
                      prng.fold_in(rngs[0], i), lv.shape, lv.dtype,
                      device=lv.device, offset=first * lv.numel())
                  for i, (m, lv) in enumerate(zip(zs, logvars))]
    z = torch.cat(zs, dim=-2).reshape(B, P, cfg.num_groups * cfg.embed_dim)
    z = L.positional_encoding(params["pe"], z, dropout_rate=cfg.dropout,
                              dropout_key=rngs[1])
    for i, block in enumerate(params["blocks"]):
        z = encoder_block(block, z, n_heads=cfg.n_heads,
                          dropout_rate=cfg.dropout, rng=rngs[2 + i],
                          deterministic=deterministic)
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


def spatial_forward(params, cfg: SpatialModelConfig, x, *, rng=None,
                    deterministic: bool = True):
    """Encode and decode x [B, P, F, C] (padding sentinels zeroed first);
    variational models return (recon, mu, logvar)."""
    x = apply_padding_mask(x)
    if cfg.variational:
        z, mu, logvar = spatial_encode(params, cfg, x, rng=rng,
                                       deterministic=deterministic)
        return spatial_decode(params, cfg, z), mu, logvar
    z = spatial_encode(params, cfg, x, rng=rng, deterministic=deterministic)
    return spatial_decode(params, cfg, z)
