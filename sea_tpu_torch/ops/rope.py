"""Rotary position embeddings in real arithmetic.

Counterpart of ``sea_tpu/ops/rope.py``: consecutive pairs (x[2i], x[2i+1])
of each head vector rotate by t * theta^(-2i/hd), frequencies and angles
in f32.
"""

from __future__ import annotations

import torch


def rope_cos_sin(head_dim: int, positions, theta: float = 10000.0,
                 dtype=torch.float32):
    """positions: integer tensor of absolute token indices, any shape.
    Returns (cos, sin), each [*positions.shape, head_dim//2]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device)[: head_dim // 2]
    freqs = 1.0 / (theta ** (exponent / head_dim))
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def apply_rope(x, cos, sin):
    """x: [..., T, n_heads, head_dim]; cos/sin: [T, head_dim//2],
    broadcast over batch and heads. Result in x's dtype."""
    a = x[..., 0::2]
    b = x[..., 1::2]
    c = cos[..., None, :]
    s = sin[..., None, :]
    out = torch.stack([a * c - b * s, a * s + b * c], dim=-1)
    return out.reshape(x.shape).to(x.dtype)
