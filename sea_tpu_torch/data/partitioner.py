"""Device-side un-patching.

The partition itself (``sea_tpu.data.partitioner.PartitionIndex``) is
framework-free and shared; this is the tensor counterpart of its
``unpatchify_jax``.
"""

from __future__ import annotations

import numpy as np
import torch

from sea_tpu.data.partitioner import PartitionIndex


def unpatchify_torch(part: PartitionIndex, patched):
    """[..., P, C, F] -> [..., N, F]: scatter into N+1 node slots, where
    the last slot absorbs the padded cells, then drop it."""
    P, C = part.index_map.shape
    lead = tuple(patched.shape[:-3])
    F = patched.shape[-1]
    flat = patched.reshape(lead + (P * C, F))
    idx = torch.from_numpy(
        np.where(part.valid_mask, part.index_map, part.num_nodes).reshape(-1)
    ).to(patched.device)
    out = torch.zeros(lead + (part.num_nodes + 1, F), dtype=patched.dtype,
                      device=patched.device)
    out[..., idx, :] = flat
    return out[..., :part.num_nodes, :]
