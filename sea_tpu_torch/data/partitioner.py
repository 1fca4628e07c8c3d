"""Mesh partitioners: bucketize nodes into a regular grid of spatial patches.

Behavioral mirror of reference utils/data_processors.py DataPartitioner2D
(:9-111) and DataPartitioner3D (:114-223), redesigned for TPU-friendly static
shapes: instead of the reference's per-patch Python double/triple loop with
dynamic per-patch occupancy (:42-55) followed by right-padding (:61-88), we
bucketize once, precompute a padded [P, C_max] gather-index matrix plus a
validity mask, and patchify/unpatchify become single vectorized gather /
scatter ops on the host (numpy) or the device (``unpatchify_torch``).

Equivalences preserved exactly:
- Grid: boundaries = linspace(min, max, m) per axis; bucketize right=True,
  clamped to [1, m-1]; patch (i, j[, k]) ordered i-major then j (then k)
  for i, j, k in 1..m-1 (:30-47, :138-158).
- Within a patch, nodes keep ascending global-node-index order (the
  reference's mask.nonzero order, :45).
- Padding: fields/coords padded with ``pad_field_value`` (0), indices with
  ``pad_id`` (-1), to the max patch occupancy C_max (:61-88).
- inverse_partition scatters only valid entries back to flat node order
  (:90-111).

Round-trip invariant (unit_test_create_partitions2D/3D, modular_testing.py:
7-74): partition -> inverse recovers fields and coords to 1e-6. Covered by
tests/test_partitioner.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


@dataclass
class PartitionIndex:
    """Precomputed static-shape partition of N mesh nodes into P patches."""

    index_map: np.ndarray  # [P, C] int64, pad_id at padded slots
    valid_mask: np.ndarray  # [P, C] bool
    coords: np.ndarray  # [P, C, dim] float32, pad_field_value at padded slots
    num_nodes: int
    pad_id: int
    pad_field_value: float

    @property
    def num_patches(self) -> int:
        return self.index_map.shape[0]

    @property
    def cells_per_patch(self) -> int:
        return self.index_map.shape[1]


def _bucketize(coords_1d: np.ndarray, n_bound: int) -> np.ndarray:
    """torch.bucketize(x, linspace(min,max,n), right=True).clamp(1, n-1)."""
    lo, hi = coords_1d.min(), coords_1d.max()
    boundaries = np.linspace(lo, hi, n_bound, dtype=np.float32)
    idx = np.searchsorted(boundaries, coords_1d, side="right")
    return np.clip(idx, 1, n_bound - 1)


def build_partition_index(coords: np.ndarray, m: int, n: int,
                          k: Optional[int] = None, *, pad_id: int = -1,
                          pad_field_value: float = 0.0) -> PartitionIndex:
    """coords: [N, dim] node coordinates (dim = 2 or 3).

    Bucketizes once and derives the padded gather index. The reference
    recomputes the whole assignment per 2048-timestep chunk
    (data_processors.py:521-524); geometry is time-invariant so we do it once.
    """
    coords = np.asarray(coords, dtype=np.float32)
    N, dim = coords.shape
    if dim == 2:
        xi = _bucketize(coords[:, 0], m)
        yi = _bucketize(coords[:, 1], n)
        patch_of_node = (xi - 1) * (n - 1) + (yi - 1)
        P = (m - 1) * (n - 1)
    elif dim == 3:
        assert k is not None, "3D partition requires k"
        xi = _bucketize(coords[:, 0], m)
        yi = _bucketize(coords[:, 1], n)
        zi = _bucketize(coords[:, 2], k)
        patch_of_node = ((xi - 1) * (n - 1) + (yi - 1)) * (k - 1) + (zi - 1)
        P = (m - 1) * (n - 1) * (k - 1)
    else:
        raise ValueError(f"coords must be [N,2] or [N,3], got dim={dim}")

    # Stable sort by patch keeps ascending node order within each patch,
    # matching mask.nonzero() ordering in the reference.
    order = np.argsort(patch_of_node, kind="stable")
    sorted_patch = patch_of_node[order]
    counts = np.bincount(sorted_patch, minlength=P)
    C = int(counts.max()) if N > 0 else 0

    index_map = np.full((P, C), pad_id, dtype=np.int64)
    # Position of each node within its patch.
    starts = np.zeros(P, dtype=np.int64)
    starts[1:] = np.cumsum(counts)[:-1]
    within = np.arange(N) - starts[sorted_patch]
    index_map[sorted_patch, within] = order

    valid = index_map != pad_id
    patch_coords = np.full((P, C, dim), pad_field_value, dtype=np.float32)
    patch_coords[valid] = coords[index_map[valid]]

    return PartitionIndex(index_map=index_map, valid_mask=valid,
                          coords=patch_coords, num_nodes=N, pad_id=pad_id,
                          pad_field_value=pad_field_value)


def patchify(part: PartitionIndex, fields: np.ndarray) -> np.ndarray:
    """fields: [T, N, F] -> [T, P, C, F], padded slots = pad_field_value.

    Single gather; replaces the reference's per-patch loop + pad
    (data_processors.py:42-88).
    """
    fields = np.asarray(fields)
    T, N, F = fields.shape
    safe_idx = np.where(part.valid_mask, part.index_map, 0)
    out = fields[:, safe_idx.reshape(-1), :].reshape(
        T, part.num_patches, part.cells_per_patch, F)
    out = np.where(part.valid_mask[None, :, :, None], out,
                   np.asarray(part.pad_field_value, dtype=out.dtype))
    return out


def unpatchify(part: PartitionIndex, patched: np.ndarray) -> np.ndarray:
    """patched: [T, P, C, F] -> [T, N, F]; inverse of patchify.

    Mirrors inverse_partition (data_processors.py:90-111): scatter valid
    entries back to flat node order.
    """
    patched = np.asarray(patched)
    T, P, C, F = patched.shape
    out = np.empty((T, part.num_nodes, F), dtype=patched.dtype)
    valid = part.valid_mask
    out[:, part.index_map[valid], :] = patched[:, valid, :]
    return out


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
