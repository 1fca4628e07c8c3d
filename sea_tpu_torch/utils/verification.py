"""Public verification utilities: a copy of
``sea_tpu/utils/verification.py`` on the port's ``data/mesh`` and
``data/partitioner``.

- verify_partition_roundtrip: partition -> inverse preserves every field
  value and coordinate (1e-6).
- verify_mesh_processor: scale + patchify + inverse equality on
  ``test_numbers`` random timesteps, returning max/mean diff stats.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.data.partitioner import (PartitionIndex, patchify,
                                            unpatchify)


class VerificationError(AssertionError):
    """Raised when a data-pipeline invariant fails. Subclasses
    AssertionError for callers that catch it, but is raised explicitly so
    ``python -O`` cannot strip it."""


def verify_partition_roundtrip(part: PartitionIndex, fields: np.ndarray,
                               coords: np.ndarray, *, atol: float = 1e-6
                               ) -> Dict[str, float]:
    """fields: [T, N, F]; coords: [N, dim]. Raises VerificationError on
    failure; returns diff stats on success."""
    recon = unpatchify(part, patchify(part, fields))
    max_diff = float(np.max(np.abs(recon - fields)))
    if max_diff > atol:
        raise VerificationError(f"field round-trip failed: {max_diff}")

    valid = part.valid_mask
    recon_coords = np.empty_like(coords)
    recon_coords[part.index_map[valid]] = part.coords[valid]
    coord_diff = float(np.max(np.abs(recon_coords - coords)))
    if coord_diff > atol:
        raise VerificationError(f"coord round-trip failed: {coord_diff}")
    return {"max_field_diff": max_diff, "max_coord_diff": coord_diff,
            "passed": True}


def verify_mesh_processor(mp: MeshProcessor, fields: np.ndarray, *,
                          test_numbers: int = 10, atol: float = 1e-6,
                          seed: int = 0) -> Dict[str, float]:
    """End-to-end patchify -> unpatchify equality on ``test_numbers``
    random timesteps, with the processor's fitted scalers (refitting on
    the sample would change them)."""
    rng = np.random.RandomState(seed)
    T = fields.shape[0]
    idx = rng.choice(T, min(test_numbers, T), replace=False)
    sample = np.asarray(fields[idx], dtype=np.float32)
    if mp.scalers and any(sc.min_val is None for sc in mp.scalers):
        raise ValueError("verify_mesh_processor requires fitted scalers; "
                         "run patchify_and_scale first")
    patched = patchify(mp.partition, mp._scale_fields(sample))
    recon = mp.inverse_scale_and_unpatch(patched)
    diff = np.abs(recon - sample)
    result = {"max_diff": float(diff.max()), "mean_diff": float(diff.mean()),
              "passed": bool(np.allclose(recon, sample, atol=max(atol, 1e-5)))}
    if not result["passed"]:
        raise VerificationError(f"mesh round-trip failed: {result}")
    return result
