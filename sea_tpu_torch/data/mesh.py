"""MeshProcessor: scale + patchify orchestration.

Mirror of reference utils/data_processors.py MeshProcessor (:454-597):
optionally fit per-field-group min-max scalers, build the partitioner and
patchify [T, N, F] fields into [T, P, C, F], and back
(``inverse_scale_and_unpatch`` on the host for the stage-1 test; the
rollout's inverse runs on the device, ``rollout/e2e.py``). Optionally runs the
round-trip invariant check on construction (``perform_initial_test``,
:535-536, 575-597).

Differences by design: the partition index is computed once (geometry is
time-invariant) and patchify is a single vectorized gather — no 2048-step
chunk loop needed.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from sea_tpu_torch.configs.base import MeshConfig
from sea_tpu_torch.data.partitioner import (PartitionIndex,
                                            build_partition_index, patchify,
                                            unpatchify)
from sea_tpu_torch.data.scaler import MinMaxScaler


class MeshProcessor:
    def __init__(self, mesh_cfg: MeshConfig,
                 field_groups: Sequence[Sequence[int]],
                 coordinates: np.ndarray, *, save_dir: str = "."):
        """coordinates: [dim, N] (reference layout, data_processors.py:455)
        or [N, dim]; both accepted, stored as [N, dim]."""
        coords = np.asarray(coordinates, dtype=np.float32)
        if coords.ndim != 2:
            raise ValueError(f"coordinates must be 2D, got {coords.shape}")
        if coords.shape[0] in (2, 3) and coords.shape[1] not in (2, 3):
            coords = coords.T
        self.coordinates = coords  # [N, dim]
        self.mesh_cfg = mesh_cfg
        self.field_groups = [list(g) for g in field_groups]
        self.save_dir = save_dir

        self.partition: PartitionIndex = build_partition_index(
            coords, mesh_cfg.m, mesh_cfg.n,
            mesh_cfg.k if mesh_cfg.dimension == "3D" else None,
            pad_id=mesh_cfg.pad_id,
            pad_field_value=mesh_cfg.pad_field_value)

        self.scalers = []
        if mesh_cfg.scale_feature_range is not None:
            for i, _ in enumerate(self.field_groups):
                self.scalers.append(MinMaxScaler(
                    feature_range=mesh_cfg.scale_feature_range,
                    name=f"{mesh_cfg.scaler_name}-group{i}",
                    save_dir=save_dir))

    @property
    def num_patches(self) -> int:
        return self.partition.num_patches

    @property
    def cells_per_patch(self) -> int:
        return self.partition.cells_per_patch

    def patchify_and_scale(self, fields: np.ndarray, *,
                           perform_initial_test: bool = True
                           ) -> Tuple[np.ndarray, np.ndarray]:
        """fields: [T, N, F] -> (patch_coords [P, C, dim],
        patched [T, P, C, F]).

        The scalers are fitted on the full tensor, as in the reference's
        train_indices-given branch (data_processors.py:491-494 — the
        reference fits on *all* data despite receiving train_indices;
        behavior kept) and in every caller of the JAX package.
        """
        fields = np.asarray(fields, dtype=np.float32)
        for scaler, group in zip(self.scalers, self.field_groups):
            scaler.fit(fields[..., group])
        scaled = self._scale_fields(fields)
        patched = patchify(self.partition, scaled)
        if perform_initial_test:
            self._roundtrip_check(scaled, patched)
        return self.partition.coords, patched

    def _check_group_coverage(self, n_fields: int) -> None:
        """Scaling writes into a zeros buffer per group — a field index no
        group covers would come back identically 0 (silent corruption)."""
        covered = sorted(i for g in self.field_groups for i in g)
        if covered != list(range(n_fields)):
            raise ValueError(
                f"field_groups {self.field_groups} must cover every field "
                f"index 0..{n_fields - 1} exactly once when scaling is "
                f"enabled (covered: {covered})")

    def _scale_fields(self, fields: np.ndarray) -> np.ndarray:
        if not self.scalers:
            return fields
        self._check_group_coverage(fields.shape[-1])
        out = np.zeros_like(fields)
        for scaler, group in zip(self.scalers, self.field_groups):
            out[..., group] = scaler.transform(fields[..., group])
        return out

    def inverse_scale_and_unpatch(self, patched: np.ndarray) -> np.ndarray:
        """[T, P, C, F] -> [T, N, F]: unpatchify, then undo each group's
        scaling."""
        flat = unpatchify(self.partition, np.asarray(patched))
        if not self.scalers:
            return flat
        self._check_group_coverage(flat.shape[-1])
        out = np.zeros_like(flat)
        for scaler, group in zip(self.scalers, self.field_groups):
            out[..., group] = scaler.inverse_transform(flat[..., group])
        return out

    def _roundtrip_check(self, scaled: np.ndarray, patched: np.ndarray,
                         atol: float = 1e-6) -> None:
        """The reference's perform_initial_test invariant
        (unit_test_create_partitions2D/3D, modular_testing.py:7-74): the
        partition preserves every field value and coordinate."""
        recon = unpatchify(self.partition, patched)
        if not np.allclose(recon, scaled, atol=atol):
            raise AssertionError(
                "partition round-trip failed: max diff "
                f"{np.max(np.abs(recon - scaled))}")
        valid = self.partition.valid_mask
        recon_coords = np.empty_like(self.coordinates)
        recon_coords[self.partition.index_map[valid]] = \
            self.partition.coords[valid]
        if not np.allclose(recon_coords, self.coordinates, atol=atol):
            raise AssertionError("partition coordinate round-trip failed")
