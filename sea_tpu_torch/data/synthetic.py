"""Synthetic CFD-like datasets for tests, end-to-end slices, and benchmarks.

The reference repo ships no data (paths point at ./data/CF/*.npy,
configs/cylinder_flow.py:7-9, which don't exist in-tree). This module
generates data with the same shapes and file contract:
- field_data:  [tr, T, N, F]  per-trajectory time series of node fields
- coordinates: [dim, N]       mesh node coordinates
- input_data:  [tr, T, ib]    input/boundary scalars (e.g. Reynolds number)

The cylinder case produces a smooth advecting vortex-street-like pattern
(u, v, p) whose shedding frequency depends on the per-trajectory Reynolds
number, so the temporal model has real Re-conditioned dynamics to learn.
The multiphase case produces (u, v, alpha) with a moving phase front.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def cylinder_like(tr: int = 5, T: int = 50, n_nodes: int = 600,
                  seed: int = 0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    rng = np.random.RandomState(seed)
    # Irregular mesh over [0, 8] x [0, 2], denser near the "cylinder" at (2,1)
    xy = rng.rand(n_nodes, 2) * np.array([8.0, 2.0])
    near = rng.rand(n_nodes // 3, 2) * np.array([2.0, 1.0]) + \
        np.array([1.0, 0.5])
    xy[: near.shape[0]] = near
    x, y = xy[:, 0], xy[:, 1]

    res = 100.0 + 300.0 * rng.rand(tr)  # Reynolds numbers per trajectory
    t_axis = np.arange(T, dtype=np.float32)

    fields = np.zeros((tr, T, n_nodes, 3), dtype=np.float32)
    for i, re in enumerate(res):
        freq = 0.05 + re / 4000.0
        k = 2.0 * np.pi / 4.0
        phase = k * x[None, :] - 2.0 * np.pi * freq * t_axis[:, None]
        envelope = np.exp(-0.5 * ((y[None, :] - 1.0) / 0.6) ** 2)
        wake = 1.0 / (1.0 + np.exp(-(x[None, :] - 2.0)))
        # All fields O(1) so per-field relative MSE is comparable
        # (real CFD data is min-max scaled; reference ships scaling off).
        u = 1.0 + 0.5 * envelope * wake * np.sin(phase)
        v = 0.5 + 0.8 * envelope * wake * np.cos(phase) * np.sin(
            np.pi * y / 2.0)
        p = 0.5 - 0.8 * envelope * wake * np.sin(2 * phase + 0.7)
        fields[i, :, :, 0] = u
        fields[i, :, :, 1] = v
        fields[i, :, :, 2] = p

    coordinates = xy.T.astype(np.float32)  # [2, N] reference layout
    input_data = np.repeat(res[:, None, None], T, axis=1).astype(np.float32)
    input_data = input_data / 400.0  # normalized ib scalar
    return fields, coordinates, input_data


def multiphase_like(tr: int = 5, T: int = 50, n_nodes: int = 600,
                    seed: int = 1) -> Tuple[np.ndarray, np.ndarray,
                                            np.ndarray]:
    rng = np.random.RandomState(seed)
    xy = rng.rand(n_nodes, 2) * np.array([4.0, 4.0])
    x, y = xy[:, 0], xy[:, 1]
    speeds = 0.5 + rng.rand(tr)
    t_axis = np.arange(T, dtype=np.float32)

    fields = np.zeros((tr, T, n_nodes, 3), dtype=np.float32)
    for i, s in enumerate(speeds):
        front = 0.5 + 0.06 * s * t_axis[:, None]  # rising interface height
        alpha = 1.0 / (1.0 + np.exp((y[None, :] - front) / 0.3))
        u = 0.2 * np.sin(2 * np.pi * x[None, :] / 4.0
                         + 0.2 * s * t_axis[:, None]) * alpha
        v = 0.1 * s * alpha * (1 - alpha) * 4.0
        fields[i, :, :, 0] = u
        fields[i, :, :, 1] = v
        fields[i, :, :, 2] = alpha
    coordinates = xy.T.astype(np.float32)
    input_data = np.repeat(speeds[:, None, None], T, axis=1).astype(np.float32)
    return fields, coordinates, input_data
