"""Rollout metrics: counterpart of ``relative_mse`` and
``relative_mse_with_time`` in ``sea_tpu/train/metrics.py``."""

from __future__ import annotations

import torch

EPS = 1e-8


def relative_mse(pred, truth, axis: int = -1):
    num = torch.sum((pred - truth) ** 2, dim=axis)
    den = torch.sum(truth ** 2, dim=axis)
    return num / (den + EPS)


def relative_mse_with_time(pred, truth, axis: int = 2):
    """pred/truth: [trajectory, time, cell, field] -> [traj, time, field]."""
    return relative_mse(pred, truth, axis=axis)
