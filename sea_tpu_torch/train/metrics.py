"""Metrics and losses: counterpart of ``relative_mse``,
``relative_mse_with_time``, ``mse``, ``masked_mse`` and
``StatsAccumulator`` in ``sea_tpu/train/metrics.py``."""

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


def mse(pred, truth):
    return torch.mean((pred - truth) ** 2)


def masked_mse(pred, truth, n_valid: int):
    """MSE over the first n_valid samples of a padded batch (leading axis
    = batch), as ``sea_tpu.train.metrics.masked_mse``."""
    w = (torch.arange(pred.shape[0], device=pred.device)
         < n_valid).to(torch.float32)
    per_sample = torch.mean((pred - truth) ** 2,
                            dim=tuple(range(1, pred.dim())))
    return torch.sum(per_sample * w) / torch.sum(w)


class StatsAccumulator:
    """Sums per-step scalar stats on the device; ``means()`` reads them
    back once, so the train loop never waits on the device per step."""

    def __init__(self):
        self._agg = None
        self.count = 0

    def add(self, stats):
        scal = stats if isinstance(stats, dict) else {"loss": stats}
        scal = {k: v.detach() for k, v in scal.items()}
        self._agg = (scal if self._agg is None
                     else {k: self._agg[k] + v for k, v in scal.items()})
        self.count += 1

    def means(self) -> dict:
        if self.count == 0:
            return {}
        return {k: float(v) / self.count for k, v in self._agg.items()}
