"""Metrics and losses: counterpart of ``relative_mse``,
``relative_mse_with_time``, ``mse``, ``r2``, the masked metrics of padded
evaluation batches (``masked_mse``, ``masked_r2``, ``masked_kl``), the
VAE loss (``vloss``, ``kl_anneal_weight``), ``per_tensor_norms`` and
``StatsAccumulator`` in ``sea_tpu/train/metrics.py``.

``n_valid`` (the real rows of a padded batch) and ``iteration`` are host
ints here: the port's loops know them on the host, so no metric waits on
the device for them. The KL weight is formed in f32 as JAX forms it from
an int32 iteration."""

from __future__ import annotations

import math

import numpy as np
import torch

from sea_tpu_torch.train.optim import sharded_tensor_norms, tensor_norms
from sea_tpu_torch.utils.params import tree_leaves, tree_paths

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


def r2(pred, truth):
    """Flattened R^2: 1 - sum((pred - truth)^2) / sum((truth - mean)^2)."""
    pred, truth = pred.reshape(-1), truth.reshape(-1)
    residual = torch.sum((pred - truth) ** 2)
    total = torch.sum((truth - torch.mean(truth)) ** 2)
    return 1.0 - residual / total


def sharded_r2(pred, truth, grid):
    """``r2`` of the global batch a data-parallel rank holds a block of:
    the truth's mean, the residual and the total summed over the data
    ranks."""
    if grid is None or grid.n_data == 1:
        return r2(pred, truth)
    from sea_tpu_torch.parallel.collectives import all_reduce
    pred, truth = pred.reshape(-1), truth.reshape(-1)
    g = grid.data_group
    mean = all_reduce(torch.sum(truth), g) / (truth.numel() * grid.n_data)
    residual = all_reduce(torch.sum((pred - truth) ** 2), g)
    total = all_reduce(torch.sum((truth - mean) ** 2), g)
    return 1.0 - residual / total


def _sample_mask(n_valid: int, batch: int, device):
    """f32 [batch]: 1 for the first n_valid rows, 0 for the padding."""
    return (torch.arange(batch, device=device) < n_valid).to(torch.float32)


def masked_mse(pred, truth, n_valid: int):
    """MSE over the first n_valid samples of a padded batch (leading axis
    = batch), as ``sea_tpu.train.metrics.masked_mse``."""
    w = _sample_mask(n_valid, pred.shape[0], pred.device)
    per_sample = torch.mean((pred - truth) ** 2,
                            dim=tuple(range(1, pred.dim())))
    return torch.sum(per_sample * w) / torch.sum(w)


def masked_r2(pred, truth, n_valid: int):
    """Flattened R^2 over the valid rows of a padded batch."""
    w = _sample_mask(n_valid, pred.shape[0], pred.device).reshape(
        (pred.shape[0],) + (1,) * (pred.dim() - 1))
    count = torch.sum(w) * math.prod(truth.shape[1:])
    mean_truth = torch.sum(truth * w) / count
    residual = torch.sum(w * (pred - truth) ** 2)
    total = torch.sum(w * (truth - mean_truth) ** 2)
    return 1.0 - residual / total


def masked_kl(mu, logvar, n_valid: int):
    """The VAE loss's KL term (summed) over the valid rows only."""
    w = _sample_mask(n_valid, mu.shape[0], mu.device).reshape(
        (mu.shape[0],) + (1,) * (mu.dim() - 1))
    return -0.5 * torch.sum(w * (1 + logvar - mu ** 2 - torch.exp(logvar)))


def kl_anneal_weight(kl_weight_min: float, kl_weight_max: float,
                     iteration: int, total_steps: int) -> float:
    """Linear KL anneal from min to max over total_steps, as a float that
    is the f32 value JAX computes: iteration / total_steps in f32 (an
    int32 over a weak int), times (max - min) rounded to f32, plus min
    rounded to f32. Shared by the train and the evaluation steps."""
    frac = np.float32(iteration) / np.float32(total_steps)
    return float(np.float32(kl_weight_min)
                 + np.float32(kl_weight_max - kl_weight_min) * frac)


def vloss(x, recon, mu, logvar, *, kl_weight_min: float,
          kl_weight_max: float, iteration: int, total_steps: int):
    """(total, recon_loss, kl_loss): MSE reconstruction plus the annealed
    KL weight times the summed KL."""
    kl_weight = kl_anneal_weight(kl_weight_min, kl_weight_max, iteration,
                                 total_steps)
    recon_loss = mse(recon, x)
    kl = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar))
    return recon_loss + kl_weight * kl, recon_loss, kl


def per_tensor_norms(tree, prefix: str = "", dims=None, grid=None):
    """Flat {prefix + npz path: f32 L2 norm} over every leaf of a tree,
    0-d tensors on the leaves' device (the JAX function's keys: its
    ``blocks/0/attn/q/w`` path spelling). The stand-in for the
    reference's per-tensor ``wandb.watch`` histograms; the training loops
    read an epoch's norms back in one transfer (``read_norms``). On a
    tensor-parallel ``grid`` (``dims``: each leaf's split axis) the norms
    of the global leaves."""
    leaves = tree_leaves(tree)
    norms = (tensor_norms(leaves) if grid is None
             else sharded_tensor_norms(leaves, dims, grid))
    return dict(zip((prefix + p for p in tree_paths(tree)), norms))


def read_norms(norms) -> dict:
    """per_tensor_norms' dict as host floats, in one transfer."""
    if not norms:
        return {}
    values = torch.stack(list(norms.values())).cpu().tolist()
    return dict(zip(norms, values))


class StatsAccumulator:
    """Sums per-step scalar stats on the device; ``means()`` reads them
    back once, so the train loop never waits on the device per step. The
    nested "tensors" entry (log_per_tensor) is left out: the loops read
    the last batch's apart."""

    def __init__(self):
        self._agg = None
        self.count = 0

    def add(self, stats):
        scal = stats if isinstance(stats, dict) else {"loss": stats}
        scal = {k: v.detach() for k, v in scal.items() if k != "tensors"}
        self._agg = (scal if self._agg is None
                     else {k: self._agg[k] + v for k, v in scal.items()})
        self.count += 1

    def means(self) -> dict:
        if self.count == 0:
            return {}
        return {k: float(v) / self.count for k, v in self._agg.items()}
