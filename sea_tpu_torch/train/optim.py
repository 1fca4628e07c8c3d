"""AdamW with optax's semantics and state layout.

Counterpart of ``make_optimizer`` in ``sea_tpu/train/optim.py`` for the
recipe both shipped cases train with: ``optax.adamw`` with betas, eps and
weight decay from the TrainConfig, a constant learning rate and f32
moments. The state has the layout of ``tx.init(params)`` in the JAX
package — ``(ScaleByAdamState(count, mu, nu), EmptyState(),
EmptyState())`` — so it flattens to the same npz paths
(``opt_state/0/0`` the step count, ``opt_state/0/1/...`` mu,
``opt_state/0/2/...`` nu) and a checkpoint's moments load in either
package (``utils.params.opt_state_to_numpy`` / ``opt_state_from_numpy``).

Per step, in optax's order of operations:
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u += weight_decay * p;     p += -lr * u
Unlike optax, which returns new trees, the update writes the moments and
the parameters IN PLACE (``torch._foreach_*`` over all tensors at once):
no second copy of 2 x params of state. ``count`` is a 0-d int32 tensor
kept on the host, so the bias corrections need no read from the device.

Not ported (each raises, ROADMAP.md): the 'linear' scheduler, adafactor,
bf16 first moments and the bf16 shadow weights.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from sea_tpu_torch.configs.base import TrainConfig
from sea_tpu_torch.utils.params import tree_leaves, tree_map


class ScaleByAdamState(NamedTuple):
    count: Any  # 0-d int32 tensor on the host
    mu: Any     # tree like params
    nu: Any


def global_norm(tensors):
    """optax.global_norm: sqrt of the sum of squares of every element, as
    an f32 0-d tensor on the tensors' device. On the CPU each tensor's norm
    accumulates in f64: there an f32 norm of the cylinder model's
    multi-million-element gradients came out ~1e-4 (relative) below the
    card's, whose _foreach_norm needs no such help."""
    if tensors[0].device.type == "cpu":
        norms = [torch.linalg.vector_norm(t, dtype=torch.float64)
                 for t in tensors]
        return torch.linalg.vector_norm(torch.stack(norms)).float()
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    def __init__(self, learning_rate: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0):
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay

    def init(self, params):
        """(ScaleByAdamState(0, zeros, zeros), (), ()) — tx.init's tree."""
        return (ScaleByAdamState(torch.zeros((), dtype=torch.int32),
                                 tree_map(torch.zeros_like, params),
                                 tree_map(torch.zeros_like, params)), (), ())

    @torch.no_grad()
    def step(self, grads, state, params):
        """Apply one update IN PLACE to ``params`` (the tree's tensors) and
        to the moments of ``state``; returns the new state (the count
        advanced)."""
        adam = state[0]
        p = tree_leaves(params)
        mu, nu = tree_leaves(adam.mu), tree_leaves(adam.nu)
        g = list(grads)
        if not len(p) == len(mu) == len(nu) == len(g):
            raise ValueError(f"{len(g)} grads for {len(p)} params, "
                             f"{len(mu)}/{len(nu)} moments")
        count = adam.count + 1
        n = int(count)
        bc1 = float(np.float32(1) - np.float32(self.b1) ** np.int32(n))
        bc2 = float(np.float32(1) - np.float32(self.b2) ** np.int32(n))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        u = torch._foreach_div(mu, bc1)
        denom = torch._foreach_div(nu, bc2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(u, denom)
        del denom
        if self.weight_decay:
            torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_add_(p, u)
        return (ScaleByAdamState(count, adam.mu, adam.nu),) + tuple(state[1:])


def make_optimizer(cfg: TrainConfig) -> AdamW:
    """The optimizer of a TrainConfig, as the JAX package builds it."""
    unported = []
    if cfg.scheduler is not None:
        unported.append(f"scheduler={cfg.scheduler!r}")
    if getattr(cfg, "optimizer", "adamw") != "adamw":
        unported.append(f"optimizer={cfg.optimizer!r}")
    if getattr(cfg, "adam_mu_dtype", "float32") != "float32":
        unported.append(f"adam_mu_dtype={cfg.adam_mu_dtype!r}")
    if getattr(cfg, "compute_dtype", "float32") != "float32":
        unported.append(f"compute_dtype={cfg.compute_dtype!r}")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to sea_tpu_torch yet; the "
            "port trains AdamW in f32 with a constant learning rate (see "
            "ROADMAP.md)")
    return AdamW(cfg.learning_rate, b1=cfg.betas[0], b2=cfg.betas[1],
                 eps=cfg.eps, weight_decay=cfg.weight_decay)
