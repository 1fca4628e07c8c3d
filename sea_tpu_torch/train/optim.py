"""AdamW with optax's semantics and state layout, and the bf16 shadow.

Counterpart of ``make_optimizer`` in ``sea_tpu/train/optim.py`` for the
recipe both shipped cases train with: ``optax.adamw`` with betas, eps and
weight decay from the TrainConfig, a constant learning rate, f32 second
moments and f32 or bf16 first moments (``adam_mu_dtype``). The state has
the layout of ``tx.init(params)`` in the JAX package — ``(ScaleByAdamState
(count, mu, nu), EmptyState(), EmptyState())`` — so it flattens to the same
npz paths (``opt_state/0/0`` the step count, ``opt_state/0/1/...`` mu,
``opt_state/0/2/...`` nu) and a checkpoint's moments load in either
package (``utils.params.opt_state_to_numpy`` / ``opt_state_from_numpy``).

Per step, in optax's order of operations:
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u += weight_decay * p;     p += -lr * u
With a bf16 mu (optax 0.2.6): b1 is rounded to bf16 (JAX's weak typing
makes ``b1 * mu`` a bf16 product), the new mu is formed in f32, u comes
from that f32 mu, and only then is mu stored rounded to bf16. XLA on the
CPU fuses ``(1 - b1) g + b1 mu`` and rounds it once; here the two products
round to f32 before the add, an f32 ulp of mu at most, which moves the
stored bf16 mu by an ulp only where it lies on a rounding boundary.
Unlike optax, which returns new trees, the update writes the moments and
the parameters IN PLACE (``torch._foreach_*`` over all tensors at once):
no second copy of 2 x params of state. ``count`` is a 0-d int32 tensor
kept on the host, so the bias corrections need no read from the device.

``with_bf16_shadow`` wraps an optimizer for compute_dtype
"bfloat16_shadow": its state, ``ShadowOptState(inner, shadow)``, carries a
bf16 copy of the f32 master parameters that the train step differentiates;
each step widens the bf16 gradients to f32, updates the masters and the
inner state, and refreshes the shadow from the updated masters, in place.

Not ported (each raises, ROADMAP.md): the 'linear' scheduler and
adafactor.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import numpy as np
import torch

from sea_tpu_torch.configs.base import TrainConfig
from sea_tpu_torch.utils.params import tree_leaves, tree_map


class ScaleByAdamState(NamedTuple):
    count: Any  # 0-d int32 tensor on the host
    mu: Any     # tree like params, f32 or bf16
    nu: Any


class ShadowOptState(NamedTuple):
    """The state of ``with_bf16_shadow``: npz paths ``opt_state/0/...``
    (the inner state) and ``opt_state/1/...`` (the shadow), as the JAX
    package's."""
    inner: Any
    shadow: Any  # to_bf16(master params)


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
                 weight_decay: float = 0.0, mu_dtype=torch.float32):
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype {mu_dtype}: float32 or bfloat16")
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.mu_dtype = mu_dtype

    def init(self, params):
        """(ScaleByAdamState(0, zeros, zeros), (), ()) — tx.init's tree."""
        return (ScaleByAdamState(
            torch.zeros((), dtype=torch.int32),
            tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                     params),
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
        if self.mu_dtype == torch.bfloat16:
            b1 = float(torch.tensor(self.b1, dtype=torch.bfloat16))
            mu32 = torch._foreach_mul(g, 1.0 - self.b1)
            torch._foreach_add_(mu32, [m.float() for m in mu], alpha=b1)
        else:
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
            mu32 = mu
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        u = torch._foreach_div(mu32, bc1)
        if mu32 is not mu:
            torch._foreach_copy_(mu, mu32)  # stored rounded to bf16
            del mu32
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


class with_bf16_shadow:  # noqa: N801 — the JAX package's name
    """Wrap ``tx`` (an AdamW) for compute_dtype "bfloat16_shadow": its
    state carries the bf16 shadow of the master params, refreshed after
    each update as to_bf16 of the updated masters. The inner update sees
    f32 gradients (the bf16 ones widened) and the f32 masters, so the
    moments, bias corrections and weight decay are the plain recipe's."""

    def __init__(self, tx: AdamW):
        self.inner = tx

    def init(self, params):
        from sea_tpu_torch.utils.precision import to_bf16
        return ShadowOptState(self.inner.init(params), to_bf16(params))

    @torch.no_grad()
    def step(self, grads, state, params):
        """Update ``params`` and the inner state in place from ``grads``
        (bf16, taken with respect to the shadow), then refresh the shadow
        in place; returns the new state."""
        inner = self.inner.step([g.float() for g in grads], state.inner,
                                params)
        torch._foreach_copy_(tree_leaves(state.shadow), tree_leaves(params))
        return ShadowOptState(inner, state.shadow)


def make_optimizer(cfg: TrainConfig):
    """The optimizer of a TrainConfig, as the JAX package builds it: AdamW,
    its first moment in bf16 when adam_mu_dtype is "bfloat16", wrapped by
    with_bf16_shadow when compute_dtype is "bfloat16_shadow"."""
    unported = []
    if cfg.scheduler is not None:
        unported.append(f"scheduler={cfg.scheduler!r}")
    if getattr(cfg, "optimizer", "adamw") != "adamw":
        unported.append(f"optimizer={cfg.optimizer!r}")
    if unported:
        raise NotImplementedError(
            f"{', '.join(unported)}: not ported to sea_tpu_torch yet; the "
            "port trains AdamW with a constant learning rate (see "
            "ROADMAP.md)")
    bf16_mu = getattr(cfg, "adam_mu_dtype", "float32") == "bfloat16"
    tx = AdamW(cfg.learning_rate, b1=cfg.betas[0], b2=cfg.betas[1],
               eps=cfg.eps, weight_decay=cfg.weight_decay,
               mu_dtype=torch.bfloat16 if bf16_mu else torch.float32)
    if getattr(cfg, "compute_dtype", "float32") == "bfloat16_shadow":
        return with_bf16_shadow(tx)
    return tx
