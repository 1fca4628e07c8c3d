"""The optimizers of the JAX package, with optax's semantics and state
layouts, and the bf16 shadow.

Counterpart of ``make_optimizer`` in ``sea_tpu/train/optim.py``:
``optax.adamw`` with betas, eps and weight decay from the TrainConfig and
f32 or bf16 first moments (``adam_mu_dtype``), or ``optax.adafactor`` as
the JAX package configures it (``optimizer="adafactor"``); either at a
constant learning rate or on ``optax.linear_schedule`` from 0.1 lr to lr
over ``epoch_num`` optimizer steps (``scheduler="linear"``: the JAX
package's clock is the update count, not the epoch). The states have the
layout of ``tx.init(params)`` in the JAX package, so they flatten to the
same npz paths and a checkpoint's state loads in either package
(``utils.params.to_numpy`` / ``opt_state_from_numpy``):

- AdamW: ``(ScaleByAdamState(count, mu, nu), EmptyState(), EmptyState())``
  (``opt_state/0/0`` the step count, ``opt_state/0/1/...`` mu,
  ``opt_state/0/2/...`` nu); with the schedule the third element is
  ``ScaleByScheduleState(count)``.
- Adafactor: ``(FactoredState(count, v_row, v_col, v), EmptyState(),
  EmptyState(), [EmptyState(),] EmptyState())`` (the bracketed element
  with weight decay), the schedule's state again third.
EmptyState is ``()`` here.

AdamW per step, in optax's order of operations:
    mu = (1 - b1) g + b1 mu;   nu = (1 - b2) g^2 + b2 nu;   count += 1
    u  = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)
    u += weight_decay * p;     p += -lr * u
With a bf16 mu (optax 0.2.6): b1 is rounded to bf16 (JAX's weak typing
makes ``b1 * mu`` a bf16 product), the new mu is formed in f32, u comes
from that f32 mu, and only then is mu stored rounded to bf16. XLA on the
CPU fuses ``(1 - b1) g + b1 mu`` and rounds it once; here the two products
round to f32 before the add, an f32 ulp of mu at most, which moves the
stored bf16 mu by an ulp only where it lies on a rounding boundary.

Adafactor per step (optax's chain: scale_by_factored_rms, then
clip_by_block_rms(1), the learning rate, add_decayed_weights, scale(-1)),
with d = 1 - (count + 1)^-0.8 and g2 = g^2 + 1e-30:
- a leaf whose two largest dims are both at least 128 keeps the row and
  column means of g2 (v_row, v_col: the leaf's shape without its largest,
  resp. second-largest, dim), v = d v + (1 - d) mean(g2); u = g
  rsqrt(v_row / mean(v_row)) rsqrt(v_col), each factor broadcast back;
- any other leaf keeps v = d v + (1 - d) g2 whole; u = g rsqrt(v);
then u /= max(1, rms(u)) per leaf, u *= lr, u += weight_decay * p (after
the learning rate, so the decay is not scaled by it), p -= u.

Unlike optax, which returns new trees, the updates write the statistics
and the parameters IN PLACE (``torch._foreach_*`` where a pass covers
many tensors): no second copy of the state. AdamW runs over groups of
leaves (``UPDATE_GROUPS``), so its temporaries stay a fraction of a
parameter copy. The counts are 0-d int32 tensors kept on the host, so
the bias corrections, the decay and the schedule need no read from the
device.

``with_bf16_shadow`` wraps an optimizer for compute_dtype
"bfloat16_shadow": its state, ``ShadowOptState(inner, shadow)``, carries a
bf16 copy of the f32 master parameters that the train step differentiates;
each step widens the bf16 gradients to f32, updates the masters and the
inner state, and refreshes the shadow from the updated masters, in place.

On a ``--mesh`` grid (``parallel``) a rank updates its shards of the
tensor-parallel leaves. AdamW is elementwise and needs nothing more.
``on_grid`` gives Adafactor each leaf's split axis and global shape: it
factors a leaf as its global shape says, and its row and column means,
the mean of v_row and the update's RMS clip sum over the model ranks
where the leaf is split. ``state_dims`` gives each state leaf the axis it
is split on (the shadow's and the moments' are their params'), so
``parallel.mesh.shard`` and ``unshard`` move a state between the global
npz layout and a rank's shards. ``global_norm`` and
``sharded_tensor_norms`` sum a split leaf's squares over the model ranks
and count a replicated one once.
"""

from __future__ import annotations

import math
from typing import Any, NamedTuple

import numpy as np
import torch

from sea_tpu_torch.configs.base import TrainConfig
from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.parallel.mesh import REPLICATED
from sea_tpu_torch.utils.params import tree_leaves, tree_map


class ScaleByAdamState(NamedTuple):
    count: Any  # 0-d int32 tensor on the host
    mu: Any     # tree like params, f32 or bf16
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: Any  # 0-d int32 tensor on the host: updates made so far


class FactoredState(NamedTuple):
    """Adafactor's statistics (optax's FactoredState): per leaf, v_row and
    v_col for a factored leaf (v a [1] placeholder), v for the others
    (v_row and v_col [1] placeholders)."""
    count: Any  # 0-d int32 tensor on the host
    v_row: Any
    v_col: Any
    v: Any


class ShadowOptState(NamedTuple):
    """The state of ``with_bf16_shadow``: npz paths ``opt_state/0/...``
    (the inner state) and ``opt_state/1/...`` (the shadow), as the JAX
    package's."""
    inner: Any
    shadow: Any  # to_bf16(master params)


def _norms(tensors):
    """Each tensor's L2 norm, 0-d on its device: f32 from _foreach_norm
    on the card; on the CPU accumulated in f64, where an f32 norm of the
    cylinder model's multi-million-element gradients came out ~1e-4
    (relative) below the card's."""
    if tensors[0].device.type == "cpu":
        return [torch.linalg.vector_norm(t, dtype=torch.float64)
                for t in tensors]
    return torch._foreach_norm([t.float() for t in tensors])


def tensor_norms(tensors):
    """[the f32 L2 norm of each tensor], 0-d tensors on their device."""
    return [n.float() for n in _norms(tensors)]


def global_norm(tensors, dims=None, grid=None):
    """optax.global_norm: sqrt of the sum of squares of every element, as
    an f32 0-d tensor on the tensors' device (each tensor's norm as in
    ``tensor_norms``, in f64 on the CPU). ``dims`` (each tensor's split
    axis, ``parallel.mesh``) and a tensor-parallel ``grid``: the norm of
    the global tensors, whose split leaves this rank holds a slice of."""
    if grid is None or grid.n_model == 1:
        return torch.linalg.vector_norm(torch.stack(_norms(tensors))).float()
    sq = torch.stack(sharded_tensor_norms(tensors, dims, grid, f32=False))
    return torch.linalg.vector_norm(sq).float()


def sharded_tensor_norms(tensors, dims, grid, f32: bool = True):
    """``tensor_norms`` of the global tensors a rank holds slices of: a
    split leaf's squares summed over the model ranks (``dims``: each
    tensor's split axis)."""
    norms = _norms(tensors)
    if grid is not None and grid.n_model > 1:
        sq = torch.stack(norms) ** 2
        split = torch.tensor([d != REPLICATED for d in dims],
                             device=sq.device)
        total = collectives.all_reduce(sq, grid.model_group)
        norms = list(torch.sqrt(torch.where(split, total, sq)).unbind())
    return [n.float() for n in norms] if f32 else norms


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int):
    """optax.linear_schedule: count -> the learning rate of the update
    made at that count, in f32 as optax computes it, from init_value to
    end_value over transition_steps counts, then held."""
    if transition_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        k = np.float32(min(max(count, 0), transition_steps))
        frac = np.float32(1) - k / np.float32(transition_steps)
        return float(np.float32(init_value - end_value) * frac
                     + np.float32(end_value))
    return schedule


def _lr_init(learning_rate):
    """The state element of optax's scale_by_learning_rate: EmptyState for
    a constant, ScaleByScheduleState for a schedule."""
    if callable(learning_rate):
        return ScaleByScheduleState(torch.zeros((), dtype=torch.int32))
    return ()


def _lr_dims(learning_rate):
    """The split axes of the lr state: a replicated count, or nothing."""
    if callable(learning_rate):
        return ScaleByScheduleState(REPLICATED)
    return ()


def _lr_step(learning_rate, lr_state):
    """(this update's learning rate, the next lr state)."""
    if not callable(learning_rate):
        return learning_rate, lr_state
    return (learning_rate(int(lr_state.count)),
            ScaleByScheduleState(lr_state.count + 1))


class AdamW:
    """optax.adamw. ``learning_rate``: a float, or a schedule (a function
    of the update count, ``linear_schedule``)."""

    def __init__(self, learning_rate, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 weight_decay: float = 0.0, mu_dtype=torch.float32):
        if mu_dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"mu_dtype {mu_dtype}: float32 or bfloat16")
        self.lr, self.b1, self.b2 = learning_rate, b1, b2
        self.eps, self.weight_decay = eps, weight_decay
        self.mu_dtype = mu_dtype

    def on_grid(self, grid, dims, shapes):
        """Elementwise: a rank's shards update as the global leaves."""
        return self

    def state_dims(self, dims, shapes):
        """Split axes of the state (``parallel.mesh``): mu and nu as
        their params."""
        return (ScaleByAdamState(REPLICATED, dims, dims), (),
                _lr_dims(self.lr))

    def init(self, params):
        """(ScaleByAdamState(0, zeros, zeros), (), () or the schedule's
        state) — tx.init's tree."""
        return (ScaleByAdamState(
            torch.zeros((), dtype=torch.int32),
            tree_map(lambda p: torch.zeros_like(p, dtype=self.mu_dtype),
                     params),
            tree_map(torch.zeros_like, params)), (), _lr_init(self.lr))

    @torch.no_grad()
    def step(self, grads, state, params):
        """Apply one update IN PLACE to ``params`` (the tree's tensors) and
        to the moments of ``state``; returns the new state (the counts
        advanced)."""
        adam = state[0]
        lr, lr_state = _lr_step(self.lr, state[2])
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
        for group in leaf_groups(p, UPDATE_GROUPS):
            self._update(*([x[i] for i in group] for x in (p, mu, nu, g)),
                         lr, bc1, bc2)
        return (ScaleByAdamState(count, adam.mu, adam.nu), state[1],
                lr_state)

    def _update(self, p, mu, nu, g, lr, bc1, bc2):
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
        torch._foreach_mul_(u, -lr)
        torch._foreach_add_(p, u)


# AdamW updates its leaves in consecutive groups of at most 1/UPDATE_GROUPS
# of the parameters' elements (or one leaf, where a leaf is larger): the
# update's temporaries (u and the denominator; with a bf16 mu, mu in f32
# too) then take a fraction of a parameter copy, not two whole copies,
# which set the step's peak where the activations are small (a 4-layer
# cylinder step under remat, PERF.md). Per element the arithmetic is the
# same.
UPDATE_GROUPS = 4


def leaf_groups(leaves, n_groups: int):
    """Consecutive groups of leaf indices, each of at most
    max(total / n_groups, the largest leaf) elements."""
    sizes = [x.numel() for x in leaves]
    budget = max(sum(sizes) / n_groups, max(sizes, default=0))
    groups, total = [[]], 0
    for i, size in enumerate(sizes):
        if groups[-1] and total + size > budget:
            groups.append([])
            total = 0
        groups[-1].append(i)
        total += size
    return [group for group in groups if group]


def factored_dims(shape, min_dim_size_to_factor: int = 128):
    """optax's _factored_dims: (second-largest, largest) dim of a leaf
    whose second-largest dim is at least min_dim_size_to_factor, else
    None (np.argsort's order, so equal dims split as optax splits them)."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return int(order[-2]), int(order[-1])


class Adafactor:
    """optax.adafactor(learning_rate, multiply_by_parameter_scale=False,
    clipping_threshold=1.0, momentum=None, weight_decay_rate=wd or None):
    the JAX package's adafactor. ``learning_rate``: a float or a
    schedule."""

    DECAY_RATE = 0.8
    EPS = 1e-30
    CLIP = 1.0

    def __init__(self, learning_rate, weight_decay: float = 0.0):
        self.lr, self.weight_decay = learning_rate, weight_decay
        # On a tensor-parallel grid: the grid, and each leaf's split axis
        # and global shape in tree_leaves order (``on_grid``).
        self.grid, self.dims, self.shapes = None, None, None

    def on_grid(self, grid, dims, shapes):
        """A copy for a rank holding slices of the leaves: ``dims`` and
        ``shapes`` are each leaf's split axis (``parallel.mesh``) and its
        global shape, in ``tree_leaves`` order."""
        tx = Adafactor(self.lr, self.weight_decay)
        if grid is not None and grid.n_model > 1:
            tx.grid, tx.dims = grid, list(dims)
            tx.shapes = [tuple(x) for x in shapes]
        return tx

    def _shape(self, i: int, p):
        """Leaf i's global shape (p its local slice)."""
        return tuple(p.shape) if self.shapes is None else self.shapes[i]

    def _mean(self, x, dim: int, i: int, axis: int, keepdim: bool = False):
        """x.mean(dim) of a statistic of leaf i whose dim ``dim`` is the
        leaf's axis ``axis``: where the leaf is split on that axis, over
        the global axis (the sum all-reduced over the model ranks)."""
        if self.dims is None or self.dims[i] != axis:
            return x.mean(dim=dim, keepdim=keepdim)
        return (collectives.all_reduce(x.sum(dim=dim, keepdim=keepdim),
                                       self.grid.model_group)
                / self.shapes[i][axis])

    def state_dims(self, dims, shapes):
        """Split axes of the state (``parallel.mesh``): v as its param
        where unfactored; v_row and v_col along the param's split axis
        where they keep it. ``shapes``: the global params (anything with
        a shape)."""
        def stat_dim(d, shape, which):
            f = factored_dims(shape)
            if d == REPLICATED or (f is None) != (which == "v"):
                return REPLICATED
            if which == "v":
                return d
            drop = f[1] if which == "v_row" else f[0]
            return REPLICATED if d == drop else d - (d > drop)
        flat = list(zip(tree_leaves(dims),
                        (tuple(np.shape(a)) for a in tree_leaves(shapes))))

        def tree(which):
            it = iter(flat)
            return tree_map(lambda _: stat_dim(*next(it), which), dims)
        tail = ((),) if self.weight_decay else ()
        return ((FactoredState(REPLICATED, tree("v_row"), tree("v_col"),
                               tree("v")), (), _lr_dims(self.lr))
                + tail + ((),))

    def init(self, params):
        shapes = iter([self._shape(i, p)
                       for i, p in enumerate(tree_leaves(params))] * 3)

        def stats(p, which):
            # factored as the global leaf; the statistic's local shape
            dims = factored_dims(next(shapes))
            if dims is None:
                shape = tuple(p.shape) if which == "v" else (1,)
            elif which == "v":
                shape = (1,)
            else:  # v_row drops the largest dim, v_col the second-largest
                drop = dims[1] if which == "v_row" else dims[0]
                shape = tuple(d for i, d in enumerate(p.shape) if i != drop)
            return torch.zeros(shape, dtype=p.dtype, device=p.device)

        factored = FactoredState(
            torch.zeros((), dtype=torch.int32),
            *(tree_map(lambda p, w=which: stats(p, w), params)
              for which in ("v_row", "v_col", "v")))
        tail = ((),) if self.weight_decay else ()
        return (factored, (), _lr_init(self.lr)) + tail + ((),)

    @torch.no_grad()
    def step(self, grads, state, params):
        """Apply one update IN PLACE to ``params`` and the statistics of
        ``state``; returns the new state (the counts advanced)."""
        fac = state[0]
        lr, lr_state = _lr_step(self.lr, state[2])
        p, g = tree_leaves(params), list(grads)
        v_row, v_col = tree_leaves(fac.v_row), tree_leaves(fac.v_col)
        v = tree_leaves(fac.v)
        if not len(p) == len(g) == len(v):
            raise ValueError(f"{len(g)} grads for {len(p)} params, "
                             f"{len(v)} statistics")
        decay = np.float32(1) - np.float32(int(fac.count) + 1) ** np.float32(
            -self.DECAY_RATE)
        keep, take = float(decay), float(np.float32(1) - decay)
        dims = [factored_dims(self._shape(i, x)) for i, x in enumerate(p)]
        u = [None] * len(p)
        whole = [i for i, d in enumerate(dims) if d is None]
        if whole:  # one pass over every unfactored leaf
            gw, vw = [g[i] for i in whole], [v[i] for i in whole]
            g2 = torch._foreach_mul(gw, gw)
            torch._foreach_add_(g2, self.EPS)
            torch._foreach_mul_(vw, keep)
            torch._foreach_add_(vw, g2, alpha=take)
            del g2
            for i, x in zip(whole, torch._foreach_mul(gw, torch._foreach_rsqrt(
                    vw))):
                u[i] = x
        fac_i = [i for i, d in enumerate(dims) if d is not None]
        if fac_i:
            rows, cols = [], []
            for i in fac_i:  # a leaf's squares at a time, not all at once
                d1, d0 = dims[i]
                g2 = g[i] * g[i] + self.EPS
                rows.append(self._mean(g2, d0, i, d0))
                cols.append(self._mean(g2, d1, i, d1))
                del g2
            vr, vc = [v_row[i] for i in fac_i], [v_col[i] for i in fac_i]
            for stat, new in ((vr, rows), (vc, cols)):
                torch._foreach_mul_(stat, keep)
                torch._foreach_add_(stat, new, alpha=take)
            del rows, cols
            for i, r, c in zip(fac_i, vr, torch._foreach_rsqrt(vc)):
                d1, d0 = dims[i]
                rd1 = d1 - 1 if d1 > d0 else d1
                row = torch.rsqrt(r / self._mean(r, rd1, i, d1,
                                                 keepdim=True))
                u[i] = g[i] * row.unsqueeze(d0) * c.unsqueeze(d1)
        # clip_by_block_rms: u / max(1, rms(u) / threshold), per leaf; the
        # rms as norm / sqrt(size), every leaf's in a few multi-tensor
        # launches.
        if self.grid is None:
            scale = torch._foreach_norm(u)
        else:  # the norms of the global updates
            scale = sharded_tensor_norms(u, self.dims, self.grid)
        torch._foreach_div_(scale, [math.sqrt(math.prod(self._shape(i, x)))
                                    * self.CLIP for i, x in enumerate(u)])
        torch._foreach_clamp_min_(scale, 1.0)
        for x, c in zip(u, scale):
            x.div_(c)
        torch._foreach_mul_(u, lr)
        if self.weight_decay:
            torch._foreach_add_(u, p, alpha=self.weight_decay)
        torch._foreach_sub_(p, u)
        return ((FactoredState(fac.count + 1, fac.v_row, fac.v_col, fac.v),
                 state[1], lr_state) + tuple(state[3:]))


class with_bf16_shadow:  # noqa: N801 — the JAX package's name
    """Wrap ``tx`` (AdamW or Adafactor) for compute_dtype
    "bfloat16_shadow": its state carries the bf16 shadow of the master
    params, refreshed after each update as to_bf16 of the updated masters.
    The inner update sees f32 gradients (the bf16 ones widened) and the
    f32 masters, so its statistics and weight decay are the plain
    recipe's."""

    def __init__(self, tx):
        self.inner = tx

    def on_grid(self, grid, dims, shapes):
        return with_bf16_shadow(self.inner.on_grid(grid, dims, shapes))

    def state_dims(self, dims, shapes):
        """The inner state's, and the shadow split as the params."""
        return ShadowOptState(self.inner.state_dims(dims, shapes), dims)

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
    """The optimizer of a TrainConfig, as the JAX package builds it: AdamW
    (its first moment in bf16 when adam_mu_dtype is "bfloat16") or
    Adafactor (``optimizer``), at the constant learning rate or on the
    linear schedule (``scheduler="linear"``: 0.1 lr to lr over epoch_num
    updates), wrapped by with_bf16_shadow when compute_dtype is
    "bfloat16_shadow"."""
    if cfg.scheduler == "linear":
        lr = linear_schedule(0.1 * cfg.learning_rate, cfg.learning_rate,
                             cfg.epoch_num)
    elif cfg.scheduler is None:
        lr = cfg.learning_rate
    else:
        raise ValueError(f"unknown scheduler {cfg.scheduler!r}")
    family = getattr(cfg, "optimizer", "adamw")
    if family == "adafactor":
        tx = Adafactor(lr, weight_decay=cfg.weight_decay)
    elif family == "adamw":
        bf16_mu = getattr(cfg, "adam_mu_dtype", "float32") == "bfloat16"
        tx = AdamW(lr, b1=cfg.betas[0], b2=cfg.betas[1], eps=cfg.eps,
                   weight_decay=cfg.weight_decay,
                   mu_dtype=torch.bfloat16 if bf16_mu else torch.float32)
    else:
        raise ValueError(f"unknown optimizer {family!r} (expected 'adamw' "
                         "or 'adafactor')")
    if getattr(cfg, "compute_dtype", "float32") == "bfloat16_shadow":
        return with_bf16_shadow(tx)
    return tx
