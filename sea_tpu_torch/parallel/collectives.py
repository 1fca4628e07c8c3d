"""The collectives GSPMD inserts in the JAX package's sharded programs,
made explicit, and the grid the model code reads while it runs sharded.

Rank r of a D x M grid sits at (d, m) = (r // M, r % M): its data group
is the D ranks of its column (the same m), its model group the M ranks of
its row (the same d). It holds trajectories [d*B/D, (d+1)*B/D) of every
batch and, of each tensor-parallel weight, the m-th of M slices
(``parallel.mesh``).

Megatron's two operators over the model group, as autograd functions:
``copy_to_model`` (identity forward, all-reduce backward) where a
replicated activation enters a column-parallel linear, and
``reduce_from_model`` (all-reduce forward, identity backward) at a
row-parallel output. ``all_reduce_model`` (all-reduce both ways) carries
the statistics of the distributed hidden LayerNorm, a replicated value
computed from sharded ones that feeds sharded ones again. The data group
sums gradients (``sum_over_data``); every norm of a sharded leaf sums its
squares over the model group.

Only ``all_reduce`` and ``all_gather`` are called: gloo carries both
for CUDA tensors. A bf16 tensor is summed in f32 and rounded once.

``sharded(grid)`` makes a grid current while the model runs: ops
(``ops.layers``, ``ops.attention``) then take their local shapes, the
dropout hashes global positions, and the flash kernels get their
``bh_map``. No grid (or a 1 x 1 one) leaves every op as it was.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Optional

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Grid:
    """This rank's place in a (data, model) grid of ranks."""
    n_data: int
    n_model: int
    data_rank: int = 0
    model_rank: int = 0
    data_group: object = None
    model_group: object = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "model": self.n_model}

    def rows(self, n: int) -> slice:
        """This rank's block of n global rows (n divisible by n_data)."""
        if n % self.n_data:
            raise ValueError(f"{n} rows do not split over the {self.n_data} "
                             "ranks of the data axis")
        b = n // self.n_data
        return slice(self.data_rank * b, (self.data_rank + 1) * b)

    def local_heads(self, n_heads: int) -> int:
        """Heads a rank holds of an attention of n_heads."""
        if n_heads % self.n_model:
            raise ValueError(
                f"tensor parallelism needs n_heads % n_model == 0; got "
                f"{n_heads} heads over {self.n_model} model ranks")
        return n_heads // self.n_model

    def bh_map(self, b_loc: int, h_loc: int, n_heads: int, device):
        """int32 [b_loc * h_loc]: local (b, h) -> global b*H + h, the rows
        the flash kernels' dropout hash sees."""
        b0 = self.data_rank * b_loc
        h0 = self.model_rank * h_loc
        b = torch.arange(b0, b0 + b_loc, dtype=torch.int32, device=device)
        h = torch.arange(h0, h0 + h_loc, dtype=torch.int32, device=device)
        return (b[:, None] * n_heads + h[None, :]).reshape(-1).contiguous()


# The grid of the enclosing ``sharded`` block, per thread (as the JAX
# package's kernel-sharding context, ops/dispatch.py): the model code is
# functional, and the ops deep inside it read the grid from here.
_state = threading.local()


@contextlib.contextmanager
def sharded(grid: Optional[Grid]):
    """Run the enclosed model code on this rank's shards of ``grid``.
    None, or a 1 x 1 grid, leaves every op unsharded."""
    prev = current()
    _state.grid = grid if grid is not None and grid.size > 1 else None
    try:
        yield
    finally:
        _state.grid = prev


def current() -> Optional[Grid]:
    """The grid of the enclosing ``sharded`` block, or None."""
    return getattr(_state, "grid", None)


def tensor_parallel() -> Optional[Grid]:
    """The current grid when its model axis splits weights, else None."""
    g = current()
    return g if g is not None and g.n_model > 1 else None


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce(x, group):
    """The sum of x over ``group``, a new tensor (x itself when the group
    is one rank)."""
    if _group_size(group) == 1:
        return x
    if x.dtype == torch.bfloat16:  # summed in f32, then rounded once
        return all_reduce(x.float(), group).to(torch.bfloat16)
    y = x.detach().clone().contiguous()
    dist.all_reduce(y, group=group)
    return y


def all_gather_cat(x, dim: int, group, n: int):
    """Concatenate the n ranks' x along ``dim`` (each rank's x of one
    shape), in the group's rank order."""
    if n == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    return torch.cat(parts, dim)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


def copy_to_model(x):
    """Megatron's f: a replicated x entering column-parallel weights.
    Identity forward; the backward sums the ranks' partial gradients."""
    g = tensor_parallel()
    return x if g is None else _CopyToModel.apply(x, g.model_group)


def reduce_from_model(x):
    """Megatron's g: the partial products of a row-parallel linear summed
    over the model group. The backward passes the (replicated) gradient
    on unchanged."""
    g = tensor_parallel()
    return x if g is None else _ReduceFromModel.apply(x, g.model_group)


def all_reduce_model(x):
    """Sum over the model group, forward and backward: a statistic of
    sharded values (the hidden LayerNorm's) that sharded values read."""
    g = tensor_parallel()
    return x if g is None else _AllReduceBoth.apply(x, g.model_group)


def sum_over_data(tensors, grid: Optional[Grid]):
    """Each tensor summed over the data group, in one all-reduce of one
    flat f32 buffer; a list of new tensors (a bf16 gradient comes back in
    f32: its ranks' parts are summed in f32). Without a data axis the
    tensors come back as they are."""
    if grid is None or grid.n_data == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=grid.data_group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def data_mean(x, grid: Optional[Grid]):
    """The mean of a per-rank value over the data group (no gradient)."""
    if grid is None or grid.n_data == 1:
        return x
    return all_reduce(x, grid.data_group) / grid.n_data
