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

A sequence-parallel grid (``mesh.make_seq_mesh``) is 1 x 1 with a seq
axis of n ranks: rank r holds time steps [r T/n, (r+1) T/n) of every
activation and all of the params; its ``seq_group`` carries the ring
(``parallel.ring_attention``), the loss and the gradient sums.

``all_reduce`` and ``all_gather`` carry the collectives: gloo carries
both for CUDA tensors. A bf16 tensor is summed in f32 and rounded once.
``ring_shift``, the counterpart of ``jax.lax.ppermute`` on a ring or a
chain, moves tensors between neighbouring ranks point to point: under
NCCL the tensors themselves, under gloo (ranks sharing a card, or the
CPU) a CUDA tensor through a host copy: gloo's send of a CUDA tensor
fails on the H100 machine ("writev ... Bad address": it reads the
device pointer as host memory; PERF.md).

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
    n_seq: int = 1
    seq_rank: int = 0
    seq_group: object = None

    @property
    def size(self) -> int:
        return self.n_data * self.n_model * self.n_seq

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


def seq_parallel() -> Optional[Grid]:
    """The current grid when it splits the time axis, else None."""
    g = current()
    return g if g is not None and g.n_seq > 1 else None


def time_offset(t_local: int) -> int:
    """The global position of the first of the t_local time steps this
    rank holds (0 unless the current grid splits time)."""
    g = seq_parallel()
    return 0 if g is None else g.seq_rank * t_local


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


def _replica_group(grid: Optional[Grid]):
    """The group over which the params are replicated and the batch is
    split: the data group, or the seq group of a seq grid (None when
    there is neither)."""
    if grid is None:
        return None
    if grid.n_seq > 1:
        return grid.seq_group
    return grid.data_group if grid.n_data > 1 else None


def sum_over(tensors, group):
    """Each tensor summed over ``group``, in one all-reduce of one flat
    f32 buffer; a list of new tensors (a bf16 gradient comes back in f32:
    its ranks' parts are summed in f32). Over no group, or a group of one
    rank, the tensors come back as they are."""
    if _group_size(group) == 1 or not tensors:
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view(t.shape))
        at += t.numel()
    return out


def mean_over(x, group):
    """The mean of a per-rank value over ``group``, no gradient."""
    if _group_size(group) == 1:
        return x
    return all_reduce(x, group) / _group_size(group)


def sum_over_data(tensors, grid: Optional[Grid]):
    """``sum_over`` the data group (the seq group of a seq grid: each
    rank's gradient is that of its time steps' share of the loss)."""
    return sum_over(tensors, _replica_group(grid))


def data_mean(x, grid: Optional[Grid]):
    """``mean_over`` the data group (the seq group of a seq grid)."""
    return mean_over(x, _replica_group(grid))


def ring_shift(tensors, group, direction: int = 1, wrap: bool = True):
    """``jax.lax.ppermute`` over ``group``: each rank sends its tensors to
    the rank ``direction`` places on in the group's order and returns the
    tensors of the rank as far the other way, new tensors of the same
    shapes and dtypes. ``wrap`` True: a ring. False: a chain, whose last
    rank (in ``direction``) sends nothing and whose first receives zeros.
    All ranks of the group call it together, with tensors of the same
    shapes. The transport is chosen by the backend's name: under NCCL the
    tensors go as they are; under gloo a CUDA tensor goes through a host
    copy (gloo's point-to-point does not carry CUDA tensors)."""
    tensors = list(tensors)
    n = _group_size(group)
    if n == 1:
        return ([t.detach().clone() for t in tensors] if wrap
                else [torch.zeros_like(t) for t in tensors])
    me = dist.get_rank(group)
    to, frm = me + direction, me - direction
    send = wrap or 0 <= to < n
    recv = wrap or 0 <= frm < n
    staged = dist.get_backend(group) != "nccl"
    ops, bufs = [], []
    for i, t in enumerate(tensors):
        if send:
            x = t.detach().contiguous()
            if staged and x.device.type != "cpu":
                x = x.cpu()
            ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
                group, to % n), group, tag=i))
        if recv:
            bufs.append(torch.empty(
                t.shape, dtype=t.dtype,
                device="cpu" if staged else t.device))
            ops.append(dist.P2POp(dist.irecv, bufs[-1], dist.get_global_rank(
                group, frm % n), group, tag=i))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if not recv:
        return [torch.zeros_like(t) for t in tensors]
    return [b.to(t.device) for b, t in zip(bufs, tensors)]
