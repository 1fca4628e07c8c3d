"""The (data, model) grid of ranks and the tensor-parallel layout of the
parameters: the port's counterpart of ``sea_tpu/parallel/mesh.py``.

``make_mesh(n_data, n_model)`` builds this rank's ``collectives.Grid``:
its data and model process groups. It raises unless n_data x n_model is
the world size; the JAX function warns and leaves the other devices
idle, but a rank outside the grid would have no batch block and no
shard (a documented divergence, ROADMAP.md Queue 3).

The JAX package writes PartitionSpecs and lets GSPMD place the arrays;
here ``temporal_param_dims`` and ``spatial_param_dims`` give each leaf
the axis it is split on over the model ranks (``REPLICATED`` otherwise),
``shard`` slices a global tree (the npz layout) into this rank's shard
and ``unshard`` gathers it back. The layout is the JAX specs':

- attention q, k, v column-parallel (output dim: the heads), the output
  projection row-parallel (input dim); ``_tp_attention_spec``;
- the per-field MLPs of the temporal blocks (``_tp_mlp_spec``): the first
  linear column-parallel with its hidden LayerNorm's weight and bias
  split alike, the last row-parallel, middle linears (no shipped config
  has them) replicated;
- every other leaf replicated (the spatial model shards its blocks'
  attention only, ``spatial_param_shardings``).

A linear's weight may be the plain ``w``, int8 ``w_q`` or packed int4
``w_p4`` [K/2, N], and its ``w_s`` follows the output dim
(``_tp_linear_spec``). A packed row k pairs inputs k and k + K/2, so a
row-parallel ``w_p4`` split over its rows stays a valid packed array
whose inputs are two slices of x (``ops.layers.linear``). A dim that does
not split evenly raises ValueError naming the divisibility; the JAX
package falls back to unsharded XLA there (ROADMAP.md Queue 3).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from sea_tpu_torch.parallel.collectives import Grid, all_gather_cat
from sea_tpu_torch.utils.params import tree_map

REPLICATED = -1


def make_mesh(n_data: Optional[int] = None, n_model: int = 1) -> Grid:
    """This rank's place in an n_data x n_model grid over every rank of
    the process group (one process: a 1 x 1 grid). Every rank must call
    it, in the same order: it creates the process groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_data is None:
        n_data = world // n_model
    if n_data < 1 or n_model < 1 or n_data * n_model != world:
        raise ValueError(
            f"make_mesh(n_data={n_data}, n_model={n_model}) needs "
            f"{n_data * n_model} ranks; the process group has {world}. "
            "Launch D*M ranks (torchrun --nproc_per_node D*M) for --mesh "
            "DxM.")
    if world == 1:
        return Grid(1, 1)
    data_group = model_group = None
    # new_group is collective: every rank creates every group, in order.
    for m in range(n_model):
        g = dist.new_group([d * n_model + m for d in range(n_data)])
        if rank % n_model == m:
            data_group = g
    for d in range(n_data):
        g = dist.new_group([d * n_model + m for m in range(n_model)])
        if rank // n_model == d:
            model_group = g
    return Grid(n_data, n_model, rank // n_model, rank % n_model,
                data_group, model_group)


def make_seq_mesh(n_seq: Optional[int] = None) -> Grid:
    """This rank's place on a ring of n_seq ranks over the time axis
    (``--seq_parallel N``; default: every rank of the process group). It
    raises unless n_seq is the world size, the same divergence as
    ``make_mesh``: the JAX function takes the first n_seq devices. Every
    rank must call it: it creates the group."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    n_seq = world if n_seq is None else n_seq
    if n_seq != world:
        raise ValueError(
            f"make_seq_mesh(n_seq={n_seq}) needs {n_seq} ranks; the process "
            f"group has {world}. Launch N ranks (torchrun --nproc_per_node "
            "N) for --seq_parallel N.")
    if world == 1:
        return Grid(1, 1)
    group = dist.new_group(list(range(world)))
    return Grid(1, 1, n_seq=world, seq_rank=rank, seq_group=group)


def shard_seq(grid: Grid, x, *, axis: int = 1):
    """This rank's contiguous block of x's time axis (the JAX
    P(None, 'seq') placement); numpy or torch. The axis must divide by
    the ring size."""
    n = x.shape[axis]
    if n % grid.n_seq:
        raise ValueError(f"{n} time steps do not split over the "
                         f"{grid.n_seq} ranks of the seq axis")
    t = n // grid.n_seq
    index = [slice(None)] * x.ndim
    index[axis] = slice(grid.seq_rank * t, (grid.seq_rank + 1) * t)
    return x[tuple(index)]


def parse_mesh(spec: str):
    """'DxM' -> (D, M); ValueError for anything else."""
    parts = spec.strip().lower().split("x")
    if len(parts) != 2 or not all(p.isdigit() and int(p) > 0 for p in parts):
        raise ValueError(f"--mesh must be 'auto', 'none', or DxM (e.g. "
                         f"4x2); got {spec!r}")
    return int(parts[0]), int(parts[1])


def shard_batch(grid: Grid, x, *, axis: int = 0):
    """This rank's contiguous block of x's rows along ``axis`` (the JAX
    P('data') placement); numpy or torch."""
    index = [slice(None)] * x.ndim
    index[axis] = grid.rows(x.shape[axis])
    return x[tuple(index)]


# ---------------------------------------------------------------------------
# Tensor-parallel layout: the axis each leaf splits on over the model ranks
# ---------------------------------------------------------------------------

def _tp_linear_dims(p, role: str):
    """The split axes of one linear's dict (plain, int8 or int4): 'col'
    splits the output dim (w/w_q/w_p4 axis 1, w_s and b axis 0), 'row'
    the input dim (w/w_q/w_p4 axis 0; w_s and b replicated)."""
    out = {}
    for k in p:
        if k in ("w", "w_q", "w_p4"):
            out[k] = 1 if role == "col" else 0
        elif k in ("w_s", "b"):
            out[k] = 0 if role == "col" else REPLICATED
        else:
            raise ValueError(f"linear leaf {k!r} has no tensor-parallel "
                             "layout (fused projections are not sharded)")
    return out


def _replicated(tree):
    return tree_map(lambda _: REPLICATED, tree)


def _tp_mlp_dims(p):
    """Megatron layout of one MLP (``_tp_mlp_spec``)."""
    layers = p["layers"]
    n = len(layers)
    out = []
    for i, entry in enumerate(layers):
        if n >= 2 and i in (0, n - 1):
            role = "col" if i == 0 else "row"
            # In the entry's own key order: a dims tree lists its leaves
            # in the order of the tree it describes.
            e = {k: (_tp_linear_dims(v, role) if k == "lin"
                     else {name: 0 for name in v}) for k, v in entry.items()}
        else:
            e = _replicated(entry)
        out.append(e)
    return {"layers": out}


def _tp_attention_dims(p):
    """q/k/v column-parallel over the heads, proj row-parallel."""
    if set(p) != {"q", "k", "v", "proj"}:
        raise ValueError(f"attention leaves {sorted(p)} have no "
                         "tensor-parallel layout (fused projections are "
                         "not sharded)")
    return {k: _tp_linear_dims(v, "row" if k == "proj" else "col")
            for k, v in p.items()}


def temporal_param_dims(params):
    """``temporal_param_shardings`` as split axes: every attention and the
    per-field MLPs tensor-parallel, everything else replicated."""
    def block_dims(block):
        dims = _replicated(block)
        dims["mlp"] = [_tp_mlp_dims(p) for p in block["mlp"]]
        for key in ("self_attn", "cross_attn_ib"):
            if key in block:
                dims[key] = [_tp_attention_dims(p) for p in block[key]]
        if "cross_attn" in block:
            ca = block["cross_attn"]
            if ca and isinstance(ca[0], list):  # sea: [G][G]
                dims["cross_attn"] = [[None if p is None
                                       else _tp_attention_dims(p)
                                       for p in row] for row in ca]
            else:  # pool: [G]
                dims["cross_attn"] = [_tp_attention_dims(p) for p in ca]
        return dims
    return {"blocks": [block_dims(b) for b in params["blocks"]],
            "ln_final": _replicated(params["ln_final"])}


def spatial_param_dims(params):
    """``spatial_param_shardings``: the blocks' attention over the model
    ranks, everything else replicated."""
    dims = _replicated(params)
    for i, block in enumerate(params["blocks"]):
        dims["blocks"][i]["attn"] = _tp_attention_dims(block["attn"])
    return dims


def _zip_map(fn, tree, dims):
    """fn(leaf, dim) over a tree and its dims tree."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, dims[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        children = [_zip_map(fn, v, d) for v, d in zip(tree, dims)]
        if hasattr(tree, "_fields"):
            return type(tree)(*children)
        return type(tree)(children)
    if tree is None:
        return None
    return fn(tree, dims)


def _slice(a, dim: int, grid: Grid):
    n = a.shape[dim]
    if n % grid.n_model:
        raise ValueError(
            f"tensor parallelism needs the split dim to divide evenly: a "
            f"leaf of shape {tuple(a.shape)} splits axis {dim} of size {n} "
            f"over {grid.n_model} model ranks")
    s = n // grid.n_model
    index = [slice(None)] * a.ndim
    index[dim] = slice(grid.model_rank * s, (grid.model_rank + 1) * s)
    part = a[tuple(index)]
    if isinstance(part, torch.Tensor):
        return part.contiguous().clone()
    return np.ascontiguousarray(part)


def shard(grid: Grid, tree, dims):
    """This rank's shard of a global tree (tensors or numpy arrays):
    each leaf sliced on its axis, the replicated ones kept."""
    if grid.n_model == 1:
        return tree
    return _zip_map(lambda a, d: a if d == REPLICATED else _slice(a, d, grid),
                    tree, dims)


def unshard(grid: Grid, tree, dims):
    """The global tree from every model rank's shard (tensors), gathered
    in rank order; replicated leaves as they are."""
    if grid.n_model == 1:
        return tree

    def gather(a, d):
        if d == REPLICATED:
            return a
        return all_gather_cat(a, d, grid.model_group, grid.n_model)
    return _zip_map(gather, tree, dims)
