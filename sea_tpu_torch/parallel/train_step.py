"""Sharded train steps and the sharded rollout: the port's counterpart of
``sea_tpu/parallel/train_step.py``'s mesh paths.

Each builder takes the grid (``mesh.make_mesh``) and the GLOBAL params
(the npz layout: numpy for the train steps, tensors for the rollout) and
returns what the JAX builder returns, ``(step, placed_params,
placed_opt, place_batch)``: the step a rank runs, the rank's shard of
the params and of the optimizer state on its device, and a function that
cuts the rank's block of a global batch. The step is the one-device step
(``train_temporal.make_train_step``, ``train_spatial.make_train_step``)
with the grid: the forward on the rank's shards, gradients summed over
the data ranks, norms over the model ranks, the optimizer told each
leaf's split (``Optimizer.on_grid``). Every rank keeps the same key
sequence, so the dropout masks are one device's, hashed at global
positions.
"""

from __future__ import annotations

import numpy as np
import torch

from sea_tpu_torch.parallel.collectives import Grid, sharded
from sea_tpu_torch.parallel.mesh import (shard, shard_batch, shard_seq,
                                         spatial_param_dims,
                                         temporal_param_dims)
from sea_tpu_torch.utils.params import (from_numpy, opt_state_from_numpy,
                                        tree_leaves, tree_map)


def _place_state(grid: Grid, tx, params, dims, device, init_opt_state,
                 mu_dtype):
    """(this rank's params, the optimizer on the grid, its state): the
    state from ``tx.init`` of the shards, or a restored global state
    sliced as ``tx.state_dims`` says."""
    placed = from_numpy(shard(grid, params, dims), device)
    shapes = [np.shape(a) for a in tree_leaves(params)]
    tx = tx.on_grid(grid, tree_leaves(dims), shapes)
    if init_opt_state is None:
        opt = tx.init(placed)
    else:
        opt = opt_state_from_numpy(
            shard(grid, init_opt_state, tx.state_dims(dims, params)),
            device, mu_dtype)
    return placed, tx, opt


def _batch_placer(grid: Grid, device):
    def place(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            shard_batch(grid, np.asarray(a)))).to(device) for a in arrays)
    return place


def make_sharded_temporal_train_step(grid: Grid, cfg, tx, params, *, device,
                                     compute_dtype: str = "float32",
                                     init_opt_state=None, mu_dtype=None,
                                     log_norms: bool = True,
                                     per_tensor: bool = False):
    """The temporal step over ``grid``; place_batch(src, tgt, ib) takes
    global numpy batches (rows a multiple of n_data)."""
    from sea_tpu_torch.train.train_temporal import make_train_step
    dims = temporal_param_dims(params)
    placed, tx, opt = _place_state(grid, tx, params, dims, device,
                                   init_opt_state, mu_dtype)
    step = make_train_step(cfg, tx, compute_dtype=compute_dtype,
                           log_norms=log_norms, per_tensor=per_tensor,
                           grid=grid, dims=tree_leaves(dims))
    return step, placed, opt, _batch_placer(grid, device)


def make_seq_parallel_train_step(grid: Grid, cfg, tx, params, *, device,
                                 compute_dtype: str = "float32",
                                 init_opt_state=None, mu_dtype=None,
                                 log_norms: bool = True,
                                 per_tensor: bool = False):
    """The temporal step over a seq grid (``mesh.make_seq_mesh``): the
    time axis of src, tgt and ib split over the ring, the params and the
    optimizer state replicated, every attention a ring
    (``parallel.ring_attention``), the loss the global MSE (each rank's
    time block's share, summed) and the gradients summed over the seq
    ranks before the norms and the update. place_batch(src, tgt, ib)
    takes global numpy batches whose time axis divides by the ring."""
    from sea_tpu_torch.train.train_temporal import make_train_step
    placed = from_numpy(params, device)
    opt = (tx.init(placed) if init_opt_state is None
           else opt_state_from_numpy(init_opt_state, device, mu_dtype))
    step = make_train_step(cfg, tx, compute_dtype=compute_dtype,
                           log_norms=log_norms, per_tensor=per_tensor,
                           grid=grid)

    def place(*arrays):
        return tuple(torch.from_numpy(np.ascontiguousarray(
            shard_seq(grid, np.asarray(a)))).to(device) for a in arrays)
    return step, placed, opt, place


def make_sharded_spatial_train_step(grid: Grid, cfg, tx, params, *, device,
                                    compute_dtype: str = "float32",
                                    kl_weight_min: float = 0.0,
                                    kl_weight_max: float = 0.0,
                                    total_steps: int = 1,
                                    init_opt_state=None, mu_dtype=None,
                                    log_norms: bool = True,
                                    per_tensor: bool = False):
    """The stage-1 step over ``grid`` (the variational loss included);
    step(params, opt_state, batch, key, iteration) as the one-device
    step; place_batch(batch) takes a global numpy batch."""
    from sea_tpu_torch.train.train_spatial import make_train_step
    dims = spatial_param_dims(params)
    placed, tx, opt = _place_state(grid, tx, params, dims, device,
                                   init_opt_state, mu_dtype)
    step = make_train_step(cfg, tx, kl_weight_min=kl_weight_min,
                           kl_weight_max=kl_weight_max,
                           total_steps=total_steps,
                           compute_dtype=compute_dtype, log_norms=log_norms,
                           per_tensor=per_tensor, grid=grid,
                           dims=tree_leaves(dims))
    place = _batch_placer(grid, device)
    return step, placed, opt, lambda batch: place(batch)[0]


def make_sharded_rollout(grid: Grid, cfg, params, *, device,
                         cache_dtype=torch.float32):
    """The scan rollout with trajectories split over the data ranks and
    tensor-parallel params: (run, placed_params, place_batch);
    run(placed_params, x0, ib) returns this rank's trajectories
    [B/D, T, G, E]. ``params``: the global serving tree (f32, bf16, int8
    or int4 layouts, unfused). Scan-incremental configs only, as in the
    JAX function."""
    from sea_tpu_torch.models.temporal import is_scan_incremental
    from sea_tpu_torch.rollout.engine import rollout_scan
    if not is_scan_incremental(cfg):
        raise ValueError(
            "make_sharded_rollout requires a scan-incremental config "
            "(no attention ib-conditioning, src_len == 0; every exchange "
            "mode incl. pool qualifies); use rollout.engine.rollout for "
            "the prefix-recompute fallback")
    placed = tree_map(lambda a: a.to(device),
                      shard(grid, params, temporal_param_dims(params)))

    def run(params, x0, ib):
        with sharded(grid):
            return rollout_scan(params, cfg, x0, ib, cache_dtype=cache_dtype)
    return run, placed, _batch_placer(grid, device)
