"""Pipeline-parallel temporal training (GPipe over (data, pipe) ranks):
the port's counterpart of ``sea_tpu/parallel/pipeline.py``
(``--pp S``, ``--pp_microbatches M``).

Rank r = d S + s is stage s of data replica d (``make_pipe_mesh``: pipe
is the fastest-varying axis, as in the JAX mesh). Stage s holds the
temporal blocks [s L/S, (s+1) L/S) in the one-device list layout
(``stage_params``) and a copy of ``ln_final``, replicated as
``pipeline_param_shardings`` replicates it; the JAX package's stacked
layer axis is a layout for ``shard_map`` and is not needed here.

The batch splits into M microbatches (rows [m B/M, (m+1) B/M)), and
data replica d takes the d-th of D slices of each, as the JAX
``P(None, 'data')`` placement does. ``pipeline_forward`` runs the JAX
schedule step for step: at step t stage s runs microbatch t - s through
its blocks and every stage passes its output on to the next
(``collectives.ring_shift`` in chain form, the JAX ``ppermute``); a stage
outside its window computes nothing (the JAX bubble computes values no
one reads). The last stage's outputs reach every stage, as the JAX
``psum`` over pipe does, and ``ln_final`` applies there. Dropout keys are
drawn outside the stages, one per (microbatch, global layer), as
``jax.random.split(rng, M L)`` draws them, so the sampled network does
not depend on S; inside a stage every op sees only its own microbatch
block (the JAX ``shard_map`` body's local arrays): dropout hashes the
block's flat positions and the flash kernels its own rows.

``make_pipeline_train_step``: all forwards, then all backwards in
reverse microbatch order (GPipe), each stage differentiating its stored
outputs by ``torch.autograd.grad`` with the gradient its successor sends
back over the chain; block gradients summed over the data group,
``grad_norm`` and ``param_norm`` the global ones (squares summed over
the pipe group, ``ln_final`` counted once). Divergences from the JAX
package (ROADMAP.md Queue 3): the grid must cover every rank (the JAX
CLI idles devices past D S); Adafactor factors each layer's leaves
(the JAX stacked leaves carry the layer axis); resume restores the params
only, as the JAX driver does.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from sea_tpu_torch.configs.base import TemporalModelConfig
from sea_tpu_torch.models.temporal import temporal_block
from sea_tpu_torch.ops import layers as L
from sea_tpu_torch.parallel.collectives import (all_gather_cat, all_reduce,
                                                mean_over, ring_shift,
                                                sum_over)
from sea_tpu_torch.train import metrics as M
from sea_tpu_torch.train.optim import _norms, tensor_norms
from sea_tpu_torch.utils.params import (from_numpy, tree_leaves, tree_map,
                                        tree_paths)
from sea_tpu_torch.utils.prng import split


@dataclasses.dataclass(frozen=True)
class PipeGrid:
    """This rank's place in a (data, pipe) grid: stage ``pipe_rank`` of
    data replica ``data_rank``."""
    n_pipe: int
    n_data: int = 1
    pipe_rank: int = 0
    data_rank: int = 0
    pipe_group: object = None
    data_group: object = None

    @property
    def size(self) -> int:
        return self.n_pipe * self.n_data

    @property
    def shape(self) -> dict:
        return {"data": self.n_data, "pipe": self.n_pipe}

    @property
    def last(self) -> bool:
        return self.pipe_rank == self.n_pipe - 1

    def layers(self, num_layers: int) -> slice:
        """The global blocks this stage holds."""
        if num_layers % self.n_pipe:
            raise ValueError(f"num_layers={num_layers} not divisible by "
                             f"pipe={self.n_pipe}")
        n = num_layers // self.n_pipe
        return slice(self.pipe_rank * n, (self.pipe_rank + 1) * n)


def make_pipe_mesh(n_pipe: int, n_data: int = 1) -> PipeGrid:
    """This rank's place in an n_data x n_pipe grid over every rank of the
    process group; rank = d n_pipe + s. Raises unless n_pipe n_data is
    the world size. Every rank must call it: it creates the groups."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if n_pipe < 1 or n_data < 1 or n_pipe * n_data != world:
        raise ValueError(
            f"make_pipe_mesh(n_pipe={n_pipe}, n_data={n_data}) needs "
            f"{n_pipe * n_data} ranks; the process group has {world}")
    if world == 1:
        return PipeGrid(1)
    pipe_group = data_group = None
    # new_group is collective: every rank creates every group, in order.
    for d in range(n_data):
        g = dist.new_group([d * n_pipe + s for s in range(n_pipe)])
        if rank // n_pipe == d:
            pipe_group = g
    for s in range(n_pipe):
        g = dist.new_group([d * n_pipe + s for d in range(n_data)])
        if rank % n_pipe == s:
            data_group = g
    return PipeGrid(n_pipe, n_data, rank % n_pipe, rank // n_pipe,
                    pipe_group, data_group)


def stage_params(grid: PipeGrid, params, num_layers: int):
    """This stage's part of a one-device tree: its blocks and ln_final."""
    return {"blocks": list(params["blocks"][grid.layers(num_layers)]),
            "ln_final": params["ln_final"]}


def gather_params(grid: PipeGrid, stage, num_layers: int):
    """The one-device tree from every stage's blocks (tensors), gathered
    over the pipe group in stage order; every rank gets it."""
    if grid.n_pipe == 1:
        return stage
    blocks = stage["blocks"]
    per_leaf = zip(*(tree_leaves(b) for b in blocks))
    gathered = [all_gather_cat(torch.stack(leaves), 0, grid.pipe_group,
                               grid.n_pipe) for leaves in per_leaf]
    out = []
    for i in range(num_layers):
        it = iter(g[i] for g in gathered)
        out.append(tree_map(lambda _: next(it), blocks[0]))
    return {"blocks": out, "ln_final": stage["ln_final"]}


def _check_batch(grid: PipeGrid, cfg, B: int, n_microbatches: int):
    """The JAX ``pipeline_forward``'s validation."""
    if cfg.num_layers % grid.n_pipe:
        raise ValueError(f"num_layers={cfg.num_layers} not divisible by "
                         f"pipe={grid.n_pipe}")
    if B % n_microbatches:
        raise ValueError(f"batch {B} not divisible by n_microbatches="
                         f"{n_microbatches}")
    if (B // n_microbatches) % grid.n_data:
        raise ValueError(
            f"microbatch size {B // n_microbatches} not divisible by the "
            f"mesh 'data' axis ({grid.n_data}); use batch divisible by "
            f"n_microbatches*data = {n_microbatches * grid.n_data}")


def place_microbatches(grid: PipeGrid, x, n_microbatches: int):
    """This rank's block [M, B/(M D), ...] of a global [B, ...] batch
    (numpy or torch): microbatch m's d-th slice."""
    B = x.shape[0]
    b = B // n_microbatches // grid.n_data
    x = x.reshape((n_microbatches, B // n_microbatches) + tuple(x.shape[1:]))
    return x[:, grid.data_rank * b:(grid.data_rank + 1) * b]


class _FromLastStage(torch.autograd.Function):
    """The JAX ``psum`` over pipe of the last stage's outputs (zeros on
    the others): every stage gets them. Each stage then computes the
    same loss from them, so the last stage's gradient is its own loss's:
    the backward passes it through."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _keys(rng, cfg, M_, deterministic):
    """Per (microbatch, global layer) dropout keys, or None."""
    if deterministic or rng is None:
        return None
    return split(rng, M_ * cfg.num_layers)


def _run_stage(grid, stage, cfg, x_mb, ib_mb, keys, *, deterministic,
               train):
    """The GPipe forward of this stage. Returns (records, outs): records
    (m, x_in, y) of the microbatches it ran (x_in a leaf needing a
    gradient on later stages when ``train``), outs the last stage's
    outputs by microbatch (None elsewhere)."""
    S, s = grid.n_pipe, grid.pipe_rank
    M_ = x_mb.shape[0]
    G = cfg.num_fields
    lo = grid.layers(cfg.num_layers).start
    records, outs = [], [None] * M_
    state = torch.zeros_like(x_mb[0])
    for t in range(M_ + S - 1):
        m = t - s
        y = None
        if 0 <= m < M_:
            x_in = x_mb[m] if s == 0 else state
            if train and s > 0:
                x_in = x_in.detach().requires_grad_(True)
            h = [x_in[:, :, g, :] for g in range(G)]
            for li, block in enumerate(stage["blocks"]):
                key = (None if keys is None
                       else keys[m * cfg.num_layers + lo + li])
                h = temporal_block(block, cfg, h, ib_mb[m], ib_mb[m],
                                   rng=key, deterministic=deterministic)
            y = torch.stack(h, dim=2)
            records.append((m, x_in, y))
            if grid.last:
                outs[m] = y
        if t < M_ + S - 2:  # the last step's output goes nowhere
            send = (torch.zeros_like(x_mb[0]) if y is None
                    else y.detach().to(x_mb.dtype))
            state = ring_shift([send], grid.pipe_group, 1, wrap=False)[0]
    return records, outs


def _finish(grid, stage, cfg, x_mb, ib_mb, outs):
    """Every stage's copy of the last stage's outputs [M, b, T, G, E]
    with ln_final applied."""
    out = (torch.stack(outs) if grid.last else torch.zeros_like(x_mb))
    out = _FromLastStage.apply(out, grid.pipe_group) if grid.n_pipe > 1 \
        else out
    flat = out.reshape((-1,) + tuple(out.shape[2:]))
    ib = ib_mb.reshape((-1,) + tuple(ib_mb.shape[2:]))
    x_vars = [L.apply_norm(stage["ln_final"][i], flat[:, :, i, :], ib)
              for i in range(cfg.num_fields)]
    return torch.stack(x_vars, dim=2).reshape(out.shape)


def pipeline_forward(stage, cfg: TemporalModelConfig, x, ib, *,
                     grid: PipeGrid, n_microbatches: int, rng=None,
                     deterministic: bool = True):
    """The pipelined ``temporal_forward``: x [B, T, G, E] and ib [B, T,
    ib_num], the global batch on every rank; ``stage`` this stage's
    params (``stage_params``). Returns the global output [B, T, G, E] on
    every rank. Deterministic, it equals the one-device forward."""
    B = x.shape[0]
    _check_batch(grid, cfg, B, n_microbatches)
    x_mb = place_microbatches(grid, x, n_microbatches)
    ib_mb = place_microbatches(grid, ib, n_microbatches)
    keys = _keys(rng, cfg, n_microbatches, deterministic)
    with torch.no_grad():
        _, outs = _run_stage(grid, stage, cfg, x_mb, ib_mb, keys,
                             deterministic=deterministic, train=False)
        out = _finish(grid, stage, cfg, x_mb, ib_mb, outs)
        out = all_gather_cat(out, 1, grid.data_group, grid.n_data)
    return out.reshape((B,) + tuple(out.shape[2:]))


def _global_norm(grid, block_leaves, ln_leaves):
    """sqrt(sum of squares) over every stage's blocks and one ln_final,
    f32 0-d (the squares in f64 on the CPU, as train.optim.global_norm)."""
    sq = torch.stack(_norms(block_leaves)) ** 2
    total = all_reduce(sq.sum().reshape(1), grid.pipe_group)[0]
    ln = torch.stack(_norms(ln_leaves)) ** 2
    return torch.sqrt(total + ln.sum()).float()


def _per_tensor(grid, stage, block_values, ln_values, prefix):
    """{prefix + one-device npz path: norm} of every stage's leaves,
    gathered over the pipe group (each stage holds alike blocks)."""
    local = torch.stack(tensor_norms(block_values))
    every = all_gather_cat(local, 0, grid.pipe_group, grid.n_pipe)
    per_block = len(tree_leaves(stage["blocks"][0]))
    n_local = len(stage["blocks"])
    names = tree_paths(stage["blocks"][0])
    out = {}
    for s in range(grid.n_pipe):
        for j in range(n_local):
            for k, name in enumerate(names):
                out[f"{prefix}blocks/{s * n_local + j}/{name}"] = every[
                    (s * n_local + j) * per_block + k]
    for name, n in zip(tree_paths(stage["ln_final"]),
                       tensor_norms(ln_values)):
        out[f"{prefix}ln_final/{name}"] = n
    return out


def make_pipeline_train_step(grid: PipeGrid, cfg: TemporalModelConfig, tx,
                             params, *, device, n_microbatches: int = 0,
                             compute_dtype: str = "float32",
                             log_norms: bool = True,
                             per_tensor: bool = False):
    """The teacher-forced temporal step with the blocks pipelined over
    the stages and the batch split over the data replicas. ``params``: the
    one-device tree (numpy). Returns (step, placed_params, placed_opt,
    place_batch): step(params, opt_state, src, tgt, ib, key) on this
    rank's stage params and microbatch blocks (``place_batch`` of the
    global numpy batch), as the other sharded steps. The optimizer state
    starts fresh (resume restores the params only)."""
    from sea_tpu_torch.utils.precision import train_cast
    M_ = n_microbatches or grid.n_pipe
    nl = cfg.num_layers
    if nl % grid.n_pipe:
        raise ValueError(f"num_layers={nl} not divisible by "
                         f"pipe={grid.n_pipe}")
    placed = from_numpy(stage_params(grid, params, nl), device)
    opt = tx.init(placed)
    cast_p, cast_x = train_cast(compute_dtype)
    shadow = compute_dtype == "bfloat16_shadow"
    n_data = grid.n_data

    def step(params, opt_state, src, tgt, ib, key):
        wrt = opt_state.shadow if shadow else params
        block_leaves = tree_leaves(wrt["blocks"])
        ln_leaves = tree_leaves(wrt["ln_final"])
        for leaf in block_leaves + ln_leaves:
            leaf.requires_grad_(True)
        stage = wrt if shadow else cast_p(params)
        s, i = cast_x(src, ib)
        records, outs = _run_stage(grid, stage, cfg, s, i,
                                   _keys(key, cfg, src.shape[0], False),
                                   deterministic=False, train=True)
        out = _finish(grid, stage, cfg, s, i, outs)
        loss = M.mse(out.float(), tgt)
        ys = [y for _, _, y in records] if grid.last else []
        got = torch.autograd.grad(loss / n_data if n_data > 1 else loss,
                                  ln_leaves + ys, allow_unused=True)
        ln_grads = [torch.zeros_like(p) if g is None else g
                    for p, g in zip(ln_leaves, got[:len(ln_leaves)])]
        g_out = dict(zip((m for m, _, _ in records), got[len(ln_leaves):]))
        block_grads = [torch.zeros_like(p) for p in block_leaves]
        by_m = {m: (x_in, y) for m, x_in, y in records}
        S, st = grid.n_pipe, grid.pipe_rank
        g_recv = None
        for t in reversed(range(M_ + S - 1)):
            m = t - st
            g_x = None
            if m in by_m:
                x_in, y = by_m[m]
                g_y = g_out[m] if grid.last else g_recv
                inputs = block_leaves + ([x_in] if st > 0 else [])
                gs = torch.autograd.grad(y, inputs, grad_outputs=g_y,
                                         allow_unused=True)
                for j, g in enumerate(gs[:len(block_leaves)]):
                    if g is not None:
                        block_grads[j] += g
                if st > 0:
                    g_x = gs[-1]
            if t > 0:  # the first step's input gradient goes nowhere
                send = (torch.zeros_like(s[0]) if g_x is None
                        else g_x.to(s.dtype))
                g_recv = ring_shift([send], grid.pipe_group, -1,
                                    wrap=False)[0]
        grads = sum_over(block_grads + ln_grads, grid.data_group)
        with torch.no_grad():
            loss = mean_over(loss.detach(), grid.data_group)
            g_blocks, g_ln = grads[:len(block_leaves)], grads[len(
                block_leaves):]
            if log_norms:
                p_leaves = tree_leaves(params)
                nb = len(tree_leaves(params["blocks"]))
                norms = {"grad_norm": _global_norm(grid, g_blocks, g_ln),
                         "param_norm": _global_norm(grid, p_leaves[:nb],
                                                    p_leaves[nb:])}
                if per_tensor:
                    norms["tensors"] = {
                        **_per_tensor(grid, params, g_blocks, g_ln,
                                      "Grad_Norm/"),
                        **_per_tensor(grid, params, p_leaves[:nb],
                                      p_leaves[nb:], "Param_Norm/")}
            else:
                zero = torch.zeros((), device=loss.device)
                norms = {"grad_norm": zero, "param_norm": zero}
            opt_state = tx.step(grads, opt_state, params)
        return params, opt_state, {"loss": loss, **norms}

    def place_batch(src, tgt, ib):
        B = src.shape[0]
        _check_batch(grid, cfg, B, M_)
        return tuple(torch.from_numpy(np.ascontiguousarray(
            place_microbatches(grid, np.asarray(a), M_))).to(device)
            for a in (src, tgt, ib))

    return step, placed, opt, place_batch
