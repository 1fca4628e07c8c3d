"""What one rank of a gloo process group runs for the port's mesh tests
(tests/test_torch_parallel*.py, tests/test_torch_cli_mesh.py; not a
pytest module). It imports torch and the port only, never JAX:
``sea_tpu_torch.parallel.multihost.run_ranks`` starts the ranks with the
``spawn`` method, and each imports this module by name.

``run_grid(shape, jobs)`` builds the (data, model) grid of ``shape`` over
the group's ranks and runs each job, a (function name, arguments) pair of
this module, on it. Every job returns global values (gathered shards,
numpy), so a test compares them with the one-device run, which calls the
same functions on a 1 x 1 grid in its own process.
"""

from __future__ import annotations

import numpy as np
import torch

from sea_tpu_torch.parallel import collectives
from sea_tpu_torch.parallel.mesh import (make_mesh, spatial_param_dims,
                                         temporal_param_dims, unshard)
from sea_tpu_torch.parallel.train_step import (
    make_sharded_rollout, make_sharded_spatial_train_step,
    make_sharded_temporal_train_step)
from sea_tpu_torch.train.optim import make_optimizer
from sea_tpu_torch.utils.params import to_numpy


def run_grid(shape, jobs):
    """{name: result} of each job (name -> (function, args)) on the grid
    of ``shape`` (n_data, n_model) over the process group (None: no grid,
    for jobs that build their own, as the CLI does from --mesh)."""
    torch.set_num_threads(1)
    grid = make_mesh(*shape) if shape else None
    return {name: globals()[fn](grid, *args)
            for name, (fn, args) in jobs.items()}


def _mu_dtype(tcfg):
    return (torch.bfloat16 if tcfg.adam_mu_dtype == "bfloat16"
            else torch.float32)


def temporal_steps(grid, cfg, tcfg, params, batch, keys,
                   init_opt_state=None):
    """len(keys) sharded temporal steps from the global ``params`` (numpy)
    on the global ``batch`` (src, tgt, ib): (per-step stats as floats, the
    global params and optimizer state after them, numpy)."""
    tx = make_optimizer(tcfg)
    step, p, o, place = make_sharded_temporal_train_step(
        grid, cfg, tx, params, device="cpu",
        compute_dtype=tcfg.compute_dtype, init_opt_state=init_opt_state,
        mu_dtype=_mu_dtype(tcfg))
    stats = []
    for key in keys:
        p, o, st = step(p, o, *place(*batch), key)
        stats.append({k: float(v) for k, v in st.items()})
    dims = temporal_param_dims(params)
    return (stats, to_numpy(unshard(grid, p, dims)),
            to_numpy(unshard(grid, o, tx.state_dims(dims, params))))


def spatial_step(grid, cfg, tcfg, params, batch, key, iteration,
                 total_steps):
    """One sharded stage-1 step (the variational loss when the config is
    variational): (stats, global params after it)."""
    tx = make_optimizer(tcfg)
    step, p, o, place = make_sharded_spatial_train_step(
        grid, cfg, tx, params, device="cpu",
        compute_dtype=tcfg.compute_dtype,
        kl_weight_min=tcfg.kl_weight_min, kl_weight_max=tcfg.kl_weight_max,
        total_steps=total_steps)
    p, o, st = step(p, o, place(batch), key, iteration)
    return ({k: float(v) for k, v in st.items()},
            to_numpy(unshard(grid, p, spatial_param_dims(params))))


def rollout(grid, cfg, params, x0, ib, cache_dtype):
    """The sharded scan rollout of every trajectory, gathered: [B, T, G,
    E] numpy. ``params``: the global serving tree (numpy)."""
    from sea_tpu_torch.utils.params import from_numpy
    run, placed, place = make_sharded_rollout(
        grid, cfg, from_numpy(params, "cpu"), device="cpu",
        cache_dtype=cache_dtype)
    local = run(placed, *place(x0, ib))
    return collectives.all_gather_cat(local, 0, grid.data_group,
                                      grid.n_data).numpy()


def masks(grid, B, T, E, H, seed, rate):
    """The dropout a rank draws under the grid, gathered to the global
    arrays: the elementwise mask of a [B, T, E] activation, the flash
    kernels' [B, H, T, T] mask for the rank's bh_map, the plain
    attention's [B, H, T, T] mask and the variational noise [B, T, E]."""
    from sea_tpu_torch.ops import attention as A
    from sea_tpu_torch.ops import flash_attention as FA
    from sea_tpu_torch.ops import layers as L
    from sea_tpu_torch.utils import prng
    key = prng.fold_in(prng.prng_key(seed), 1)
    b = B // grid.n_data
    h = H // grid.n_model
    with collectives.sharded(grid):
        elem = L.dropout(torch.ones(b, T, E), rate, key)
        bh = grid.bh_map(b, h, H, "cpu") if grid.size > 1 else None
        flash = FA.dropout_mask(b, h, T, T, prng.key_to_seed(key), rate,
                                "cpu", bh_map=bh)
        # attention_core's probabilities of v = I: the dropped p itself.
        q = torch.zeros(b, T, h, T)
        eye = torch.eye(T).reshape(1, T, 1, T).expand(b, T, h, T)
        plain = A.attention_core(q, q, eye.contiguous(), causal=False,
                                 dropout_rate=rate, dropout_key=key)
        first = grid.data_rank if grid.size > 1 else 0
        noise = prng.normal(key, (b, T, E), device="cpu",
                            offset=first * b * T * E)

    def gather(x, data_dim, model_dim=None):
        x = collectives.all_gather_cat(x, data_dim, grid.data_group,
                                       grid.n_data)
        if model_dim is not None:
            x = collectives.all_gather_cat(x, model_dim, grid.model_group,
                                           grid.n_model)
        return x.numpy()
    return {"elementwise": gather(elem, 0), "flash": gather(flash, 0, 1),
            "plain": gather(plain.permute(0, 2, 1, 3), 0, 1),
            "noise": gather(noise, 0)}


def checkpoint_resume(grid, cfg, tcfg, params, batch, keys, path):
    """One sharded step, its global params and state written by rank 0
    as the one-device npz; then every rank reads the npz back through the
    one-device template, slices its shard and takes a second step:
    (the npz's params and state as read back, the second step's stats and
    params)."""
    from sea_tpu_torch.parallel.multihost import is_primary
    from sea_tpu_torch.utils.checkpoint import (load_full_checkpoint,
                                                save_checkpoint)
    from sea_tpu_torch.utils.params import opt_state_template
    _, p, o = temporal_steps(grid, cfg, tcfg, params, batch, keys[:1])
    if is_primary():
        save_checkpoint(*path, p, opt_state=o, meta={"epoch": 1})
    if torch.distributed.is_initialized():
        torch.distributed.barrier()  # the npz is written
    from sea_tpu_torch.utils.checkpoint import checkpoint_path
    npz = checkpoint_path(*path[:4])
    template = opt_state_template(make_optimizer(tcfg), params)
    rp, ro, _ = load_full_checkpoint(npz, params, template)
    stats, p2, _ = temporal_steps(grid, cfg, tcfg, rp, batch, keys[1:],
                                  init_opt_state=ro)
    return rp, ro, stats, p2


def evaluation(grid, case, params, windows, sparams, mp, scfg):
    """full_autoregressive_evaluation(mesh=grid) of the windows, no
    files: its metrics."""
    from sea_tpu_torch.data.latents import LatentService
    from sea_tpu_torch.train.evaluate import full_autoregressive_evaluation
    from sea_tpu_torch.utils.params import from_numpy
    svc = LatentService(scfg, from_numpy(sparams, "cpu"), device="cpu")
    res = full_autoregressive_evaluation(
        from_numpy(params, "cpu"), case, windows, svc, mp,
        save_artifacts=False, mesh=grid if grid.size > 1 else None)
    return {k: np.asarray(v) for k, v in res.items()}


def cli(grid, argv, stub_plots=True):
    """sea_tpu_torch.cli.main(argv) on this rank (its grid comes from
    --mesh; ``grid`` is unused): its metrics, when it returns any."""
    from sea_tpu_torch import cli as torch_cli
    if stub_plots:
        from sea_tpu_torch.utils import plotting
        for name in ("plot_all_fields_2d", "plot_all_fields_3d",
                     "plot_rollout_error"):
            setattr(plotting, name, lambda *a, **k: None)
    out = torch_cli.main(argv)
    if isinstance(out, dict) and "decoded_rel_mse" in out:
        return {k: float(out[k]) for k in ("encoded_rel_mse",
                                           "decoded_rel_mse")}
    return None


def cli_printed(grid, argv):
    """What sea_tpu_torch.cli.main(argv) prints on this rank (rank 0
    prints; the others run silent), plots stubbed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        cli(grid, argv)
    return buf.getvalue()


def run_seq(jobs):
    """{name: result} of each job on the seq ring over every rank of the
    process group (``make_seq_mesh``)."""
    from sea_tpu_torch.parallel.mesh import make_seq_mesh
    torch.set_num_threads(1)
    grid = make_seq_mesh()
    return {name: globals()[fn](grid, *args)
            for name, (fn, args) in jobs.items()}


def run_pipe(shape, jobs):
    """{name: result} of each job on the (data, pipe) grid of ``shape``
    (n_data, n_pipe) over the process group."""
    from sea_tpu_torch.parallel.pipeline import make_pipe_mesh
    torch.set_num_threads(1)
    grid = make_pipe_mesh(shape[1], shape[0])
    return {name: globals()[fn](grid, *args)
            for name, (fn, args) in jobs.items()}


def ring(grid, q, k, v, g, kw):
    """Ring attention of the global numpy [B, T, H, hd] q, k, v on this
    rank's time block, and its backward of the cotangent g: (out, dq, dk,
    dv), each gathered to the global [B, T, H, hd] (numpy)."""
    from sea_tpu_torch.parallel.mesh import shard_seq
    from sea_tpu_torch.parallel.ring_attention import ring_attention
    qb, kb, vb = (torch.from_numpy(np.ascontiguousarray(
        shard_seq(grid, a))).requires_grad_(True) for a in (q, k, v))
    out = ring_attention(qb, kb, vb, grid, **kw)
    out.backward(torch.from_numpy(np.ascontiguousarray(shard_seq(grid, g))))
    return tuple(collectives.all_gather_cat(x.detach(), 1, grid.seq_group,
                                            grid.n_seq).numpy()
                 for x in (out, qb.grad, kb.grad, vb.grad))


def seq_steps(grid, cfg, tcfg, params, batch, keys):
    """len(keys) sequence-parallel temporal steps from the global
    ``params`` (numpy) on the global ``batch``: (per-step stats as
    floats, params and optimizer state after them, numpy)."""
    from sea_tpu_torch.parallel.train_step import \
        make_seq_parallel_train_step
    tx = make_optimizer(tcfg)
    step, p, o, place = make_seq_parallel_train_step(
        grid, cfg, tx, params, device="cpu",
        compute_dtype=tcfg.compute_dtype, mu_dtype=_mu_dtype(tcfg))
    stats = []
    for key in keys:
        p, o, st = step(p, o, *place(*batch), key)
        stats.append({k: float(v) for k, v in st.items()})
    return stats, to_numpy(p), to_numpy(o)


def pipe_forward(grid, cfg, params, x, ib, n_microbatches, key):
    """``pipeline_forward`` of the global numpy batch (deterministic when
    key is None): the global output, numpy."""
    from sea_tpu_torch.parallel.pipeline import (pipeline_forward,
                                                 stage_params)
    from sea_tpu_torch.utils.params import from_numpy
    stage = from_numpy(stage_params(grid, params, cfg.num_layers), "cpu")
    return pipeline_forward(
        stage, cfg, torch.from_numpy(x), torch.from_numpy(ib), grid=grid,
        n_microbatches=n_microbatches, rng=key,
        deterministic=key is None).numpy()


def pipe_steps(grid, cfg, tcfg, params, batch, keys, n_microbatches,
               plain_attention=False):
    """len(keys) pipeline-parallel temporal steps: (per-step stats, the
    one-device params after them, and the one-device AdamW mu).
    ``plain_attention``: the model's attentions take the plain path,
    whose dropout hashes the flat index of the probabilities as the JAX
    package's XLA attention does (its pipeline cannot host the Pallas
    kernels: a pallas_call inside its shard_map is refused)."""
    import functools

    from sea_tpu_torch.models import temporal as TT
    from sea_tpu_torch.ops.attention import mha
    from sea_tpu_torch.parallel.pipeline import (gather_params,
                                                 make_pipeline_train_step)
    if plain_attention:
        TT.mha = functools.partial(mha, impl="plain")
    tx = make_optimizer(tcfg)
    step, p, o, place = make_pipeline_train_step(
        grid, cfg, tx, params, device="cpu", n_microbatches=n_microbatches,
        compute_dtype=tcfg.compute_dtype)
    stats = []
    for key in keys:
        p, o, st = step(p, o, *place(*batch), key)
        stats.append({k: float(v) for k, v in st.items()})
    adam = (o.inner if hasattr(o, "inner") else o)[0]
    return (stats, to_numpy(gather_params(grid, p, cfg.num_layers)),
            to_numpy(gather_params(grid, adam.mu, cfg.num_layers)))
