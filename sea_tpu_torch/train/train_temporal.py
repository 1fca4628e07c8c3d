"""Stage-2 (temporal State-Exchange transformer) training driver.

Counterpart of ``sea_tpu/train/train_temporal.py``: ``process_data``
(load, split at trajectory level, patchify, encode with the frozen
stage-1 encoder, cut the temporal windows), ``make_train_step``
(teacher-forced next-step MSE under the f32 or a bf16 numerics policy,
gradients by autograd through the flash and fused AdaLN kernels, the
optimizer of ``train/optim.py``: AdamW or Adafactor, the bf16 shadow),
``make_eval_step`` (f32, on the master parameters) and ``train``, the
epoch loop with validation, the full autoregressive evaluation cadence
and the best-validation and best-rollout checkpoints, written as the same
npz files the JAX driver writes.

The full evaluation calls ``evaluate.fused_autoregressive_evaluation``
(the rollout, decode and scores on the device, as the CLI's `temporal
test` runs them) with the epoch, so it writes the artifacts the JAX loop's
``full_autoregressive_evaluation`` writes: the same metrics and files.
``profile_dir`` traces one steady-state epoch (``utils.profiling.trace``);
``log_per_tensor`` records a norm per gradient and parameter tensor from
each epoch's last batch (the tracker's "tensors" rows).

``mesh`` (a ``parallel.collectives.Grid`` from ``parallel.mesh.
make_mesh``) trains data- and tensor-parallel over the process group's
ranks, as the JAX loop's mesh does: the batch rounded up to a multiple of
the data axis, each rank's step on its block and shards
(``parallel.train_step``), evaluation and checkpoints on the gathered
global params, files and metrics from rank 0 alone. ``seq_mesh`` trains
sequence-parallel (ring attention over the time axis) and ``pipe_mesh``
pipeline-parallel (GPipe over the blocks), likewise from the one-device
params and to one-device checkpoints.
``dataset_time_shifting`` cuts the train windows anew each epoch, from
the JAX loop's seeds.
Dropout keys come from ``utils.prng``, JAX's threefry key functions on the
host, with the JAX driver's key sequence, so a run from the same initial
weights draws the JAX run's dropout masks.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sea_tpu_torch.configs.base import CaseConfig, TemporalModelConfig
from sea_tpu_torch.data.datasets import (TemporalWindows, apply_sea_layout,
                                         batch_index_iterator,
                                         ib_is_time_constant,
                                         make_temporal_windows,
                                         padded_batch_index_iterator,
                                         split_indices)
from sea_tpu_torch.data.io import load_case_data
from sea_tpu_torch.data.latents import (LatentService,
                                        transform_latents_to_temporal)
from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.models.spatial import init_spatial
from sea_tpu_torch.models.temporal import init_temporal, temporal_forward
from sea_tpu_torch.parallel.collectives import (data_mean, sharded,
                                                sum_over_data)
from sea_tpu_torch.parallel.mesh import temporal_param_dims, unshard
from sea_tpu_torch.parallel.multihost import is_primary
from sea_tpu_torch.parallel.pipeline import (gather_params,
                                             make_pipeline_train_step)
from sea_tpu_torch.parallel.train_step import (
    make_seq_parallel_train_step, make_sharded_temporal_train_step)
from sea_tpu_torch.train import metrics as M
from sea_tpu_torch.train.optim import global_norm, make_optimizer
from sea_tpu_torch.train.tracking import BaseErrorTracker, NoOpErrorTracker
from sea_tpu_torch.utils.checkpoint import (checkpoint_path, load_params,
                                            save_checkpoint)
from sea_tpu_torch.utils.params import (from_numpy, opt_state_from_numpy,
                                        to_numpy, tree_leaves, tree_paths)
from sea_tpu_torch.utils.precision import train_cast
from sea_tpu_torch.utils.profiling import trace
from sea_tpu_torch.utils.prng import prng_key, split


@dataclasses.dataclass
class TemporalData:
    train: TemporalWindows
    val: TemporalWindows
    test: TemporalWindows
    mesh_processor: MeshProcessor
    latent_service: LatentService
    # (latents, fields, ib) of the train split's trajectories, from which
    # dataset_time_shifting cuts each epoch's windows anew.
    train_raw: tuple = None


def process_data(case: CaseConfig, *, device,
                 data=None) -> TemporalData:
    """``data``: (fields, coords, ib) arrays, or None to read the case's
    configured paths. The frozen encoder is the case's encoder_decoder
    checkpoint in its save_dir, run on ``device``."""
    if data is None:
        fields, coords, ib = load_case_data(case.run.field_data_path,
                                            case.run.coordinates_path,
                                            case.run.input_path)
    else:
        fields, coords, ib = data
    if ib is None:
        raise ValueError("the temporal model requires input/boundary data")
    tr, T, N, F = fields.shape

    train_idx, val_idx, test_idx = split_indices(
        tr, case.temporal_split.train_fraction,
        case.temporal_split.val_fraction, case.temporal_split.random_seed)

    mp = MeshProcessor(case.mesh, case.spatial.field_groups, coords,
                       save_dir=case.run.save_dir)
    _, patched = mp.patchify_and_scale(
        fields.reshape(tr * T, N, F),
        perform_initial_test=case.run.perform_initial_test)
    tokens = apply_sea_layout(patched, case.run.sea_layout)  # [tr*T,P,F,C]

    scfg = case.spatial.with_n_inp(mp.cells_per_patch)
    template = to_numpy(init_spatial(scfg, torch.Generator().manual_seed(0),
                                     device="cpu"))
    path = checkpoint_path(case.run.save_dir, "encoder_decoder",
                           case.run.case_name, case.run.run_name)
    spatial_params = from_numpy(load_params(path, template), device)
    svc = LatentService(scfg, spatial_params,
                        batch_size=case.run.spatial_batch_size, device=device)

    latents = svc.encode_dataset(tokens)  # [tr*T, P, G, D]
    temporal_tokens = transform_latents_to_temporal(
        latents, tr, T, mp.num_patches, scfg.num_groups)  # [tr,T,G,P*D]

    tcfg = case.temporal_train

    def windows(idx):
        return make_temporal_windows(temporal_tokens[idx], fields[idx],
                                     ib[idx], tcfg.dataset_src_len,
                                     tcfg.dataset_overlap)

    return TemporalData(train=windows(train_idx), val=windows(val_idx),
                        test=windows(test_idx), mesh_processor=mp,
                        latent_service=svc,
                        train_raw=(temporal_tokens[train_idx],
                                   fields[train_idx], ib[train_idx]))


def make_train_step(cfg: TemporalModelConfig, tx, *,
                    compute_dtype: str = "float32", log_norms: bool = True,
                    per_tensor: bool = False, grid=None, dims=None):
    """step(params, opt_state, src, tgt, ib, key) -> (params, opt_state,
    stats): the JAX driver's step. The loss is the MSE, in f32, of the
    dropout forward (``key`` a ``utils.prng`` key) under the numerics
    policy ``compute_dtype`` (``utils.precision.train_cast``): the batch
    cast by cast_x; "bfloat16" and "bfloat16_mixed" cast the f32 master
    parameters inside the loss, so the gradients reach them through the
    cast; "bfloat16_shadow" differentiates the bf16 shadow in the
    optimizer state (``train.optim.with_bf16_shadow``), whose update
    widens those bf16 gradients. ``grad_norm`` and ``param_norm`` are
    optax.global_norm of the gradients (in f32) and of the master
    parameters before the update (zeros with ``log_norms=False``).
    ``per_tensor`` (with log_norms) adds stats["tensors"], the JAX step's
    per-tensor norms: ``Grad_Norm/<path>`` of each gradient (of the
    shadow under "bfloat16_shadow", in f32) and ``Param_Norm/<path>`` of
    each master parameter before the update. The parameters and the
    optimizer state are updated IN PLACE (train/optim.py); the returned
    stats are 0-d tensors on the device, not read back.

    ``grid`` (``parallel.collectives.Grid``) and ``dims`` (each leaf's
    split axis, ``parallel.mesh``): a rank's step of the sharded one
    (``parallel.train_step``). The forward runs on the rank's batch block
    and shards; the gradient of the global mean loss is the sum over the
    data ranks of each block's loss / n_data; loss and norms are the
    global batch's and the global leaves'. A seq grid
    (``parallel.mesh.make_seq_mesh``) splits the time axis instead: the
    params replicated, each rank's loss over its time block / n_seq, the
    gradients summed over the seq ranks."""
    cast_p, cast_x = train_cast(compute_dtype)
    shadow = compute_dtype == "bfloat16_shadow"
    n_data = 1 if grid is None else grid.n_data * grid.n_seq

    def step(params, opt_state, src, tgt, ib, key):
        wrt = opt_state.shadow if shadow else params
        leaves = tree_leaves(wrt)
        for leaf in leaves:
            leaf.requires_grad_(True)
        s, i = cast_x(src, ib)
        with sharded(grid):
            out = temporal_forward(wrt if shadow else cast_p(params), cfg,
                                   s, i, rng=key, deterministic=False)
        loss = M.mse(out.float(), tgt)
        # Parameters the forward never reads (the unused ln_exp[i][1]
        # norms and the diagonal of the cross-attention lattice) get zero
        # gradients, as under jax.grad.
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss / n_data if n_data > 1 else loss, leaves,
                     allow_unused=True))]
        grads = sum_over_data(grads, grid)
        with torch.no_grad():
            loss = data_mean(loss.detach(), grid)
            if log_norms:
                norms = {"grad_norm": global_norm(grads, dims, grid),
                         "param_norm": global_norm(tree_leaves(params),
                                                   dims, grid)}
                if per_tensor:
                    norms["tensors"] = {
                        **M.per_tensor_norms(
                            dict(zip(tree_paths(wrt), grads)), "Grad_Norm/",
                            dims, grid),
                        **M.per_tensor_norms(params, "Param_Norm/", dims,
                                             grid)}
            else:
                zero = torch.zeros((), device=loss.device)
                norms = {"grad_norm": zero, "param_norm": zero}
            opt_state = tx.step(grads, opt_state, params)
        return params, opt_state, {"loss": loss.detach(), **norms}
    return step


def make_eval_step(cfg: TemporalModelConfig):
    """step(params, src, tgt, ib, n_valid) -> masked MSE of the
    deterministic forward over a batch padded to a fixed size."""
    @torch.no_grad()
    def step(params, src, tgt, ib, n_valid):
        out = temporal_forward(params, cfg, src, ib)
        return M.masked_mse(out, tgt, n_valid)
    return step


def _check_meshes(case: CaseConfig, mesh, seq_mesh, pipe_mesh):
    """The JAX driver's refusals of a mesh, before any work: more than
    one, a window that does not split over the ring, a layer stack that
    does not split over the stages."""
    if sum(m is not None for m in (mesh, seq_mesh, pipe_mesh)) > 1:
        raise ValueError("pass at most one of mesh (DP x TP), seq_mesh "
                         "(sequence-parallel), pipe_mesh (pipeline)")
    tcfg = case.temporal_train
    if seq_mesh is not None and tcfg.dataset_src_len % seq_mesh.n_seq:
        raise ValueError(
            f"sequence-parallel training needs dataset_src_len "
            f"({tcfg.dataset_src_len}) divisible by the ring size "
            f"({seq_mesh.n_seq}); adjust --seq_parallel or the window "
            "length")
    if pipe_mesh is not None and case.temporal.num_layers % pipe_mesh.n_pipe:
        raise ValueError(
            f"pipeline-parallel training needs num_layers "
            f"({case.temporal.num_layers}) divisible by the pipe size "
            f"({pipe_mesh.n_pipe}); the shipped 1-layer presets should "
            "train DP/TP instead")


def train(case: CaseConfig,
          error_tracker: Optional[BaseErrorTracker] = None, *, device,
          data=None, seed: int = 0, epochs: Optional[int] = None,
          init_params=None, init_opt_state=None,
          save_artifacts: bool = True, mesh=None, seq_mesh=None,
          pipe_mesh=None, pipe_microbatches: int = 0,
          profile_dir: Optional[str] = None):
    """Train the temporal model of ``case`` on ``device``; returns
    (best-validation params as a numpy tree, TemporalData).

    init_params / init_opt_state: numpy trees in the JAX package's layout
    (``jax.tree.map(np.asarray, .)`` of its params and of
    ``tx.init(params)``, or a restored checkpoint). Without init_params
    the weights are the port's own init, drawn from a torch.Generator
    seeded with the 64 bits of the init key: the JAX init's
    distributions, not its numbers. Everything after the init — batch
    order, dropout masks, the update — follows the JAX loop.

    ``save_artifacts``: the full evaluations write the rollout CSV and
    plots (``evaluate._write_rollout_artifacts``). ``profile_dir``:
    a trace of ONE steady-state epoch, epoch min(2, epochs), into this
    directory (CLI: --profile).

    ``seq_mesh`` (``parallel.mesh.make_seq_mesh``): the time axis over the
    ring of ranks (``parallel.train_step.make_seq_parallel_train_step``).
    ``pipe_mesh`` (``parallel.pipeline.make_pipe_mesh``): the blocks over
    the stages, ``pipe_microbatches`` per step (default the stage count),
    the batch over the data replicas (``parallel.pipeline.
    make_pipeline_train_step``); a resume restores the params only.
    Either way evaluation and checkpoints see the one-device layout, and
    rank 0 records and writes."""
    tracker = error_tracker or NoOpErrorTracker()
    tcfg = case.temporal_train
    _check_meshes(case, mesh, seq_mesh, pipe_mesh)
    device = torch.device(device)
    td = process_data(case, data=data, device=device)
    cfg = case.temporal
    # Time-constant conditioning, detected from the data (never guessed):
    # the ib-only sites compute on [B, 1] rows and the fused AdaLN kernels
    # take the [B, 1, E] cond, as in the JAX driver (the seq and pipe
    # steps leave it off).
    if not cfg.ib_time_constant and cfg.ln_type == "adaln" \
            and ib_is_time_constant(td.train, td.val, td.test):
        cfg = dataclasses.replace(cfg, ib_time_constant=True)
        print("ib constant over time in every split: conditioning "
              "computed per trajectory and broadcast (ib_time_constant)")

    rng, init_key = split(prng_key(seed))
    if init_params is not None:
        params = from_numpy(init_params, device)
    else:
        gen = torch.Generator().manual_seed((init_key[0] << 32)
                                            | init_key[1])
        params = init_temporal(cfg, gen, device=device)
    tx = make_optimizer(tcfg)
    sharded_run = any(m is not None for m in (mesh, seq_mesh, pipe_mesh))
    if sharded_run and not is_primary():
        tracker = NoOpErrorTracker()  # rank 0 records the run
    tracker.log_model(params, "MSE", tcfg.optimizer)
    mu_dtype = (torch.bfloat16 if tcfg.adam_mu_dtype == "bfloat16"
                else torch.float32)
    batch_size = tcfg.batch_size
    place_batch = None
    if mesh is not None:
        n_data = mesh.n_data
        batch_size = -(-batch_size // n_data) * n_data
        if batch_size != tcfg.batch_size:
            print(f"note: batch size {tcfg.batch_size} -> {batch_size} "
                  f"(next multiple of the mesh data axis {n_data})")
        params_np = to_numpy(params)
        train_step, params, opt_state, place_batch = \
            make_sharded_temporal_train_step(
                mesh, cfg, tx, params_np, device=device,
                compute_dtype=tcfg.compute_dtype,
                init_opt_state=init_opt_state, mu_dtype=mu_dtype,
                log_norms=tcfg.log_norms, per_tensor=tcfg.log_per_tensor)
        dims = temporal_param_dims(params_np)
        opt_dims = tx.state_dims(dims, params_np)
        del params_np
    elif pipe_mesh is not None:
        mb = pipe_microbatches or pipe_mesh.n_pipe
        q = mb * pipe_mesh.n_data
        batch_size = -(-batch_size // q) * q
        if batch_size != tcfg.batch_size:
            print(f"note: batch size {tcfg.batch_size} -> {batch_size} "
                  f"(next multiple of microbatches x data axis = {q})")
        if init_opt_state is not None:
            print("note: pipeline-parallel resume restores params only "
                  "(optimizer restarts fresh — PP checkpoints don't carry "
                  "stacked-layout moments)")
        train_step, params, opt_state, place_batch = \
            make_pipeline_train_step(pipe_mesh, cfg, tx, to_numpy(params),
                                     device=device, n_microbatches=mb,
                                     compute_dtype=tcfg.compute_dtype,
                                     log_norms=tcfg.log_norms,
                                     per_tensor=tcfg.log_per_tensor)
    elif seq_mesh is not None:
        train_step, params, opt_state, place_batch = \
            make_seq_parallel_train_step(
                seq_mesh, cfg, tx, to_numpy(params), device=device,
                compute_dtype=tcfg.compute_dtype,
                init_opt_state=init_opt_state, mu_dtype=mu_dtype,
                log_norms=tcfg.log_norms, per_tensor=tcfg.log_per_tensor)
    else:
        opt_state = (opt_state_from_numpy(init_opt_state, device, mu_dtype)
                     if init_opt_state is not None else tx.init(params))
        train_step = make_train_step(cfg, tx,
                                     compute_dtype=tcfg.compute_dtype,
                                     log_norms=tcfg.log_norms,
                                     per_tensor=tcfg.log_per_tensor)
    eval_step = make_eval_step(cfg)

    def global_params():
        """The global params (a mesh rank gathers its shards, a stage
        every stage's blocks)."""
        if pipe_mesh is not None:
            return gather_params(pipe_mesh, params, cfg.num_layers)
        return params if mesh is None else unshard(mesh, params, dims)

    def global_opt_state():
        """The one-device optimizer state; None under a pipeline (its
        state is per stage and a resume restarts it)."""
        if pipe_mesh is not None:
            return None
        return (opt_state if mesh is None
                else unshard(mesh, opt_state, opt_dims))

    n_epochs = epochs if epochs is not None else tcfg.epoch_num
    best_val = float("inf")
    best_rollout = float("inf")
    best_params = to_numpy(global_params())
    start = time.time()

    # The validation split and, while its windows stay fixed, the train
    # split live on the device; each step gathers its batch there with the
    # host's index stream. With dataset_time_shifting the train windows
    # are cut anew each epoch on the host, as in the JAX driver, and each
    # batch is copied to the device.
    def resident(w: TemporalWindows):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                     for a in (w.src, w.tgt, w.ib))

    def gather(arrays, idx):
        sel = torch.from_numpy(np.asarray(idx)).to(device)
        return tuple(a.index_select(0, sel) for a in arrays)

    # Under a mesh each rank takes its block of the host's batch.
    train_split = (None if tcfg.dataset_time_shifting or sharded_run
                   else resident(td.train))
    val_split = resident(td.val)

    for epoch in range(1, n_epochs + 1):
        train_windows = td.train
        if tcfg.dataset_time_shifting:
            shift_rng = np.random.RandomState(
                (case.temporal_split.random_seed * 7919 + epoch) % (2**31))
            train_windows = make_temporal_windows(
                *td.train_raw, tcfg.dataset_src_len, tcfg.dataset_overlap,
                time_shift_rng=shift_rng)
        acc = M.StatsAccumulator()
        last_stats = None
        profiling = profile_dir and epoch == min(2, n_epochs)
        with (trace(profile_dir, name=f"train_epoch{epoch}") if profiling
              else contextlib.nullcontext()):
            for sel in batch_index_iterator(
                    len(train_windows.src), batch_size, shuffle=True,
                    seed=case.temporal_split.random_seed, epoch=epoch,
                    drop_remainder=True):
                rng, step_key = split(rng)
                if place_batch is not None:
                    src, tgt, ib = place_batch(train_windows.src[sel],
                                               train_windows.tgt[sel],
                                               train_windows.ib[sel])
                elif train_split is None:
                    src, tgt, ib = (torch.from_numpy(np.ascontiguousarray(
                        a[sel])).to(device) for a in (train_windows.src,
                                                      train_windows.tgt,
                                                      train_windows.ib))
                else:
                    src, tgt, ib = gather(train_split, sel)
                params, opt_state, stats = train_step(params, opt_state,
                                                      src, tgt, ib, step_key)
                acc.add(stats)
                last_stats = stats
            if acc.count == 0:
                raise ValueError(
                    f"train split has fewer than one batch of {batch_size} "
                    f"windows" + (" (batch was rounded up for the device "
                                  "mesh; use a smaller --mesh data axis or "
                                  "more data)" if mesh is not None else ""))
            agg = acc.means()  # the epoch's one read from the device
        if profiling:
            print(f"profiler trace (epoch {epoch}) written to {profile_dir}")
        train_loss = agg["loss"]
        tracker.record_error("train", epoch, {
            "Loss": train_loss, "Grad_Norm": agg["grad_norm"],
            "Param_Norm": agg["param_norm"]})
        if last_stats is not None and "tensors" in last_stats:
            # One norm per gradient and parameter tensor of the epoch's
            # last batch, read in one transfer.
            tracker.record_error("tensors", epoch,
                                 M.read_norms(last_stats["tensors"]))

        if epoch % tcfg.validation_interval == 0 or epoch == n_epochs:
            full = global_params()  # every rank evaluates the global model
            vacc = M.StatsAccumulator()
            for idx, n_valid in padded_batch_index_iterator(
                    len(td.val.src), tcfg.eval_batch_size):
                src, tgt, ib = gather(val_split, idx)
                vacc.add(eval_step(full, src, tgt, ib, n_valid))
            val_loss = vacc.means().get("loss", 0.0)
            val_metrics = {"Loss": val_loss}

            if epoch % tcfg.full_eval_interval == 0:
                from sea_tpu_torch.train.evaluate import \
                    fused_autoregressive_evaluation
                results = fused_autoregressive_evaluation(
                    full, case, td.val, td.latent_service,
                    td.mesh_processor, epoch=epoch,
                    save_artifacts=save_artifacts and is_primary())
                val_metrics["Full_Encoded_Rel_MSE"] = \
                    results["encoded_rel_mse"]
                val_metrics["Full_Decoded_Rel_MSE"] = \
                    results["decoded_rel_mse"]
                if results["decoded_rel_mse"] < best_rollout:
                    best_rollout = results["decoded_rel_mse"]
                    if is_primary():
                        save_checkpoint(
                            case.run.save_dir, "temporal_Checkpoint",
                            case.run.case_name, case.run.run_name,
                            to_numpy(full),
                            meta={"epoch": epoch,
                                  "decoded_rel_mse": best_rollout})
                        print("--- Checkpoint Model Saved ---")

            tracker.record_error("val", epoch, val_metrics)
            print(f"Epoch {epoch}/{n_epochs} train Loss {train_loss:.8f} | "
                  f"val Loss {val_loss:.8f}")

            if val_loss < best_val:
                best_val = val_loss
                best_params = to_numpy(full)
                # A mesh gathers the state on every rank; rank 0 writes
                # the one-device npz.
                opt = global_opt_state()
                opt_np = None if opt is None else to_numpy(opt)
                if is_primary():
                    save_checkpoint(
                        case.run.save_dir, "temporal", case.run.case_name,
                        case.run.run_name, best_params, opt_state=opt_np,
                        meta={"epoch": epoch, "val_loss": best_val})
                    print("--- New Best Model Saved ---")

    print(f"Total training time: {time.time() - start:.2f} seconds")
    tracker.finish()
    return best_params, td
