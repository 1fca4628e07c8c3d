"""Stage-1 (spatial autoencoder) training loop.

Counterpart of ``sea_tpu/train/train_spatial.py``: ``process_data``
(load, split at snapshot level, patchify, SEA layout, derive n_inp),
``make_train_step`` (the MSE of the dropout forward, or the VAE loss
with its KL weight annealed over the loop's optimizer steps, under the
f32 or a bf16 numerics policy; the optimizer of ``train/optim.py``,
AdamW or Adafactor, the bf16 shadow kept; the gradient and parameter
norms and R^2),
``make_eval_step`` (masked metrics over padded batches) and ``train``,
the epoch loop with validation and the best-validation-reconstruction
checkpoint, written as the npz the JAX loop writes.

The stage-1 model reaches no kernel (its attention over 64 patches is the
plain path, ``models/spatial.py``): the step is PyTorch's GEMMs and
elementwise kernels. Under "bfloat16_shadow" the step differentiates the
f32 masters through the bf16 cast, as the JAX spatial step does (its
shadow is kept and refreshed, never read). ``profile_dir`` traces one
steady-state epoch (``utils.profiling.trace``); ``log_per_tensor``
records a norm per gradient and parameter tensor from each epoch's last
batch. ``mesh`` (a ``parallel.collectives.Grid``) trains data- and
tensor-parallel over the ranks (``parallel.train_step``), as the JAX
loop's mesh: the blocks' attention split over the model ranks, each
batch over the data ranks; evaluation on the gathered params, files and
metrics from rank 0.
Dropout keys and the variational noise come from ``utils.prng`` with the
JAX loop's key sequence.
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from sea_tpu_torch.configs.base import CaseConfig, SpatialModelConfig
from sea_tpu_torch.data.datasets import (apply_sea_layout,
                                         batch_index_iterator,
                                         device_resident_budget,
                                         padded_batch_index_iterator,
                                         split_indices)
from sea_tpu_torch.data.io import load_case_data
from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.models.spatial import init_spatial, spatial_forward
from sea_tpu_torch.parallel.collectives import (all_reduce, data_mean,
                                                sharded, sum_over_data)
from sea_tpu_torch.train import metrics as M
from sea_tpu_torch.train.optim import global_norm, make_optimizer
from sea_tpu_torch.train.tracking import BaseErrorTracker, NoOpErrorTracker
from sea_tpu_torch.utils.checkpoint import save_checkpoint
from sea_tpu_torch.parallel.mesh import spatial_param_dims, unshard
from sea_tpu_torch.parallel.multihost import is_primary
from sea_tpu_torch.parallel.train_step import make_sharded_spatial_train_step
from sea_tpu_torch.utils.params import (from_numpy, opt_state_from_numpy,
                                        to_numpy, tree_leaves, tree_paths)
from sea_tpu_torch.utils.precision import train_cast
from sea_tpu_torch.utils.profiling import trace
from sea_tpu_torch.utils.prng import prng_key, split


@dataclasses.dataclass
class SpatialData:
    train: np.ndarray  # [B, P, F, C]
    val: np.ndarray
    test: np.ndarray
    mesh_processor: MeshProcessor
    spatial_cfg: SpatialModelConfig  # with n_inp derived


def process_data(case: CaseConfig, *, data=None) -> SpatialData:
    """``data``: (fields [tr, T, N, F], coords, ib) arrays, or None to read
    the case's configured paths. Every snapshot of every trajectory is a
    sample; the split is over snapshots."""
    if data is None:
        fields, coords, _ = load_case_data(case.run.field_data_path,
                                           case.run.coordinates_path,
                                           case.run.input_path)
    else:
        fields, coords, _ = data
    tr, T, N, F = fields.shape
    train_idx, val_idx, test_idx = split_indices(
        tr * T, case.spatial_split.train_fraction,
        case.spatial_split.val_fraction, case.spatial_split.random_seed)
    mp = MeshProcessor(case.mesh, case.spatial.field_groups, coords,
                       save_dir=case.run.save_dir)
    _, patched = mp.patchify_and_scale(
        fields.reshape(tr * T, N, F),
        perform_initial_test=case.run.perform_initial_test)
    tokens = apply_sea_layout(patched, case.run.sea_layout)  # [B,P,F,C]
    return SpatialData(train=tokens[train_idx], val=tokens[val_idx],
                       test=tokens[test_idx], mesh_processor=mp,
                       spatial_cfg=case.spatial.with_n_inp(
                           mp.cells_per_patch))


def make_train_step(cfg: SpatialModelConfig, tx, *, kl_weight_min=0.0,
                    kl_weight_max=0.0, total_steps: int = 1,
                    compute_dtype: str = "float32", log_norms: bool = True,
                    per_tensor: bool = False, grid=None, dims=None):
    """step(params, opt_state, batch, key, iteration) -> (params,
    opt_state, stats): the JAX loop's step. ``key`` is a ``utils.prng``
    key, ``iteration`` the host's optimizer-step count (the KL anneal's
    position). The forward runs on cast_p(params) (``train_cast``), so
    the f32 masters take the gradients through the cast under every
    policy; the loss terms are f32 against the f32 batch. Stats: loss,
    recon_loss, kl_loss (0 unless variational), grad_norm and param_norm
    (global norms of the gradients and of the masters before the update;
    zeros with ``log_norms=False``) and r2, 0-d tensors on the device;
    ``per_tensor`` (with log_norms) adds "tensors", ``Grad_Norm/<path>``
    and ``Param_Norm/<path>`` of each tensor, as the JAX step. The
    parameters and the optimizer state are updated IN PLACE.

    ``grid`` and ``dims``: a rank's step of the sharded one
    (``parallel.train_step``), as in ``train_temporal.make_train_step``.
    The global loss is the mean reconstruction error plus the weighted
    KL summed over the batch, so a rank differentiates its block's
    recon / n_data + weight * KL, and the gradients sum over the data
    ranks."""
    cast_p, cast_x = train_cast(compute_dtype)
    n_data = 1 if grid is None else grid.n_data

    def step(params, opt_state, batch, key, iteration: int):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        (x,) = cast_x(batch)
        with sharded(grid):
            out = spatial_forward(cast_p(params), cfg, x, rng=key,
                                  deterministic=False)
        if cfg.variational:
            recon, mu, logvar = out
            loss, recon_loss, kl = M.vloss(
                batch, recon.float(), mu.float(), logvar.float(),
                kl_weight_min=kl_weight_min, kl_weight_max=kl_weight_max,
                iteration=iteration, total_steps=total_steps)
            if n_data > 1:
                loss = recon_loss / n_data + M.kl_anneal_weight(
                    kl_weight_min, kl_weight_max, iteration,
                    total_steps) * kl
        else:
            recon = out
            loss = recon_loss = M.mse(recon.float(), batch)
            kl = torch.zeros((), device=batch.device)
            if n_data > 1:
                loss = loss / n_data
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, torch.autograd.grad(
                     loss, leaves, allow_unused=True))]
        grads = sum_over_data(grads, grid)
        with torch.no_grad():
            if n_data > 1:  # the global batch's terms
                loss = all_reduce(loss.detach(), grid.data_group)
                recon_loss = data_mean(recon_loss.detach(), grid)
                kl = all_reduce(kl.detach(), grid.data_group)
            if log_norms:
                norms = {"grad_norm": global_norm(grads, dims, grid),
                         "param_norm": global_norm(leaves, dims, grid)}
                if per_tensor:
                    norms["tensors"] = {
                        **M.per_tensor_norms(
                            dict(zip(tree_paths(params), grads)),
                            "Grad_Norm/", dims, grid),
                        **M.per_tensor_norms(params, "Param_Norm/", dims,
                                             grid)}
            else:
                zero = torch.zeros((), device=batch.device)
                norms = {"grad_norm": zero, "param_norm": zero}
            stats = {"loss": loss.detach(), "recon_loss": recon_loss.detach(),
                     "kl_loss": kl.detach(), **norms,
                     "r2": M.sharded_r2(recon.detach(), batch, grid)}
            opt_state = tx.step(grads, opt_state, params)
        return params, opt_state, stats
    return step


def make_eval_step(cfg: SpatialModelConfig, *, kl_weight_min=0.0,
                   kl_weight_max=0.0, total_steps: int = 1):
    """step(params, batch, n_valid, iteration) -> masked metrics of the
    deterministic forward over a batch padded to a fixed size."""
    @torch.no_grad()
    def step(params, batch, n_valid: int, iteration: int):
        if cfg.variational:
            recon, mu, logvar = spatial_forward(params, cfg, batch)
            kl_weight = M.kl_anneal_weight(kl_weight_min, kl_weight_max,
                                           iteration, total_steps)
            recon_loss = M.masked_mse(recon, batch, n_valid)
            kl = M.masked_kl(mu, logvar, n_valid)
            total = recon_loss + kl_weight * kl
        else:
            recon = spatial_forward(params, cfg, batch)
            total = recon_loss = M.masked_mse(recon, batch, n_valid)
            kl = torch.zeros((), device=batch.device)
        return {"loss": total, "recon_loss": recon_loss, "kl_loss": kl,
                "r2": M.masked_r2(recon, batch, n_valid)}
    return step


def train(case: CaseConfig,
          error_tracker: Optional[BaseErrorTracker] = None, *, device,
          data=None, seed: int = 0, epochs: Optional[int] = None,
          init_params=None, init_opt_state=None, mesh=None,
          precomputed: Optional[SpatialData] = None,
          profile_dir: Optional[str] = None):
    """Train the stage-1 model of ``case`` on ``device``; returns
    (best-validation-reconstruction params as a numpy tree, SpatialData).

    init_params / init_opt_state: numpy trees in the JAX package's layout
    (a restored checkpoint for resume). Without init_params the weights
    are the port's own init from a torch.Generator seeded with the 64
    bits of the init key: the JAX init's distributions, not its numbers.
    Everything after the init (batch order, keys, the update) follows the
    JAX loop. ``precomputed``: process_data's result, when the caller
    already ran it. ``epochs`` overrides the config's count; the KL
    anneal runs over the optimizer steps of that many epochs.
    ``profile_dir``: a trace of ONE steady-state epoch, epoch min(2,
    epochs), into this directory (CLI: --profile)."""
    tracker = error_tracker or NoOpErrorTracker()
    if mesh is not None and not is_primary():
        tracker = NoOpErrorTracker()  # rank 0 records the run
    tcfg = case.spatial_train
    device = torch.device(device)
    sd = precomputed if precomputed is not None else process_data(
        case, data=data)
    cfg = sd.spatial_cfg

    rng, init_key = split(prng_key(seed))
    if init_params is not None:
        params = from_numpy(init_params, device)
    else:
        gen = torch.Generator().manual_seed((init_key[0] << 32)
                                            | init_key[1])
        params = init_spatial(cfg, gen, device=device)
    tx = make_optimizer(tcfg)
    tracker.log_model(params, "Vloss" if cfg.variational else "MSE",
                      tcfg.optimizer)
    mu_dtype = (torch.bfloat16 if tcfg.adam_mu_dtype == "bfloat16"
                else torch.float32)
    n_epochs = epochs if epochs is not None else tcfg.epoch_num
    batch_size = tcfg.batch_size
    if mesh is not None:
        batch_size = -(-batch_size // mesh.n_data) * mesh.n_data
        if batch_size != tcfg.batch_size:
            print(f"note: batch size {tcfg.batch_size} -> {batch_size} "
                  f"(next multiple of the mesh data axis {mesh.n_data})")
    total_steps = max(1, n_epochs * max(1, len(sd.train) // batch_size))
    kl = dict(kl_weight_min=tcfg.kl_weight_min,
              kl_weight_max=tcfg.kl_weight_max, total_steps=total_steps)
    place_batch = None
    if mesh is not None:
        params_np = to_numpy(params)
        train_step, params, opt_state, place_batch = \
            make_sharded_spatial_train_step(
                mesh, cfg, tx, params_np, device=device,
                compute_dtype=tcfg.compute_dtype,
                init_opt_state=init_opt_state, mu_dtype=mu_dtype,
                log_norms=tcfg.log_norms, per_tensor=tcfg.log_per_tensor,
                **kl)
        dims = spatial_param_dims(params_np)
        opt_dims = tx.state_dims(dims, params_np)
        del params_np
    else:
        opt_state = (opt_state_from_numpy(init_opt_state, device, mu_dtype)
                     if init_opt_state is not None else tx.init(params))
        train_step = make_train_step(
            cfg, tx, compute_dtype=tcfg.compute_dtype,
            log_norms=tcfg.log_norms, per_tensor=tcfg.log_per_tensor, **kl)
    eval_step = make_eval_step(cfg, **kl)

    def global_params():
        """The global params (a mesh rank gathers its shards)."""
        return params if mesh is None else unshard(mesh, params, dims)

    # The splits live on the device when they fit the budget; each step
    # gathers its batch there with the host's index stream. Otherwise each
    # batch is copied from the host: the same batches either way.
    resident = (tcfg.device_resident_data
                and sd.train.nbytes + sd.val.nbytes <= device_resident_budget(
                    tcfg.device_resident_max_bytes, device))
    splits = {}
    for name, arr in (("train", sd.train), ("val", sd.val)):
        splits[name] = torch.from_numpy(np.ascontiguousarray(arr))
        if resident:
            splits[name] = splits[name].to(device)

    def gather(name, idx):
        sel = torch.from_numpy(np.asarray(idx))
        src = splits[name]
        return src.index_select(0, sel.to(src.device)).to(device)

    best_val = float("inf")
    best_params = to_numpy(global_params())
    iteration = 0
    start = time.time()
    for epoch in range(1, n_epochs + 1):
        acc = M.StatsAccumulator()
        last_stats = None
        profiling = profile_dir and epoch == min(2, n_epochs)
        with (trace(profile_dir, name=f"train_epoch{epoch}") if profiling
              else contextlib.nullcontext()):
            for sel in batch_index_iterator(
                    len(sd.train), batch_size, shuffle=True,
                    seed=case.spatial_split.random_seed, epoch=epoch,
                    drop_remainder=True):
                rng, step_key = split(rng)
                batch = (gather("train", sel) if place_batch is None
                         else place_batch(sd.train[sel]))
                params, opt_state, stats = train_step(
                    params, opt_state, batch, step_key, iteration)
                acc.add(stats)
                iteration += 1
                last_stats = stats
            if acc.count == 0:
                raise ValueError(f"train split has fewer than one batch of "
                                 f"{batch_size} snapshots")
            agg = acc.means()  # the epoch's one read from the device
        if profiling:
            print(f"profiler trace (epoch {epoch}) written to {profile_dir}")
        train_metrics = {"Loss": agg["loss"], "Recon_Loss": agg["recon_loss"],
                         "R2": agg["r2"], "Grad_Norm": agg["grad_norm"],
                         "Param_Norm": agg["param_norm"]}
        if cfg.variational:
            train_metrics["KL_Loss"] = agg["kl_loss"]
        tracker.record_error("train", epoch, train_metrics)
        if last_stats is not None and "tensors" in last_stats:
            tracker.record_error("tensors", epoch,
                                 M.read_norms(last_stats["tensors"]))

        if epoch % tcfg.validation_interval == 0 or epoch == n_epochs:
            full = global_params()  # every rank evaluates the global model
            vacc = M.StatsAccumulator()
            for idx, n_valid in padded_batch_index_iterator(len(sd.val),
                                                            batch_size):
                vacc.add(eval_step(full, gather("val", idx), n_valid,
                                   iteration))
            vagg = vacc.means()
            val_metrics = {"Loss": vagg["loss"],
                           "Recon_Loss": vagg["recon_loss"],
                           "R2": vagg["r2"]}
            if cfg.variational:
                val_metrics["KL_Loss"] = vagg["kl_loss"]
            tracker.record_error("val", epoch, val_metrics)
            print(f"Epoch {epoch}/{n_epochs} train Loss "
                  f"{train_metrics['Loss']:.8f} R2 {train_metrics['R2']:.6f}"
                  f" | val Loss {val_metrics['Loss']:.8f}")
            if val_metrics["Recon_Loss"] < best_val:
                best_val = val_metrics["Recon_Loss"]
                best_params = to_numpy(full)
                opt_np = to_numpy(opt_state if mesh is None
                                  else unshard(mesh, opt_state, opt_dims))
                if is_primary():  # one npz, the one-device layout
                    save_checkpoint(
                        case.run.save_dir, "encoder_decoder",
                        case.run.case_name, case.run.run_name, best_params,
                        opt_state=opt_np,
                        meta={"epoch": epoch, "val_loss": best_val})
                    print("--- New Best Model Saved ---")

    print(f"Total training time: {time.time() - start:.2f} seconds")
    tracker.finish()
    return best_params, sd
