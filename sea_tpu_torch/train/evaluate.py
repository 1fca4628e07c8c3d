"""Evaluation flows: the rollout evaluations, generation and the stage-1
test.

Counterparts of ``autoregressive_validation``,
``full_autoregressive_evaluation`` (the staged path: rollout on the
device, then decode, un-patch and score through ``LatentService`` and the
mesh processor), ``fused_autoregressive_evaluation`` (rollout, decode,
un-patch and score on the device), ``generate_trajectory`` and
``test_encoder_decoder`` in ``sea_tpu/train/evaluate.py``, with the same
metrics, the same generated fields and the same artifact files: the
rollout CSV, 5 original/decoded field plot pairs and the error-vs-time
plot (``_write_rollout_artifacts``), and the stage-1 test's 5 pairs.
On a ``--mesh`` grid every rank runs these functions and rank 0 alone
writes the files (the JAX package's "primary process" guard).

Documented divergences from the JAX functions:

- ``engine='auto'`` follows the JAX policy (``rollout.engine.
  select_engine``) with the port's constants, measured on an H100: the
  configs that are not incremental take the masked prefix engine, the
  others the scan engine, where the JAX package also sends f32 weights at
  trajectory batch 1 to the prefix engine (a v5e measurement). The two
  engines are equal (tests/test_rollout.py, tests/test_torch_rollout.py),
  so the metrics agree (held to rtol 1e-4 by tests/test_torch_e2e.py).
- The plots need matplotlib, imported only to draw them. Where it does
  not import (the H100 machine the port is measured on has none), the
  writers print one line naming the plots they skip and the missing
  module, and still write the CSV.
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from sea_tpu_torch.configs.base import CaseConfig
from sea_tpu_torch.data.datasets import invert_sea_layout
from sea_tpu_torch.data.latents import (LatentService,
                                        inverse_transform_latents)
from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.parallel.multihost import is_primary
from sea_tpu_torch.rollout.e2e import (make_e2e_rollout_eval,
                                       make_eval_tail, make_generate)
from sea_tpu_torch.rollout.engine import (is_scan_incremental, rollout,
                                          select_engine)
from sea_tpu_torch.train import metrics as M
from sea_tpu_torch.utils import plotting
from sea_tpu_torch.utils.params import tree_leaves


def _to(device, a):
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def autoregressive_validation(params, case: CaseConfig, windows, *,
                              sample: int = 0):
    """Rollout check on ONE window, on the parameters' device: (MSE, mean
    relative MSE over time) of the rolled-out latents against the
    window's targets."""
    device = tree_leaves(params)[0].device
    src = _to(device, windows.src[sample:sample + 1])
    tgt = _to(device, windows.tgt[sample:sample + 1])
    ib = _to(device, windows.ib[sample:sample + 1])
    with torch.inference_mode():
        preds = rollout(params, case.temporal, src[:, 0], ib)
        loss = float(M.mse(preds, tgt))
        rel = float(torch.mean(M.relative_mse_with_time(preds, tgt,
                                                        axis=3)))
    return loss, rel


def full_autoregressive_evaluation(params, case: CaseConfig, windows,
                                   latent_service: LatentService,
                                   mesh_processor: MeshProcessor, *,
                                   spatial_params=None, epoch: int = 0,
                                   plot_traj: bool = True,
                                   save_artifacts: bool = True,
                                   cache_dtype=torch.float32,
                                   mesh=None) -> Dict[str, Any]:
    """windows: TemporalWindows (src, tgt, tgt_original, ib) as numpy.

    The staged evaluation: every window rolls out as one batch on the
    latent service's device (``rollout``, the engine select_engine picks,
    caches of ``cache_dtype`` on scan); the latents come to the host, are
    decoded in batches by the latent service (``spatial_params`` override
    its weights), un-patched and un-scaled, and scored per (time, field).
    Returns {encoded_rel_mse, decoded_rel_mse, decoded_rel_mse_per_time
    [T, F]} averaged over the set; with ``save_artifacts`` writes the
    rollout artifacts, the plots tagged with ``epoch``.

    ``mesh``: a ``parallel.collectives.Grid`` (``parallel.mesh.make_mesh``;
    every rank calls this): the trajectories split over its data ranks
    (padded up to a multiple of the axis by repeating the last, the
    padding trimmed) and the params, the global serving tree, over its
    model ranks (``parallel.train_step.make_sharded_rollout``); the
    rollouts are gathered on every rank, which decodes and scores them,
    and rank 0 writes the files. Scan-incremental configs only; the
    others take the one-device engine, as in the JAX function."""
    if spatial_params is not None:
        latent_service = latent_service.with_params(spatial_params)
    device = latent_service.device
    with torch.inference_mode():
        if mesh is not None and is_scan_incremental(case.temporal):
            preds_dev = _sharded_rollout(mesh, params, case, windows, device,
                                         cache_dtype)
        else:
            x0, ib = _to(device, windows.src[:, 0]), _to(device, windows.ib)
            preds_dev = rollout(params, case.temporal, x0, ib,
                                cache_dtype=cache_dtype)  # [B, T, G, E]
        encoded_rel_mse = float(torch.mean(M.relative_mse(
            preds_dev, _to(device, windows.tgt))))
    preds = preds_dev.cpu().numpy()
    B, T = preds.shape[:2]

    lat = inverse_transform_latents(preds, case.mesh.num_patches)
    decoded = latent_service.decode_dataset(lat)  # [B*T, P, F, C]
    decoded = invert_sea_layout(decoded, case.run.sea_layout)
    flat = mesh_processor.inverse_scale_and_unpatch(decoded)  # [B*T, N, F]
    decoded_fields = flat.reshape(B, T, *flat.shape[1:])
    original = np.asarray(windows.tgt_original)  # [B, T, N, F]
    rel = M.relative_mse_with_time(torch.from_numpy(decoded_fields),
                                   torch.from_numpy(original)).numpy()
    per_time = rel.mean(axis=0)  # [T, F]
    if save_artifacts and is_primary():
        _write_rollout_artifacts(case, mesh_processor, per_time, original,
                                 decoded_fields, epoch=epoch,
                                 plot_traj=plot_traj)
    return {"encoded_rel_mse": encoded_rel_mse,
            "decoded_rel_mse": float(per_time.mean()),
            "decoded_rel_mse_per_time": per_time}


def _sharded_rollout(grid, params, case, windows, device, cache_dtype):
    """Every window's rollout [B, T, G, E] on every rank of ``grid``: each
    rank rolls out its block of trajectories on its shards, then the
    blocks are gathered over the data ranks."""
    from sea_tpu_torch.parallel.collectives import all_gather_cat
    from sea_tpu_torch.parallel.train_step import make_sharded_rollout
    run, placed, place = make_sharded_rollout(grid, case.temporal, params,
                                              device=device,
                                              cache_dtype=cache_dtype)
    x0, ib = np.asarray(windows.src[:, 0]), np.asarray(windows.ib)
    B = x0.shape[0]
    pad = (-B) % grid.n_data
    if pad:  # repeat the last trajectory; trimmed below
        x0 = np.concatenate([x0, np.repeat(x0[-1:], pad, 0)], axis=0)
        ib = np.concatenate([ib, np.repeat(ib[-1:], pad, 0)], axis=0)
    local = run(placed, *place(x0, ib))
    return all_gather_cat(local, 0, grid.data_group, grid.n_data)[:B]


def _plot_or_skip(names, what: str) -> bool:
    """True where matplotlib imports; else prints the one skip line
    naming the plots ``names`` and the missing module."""
    missing = plotting.matplotlib_missing()
    if missing is not None:
        print(f"{what}: {missing} is not installed, so the plots "
              f"{', '.join(names)} were not drawn")
    return missing is None


def _write_rollout_artifacts(case: CaseConfig, mesh_processor, per_time,
                             original, decoded_fields, *, epoch: int,
                             plot_traj: bool) -> None:
    """The JAX package's rollout artifacts in ``case.run.save_dir``: the
    per-time CSV [T, F], the original and decoded fields [B, T, N, F] of
    trajectory 0 at 5
    timesteps drawn by ``RandomState(case.temporal_split.random_seed)``
    (``temporal_{original,decoded}_data_{t}_{epoch}.png``) and, with
    ``plot_traj``, the error-vs-time plot."""
    T = original.shape[1]
    save_dir, run = case.run.save_dir, case.run
    os.makedirs(save_dir, exist_ok=True)
    csv_path = os.path.join(
        save_dir, f"rollout_error_{run.case_name}_{run.run_name}.csv")
    with open(csv_path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["Time Step"] + [f"Field {i+1}"
                                         for i in range(per_time.shape[1])])
        for i, row in enumerate(per_time):
            writer.writerow([i + 1] + list(row))
    rng = np.random.RandomState(case.temporal_split.random_seed)
    sample_idx = rng.choice(T, min(5, T), replace=False)
    fields = {f"temporal_{kind}_data_{idx}_{epoch}.png": (data[0], int(idx))
              for idx in sample_idx
              for kind, data in (("original", original),
                                 ("decoded", decoded_fields))}
    error_plot = f"rollout_error_{run.case_name}_{run.run_name}.png"
    names = list(fields) + ([error_plot] if plot_traj else [])
    if not _plot_or_skip(names, f"rollout artifacts (wrote {csv_path})"):
        return
    _plot_fields(case, mesh_processor, fields)
    if plot_traj:
        plotting.plot_rollout_error(per_time,
                                    os.path.join(save_dir, error_plot))


def _plot_fields(case: CaseConfig, mesh_processor, fields) -> None:
    """{file name: (snapshots [T, N, F], t)}: all fields at t, drawn in
    case.run.save_dir at the mesh's coordinates."""
    c = mesh_processor.coordinates
    for name, (data, idx) in fields.items():
        path = os.path.join(case.run.save_dir, name)
        if case.mesh.dimension == "2D":
            plotting.plot_all_fields_2d(data, c[:, 0], c[:, 1], idx,
                                        filename=path)
        else:
            plotting.plot_all_fields_3d(data, c[:, 0], c[:, 1], c[:, 2],
                                        idx, filename=path)


def fused_autoregressive_evaluation(params, case: CaseConfig, windows,
                                    latent_service: LatentService,
                                    mesh_processor: MeshProcessor, *,
                                    spatial_params=None, epoch: int = 0,
                                    plot_traj: bool = True,
                                    save_artifacts: bool = True,
                                    cache_dtype=torch.float32,
                                    engine: str = "auto"
                                    ) -> Dict[str, Any]:
    """windows: TemporalWindows (src, tgt, tgt_original, ib) as numpy; all
    windows roll out as one batch on the latent service's device.
    ``spatial_params`` (default: the latent service's weights) decode: the
    CLI passes the reduced-precision stage-1 weights of ``--precision``
    there.

    engine: 'auto' (``select_engine``), 'scan' (KV caches of
    ``cache_dtype``; the fused rollout evaluation) or 'prefix' (the
    bucketed prefix engine, then the same decode-and-score tail). Under
    'auto' a cache dtype other than f32 asks for the KV-cache engine:
    an incremental config then takes scan, as in the JAX function.

    Returns {encoded_rel_mse, decoded_rel_mse, decoded_rel_mse_per_time
    [T, F]} averaged over the set, and the engine that served the rollout
    ("scan" or "prefix"); with ``save_artifacts``, writes the artifacts of
    full_autoregressive_evaluation (``_write_rollout_artifacts``)."""
    device = latent_service.device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    sparams = (latent_service.params if spatial_params is None
               else spatial_params)
    x0, ib = dev(windows.src[:, 0]), dev(windows.ib)
    truth, tgt_lat = dev(windows.tgt_original), dev(windows.tgt)
    if engine == "auto":
        engine = select_engine(case.temporal, x0.shape[0], ib.shape[1],
                               params)
        if engine == "prefix" and cache_dtype != torch.float32:
            if is_scan_incremental(case.temporal):
                print(f"cache_dtype={cache_dtype}: scan engine forced (the "
                      "prefix engine has no KV cache)")
                engine = "scan"
            else:
                print(f"cache_dtype={cache_dtype} ignored: non-incremental "
                      "config serves on the prefix engine, which has no KV "
                      "cache")
    kw = dict(sea_layout=case.run.sea_layout, scalers=mesh_processor.scalers,
              field_groups=mesh_processor.field_groups)
    if engine == "scan":
        run = make_e2e_rollout_eval(case.temporal, latent_service.cfg,
                                    mesh_processor.partition,
                                    cache_dtype=cache_dtype, **kw)
        fields, rel, enc_rel = run(params, sparams, x0, ib, truth, tgt_lat)
    else:
        preds = rollout(params, case.temporal, x0, ib, engine=engine)
        tail = make_eval_tail(latent_service.cfg, mesh_processor.partition,
                              **kw)
        with torch.inference_mode():
            fields, rel, enc_rel = tail(sparams, preds, truth, tgt_lat)
    per_time = rel.cpu().numpy().mean(axis=0)  # [T, F]
    if save_artifacts:  # the plots draw trajectory 0 only
        _write_rollout_artifacts(case, mesh_processor, per_time,
                                 np.asarray(windows.tgt_original[:1]),
                                 fields[:1].cpu().numpy(), epoch=epoch,
                                 plot_traj=plot_traj)
    return {"encoded_rel_mse": float(enc_rel),
            "decoded_rel_mse": float(per_time.mean()),
            "decoded_rel_mse_per_time": per_time, "engine": engine}


def generate_trajectory(params, case: CaseConfig, windows,
                        latent_service: LatentService,
                        mesh_processor: MeshProcessor, *,
                        trajectory: int = 0, horizon: Optional[int] = None,
                        spatial_params=None,
                        cache_dtype=torch.float32) -> np.ndarray:
    """Surrogate simulation from test window ``trajectory``: its initial
    latent state rolled ``horizon`` steps (default: the window's length)
    on the scan engine and decoded to physical fields [H, N, F] on the
    device (``rollout.e2e.make_generate``). Past the window the ib
    conditioning holds its last value: the shipped cases condition on
    per-trajectory constants."""
    n = len(windows.src)
    if not 0 <= trajectory < n:
        raise ValueError(f"trajectory index {trajectory} out of range "
                         f"(the test split has {n} windows)")
    gen = make_generate(
        case.temporal, latent_service.cfg, mesh_processor.partition,
        sea_layout=case.run.sea_layout, scalers=mesh_processor.scalers,
        field_groups=mesh_processor.field_groups, cache_dtype=cache_dtype)
    sparams = (latent_service.params if spatial_params is None
               else spatial_params)
    device = latent_service.device
    x0 = torch.from_numpy(np.ascontiguousarray(
        windows.src[trajectory, :1])).to(device)  # [1, G, E]
    ib = np.asarray(windows.ib[trajectory])  # [T, ib_num]
    H = horizon if horizon is not None else ib.shape[0]
    ib_h = ib[:H] if H <= ib.shape[0] else np.concatenate(
        [ib, np.repeat(ib[-1:], H - ib.shape[0], axis=0)], axis=0)
    fields = gen(params, sparams, x0,
                 torch.from_numpy(np.ascontiguousarray(ib_h[None])).to(
                     device))
    return fields[0].cpu().numpy()  # [H, N, F]


def test_encoder_decoder(spatial_params, case: CaseConfig, tokens,
                         mesh_processor: MeshProcessor, *, device,
                         save_artifacts: bool = True,
                         spatial_cfg=None) -> Dict[str, float]:
    """Autoencode the test snapshots ``tokens`` [B, P, F, C] (SEA layout
    applied) with the stage-1 params (a tree of tensors) on ``device``,
    print and return the reconstruction MSE before un-patching
    ("mse_patched"), after inverse scaling and un-patching
    ("mse_unpatched"), and the relative MSE over nodes, averaged over
    snapshots and fields ("relative_mse"). ``save_artifacts``: the
    original and decoded fields of 5 snapshots drawn by
    ``RandomState(case.spatial_split.random_seed)``
    (``{original,decoded}_data_{i}.png`` in case.run.save_dir)."""
    svc = LatentService(spatial_cfg or case.spatial, spatial_params,
                        batch_size=case.run.spatial_batch_size, device=device)
    recon = svc.decode_dataset(svc.encode_dataset(tokens))
    pre_unpatch_mse = float(np.mean((recon - tokens) ** 2))
    decoded = mesh_processor.inverse_scale_and_unpatch(
        invert_sea_layout(recon, case.run.sea_layout))
    original = mesh_processor.inverse_scale_and_unpatch(
        invert_sea_layout(np.asarray(tokens), case.run.sea_layout))
    post_unpatch_mse = float(np.mean((decoded - original) ** 2))
    rel = float(M.relative_mse(torch.from_numpy(decoded),
                               torch.from_numpy(original), axis=1).mean())
    if save_artifacts:
        os.makedirs(case.run.save_dir, exist_ok=True)
        rng = np.random.RandomState(case.spatial_split.random_seed)
        idx = rng.choice(original.shape[0], min(5, original.shape[0]),
                         replace=False)
        fields = {f"{kind}_data_{i}.png": (data, int(i)) for i in idx
                  for kind, data in (("original", original),
                                     ("decoded", decoded))}
        if _plot_or_skip(list(fields), "stage-1 test artifacts"):
            _plot_fields(case, mesh_processor, fields)
    print(f"Test Loss before inverse scaling and unpatching: "
          f"{pre_unpatch_mse:.6f}")
    print(f"Test Loss after inverse scaling and unpatching: "
          f"{post_unpatch_mse:.6f}")
    print(f"Test Relative MSE after inverse scaling and unpatching: "
          f"{rel:.6f}")
    return {"mse_patched": pre_unpatch_mse, "mse_unpatched": post_unpatch_mse,
            "relative_mse": rel}

