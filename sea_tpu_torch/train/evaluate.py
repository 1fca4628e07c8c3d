"""Serving evaluation and generation: rollout, decode, un-patch (and
score) on the device; and the stage-1 test.

Counterparts of ``fused_autoregressive_evaluation``,
``generate_trajectory`` and ``test_encoder_decoder`` in
``sea_tpu/train/evaluate.py``, with the same metrics, the same rollout
CSV and the same generated fields.

Documented divergences from the JAX functions:

- ``engine='auto'`` follows the JAX policy (``rollout.engine.
  select_engine``) with the port's constants, measured on an H100: the
  configs that are not incremental take the masked prefix engine, the
  others the scan engine, where the JAX package also sends f32 weights at
  trajectory batch 1 to the prefix engine (a v5e measurement). The two
  engines are equal (tests/test_rollout.py, tests/test_torch_rollout.py),
  so the metrics agree (held to rtol 1e-4 by tests/test_torch_e2e.py).
- Only the per-time CSV is written. The field and error plots, and
  the stage-1 test's original and decoded field plots, wait: the GPU
  machine has no matplotlib (ROADMAP.md).
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from sea_tpu_torch.configs.base import CaseConfig
from sea_tpu_torch.data.datasets import invert_sea_layout
from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.data.latents import LatentService
from sea_tpu_torch.rollout.e2e import (make_e2e_rollout_eval,
                                       make_eval_tail, make_generate)
from sea_tpu_torch.rollout.engine import (is_scan_incremental, rollout,
                                          select_engine)
from sea_tpu_torch.train.metrics import relative_mse


def fused_autoregressive_evaluation(params, case: CaseConfig, windows,
                                    latent_service: LatentService,
                                    mesh_processor: MeshProcessor, *,
                                    spatial_params=None,
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
    ("scan" or "prefix"); writes the rollout CSV."""
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
        _, rel, enc_rel = run(params, sparams, x0, ib, truth, tgt_lat)
    else:
        preds = rollout(params, case.temporal, x0, ib, engine=engine)
        tail = make_eval_tail(latent_service.cfg, mesh_processor.partition,
                              **kw)
        with torch.inference_mode():
            _, rel, enc_rel = tail(sparams, preds, truth, tgt_lat)
    per_time = rel.cpu().numpy().mean(axis=0)  # [T, F]
    _write_rollout_csv(case, per_time)
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
                         save_artifacts: bool = False,
                         spatial_cfg=None) -> Dict[str, float]:
    """Autoencode the test snapshots ``tokens`` [B, P, F, C] (SEA layout
    applied) with the stage-1 params (a tree of tensors) on ``device``,
    print and return the reconstruction MSE before un-patching
    ("mse_patched"), after inverse scaling and un-patching
    ("mse_unpatched"), and the relative MSE over nodes, averaged over
    snapshots and fields ("relative_mse"). ``save_artifacts`` (the field
    plots) is not ported."""
    if save_artifacts:
        raise NotImplementedError(
            "save_artifacts: the stage-1 field plots are not ported to "
            "sea_tpu_torch yet (see ROADMAP.md)")
    svc = LatentService(spatial_cfg or case.spatial, spatial_params,
                        batch_size=case.run.spatial_batch_size, device=device)
    recon = svc.decode_dataset(svc.encode_dataset(tokens))
    pre_unpatch_mse = float(np.mean((recon - tokens) ** 2))
    decoded = mesh_processor.inverse_scale_and_unpatch(
        invert_sea_layout(recon, case.run.sea_layout))
    original = mesh_processor.inverse_scale_and_unpatch(
        invert_sea_layout(np.asarray(tokens), case.run.sea_layout))
    post_unpatch_mse = float(np.mean((decoded - original) ** 2))
    rel = float(relative_mse(torch.from_numpy(decoded),
                             torch.from_numpy(original), axis=1).mean())
    print(f"Test Loss before inverse scaling and unpatching: "
          f"{pre_unpatch_mse:.6f}")
    print(f"Test Loss after inverse scaling and unpatching: "
          f"{post_unpatch_mse:.6f}")
    print(f"Test Relative MSE after inverse scaling and unpatching: "
          f"{rel:.6f}")
    return {"mse_patched": pre_unpatch_mse, "mse_unpatched": post_unpatch_mse,
            "relative_mse": rel}


def _write_rollout_csv(case: CaseConfig, per_time: np.ndarray) -> None:
    """The rollout CSV of sea_tpu.train.evaluate._write_rollout_artifacts."""
    os.makedirs(case.run.save_dir, exist_ok=True)
    path = os.path.join(
        case.run.save_dir,
        f"rollout_error_{case.run.case_name}_{case.run.run_name}.csv")
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["Time Step"] + [f"Field {i+1}"
                                         for i in range(per_time.shape[1])])
        for i, row in enumerate(per_time):
            writer.writerow([i + 1] + list(row))
