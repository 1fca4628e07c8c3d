"""Serving evaluation: rollout, decode, un-patch and score on the device.

Counterpart of ``fused_autoregressive_evaluation`` in
``sea_tpu/train/evaluate.py``, with the same metrics and the same rollout
CSV.

Documented divergences from the JAX function:

- The rollout always runs on the scan engine. The JAX ``engine='auto'``
  policy sends f32 weights at trajectory batch 1 to the bucketed prefix
  engine, on the strength of a TPU measurement; tests/test_rollout.py
  proves the two engines equal, so the metrics agree (held to rtol 1e-4
  by tests/test_torch_e2e.py). The prefix engine is not ported yet.
- Only the per-time CSV is written. The field and error plots wait: the
  GPU machine has no matplotlib (ROADMAP.md).
"""

from __future__ import annotations

import csv
import os
from typing import Any, Dict

import numpy as np
import torch

from sea_tpu_torch.configs.base import CaseConfig
from sea_tpu_torch.data.mesh import MeshProcessor
from sea_tpu_torch.data.latents import LatentService
from sea_tpu_torch.rollout.e2e import make_e2e_rollout_eval


def fused_autoregressive_evaluation(params, case: CaseConfig, windows,
                                    latent_service: LatentService,
                                    mesh_processor: MeshProcessor, *,
                                    spatial_params=None,
                                    cache_dtype=torch.float32
                                    ) -> Dict[str, Any]:
    """windows: TemporalWindows (src, tgt, tgt_original, ib) as numpy; all
    windows roll out as one batch on the latent service's device with KV
    caches of ``cache_dtype``. ``spatial_params`` (default: the latent
    service's weights) decode: the CLI passes the reduced-precision
    stage-1 weights of ``--precision`` there.

    Returns {encoded_rel_mse, decoded_rel_mse, decoded_rel_mse_per_time
    [T, F]} averaged over the set, and writes the rollout CSV."""
    device = latent_service.device

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    run = make_e2e_rollout_eval(
        case.temporal, latent_service.cfg, mesh_processor.partition,
        sea_layout=case.run.sea_layout, scalers=mesh_processor.scalers,
        field_groups=mesh_processor.field_groups, cache_dtype=cache_dtype)
    sparams = (latent_service.params if spatial_params is None
               else spatial_params)
    _, rel, enc_rel = run(params, sparams,
                          dev(windows.src[:, 0]),
                          dev(windows.ib), dev(windows.tgt_original),
                          dev(windows.tgt))
    per_time = rel.cpu().numpy().mean(axis=0)  # [T, F]
    _write_rollout_csv(case, per_time)
    return {"encoded_rel_mse": float(enc_rel),
            "decoded_rel_mse": float(per_time.mean()),
            "decoded_rel_mse_per_time": per_time}


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
