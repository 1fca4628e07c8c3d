"""Stage-2 data preparation for serving.

Counterpart of ``process_data`` in ``sea_tpu/train/train_temporal.py``
(the training loop itself is not ported yet; ROADMAP.md): load, split at
trajectory level, patchify, encode with the frozen stage-1 encoder, and
cut the temporal windows. The data, mesh and window code is the JAX
package's own framework-free modules; only the encoder runs here.
"""

from __future__ import annotations

import dataclasses

import torch

from sea_tpu.configs.base import CaseConfig
from sea_tpu.data.datasets import (TemporalWindows, apply_sea_layout,
                                   make_temporal_windows, split_indices)
from sea_tpu.data.io import load_case_data
from sea_tpu.data.mesh import MeshProcessor
from sea_tpu.utils.checkpoint import checkpoint_path, load_params
from sea_tpu_torch.data.latents import (LatentService,
                                        transform_latents_to_temporal)
from sea_tpu_torch.models.spatial import init_spatial
from sea_tpu_torch.utils.params import from_numpy, to_numpy


@dataclasses.dataclass
class TemporalData:
    train: TemporalWindows
    val: TemporalWindows
    test: TemporalWindows
    mesh_processor: MeshProcessor
    latent_service: LatentService


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
        fields.reshape(tr * T, N, F), fit_scalers=True,
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
                        latent_service=svc)
