"""End-to-end rollout evaluation and generation on the device.

Counterpart of ``sea_tpu/rollout/e2e.py``: scan rollout (KV caches) ->
latent layout shuttle -> frozen stage-1 decode -> device-side un-patch ->
inverse min-max scale -> per-(time, field) relative MSE against the ground
truth. Nothing returns to the host between the initial latent state and
the metric tensors. ``make_eval_tail`` is the part after the rollout, which
the prefix engine's serving path (train/evaluate.py) runs after its own
rollout; ``make_generate`` is the scan rollout and the decode without a
ground truth, at any horizon.
"""

from __future__ import annotations

import numpy as np
import torch

from sea_tpu_torch.configs.base import SpatialModelConfig, TemporalModelConfig
from sea_tpu_torch.data.partitioner import PartitionIndex, unpatchify_torch
from sea_tpu_torch.models.spatial import spatial_decode
from sea_tpu_torch.rollout.engine import is_scan_incremental, rollout_scan
from sea_tpu_torch.train import metrics as M


def _require_incremental(tcfg: TemporalModelConfig, what: str, why: str):
    if not is_scan_incremental(tcfg):
        raise ValueError(
            f"{what} requires a scan-incremental config (no attention "
            f"ib-conditioning, src_len == 0){why}")


def make_e2e_rollout_eval(tcfg: TemporalModelConfig,
                          scfg: SpatialModelConfig, part: PartitionIndex, *,
                          sea_layout: str = "isolate", scalers=None,
                          field_groups=None, cache_dtype=torch.float32):
    """Returns fn(tparams, sparams, x0, ib, truth, tgt_lat) ->
    (decoded fields [B,T,N,F], rel-MSE [B,T,F], encoded rel-MSE scalar).

    x0: [B, G, E]; ib: [B, T, ib_num]; truth: [B, T, N, F] node fields
    aligned with the predictions; tgt_lat: [B, T, G, E] latent targets.
    cache_dtype: the rollout's KV-cache storage (f32, bf16 or int8)."""
    _require_incremental(
        tcfg, "make_e2e_rollout_eval",
        "; train.evaluate.fused_autoregressive_evaluation serves the "
        "others on the masked prefix engine")
    tail = make_eval_tail(scfg, part, sea_layout=sea_layout, scalers=scalers,
                          field_groups=field_groups)

    @torch.inference_mode()
    def run(tparams, sparams, x0, ib, truth, tgt_lat):
        preds = rollout_scan(tparams, tcfg, x0, ib, cache_dtype=cache_dtype)
        return tail(sparams, preds, truth, tgt_lat)

    return run


def make_eval_tail(scfg: SpatialModelConfig, part: PartitionIndex, *,
                   sea_layout: str = "isolate", scalers=None,
                   field_groups=None):
    """fn(sparams, preds [B,T,G,E], truth [B,T,N,F], tgt_lat [B,T,G,E]) ->
    (decoded fields, rel-MSE per (B, T, F), encoded rel-MSE scalar): the
    fused evaluation after its rollout, and the prefix engine's serving
    path after its own."""
    decode = make_decode_chain(scfg, part, sea_layout=sea_layout,
                               scalers=scalers, field_groups=field_groups)

    def tail(sparams, preds, truth, tgt_lat):
        enc_rel = torch.mean(M.relative_mse(preds.float(), tgt_lat))
        fields = decode(sparams, preds)
        rel = M.relative_mse_with_time(fields, truth, axis=2)
        return fields, rel, enc_rel

    return tail


def make_decode_chain(scfg: SpatialModelConfig, part: PartitionIndex, *,
                      sea_layout: str = "isolate", scalers=None,
                      field_groups=None):
    """fn(sparams, preds [B,T,G,E]) -> fields [B,T,N,F]: layout shuttle,
    frozen decode, un-patch, then the inverse min-max scale as per-field
    affine constants orig = scaled * a + b (identity without scalers)."""
    P, C = part.num_patches, part.cells_per_patch
    D, G = scfg.embed_dim, scfg.num_groups
    a = np.ones((scfg.num_fields,), np.float32)
    b = np.zeros((scfg.num_fields,), np.float32)
    for scaler, group in zip(scalers or (), field_groups or ()):
        lo, hi = scaler.feature_range
        af = (scaler.max_val - scaler.min_val) / (hi - lo)
        for f in group:
            a[f] = af
            b[f] = scaler.min_val - lo * af

    def decode(sparams, preds):
        B, T = preds.shape[:2]
        lat = preds.reshape(B * T, G, P, D).transpose(1, 2)
        dec = spatial_decode(sparams, scfg, lat)  # [B*T, P, F, C]
        if sea_layout == "isolate":
            dec = dec.transpose(2, 3)  # -> [B*T, P, C, F]
        else:  # mixed
            dec = dec.reshape(B * T, P, C, dec.shape[2])
        fields = unpatchify_torch(part, dec).reshape(B, T, part.num_nodes,
                                                     -1)
        return (fields.float() * torch.from_numpy(a).to(fields.device)
                + torch.from_numpy(b).to(fields.device))

    return decode


def make_generate(tcfg: TemporalModelConfig, scfg: SpatialModelConfig,
                  part: PartitionIndex, *, sea_layout: str = "isolate",
                  scalers=None, field_groups=None,
                  cache_dtype=torch.float32):
    """Surrogate simulation: fn(tparams, sparams, x0 [B,G,E], ib
    [B,H,ib_num]) -> fields [B,H,N,F], the scan rollout of H steps decoded,
    un-patched and un-scaled on the device. No ground truth, so H is not
    tied to a dataset window; the KV caches grow linearly in H."""
    _require_incremental(tcfg, "generate",
                         "; prefix-recompute has no horizon-unbounded form")
    decode = make_decode_chain(scfg, part, sea_layout=sea_layout,
                               scalers=scalers, field_groups=field_groups)

    @torch.inference_mode()
    def run(tparams, sparams, x0, ib):
        preds = rollout_scan(tparams, tcfg, x0, ib, cache_dtype=cache_dtype)
        return decode(sparams, preds)

    return run
