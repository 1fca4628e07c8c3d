"""Frozen stage-1 latent service.

Counterpart of ``sea_tpu/data/latents.py``: run the frozen spatial encoder
(or decoder) over a dataset in batches. Batches keep one static size, the
last one padded with zeros and trimmed, as on the TPU, so every call sees
the same shapes.
"""

from __future__ import annotations

import numpy as np
import torch

from sea_tpu_torch.configs.base import SpatialModelConfig
from sea_tpu_torch.models.spatial import (apply_padding_mask, spatial_decode,
                                          spatial_encode)


class LatentService:
    def __init__(self, cfg: SpatialModelConfig, params, *, device,
                 batch_size: int = 1000):
        if cfg.n_inp is None:
            raise ValueError("LatentService needs a config with n_inp set")
        self.cfg = cfg
        self.params = params
        self.batch_size = batch_size
        self.device = torch.device(device)

    def _encode(self, x):
        z = spatial_encode(self.params, self.cfg, apply_padding_mask(x))
        # Variational models serve the deterministic latent z = mu.
        return z[0] if self.cfg.variational else z

    def _decode(self, z):
        return spatial_decode(self.params, self.cfg, z)

    @torch.inference_mode()
    def _batched(self, fn, data: np.ndarray) -> np.ndarray:
        n = data.shape[0]
        bs = min(self.batch_size, n)
        outs = []
        for start in range(0, n, bs):
            chunk = data[start:start + bs]
            pad = bs - chunk.shape[0]
            if pad > 0:
                chunk = np.concatenate(
                    [chunk, np.zeros((pad,) + chunk.shape[1:], chunk.dtype)])
            out = fn(torch.from_numpy(np.ascontiguousarray(chunk))
                     .to(self.device)).cpu().numpy()
            outs.append(out[:out.shape[0] - pad] if pad else out)
        return np.concatenate(outs, axis=0)

    def encode_dataset(self, data: np.ndarray) -> np.ndarray:
        """[B, P, F, C] -> latents [B, P, G, D]."""
        return self._batched(self._encode, data)

    def decode_dataset(self, latents: np.ndarray) -> np.ndarray:
        """[B, P, G, D] -> fields [B, P, F, C]."""
        return self._batched(self._decode, latents)

    def with_params(self, params) -> "LatentService":
        """A copy of this service running other weights (the CLI's
        reduced-precision casts of the stage-1 model)."""
        import copy
        svc = copy.copy(self)
        svc.params = params
        return svc


def transform_latents_to_temporal(latents: np.ndarray, tr: int, T: int,
                                  n_patches: int, num_groups: int
                                  ) -> np.ndarray:
    """[tr*T, P, G, D] -> [tr, T, G, P*D]. A copy of the numpy function in
    sea_tpu.data.latents, which cannot be imported without jax."""
    D = latents.shape[-1]
    x = latents.reshape(tr, T, n_patches, num_groups, D)
    x = x.transpose(0, 1, 3, 2, 4)
    return x.reshape(tr, T, num_groups, n_patches * D)


def inverse_transform_latents(temporal: np.ndarray, n_patches: int
                              ) -> np.ndarray:
    """[tr, T, G, P*D] -> [tr*T, P, G, D], the inverse of
    transform_latents_to_temporal (a copy of the JAX package's numpy
    function)."""
    tr, T, G, E = temporal.shape
    D = E // n_patches
    x = temporal.reshape(tr, T, G, n_patches, D)
    x = x.transpose(0, 1, 3, 2, 4)
    return x.reshape(tr * T, n_patches, G, D)
