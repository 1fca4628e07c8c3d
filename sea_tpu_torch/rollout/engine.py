"""Autoregressive rollout engine: the scan engine.

Counterpart of ``sea_tpu/rollout/engine.py::rollout_scan``. The JAX
package compiles the rollout into one ``lax.scan``; here it is a Python
loop over ``models.temporal.temporal_step`` with the KV caches allocated
once and written in place. Each step does O(t) cache work, and the result
equals prefix recompute because every op outside attention is per token,
attention is causal, and RoPE and AdaLN use the absolute position and the
per-token ib (proved for the JAX engines by tests/test_rollout.py, and for
this one against them by tests/test_torch_temporal.py).

The positions live on the device as int32 (``torch.arange(T)``) and each
step passes its slice ``ts[t:t+1]``, so the flash-decode kernel reads the
position on the device and the loop never synchronises on it — a CUDA
graph of the loop needs no kernel change.

Not ported: the prefix engines and ``select_engine`` (its constants are TPU
measurements); see ROADMAP.md. The JAX package's ``select_engine``
sends every reduced-precision serving mode (bf16, int8 or int4 weights)
and every explicit KV-cache dtype to this engine anyway.
"""

from __future__ import annotations

import torch

from sea_tpu_torch.configs.base import TemporalModelConfig
from sea_tpu_torch.models.temporal import (check_supported,
                                           init_temporal_cache,
                                           precompute_cond_tables,
                                           temporal_step)
from sea_tpu_torch.utils.params import tree_map


def is_scan_incremental(cfg: TemporalModelConfig) -> bool:
    """True when the model is incrementally computable: no attention-mode
    ib conditioning (unmasked over the ib stream) and src_len == 0."""
    return cfg.ib_addition_mode != "attention" and cfg.src_len == 0


@torch.inference_mode()
def rollout_scan(params, cfg: TemporalModelConfig, x0, ib, *,
                 cache_dtype=torch.float32):
    """x0: [B, G, E] initial latent state; ib: [B, T, ib_num].

    Returns predictions [B, T, G, E]: prediction k estimates the state at
    time k+1. cache_dtype: the KV caches' storage, torch.float32,
    torch.bfloat16 or torch.int8 (per-token scales). The AdaLN cond
    tables are computed once for the horizon (AdaLN configs only; a
    plain-LN config's only ib-only activation is the small ib
    embedding)."""
    check_supported(cfg)
    B, T = x0.shape[0], ib.shape[1]
    cache = init_temporal_cache(cfg, B, T, dtype=cache_dtype,
                                device=x0.device)
    tables = None
    if cfg.ln_type.lower() == "adaln":
        tables = precompute_cond_tables(params, cfg, ib)
    ts = torch.arange(T, dtype=torch.int32, device=x0.device)
    ys = torch.empty((B, T) + tuple(x0.shape[1:]), dtype=x0.dtype,
                     device=x0.device)
    x_t = x0
    for step in range(T):
        cond_t = (tree_map(lambda a: a[step], tables)
                  if tables is not None else None)
        x_t = temporal_step(params, cfg, x_t, ib[:, step], cache,
                            ts[step:step + 1], cond_t=cond_t)
        ys[:, step] = x_t
    return ys
