"""Autoregressive rollout engines and the serving policy that picks one.

Counterpart of ``sea_tpu/rollout/engine.py``.

``rollout_scan``: the JAX package compiles the rollout into one
``lax.scan``; here it is a Python loop over ``models.temporal.temporal_step``
with the KV caches allocated once and written in place. Each step does
O(t) cache work, and the result equals prefix recompute because every op
outside attention is per token, attention is causal, and RoPE and AdaLN
use the absolute position and the per-token ib (proved for the JAX engines
by tests/test_rollout.py, and for this one against them by
tests/test_torch_temporal.py). The positions live on the device as int32
(``torch.arange(T)``) and each step passes its slice ``ts[t:t+1]``, so the
flash-decode kernel reads the position on the device and the loop never
synchronises on it.

``rollout_prefix_bucketed``: step i runs the full forward on the first L
positions of one buffer, L being i+1 rounded up to a multiple of
``bucket``, and writes row i of its output at i+1. The JAX package rounds
L so that it compiles ~T/bucket programs; the port keeps the same
structure, so the two engines run the same forwards on the same shapes.
It is the only exact engine for the configs that are not incremental
(attention-mode ib, src_len != 0): there each forward runs with
``valid_len = i+1``, every attention reading the first i+1 keys alone. On
the card every attention of it is one launch of the f32 flash forward.

``select_engine``: the JAX package's policy with the port's constants,
measured on an H100 (PERF.md, ``chip_smoke.py`` ``[engine-time]``).
"""

from __future__ import annotations

import torch

from sea_tpu_torch.configs.base import TemporalModelConfig
from sea_tpu_torch.models.temporal import (init_temporal_cache,
                                           is_scan_incremental,
                                           precompute_cond_tables,
                                           temporal_forward, temporal_step)
from sea_tpu_torch.utils.params import tree_leaves, tree_map

_NOT_INCREMENTAL = ("engine='scan' requires a scan-incremental config "
                    "(no attention ib-conditioning, src_len == 0)")


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
    if not is_scan_incremental(cfg):
        raise ValueError(_NOT_INCREMENTAL)
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


@torch.inference_mode()
def rollout_prefix_bucketed(params, cfg: TemporalModelConfig, x0, ib, *,
                            bucket: int = 64):
    """x0: [B, G, E]; ib: [B, T, ib_num] -> predictions [B, T, G, E], as
    ``rollout_scan``. Step i runs ``temporal_forward`` on ``buf[:, :L]``
    (L = i+1 rounded up to a multiple of ``bucket``, at most T) and writes
    its row i at buf[:, i+1]. Causal configs run the forward unmasked
    (the rows past i do not reach row i); the others with valid_len =
    i+1, as the JAX package's masked chunk does."""
    masked = not is_scan_incremental(cfg)
    B, T = x0.shape[0], ib.shape[1]
    buf = torch.zeros((B, T + 1) + tuple(x0.shape[1:]), dtype=x0.dtype,
                      device=x0.device)
    buf[:, 0] = x0
    for i in range(T):
        L = min(-(-(i + 1) // bucket) * bucket, T)
        out = temporal_forward(params, cfg, buf[:, :L], ib[:, :L],
                               valid_len=i + 1 if masked else None)
        buf[:, i + 1] = out[:, i]
    return buf[:, 1:]


# select_engine's constants, from chip_smoke.py [engine-time] on one H100
# 80GB HBM3 at 700 W (PERF.md, Findings), f32 weights, both engines in one
# process, two runs: prefix/scan steps/s 0.893 and 0.760 for multiphase
# at B=1 (T=250), 0.912 and 0.917 at B=2, 0.739 and 0.727 for cylinder at
# B=1 (T=399). The prefix engine won no
# cell, and cannot while the scan step is host-bound: a prefix step is a
# full forward with more launches (260.5 device events against 205) and
# 3.7x the device work (2486 against 663 us). So PREFIX_MAX_BATCH = 0:
# auto sends only the configs that are not incremental to the prefix
# engine, where the JAX package's v5e constants (1, 512) also send f32
# B=1 rollouts (ROADMAP.md, Queue 3). PREFIX_MAX_T keeps the JAX bound.
PREFIX_MAX_BATCH = 0
PREFIX_MAX_T = 512


def weights_f32(params) -> bool:
    """True when every leaf is float32: no bf16 cast and no int8/int4
    packing has been applied."""
    return all(leaf.dtype == torch.float32 for leaf in tree_leaves(params))


def select_engine(cfg: TemporalModelConfig, batch: int, horizon: int,
                  params) -> str:
    """'scan' or 'prefix'. A config that is not incremental must take the
    (masked, exact) prefix engine; an incremental one takes scan except
    where the constants above found prefix faster: f32 weights, at most
    PREFIX_MAX_BATCH trajectories, at most PREFIX_MAX_T steps."""
    if not is_scan_incremental(cfg):
        return "prefix"
    if (batch <= PREFIX_MAX_BATCH and horizon <= PREFIX_MAX_T
            and weights_f32(params)):
        return "prefix"
    return "scan"


def rollout(params, cfg: TemporalModelConfig, x0, ib, *,
            cache_dtype=torch.float32, engine: str = "auto"):
    """The serving dispatch the CLI, the evaluation and the training
    loop's rollout evaluation share. engine: 'auto' (``select_engine``),
    'scan' or 'prefix' (bucketed, masked for the configs that are not
    incremental). cache_dtype: the scan engine's KV-cache storage."""
    if engine == "auto":
        engine = select_engine(cfg, x0.shape[0], ib.shape[1], params)
    if engine == "scan":
        if not is_scan_incremental(cfg):
            raise ValueError(_NOT_INCREMENTAL)
        return rollout_scan(params, cfg, x0, ib, cache_dtype=cache_dtype)
    if engine == "prefix":
        return rollout_prefix_bucketed(params, cfg, x0, ib)
    raise ValueError(f"unknown engine {engine!r}")
