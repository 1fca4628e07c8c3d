"""Activation statistics for activation-aware int4 quantization.

Counterpart of ``sea_tpu/utils/calibration.py``. Inside
``capture_activation_stats()`` every call of ``ops.layers.linear`` on an
unquantized 2-D weight reports its input, keyed by the identity of its
param dict; ``resolve(params)`` then maps identities to tree paths on the
SAME params object the forward ran with. Per input channel k it keeps

- ``sq``:   E[x_k^2], the weights of the int4 clip search's error,
- ``mean``: E[x_k], for the bias correction,

which ``utils.precision.quantize_weights_int4(act_stats=...)`` consumes.
The port runs eagerly, so every call records (the JAX package skips
traced calls).
"""

from __future__ import annotations

import contextlib

import torch

from sea_tpu_torch.ops import layers as _layers


class ActivationRecorder:
    """Per-input-channel moments of every 2-D linear an eager forward
    reaches, keyed by param-dict identity until ``resolve``."""

    def __init__(self):
        self._acc = {}  # id(param dict) -> [count, sum_x, sum_x2]

    def record(self, params, x):
        w = params.get("w")
        if not isinstance(w, torch.Tensor) or w.dim() != 2:
            return
        x2 = x.detach().float().reshape(-1, x.shape[-1])
        ent = self._acc.get(id(params))
        if ent is None:
            self._acc[id(params)] = [x2.shape[0], x2.sum(dim=0),
                                     (x2 * x2).sum(dim=0)]
        else:
            ent[0] += x2.shape[0]
            ent[1] = ent[1] + x2.sum(dim=0)
            ent[2] = ent[2] + (x2 * x2).sum(dim=0)

    def resolve(self, params):
        """``{path: {"mean": [K], "sq": [K], "count": n}}`` for every
        recorded linear of ``params`` (the object the forward ran with);
        paths are tuples of dict keys and list indices."""
        out = {}

        def walk(node, path):
            if isinstance(node, dict):
                ent = self._acc.get(id(node))
                if ent is not None:
                    n, sx, sxx = ent
                    out[path] = {"count": n, "mean": sx / n, "sq": sxx / n}
                for k, v in node.items():
                    walk(v, path + (k,))
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, path + (i,))

        walk(params, ())
        return out


@contextlib.contextmanager
def capture_activation_stats():
    """Install the recorder on ``ops.layers.linear``; yields it. Not
    reentrant."""
    if _layers._CALIBRATION is not None:
        raise RuntimeError("activation capture already active")
    rec = ActivationRecorder()
    _layers._CALIBRATION = rec
    try:
        yield rec
    finally:
        _layers._CALIBRATION = None


@torch.inference_mode()
def calibrate_temporal(params, cfg, batches):
    """Activation stats of a TEMPORAL model over ``(data, ib)`` teacher-
    forced batches (data [B, T, G, E], ib [B, T, ib_num]; numpy or
    tensors, moved to the params' device). Returns the resolved ``{path:
    stats}`` for ``quantize_weights_int4(act_stats=...)``."""
    from sea_tpu_torch.models.temporal import temporal_forward
    from sea_tpu_torch.utils.precision import _device_of
    device = _device_of(params)
    with capture_activation_stats() as rec:
        for data, ib in batches:
            temporal_forward(params, cfg, torch.as_tensor(data).to(device),
                             torch.as_tensor(ib).to(device))
    return rec.resolve(params)
