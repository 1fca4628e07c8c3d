"""Tracing and per-step timing: counterpart of
``sea_tpu/utils/profiling.py`` on ``torch.profiler``.

- ``trace(logdir)``: a ``torch.profiler.profile`` over the host and, where
  CUDA is present, the device. On exit it writes a Chrome trace,
  ``{name}.pt.trace.json`` in ``logdir``, which Perfetto opens and
  TensorBoard's PyTorch profiler plugin lists.
- ``annotate(name)``: a named span inside a trace
  (``torch.profiler.record_function``).
- ``StepTimer``: wall-clock per step; the first ``skip`` steps are left
  out of the steady-state summary. The port compiles nothing at its first
  step, but that step still loads the kernels' libraries and warms
  cuBLAS's heuristics, so ``skip=1`` stays the default.
"""

from __future__ import annotations

import contextlib
import os
import socket
import time
from typing import Dict, List, Optional

import torch


@contextlib.contextmanager
def trace(logdir: str, name: Optional[str] = None):
    """Capture a trace of the enclosed work into
    ``{logdir}/{name}.pt.trace.json`` (default name: host_pid, as
    ``torch.profiler.tensorboard_trace_handler`` names its files).
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    name = name or f"{socket.gethostname()}_{os.getpid()}"
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, f"{name}.pt.trace.json"))


def annotate(name: str):
    """Named span inside a trace."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Wall-clock per step; the first ``skip`` steps are excluded from the
    steady-state summary."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self.times: List[float] = []
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        self._t0 = None

    @property
    def steady(self) -> List[float]:
        return self.times[self.skip:] if len(self.times) > self.skip \
            else self.times

    def summary(self) -> Dict[str, float]:
        st = self.steady
        if not st:
            return {"steps": 0}
        total = sum(st)
        return {"steps": len(st), "mean_s": total / len(st),
                "steps_per_sec": len(st) / total,
                "first_step_s": self.times[0] if self.times else 0.0}
