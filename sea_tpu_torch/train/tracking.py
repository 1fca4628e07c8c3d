"""Metric tracking / observability.

Mirror of reference utils/train_utils.py:50-110: an ErrorTracker ABC with
``record_error(phase, epoch, metrics)`` / ``log_model`` / ``finish``, a
wandb implementation that degrades gracefully to no-op on any failure, and a
no-op. Adds a CSV tracker (the reference only has wandb-or-nothing) so every
run leaves a greppable artifact; metric names keep the reference's
``{phase}/{Key}`` convention (train/Loss, val/Full_Decoded_Rel_MSE, ...).
"""

from __future__ import annotations

import csv
import os
from abc import ABC, abstractmethod
from typing import Any, Dict, Optional


class BaseErrorTracker(ABC):
    @abstractmethod
    def record_error(self, phase: str, epoch: int,
                     metrics: Dict[str, Any]) -> None: ...

    def log_model(self, model=None, criterion=None, optimizer=None) -> None:
        pass

    def finish(self) -> None:
        pass


class NoOpErrorTracker(BaseErrorTracker):
    def __init__(self, *args, **kwargs):
        pass

    def record_error(self, phase, epoch, metrics):
        pass


class CSVErrorTracker(BaseErrorTracker):
    """Appends one row per record_error call to {save_dir}/{run_name}_metrics.csv."""

    def __init__(self, save_dir: str, run_name: str):
        os.makedirs(save_dir, exist_ok=True)
        self.path = os.path.join(save_dir, f"{run_name}_metrics.csv")
        self._fh = open(self.path, "a", newline="")
        self._writer = csv.writer(self._fh)
        if self._fh.tell() == 0:
            self._writer.writerow(["phase", "epoch", "metric", "value"])

    def record_error(self, phase, epoch, metrics):
        for key, value in metrics.items():
            self._writer.writerow([phase, epoch, key, float(value)])
        self._fh.flush()

    def finish(self):
        self._fh.close()


class WandbErrorTracker(BaseErrorTracker):
    def __init__(self, project_name: str, run_name: Optional[str] = None,
                 config=None):
        import wandb
        self.wandb = wandb
        self.run = wandb.init(project=project_name, name=run_name,
                              config=config)

    def record_error(self, phase, epoch, metrics):
        log = {"epoch": epoch}
        for key, value in metrics.items():
            log[f"{phase}/{key}"] = value
        self.wandb.log(log)

    def log_model(self, model=None, criterion=None, optimizer=None) -> None:
        """wandb.watch equivalent (reference utils/train_utils.py:75-76).

        The port's model is a functional parameter tree, not an
        nn.Module to hook, so this records the model's static description
        (total param count, per-tensor count, criterion/optimizer names)
        to the run config once; the gradient/parameter norm STREAM that
        wandb.watch would produce flows through record_error instead
        (TrainConfig.log_per_tensor -> train steps' per-tensor
        Grad_Norm/* and Param_Norm/* metrics, metrics.per_tensor_norms).
        """
        info = {}
        if model is not None:
            import numpy as np
            from sea_tpu_torch.utils.params import tree_leaves
            leaves = [l for l in tree_leaves(model)
                      if hasattr(l, "shape")]
            info["model/num_tensors"] = len(leaves)
            info["model/num_params"] = int(sum(
                int(np.prod(l.shape)) for l in leaves))
        if criterion is not None:
            info["model/criterion"] = str(criterion)
        if optimizer is not None:
            info["model/optimizer"] = (
                optimizer if isinstance(optimizer, str)
                else getattr(optimizer, "name", None)
                or type(optimizer).__name__)
        if info:
            self.run.config.update(info, allow_val_change=True)

    def finish(self):
        self.wandb.finish()


class MultiTracker(BaseErrorTracker):
    def __init__(self, *trackers: BaseErrorTracker):
        self.trackers = trackers

    def record_error(self, phase, epoch, metrics):
        for t in self.trackers:
            t.record_error(phase, epoch, metrics)

    def log_model(self, model=None, criterion=None, optimizer=None):
        for t in self.trackers:
            t.log_model(model, criterion, optimizer)

    def finish(self):
        for t in self.trackers:
            t.finish()


def create_error_tracker(use_wandb: bool, project_name: str,
                         run_name: Optional[str] = None, config=None, *,
                         save_dir: Optional[str] = None) -> BaseErrorTracker:
    """Factory (train_utils.py:94-110): any wandb failure -> graceful no-op.
    Always includes the CSV tracker when a save_dir is given."""
    trackers = []
    if save_dir is not None:
        trackers.append(CSVErrorTracker(save_dir, run_name or "run"))
    if use_wandb:
        try:
            trackers.append(WandbErrorTracker(project_name, run_name, config))
        except Exception as e:  # noqa: BLE001 — parity with reference
            print(f"Error initializing Wandb: {e}. Using fallback tracking.")
    if not trackers:
        return NoOpErrorTracker()
    if len(trackers) == 1:
        return trackers[0]
    return MultiTracker(*trackers)
