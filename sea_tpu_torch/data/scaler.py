"""Global min-max scaler with persisted state.

Mirror of reference MinMaxScaler (utils/data_processors.py:225-289): scale a
whole tensor to ``feature_range`` using its global min/max, and persist
min/max next to the checkpoints as the JAX package does, as .npz (instead
of torch.save) under ``{save_dir}/{name}_min_max_values.npz``. Both
packages fit the scalers on every run; the rollout evaluation inverts the
scaling on the device from ``min_val``/``max_val``/``feature_range``
(``rollout/e2e.py``).

The reference's MeshProcessor constructs its scalers by passing a config dict
positionally into ``feature_range`` (data_processors.py:476-481) — a bug that
would crash on transform if scaling were ever enabled (it is None in both
shipped configs). We implement scaling correctly instead.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np


class MinMaxScaler:
    def __init__(self, feature_range: Tuple[float, float] = (-1.0, 1.0),
                 name: str = "scaler", save_dir: str = "."):
        self.feature_range = feature_range
        self.min_val: Optional[float] = None
        self.max_val: Optional[float] = None
        self.name = name
        self.save_file = os.path.join(save_dir,
                                      f"{name}_min_max_values.npz")

    def fit(self, data: np.ndarray) -> None:
        self.min_val = float(np.min(data))
        self.max_val = float(np.max(data))
        if self.min_val == self.max_val:
            raise ValueError("Data has zero variance")
        self._record_values()

    def transform(self, data: np.ndarray) -> np.ndarray:
        if self.min_val is None or self.max_val is None:
            raise ValueError("The scaler has not been fitted yet. Call 'fit' "
                             "with training data before 'transform'.")
        lo, hi = self.feature_range
        std = (data - self.min_val) / (self.max_val - self.min_val)
        return std * (hi - lo) + lo

    def inverse_transform(self, scaled: np.ndarray) -> np.ndarray:
        if self.min_val is None or self.max_val is None:
            raise ValueError("The scaler has not been fitted yet.")
        lo, hi = self.feature_range
        std = (scaled - lo) / (hi - lo)
        return std * (self.max_val - self.min_val) + self.min_val

    def _record_values(self) -> None:
        os.makedirs(os.path.dirname(self.save_file) or ".", exist_ok=True)
        np.savez(self.save_file, min_val=self.min_val, max_val=self.max_val,
                 feature_range=np.asarray(self.feature_range))
