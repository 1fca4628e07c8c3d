"""Global seeding helper: counterpart of ``sea_tpu/utils/seeding.py``.

One switch that seeds every host-side RNG a script may touch (python
``random``, numpy, ``PYTHONHASHSEED``) and PyTorch's CPU and CUDA
generators. The drivers draw their dropout keys from ``utils.prng`` and
their inits from explicit ``torch.Generator``s, so they never need it; the
CLI's ``--seed`` calls it, as the JAX CLI does.

Returns ``utils.prng.prng_key(seed)``, the port's ``jax.random.PRNGKey``,
so a caller can thread it onward:

    key = set_seed(42)
"""

from __future__ import annotations

import os
import random

import numpy as np
import torch

from sea_tpu_torch.utils.prng import Key, prng_key


def set_seed(seed: int) -> Key:
    """Seed python ``random``, numpy, PYTHONHASHSEED and torch (CPU and,
    where present, every CUDA device); return ``prng_key(seed)``."""
    random.seed(seed)
    np.random.seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    torch.manual_seed(seed)
    if torch.cuda.is_available():
        torch.cuda.manual_seed_all(seed)
    return prng_key(seed)
