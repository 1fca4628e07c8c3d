"""Array file loading.

Mirror of reference load_and_convert (train/train_encoder.py:14-44,
train/train_temporal.py:13-44): load field_data / coordinates / input_data
from .npy or .pt paths. torch is imported lazily only for .pt files.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def load_array(path: str) -> np.ndarray:
    if path.endswith(".npy"):
        return np.load(path)
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    if path.endswith(".pt"):
        import torch
        t = torch.load(path, map_location="cpu")
        return t.numpy() if hasattr(t, "numpy") else np.asarray(t)
    raise ValueError(f"Unsupported file format for {path}. "
                     "Only .npy, .npz and .pt are supported.")


def load_case_data(field_data_path: str, coordinates_path: str,
                   input_path: Optional[str] = None
                   ) -> Tuple[np.ndarray, np.ndarray, Optional[np.ndarray]]:
    """Returns (field_data [tr,T,N,F], coordinates [dim,N]|[N,dim],
    input_data [tr,T,ib] or None)."""
    fields = np.asarray(load_array(field_data_path), dtype=np.float32)
    coords = np.asarray(load_array(coordinates_path), dtype=np.float32)
    ib = None
    if input_path:
        ib = np.asarray(load_array(input_path), dtype=np.float32)
    return fields, coords, ib
