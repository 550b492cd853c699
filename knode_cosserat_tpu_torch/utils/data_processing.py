"""Min-max normalization helpers (parity with Utils/data_processing.py:3-50;
unused by the live training path in the reference, kept for API parity).
A copy of the JAX package's module of the same name (it imports no
JAX)."""
from __future__ import annotations

import numpy as np

__all__ = ["normalize_data", "denormalize_data"]


def normalize_data(data: np.ndarray):
    """Normalize to [0, 1] along time (2D) or time+space (3D). Returns
    (normalized, min_vals, range_vals)."""
    data = np.asarray(data)
    axis = (0,) if data.ndim == 2 else (0, 2)
    min_vals = np.min(data, axis=axis, keepdims=True)
    max_vals = np.max(data, axis=axis, keepdims=True)
    range_vals = np.clip(max_vals - min_vals, 1e-10, np.inf)
    return (data - min_vals) / range_vals, min_vals.squeeze(), \
        range_vals.squeeze()


def denormalize_data(normalized, min_vals, range_vals):
    return normalized * range_vals + min_vals
