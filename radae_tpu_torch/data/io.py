"""Flat-binary feature files (the part of `radae_tpu/data/io.py` the port uses).

Features are little-endian f32, 36 floats per 10 ms frame, of which the
first 20 are used (reference: inference.py:93-97).
"""

from __future__ import annotations

import numpy as np

NB_TOTAL_FEATURES = 36
NUM_USED_FEATURES = 20


def read_f32(path, cols: int | None = None) -> np.ndarray:
    x = np.fromfile(path, dtype=np.float32)
    if cols is not None:
        x = x.reshape(-1, cols)
    return x
