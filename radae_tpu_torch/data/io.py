"""Flat-binary files (the part of `radae_tpu/data/io.py` the port uses).

Features are little-endian f32, 36 floats per 10 ms frame, of which the
first 20 are used (reference: inference.py:93-97); modem samples are
complex64, interleaved ..IQIQ.. f32 at Fs = 8 kHz (reference: rx.py:48).
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


def write_f32(path, x: np.ndarray):
    np.asarray(x, dtype=np.float32).flatten().tofile(path)
