"""Flat-binary files matching the reference's inter-process contracts (a
copy of `radae_tpu/data/io.py`, numpy only).

All formats little-endian flat binary (reference SURVEY / L4 pipe formats):
  features: f32, 36 floats per 10 ms frame, first 20 used
            (reference: inference.py:93-97)
  latents z: f32, latent_dim floats per 40 ms step
  modem samples: complex64 as interleaved ..IQIQ.. f32 at Fs = 8 kHz
            (reference: rx.py:48, inference.py:56)
  int16 sample conversion with scaling (reference: f32toint16.py / int16tof32.py)
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


def read_c64(path) -> np.ndarray:
    return np.fromfile(path, dtype=np.complex64)


def write_c64(path, x: np.ndarray):
    np.asarray(x, dtype=np.complex64).flatten().tofile(path)


def features_from_file(path, num_used=NUM_USED_FEATURES) -> np.ndarray:
    """Load a 36-wide feature file, keep the first `num_used` columns.

    Returns (1, T, num_used) float32."""
    feats = read_f32(path, NB_TOTAL_FEATURES)
    return feats[None, :, :num_used].copy()


def features_to_file(path, features: np.ndarray, num_used=NUM_USED_FEATURES):
    """Write features padded back out to the 36-wide layout with zeros
    (reference: inference.py:231-234)."""
    f = np.asarray(features)
    if f.ndim == 3:
        f = f[0]
    T = f.shape[0]
    out = np.zeros((T, NB_TOTAL_FEATURES), dtype=np.float32)
    out[:, :min(num_used, f.shape[1])] = f[:, :num_used]
    out.tofile(path)


def f32_to_int16(x: np.ndarray, scale: float = 8192.0,
                 real: bool = False) -> np.ndarray:
    """Complex/float f32 stream -> int16, with clipping
    (reference: f32toint16.py)."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        x = x.real if real else x.view(np.float32) if x.dtype == np.complex64 \
            else np.stack([x.real, x.imag], -1).reshape(-1)
    y = np.clip(x * scale, -32767, 32767)
    return y.astype(np.int16)


def int16_to_f32(x: np.ndarray, scale: float = 8192.0,
                 zeropad: bool = False) -> np.ndarray:
    """int16 -> f32 stream; zeropad interleaves zeros to turn a real stream
    into IQ with Q=0 (reference: int16tof32.py)."""
    y = np.asarray(x, dtype=np.float32) / scale
    if zeropad:
        out = np.zeros(2 * len(y), dtype=np.float32)
        out[::2] = y
        y = out
    return y
