"""Root-raised-cosine filter design and sample-clock-offset resampler
(reference: radae/dsp.py:532-575, itself a port of the dsplog.com design).
A copy of `radae_tpu/dsp/rrc.py`: numpy only, the same code."""

from __future__ import annotations

import numpy as np


def gen_rn_coeffs(alpha: float, T: float, Rs: float, Nsym: int, M: int) -> np.ndarray:
    """Root-Nyquist (RRC) filter taps, length Nsym*M."""
    Ts = 1.0 / Rs
    n = np.arange(-Nsym * Ts / 2, Nsym * Ts / 2, T)
    Nfilter = Nsym * M

    sinc_num = np.sin(np.pi * n / Ts)
    sinc_den = np.pi * n / Ts
    sinc = np.ones_like(n)
    nz = np.abs(sinc_den) >= 1e-10
    sinc[nz] = sinc_num[nz] / sinc_den[nz]

    cos_num = np.cos(alpha * np.pi * n / Ts)
    cos_den = 1 - (2 * alpha * n / Ts) ** 2
    cosop = np.full_like(n, np.pi / 4)
    nz = np.abs(cos_den) >= 1e-10
    cosop[nz] = cos_num[nz] / cos_den[nz]

    gt = sinc * cosop
    Nfft = 4096
    GF = np.fft.fft(gt, Nfft) / M

    # sqrt amplifies the stop band; push it back down
    small = np.abs(GF) < 0.02
    GF[small] *= 0.001

    GF_root = np.sqrt(np.abs(GF)) * np.exp(1j * np.angle(GF))
    g = np.fft.ifft(GF_root)
    return g[:Nfilter].real


def sample_clock_offset(tx: np.ndarray, ppm: float) -> np.ndarray:
    """Resample by a ppm clock offset using linear interpolation."""
    n = len(tx)
    step = 1.0 + ppm / 1e6
    tin = np.arange(n) * step
    valid = tin < n - 1
    t1 = np.floor(tin[valid]).astype(int)
    f = tin[valid] - t1
    rx = np.zeros(n, dtype=np.complex64)
    rx[:valid.sum()] = (1 - f) * tx[t1] + f * tx[t1 + 1]
    return rx
