"""Streaming complex band-pass filter (a copy of `radae_tpu/dsp/bpf.py`,
which the port may not import: numpy only, the same code).

Mix to baseband, sinc low-pass FIR, mix back up — with carried filter memory
and oscillator phase so chunked streaming equals whole-file filtering
(reference: radae/dsp.py:39-102).  Host-side numpy: the filter runs on short
real-time audio buffers where kernel-launch latency would dominate.
"""

from __future__ import annotations

import numpy as np


class ComplexBPF:
    def __init__(self, Ntap: int, Fs_Hz: float, bandwidth_Hz: float,
                 centre_freq_Hz: float, max_len: int):
        self.Ntap = Ntap
        B = bandwidth_Hz / Fs_Hz
        self.alpha = 2 * np.pi * centre_freq_Hz / Fs_Hz

        # real low-pass prototype of bandwidth B/2 (windowless sinc)
        n = np.arange(Ntap) - (Ntap - 1) / 2
        self.h = (B * np.sinc(n * B)).astype(np.complex64)
        assert np.allclose(self.h, self.h[::-1])   # symmetric: no time flip

        self.mem = np.zeros(Ntap - 1, np.complex64)
        self.n = max_len
        self.phase = np.complex64(1 + 0j)
        self.phase_vec_exp = np.exp(
            -1j * self.alpha * np.arange(1, max_len + 1)).astype(np.complex64)

    def bpf(self, x: np.ndarray) -> np.ndarray:
        n = len(x)
        assert n <= self.n

        phase_vec = self.phase * self.phase_vec_exp[:n]
        x_bb = x * phase_vec

        ext = np.concatenate([self.mem, x_bb])
        # filtered[i] = sum_k ext[i+k] h[k]  == 'valid' correlation
        y = np.convolve(ext, self.h[::-1], mode="valid").astype(np.complex64)

        self.mem = ext[-(self.Ntap - 1):]
        self.phase = phase_vec[-1]
        return (y * np.conj(phase_vec)).astype(np.complex64)


def bpf_self_test(plot_en: bool = False) -> bool:
    """-ve frequency image of a real cosine must be rejected by >40 dB, and
    chunked filtering must equal whole-file filtering
    (reference: dsp.py:104-149)."""
    Ntap, Fs, bw, fc = 101, 8000, 800, 1000

    def rejection(rx_bpf):
        w = np.hanning(len(rx_bpf))
        spec = np.abs(np.fft.fft(rx_bpf * w)) ** 2
        pos, neg = spec[:Fs // 2].sum(), spec[Fs // 2:].sum()
        return 10 * np.log10(pos / neg)

    rx = np.cos(2 * np.pi * fc * np.arange(Fs) / Fs)

    f1 = ComplexBPF(Ntap, Fs, bw, fc, Fs)
    whole = f1.bpf(rx)
    ok1 = rejection(whole[Ntap - 1:]) > 40.0

    f2 = ComplexBPF(Ntap, Fs, bw, fc, Fs)
    Nmf = 960
    chunked = np.concatenate([f2.bpf(rx[i:i + Nmf])
                              for i in range(0, (len(rx) // Nmf) * Nmf, Nmf)])
    ok2 = rejection(chunked[Ntap - 1:]) > 40.0
    ok3 = np.allclose(whole[:len(chunked)], chunked, atol=1e-5)
    return bool(ok1 and ok2 and ok3)
