"""Calibration tools: chirp generation, C/No estimation, EOO BER (a numpy
copy of `radae_tpu/tools/chirp.py`).

- chirp: triangle-sweep complex chirp for OTA level calibration
  (reference: chirp.py:1-67)
- est_CNo: C/No from a chirp via windowed FFT, signal band 400-2000 Hz vs
  adjacent noise band, peak search over time (reference: est_CNo.py)
- eoo_ber: frame-by-frame EOO BER vs stored tx bits (reference: eoo_ber.py)
"""

from __future__ import annotations

import argparse
import sys

import numpy as np


def gen_chirp(Fs=8000, T=4.0, f1=400.0, f2=2000.0, amp=0.25):
    """Triangle-sweep complex chirp: f1 -> f2 -> f1, length T seconds."""
    n = int(Fs * T)
    t = np.arange(n) / Fs
    half = T / 2
    # instantaneous frequency: up then down
    finst = np.where(t < half,
                     f1 + (f2 - f1) * t / half,
                     f2 - (f2 - f1) * (t - half) / half)
    phase = 2 * np.pi * np.cumsum(finst) / Fs
    return (amp * np.exp(1j * phase)).astype(np.complex64)


def chirp_main(argv=None):
    p = argparse.ArgumentParser(description="write a calibration chirp IQ.f32")
    p.add_argument("out", type=str)
    p.add_argument("--secs", type=float, default=4.0)
    p.add_argument("--amp", type=float, default=0.25)
    args = p.parse_args(argv)
    gen_chirp(T=args.secs, amp=args.amp).tofile(args.out)


def est_CNo(rx, Fs=8000, f_sig=(400, 2000), chirp_secs=4.0, verbose=False):
    """Estimate C/No of a chirp in noise (reference: est_CNo.py).

    Two stages: (1) locate the chirp by sliding a chirp-length span over
    per-window in-band energies and maximising the total (a long-average
    localiser, so the pick has negligible selection bias, unlike a
    max-over-short-windows search which reads ~1.5 dB high); (2) one C/No
    estimate over that span — in-band power minus the noise-band baseline,
    averaged through any fading.

    With a length-N DFT, mean power = sum|X|^2 / N^2 (Parseval) and the
    noise PSD is mean_noise|X|^2 / (N * Fs); the Hann window scaling
    cancels in the C/No ratio.  Returns (CNo_dBHz, chirp_start_seconds)."""
    Nw = 1024
    nwin = len(rx) // Nw
    if nwin == 0:
        return -np.inf, 0.0
    f = np.fft.fftfreq(Nw, 1 / Fs)
    sig_band = (f >= f_sig[0]) & (f <= f_sig[1])
    noise_band = (f > f_sig[1] + 200) & (f < f_sig[1] + 800)
    n_sig = int(sig_band.sum())
    win = np.hanning(Nw)
    S = np.empty(nwin)
    mu = np.empty(nwin)
    for i in range(nwin):
        X = np.abs(np.fft.fft(rx[i * Nw:(i + 1) * Nw] * win)) ** 2
        mu[i] = X[noise_band].mean()
        S[i] = X[sig_band].sum() - n_sig * mu[i]  # noise-corrected signal
    span = max(1, min(nwin, int(round(chirp_secs * Fs / Nw))))
    # slide the span: cumulative sums -> O(nwin) search
    cS = np.concatenate([[0.0], np.cumsum(S)])
    cmu = np.concatenate([[0.0], np.cumsum(mu)])
    spanS = cS[span:] - cS[:-span]
    start = int(np.argmax(spanS))
    S_tot = spanS[start]
    mu_tot = cmu[start + span] - cmu[start]
    if S_tot <= 0 or mu_tot <= 0:
        return -np.inf, 0.0
    CNo = 10 * np.log10((Fs / Nw) * S_tot / mu_tot)
    best_t = start * Nw / Fs
    if verbose:
        print(f"C/No: {CNo:5.2f} dBHz at t: {best_t:5.2f} s")
    return CNo, best_t


def est_CNo_main(argv=None):
    p = argparse.ArgumentParser(description="C/No estimate from chirp IQ.f32")
    p.add_argument("rx", type=str)
    p.add_argument("--chirp-secs", type=float, default=4.0,
                   help="tx chirp length the averaging span must match "
                        "(a longer span dilutes C with non-chirp windows)")
    args = p.parse_args(argv)
    rx = np.fromfile(args.rx, np.complex64)
    CNo, t = est_CNo(rx, chirp_secs=args.chirp_secs, verbose=False)
    print(f"C/No (dBHz): {CNo:5.2f} time: {t:5.2f}")


def eoo_ber_main(argv=None):
    """Frame-by-frame EOO BER; PASS if any frame < 5% (reference: eoo_ber.py)."""
    p = argparse.ArgumentParser()
    p.add_argument("tx_bits", type=str)
    p.add_argument("rx_bits", type=str)
    args = p.parse_args(argv)
    tx = np.fromfile(args.tx_bits, np.float32)
    rx = np.fromfile(args.rx_bits, np.float32)
    nbits = len(tx)
    nframes = len(rx) // nbits
    ok = False
    for f in range(nframes):
        errs = int(np.sum(rx[f * nbits:(f + 1) * nbits] * tx < 0))
        ber = errs / nbits
        print(f"frame: {f} n_errors: {errs} BER: {ber:5.3f}")
        if ber < 0.05:
            ok = True
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1
