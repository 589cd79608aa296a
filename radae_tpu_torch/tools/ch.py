"""Minimal independent channel tool, equivalent of codec2's `ch` (a copy
of `radae_tpu/tools/ch.py` on the port's `channel/doppler.py`: numpy and
scipy only, the same code, so it runs on the host and takes no --device).

The reference validates its chirp C/No estimator against codec2's `ch`
channel simulator — a *separate* implementation whose C/No report comes
from a time-domain power measurement, breaking the circularity of testing
the spectral estimator against the same channel code that made the signal
(reference: test/chirp_mpp.sh:44-72).  This module reproduces that
contract natively: apply optional two-path Watterson fading, add AWGN of
a requested noise density No, and report the resulting C/No measured from
the *faded time-domain signal power* — deliberately a different
measurement path from tools/chirp.py::est_CNo (windowed spectral bands).

Semantics mirrored from codec2 ch as used by the reference test:
- C is the mean power of the whole input (silence included — callers
  correct for duty cycle, chirp_mpp.sh:52-55)
- noise is added after fading (`--after_fade`)
- `--No` is the noise density in dB/Hz, so sigma^2 = 10^(No/10) * Fs
"""

from __future__ import annotations

import argparse

import numpy as np

from ..channel.doppler import CHANNEL_PRESETS, fade_two_path


def apply_ch(x: np.ndarray, No_dB: float, Fs: float = 8000,
             fading: str | None = None,
             rng: np.random.Generator | None = None):
    """Fade (optional) + AWGN at noise density No_dB.

    Returns (y, CNo_dB): output samples and the internally measured C/No
    (C = mean power of the faded signal over the whole file)."""
    if rng is None:
        rng = np.random.default_rng()
    x = np.asarray(x, np.complex64)
    if fading is not None:
        # unnormalised: C is measured from the faded power below
        x = fade_two_path(x, fading, Fs, rng=rng, normalize=False)
    C = float(np.mean(np.abs(x) ** 2))
    No = 10.0 ** (No_dB / 10.0)
    sigma2 = No * Fs
    noise = np.sqrt(sigma2 / 2) * (rng.standard_normal(len(x))
                                   + 1j * rng.standard_normal(len(x)))
    y = (x + noise).astype(np.complex64)
    CNo_dB_meas = 10.0 * np.log10(C / No) if C > 0 else -np.inf
    return y, CNo_dB_meas


def analog_compressor(pcm: np.ndarray, gain_dB: float = 6.0,
                      Fs: float = 8000.0, clip: float = 16384.0):
    """Hilbert-clipper SSB speech compressor (reference: utils.sh
    analog_compressor, built from codec2 ch's compressor + clipper +
    SSB filter chain).  Band-limit 300-2600 Hz, hard-limit the analytic
    envelope after gain_dB of drive, band-limit again to remove clipping
    splatter.  Input/output: real speech samples at Fs, int16 scale."""
    from scipy.signal import firwin, hilbert, lfilter

    h = firwin(101, [300.0 / (Fs / 2), 2600.0 / (Fs / 2)], pass_zero=False)
    x = lfilter(h, 1.0, np.asarray(pcm, np.float32))
    a = hilbert(x) * 10.0 ** (gain_dB / 20.0)
    env = np.abs(a) + 1e-9
    a = np.where(env > clip, a / env * clip, a)
    return lfilter(h, 1.0, a.real).astype(np.float32)


def main(argv=None):
    p = argparse.ArgumentParser(
        description="channel tool: fading + calibrated AWGN on IQ.f32")
    p.add_argument("inp", type=str)
    p.add_argument("out", type=str)
    p.add_argument("--No", type=float, required=True,
                   help="noise density, dB/Hz")
    p.add_argument("--fading", type=str, default=None,
                   choices=sorted(CHANNEL_PRESETS))
    p.add_argument("--seed", type=int, default=None)
    args = p.parse_args(argv)
    x = np.fromfile(args.inp, np.complex64)
    rng = np.random.default_rng(args.seed)
    y, CNo = apply_ch(x, args.No, fading=args.fading, rng=rng)
    y.tofile(args.out)
    print(f"C/No: {CNo:6.2f} dBHz")


if __name__ == "__main__":
    main()
