"""Analog FM modulator/demodulator simulation — the BBFM baseline (a copy
of `radae_tpu/channel/fm.py`, which the port may not import: numpy only,
the same code).

Port of the Octave analog FM simulation (reference: fm.m): phase-integrating
modulator with optional 50 us pre-emphasis, complex-baseband demodulator via
rect-domain differentiation with delta-phase limiting, Carson's-rule
bandwidth input filter and an fm_max output filter.  Used as the classical
baseline the BBFM autoencoder is compared against (reference: BBFM.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _firls(ncoeffs, bands, gains, fs=2.0):
    """Least-squares linear-phase FIR on a fine frequency grid (replaces
    Octave's firls for the two filter shapes used here)."""
    n = ncoeffs
    grid_f = np.linspace(0, 1, 512)
    grid_g = np.interp(grid_f, bands, gains)
    # frequency-sampling design with Hamming window
    shift = np.exp(-1j * np.pi * grid_f * (n - 1))
    half = grid_g * shift
    full = np.concatenate([half, np.conj(half[-2:0:-1])])
    h = np.fft.ifft(full).real[:n] * np.hamming(n)
    # normalise passband gain
    return h / np.abs(np.fft.rfft(h, 1024)).max()


@dataclass
class FMConfig:
    Fs: float = 96000.0
    fm_max: float = 3000.0       # max modulation frequency
    fd: float = 5000.0           # max deviation
    fc: float = 24000.0          # carrier
    pre_emp: bool = False
    de_emp: bool = False
    output_filter: bool = True
    ph_dont_limit: bool = False

    @property
    def m(self):
        return self.fd / self.fm_max        # modulation index

    @property
    def Bfm(self):
        return 2 * (self.fd + self.fm_max)  # Carson's rule


class AnalogFM:
    def __init__(self, cfg: FMConfig = FMConfig()):
        self.cfg = cfg
        Fs = cfg.Fs
        tc = 50e-6
        self.prede = np.array([1.0, -(1.0 - 1.0 / (tc * Fs))])
        ncoeffs = 200
        fc_in = (cfg.Bfm / 2) / (Fs / 2)
        self.bin = _firls(ncoeffs,
                          [0, fc_in * 0.95, min(fc_in * 1.05, 1.0), 1.0],
                          [1, 1, 0.01, 0.01])
        fc_out = cfg.fm_max / (Fs / 2)
        self.bout = _firls(ncoeffs,
                           [0, 0.95 * fc_out, min(1.05 * fc_out, 1.0), 1.0],
                           [1, 1, 0.01, 0.01])
        self.delay = ncoeffs

    def mod(self, audio: np.ndarray) -> np.ndarray:
        """Real modulating signal in [-1,1] -> complex FM at carrier fc."""
        cfg = self.cfg
        x = np.asarray(audio, np.float64)
        if cfg.pre_emp:
            x = _iir1(self.prede, [1.0], x)
            x = x / np.abs(x).max()          # AGC to set deviation
        wc = 2 * np.pi * cfg.fc / cfg.Fs
        wd = 2 * np.pi * cfg.fd / cfg.Fs
        phase = np.cumsum(wc + wd * x)
        return np.exp(1j * phase).astype(np.complex64)

    def demod(self, rx: np.ndarray) -> np.ndarray:
        """Complex FM at fc -> demodulated real signal (unit deviation)."""
        cfg = self.cfg
        n = len(rx)
        t = np.arange(n)
        wc = 2 * np.pi * cfg.fc / cfg.Fs
        wd = 2 * np.pi * cfg.fd / cfg.Fs
        bb = rx * np.exp(-1j * wc * t)
        bb = np.convolve(bb, self.bin)[:n]
        diff = np.empty(n, np.complex128)
        diff[0] = 1.0
        diff[1:] = bb[1:] * np.conj(bb[:-1])
        out = np.arctan2(diff.imag, diff.real)
        if not cfg.ph_dont_limit:
            out = np.clip(out, -wd, wd)     # kill static clicks at low SNR
        out = out / wd
        if cfg.output_filter:
            out = np.convolve(out, self.bout)[:n]
        if cfg.de_emp:
            out = _iir1([1.0], self.prede, out)
        return out.astype(np.float32)

    def snr_test(self, CNdB: float, nsec: float = 1.0, fmod: float = 1000.0,
                 rng=None):
        """Mod a sine, add carrier-to-noise-calibrated AWGN, demod, measure
        output SNR (reference: analog_fm_test)."""
        if rng is None:
            rng = np.random.default_rng(0)
        cfg = self.cfg
        n = int(cfg.Fs * nsec)
        t = np.arange(n) / cfg.Fs
        audio = np.sin(2 * np.pi * fmod * t)
        tx = self.mod(audio)
        # C/N in Bfm: carrier power 1; noise power in Fs scaled to CN in Bfm
        CN = 10 ** (CNdB / 10)
        variance = cfg.Fs / (CN * cfg.Bfm)
        noise = np.sqrt(variance / 2) * (rng.standard_normal(n)
                                         + 1j * rng.standard_normal(n))
        out = self.demod((tx + noise).astype(np.complex64))
        out = out[self.delay: n - self.delay]
        # output SNR: power at fmod vs the rest
        spec = np.abs(np.fft.rfft(out * np.hanning(len(out)))) ** 2
        freqs = np.fft.rfftfreq(len(out), 1 / cfg.Fs)
        sig_band = np.abs(freqs - fmod) < 50
        noise_band = (freqs < cfg.fm_max) & ~ (np.abs(freqs - fmod) < 100)
        S = spec[sig_band].sum()
        N = spec[noise_band].sum() + 1e-12
        return 10 * np.log10(S / N)


def _iir1(b, a, x):
    """Direct-form-I first-order IIR/FIR filter."""
    b = np.asarray(b, np.float64)
    a = np.asarray(a, np.float64)
    y = np.zeros(len(x))
    xprev = yprev = 0.0
    for i, xi in enumerate(x):
        acc = b[0] * xi
        if len(b) > 1:
            acc += b[1] * xprev
        if len(a) > 1:
            acc -= a[1] * yprev
        y[i] = acc / a[0]
        xprev, yprev = xi, y[i]
    return y
