"""Vocoder front/back end: feature extraction and speech synthesis (port of
`radae_tpu/vocoder.py`: FARGANVocoder and MelVocoder are numpy copies, the
same code; get_vocoder's neural back end runs on the device it is given).

The reference uses the external opus/FARGAN `lpcnet_demo` binary (built
from a pinned opus commit, reference: src/lpcnet_demo.c:98-100,
cmake/BuildOpus.cmake) as a separate process connected by files.  This
module provides:

  * FARGANVocoder — a bridge to that binary when available (path via
    $RADAE_LPCNET_DEMO or constructor arg), matching the reference's
    `lpcnet_demo -features in.pcm feat.f32` / `-fargan-synthesis feat.f32
    out.pcm` CLI contract (16 kHz int16 pcm, 36 floats per 10 ms frame).

  * MelVocoder — a self-contained DSP analysis/synthesis pair with the
    same 36-float frame layout (18 cepstral + pitch + voicing + 16 unused)
    so the full wav -> radae -> wav pipeline runs without external
    binaries.  It is a classical mel-cepstral vocoder (not FARGAN): lower
    speech quality, same interface, useful for development and testing.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import tempfile

import numpy as np

from .data.io import NB_TOTAL_FEATURES

SPEECH_FS = 16000
FRAME = 160                  # 10 ms at 16 kHz
NCEPS = 18
PITCH_MIN_HZ, PITCH_MAX_HZ = 62.5, 500.0
NFFT = 512


class FARGANVocoder:
    """Bridge to the external opus/FARGAN lpcnet_demo binary."""

    def __init__(self, binary: str | None = None):
        self.binary = binary or os.environ.get("RADAE_LPCNET_DEMO", "")
        if not self.binary:
            self.binary = shutil.which("lpcnet_demo") or ""

    def available(self) -> bool:
        return bool(self.binary) and os.path.exists(self.binary)

    def extract(self, pcm: np.ndarray) -> np.ndarray:
        """int16 16 kHz pcm -> (T, 36) float32 features."""
        with tempfile.TemporaryDirectory() as d:
            pin, fout = f"{d}/in.pcm", f"{d}/feat.f32"
            np.asarray(pcm, np.int16).tofile(pin)
            subprocess.run([self.binary, "-features", pin, fout], check=True)
            return np.fromfile(fout, np.float32).reshape(-1, NB_TOTAL_FEATURES)

    def synthesize(self, features: np.ndarray) -> np.ndarray:
        """(T, 36) features -> int16 pcm."""
        with tempfile.TemporaryDirectory() as d:
            fin, pout = f"{d}/feat.f32", f"{d}/out.pcm"
            np.asarray(features, np.float32).tofile(fin)
            subprocess.run([self.binary, "-fargan-synthesis", fin, pout],
                           check=True)
            return np.fromfile(pout, np.int16)


def _mel_filterbank(nbands=NCEPS, nfft=NFFT, fs=SPEECH_FS):
    def hz_to_mel(f):
        return 2595.0 * np.log10(1.0 + f / 700.0)

    def mel_to_hz(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    mels = np.linspace(hz_to_mel(100), hz_to_mel(fs / 2 - 200), nbands + 2)
    freqs = mel_to_hz(mels)
    bins = np.floor((nfft // 2 + 1) * freqs / (fs / 2)).astype(int)
    fb = np.zeros((nbands, nfft // 2 + 1), np.float32)
    for b in range(nbands):
        lo, mid, hi = bins[b], bins[b + 1], bins[b + 2]
        hi = max(hi, mid + 1)
        mid = max(mid, lo + 1)
        fb[b, lo:mid] = np.linspace(0, 1, mid - lo, endpoint=False)
        fb[b, mid:hi] = np.linspace(1, 0, hi - mid, endpoint=False)
    return fb


def _dct_mat(n):
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * k * (2 * i + 1) / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m.astype(np.float32)


class MelVocoder:
    """Self-contained mel-cepstral vocoder with the 36-float frame layout."""

    def __init__(self):
        self.fb = _mel_filterbank()
        self.dct = _dct_mat(NCEPS)
        self.idct = np.linalg.inv(self.dct)
        self.win = np.hanning(2 * FRAME).astype(np.float32)

    # -- analysis -----------------------------------------------------------
    def extract(self, pcm: np.ndarray) -> np.ndarray:
        x = np.asarray(pcm, np.float32) / 32768.0
        nframes = len(x) // FRAME - 1
        feats = np.zeros((max(nframes, 0), NB_TOTAL_FEATURES), np.float32)
        lag_min = int(SPEECH_FS / PITCH_MAX_HZ)
        lag_max = int(SPEECH_FS / PITCH_MIN_HZ)
        for t in range(nframes):
            seg = x[t * FRAME:(t + 2) * FRAME] * self.win
            spec = np.abs(np.fft.rfft(seg, NFFT)) ** 2
            band = self.fb @ spec + 1e-10
            ceps = self.dct @ np.log10(band).astype(np.float32)
            feats[t, :NCEPS] = ceps

            # pitch + voicing from properly normalised cross-correlation:
            # corr(lag) = <x[:-lag], x[lag:]> / (|x[:-lag]| |x[lag:]|)
            seg2 = x[t * FRAME:(t + 2) * FRAME]
            seg2 = seg2 - seg2.mean()
            n2 = len(seg2)
            ac = np.correlate(seg2, seg2, "full")[n2 - 1:]
            csum = np.concatenate([[0], np.cumsum(seg2 * seg2)])
            lags = np.arange(lag_min, lag_max)
            e_head = csum[n2 - lags] - csum[0]
            e_tail = csum[n2] - csum[lags]
            denom = np.sqrt(e_head * e_tail) + 1e-9
            acn = ac[lag_min:lag_max] / denom
            if csum[-1] > 1e-9:
                k = int(np.argmax(acn))
                lag = lag_min + k
                corr = float(acn[k])
            else:
                lag, corr = lag_max, 0.0
            # pitch feature: log-lag centered (roughly [-1, 1])
            feats[t, 18] = np.log2(lag / np.sqrt(lag_min * lag_max)) / 1.5
            feats[t, 19] = np.clip(corr, 0.0, 1.0) - 0.5
        return feats

    # -- synthesis ----------------------------------------------------------
    def synthesize(self, features: np.ndarray) -> np.ndarray:
        f = np.asarray(features, np.float32)
        T = f.shape[0]
        out = np.zeros((T + 1) * FRAME, np.float32)
        rng = np.random.default_rng(0)
        lag_min = int(SPEECH_FS / PITCH_MAX_HZ)
        lag_max = int(SPEECH_FS / PITCH_MIN_HZ)
        phase = 0.0
        for t in range(T):
            band = 10 ** (self.idct @ f[t, :NCEPS])
            lag = np.sqrt(lag_min * lag_max) * 2 ** (1.5 * f[t, 18])
            lag = float(np.clip(lag, lag_min, lag_max))
            corr = float(np.clip(f[t, 19] + 0.5, 0.0, 1.0))

            # excitation: pulse train (voiced) + noise, 20 ms
            n = 2 * FRAME
            exc = (1.0 - corr) * rng.standard_normal(n).astype(np.float32)
            f0 = SPEECH_FS / lag
            ph = phase + 2 * np.pi * f0 * np.arange(n) / SPEECH_FS
            for h in range(1, int(SPEECH_FS / 2 / f0)):
                exc += (corr * 0.5 / np.sqrt(h)) * np.cos(h * ph).astype(np.float32)
            phase = ph[-1] % (2 * np.pi)

            # shape excitation spectrum by the band envelope
            E = np.fft.rfft(exc * self.win, NFFT)
            espec = np.abs(E) ** 2
            eband = self.fb @ espec + 1e-10
            # per-bin gain interpolated from band gains
            gain_band = np.sqrt(band / eband)
            gain_bin = self.fb.T @ gain_band / (self.fb.sum(0) + 1e-6)
            y = np.fft.irfft(E * gain_bin, NFFT)[:n]
            out[t * FRAME:(t + 2) * FRAME] += y * self.win
        peak = np.abs(out).max() + 1e-9
        return (out / peak * 16384).astype(np.int16)


NEURAL_WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "fixtures", "vocoder_nn.npz")


def get_vocoder(prefer_external: bool = True, backend: str = "auto",
                device="cuda"):
    """Synthesis back-end selection.

    auto: FARGAN binary if present, else the trained neural fixture
    (vocoder_nn.npz) if present, else the classical MelVocoder.  The
    neural back end synthesizes on `device` (default cuda, refused without
    a card; "cpu" when asked).
    """
    if backend == "mel":
        return MelVocoder()
    if backend in ("auto", "neural"):
        if backend == "auto" and prefer_external:
            v = FARGANVocoder()
            if v.available():
                return v
        if os.path.exists(NEURAL_WEIGHTS):
            from .vocoder_nn import NeuralVocoder
            return NeuralVocoder(NEURAL_WEIGHTS, device=device)
        if backend == "neural":
            raise FileNotFoundError(NEURAL_WEIGHTS)
    return MelVocoder()
