"""Corpus augmentation: inflate a small speech corpus for training (a copy
of `radae_tpu/data/augment.py`: numpy and scipy only, the same code).

The reference trains on ~200 hours of speech; this environment ships ~116 s
of public wav fixtures (reference: wav/*.wav).  To close as much of that
gap as the data honestly allows, each utterance is expanded by a grid of
acoustic transforms that create distinct voice qualities while staying
speech-like:

  * speed/pitch warps by polyphase resampling (shifts pitch AND formants —
    effectively new speakers)
  * spectral tilt (+/- first-order emphasis, new channel/voice colour)
  * time reversal (reversed speech has speech statistics)
  * low-level noise mixing and random per-variant gain

Features are extracted with the built-in vocoder (radae_tpu_torch.vocoder) and
concatenated into one .f32 feature file (36 floats / 10 ms frame).

CLI:  python -m radae_tpu_torch.data.augment WAVDIR OUT.f32 [--hold-out name...]
"""

from __future__ import annotations

import argparse
import os
import sys
import wave
from fractions import Fraction

import numpy as np
from scipy.signal import resample_poly

from ..vocoder import MelVocoder, SPEECH_FS

SPEED_FACTORS = (0.85, 0.92, 1.0, 1.08, 1.16)
TILTS = (0.0, 0.4, -0.4)                  # pre-emphasis coefficient


def read_wav(path: str) -> np.ndarray:
    w = wave.open(path)
    assert w.getframerate() == SPEECH_FS, (path, w.getframerate())
    pcm = np.frombuffer(w.readframes(w.getnframes()), np.int16)
    if w.getnchannels() > 1:
        pcm = pcm[:: w.getnchannels()]
    return pcm.astype(np.float32)


def warp(pcm: np.ndarray, factor: float) -> np.ndarray:
    """Speed/pitch warp: play back `factor` times faster (resample)."""
    if factor == 1.0:
        return pcm
    fr = Fraction(factor).limit_denominator(50)
    return resample_poly(pcm, fr.denominator, fr.numerator).astype(np.float32)


def tilt(pcm: np.ndarray, a: float) -> np.ndarray:
    """First-order spectral tilt: y[n] = x[n] - a*x[n-1] (a>0 brightens,
    a<0 darkens); renormalised to the input RMS."""
    if a == 0.0:
        return pcm
    y = pcm.copy()
    y[1:] -= a * pcm[:-1]
    rms_in = np.sqrt((pcm ** 2).mean() + 1e-9)
    rms_out = np.sqrt((y ** 2).mean() + 1e-9)
    return y * (rms_in / rms_out)


def reverb(pcm: np.ndarray, rng: np.random.Generator,
           rt_ms: float = 120.0, direct: float = 0.8) -> np.ndarray:
    """Synthetic small-room reverb: exponentially-decaying noise RIR."""
    n = int(rt_ms / 1000 * SPEECH_FS)
    rir = (rng.standard_normal(n).astype(np.float32)
           * np.exp(-3.0 * np.arange(n) / n))
    rir[0] = 0.0
    tail = np.convolve(pcm, rir, mode="full")[: len(pcm)]
    tail *= (1.0 - direct) * np.sqrt((pcm ** 2).mean()
                                     / ((tail ** 2).mean() + 1e-9))
    return (direct * pcm + tail).astype(np.float32)


def bandlimit(pcm: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Random comms-style band limit (telephone-ish channel colour)."""
    from scipy.signal import butter, lfilter
    lo = rng.uniform(80, 250)
    hi = rng.uniform(3000, 6500)
    b, a = butter(2, [lo / (SPEECH_FS / 2), hi / (SPEECH_FS / 2)], "bandpass")
    y = lfilter(b, a, pcm).astype(np.float32)
    return y * np.sqrt((pcm ** 2).mean() / ((y ** 2).mean() + 1e-9))


def augment_pcm(pcm: np.ndarray, rng: np.random.Generator,
                speeds=SPEED_FACTORS, tilts=TILTS, reverse: bool = True,
                room: bool = False):
    """Yield augmented float32 pcm variants of one utterance."""
    for s in speeds:
        w = warp(pcm, s)
        for a in tilts:
            t = tilt(w, a)
            for rev in ((False, True) if reverse else (False,)):
                v = t[::-1].copy() if rev else t
                if room and rng.uniform() < 0.5:
                    v = reverb(v, rng, rt_ms=rng.uniform(60, 200))
                if room and rng.uniform() < 0.3:
                    v = bandlimit(v, rng)
                gain = 10 ** (rng.uniform(-6, 6) / 20)
                v = v * gain
                snr_db = rng.uniform(25, 40)
                npow = (v ** 2).mean() / 10 ** (snr_db / 10)
                v = v + rng.standard_normal(len(v)).astype(np.float32) \
                    * np.sqrt(npow)
                peak = np.abs(v).max() + 1e-9
                if peak > 30000:
                    v = v * (30000 / peak)
                yield v.astype(np.float32)


def build_corpus(wav_dir: str, out_path: str, hold_out=(), skip=("all.wav",),
                 speeds=SPEED_FACTORS, tilts=TILTS, reverse=True, room=False,
                 seed=0, verbose=True):
    """Extract features for the augmented corpus; returns frame count."""
    rng = np.random.default_rng(seed)
    voc = MelVocoder()
    total = 0
    with open(out_path, "wb") as out:
        for name in sorted(os.listdir(wav_dir)):
            if not name.endswith(".wav") or name in skip:
                continue
            if any(h in name for h in hold_out):
                continue
            pcm = read_wav(os.path.join(wav_dir, name))
            nv = 0
            for v in augment_pcm(pcm, rng, speeds, tilts, reverse, room):
                feats = voc.extract(v.astype(np.int16))
                feats.astype(np.float32).tofile(out)
                total += feats.shape[0]
                nv += 1
            if verbose:
                print(f"{name}: {len(pcm)/SPEECH_FS:.1f}s x {nv} variants",
                      file=sys.stderr)
    if verbose:
        print(f"wrote {total} frames ({total/100:.0f} s) to {out_path}",
              file=sys.stderr)
    return total


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("wav_dir", type=str)
    p.add_argument("out", type=str)
    p.add_argument("--hold-out", nargs="*", default=[],
                   help="substrings of wav names to exclude (eval holdout)")
    p.add_argument("--no-reverse", dest="reverse", action="store_false")
    p.add_argument("--room", action="store_true",
                   help="also apply random synthetic reverb / band limits")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(reverse=True)
    args = p.parse_args(argv)
    build_corpus(args.wav_dir, args.out, hold_out=args.hold_out,
                 reverse=args.reverse, room=args.room, seed=args.seed)


if __name__ == "__main__":
    main()
