"""Native generation of HF channel fading samples (no Octave dependency; a
copy of `radae_tpu/channel/doppler.py`: numpy only, the same code).

Port of the PathSim-method Doppler spreading generator and the multipath
H/G sample-file builder (reference: doppler_spread.m:8-50,
multipath_samples.m:12-100).  File formats are kept bit-compatible with the
reference so its H/G files interoperate:

  H file: rate-Rs fade magnitudes, f32, row-major (time, Nc)
  G file: rate-Fs complex Doppler gains ...G1G2G1G2..., with the first
          (G1,G2) entry holding hf_gain (reference: multipath_samples.m:88-100,
          radae/dataset.py:83-88)

Host-side numpy: channel sample generation is data preparation, not part of
the compiled compute path.
"""

from __future__ import annotations

import numpy as np

# dopplerSpreadHz, path_delay_s per channel class (multipath_samples.m:12-24)
CHANNEL_PRESETS = {
    "mpg": (0.1, 0.5e-3),
    "mpp": (1.0, 2e-3),
    "mpd": (2.0, 4e-3),
    # 60 km/h at 450 MHz land-mobile-radio channel
    "lmr60": (2 * 450e6 * (60 * 1e3 / 3600 / 3e8), 200e-6),
}


def _fir2(ntaps: int, freq: np.ndarray, gain: np.ndarray) -> np.ndarray:
    """Frequency-sampling FIR design with a Hamming window.

    freq is normalised to Nyquist=1 and must start at 0; equivalent to
    Octave's fir2 as used by doppler_spread.m:31."""
    nfft = 512
    grid_f = np.linspace(0.0, 1.0, nfft + 1)
    grid_g = np.interp(grid_f, freq, gain)
    # build full spectrum with linear phase (half-length delay)
    shift = np.exp(-1j * np.pi * grid_f * (ntaps - 1))
    half = grid_g * shift
    full = np.concatenate([half, np.conj(half[-2:0:-1])])
    h = np.fft.ifft(full).real[:ntaps]
    return h * np.hamming(ntaps)


def doppler_spread(spread_Hz: float, Fs: float, nsam: int,
                   rng: np.random.Generator | None = None) -> np.ndarray:
    """Gaussian-filtered complex Doppler spreading samples, shape (nsam,).

    Filters complex white noise at a low sample rate with a Gaussian-shaped
    FIR, then linearly resamples to Fs (reference: doppler_spread.m:8-50)."""
    if rng is None:
        rng = np.random.default_rng()
    sigma = spread_Hz / 2.0
    lowFs = float(np.ceil(10 * spread_Hz))
    ntaps = 100
    M = Fs / lowFs
    if M != np.floor(M):
        M = np.floor(M)
        lowFs = Fs / M
    M = int(M)
    nsam_low = max(int(np.ceil(nsam / M)), 2)

    x = np.arange(0.0, lowFs / 2 + lowFs / 200, lowFs / 100)
    y = (1.0 / (sigma * np.sqrt(2 * np.pi))) * np.exp(-(x ** 2) / (2 * sigma * sigma))
    b = _fir2(ntaps, x / (lowFs / 2), y)

    noise = (rng.standard_normal(nsam_low + ntaps)
             + 1j * rng.standard_normal(nsam_low + ntaps))
    spread_low = np.convolve(noise, b)[:nsam_low + ntaps][ntaps:]

    # linear resample: sample n of the output sits at low-rate position n/M
    t_low = np.arange(nsam_low) * M
    t_out = np.arange(nsam)
    spread = (np.interp(t_out, t_low, spread_low.real)
              + 1j * np.interp(t_out, t_low, spread_low.imag))
    return spread.astype(np.complex64)


def multipath_samples(ch: str, Fs: float, Rs: float, Nc: int, nseconds: float,
                      H_fn: str = "", G_fn: str = "",
                      rng: np.random.Generator | None = None):
    """Generate rate-Rs H fades and rate-Fs G Doppler gains for a channel
    class, optionally writing reference-compatible files.

    Returns (H, G, hf_gain): H (time,Nc) float32 magnitudes at rate Rs;
    G (time,2) complex64 at rate Fs (reference: multipath_samples.m:30-100)."""
    if ch not in CHANNEL_PRESETS:
        raise ValueError(f"unknown channel {ch!r}; pick from {list(CHANNEL_PRESETS)}")
    if rng is None:
        rng = np.random.default_rng()
    spread_Hz, path_delay_s = CHANNEL_PRESETS[ch]
    nsam = int(Fs * nseconds)

    G1 = doppler_spread(spread_Hz, Fs, nsam, rng)
    G2 = doppler_spread(spread_Hz, Fs, nsam, rng)
    hf_gain = 1.0 / np.sqrt(np.var(G1) + np.var(G2))

    M = int(Fs / Rs)
    omega = 2 * np.pi * np.arange(Nc)
    H = hf_gain * (G1[::M, None] + G2[::M, None]
                   * np.exp(-1j * omega[None, :] * path_delay_s * Rs))
    H = np.abs(H).astype(np.float32)

    G = np.stack([G1, G2], axis=1).astype(np.complex64)

    if H_fn:
        H.flatten().tofile(H_fn)
    if G_fn:
        head = np.full((1, 2), hf_gain, dtype=np.complex64)
        np.concatenate([head, G], axis=0).flatten().tofile(G_fn)
    return H, G, float(hf_gain)


def load_g_file(g_fn: str) -> np.ndarray:
    """Load a G file: strips the hf_gain head row and pre-applies the gain
    (reference: radae/dataset.py:83-88)."""
    G = np.fromfile(g_fn, dtype=np.complex64).reshape(-1, 2)
    mp_gain = np.real(G[0, 0])
    return (mp_gain * G[1:, :]).astype(np.complex64)


def load_h_file(h_fn: str, Nc: int) -> np.ndarray:
    return np.fromfile(h_fn, dtype=np.float32).reshape(-1, Nc)


def fade_two_path(x: np.ndarray, channel: str, Fs: float = 8000,
                  rng: np.random.Generator | None = None,
                  normalize: bool = True) -> np.ndarray:
    """Apply a preset two-path Watterson fade to a sample stream.

    Receive-time gain convention: y[n] = hf_gain*(G1[n]*x[n] +
    G2[n]*x[n-d]) with d the preset's path delay.  The single shared
    implementation behind tools/ch, tools/ptt_loop and the streaming
    robustness tests.  With normalize=True the output is rescaled to the
    input's mean power so a subsequently-set SNR is the true SNR."""
    if rng is None:
        rng = np.random.default_rng()
    x = np.asarray(x, np.complex64)
    _, path_delay_s = CHANNEL_PRESETS[channel]
    _, G, hf_gain = multipath_samples(channel, Fs, Fs / 160, 1,
                                      len(x) / Fs + 1, rng=rng)
    G1, G2 = G[: len(x), 0], G[: len(x), 1]
    d = int(round(path_delay_s * Fs))
    delayed = np.concatenate([np.zeros(d, np.complex64), x[:-d]])
    y = (hf_gain * (x * G1 + delayed * G2)).astype(np.complex64)
    if normalize:
        sig = np.abs(x) > 0
        p_in = (np.abs(x[sig]) ** 2).mean() if sig.any() else 0.0
        p_out = (np.abs(y[sig]) ** 2).mean() + 1e-12 if sig.any() else 1.0
        y = (y * np.sqrt(p_in / p_out)).astype(np.complex64)
    return y
