"""The one traffic generator: every input a cell sends is made here from
the traffic file's parameters and the run's seed.

Speech features come from the repository's feature fixture, each stream or
file at its own offset; the benchmark's plain encoder and modulator
(reference/radae_ref.py) turn them into a transmitted signal; an AWGN
channel at an SNR drawn for each stream or file, and a random carrier
phase, give what a receiver hears.  The same seed gives the same inputs on
the same device.  The sizes of the work (streams, frames, file lengths) do
not depend on the seed: a seed changes the content and the order only.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import radae_ref as R

FEATURE_COLUMNS = 36        # a 10 ms feature frame in the fixture
USED_FEATURES = 20          # the vocoder features the model codes
SNR_BANDWIDTH_HZ = 3000.0   # SNRs are stated in 3 kHz, as HF modems are
BLOCK = 4096                # streams encoded at once while making a pool


class Source:
    """The seeded draws of one run: a numpy Generator for sizes, offsets
    and orders, a torch Generator on the device for the channel."""

    def __init__(self, seed: int, device):
        self.rng = np.random.default_rng(seed)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed) % (1 << 63))
        self.device = device

    def uniform(self, n, lo, hi):
        u = torch.rand(n, generator=self.gen, device=self.device)
        return lo + (hi - lo) * u


def speech_features(root, traffic, cfg, src: Source, n, rows):
    """(n, rows, feature_dim) features: stream or file b starts at a seeded
    base plus b times the traffic's row_step (wrapped); the auxdata column
    of a 21-feature model is -1, as a transmitter sends without data."""
    raw = np.fromfile(root / traffic["features"], np.float32).reshape(
        -1, FEATURE_COLUMNS)[:, :USED_FEATURES]
    if len(raw) <= rows:
        raise ValueError(f"{rows} feature rows asked of a fixture of {len(raw)}")
    raw = torch.as_tensor(np.ascontiguousarray(raw), device=src.device)
    base = int(src.rng.integers(0, len(raw) - rows))
    offs = (base + traffic["row_step"] * torch.arange(n, device=src.device)) \
        % (len(raw) - rows)
    out = torch.full((n, rows, cfg["feature_dim"]), -1.0, device=src.device)
    out[:, :, :USED_FEATURES] = raw[offs[:, None]
                                    + torch.arange(rows, device=src.device)]
    return out


def transmit(nets, modem, cfg, feats):
    """Features (n, 12 k, F) from the zero state -> (n, k Nmf) complex
    samples, through the plain encoder and modulator, in blocks."""
    out = []
    for b in range(0, feats.shape[0], BLOCK):
        f = feats[b:b + BLOCK]
        z, _ = nets.encoder(f, nets.encoder_zero_state(f.shape[0], f.device),
                            cfg["bottleneck"])
        out.append(modem.modulate(z))
    return torch.cat(out)


def channel(x, snr_db, src: Source, fs):
    """x (n, T) complex through AWGN at snr_db (n,) in 3 kHz, measured
    against each row's own mean power, and a uniform carrier phase."""
    n = x.shape[0]
    phase = src.uniform(n, 0.0, 2.0 * np.pi)
    x = x * torch.polar(torch.ones_like(phase), phase)[:, None]
    power = (x.real ** 2 + x.imag ** 2).mean(dim=1)
    var = power * fs / (SNR_BANDWIDTH_HZ * 10.0 ** (snr_db / 10.0))
    noise = torch.randn(x.shape + (2,), generator=src.gen, device=src.device)
    sd = torch.sqrt(var / 2.0)[:, None]
    return x + torch.complex(noise[..., 0] * sd, noise[..., 1] * sd)


def stream_iq(root, traffic, cfg, nets, modem, src: Source):
    """The rx stream pool: (pool_frames, streams, Nmf+M+Ncp, 2) f32, frame
    k of every stream with the next frame's pilot row after it (the last
    frame's is the pilot row a next frame would start with)."""
    n, P = traffic["streams"], traffic["pool_frames"]
    feats = speech_features(root, traffic, cfg, src, n, 12 * P)
    tx = transmit(nets, modem, cfg, feats)
    tx = torch.cat([tx, modem.pilot_row.expand(n, -1)], dim=1)
    snr = src.uniform(n, *traffic["snr_db"])
    rx = R.packed(channel(tx, snr, src, cfg["Fs"]))
    win = modem.Nmf + modem.M + modem.Ncp
    return torch.stack([rx[:, k * modem.Nmf:k * modem.Nmf + win]
                        for k in range(P)]).contiguous()


def stream_features(root, traffic, cfg, src: Source):
    """The tx stream pool: (pool_frames, streams, 12, F) features."""
    n, P = traffic["streams"], traffic["pool_frames"]
    feats = speech_features(root, traffic, cfg, src, n, 12 * P)
    return feats.reshape(n, P, 12, -1).transpose(0, 1).contiguous()


def file_frames(traffic, frame_s=0.12):
    """Each file's length in modem frames: the quantiles of the uniform
    spread of lengths, the same for every seed."""
    lo, hi = traffic["seconds"]
    n = traffic["files"]
    return [int((lo + (hi - lo) * (i + 0.5) / n) / frame_s) for i in range(n)]


def file_iq(root, traffic, cfg, nets, modem, src: Source):
    """The file pool: one (frames Nmf, 2) f32 tensor a file, whole modem
    frames, time and frequency aligned."""
    frames = file_frames(traffic)
    n, longest = len(frames), max(frames)
    feats = speech_features(root, traffic, cfg, src, n, 12 * longest)
    tx = transmit(nets, modem, cfg, feats)        # causal: a prefix is a file
    snr = src.uniform(n, *traffic["snr_db"])
    rx = R.packed(channel(tx, snr, src, cfg["Fs"]))
    return [rx[i, :f * modem.Nmf].contiguous() for i, f in enumerate(frames)]


def file_order(traffic, src: Source, n_calls):
    """The files' order: one seeded permutation of the pool after another,
    so every seed sends each file equally often."""
    n = traffic["files"]
    order = []
    while len(order) < n_calls:
        order.extend(int(i) for i in src.rng.permutation(n))
    return order[:n_calls]
