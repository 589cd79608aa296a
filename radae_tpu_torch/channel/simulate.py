"""Simulated HF channel on split-complex planes (port of
`radae_tpu/channel/simulate.py`).

The reference's in-model channel (reference: radae/radae.py:505-634): two-
path Watterson multipath with Doppler-spread gains G1/G2, phase, frequency
and df/dt offsets, per-sequence random phase/frequency and gain draws
(training), and AWGN with the per-bottleneck sigma formulas copied exactly.

Every random draw comes from an explicit torch.Generator on the device, in
radae_tpu's order (Eb/No, then per channel call: phase, frequency, noise,
gain).  torch cannot reproduce jax's stream, so the draws agree with
radae_tpu's in distribution only; everything else agrees value for value.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..ops import cplx
from ..ops.cplx import C


def _uniform(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=gen.device)


def draw_EbNodB(cfg, gen: torch.Generator, num_batches: int) -> torch.Tensor:
    """Per-sequence Eb/No (B, 1, 1): fixed, or uniform over a 20 dB range
    (reference: radae.py:470-473)."""
    if cfg.range_EbNo:
        return cfg.range_EbNo_start + 20.0 * _uniform(gen, (num_batches, 1, 1))
    return cfg.EbNodB * torch.ones((num_batches, 1, 1), device=gen.device)


def complex_normal(gen: torch.Generator, shape) -> C:
    """Unit-total-variance circular complex Gaussian (the variance
    convention of torch.randn_like on complex tensors)."""
    s = 1.0 / math.sqrt(2.0)
    return C(s * torch.randn(shape, generator=gen, device=gen.device),
             s * torch.randn(shape, generator=gen, device=gen.device))


def multipath_two_path(tx: C, G: C, d_samples: int) -> C:
    """Two-path Watterson model: rx = tx*G1 + delay(tx, d)*G2, power
    normalised so the measured SNR stays calibrated (reference:
    radae.py:529-539).  tx: (B, N); G: (B, N, 2) Doppler gains."""
    d = d_samples
    G1, G2 = G[:, :, 0], G[:, :, 1]
    tail = tx[:, :-d] * G2[:, :-d]
    delayed = cplx.concatenate(
        [cplx.zeros(tx.re[:, :d].shape, tx.re.device), tail], axis=1)
    tx_mp = tx * G1 + delayed
    mp_gain = torch.sqrt(tx.abs2().mean() / tx_mp.abs2().mean())
    return tx_mp * mp_gain


def _sigma_rate_fs(cfg, EbNo):
    """AWGN sigma at rate Fs (reference: radae.py:570-577)."""
    if cfg.bottleneck == 3:
        # rms power var(tx) ~ 1 after the PA saturation model
        S = 1.0
        return torch.sqrt(S * cfg.Fs / (EbNo * cfg.Rb))
    return (EbNo * cfg.M) ** -0.5


def _sigma_rate_rs(cfg, EbNodB):
    """AWGN sigma at rate Rs (reference: radae.py:627-632)."""
    if cfg.bottleneck == 3:
        EbNo = 10.0 ** (EbNodB / 10.0)
        sigma = cfg.M / torch.sqrt(2.0 * cfg.Nc * EbNo)
        return sigma / math.sqrt(2.0)
    return 10.0 ** (-EbNodB / 20.0)


def rate_fs_channel(cfg, gen: torch.Generator, tx: C, G: C,
                    EbNodB) -> Tuple[C, torch.Tensor, C]:
    """Rate-Fs (time domain) channel.

    tx: (B, N) transmit samples (after the PA bottleneck); G: (B, N, 2)
    path gains; EbNodB: (B, 1, 1).  Returns (rx, sigma (B, 1), final_phase
    (B,)): the phase rotation of the frequency offset at the last sample,
    for the EOO's phase continuity (reference: radae.py:553,
    inference.py:267-272)."""
    B, N = tx.shape
    dev = tx.re.device
    tx = multipath_two_path(tx, G, cfg.d_samples)
    final_phase = C(torch.ones((B,), device=dev), torch.zeros((B,), device=dev))

    # deterministic impairments given by the user (inference time)
    if cfg.phase_offset:
        tx = tx * cplx.expj(torch.tensor(cfg.phase_offset, dtype=torch.float32,
                                         device=dev))
    lin_phase = None
    if cfg.freq_offset:
        freq = (cfg.freq_offset
                + cfg.df_dt * torch.arange(N, dtype=torch.float32,
                                           device=dev) / cfg.Fs)
        omega = freq * 2.0 * math.pi / cfg.Fs
        lin_phase = cplx.expj(torch.cumsum(omega, 0))
        tx = tx * C(lin_phase.re[None, :], lin_phase.im[None, :])
        final_phase = C(lin_phase.re[-1].expand(B), lin_phase.im[-1].expand(B))

    # per-sequence random phase + frequency offset (training)
    if cfg.freq_rand:
        phase = 2.0 * math.pi * _uniform(gen, (B, 1))
        freq_offset = 40.0 * (_uniform(gen, (B, 1)) - 0.5)
        omega = freq_offset * 2.0 * math.pi / cfg.Fs
        lin = omega * torch.arange(N, dtype=torch.float32, device=dev)[None, :]
        tx = tx * cplx.expj(phase + lin)

    EbNo = 10.0 ** (EbNodB.reshape(B, 1) / 10.0)
    sigma = _sigma_rate_fs(cfg, EbNo)                                # (B,1)
    rx = tx + complex_normal(gen, tx.shape) * sigma

    # per-sequence random gain -20..+20 dB, SNR unchanged (training)
    if cfg.gain_rand:
        gain_dB = -20.0 + 40.0 * _uniform(gen, (B, 1))
        rx = rx * (10.0 ** (gain_dB / 20.0))

    rx = rx * cfg.gain
    if cfg.freq_offset and cfg.correct_freq_offset:
        rx = rx * C(lin_phase.re[None, :], -lin_phase.im[None, :])
    return rx, sigma, final_phase


def rate_rs_channel(cfg, gen: torch.Generator, tx_sym: C, H, EbNodB):
    """Rate-Rs (one sample per symbol) channel: per-carrier magnitude fade
    H plus AWGN (reference: radae.py:616-634).

    tx_sym: (B, T_Rs, Nc); H: (B, T_Rs, Nc) real fades.  Returns (rx_sym,
    sigma, the faded tx_sym, for the post-channel power)."""
    if cfg.phase_offset:
        tx_sym = tx_sym * cplx.expj(torch.tensor(
            cfg.phase_offset, dtype=torch.float32, device=tx_sym.re.device))
    tx_sym = tx_sym * H
    sigma = _sigma_rate_rs(cfg, EbNodB)
    rx_sym = tx_sym + complex_normal(gen, tx_sym.shape) * sigma
    return rx_sym, sigma, tx_sym
