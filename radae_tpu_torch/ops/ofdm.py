"""OFDM modulation primitives on split-complex planes (port of
`radae_tpu/ops/ofdm.py`).

The Nc<->M carrier transforms are small non-power-of-2 DFT matrices applied
as pairs of real matrix products, batched over streams x symbol rows.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cplx
from .cplx import C


def qpsk_map(z: torch.Tensor) -> C:
    """Interleaved real latents (..., L) -> QPSK symbols (..., L/2);
    even indices = I, odd = Q (reference: radae/radae.py:482)."""
    return C(z[..., ::2], z[..., 1::2])


def qpsk_demap(sym: C) -> torch.Tensor:
    """Complex symbols -> interleaved real latents (reference: radae.py:649-651)."""
    return torch.stack([sym.re, sym.im], dim=-1).reshape(
        sym.re.shape[:-1] + (2 * sym.re.shape[-1],))


def magnitude_bottleneck(x: C) -> C:
    """tanh() saturation of the complex magnitude, phase preserved, as a
    radial rescale (reference: radae.py:487,525-526)."""
    r = torch.sqrt(x.abs2() + 1e-12)
    return x * (torch.tanh(r) / r)


def insert_pilots(tx_sym: C, P: C, pilot_gain: float, Ns: int) -> C:
    """Insert one pilot row per modem frame: D...D -> PD...D.

    tx_sym: (B, T_Rs, Nc) with T_Rs divisible by Ns; P: (Nc,) pilots made
    by cplx.const.  Returns (B, T_Rs + T_Rs//Ns, Nc)
    (reference: radae.py:493-500)."""
    B, T, Nc = tx_sym.shape
    nmf = T // Ns
    framed = tx_sym.reshape(B, nmf, Ns, Nc)
    P = P * pilot_gain
    pr = P.re.expand(B, nmf, 1, Nc)
    pi = P.im.expand(B, nmf, 1, Nc)
    out = cplx.concatenate([C(pr, pi), framed], axis=2)
    return out.reshape(B, nmf * (Ns + 1), Nc)


def strip_pilots(rx_sym: C, Ns: int) -> C:
    """Drop the pilot row of each PD...D modem frame.

    rx_sym: (B, T', Nc) with T' divisible by Ns+1 -> (B, nmf, Ns, Nc)."""
    B, T, Nc = rx_sym.shape
    nmf = T // (Ns + 1)
    return rx_sym.reshape(B, nmf, Ns + 1, Nc)[:, :, 1:, :]


def idft(tx_sym: C, Winv: C) -> C:
    """Carriers -> time samples: (B, T, Nc) @ (Nc, M) -> (B, T, M)."""
    return cplx.matmul_const(tx_sym, Winv)


def dft(rx: C, Wfwd: C) -> C:
    """Time samples -> carriers: (B, T, M) @ (M, Nc) -> (B, T, Nc)."""
    return cplx.matmul_const(rx, Wfwd)


def add_cp(tx: C, Ncp: int) -> C:
    """Prefix each symbol with its last Ncp samples: (B,T,M) -> (B,T,M+Ncp)."""
    if Ncp == 0:
        return tx
    return cplx.concatenate([tx[:, :, -Ncp:], tx], axis=-1)


def strip_cp(rx: C, M: int, Ncp: int, time_offset: int = 0) -> C:
    """(B, T, M+Ncp) -> (B, T, M) sampling at Ncp+time_offset."""
    st = Ncp + time_offset
    return rx[:, :, st:st + M]


def modulate(cfg, z: torch.Tensor, P: C, Winv: C) -> torch.Tensor:
    """Latents z (B, Tz, latent_dim), Tz a whole number of modem frames ->
    packed samples (B, T, 2): QPSK map, one pilot row a modem frame, IDFT,
    CP and the PA tanh (bottleneck 3) (reference: radae.py:482-526).  P and
    Winv: cfg.P and cfg.Winv made by cplx.const."""
    B = z.shape[0]
    n_rs = z.shape[1] * cfg.latent_dim // (cfg.bps * cfg.Nc)
    tx_sym = qpsk_map(z)
    if cfg.bottleneck == 2:
        tx_sym = magnitude_bottleneck(tx_sym)
    tx_sym = insert_pilots(tx_sym.reshape(B, n_rs, cfg.Nc), P,
                           cfg.pilot_gain, cfg.Ns)
    tx = add_cp(idft(tx_sym, Winv), cfg.Ncp).reshape(B, -1)
    if cfg.bottleneck == 3:
        tx = magnitude_bottleneck(tx)
    return cplx.stack_last(tx)


def set_eoo_bits(cfg, eoo_bits) -> np.ndarray:
    """Embed (Ns-1)*Nc QPSK symbols worth of +/-1 bits in the EOO frame.

    Returns a new (1, Nmf+M+Ncp) complex64 EOO frame (reference:
    radae/radae.py:441-455).  Host numpy: the frame is built once and sent
    as it is."""
    Ns, Ncp, M, Nc, Nmf = cfg.Ns, cfg.Ncp, cfg.M, cfg.Nc, cfg.Nmf
    if not Ncp:
        raise ValueError("EOO data needs a cyclic prefix")
    eoo_bits = np.asarray(eoo_bits, dtype=np.float32)
    eoo_syms = (eoo_bits[::2] + 1j * eoo_bits[1::2]).reshape(1, Ns - 1, Nc)
    eoo_tx = eoo_syms @ cfg.Winv
    eoo_tx_cp = np.concatenate([eoo_tx[:, :, -Ncp:], eoo_tx], axis=-1)
    eoo_tx = eoo_tx_cp.reshape(1, (Ns - 1) * (M + Ncp)) * cfg.pilot_gain
    if cfg.bottleneck == 3:
        eoo_tx = np.tanh(np.abs(eoo_tx)) * np.exp(1j * np.angle(eoo_tx))
    eoo = cfg.eoo.copy()
    eoo[0, 2 * (M + Ncp):Nmf] = eoo_tx
    return eoo.astype(np.complex64)
