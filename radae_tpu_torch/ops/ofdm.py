"""OFDM modulation primitives on split-complex planes (port of
`radae_tpu/ops/ofdm.py`).

The Nc<->M carrier transforms are small non-power-of-2 DFT matrices applied
as pairs of real matrix products, batched over streams x symbol rows.
"""

from __future__ import annotations

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
