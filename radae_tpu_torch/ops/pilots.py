"""Pilot-based channel estimation and equalisation on split-complex planes
(port of `radae_tpu/ops/pilots.py`).

The estimators (3-pilot mean and least squares) are gathers + batched
per-carrier products over the whole (batch, frame, carrier) grid
(reference: radae/radae.py:312-384).  Phase-only EQ multiplies by
conj(h)/|h| instead of exp(-j*angle(h)).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import cplx
from .cplx import C

LOCAL_PATH_DELAY_S = 0.0025   # assumed path delay for the LS fit (radae.py:338)


def window3_index(Nc: int) -> np.ndarray:
    """(Nc, 3) gather indices: carriers c-1..c+1 with edges clamped inward
    (the reference's "wingman pilot" edge handling, radae.py:333-337)."""
    mid = np.clip(np.arange(Nc), 1, Nc - 2)
    return np.stack([mid - 1, mid, mid + 1], axis=1)


def ls_pmat(w: np.ndarray, Fs: int) -> np.ndarray:
    """Per-carrier 3-pilot least-squares projection matrices, (Nc, 2, 3),
    for the 2-ray channel h(w) = g0 + g1*exp(-j*w*a) (host numpy;
    reference: radae.py:331-344, dsp.py:400-412)."""
    Nc = len(w)
    a = LOCAL_PATH_DELAY_S * Fs
    mid = np.clip(np.arange(Nc), 1, Nc - 2)
    Pmat = np.zeros((Nc, 2, 3), dtype=np.complex64)
    for c in range(Nc):
        m = mid[c]
        A = np.array([[1, np.exp(-1j * w[m - 1] * a)],
                      [1, np.exp(-1j * w[m] * a)],
                      [1, np.exp(-1j * w[m + 1] * a)]])
        Pmat[c] = np.linalg.inv(A.conj().T @ A) @ A.conj().T
    return Pmat


class LSConsts(NamedTuple):
    """Device constants of `est_pilots_ls`, made once by `ls_consts`."""
    invP: C              # (Nc,) 1 / known pilot
    idx: torch.Tensor    # (Nc, 3) int64 window gather
    Pmat: C              # (Nc, 2, 3)
    phase: C             # (Nc,) exp(-j w a)


def ls_consts(P, w, Fs, device) -> LSConsts:
    a = LOCAL_PATH_DELAY_S * Fs
    return LSConsts(
        invP=cplx.const((1.0 / np.asarray(P)).astype(np.complex64), device),
        idx=torch.as_tensor(window3_index(len(w)), device=device),
        Pmat=cplx.const(ls_pmat(np.asarray(w), Fs), device),
        phase=cplx.const(np.exp(-1j * np.asarray(w) * a).astype(np.complex64),
                         device))


def est_pilots_ls(pilot_rows: C, k: LSConsts) -> C:
    """3-pilot least-squares fit across frequency.

    pilot_rows: (..., Nc) received pilot symbols.  Returns (..., Nc) channel
    estimates h_c = g0 + g1*exp(-j*w_c*a) (reference: radae.py:331-344)."""
    ratio = cplx.mul_const(pilot_rows, k.invP)                 # rx / P
    h = C(ratio.re[..., k.idx], ratio.im[..., k.idx])          # (..., Nc, 3)
    Pr, Pi = k.Pmat
    g = C(torch.einsum("cij,...cj->...ci", Pr, h.re)
          - torch.einsum("cij,...cj->...ci", Pi, h.im),
          torch.einsum("cij,...cj->...ci", Pr, h.im)
          + torch.einsum("cij,...cj->...ci", Pi, h.re))        # (..., Nc, 2)
    return g[..., 0] + cplx.mul_const(g[..., 1], k.phase)


def _ratio_to_P(pilot_rows: C, k: LSConsts) -> C:
    """received pilot / known pilot, through the precomputed 1/P."""
    return cplx.mul_const(pilot_rows, k.invP)


def est_pilots_mean3(pilot_rows: C, k: LSConsts) -> C:
    """3-pilot local mean across frequency (the eq_mean6 estimator):
    (..., Nc) received pilot symbols -> (..., Nc) channel estimates
    (reference: radae.py:321-328)."""
    ratio = _ratio_to_P(pilot_rows, k)
    return C(ratio.re[..., k.idx].mean(dim=-1),
             ratio.im[..., k.idx].mean(dim=-1))


def interp_pilot_eq(rx_sym_pilots: C, rx_pilots: C, Ns: int,
                    phase_mag_eq: bool = False) -> C:
    """Linearly interpolate the pilot channel estimates across each frame
    and equalise the data symbols.

    rx_sym_pilots: (B, nmf, Ns+1, Nc) with the pilot in row 0; rx_pilots:
    (B, nmf, Nc) estimates per frame.  Frames 0..nmf-2 interpolate toward
    the next frame's pilot; the last frame extrapolates with the previous
    slope (reference: radae.py:351-370)."""
    nmf = rx_sym_pilots.shape[1]
    if nmf > 1:
        slopes = (rx_pilots[:, 1:] - rx_pilots[:, :-1]) * (1.0 / (Ns + 1))
        slopes = cplx.concatenate([slopes, slopes[:, -1:]], axis=1)
    else:
        slopes = rx_pilots * 0.0
    steps = torch.arange(1, Ns + 1, dtype=torch.float32,
                         device=rx_pilots.re.device)[None, None, :, None]
    rx_ch = rx_pilots[:, :, None, :] + slopes[:, :, None, :] * steps
    data = rx_sym_pilots[:, :, 1:Ns + 1, :]
    if phase_mag_eq:
        data = data / rx_ch
    else:
        data = data * rx_ch.unit().conj()
    return cplx.concatenate([rx_sym_pilots[:, :, :1, :], data], axis=2)


def coarse_mag_correction(rx_sym_pilots: C, rx_pilots: C, P0_abs, pilot_gain,
                          bottleneck):
    """Scale the symbols by the RMS pilot magnitude of each batch row, over
    all its frames (reference: radae.py:376-382).  Returns (symbols, mag)."""
    mag = torch.sqrt(rx_pilots.abs2().mean(dim=(1, 2)))          # (B,)
    if bottleneck == 3:
        mag = mag * P0_abs / pilot_gain
    return rx_sym_pilots * (1.0 / mag)[:, None, None, None], mag


def pilot_eq(cfg, rx_sym_pilots: C, k: LSConsts) -> C:
    """The whole pilot EQ pass over (B, nmf, Ns+1, Nc) symbols: the 3-pilot
    mean or least-squares estimator per carrier (or the carriers' mean when
    cfg.per_carrier_eq is False), interpolation + EQ, and the coarse
    magnitude correction, as RADAE.do_pilot_eq (reference:
    radae.py:312-384).  k: ls_consts(cfg.P, cfg.w, cfg.Fs, device)."""
    pilot_rows = rx_sym_pilots[:, :, 0, :]                       # (B,nmf,Nc)
    if cfg.per_carrier_eq:
        rx_pilots = (est_pilots_mean3(pilot_rows, k) if cfg.eq_mean6
                     else est_pilots_ls(pilot_rows, k))
    else:
        ratio = _ratio_to_P(pilot_rows, k)
        rx_pilots = C(ratio.re.mean(dim=-1, keepdim=True).expand_as(ratio.re),
                      ratio.im.mean(dim=-1, keepdim=True).expand_as(ratio.im))
    rx_sym_pilots = interp_pilot_eq(rx_sym_pilots, rx_pilots, cfg.Ns,
                                    cfg.phase_mag_eq)
    if cfg.coarse_mag:
        rx_sym_pilots, _ = coarse_mag_correction(
            rx_sym_pilots, rx_pilots, float(np.abs(cfg.P[0])),
            cfg.pilot_gain, cfg.bottleneck)
    return rx_sym_pilots
