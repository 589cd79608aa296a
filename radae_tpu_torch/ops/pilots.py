"""Least-squares pilot channel estimation on split-complex planes (port of
the LS path of `radae_tpu/ops/pilots.py`).

The estimator is a gather + a batched per-carrier 2x3 projection over the
whole (batch, frame, carrier) grid (reference: radae/radae.py:331-344).
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
