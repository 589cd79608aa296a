"""Batched pilot acquisition as matrix products (port of
`radae_tpu/ops/acquisition_op.py`).

The coarse search correlates the received buffer against frequency-shifted
pilot replicas over a (time = Nmf) x (frequency = 40) grid, for many
streams at once:

    D[t, f] = | conj(rx[t : t+M]) @ p_w[:, f] |

with the (B, Nt, M) sliding windows built by indexing, so the grid is a
(B*Nt, M) @ (M, F) product left to torch.matmul (radae_tpu leaves it to
XLA outside any Pallas kernel).  Split-complex throughout.  Each factory
takes a `device` (default "cuda") for its constants; the functions it
returns run on the device of their inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from . import cplx

# radae_tpu's acquisition settings: the coarse grid spans FRANGE Hz in FSTEP
# Hz steps with a false-acquisition probability PACQ_ERROR1; the windowed
# detector acquires after min(CONSEC, n_windows) consecutive hits (the
# original uses 4, a parity target here) and correlates the time grid every
# TSTRIDE samples; refine searches +-T_HALF samples and +-F_HALF Hz in
# F_STEP steps
FRANGE, FSTEP, PACQ_ERROR1 = 100.0, 2.5, 1e-5
CONSEC, TSTRIDE = 3, 2
T_HALF, F_HALF, F_STEP = 2, 2.0, 0.25


def _pilot_replicas(cfg, dev):
    """Shared coarse-search setup: freq-shifted pilot replicas (M, F)
    split-complex, the coarse frequency axis, and the Rayleigh threshold
    multiplier 2*sqrt(-ln(Pa/5)) (reference: dsp.py:217-221)."""
    fcoarse = np.arange(-FRANGE / 2, FRANGE / 2, FSTEP)
    n = np.arange(cfg.M)[:, None]
    p_w = (np.exp(1j * 2 * np.pi * fcoarse[None, :] * n / cfg.Fs)
           * cfg.p[:, None])
    PW = cplx.const(p_w, dev)
    thresh_k = float(2.0 * np.sqrt(-np.log(PACQ_ERROR1 / 5.0)))
    return fcoarse, PW, thresh_k


def _corr(wr, wi, PW):
    """|conj(w) @ p_w| of windows (..., M) against the replicas (M, F)."""
    Dr = wr @ PW.re + wi @ PW.im
    Di = wr @ PW.im - wi @ PW.re
    return torch.sqrt(Dr * Dr + Di * Di)


def make_detect_pilots(cfg, device="cuda"):
    """Batched one-shot detector.

    detect(rx_packed (B, 2*Nmf+M+Ncp, 2)) ->
        (candidate (B,) bool, tmax (B,) int32, fmax (B,) float32,
         Dthresh (B,), Dtmax (B,))
    """
    dev = resolve_device(device)
    M, Nmf = cfg.M, cfg.Nmf
    fcoarse, PW, thresh_k = _pilot_replicas(cfg, dev)
    F = len(fcoarse)
    fvec = torch.as_tensor(fcoarse, dtype=torch.float32, device=dev)
    win_idx = torch.as_tensor(np.arange(Nmf)[:, None] + np.arange(M)[None, :],
                              device=dev)

    def grid(rx, offset):
        """|corr| grid (B, Nmf, F) for windows starting at offset."""
        wr = rx.re[:, offset:offset + Nmf + M - 1][:, win_idx]   # (B,Nmf,M)
        wi = rx.im[:, offset:offset + Nmf + M - 1][:, win_idx]
        return _corr(wr, wi, PW)

    def detect(rx_packed):
        rx = cplx.from_last(rx_packed)
        D1 = grid(rx, 0)                     # pilots at frame start
        D2 = grid(rx, Nmf)                   # pilots one frame later
        flat = (D1 + D2).reshape(D1.shape[0], -1)
        amax = torch.argmax(flat, dim=1)
        tmax = (amax // F).to(torch.int32)
        fmax = fvec[amax % F]
        Dtmax = torch.gather(flat, 1, amax[:, None])[:, 0]
        sigma_r = 0.5 * (D1.mean(dim=(1, 2)) + D2.mean(dim=(1, 2))) \
            / np.sqrt(np.pi / 2)
        Dthresh = thresh_k * sigma_r
        return Dtmax > Dthresh, tmax, fmax, Dthresh, Dtmax

    return detect


def make_detect_pilots_windowed(cfg, n_windows: int, device="cuda"):
    """Windowed-retry batched detector: the product receiver's
    search -> candidate -> acquired state machine (acquire after
    min(CONSEC, n_windows) consecutive above-threshold detections whose
    timing agrees within max(round(0.02*M), TSTRIDE + 2) samples,
    reference: rx.py:146-199), over n_windows
    successive 2-frame windows (window k = frames k, k+1).  Each frame's
    grid is computed once and shared by the two windows that use it: a
    loop over the windows carries grid k while computing grid k+1, with
    the same state radae_tpu's scan carries.

    detect(rx_packed (B, T, 2)), T >= (n_windows+1)*Nmf + M + Ncp ->
        (candidate (B,) bool   -- acquired (consec stable hits),
         tmax (B,) int32       -- absolute sample index of the pilot
                                  (best-effort argmax if no hit),
         fmax (B,) float32,
         win (B,) int32        -- acquiring window (n_windows if none),
         Dthresh (B,) float32) -- threshold from the mean sigma_r over
                                  the windows that are not all zero
    """
    dev = resolve_device(device)
    M, Nmf = cfg.M, cfg.Nmf
    consec = min(CONSEC, n_windows)
    t_match_tol = max(int(round(0.02 * M)), TSTRIDE + 2)
    fcoarse, PW, thresh_k = _pilot_replicas(cfg, dev)
    F = len(fcoarse)
    fvec = torch.as_tensor(fcoarse, dtype=torch.float32, device=dev)
    toff = np.arange(0, Nmf, TSTRIDE)
    win_idx = torch.as_tensor(toff[:, None] + np.arange(M)[None, :],
                              device=dev)

    def grid_at(xr, xi, off):
        """|corr| grid (B, Nt, F) for windows starting at sample off."""
        sr = xr[:, off:off + Nmf + M - 1]
        si = xi[:, off:off + Nmf + M - 1]
        return _corr(sr[:, win_idx], si[:, win_idx], PW)

    def detect(rx_packed):
        B = rx_packed.shape[0]
        if rx_packed.shape[1] < (n_windows + 1) * Nmf + M:
            raise ValueError(f"{rx_packed.shape[1]} samples are fewer than "
                             f"{n_windows} acquisition windows need")
        d = rx_packed.device
        xr, xi = rx_packed[..., 0], rx_packed[..., 1]
        G_prev = grid_at(xr, xi, 0)
        zi = torch.zeros((B,), dtype=torch.int64, device=d)
        zf = torch.zeros((B,), dtype=torch.float32, device=d)
        found = torch.zeros((B,), dtype=torch.bool, device=d)
        tmax, fmax = zi, zf
        win = torch.full((B,), n_windows, dtype=torch.int64, device=d)
        count, t_prev = zi, torch.full((B,), -10 * Nmf, dtype=torch.int64,
                                       device=d)
        bD, bt, bf = torch.full((B,), -1.0, device=d), zi, zf
        sig_sum, sig_n = zf, zf
        for k in range(n_windows):
            G_next = grid_at(xr, xi, (k + 1) * Nmf)
            flat = (G_prev + G_next).reshape(B, -1)
            amax = torch.argmax(flat, dim=1)
            t_rel = TSTRIDE * (amax // F)                  # within-frame
            t_k = k * Nmf + t_rel                          # absolute
            f_k = fvec[amax % F]
            D_k = torch.gather(flat, 1, amax[:, None])[:, 0]
            sigma_k = 0.5 * (G_prev.mean(dim=(1, 2))
                             + G_next.mean(dim=(1, 2))) / np.sqrt(np.pi / 2)
            cand_k = D_k > thresh_k * sigma_k
            # consecutive hits must agree in within-frame timing, wrap-aware
            dt_ = torch.abs(t_rel - t_prev)
            agree = torch.minimum(dt_, Nmf - dt_) <= t_match_tol
            count = torch.where(cand_k & agree, count + 1,
                                torch.where(cand_k, 1, 0))
            t_prev = torch.where(cand_k, t_rel, t_prev)
            hit = ~found & (count >= consec)
            tmax = torch.where(hit, t_k, tmax)
            fmax = torch.where(hit, f_k, fmax)
            win = torch.where(hit, k, win)
            found = found | hit
            better = D_k > bD
            bD = torch.where(better, D_k, bD)
            bt = torch.where(better, t_k, bt)
            bf = torch.where(better, f_k, bf)
            # all-zero windows (zero-padded short overs) stay out of the
            # sigma average, which sets the end-of-over threshold
            nz_ = sigma_k > 0.0
            sig_sum = sig_sum + torch.where(nz_, sigma_k, 0.0)
            sig_n = sig_n + nz_.to(torch.float32)
            G_prev = G_next
        tmax = torch.where(found, tmax, bt).to(torch.int32)
        fmax = torch.where(found, fmax, bf)
        Dthresh = thresh_k * sig_sum / torch.clamp(sig_n, min=1.0)
        return found, tmax, fmax, win.to(torch.int32), Dthresh

    return detect


def make_refine(cfg, device="cuda"):
    """Batched fine time/frequency refinement around a coarse peak (the
    product path's acquisition.refine, reference: dsp.py:233-270): a
    +-T_HALF sample, +-F_HALF Hz grid in F_STEP steps, with the per-row
    frequency shift factored as exp(-i 2 pi (fmax+df) ...) = per-row(fmax)
    * static(df).

    refine(xr, xi (B, T), tmax (B,) int, fmax (B,) f32) -> (tmax, fmax)."""
    dev = resolve_device(device)
    M, Nmf, Fs = cfg.M, cfg.Nmf, cfg.Fs
    dts = np.arange(-T_HALF, T_HALF + 1, dtype=np.int32)
    dfs = np.arange(-F_HALF, F_HALF + F_STEP / 2, F_STEP, dtype=np.float32)
    nt, nf = len(dts), len(dfs)
    n = np.arange(M, dtype=np.float32)

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x), device=dev)

    cp_r = t(np.asarray(cfg.p.real, np.float32))            # conj(p)
    cp_i = t(np.asarray(-cfg.p.imag, np.float32))
    ang = -2.0 * np.pi * n[:, None] * dfs[None, :] / Fs     # (M, nf)
    Fr, Fi = t(np.cos(ang)), t(np.sin(ang))
    a2 = -2.0 * np.pi * dfs * Nmf / Fs                      # (nf,)
    g2r, g2i = t(np.cos(a2)), t(np.sin(a2))
    narr, dts_t, dfs_t = t(n), t(dts), t(dfs)
    blk = M + 2 * T_HALF

    def windows(x, idx):
        b = torch.gather(x, 1, idx)                          # (B, blk)
        return torch.stack([b[:, d:d + M] for d in range(nt)], dim=1)

    def refine(xr, xi, tmax, fmax):
        T = xr.shape[1]
        ar = torch.arange(blk, device=xr.device)[None, :]
        idxb = torch.clamp(tmax[:, None].long() - T_HALF + ar, 0, T - 1)
        idx2 = torch.clamp(idxb + Nmf, 0, T - 1)
        R1r, R1i = windows(xr, idxb), windows(xi, idxb)      # (B, nt, M)
        R2r, R2i = windows(xr, idx2), windows(xi, idx2)
        th = (-2.0 * np.pi / Fs) * fmax[:, None] * narr[None, :]
        Ar, Ai = torch.cos(th), torch.sin(th)
        Wr = Ar * cp_r[None, :] - Ai * cp_i[None, :]
        Wi = Ar * cp_i[None, :] + Ai * cp_r[None, :]
        Q1r = R1r * Wr[:, None, :] - R1i * Wi[:, None, :]
        Q1i = R1r * Wi[:, None, :] + R1i * Wr[:, None, :]
        Q2r = R2r * Wr[:, None, :] - R2i * Wi[:, None, :]
        Q2i = R2r * Wi[:, None, :] + R2i * Wr[:, None, :]
        D1r, D1i = Q1r @ Fr - Q1i @ Fi, Q1r @ Fi + Q1i @ Fr  # (B, nt, nf)
        D2r, D2i = Q2r @ Fr - Q2i @ Fi, Q2r @ Fi + Q2i @ Fr
        phb = (-2.0 * np.pi * Nmf / Fs) * fmax               # (B,)
        cb, sb = torch.cos(phb), torch.sin(phb)
        c2r = cb[:, None] * g2r[None, :] - sb[:, None] * g2i[None, :]
        c2i = cb[:, None] * g2i[None, :] + sb[:, None] * g2r[None, :]
        Dr = D1r + c2r[:, None, :] * D2r - c2i[:, None, :] * D2i
        Di = D1i + c2r[:, None, :] * D2i + c2i[:, None, :] * D2r
        D = (Dr * Dr + Di * Di).reshape(xr.shape[0], -1)
        amax = torch.argmax(D, dim=1)
        return tmax + dts_t[amax // nf], fmax + dfs_t[amax % nf]

    return refine
