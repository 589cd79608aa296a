"""Pilot acquisition: coarse time x frequency correlation search, fine
refinement, and in-sync pilot spot checks (a copy of
`radae_tpu/dsp/acquisition.py`: numpy only, the same code; it runs on the
host for the per-frame receiver, `apps/rxe.py`).  The device-side
`ops/acquisition_op.py` serves the batch receiver and makes other
decisions, so it does not stand in for this module.

The reference searches a (t=Nmf) x (f=40) grid with a Python loop of small
matmuls (reference: radae/dsp.py:152-320).  Here the whole grid is one
batched matmul over a strided view — (Nmf, M) @ (M, F).

Detection statistics follow "Pilot Detection over Multiple Frames": the
threshold Dthresh = 2*sigma_r*sqrt(-ln(Pa/5)) derives from Rayleigh noise
stats of the correlator output (reference: dsp.py:217-221).
"""

from __future__ import annotations

import numpy as np


def _frames_view(rx: np.ndarray, n_start: int, M: int) -> np.ndarray:
    """(n_start, M) sliding-window view of rx without copying."""
    return np.lib.stride_tricks.as_strided(
        rx, shape=(n_start, M), strides=(rx.strides[0], rx.strides[0]),
        writeable=False)


class Acquisition:
    def __init__(self, Fs, Rs, M, Ncp, Nmf, p, pend,
                 frange=100, fstep=2.5, Pacq_error1=0.00001, Pacq_error2=0.0001):
        self.Fs = Fs
        self.Rs = Rs
        self.M = M
        self.Ncp = Ncp
        self.Nmf = Nmf
        self.p = np.asarray(p, np.complex64)
        self.pend = np.asarray(pend, np.complex64)
        self.Pacq_error1 = Pacq_error1
        self.Pacq_error2 = Pacq_error2
        self.fcoarse_range = np.arange(-frange / 2, frange / 2, fstep)

        # pilot replicas pre-shifted to each candidate coarse frequency
        f = self.fcoarse_range[None, :]
        n = np.arange(M)[:, None]
        self.p_w = (np.exp(1j * 2 * np.pi * f * n / Fs)
                    * self.p[:, None]).astype(np.complex64)   # (M, F)

        self.sigma_p = np.sqrt(np.dot(np.conj(self.p), self.p).real)
        self.Dtmax12 = 0.0
        self.Dtmax12_eoo = 0.0
        self.Dthresh = 0.0
        self.Dt1 = np.zeros((Nmf, len(self.fcoarse_range)), np.complex64)
        self.Dt2 = np.zeros((Nmf, len(self.fcoarse_range)), np.complex64)
        self._rng = np.random.default_rng(0)

    # -- coarse search (reference: dsp.py:178-231) --------------------------
    def detect_pilots(self, rx: np.ndarray):
        M, Nmf = self.M, self.Nmf
        assert len(rx) == 2 * Nmf + M + self.Ncp

        rxc = np.conj(rx)
        # correlate pilots at the start of this frame and the next: both
        # whole grids as two matmuls
        R1 = _frames_view(rxc, Nmf, M)
        R2 = _frames_view(rxc[Nmf:], Nmf, M)
        Dt1 = R1 @ self.p_w                      # (Nmf, F)
        Dt2 = R2 @ self.p_w
        Dt12 = np.abs(Dt1) + np.abs(Dt2)

        flat = np.argmax(Dt12)
        tmax, f_ind_max = np.unravel_index(flat, Dt12.shape)
        Dtmax12 = Dt12[tmax, f_ind_max]
        fmax = self.fcoarse_range[f_ind_max]

        sigma_r1 = np.mean(np.abs(Dt1)) / np.sqrt(np.pi / 2)
        sigma_r2 = np.mean(np.abs(Dt2)) / np.sqrt(np.pi / 2)
        sigma_r = (sigma_r1 + sigma_r2) / 2.0
        Dthresh = 2 * sigma_r * np.sqrt(-np.log(self.Pacq_error1 / 5.0))

        self.Dt1, self.Dt2 = Dt1, Dt2
        self.Dthresh = Dthresh
        self.Dtmax12 = Dtmax12
        self.f_ind_max = f_ind_max
        return bool(Dtmax12 > Dthresh), int(tmax), float(fmax)

    # -- fine time/freq refinement (reference: dsp.py:233-270) --------------
    def refine(self, rx: np.ndarray, tmax: int, fmax: float,
               tfine_range, ffine_range):
        M, Nmf, Fs = self.M, self.Nmf, self.Fs
        tfine = np.asarray(tfine_range, int)
        ffine = np.asarray(ffine_range, float)

        w = 2 * np.pi * ffine[None, :] / Fs
        n = np.arange(M)[:, None]
        w1 = np.exp(-1j * w * n) * np.conj(self.p)[:, None]         # (M, F)
        w2 = w1 * np.exp(-1j * w * Nmf)

        R1 = np.stack([rx[t:t + M] for t in tfine])                  # (T, M)
        R2 = np.stack([rx[t + Nmf:t + Nmf + M] for t in tfine])
        D = np.abs(R1 @ w1 + R2 @ w2)                                # (T, F)
        t_ind, f_ind = np.unravel_index(np.argmax(D), D.shape)
        if D[t_ind, f_ind] > 0:
            return int(tfine[t_ind]), float(ffine[f_ind])
        return tmax, fmax

    def est_cp_foff(self, rx: np.ndarray, tmax: int, fmax: float,
                    d_skip: int | None = None) -> float:
        """Residual frequency offset (Hz, relative to fmax) from
        cyclic-prefix correlation — an anti-alias discriminator the
        reference lacks.

        refine()'s metric correlates pilots one modem frame (Tmf=120 ms)
        apart, so it has a 1/Tmf = 8.33 Hz ambiguity: under fading the
        sync-entry fine search can lock onto an alias that every
        subsequent pilot check then confirms (the replica is shifted to
        the same wrong frequency).  Each OFDM symbol's CP repeats exactly
        M samples later, so angle(sum conj(cp)*tail) = 2*pi*f*M/Fs
        measures the TRUE offset unambiguously within +-Fs/2M = +-25 Hz.
        The first d_skip samples of each CP are skipped (multipath ISI;
        defaults to Ncp/2, covering the 2 ms MPP path delay).  Uses every
        whole symbol available in the buffer from tmax-Ncp on (~10 at the
        usual tmax) for noise averaging."""
        corr = self.est_cp_corr(rx, tmax, fmax, d_skip)
        return float(np.angle(corr) * self.Fs / (2 * np.pi * self.M))

    def est_cp_corr(self, rx: np.ndarray, tmax: int, fmax: float,
                    d_skip: int | None = None) -> complex:
        """Raw CP correlation phasor for est_cp_foff: angle encodes the
        residual offset, magnitude the signal strength — so an IIR over
        these phasors is naturally fade-weighted (deep-fade frames
        contribute little, instead of injecting noisy angles)."""
        M, Ncp, Fs = self.M, self.Ncp, self.Fs
        if d_skip is None:
            d_skip = Ncp // 2
        corr = 0.0 + 0.0j
        st = tmax - Ncp + d_skip
        while st < 0:                  # tmax < Ncp-d_skip: start one symbol in
            st += M + Ncp
        while st + M + Ncp - d_skip <= len(rx):
            a = rx[st: st + Ncp - d_skip]
            b = rx[st + M: st + M + Ncp - d_skip]
            corr += np.vdot(a, b)                  # sum conj(a)*b
            st += M + Ncp
        return complex(corr * np.exp(-1j * 2 * np.pi * fmax * M / Fs))

    # -- in-sync spot check + EOO detect (reference: dsp.py:273-320) --------
    def check_pilots(self, rx: np.ndarray, tmax: int, fmax: float):
        M, Ncp, Nmf, Fs = self.M, self.Ncp, self.Nmf, self.Fs
        assert len(rx) == 2 * Nmf + M + Ncp

        # refresh 5% of the stats grid so sigma_r tracks evolving noise:
        # gather the sampled windows from the strided view and update them
        # with ONE (Nupdate, M) @ (M, F) matmul — same grid-as-matmul shape
        # as detect_pilots (duplicate rows just write the same value twice)
        rxc = np.conj(rx)
        Nupdate = int(0.05 * self.Dt1.shape[0])
        ts = self._rng.integers(0, Nmf, Nupdate)
        self.Dt1[ts, :] = _frames_view(rxc, Nmf, M)[ts] @ self.p_w
        self.Dt2[ts, :] = _frames_view(rxc[Nmf:], Nmf, M)[ts] @ self.p_w

        sigma_r1 = np.mean(np.abs(self.Dt1)) / np.sqrt(np.pi / 2)
        sigma_r2 = np.mean(np.abs(self.Dt2)) / np.sqrt(np.pi / 2)
        sigma_r = (sigma_r1 + sigma_r2) / 2.0
        Dthresh = 2 * sigma_r * np.sqrt(-np.log(self.Pacq_error2 / 5.0))
        Dthresh_eoo = 2 * sigma_r * np.sqrt(-np.log(self.Pacq_error1 / 5.0))

        w_vec = np.exp(-1j * 2 * np.pi * fmax * np.arange(M) / Fs)
        Dtmax12 = np.abs(np.dot(np.conj(w_vec * rx[tmax:tmax + M]), self.p))
        Dtmax12 += np.abs(np.dot(np.conj(w_vec * rx[tmax + Nmf:tmax + Nmf + M]), self.p))
        valid = Dtmax12 > Dthresh

        Dtmax12_eoo = np.abs(np.dot(
            np.conj(w_vec * rx[tmax + M + Ncp:tmax + 2 * M + Ncp]), self.pend))
        Dtmax12_eoo += np.abs(np.dot(
            np.conj(w_vec * rx[tmax + Nmf:tmax + Nmf + M]), self.pend))
        endofover = Dtmax12_eoo > Dthresh_eoo

        self.Dthresh = Dthresh
        self.Dtmax12 = Dtmax12
        self.Dtmax12_eoo = Dtmax12_eoo
        return bool(valid), bool(endofover)
