"""Single-modem-frame streaming transmitter and receiver (port of
`radae_tpu/dsp/streaming.py`).

These process one 120 ms modem frame at a time on the device, in
split-complex planes (ops/cplx.py).  Mirrors the reference's
transmitter_one / receiver_one (reference: radae/dsp.py:323-526) including
the embedded SNR estimator with a straight-line calibration refit on this
pipeline and ~1 s IIR smoothing (dsp.py:437-456).

Samples cross the host boundary as numpy complex64, packed to and from
interleaved (..., 2) float tensors (`cplx.from_c64`, `cplx.to_c64`).  The
receiver's latents stay on the device for the decoder; its SNR statistics
come to the host once a frame.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import calibration
from ..ops import cplx, ofdm
from ..ops import pilots as pilots_ops
from ..ops.cplx import C
from ..runtime import f32_device


class TransmitterOne:
    """z latents for one modem frame -> Nmf rate-Fs samples."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = f32_device(device)
        self._Winv = cplx.const(cfg.Winv, self.device)
        self._P = cplx.const(cfg.P, self.device)

    def modulate(self, z: torch.Tensor) -> torch.Tensor:
        """z (1, Nzmf, latent_dim) on the device -> packed (1, Nmf, 2)."""
        return ofdm.modulate(self.cfg, z, self._P, self._Winv)

    def transmit(self, z) -> np.ndarray:
        """z: (1, Nzmf, latent_dim) host array -> (Nmf,) complex64 numpy."""
        z = torch.as_tensor(np.array(z, np.float32), device=self.device)
        return cplx.to_c64(self.modulate(z)).flatten()


class ReceiverOne:
    """One modem frame of rate-Fs samples -> z_hat latents.

    Expects P DDDD P framing: the pilot of this frame plus the pilot of the
    next frame, Ns+2 OFDM symbols in total."""

    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        dev = self.device = f32_device(device)
        self._Wfwd = cplx.const(cfg.Wfwd, dev)
        self._ls = pilots_ops.ls_consts(cfg.P, cfg.w, cfg.Fs, dev)
        self._invP = cplx.const((1.0 / cfg.P).astype(np.complex64), dev)
        self._invPend = cplx.const((1.0 / cfg.Pend).astype(np.complex64), dev)
        self._steps = torch.arange(1, cfg.Ns + 1, dtype=torch.float32,
                                   device=dev)[None, :, None]
        self.snrdB_3k_est = 0.0
        # straight-line SNR correction refit on this pipeline (the analog of
        # the reference's empirical fit, dsp.py:415-416)
        self.m = calibration.SNR_CAL_M
        self.c = calibration.SNR_CAL_C

    def _demod(self, rx: C) -> C:
        cfg = self.cfg
        n_rs = rx.shape[0] // (cfg.M + cfg.Ncp)
        rx = rx.reshape(1, n_rs, cfg.M + cfg.Ncp)
        rx_dash = ofdm.strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset)
        return ofdm.dft(rx_dash, self._Wfwd)        # (1, Ns+2, Nc)

    def _rx(self, rx_packed: torch.Tensor):
        """A normal PDDDDP frame, packed (Nmf+M+Ncp, 2) -> (z_hat (1, Nzmf,
        latent_dim), the SNR statistics [S1, S2]), both on the device."""
        cfg = self.cfg
        Ns = cfg.Ns
        rx_sym = self._demod(cplx.from_last(rx_packed))  # (1, Ns+2, Nc)
        # LS channel estimate from the two pilot rows (0 and Ns+1)
        rx_pilots = pilots_ops.est_pilots_ls(rx_sym[:, [0, Ns + 1], :],
                                             self._ls)   # (1, 2, Nc)

        # SNR estimator statistics from the first pilot row (dsp.py:437-446):
        # rotate received pilots by -phase(est) and compare I/Q powers
        Pcn_hat = rx_sym[0, 0, :]
        Rcn_hat = Pcn_hat * rx_pilots[0, 0, :].unit().conj()
        S1 = torch.sum(Pcn_hat.abs2())
        S2 = torch.sum(Rcn_hat.im ** 2) + 1e-12

        # linear phase interpolation between the two pilots
        slope = (rx_pilots[:, 1, :] - rx_pilots[:, 0, :]) * (1.0 / (Ns + 1))
        rx_ch = rx_pilots[:, None, 0, :] + slope[:, None, :] * self._steps
        data = rx_sym[:, 1:Ns + 1, :] * rx_ch.unit().conj()

        if cfg.coarse_mag:
            mag = torch.sqrt(rx_pilots.abs2().mean()) + 1e-6
            if cfg.bottleneck == 3:
                mag = mag * float(np.abs(cfg.P[0])) / cfg.pilot_gain
            data = data * (1.0 / mag)

        z_hat = ofdm.qpsk_demap(data.reshape(1, -1, cfg.latent_dim // 2))
        return (z_hat.reshape(1, cfg.Nzmf, cfg.latent_dim),
                torch.stack([S1, S2]))

    def _rx_eoo(self, rx_packed: torch.Tensor) -> torch.Tensor:
        """EOO frame P E D..D E: simple per-carrier mean-phase EQ, returns
        the soft data symbols (1, 2*(Ns-1)*Nc) on the device (reference:
        dsp.py:513-524)."""
        Ns = self.cfg.Ns + 1
        rx_sym = self._demod(cplx.from_last(rx_packed))  # (1, Ns+1, Nc)
        s = (cplx.mul_const(rx_sym[0, 0, :], self._invP)
             + cplx.mul_const(rx_sym[0, 1, :], self._invPend)
             + cplx.mul_const(rx_sym[0, Ns, :], self._invPend))   # (Nc,)
        rot = s.unit().conj()
        eq = rx_sym[0] * C(rot.re[None, :], rot.im[None, :])
        return ofdm.qpsk_demap(eq[2:Ns, :].reshape(1, -1))

    def _update_snr(self, S1: float, S2: float):
        cfg = self.cfg
        snr_est = S1 / (2.0 * S2) - 1.0
        if snr_est <= 0:
            snr_est = 0.1
        snrdB_est = 10 * math.log10(snr_est)
        snrdB_est = (snrdB_est - self.c) / self.m
        Rs = cfg.Fs / cfg.M
        snrdB_3k = (snrdB_est + 10 * math.log10(Rs * cfg.Nc / 3000)
                    + 10 * math.log10((cfg.M + cfg.Ncp) / cfg.M))
        self.snrdB_3k_est = 0.9 * self.snrdB_3k_est + 0.1 * snrdB_3k

    def receive(self, rx, endofover: bool = False) -> torch.Tensor:
        """rx: (Nmf + M + Ncp,) complex64 numpy -> z_hat (1, Nzmf,
        latent_dim) on the device, or the EOO soft bits when endofover.
        A normal frame reads its two SNR statistics to the host."""
        packed = cplx.from_c64(rx, self.device)
        if endofover:
            return self._rx_eoo(packed)
        z_hat, stats = self._rx(packed)
        S1, S2 = stats.tolist()
        self._update_snr(S1, S2)
        return z_hat
