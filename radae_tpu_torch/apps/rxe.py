"""Streaming RADAE receiver ("embedded" rx): IQ in, features out (port of
`radae_tpu/apps/rxe.py`).

Full product-path receiver: band-pass filter, pilot acquisition with
search/candidate/sync state machine, timing-slip (nin) handling, frequency
tracking, per-frame OFDM demod + LS pilot EQ, stateful core decoder, and
auxdata unique-word false-sync detection (reference: radae_rxe.py:56-330).

The BPF, the ring buffer, the acquisition and the state machine stay on the
host (numpy): data-dependent control flow on short buffers.  The per-frame
demod (`dsp.streaming.ReceiverOne`) and the decoder run on the device: the
decoder is the hand-written unmerged f32 kernel (`ops.fused_core.
fused_decoder_step` on `decoder_weights`), which on CPU tensors takes its
plain version.  A frame in sync reads two things to the host: the SNR
statistics and the features.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import flagship_config
from ..convert import load_checkpoint, load_torch_checkpoint
from ..data.io import NB_TOTAL_FEATURES
from ..dsp.acquisition import Acquisition
from ..dsp.bpf import ComplexBPF
from ..dsp.streaming import ReceiverOne
from ..ops import fused_core
from ..runtime import f32_device

TUNSYNC_S = 3.0          # hang time before losing sync, rides over fades
UW_ERROR_THRESH = 7      # of 24 aux bits/s; see radae_rxe.py:52-54


class RadaeRx:
    def __init__(self, model_path: str = "", latent_dim: int = 80,
                 auxdata: bool = True, bottleneck: int = 3,
                 bpf_en: bool = True, v: int = 0,
                 disable_unsync: float = 0.0, foff_err: float = 0.0,
                 bypass_dec: bool = False, params=None, device="cuda"):
        self.auxdata = auxdata
        self.bpf_en = bpf_en
        self.v = v
        self.disable_unsync = disable_unsync
        self.foff_err = foff_err
        self._foff_injected = False
        self.bypass_dec = bypass_dec
        self.device = dev = f32_device(device)

        num_features = 21 if auxdata else 20
        self.cfg = flagship_config(feature_dim=num_features,
                                   latent_dim=latent_dim,
                                   bottleneck=bottleneck)
        cfg = self.cfg
        if params is None and model_path and not bypass_dec:
            if model_path.endswith(".pth"):
                params = load_torch_checkpoint(model_path)
            else:
                params, _ = load_checkpoint(model_path)
        # the unmerged f32 decoder kernel's packed weights
        self.weights = (fused_core.decoder_weights(params["decoder"], dev)
                        if params and not bypass_dec else None)
        self.dec_state = None

        M, Ncp, Fs = cfg.M, cfg.Ncp, cfg.Fs
        self.Nmf = cfg.Nmf
        Nmf = self.Nmf

        if bpf_en:
            w = cfg.w
            bw = 1.2 * (w[-1] - w[0]) * Fs / (2 * np.pi)
            centre = (w[-1] + w[0]) * Fs / (2 * np.pi) / 2
            self.bpf = ComplexBPF(101, Fs, bw, centre, Fs)

        self.acq = Acquisition(Fs, cfg.Rs, M, Ncp, Nmf, cfg.p, cfg.pend)
        self.receiver = ReceiverOne(cfg, dev)

        self.n_floats_out = (cfg.Nzmf * cfg.enc_stride * NB_TOTAL_FEATURES
                             if not bypass_dec else cfg.Nzmf * latent_dim)
        self.Nmf_unsync = int(TUNSYNC_S * Fs / Nmf)
        self.synced_count_one_sec = Fs // Nmf

        self.nin = Nmf
        self.state = "search"
        self.tmax = 0
        self.fmax = 0.0
        self.tmax_candidate = 0
        self.mf = 1
        self.valid_count = 0
        self.uw_errors = 0
        self.synced_count = 0
        self.rx_phase = np.complex64(1 + 0j)
        self._fcp_reset()              # CP-discriminator IIR state
        # ring buffer: P DDD P DDD P + Ncp slack for timing slips
        self.rx_buf = np.zeros(2 * Nmf + M + Ncp, np.complex64)

    def _fcp_reset(self):
        """Clear the CP-discriminator IIRs and re-arm their warmup."""
        self.fcp_phasor = 0.0 + 0.0j   # fade-weighted phasor IIR
        self.fcp_mag = 0.0             # |corr| IIR for the coherence gate
        self.fcp_n = 0                 # frames since reset (warmup)

    # -- C-API style getters (reference: radae_rxe.py:134-160) --------------
    def get_n_features_out(self):
        return self.cfg.Nzmf * self.cfg.dec_stride * NB_TOTAL_FEATURES

    def get_n_eoo_features_out(self):
        return self.cfg.Nseoo

    def get_n_floats_out(self):
        return self.n_floats_out

    def get_nin_max(self):
        return self.Nmf + self.cfg.M

    def get_nin(self):
        return self.nin

    def get_sync(self):
        return self.state == "sync"

    def get_snrdB_3k_est(self):
        return int(self.receiver.snrdB_3k_est)

    def get_freq_offset(self):
        return float(self.fmax)

    def sum_uw_errors(self, n):
        self.uw_errors += n

    def get_Neoo_bits(self):
        return self.cfg.Nseoo * self.cfg.bps

    def reset(self):
        self.dec_state = None

    def _decode(self, z_hat: torch.Tensor) -> np.ndarray:
        """z_hat (1, Nzmf, latent_dim) on the device -> features (1, 12, F)
        on the host, through the decoder kernel with its carried state."""
        if self.dec_state is None:
            self.dec_state = fused_core.decoder_state_zero(1, self.device)
        fh, self.dec_state = fused_core.fused_decoder_step(
            self.weights, z_hat, self.dec_state)
        return fh.cpu().numpy()

    # -- per-frame processing (reference: radae_rxe.py:171-330) -------------
    @torch.no_grad()
    def do_radae_rx(self, buffer_complex: np.ndarray, floats_out: np.ndarray) -> int:
        cfg = self.cfg
        M, Ncp, Fs = cfg.M, cfg.Ncp, cfg.Fs
        Nmf = self.Nmf
        acq = self.acq

        prev_state = self.state
        valid_output = False
        endofover = False
        uw_fail = False
        aux_bits = np.zeros(cfg.Nzmf, np.int16)
        z_hat = None

        buffer_complex = buffer_complex[: self.nin]
        if self.bpf_en:
            buffer_complex = self.bpf.bpf(buffer_complex)
        self.rx_buf[:-self.nin] = self.rx_buf[self.nin:]
        self.rx_buf[-self.nin:] = buffer_complex

        if self.state in ("search", "candidate"):
            candidate, self.tmax, self.fmax = acq.detect_pilots(self.rx_buf)
        else:
            # in sync: refine time/freq and spot-check pilots
            ffine = np.arange(self.fmax - 1, self.fmax + 1, 0.1)
            tfine = np.arange(max(0, self.tmax - 8), self.tmax + 8)
            self.tmax, fmax_hat = acq.refine(self.rx_buf, self.tmax,
                                             self.fmax, tfine, ffine)
            self.fmax = 0.9 * self.fmax + 0.1 * fmax_hat
            candidate, endofover = acq.check_pilots(self.rx_buf, self.tmax,
                                                    self.fmax)

            # CP-discriminator guard against pilot-spacing (8.33 Hz)
            # frequency aliases that refine/check_pilots cannot see: IIR
            # over fade-weighted CP correlation phasors; fire only after
            # a warmup so single bad frames cannot derail a good lock.
            # Disabled under the foff_err false-sync test hook, which
            # exists to simulate an uncorrectable false lock.
            if not self._foff_injected:
                corr = acq.est_cp_corr(self.rx_buf, self.tmax, self.fmax)
                self.fcp_phasor = 0.9 * self.fcp_phasor + 0.1 * corr
                self.fcp_mag = 0.9 * self.fcp_mag + 0.1 * abs(corr)
                self.fcp_n += 1
                # coherence gate: during noise-only stretches (deep fades,
                # post-EOO hang time) per-frame angles are random, so the
                # phasor IIR collapses relative to the magnitude IIR —
                # without this gate fmax would random-walk through fades.
                # fcp_n re-arms the warmup after every reset so a single
                # frame can never dominate a freshly-cleared IIR.
                coherent = abs(self.fcp_phasor) > 0.5 * self.fcp_mag
                if self.synced_count >= 8 and self.fcp_n >= 8 and coherent:
                    dfcp = (np.angle(self.fcp_phasor) * Fs
                            / (2 * np.pi * M))
                    if abs(dfcp) > 4.5:
                        self.fmax += dfcp
                        self._fcp_reset()

            # timing slips: rx clock faster/slower than tx clock
            self.nin = Nmf
            if self.tmax >= Nmf - M:
                self.nin = Nmf + M
                self.tmax -= M
            if self.tmax < M:
                self.nin = Nmf - M
                self.tmax += M

            self.synced_count += 1
            if self.synced_count % self.synced_count_one_sec == 0:
                if self.uw_errors > UW_ERROR_THRESH:
                    uw_fail = True
                self.uw_errors = 0

            # freq correction with carried phase
            w = 2 * np.pi * self.fmax / Fs
            n = np.arange(1, Nmf + M + Ncp + 1)
            phase_vec = self.rx_phase * np.exp(-1j * w * n)
            self.rx_phase = phase_vec[-1] / np.abs(phase_vec[-1])
            rx1 = self.rx_buf[self.tmax - Ncp: self.tmax - Ncp + Nmf + M + Ncp]
            rx = (rx1 * phase_vec).astype(np.complex64)

            z_hat = self.receiver.receive(rx, endofover)
            valid_output = not endofover

        if self.v >= 2 or (self.v == 1 and (self.state in ("search", "candidate")
                                            or prev_state == "candidate")):
            print(f"{self.mf:3d} state: {self.state:10s} valid: {candidate:d} "
                  f"{endofover:d} {self.valid_count:2d} "
                  f"Dthresh: {acq.Dthresh:8.2f} Dtmax12: {acq.Dtmax12:8.2f} "
                  f"{acq.Dtmax12_eoo:8.2f} tmax: {self.tmax:4d} "
                  f"fmax: {self.fmax:6.2f} "
                  f"SNRdB: {self.receiver.snrdB_3k_est:5.2f}",
                  file=sys.stderr)

        # -- sync state machine (reference: radae_rxe.py:248-293) -----------
        next_state = self.state
        if self.state == "search":
            if candidate:
                next_state = "candidate"
                self.tmax_candidate = self.tmax
                self.valid_count = 1
        elif self.state == "candidate":
            if candidate and abs(self.tmax - self.tmax_candidate) < Ncp:
                self.valid_count += 1
                if self.valid_count > 3:
                    next_state = "sync"
                    self.dec_state = None            # reset stateful decoder
                    self.synced_count = 0
                    uw_fail = False
                    self.uw_errors = 0
                    self.valid_count = self.Nmf_unsync
                    ffine = np.arange(self.fmax - 10, self.fmax + 10, 0.25)
                    tfine = np.arange(max(0, self.tmax - 1), self.tmax + 2)
                    self.tmax, self.fmax = acq.refine(self.rx_buf, self.tmax,
                                                      self.fmax, tfine, ffine)
                    self._fcp_reset()
                    self.fmax += self.foff_err       # false-sync test hook
                    self._foff_injected = self.foff_err != 0.0
                    self.foff_err = 0.0
            else:
                next_state = "search"
        elif self.state == "sync":
            unsync_enable = True
            if self.disable_unsync:
                if self.synced_count > int(self.disable_unsync * Fs / Nmf):
                    unsync_enable = False
            if candidate:
                self.valid_count = self.Nmf_unsync
            else:
                self.valid_count -= 1
                if unsync_enable and self.valid_count == 0:
                    next_state = "search"
            if unsync_enable and (endofover or uw_fail):
                next_state = "search"

        self.state = next_state
        if self.state == "search":
            self.nin = Nmf
        self.mf += 1

        # -- decode (end of pipeline, mirrors external C decoder timing) ----
        if valid_output:
            if not self.bypass_dec:
                fh = self._decode(z_hat)
                if self.auxdata:
                    aux_symb = fh[:, :, 20]
                    aux_bits = (aux_symb[0, ::4] > 0).astype(np.int16)
                    fh = fh[:, :, :20]
                    self.sum_uw_errors(int(aux_bits.sum()))
                out = np.zeros((fh.shape[1], NB_TOTAL_FEATURES), np.float32)
                out[:, :20] = fh[0]
                np.copyto(floats_out, out.flatten())
            else:
                np.copyto(floats_out, z_hat.cpu().numpy().flatten())

        if endofover:
            zf = z_hat.cpu().numpy().flatten()
            np.copyto(floats_out,
                      np.concatenate([zf, np.zeros(len(floats_out) - len(zf),
                                                   np.float32)]))

        return int(valid_output) | (int(endofover) << 1)


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="RADAE streaming receiver: IQ.f32 on stdin, features.f32 on stdout")
    parser.add_argument("--model_name", type=str, default="")
    parser.add_argument("--noauxdata", dest="auxdata", action="store_false")
    parser.add_argument("-v", type=int, default=2)
    parser.add_argument("--disable_unsync", type=float, default=0.0)
    parser.add_argument("--no_stdout", action="store_false", dest="use_stdout")
    parser.add_argument("--foff_err", type=float, default=0.0)
    parser.add_argument("--bypass_dec", action="store_true")
    parser.add_argument("--eoo_data_test", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "decoder kernel's plain version on the host)")
    parser.set_defaults(auxdata=True, use_stdout=True)
    args = parser.parse_args(argv)

    rx = RadaeRx(model_path=args.model_name, auxdata=args.auxdata, v=args.v,
                 disable_unsync=args.disable_unsync, foff_err=args.foff_err,
                 bypass_dec=args.bypass_dec, device=args.device)
    floats_out = np.zeros(rx.get_n_floats_out(), np.float32)
    while True:
        buf = sys.stdin.buffer.read(rx.get_nin() * 8)
        if len(buf) != rx.get_nin() * 8:
            break
        ret = rx.do_radae_rx(np.frombuffer(buf, np.complex64), floats_out)
        if (ret & 1) and args.use_stdout:
            sys.stdout.buffer.write(floats_out.tobytes())
        if (ret & 2) and args.eoo_data_test:
            rng = np.random.default_rng(65647)
            tx_bits = np.sign(rng.random(rx.get_Neoo_bits()) - 0.5)
            n_bits = len(tx_bits)
            n_errors = int(np.sum(floats_out[:n_bits] * tx_bits < 0))
            ber = n_errors / n_bits
            print(f"EOO data n_bits: {n_bits} n_errors: {n_errors} "
                  f"BER: {ber:5.2f}", file=sys.stderr)
            if ber < 0.05:
                print("PASS", file=sys.stderr)
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
