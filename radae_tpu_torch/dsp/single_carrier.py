"""Single-carrier PSK modem for the baseband-FM (BBFM) path (a copy of
`radae_tpu/dsp/single_carrier.py` on the port's `dsp/rrc.py` and
`dsp/bpf.py`: numpy only, the same code).

Streams BBFM latents over a DC-coupled or band-pass FM channel: RRC
pulse shaping, P25 frame-sync word, envelope-DFT fine timing with an
nin timing-slip mechanism, modulation-stripped windowed phase estimation
with cycle-slip tracking, and a search/sync state machine keyed on the
normalised frame-sync correlation (reference: radae/dsp.py:579-961).
Host-side numpy: frame-rate streaming DSP.
"""

from __future__ import annotations

import math

import numpy as np

from .rrc import gen_rn_coeffs, sample_clock_offset
from .bpf import ComplexBPF

# fixed RNG seed shared between separate tx and rx processes for BER testing
# (reference: dsp.py:635-636)
BER_TEST_SEED = 65647437836358831880808032086803839626

P25_FRAME_SYNC = np.array(
    [1, 1, 1, 1, 1, -1, 1, 1, -1, -1, 1, 1, -1, -1, -1, -1,
     1, -1, 1, -1, -1, -1, -1, -1], dtype=np.complex64)


class SingleCarrier:
    def __init__(self, Rs=2400, Fs=9600, fcentreHz=0, alpha=0.25):
        self.fcentreHz = fcentreHz
        self.alpha = alpha
        self.Fs = Fs
        self.T = 1 / Fs
        self.Rs = Rs
        self.Nfilt_sym = 6
        self.M = int(Fs / Rs)
        assert self.M == Fs / Rs, "Fs must be an integer multiple of Rs"
        self.lo_omega_rect = np.exp(1j * 2 * np.pi * fcentreHz / Fs)

        self.p25_frame_sync = P25_FRAME_SYNC
        self.Nsync_syms = 16
        self.Nframe_syms = 96
        self.Npayload_syms = self.Nframe_syms - self.Nsync_syms
        p = self.p25_frame_sync[:self.Nsync_syms]
        self.p_scale = np.dot(p, p) / np.sqrt(np.dot(p, p))
        self.sync_thresh = 0.5
        self.unsync_thresh1 = 2
        self.unsync_thresh2 = 3

        self.rrc = gen_rn_coeffs(alpha, self.T, Rs, self.Nfilt_sym, self.M)
        self.Ntap = len(self.rrc)
        self.tx_filt_mem = np.zeros(self.Ntap, np.complex64)
        self.rx_filt_mem = np.zeros(self.Ntap, np.complex64)
        self.rx_filt_out = np.zeros((self.Nframe_syms + 2) * self.M, np.complex64)

        self.sample_point = 5
        self.nin = self.Nframe_syms * self.M
        self.rx_symb_buf = np.zeros(2 * self.Nframe_syms, np.complex64)

        self.Nphase = 21                     # phase-est window (odd)
        self.phase_est_fine = 0.0
        self.phase_est_coarse = 0.0
        self.phase_est_mem = np.zeros(self.Nphase, np.complex64)
        self.phase_est_log = np.zeros(self.Nframe_syms, np.complex64)
        self.phase_ambiguity = 0.0

        self.tx_lo_phase_rect = np.complex64(1)
        self.rx_lo_phase_rect = np.complex64(1)

        self.state = "search"
        self.fs_s = 0
        self.g = 1.0
        self.norm_rx_timing = 0.0
        self.max_Cs = np.complex64(0)

        # 4x-oversampling filter for clock-offset simulation in run_test
        self.lpf = ComplexBPF(101, Fs * 4, Fs, 0, Fs * 40)
        self.rng = np.random.default_rng(BER_TEST_SEED)

    # -- transmitter --------------------------------------------------------
    def tx(self, tx_symbs: np.ndarray) -> np.ndarray:
        """80 payload symbols -> one frame of rate-Fs samples."""
        assert len(tx_symbs) == self.Npayload_syms
        syms = np.concatenate([self.p25_frame_sync[:self.Nsync_syms], tx_symbs])

        n_out = len(syms) * self.M
        filt_in = np.concatenate([self.tx_filt_mem,
                                  np.zeros(n_out, np.complex64)])
        filt_in[self.Ntap::self.M] = syms * self.M
        # out[i] = dot(filt_in[i+1 : i+Ntap+1], rrc)
        out = np.convolve(filt_in[1:], self.rrc[::-1], mode="valid").astype(np.complex64)
        self.tx_filt_mem = filt_in[-self.Ntap:]

        # mix up to centre frequency with carried LO phase
        ph = self.tx_lo_phase_rect * self.lo_omega_rect ** np.arange(1, n_out + 1)
        out = out * (ph / np.abs(ph))
        self.tx_lo_phase_rect = (ph[-1] / np.abs(ph[-1])).astype(np.complex64)
        return out

    # -- timing and phase ---------------------------------------------------
    def est_timing_and_decimate(self, rx_filt: np.ndarray) -> np.ndarray:
        """Envelope single-point-DFT fine timing + linear-interp resample
        (reference: dsp.py:665-704)."""
        M = self.M
        env = np.abs(rx_filt[int(self.sample_point):])
        x = np.dot(env, np.exp(-1j * 2 * np.pi * np.arange(len(env)) / M))
        norm_rx_timing = np.angle(x) / (2 * np.pi)
        rx_timing = norm_rx_timing * M
        corr = -rx_timing
        low = int(np.floor(corr))
        fract = corr - low
        sample = self.sample_point + low + np.arange(0, self.Nframe_syms * M, M)
        rx_symbols = rx_filt[sample] * (1 - fract) + rx_filt[sample + 1] * fract

        # nin slip keeps the timing estimate in the sweet spot
        self.nin = self.Nframe_syms * M
        if norm_rx_timing < -0.35:
            self.nin += M // 4
        if norm_rx_timing > 0.35:
            self.nin -= M // 4
        self.norm_rx_timing = norm_rx_timing
        return rx_symbols

    def est_phase_and_correct(self, rx_symbs: np.ndarray) -> np.ndarray:
        """Mod-stripped windowed phase estimate with cycle-slip tracking
        (reference: dsp.py:707-739)."""
        mod_order = 2
        buf = np.concatenate([self.phase_est_mem, rx_symbs])
        out = np.zeros(len(rx_symbs), np.complex64)
        # windowed sums of mod-stripped symbols, precomputed
        sq = buf ** mod_order
        csum = np.concatenate([[0], np.cumsum(sq)])
        for s in range(len(rx_symbs)):
            win = csum[s + 1 + self.Nphase] - csum[s + 1]
            fine = np.angle(win) / mod_order
            if fine - self.phase_est_fine < -0.9 * np.pi:
                self.phase_est_coarse += np.pi
            if fine - self.phase_est_fine > 0.9 * np.pi:
                self.phase_est_coarse -= np.pi
            self.phase_est_fine = fine
            est = self.phase_est_coarse + fine
            self.phase_est_log[s] = np.exp(1j * est)
            centre = s + self.Nphase // 2
            out[s] = buf[centre] * np.exp(-1j * est)
        self.phase_est_mem = buf[-self.Nphase:]
        return out

    def rx_Fs_to_Rs(self, rx_samples: np.ndarray) -> np.ndarray:
        assert len(rx_samples) == self.nin
        n = len(rx_samples)
        # mix down with carried LO phase
        ph = self.rx_lo_phase_rect * np.conj(self.lo_omega_rect) ** np.arange(1, n + 1)
        rx_bb = rx_samples * (ph / np.abs(ph))
        self.rx_lo_phase_rect = (ph[-1] / np.abs(ph[-1])).astype(np.complex64)

        filt_in = np.concatenate([self.rx_filt_mem, rx_bb])
        out = np.convolve(filt_in[1:], self.rrc[::-1], mode="valid").astype(np.complex64)
        to_keep = len(self.rx_filt_out) - self.nin
        self.rx_filt_out[:to_keep] = self.rx_filt_out[-to_keep:]
        self.rx_filt_out[to_keep:] = out
        self.rx_filt_mem = filt_in[-self.Ntap:]

        rx_symbs = self.est_timing_and_decimate(self.rx_filt_out)
        return self.est_phase_and_correct(rx_symbs)

    # -- frame sync state machine (reference: dsp.py:769-833) ---------------
    def rx(self, rx_samples: np.ndarray) -> np.ndarray:
        assert len(rx_samples) == self.nin
        Nf, Nsync = self.Nframe_syms, self.Nsync_syms

        self.rx_symb_buf[:Nf] = self.rx_symb_buf[Nf:]
        self.rx_symb_buf[Nf:] = self.rx_Fs_to_Rs(rx_samples)

        next_state = self.state
        fs_s = self.fs_s
        if self.state == "search":
            # normalised cross-correlation with the FS word over all offsets;
            # the sign of the peak resolves the BPSK phase ambiguity
            fs = self.p25_frame_sync[:Nsync] / self.p_scale
            max_Cs, max_s = np.complex64(0), 0
            for s in range(Nf):
                seg = self.rx_symb_buf[s:s + Nsync]
                num = np.dot(np.conj(seg), fs)
                denom = np.sqrt(np.dot(np.conj(seg), seg))
                Cs = num / (denom + 1e-12)
                if np.abs(Cs) > np.abs(max_Cs):
                    max_s, max_Cs = s, Cs
            self.max_Cs = max_Cs

            if np.abs(max_Cs) >= self.sync_thresh:
                next_state = "sync"
                fs_s = self.fs_s = max_s
                self.bad_fs = 0
                self.phase_ambiguity = np.pi if max_Cs.real < 0 else 0.0
                seg = self.rx_symb_buf[fs_s:fs_s + Nsync]
                self.g = 1 / (np.sqrt(np.mean(np.abs(seg) ** 2)) + 1e-12)

        if self.state == "sync":
            seg = np.exp(1j * self.phase_ambiguity) * self.rx_symb_buf[fs_s:fs_s + Nsync]
            n_errors = np.sum((seg * self.p25_frame_sync[:Nsync]).real < 0)
            if n_errors > self.unsync_thresh1:
                self.bad_fs += 1
            else:
                self.bad_fs = 0
            if self.bad_fs >= self.unsync_thresh2:
                next_state = "search"
            seg = self.rx_symb_buf[fs_s:fs_s + Nsync]
            self.g = 1 / (np.sqrt(np.mean(np.abs(seg) ** 2)) + 1e-12)

        self.state = next_state
        return (np.exp(1j * self.phase_ambiguity)
                * self.rx_symb_buf[fs_s + Nsync:fs_s + Nf])

    # -- built-in channel + BER self-test (reference: dsp.py:837-925) -------
    def run_test(self, Nframes=10, EbNodB=100, phase_off=0, freq_off=0,
                 mag=1, sample_clock_offset_ppm=0, target_ber=0,
                 verbose=False):
        tx_symbs = (1 - 2 * (self.rng.random(self.Npayload_syms) > 0.5)
                    + 0j).astype(np.complex64)

        tx = np.concatenate([self.tx(tx_symbs) for _ in range(Nframes)])

        # clock offset: 4x oversample, linear-interp resample, decimate
        tx_zp = np.zeros(4 * len(tx), np.complex64)
        tx_zp[::4] = tx
        tx_4 = self.lpf.bpf(tx_zp)
        rx = sample_clock_offset(tx_4, sample_clock_offset_ppm)[::4]

        phase_vec = 2 * np.pi * freq_off * np.arange(len(rx)) / self.Fs + phase_off
        rx = rx * np.exp(1j * phase_vec)
        sigma = np.sqrt(1 / (self.M * 10 ** (EbNodB / 10)))
        noise = (sigma / np.sqrt(2)) * (self.rng.standard_normal(len(rx))
                                        + 1j * self.rng.standard_normal(len(rx)))
        rx = mag * (rx + noise)

        total_errors = total_bits = 0
        n = 0
        nin = self.nin
        while len(rx[n:]) >= nin:
            rx_symbs = self.rx(rx[n:n + nin])
            if self.state == "sync":
                n_errors = np.sum((rx_symbs * tx_symbs).real < 0)
                total_errors += int(n_errors)
                total_bits += len(tx_symbs)
            n += nin
            nin = self.nin
            if verbose:
                print(f"state: {self.state:6s} nin: {self.nin:4d} "
                      f"timing: {self.norm_rx_timing:5.2f}")

        ber = total_errors / total_bits if total_bits else 1.0
        if verbose:
            print(f"total_bits: {total_bits} total_errors: {total_errors} "
                  f"BER: {ber:5.4f} target: {target_ber:5.4f}")
        return ber <= target_ber


def single_carrier_tests(verbose=False) -> bool:
    """Self-test sweep: clean, +-100 ppm clock offsets, BER vs theory with
    0.5 dB implementation-loss budget, 1500 Hz centre freq
    (reference: dsp.py:932-961)."""
    total = passes = 0

    total += 1; passes += SingleCarrier().run_test(verbose=verbose)
    total += 1; passes += SingleCarrier().run_test(Nframes=100, sample_clock_offset_ppm=100)
    total += 1; passes += SingleCarrier().run_test(Nframes=100, sample_clock_offset_ppm=-100)

    EbNodB = 4
    target = 0.5 * math.erfc(np.sqrt(10 ** ((EbNodB - 0.5) / 10)))
    total += 1; passes += SingleCarrier().run_test(
        Nframes=100, sample_clock_offset_ppm=-100, EbNodB=EbNodB, target_ber=target)
    total += 1; passes += SingleCarrier(fcentreHz=1500).run_test(
        Nframes=100, sample_clock_offset_ppm=-100, EbNodB=EbNodB,
        freq_off=1, mag=100, target_ber=target)
    if verbose:
        print(f"{passes}/{total}")
    return passes == total
