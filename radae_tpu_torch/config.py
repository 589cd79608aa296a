"""Modem geometry and model configuration (numpy only).

A copy of the JAX package's config module (`radae_tpu/config.py`), so that
the port shares the modem constants and the BBFM configuration without
importing the JAX package.

Reproduces the derived-parameter math of the reference OFDM modem setup
(reference: radae/radae.py:128-235) as a frozen, hashable config object so
that it can be closed over by the step factories.  All host-side constants
(DFT matrices, pilot sequences) are numpy arrays; the step factories convert
them to device tensors once.

Key quantities (with pilots, cp=0.004, latent_dim=80 — the model19_check3
waveform):
    Rs=33.33  Rs'=50  Ts'=0.02  Nsmf=120  Ns=4  Nc=30  M=160  Ncp=32
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from functools import cached_property

import numpy as np

# Barker-13 based pilot sequence; good autocorrelation properties
# (reference: radae/radae.py:48-56).
_BARKER_13 = np.array([1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1], dtype=np.float32)


def barker_pilots(Nc: int) -> np.ndarray:
    """Length-Nc pilot sequence from a repeated Barker-13 code (complex64)."""
    reps = int(np.ceil(Nc / len(_BARKER_13)))
    seq = np.tile(_BARKER_13, reps)[:Nc]
    return seq.astype(np.complex64)


@dataclass(frozen=True)
class RADAEConfig:
    """Static configuration: model dims + OFDM modem geometry + channel flags.

    Mirrors the constructor arguments of the reference RADAE module
    (reference: radae/radae.py:60-112) but as a hashable value object.
    """

    feature_dim: int = 20
    latent_dim: int = 80
    EbNodB: float = 100.0
    multipath_delay: float = 0.002     # seconds
    range_EbNo: bool = False
    range_EbNo_start: float = -6.0
    ber_test: bool = False
    rate_Fs: bool = False
    bottleneck: int = 1
    phase_offset: float = 0.0
    freq_offset: float = 0.0
    df_dt: float = 0.0
    gain: float = 1.0
    freq_rand: bool = False
    gain_rand: bool = False
    pilots: bool = False
    pilot_eq: bool = False
    eq_mean6: bool = True
    per_carrier_eq: bool = True
    phase_mag_eq: bool = False
    cyclic_prefix: float = 0.0         # seconds
    time_offset: int = 0
    coarse_mag: bool = False
    correct_freq_offset: bool = False
    # implementation knobs (not in reference)
    quant_noise: bool = True           # simulate 8-bit quantization after activations
    compute_dtype: str = "float32"     # "float32" | "bfloat16" matmul inputs

    def __post_init__(self):
        assert self.bottleneck in (1, 2, 3)

    # ---- fixed rates -----------------------------------------------------
    enc_stride: int = field(default=4, init=False)   # feature frames per latent step
    dec_stride: int = field(default=4, init=False)

    @property
    def Tf(self) -> float:
        return 0.01                     # feature update period (s)

    @property
    def Tz(self) -> float:
        return self.Tf * self.enc_stride  # latent update period (s)

    @property
    def Rz(self) -> float:
        return 1.0 / self.Tz

    @property
    def Rb(self) -> float:
        return self.latent_dim / self.Tz  # payload BPSK symbol rate (Hz)

    @property
    def bps(self) -> int:
        return 2                        # BPSK bits per QPSK symbol

    @property
    def Fs(self) -> int:
        return 8000                     # modem sample rate

    # ---- OFDM modem frame geometry (reference: radae/radae.py:133-168) ---
    @property
    def Ts(self) -> float:
        return 0.03 if self.pilots else 0.02

    @property
    def Rs(self) -> float:
        return 1.0 / self.Ts

    @property
    def Nzmf(self) -> int:
        return 3                        # latent vectors per modem frame

    @property
    def Nsmf(self) -> int:
        return self.Nzmf * self.latent_dim // self.bps

    @property
    def Ns(self) -> int:
        return int(self.Nzmf * self.Tz / self.Ts)   # data symbols per modem frame

    @property
    def Tmf(self) -> float:
        return self.Ns * self.Ts        # modem frame period (s), constant

    @property
    def Nc(self) -> int:
        Nc = int(self.Nsmf // self.Ns)  # number of carriers
        assert self.Ns * Nc * self.bps == self.Nzmf * self.latent_dim
        return Nc

    @cached_property
    def _rates_dash(self):
        """(Rs', Ts', Rb') after pilot and cyclic-prefix rate inflation."""
        Rs_dash, Ts_dash, Rb_dash = self.Rs, self.Ts, self.Rb
        if self.pilots:
            Rs_dash = self.Rs * (self.Ns + 1) / self.Ns
            Ts_dash = 1.0 / Rs_dash
            Rb_dash = self.Rb * (self.Ns + 1) / self.Ns
        Rs_dash = Rs_dash / (1.0 - self.cyclic_prefix / Ts_dash)
        Rb_dash = Rb_dash / (1.0 - self.cyclic_prefix / Ts_dash)
        Ts_dash = 1.0 / Rs_dash
        return Rs_dash, Ts_dash, Rb_dash

    @property
    def Rs_dash(self) -> float:
        return self._rates_dash[0]

    @property
    def Ts_dash(self) -> float:
        return self._rates_dash[1]

    @property
    def Rb_dash(self) -> float:
        return self._rates_dash[2]

    @property
    def M(self) -> int:
        return round(self.Fs / self.Rs_dash)        # samples per OFDM symbol

    @property
    def Ncp(self) -> int:
        return int(self.cyclic_prefix * self.Fs)    # cyclic prefix samples

    @property
    def d_samples(self) -> int:
        return int(self.multipath_delay * self.Fs)  # multipath delay samples

    @property
    def Nmf(self) -> int:
        """Samples per modem frame at rate Fs (with pilots + CP)."""
        return int((self.Ns + 1) * (self.M + self.Ncp))

    @property
    def Nseoo(self) -> int:
        """Number of experimental end-of-over data symbols."""
        return (self.Ns - 1) * self.Nc

    # ---- carrier frequencies and DFT matrices ----------------------------
    @cached_property
    def carrier_1_index(self) -> int:
        # centre signal on 1500 Hz; first carrier must be an integer DFT bin
        carrier_1_freq = 1500.0 - self.Rs_dash * self.Nc / 2
        return round(carrier_1_freq / self.Rs_dash)

    @cached_property
    def w(self) -> np.ndarray:
        """Carrier angular frequencies, radians/sample, shape (Nc,)."""
        return (2.0 * np.pi * (self.carrier_1_index + np.arange(self.Nc))
                / self.M).astype(np.float64)

    @cached_property
    def Winv(self) -> np.ndarray:
        """Inverse DFT matrix, (Nc, M): freq-domain carriers -> time (OFDM Tx)."""
        n = np.arange(self.M)
        # outer product of carrier freqs and sample index
        return (np.exp(1j * np.outer(self.w, n)) / self.M).astype(np.complex64)

    @cached_property
    def Wfwd(self) -> np.ndarray:
        """Forward DFT matrix, (M, Nc): time samples -> carriers (OFDM Rx)."""
        n = np.arange(self.M)
        return np.exp(-1j * np.outer(n, self.w)).astype(np.complex64)

    # ---- pilots (reference: radae/radae.py:181-199) ----------------------
    @cached_property
    def P(self) -> np.ndarray:
        """Frequency-domain pilot symbols, (Nc,) complex64, scaled by sqrt(2)."""
        return (math.sqrt(2.0) * barker_pilots(self.Nc)).astype(np.complex64)

    @cached_property
    def Pend(self) -> np.ndarray:
        """End-of-over pilot: P with every second symbol negated."""
        Pend = self.P.copy()
        Pend[1::2] = -Pend[1::2]
        return Pend

    @cached_property
    def p(self) -> np.ndarray:
        """Time-domain pilot samples, (M,)."""
        return (self.P @ self.Winv).astype(np.complex64)

    @cached_property
    def pend(self) -> np.ndarray:
        return (self.Pend @ self.Winv).astype(np.complex64)

    @cached_property
    def p_cp(self) -> np.ndarray:
        """Pilot with cyclic prefix, (Ncp+M,)."""
        return _add_cp(self.p, self.Ncp)

    @cached_property
    def pend_cp(self) -> np.ndarray:
        return _add_cp(self.pend, self.Ncp)

    @property
    def pilot_gain(self) -> float:
        if self.bottleneck == 3:
            pilot_backoff = 10 ** (-2 / 20)
            return pilot_backoff * self.M / math.sqrt(self.Nc)
        return 1.0

    # ---- end of over frame (reference: radae/radae.py:203-219) -----------
    @cached_property
    def eoo(self) -> np.ndarray:
        """End-of-over modem frame samples, (1, Nmf+M+Ncp) complex64.

        Frame layout: P E 0 0 0 E with P=p_cp, E=pend_cp (zeros can later be
        replaced by EOO data symbols via ofdm.set_eoo_bits).
        """
        assert self.Ncp, "EOO frame requires a cyclic prefix"
        M, Ncp, Nmf = self.M, self.Ncp, self.Nmf
        eoo = np.zeros((1, Nmf + M + Ncp), dtype=np.complex64)
        eoo[0, : M + Ncp] = self.p_cp
        eoo[0, M + Ncp: 2 * (M + Ncp)] = self.pend_cp
        eoo[0, Nmf: Nmf + (M + Ncp)] = self.pend_cp
        eoo = eoo * self.pilot_gain
        if self.bottleneck == 3:
            eoo = (np.tanh(np.abs(eoo)) * np.exp(1j * np.angle(eoo))).astype(np.complex64)
        return eoo

    # ---- sequence-length helpers (reference: radae/radae.py:292-307) -----
    def num_timesteps_at_rate_Rs(self, num_ten_ms_timesteps: int) -> int:
        num_modem_frames = num_ten_ms_timesteps / self.enc_stride / self.Nzmf
        return int(num_modem_frames * self.Ns)

    def num_timesteps_at_rate_Fs(self, num_timesteps_at_rate_Rs: int) -> int:
        if self.pilots:
            return int(((self.Ns + 1) / self.Ns) * num_timesteps_at_rate_Rs
                       * (self.M + self.Ncp))
        return int(num_timesteps_at_rate_Rs * (self.M + self.Ncp))

    def num_10ms_times_steps_rounded_to_modem_frames(self, n: int) -> int:
        num_modem_frames = n // self.enc_stride // self.Nzmf
        return num_modem_frames * self.enc_stride * self.Nzmf

    def summary(self) -> str:
        return (f"Rs: {self.Rs:5.2f} Rs': {self.Rs_dash:5.2f} "
                f"Ts': {self.Ts_dash:5.3f} Nsmf: {self.Nsmf:3d} "
                f"Ns: {self.Ns:3d} Nc: {self.Nc:3d} M: {self.M:d} "
                f"Ncp: {self.Ncp:d}")


def _add_cp(x: np.ndarray, Ncp: int) -> np.ndarray:
    if Ncp == 0:
        return x.astype(np.complex64)
    out = np.zeros(Ncp + len(x), dtype=np.complex64)
    out[Ncp:] = x
    out[:Ncp] = x[-Ncp:]
    return out


# The flagship deployed waveform configuration ("model19_check3" in the
# reference): auxdata on (21 features), bottleneck 3, pilots + pilot EQ with
# least-squares estimator, 4 ms cyclic prefix, coarse magnitude correction,
# time_offset -16 (reference: radae_txe.py:60-63, radae_rxe.py:85-88).
def flagship_config(**overrides) -> RADAEConfig:
    base = dict(
        feature_dim=21,
        latent_dim=80,
        EbNodB=100.0,
        rate_Fs=True,
        pilots=True,
        pilot_eq=True,
        eq_mean6=False,
        cyclic_prefix=0.004,
        coarse_mag=True,
        time_offset=-16,
        bottleneck=3,
    )
    base.update(overrides)
    return RADAEConfig(**base)


@dataclass(frozen=True)
class BBFMConfig:
    """Baseband FM variant configuration (reference: radae/bbfm.py:42-95)."""

    feature_dim: int = 20
    latent_dim: int = 40
    CNRdB: float = 100.0
    fd_Hz: float = 5000.0
    fm_Hz: float = 3000.0
    quant_noise: bool = True

    enc_stride: int = field(default=4, init=False)
    dec_stride: int = field(default=4, init=False)

    @property
    def Tf(self) -> float:
        return 0.01

    @property
    def Tz(self) -> float:
        return self.Tf * self.enc_stride

    @property
    def Rz(self) -> float:
        return 1.0 / self.Tz

    @property
    def Rb(self) -> float:
        return self.latent_dim / self.Tz

    @property
    def beta(self) -> float:
        return self.fd_Hz / self.fm_Hz          # FM deviation ratio

    @property
    def BWfm(self) -> float:
        return 2 * (self.fd_Hz + self.fm_Hz)    # Carson's rule bandwidth

    @property
    def Gfm(self) -> float:
        return 10 * math.log10(3 * (self.beta ** 2) * (self.beta + 1))

    def num_timesteps_at_rate_Rs(self, num_ten_ms_timesteps: int) -> int:
        num_seconds = num_ten_ms_timesteps * self.Tf
        return int(num_seconds * self.Rb)

    def num_10ms_times_steps_rounded_to_modem_frames(self, n: int) -> int:
        return (n // self.enc_stride) * self.enc_stride
