"""Plain PyTorch reference of RADAE's serving paths, for the benchmark's
check and its traffic.

Written from the published model (drowe67/radae: `radae/radae_base.py` for
the core nets, `radae/radae.py` for the OFDM modem and the pilot EQ) and
from nothing of the port: the weights come from the checkpoint's npz, the
modem constants from a configuration file's numbers.  It imports torch and
numpy only.

* The core nets run layer by layer over the whole sequence, as the
  published nets do (each GRU's input product over every step at once,
  then its recurrence; the GLU and the 2-tap conv over every step at once).
  State is carried in the port's serving layout, so the check can follow
  the program from a state it handed back:
    decoder: 5 GRU h (B, 96), then 5 conv histories (B, in);
    encoder: 5 GRU h (B, 64), then 5 conv history rings (B, d, in),
    oldest first.
* Complex numbers are torch.complex64.
* precision "tf32" rounds both inputs of every matrix product to TF32
  (10 mantissa bits, to nearest, ties away from zero, as the tensor cores'
  conversion does) and sums in f32: the precision just below the f32 the
  configurations state, used as the check's control.  "f32" is full f32
  (TF32 switched off).
"""

from __future__ import annotations

import math

import numpy as np
import torch

FEATURE_PERIOD_S = 0.01     # one feature frame
FRAMES_PER_STEP = 4         # feature frames per latent step
BARKER_13 = (1, 1, 1, 1, 1, -1, -1, 1, 1, -1, 1, -1, 1)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero, kept in f32."""
    i = x.contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def load_weights(path: str, device) -> dict:
    """The checkpoint's arrays (flat "side/layer/name" keys) as f32 tensors
    on `device`; the metadata entry is skipped."""
    with np.load(path, allow_pickle=False) as d:
        return {k: torch.as_tensor(np.asarray(d[k], np.float32), device=device)
                for k in d.files if not k.startswith("__")}


class Nets:
    """The core encoder and decoder of one checkpoint."""

    def __init__(self, weights: dict, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision must be f32 or tf32, got {precision!r}")
        self.tf32 = precision == "tf32"
        self.w = weights
        self.layers = range(1, 6)
        # the GLU's weight-normed matrix, g * v / |v| by rows
        self.glu = {}
        for i in self.layers:
            v = weights[f"decoder/glu{i}/v"]
            g = weights[f"decoder/glu{i}/g"]
            self.glu[i] = g[:, None] * v / torch.linalg.norm(v, dim=1,
                                                             keepdim=True)

    def mm(self, x, w_out_in):
        """x @ w.T for a weight stored (out, in)."""
        if self.tf32:
            return round_tf32(x) @ round_tf32(w_out_in).T
        return x @ w_out_in.T

    def dense(self, x, name):
        return self.mm(x, self.w[f"{name}/w"]) + self.w[f"{name}/b"]

    def _gru(self, pre, x, h):
        """One GRU layer over x (B, T, in) from h (B, H): gates r, z, n
        stacked along 3H (the published nn.GRU order)."""
        gi = self.mm(x, self.w[f"{pre}/w_ih"]) + self.w[f"{pre}/b_ih"]
        whh, bhh = self.w[f"{pre}/w_hh"], self.w[f"{pre}/b_hh"]
        H = h.shape[-1]
        ys = []
        for t in range(x.shape[1]):
            hg = self.mm(h, whh) + bhh
            rz = torch.sigmoid(gi[:, t, :2 * H] + hg[:, :2 * H])
            n = torch.tanh(gi[:, t, 2 * H:] + rz[:, :H] * hg[:, 2 * H:])
            h = n + rz[:, H:] * (h - n)
            ys.append(h)
        return torch.stack(ys, dim=1), h

    def _conv(self, pre, x, hist):
        """Causal 2-tap conv with tanh: tap 0 on x[t-d], tap 1 on x[t];
        hist (B, d, in) holds the d inputs before x.  Returns (y, the last
        d inputs)."""
        w = self.w[f"{pre}/w"]
        d = hist.shape[1]
        ext = torch.cat([hist, x], dim=1)
        y = torch.tanh(self.mm(ext[:, :x.shape[1]], w[:, :, 0])
                       + self.mm(x, w[:, :, 1]) + self.w[f"{pre}/b"])
        return y, ext[:, ext.shape[1] - d:]

    def decoder(self, z, state):
        """z (B, nz, latent), state (10 tensors) -> (features (B, 4 nz, F),
        new state)."""
        B, nz, _ = z.shape
        x = torch.tanh(self.dense(z, "decoder/dense_1"))
        hs, hists = [], []
        for i in self.layers:
            y, h = self._gru(f"decoder/gru{i}", x, state[i - 1])
            x = torch.cat([x, y * torch.sigmoid(self.mm(y, self.glu[i]))], -1)
            c, hist = self._conv(f"decoder/conv{i}", x, state[4 + i][:, None])
            x = torch.cat([x, c], dim=-1)
            hs.append(h)
            hists.append(hist[:, 0])
        out = self.dense(x, "decoder/output")
        return out.reshape(B, nz * FRAMES_PER_STEP, -1), tuple(hs + hists)

    def encoder(self, feats, state, bottleneck):
        """feats (B, 4 nz, F), state (10 tensors) -> (z (B, nz, latent),
        new state)."""
        B, T, F = feats.shape
        x = feats.reshape(B, T // FRAMES_PER_STEP, FRAMES_PER_STEP * F)
        x = torch.tanh(self.dense(x, "encoder/dense_1"))
        hs, hists = [], []
        for i in self.layers:
            y, h = self._gru(f"encoder/gru{i}", x, state[i - 1])
            x = torch.cat([x, y], dim=-1)
            c, hist = self._conv(f"encoder/conv{i}", x, state[4 + i])
            x = torch.cat([x, c], dim=-1)
            hs.append(h)
            hists.append(hist)
        z = self.dense(x, "encoder/z_dense")
        return (torch.tanh(z) if bottleneck == 1 else z), tuple(hs + hists)

    def decoder_zero_state(self, batch, device):
        return tuple(
            [torch.zeros(batch, self.w[f"decoder/gru{i}/w_hh"].shape[1],
                         device=device) for i in self.layers]
            + [torch.zeros(batch, self.w[f"decoder/conv{i}/w"].shape[1],
                           device=device) for i in self.layers])

    def encoder_zero_state(self, batch, device):
        """Ring depth: 1 for the first conv, 2 (dilation 2) for the rest."""
        return tuple(
            [torch.zeros(batch, self.w[f"encoder/gru{i}/w_hh"].shape[1],
                         device=device) for i in self.layers]
            + [torch.zeros(batch, 1 if i == 1 else 2,
                           self.w[f"encoder/conv{i}/w"].shape[1],
                           device=device) for i in self.layers])


class Modem:
    """The OFDM modem of a configuration (its numbers as the configuration
    file states them): QPSK map, one pilot row a modem frame, IDFT, cyclic
    prefix and the PA's tanh on the way out; CP strip, DFT, 3-pilot least
    squares channel estimates, linear interpolation with phase EQ, coarse
    magnitude and demap on the way in."""

    def __init__(self, c: dict, device, precision: str = "f32"):
        self.tf32 = precision == "tf32"
        self.M, self.Ncp, self.Ns, self.Nc = c["M"], c["Ncp"], c["Ns"], c["Nc"]
        self.latent = c["latent_dim"]
        self.time_offset = c["time_offset"]
        self.bottleneck = c["bottleneck"]
        self.Nmf = (self.Ns + 1) * (self.M + self.Ncp)
        Fs, M, Nc = c["Fs"], self.M, self.Nc
        w = 2.0 * np.pi * (c["carrier_1_index"] + np.arange(Nc)) / M
        n = np.arange(M)
        P = math.sqrt(2.0) * np.resize(np.array(BARKER_13, np.float64), Nc)
        self.pilot_gain = (10 ** (c["pilot_backoff_db"] / 20) * M / math.sqrt(Nc)
                           if self.bottleneck == 3 else 1.0)
        self.P0_abs = abs(P[0])
        a = c["ls_path_delay_s"] * Fs
        # per carrier c, from pilots m-1, m, m+1 (m clamped one inside the
        # band): g = (A^H A)^-1 A^H (rx/P) for h(w) = g0 + g1 exp(-j w a)
        mid = np.clip(np.arange(Nc), 1, Nc - 2)
        pmat = np.zeros((Nc, 2, 3), np.complex128)
        for k in range(Nc):
            m = mid[k]
            A = np.array([[1, np.exp(-1j * w[m + j] * a)] for j in (-1, 0, 1)])
            pmat[k] = np.linalg.inv(A.conj().T @ A) @ A.conj().T
        cx = lambda v: torch.as_tensor(np.asarray(v, np.complex64), device=device)
        self.Wfwd = cx(np.exp(-1j * np.outer(n, w)))          # (M, Nc)
        self.Winv = cx(np.exp(1j * np.outer(w, n)) / M)       # (Nc, M)
        self.P = cx(P)
        self.invP = cx(1.0 / P)
        self.pmat = cx(pmat)
        self.idx = torch.as_tensor(mid[:, None] + np.arange(-1, 2)[None, :],
                                   device=device)
        self.phase = cx(np.exp(-1j * w * a))
        self.pilot_row = self._pa(self._cp(
            (self.P * self.pilot_gain)[None, None] @ self.Winv))[0, 0]

    # -- helpers -------------------------------------------------------------
    def cmm(self, x, W):
        if self.tf32:
            r = lambda t: torch.complex(round_tf32(t.real), round_tf32(t.imag))
            return r(x) @ r(W)
        return x @ W

    def _cp(self, x):
        return torch.cat([x[..., -self.Ncp:], x], dim=-1)

    def _pa(self, x):
        if self.bottleneck != 3:
            return x
        r = torch.sqrt(x.real ** 2 + x.imag ** 2 + 1e-12)
        return x * (torch.tanh(r) / r)

    @staticmethod
    def unit(h):
        return h / torch.sqrt(h.real ** 2 + h.imag ** 2 + 1e-12)

    def ls(self, pilots):
        """(..., Nc) received pilot symbols -> (..., Nc) channel estimates."""
        r = (pilots * self.invP)[..., self.idx]               # (..., Nc, 3)
        if self.tf32:
            g = self.cmm(self.pmat, r[..., None])[..., 0]     # (..., Nc, 2)
        else:
            g = (self.pmat @ r[..., None])[..., 0]
        return g[..., 0] + g[..., 1] * self.phase

    def symbols(self, rx, n_rows):
        """rx (B, n_rows (M+Ncp)) complex -> (B, n_rows, Nc) carriers."""
        st = self.Ncp + self.time_offset
        rows = rx.reshape(rx.shape[0], n_rows, self.M + self.Ncp)
        return self.cmm(rows[:, :, st:st + self.M], self.Wfwd)

    def demap(self, data):
        """(B, ..., Nc) symbols in time order -> (B, nz, latent) latents."""
        B = data.shape[0]
        d = data.reshape(B, -1, self.latent // 2)
        return torch.stack([d.real, d.imag], dim=-1).reshape(
            B, d.shape[1], self.latent)

    # -- transmit --------------------------------------------------------------
    def modulate(self, z):
        """z (B, nz, latent), nz a whole number of modem frames ->
        (B, nz/3 Nmf) complex samples."""
        B = z.shape[0]
        sym = torch.complex(z[..., 0::2], z[..., 1::2]).reshape(
            B, -1, self.Ns, self.Nc)
        pil = (self.P * self.pilot_gain).expand(B, sym.shape[1], 1, self.Nc)
        sym = torch.cat([pil, sym], dim=2).reshape(B, -1, self.Nc)
        return self._pa(self._cp(self.cmm(sym, self.Winv)).reshape(B, -1))

    # -- receive ---------------------------------------------------------------
    def rx_frame(self, rx):
        """One frame a stream with the next frame's pilot row: rx (B,
        (Ns+2)(M+Ncp)) complex -> z_hat (B, 3, latent).  The frame's data
        rows are equalised from its own two pilot rows."""
        Ns = self.Ns
        Y = self.symbols(rx, Ns + 2)
        h0, h1 = self.ls(Y[:, 0]), self.ls(Y[:, Ns + 1])
        t = torch.arange(1, Ns + 1, device=rx.device)[None, :, None] / (Ns + 1)
        h = h0[:, None] + (h1 - h0)[:, None] * t
        data = Y[:, 1:Ns + 1] * self.unit(h).conj()
        p2 = 0.5 * ((h0.real ** 2 + h0.imag ** 2).mean(-1)
                    + (h1.real ** 2 + h1.imag ** 2).mean(-1))
        mag = torch.sqrt(p2) + 1e-6
        if self.bottleneck == 3:
            mag = mag * self.P0_abs / self.pilot_gain
        return self.demap(data / mag[:, None, None])

    def rx_file(self, rx):
        """A whole file of modem frames (pilot row first), time and
        frequency aligned: rx (n,) complex -> z_hat (1, 3 nmf, latent).
        Each frame interpolates toward the next frame's pilot, the last one
        goes on with the slope before it; the coarse magnitude is the
        pilots' RMS over the whole file."""
        Ns = self.Ns
        nmf = rx.shape[0] // self.Nmf
        Y = self.symbols(rx[None, :nmf * self.Nmf], nmf * (Ns + 1))
        Y = Y.reshape(1, nmf, Ns + 1, self.Nc)
        hp = self.ls(Y[:, :, 0])                               # (1, nmf, Nc)
        if nmf > 1:
            slope = (hp[:, 1:] - hp[:, :-1]) / (Ns + 1)
            slope = torch.cat([slope, slope[:, -1:]], dim=1)
        else:
            slope = torch.zeros_like(hp)
        s = torch.arange(1, Ns + 1, device=rx.device)[None, None, :, None]
        h = hp[:, :, None] + slope[:, :, None] * s
        data = Y[:, :, 1:] * self.unit(h).conj()
        mag = torch.sqrt((hp.real ** 2 + hp.imag ** 2).mean())
        if self.bottleneck == 3:
            mag = mag * self.P0_abs / self.pilot_gain
        return self.demap(data / mag)


def packed(x: torch.Tensor) -> torch.Tensor:
    """complex (...,) -> interleaved (..., 2) f32."""
    return torch.stack([x.real, x.imag], dim=-1)


def unpacked(x: torch.Tensor) -> torch.Tensor:
    """interleaved (..., 2) f32 -> complex (...,)."""
    return torch.complex(x[..., 0].contiguous(), x[..., 1].contiguous())
