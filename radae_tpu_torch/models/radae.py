"""The RADAE model: encoder -> OFDM tx -> simulated channel -> rx -> decoder
(port of `radae_tpu/models/radae.py`).

The reference RADAE module's forward pass (reference: radae/radae.py:457-669),
its vanilla batch receiver (radae.py:387-428) and the pilot-correlation SNR
estimator (radae.py:433-439), on split-complex planes (ops/cplx.py) on one
device.  `key` is a torch.Generator on that device (or an
`ops.draws.BatchRows`, this process's rows of a batch split over
processes), or None for a generator seeded 0 (radae_tpu's None is a fixed
key, so noise stays on there too): it drives the Eb/No draw, the
quantization noise, the BER-test bits and the channel, in radae_tpu's
order.

Without quantization noise (cfg.quant_noise False, or the receiver called
without a key) the core nets run as the hand-written kernels
(`ops.fused_core.fused_encoder_step` / `fused_decoder_step`, the unmerged f32
forms): each net over the whole sequence in one launch.  They run the plain
nets instead where the kernels cannot compute what is asked:

  * with noise, since the kernels compute the noise-free function;
  * where a gradient is asked for (grad mode on, and a leaf of the net's
    params, or its input, requires grad), since the kernels have no
    backward: radae_tpu trains by differentiating its plain forward too,
    and its kernels serve inference only.  Under torch.no_grad(), or on
    params that require no grad, the kernels run.

The routing and the packed weights live in `CoreCodec`, which BBFM
(models/bbfm.py) shares.  The kernels' weights are packed from the params
tree's tensors and kept, stamped with each leaf's storage and version
counter: an in-place update of a leaf (an optimizer step) bumps its
counter, and the next kernel call packs again, so the kernels never run on
weights older than the tree's.

Complex-valued outputs (tx_sym, tx, rx, final_phase) are cplx.C pairs of
tensors on the device.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..channel.simulate import draw_EbNodB, rate_fs_channel, rate_rs_channel
from ..ops import cplx, draws, fused_core, ofdm
from ..ops import pilots as pilots_ops
from ..ops.cplx import C
from ..runtime import f32_device
from . import layers as L
from .core import CoreDecoder, CoreEncoder


def tree_leaves(tree):
    """The leaves of a nested dict, depth first in insertion order."""
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


class CoreCodec:
    """A model's core encoder and decoder on one device, each call routed
    to its kernel or to the plain net (the part RADAE and BBFM share)."""

    def __init__(self, core_encoder, core_decoder, device):
        self.device = f32_device(device)
        self.core_encoder = core_encoder
        self.core_decoder = core_decoder
        self._kept = None     # (params, its tensors, packed weights by side)

    # -- parameters --------------------------------------------------------
    def init(self, seed) -> Dict:
        """Random weights (numpy) from an int seed: radae_tpu's
        `init(seed)` draw for draw."""
        rng = L.as_rng(seed)
        return {"encoder": self.core_encoder.init(rng),
                "decoder": self.core_decoder.init(rng)}

    def _tensors(self, params):
        """The params tree's tensors on the device, made once per tree (the
        tree given last is kept, by identity).  A leaf that is already an
        f32 tensor on the device is kept as it is, so gradients reach it
        and in-place updates show."""
        if self._kept is None or self._kept[0] is not params:
            def conv(node):
                if isinstance(node, dict):
                    return {k: conv(v) for k, v in node.items()}
                return torch.as_tensor(node, dtype=torch.float32).to(
                    self.device)
            self._kept = (params, conv(params), {})
        return self._kept[1]

    def kernel_weights(self, params, side: str) -> fused_core.PackedWeights:
        """The kernel weights of one side ("encoder" or "decoder"), packed
        from the tree's tensors and kept until a leaf's storage or version
        counter moves (an in-place update), then packed again."""
        tree = self._tensors(params)[side]
        stamp = tuple((t.data_ptr(), t._version) for t in tree_leaves(tree))
        packed = self._kept[2]
        if side not in packed or packed[side][0] != stamp:
            make = (fused_core.encoder_weights if side == "encoder"
                    else fused_core.decoder_weights)
            packed[side] = (stamp, make(tree, self.device))
        return packed[side][1]

    def _on_kernel(self, tree, x, key) -> bool:
        """Whether a core call runs as its kernel: no noise, and no
        gradient asked for through the net's params or its input."""
        if key is not None:
            return False
        return not (torch.is_grad_enabled() and (x.requires_grad or any(
            t.requires_grad for t in tree_leaves(tree))))

    def _encode(self, params, features, key, remat=False):
        tree = self._tensors(params)["encoder"]
        if self._on_kernel(tree, features, key):
            B = features.shape[0]
            return fused_core.fused_encoder_step(
                self.kernel_weights(params, "encoder"), features,
                fused_core.encoder_state_zero(B, self.device),
                self.core_encoder.bottleneck)[0]
        return self.core_encoder(tree, features, key=key, remat=remat)[0]

    def _decode(self, params, z_hat, key, remat=False):
        tree = self._tensors(params)["decoder"]
        if self._on_kernel(tree, z_hat, key):
            B = z_hat.shape[0]
            return fused_core.fused_decoder_step(
                self.kernel_weights(params, "decoder"), z_hat,
                fused_core.decoder_state_zero(B, self.device))[0]
        return self.core_decoder(tree, z_hat, key=key, remat=remat)[0]

    def _noise_key(self, key):
        return key if (key is not None and self.cfg.quant_noise) else None

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32).to(self.device)


class RADAE(CoreCodec):
    def __init__(self, cfg, device="cuda"):
        super().__init__(CoreEncoder(cfg.feature_dim, cfg.latent_dim,
                                     bottleneck=cfg.bottleneck),
                         CoreDecoder(cfg.latent_dim, cfg.feature_dim), device)
        self.cfg = cfg
        dev = self.device
        self._Winv = cplx.const(cfg.Winv, dev)
        self._Wfwd = cplx.const(cfg.Wfwd, dev)
        self._P = cplx.const(cfg.P, dev)
        self._eq = pilots_ops.ls_consts(cfg.P, cfg.w, cfg.Fs, dev)

    # -- helpers (host-side numpy) -----------------------------------------
    def default_G(self, num_batches: int, n_fs: int):
        """Benign (AWGN) Doppler gains G1=1, G2=0, packed (B, N, 2, 2) f32."""
        G = np.zeros((num_batches, n_fs, 2, 2), np.float32)
        G[:, :, 0, 0] = 1.0
        return G

    def default_H(self, num_batches: int, n_rs: int):
        return np.ones((num_batches, n_rs, self.cfg.Nc), np.float32)

    def _as_C(self, x) -> Optional[C]:
        """A C, a host complex numpy array, or a packed (..., 2) float array
        or tensor -> a C on the device."""
        if x is None or isinstance(x, C):
            return x
        if isinstance(x, np.ndarray) and np.iscomplexobj(x):
            x = cplx.from_c64(x, self.device)
        x = torch.as_tensor(x, dtype=torch.float32).to(self.device)
        if x.shape[-1] != 2:
            raise ValueError("packed complex arrays must end in (re, im)")
        return cplx.from_last(x)

    # -- transmitter side --------------------------------------------------
    def transmitter(self, z, num_timesteps_at_rate_Rs: int) -> C:
        """Latents -> rate-Fs time-domain samples (pilots + CP + PA model):
        z (B, Tz, latent_dim) -> tx C(B, N) (the tx half of the reference
        forward(), radae.py:480-527)."""
        cfg = self.cfg
        z = self._tensor(z)
        B = z.shape[0]
        tx_sym = ofdm.qpsk_map(z)
        if cfg.bottleneck == 2:
            tx_sym = ofdm.magnitude_bottleneck(tx_sym)
        tx_sym = tx_sym.reshape(B, num_timesteps_at_rate_Rs, cfg.Nc)
        n_rs = num_timesteps_at_rate_Rs
        if cfg.pilots:
            tx_sym = ofdm.insert_pilots(tx_sym, self._P, cfg.pilot_gain, cfg.Ns)
            n_rs = tx_sym.shape[1]
        tx = ofdm.add_cp(ofdm.idft(tx_sym, self._Winv), cfg.Ncp)
        tx = tx.reshape(B, n_rs * (cfg.M + cfg.Ncp))
        if cfg.bottleneck == 3:
            tx = ofdm.magnitude_bottleneck(tx)
        return tx

    # -- full autoencoder + channel forward --------------------------------
    def forward(self, params, features, H=None, G=None,
                key: Optional[torch.Generator] = None, EbNodB=None,
                remat: bool = False):
        """Encoder -> channel -> decoder.

        features: (B, T10ms, feature_dim); H: (B, T_Rs, Nc) rate-Rs fade
        magnitudes of the data symbols (None: all ones); G: rate-Fs Doppler
        gains as a C, complex numpy (B, N, 2) or packed float (B, N, 2, 2)
        (None: benign); key: a torch.Generator on the device, or None for
        one seeded 0; EbNodB: per-row Eb/No, shape (B,) or (B, 1, 1),
        instead of the config's draw; remat: the plain core nets keep only
        each block's input and outputs for the backward (models/core.py).
        Returns the dict of radae_tpu's forward: features_hat, z, z_hat,
        tx_sym, tx, rx, sigma, EbNodB, final_phase (and n_bits, n_errors,
        ber_row with cfg.ber_test) (reference: radae.py:457-669)."""
        cfg = self.cfg
        dev = self.device
        features = self._tensor(features)
        B, T, _ = features.shape
        n_rs_data = cfg.num_timesteps_at_rate_Rs(T)
        H = (torch.ones((B, n_rs_data, cfg.Nc), device=dev) if H is None
             else self._tensor(H))
        if tuple(H.shape) != (B, n_rs_data, cfg.Nc):
            raise ValueError(f"H has shape {tuple(H.shape)}, expected "
                             f"{(B, n_rs_data, cfg.Nc)}")

        gen = key
        if gen is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
        if EbNodB is None:
            EbNodB = draw_EbNodB(cfg, gen, B)
        else:
            EbNodB = self._tensor(EbNodB).reshape(B, 1, 1)

        z = self._encode(params, features, self._noise_key(gen), remat)
        if cfg.ber_test:
            z = torch.sign(draws.rand(gen, z.shape) - 0.5)

        qpsk_shape = (B, z.shape[1], cfg.latent_dim // 2)
        tx_sym = ofdm.qpsk_map(z)
        if cfg.bottleneck == 2:
            tx_sym = ofdm.magnitude_bottleneck(tx_sym)
        tx_sym = tx_sym.reshape(B, n_rs_data, cfg.Nc)

        n_rs = n_rs_data
        num_modem_frames = n_rs_data // cfg.Ns
        if cfg.pilots:
            tx_sym = ofdm.insert_pilots(tx_sym, self._P, cfg.pilot_gain, cfg.Ns)
            n_rs = tx_sym.shape[1]

        tx_before_channel = None
        rx = None
        final_phase = C(torch.ones((B,), device=dev),
                        torch.zeros((B,), device=dev))
        if cfg.rate_Fs:
            # --- at M samples per symbol (radae.py:505-602) ---------------
            tx = ofdm.add_cp(ofdm.idft(tx_sym, self._Winv), cfg.Ncp)
            n_fs = n_rs * (cfg.M + cfg.Ncp)
            tx = tx.reshape(B, n_fs)
            if cfg.bottleneck == 3:
                tx = ofdm.magnitude_bottleneck(tx)
            tx_before_channel = tx

            Gc = self._as_C(G)
            if Gc is None:
                # benign AWGN gains G1=1, G2=0
                Gc = C(torch.cat([torch.ones((B, n_fs, 1), device=dev),
                                  torch.zeros((B, n_fs, 1), device=dev)], -1),
                       torch.zeros((B, n_fs, 2), device=dev))
            rx, sigma, final_phase = rate_fs_channel(cfg, gen, tx, Gc, EbNodB)

            rx_dash = rx.reshape(B, n_rs, cfg.M + cfg.Ncp)
            rx_dash = ofdm.strip_cp(rx_dash, cfg.M, cfg.Ncp, cfg.time_offset)
            rx_sym = ofdm.dft(rx_dash, self._Wfwd)
        else:
            # --- at one sample per symbol (radae.py:603-634) --------------
            if cfg.bottleneck == 3:
                # hybrid time/freq: the PA model needs the time domain
                tx = ofdm.magnitude_bottleneck(ofdm.idft(tx_sym, self._Winv))
                tx_before_channel = tx
                tx_sym = ofdm.dft(tx, self._Wfwd)
            H_all = H
            if cfg.pilots:
                # the reference crashes on pilots + rate Rs (H is sized for
                # the data symbols only); radae_tpu makes the combination
                # work by copying each frame's first fade row onto its pilot
                H_framed = H_all.reshape(B, num_modem_frames, cfg.Ns, cfg.Nc)
                H_all = torch.cat([H_framed[:, :, :1, :], H_framed],
                                  dim=2).reshape(B, n_rs, cfg.Nc)
            rx_sym, sigma, tx_sym = rate_rs_channel(cfg, gen, tx_sym, H_all,
                                                    EbNodB)

        # --- strip pilots / EQ (radae.py:636-644) --------------------------
        if cfg.pilots:
            rx_sym_pilots = rx_sym.reshape(B, num_modem_frames, cfg.Ns + 1,
                                           cfg.Nc)
            if cfg.pilot_eq:
                rx_sym_pilots = pilots_ops.pilot_eq(cfg, rx_sym_pilots,
                                                    self._eq)
            rx_sym = rx_sym_pilots[:, :, 1:cfg.Ns + 1, :]

        z_hat = ofdm.qpsk_demap(rx_sym.reshape(*qpsk_shape))

        out = {}
        if cfg.ber_test:
            err = -z * z_hat > 0
            out["n_bits"] = z.numel()
            out["n_errors"] = err.sum()
            # per-sequence errors for batched BER grids
            out["ber_row"] = (err.sum(dim=tuple(range(1, z.dim())))
                              / (z.numel() // B))

        out.update({
            "features_hat": self._decode(params, z_hat, self._noise_key(gen),
                                         remat),
            "z": z,
            "z_hat": z_hat,
            "tx_sym": tx_sym,
            "tx": tx_before_channel,
            "rx": rx,
            "sigma": sigma,
            "EbNodB": EbNodB,
            "final_phase": final_phase,
        })
        return out

    # -- vanilla batch receiver (radae.py:387-428) --------------------------
    def receiver(self, params, rx, key: Optional[torch.Generator] = None):
        """Decode a rate-Fs sample stream (1-D complex numpy, packed (N, 2)
        or a C) to (features_hat (1, T, F), z_hat (1, Tz, latent_dim)).

        Assumes coarse sync is done (time and frequency aligned): a whole
        number of modem frames starting with a pilot.  Without a key the
        decoder is the unmerged f32 kernel: the whole stream in one launch
        at B=1.  The whole-frame kernel (fused_rx_frame_step) is not used
        here: this receiver scales by the pilots' RMS over the whole stream
        and interpolates each frame toward the next frame's pilot across
        all frames (ops/pilots.pilot_eq), where the frame kernel sees one
        frame and its two pilots, so it would compute another function."""
        cfg = self.cfg
        rx = self._as_C(rx)
        Ns = cfg.Ns + 1 if cfg.pilots else cfg.Ns
        n_rs = rx.shape[0] // (cfg.M + cfg.Ncp)
        nmf = n_rs // Ns
        n_rs = Ns * nmf
        rx = rx[: n_rs * (cfg.M + cfg.Ncp)].reshape(1, n_rs, cfg.M + cfg.Ncp)
        rx_dash = ofdm.strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset)
        rx_sym = ofdm.dft(rx_dash, self._Wfwd)
        if cfg.pilots:
            rx_sym_pilots = rx_sym.reshape(1, nmf, cfg.Ns + 1, cfg.Nc)
            if cfg.pilot_eq:
                rx_sym_pilots = pilots_ops.pilot_eq(cfg, rx_sym_pilots,
                                                    self._eq)
            rx_sym = rx_sym_pilots[:, :, 1:cfg.Ns + 1, :]
        z_hat = ofdm.qpsk_demap(rx_sym.reshape(1, -1, cfg.latent_dim // 2))
        return self._decode(params, z_hat, self._noise_key(key)), z_hat

    # -- SNR estimation from a received pilot (radae.py:433-439) ------------
    def est_snr(self, r, time_offset=0):
        """Host-side numpy: r is a (M,) complex vector of received pilot
        samples."""
        cfg = self.cfg
        st = cfg.Ncp + time_offset
        p = np.asarray(cfg.p_cp[st:st + cfg.M])
        r = np.asarray(r)
        Ct = np.abs(np.vdot(r, p)) ** 2 / np.vdot(r, r)
        SNR_est = Ct / (np.vdot(p, p) - Ct)
        return float(SNR_est.real)
