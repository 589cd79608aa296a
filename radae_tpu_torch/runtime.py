"""Batched streaming tx/rx serving steps (port of `radae_tpu/runtime.py`
`make_streaming_rx_step` and `make_streaming_tx_step`).

  rx step: (B, fps*Nmf+M+Ncp) samples -> CP strip + DFT + LS pilot EQ +
           coarse magnitude + demap -> stateful core decoder
           -> (B, fps*12, F) features                 (radae_rxe hot path)
  tx step: (B, 12, F) features -> stateful core encoder -> QPSK map +
           pilots + IDFT + CP + PA tanh -> (B, Nmf) samples (radae_txe)

Complex samples go in and out as packed (..., 2) float tensors.  Each
factory builds its device constants once; the DFT/IDFT are constant-matrix
products left to torch.matmul (in full f32: TF32 is switched off).  With
fused=True the core net runs as the fused kernel of ops/fused_core.py and
takes `decoder_weights`/`encoder_weights` and the fused state tuples;
fused_merged=True picks the chain-merged decoder kernel.  The whole rx
frame as one kernel is `ops.fused_core.make_fused_rx_frame_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import resolve_device
from .config import RADAEConfig
from .models.core import CoreDecoder, CoreEncoder
from .ops import cplx, ofdm
from .ops import fused_core
from .ops import pilots as pilots_ops


def _device(device) -> torch.device:
    dev = resolve_device(device)
    # the products here must be full f32 to hold parity with the reference
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def make_streaming_rx_step(cfg: RADAEConfig, decoder: CoreDecoder,
                           batch: int, fused: bool = False,
                           fused_merged: bool = False,
                           frames_per_step: int = 1, device="cuda"):
    """Batched streaming rx step.

    step(dec_params, rx_packed (B, fps*Nmf+M+Ncp, 2), dec_state)
      -> (features (B, fps*12, feature_dim), new_state)

    Unfused: dec_params is the `params_to_torch` decoder tree and dec_state
    the `CoreDecoder` state dict (or None).  fused=True: dec_params comes
    from `fused_core.decoder_weights` and dec_state from
    `decoder_state_zero`; with fused_merged=True both come from the
    same functions with merged=True and the chain-merged decoder kernel
    runs.  frames_per_step=N demodulates and decodes N
    consecutive frames per call, each frame equalised from its own two
    bracketing pilot rows (the same math as N chained calls)."""
    dev = _device(device)
    Ns, Nc = cfg.Ns, cfg.Nc
    fps = int(frames_per_step)
    if fps < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {fps}")
    if fused_merged and not fused:
        raise ValueError("fused_merged=True needs fused=True")
    Wfwd = cplx.const(cfg.Wfwd, dev)
    ls = pilots_ops.ls_consts(cfg.P, cfg.w, cfg.Fs, dev)
    pil_idx = torch.as_tensor([f * (Ns + 1) for f in range(fps + 1)],
                              device=dev)
    dat_idx = torch.as_tensor(np.concatenate(
        [f * (Ns + 1) + 1 + np.arange(Ns) for f in range(fps)]), device=dev)
    steps = torch.arange(1, Ns + 1, dtype=torch.float32,
                         device=dev)[None, None, :, None]
    P0_abs = float(np.abs(cfg.P[0]))
    n_rs = fps * (Ns + 1) + 1

    def step(dec_params, rx_packed, dec_state):
        B = rx_packed.shape[0]
        if tuple(rx_packed.shape) != (batch, n_rs * (cfg.M + cfg.Ncp), 2):
            raise ValueError(
                f"rx step built for ({batch}, {n_rs * (cfg.M + cfg.Ncp)}, 2) "
                f"samples, got {tuple(rx_packed.shape)}")
        rx = cplx.from_last(rx_packed).reshape(B, n_rs, cfg.M + cfg.Ncp)
        rx_dash = ofdm.strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset)
        rx_sym = ofdm.dft(rx_dash, Wfwd)                  # (B, n_rs, Nc)

        rx_pilots = pilots_ops.est_pilots_ls(rx_sym[:, pil_idx, :], ls)
        p0 = rx_pilots[:, :-1, :]                        # (B, fps, Nc)
        p1 = rx_pilots[:, 1:, :]
        slope = (p1 - p0) * (1.0 / (Ns + 1))
        rx_ch = p0[:, :, None, :] + slope[:, :, None, :] * steps
        data = rx_sym[:, dat_idx, :].reshape(B, fps, Ns, Nc) \
            * rx_ch.unit().conj()
        if cfg.coarse_mag:
            # per frame, from its own two bracketing pilot rows
            p2 = 0.5 * (p0.abs2().mean(dim=-1) + p1.abs2().mean(dim=-1))
            mag = torch.sqrt(p2) + 1e-6                  # (B, fps)
            if cfg.bottleneck == 3:
                mag = mag * P0_abs / cfg.pilot_gain
            data = data * (1.0 / mag)[:, :, None, None]

        z_hat = ofdm.qpsk_demap(data.reshape(B, -1, cfg.latent_dim // 2))
        if fused:
            if fused_core.is_merged(dec_params) != bool(fused_merged):
                raise ValueError(
                    f"rx step built with fused_merged={fused_merged}: the "
                    "weights must come from decoder_weights(..., merged="
                    f"{bool(fused_merged)})")
            z_hat = z_hat.reshape(B, fps * cfg.Nzmf, cfg.latent_dim)
            return fused_core.fused_decoder_step(dec_params, z_hat, dec_state)
        return decoder(dec_params, z_hat, key=None, state=dec_state)

    return step


def make_streaming_tx_step(cfg: RADAEConfig, encoder: CoreEncoder,
                           batch: int, fused: bool = False, device="cuda"):
    """Batched streaming tx step.

    step(enc_params, features (B, 12, F), enc_state)
      -> (tx_packed (B, Nmf, 2), new_state)

    fused=True: enc_params comes from `fused_core.encoder_weights` and
    enc_state from `encoder_state_zero`."""
    dev = _device(device)
    n_rs = cfg.Nzmf * cfg.latent_dim // (cfg.bps * cfg.Nc)
    Winv = cplx.const(cfg.Winv, dev)
    P = cplx.const(cfg.P, dev)

    def step(enc_params, features, enc_state):
        B = features.shape[0]
        if B != batch:
            raise ValueError(f"tx step built for batch {batch}, got {B}")
        if fused:
            z, enc_state = fused_core.fused_encoder_step(
                enc_params, features, enc_state, cfg.bottleneck)
        else:
            z, enc_state = encoder(enc_params, features, key=None,
                                   state=enc_state)
        tx_sym = ofdm.qpsk_map(z)
        if cfg.bottleneck == 2:
            tx_sym = ofdm.magnitude_bottleneck(tx_sym)
        tx_sym = tx_sym.reshape(B, n_rs, cfg.Nc)
        tx_sym = ofdm.insert_pilots(tx_sym, P, cfg.pilot_gain, cfg.Ns)
        tx = ofdm.idft(tx_sym, Winv)
        tx = ofdm.add_cp(tx, cfg.Ncp).reshape(B, -1)
        if cfg.bottleneck == 3:
            tx = ofdm.magnitude_bottleneck(tx)
        return cplx.stack_last(tx), enc_state

    return step
