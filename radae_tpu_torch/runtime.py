"""Batched streaming tx/rx serving steps and the whole-over batched
receiver (port of `radae_tpu/runtime.py`: `make_streaming_rx_step`,
`make_streaming_tx_step`, `make_batched_receiver`).

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
fused_merged=True (or "pad", the padded layout) picks the chain-merged
decoder kernel, fused_quant="int8" the int8 instances and
fused_dtype=torch.bfloat16 the instances with bf16 products.  The whole rx
frame as one kernel is `ops.fused_core.make_fused_rx_frame_step`.
"""

from __future__ import annotations

import numpy as np
import torch

from . import calibration, resolve_device, trace
from .config import RADAEConfig
from .models.core import CoreDecoder, CoreEncoder
from .ops import cplx, ofdm
from .ops import fused_core
from .ops import pilots as pilots_ops


def _check_fused(fused, fused_quant, fused_dtype=None, fused_merged=False):
    """Refuse fused options the port has no kernel for, and options that
    need fused=True without it."""
    if fused_quant not in fused_core.QUANTS:
        raise ValueError(f"fused_quant must be one of {fused_core.QUANTS}, "
                         f"got {fused_quant!r}")
    if fused_dtype is not None and fused_dtype not in fused_core.DTYPES:
        raise ValueError(f"fused_dtype must be None or one of "
                         f"{fused_core.DTYPES}, got {fused_dtype!r}")
    if fused_merged not in (False, True, "pad"):
        raise ValueError(f'fused_merged must be False, True or "pad", got '
                         f"{fused_merged!r}")
    if (fused_quant or fused_dtype is not None or fused_merged) and not fused:
        raise ValueError("fused_quant, fused_dtype and fused_merged need "
                         "fused=True")
    return torch.float32 if fused_dtype is None else fused_dtype


def _check_quant(weights, fused_quant, what):
    if weights.quant != fused_quant:
        raise ValueError(f"{what} built with fused_quant={fused_quant!r} got "
                         f"weights of quant={weights.quant!r}")


def f32_device(device) -> torch.device:
    """resolve_device(device), with TF32 switched off: the products of the
    port's entry points must be full f32 to hold parity with the
    reference."""
    dev = resolve_device(device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def make_streaming_rx_step(cfg: RADAEConfig, decoder: CoreDecoder,
                           batch: int, fused: bool = False,
                           fused_merged: bool = False, fused_quant=None,
                           fused_dtype=None, frames_per_step: int = 1,
                           device="cuda"):
    """Batched streaming rx step.

    step(dec_params, rx_packed (B, fps*Nmf+M+Ncp, 2), dec_state)
      -> (features (B, fps*12, feature_dim), new_state)

    Unfused: dec_params is the `params_to_torch` decoder tree and dec_state
    the `CoreDecoder` state dict (or None).  fused=True: dec_params comes
    from `fused_core.decoder_weights` and dec_state from
    `decoder_state_zero`; with fused_merged=True both come from the
    same functions with merged=True and the chain-merged decoder kernel
    runs, and with fused_merged="pad" they come with merged="pad" (the
    padded layout); with fused_quant="int8" the weights come from
    `decoder_weights(..., quant="int8")` and the int8 kernel runs.
    fused_dtype=torch.bfloat16 runs the kernel's bf16-product instance
    (radae_tpu's compute_dtype), on f32, bf16 (`decoder_weights(...,
    dtype=torch.bfloat16)`) or int8 weights; the chain-merged kernel's
    then runs on the tensor cores, on the weights packed on its first
    launch with a weight set and kept in it.  frames_per_step=N
    demodulates and decodes N consecutive frames per call, each frame
    equalised from its own two bracketing pilot rows (the same math as N
    chained calls)."""
    cd = _check_fused(fused, fused_quant, fused_dtype, fused_merged)
    dev = f32_device(device)
    Ns, Nc = cfg.Ns, cfg.Nc
    fps = int(frames_per_step)
    if fps < 1:
        raise ValueError(f"frames_per_step must be >= 1, got {fps}")
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
        with trace.span("rx.front_end", dev):
            with trace.span("rx.front_end.dft"):
                rx = cplx.from_last(rx_packed).reshape(B, n_rs,
                                                       cfg.M + cfg.Ncp)
                rx_dash = ofdm.strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset)
                rx_sym = ofdm.dft(rx_dash, Wfwd)          # (B, n_rs, Nc)

            with trace.span("rx.front_end.pilot_eq"):
                rx_pilots = pilots_ops.est_pilots_ls(rx_sym[:, pil_idx, :],
                                                     ls)
                p0 = rx_pilots[:, :-1, :]                # (B, fps, Nc)
                p1 = rx_pilots[:, 1:, :]
                slope = (p1 - p0) * (1.0 / (Ns + 1))
                rx_ch = p0[:, :, None, :] + slope[:, :, None, :] * steps
                data = rx_sym[:, dat_idx, :].reshape(B, fps, Ns, Nc) \
                    * rx_ch.unit().conj()
                if cfg.coarse_mag:
                    # per frame, from its own two bracketing pilot rows
                    p2 = 0.5 * (p0.abs2().mean(dim=-1)
                                + p1.abs2().mean(dim=-1))
                    mag = torch.sqrt(p2) + 1e-6          # (B, fps)
                    if cfg.bottleneck == 3:
                        mag = mag * P0_abs / cfg.pilot_gain
                    data = data * (1.0 / mag)[:, :, None, None]

            with trace.span("rx.front_end.demap"):
                z_hat = ofdm.qpsk_demap(data.reshape(B, -1,
                                                     cfg.latent_dim // 2))
        with trace.span("rx.decode"):
            if fused:
                if fused_core.merged_layout(dec_params) != fused_merged:
                    raise ValueError(
                        f"rx step built with fused_merged={fused_merged!r}: "
                        "the weights must come from decoder_weights(..., "
                        f"merged={fused_merged!r})")
                _check_quant(dec_params, fused_quant, "rx step")
                z_hat = z_hat.reshape(B, fps * cfg.Nzmf, cfg.latent_dim)
                return fused_core.fused_decoder_step(dec_params, z_hat,
                                                     dec_state, cd)
            return decoder(dec_params, z_hat, key=None, state=dec_state)

    return step


def make_streaming_tx_step(cfg: RADAEConfig, encoder: CoreEncoder,
                           batch: int, fused: bool = False, fused_quant=None,
                           device="cuda"):
    """Batched streaming tx step.

    step(enc_params, features (B, 12, F), enc_state)
      -> (tx_packed (B, Nmf, 2), new_state)

    fused=True: enc_params comes from `fused_core.encoder_weights` (with
    quant=fused_quant) and enc_state from `encoder_state_zero`."""
    _check_fused(fused, fused_quant)
    dev = f32_device(device)
    Winv = cplx.const(cfg.Winv, dev)
    P = cplx.const(cfg.P, dev)

    def step(enc_params, features, enc_state):
        B = features.shape[0]
        if B != batch:
            raise ValueError(f"tx step built for batch {batch}, got {B}")
        with trace.span("tx.encode"):
            if fused:
                _check_quant(enc_params, fused_quant, "tx step")
                z, enc_state = fused_core.fused_encoder_step(
                    enc_params, features, enc_state, cfg.bottleneck)
            else:
                z, enc_state = encoder(enc_params, features, key=None,
                                       state=enc_state)
        with trace.span("tx.modulate", dev):
            return ofdm.modulate(cfg, z, P, Winv), enc_state

    return step


def make_batched_receiver(cfg: RADAEConfig, decoder: CoreDecoder,
                          batch: int, n_frames: int,
                          fused: bool = False, fused_quant=None,
                          fused_dtype=None, fused_merged=False,
                          n_windows: int = 1, refine: bool = False,
                          eoo: bool = False, device="cuda"):
    """Whole-over batched receiver: acquires, aligns, derotates and decodes
    B independent raw IQ streams (port of radae_tpu's
    `make_batched_receiver`, which does it in one jitted program).

    rx(dec_params, rx_packed (B, T, 2)) ->
        (features (B, n_frames, 12, feature_dim),
         candidate (B,) bool, tmax (B,) int32, fmax (B,) float32)

    or, when any of (n_windows > 1, refine, eoo) is set, a
    dict with keys features/candidate/tmax/fmax/win/snrdB_3k plus (when
    eoo) eoo_detected (B,) bool, eoo_frame (B,) int32 (the first frame
    position whose end-of-over correlation exceeds the threshold;
    n_frames+1 if none) and eoo_bits (B, Nseoo*bps) soft bits of that
    frame.  rx_packed may be a numpy array or a tensor; it is moved to the
    receiver's device.

    * n_windows=K retries the detection over K successive 2-frame windows
      with the product receiver's search->candidate->acquired machine
      (`ops.acquisition_op.make_detect_pilots_windowed`);
    * refine=True adds the fine +-2 Hz / 0.25 Hz, +-2 sample search;
    * eoo=True scans every frame position for the end-of-over marker and
      demodulates the detected EOO frame's data symbols;
    * with any of these the receiver also measures the residual frequency
      from each symbol's cyclic prefix, snapped to the 1/Tmf alias grid of
      the pilot metric, and derotates by it (radae_tpu's cp_correct
      default).

    Alignment is a barrel shift by the bits of tmax - Ncp with the last
    sample replicated at the tail; derotation multiplies by a phasor ramp
    made of a 128-wide lo table and a hi table (t = 128 hi + lo).  The
    frames are decoded in a loop over `make_streaming_rx_step`, which gets
    `fused`, `fused_quant`, `fused_dtype` and `fused_merged`; with
    fused=True dec_params are `fused_core.decoder_weights(..., merged=
    fused_merged, quant=fused_quant)` and the batch must be `batch`.
    Streams whose `candidate` is False still give (garbage) features.

    T must be >= (n_windows+1)*Nmf + M + Ncp (acquisition windows) and
    >= tmax_max + (n_frames+1)*Nmf + Ncp for a full decode; short buffers
    are edge-padded."""
    from .ops.acquisition_op import (make_detect_pilots,
                                     make_detect_pilots_windowed,
                                     make_refine)

    _check_fused(fused, fused_quant, fused_dtype, fused_merged)
    dev = f32_device(device)
    M, Ncp, Nmf, Fs, Ns, Nc = cfg.M, cfg.Ncp, cfg.Nmf, cfg.Fs, cfg.Ns, cfg.Nc
    extended = (n_windows > 1) or refine or eoo
    if n_windows > 1:
        detect_w = make_detect_pilots_windowed(cfg, n_windows, device=dev)
    else:
        detect = make_detect_pilots(cfg, device=dev)
    refine_fn = make_refine(cfg, device=dev) if refine else None
    frame_len = (Ns + 2) * (M + Ncp)          # rx-step window incl. next pilot
    Wfwd = cplx.const(cfg.Wfwd, dev)
    ls = pilots_ops.ls_consts(cfg.P, cfg.w, Fs, dev)
    nbits = max(1, int(np.ceil(np.log2(n_windows * Nmf))))
    lo = torch.arange(128, dtype=torch.float32, device=dev)

    def shift(x, sh):
        return torch.cat([x[:, sh:], x[:, -1:].expand(x.shape[0], sh)], dim=1)

    def derotate(wr, wi, f_hz, offs, n_keep):
        theta = -2.0 * np.pi * f_hz / Fs                       # (B,)
        hi_n = -(-n_keep // 128)
        a_lo = theta[:, None] * lo[None, :]
        a_hi = theta[:, None] * (
            128.0 * torch.arange(hi_n, dtype=torch.float32, device=dev)[None, :]
            + offs[:, None].to(torch.float32))
        cl, sl = torch.cos(a_lo), torch.sin(a_lo)              # (B, 128)
        ch, sh_ = torch.cos(a_hi), torch.sin(a_hi)             # (B, hi_n)
        B_ = wr.shape[0]
        ramp_r = (ch[:, :, None] * cl[:, None, :]
                  - sh_[:, :, None] * sl[:, None, :]).reshape(
                      B_, hi_n * 128)[:, :n_keep]
        ramp_i = (ch[:, :, None] * sl[:, None, :]
                  + sh_[:, :, None] * cl[:, None, :]).reshape(
                      B_, hi_n * 128)[:, :n_keep]
        return wr * ramp_r - wi * ramp_i, wr * ramp_i + wi * ramp_r

    def rx(dec_params, rx_packed):
        rx_packed = torch.as_tensor(rx_packed, dtype=torch.float32,
                                    device=dev)
        B, T = rx_packed.shape[0], rx_packed.shape[1]
        if fused and B != batch:
            raise ValueError(f"fused batched receiver was built for batch="
                             f"{batch} but got rx batch {B}")
        step = make_streaming_rx_step(cfg, decoder, B, fused=fused,
                                      fused_merged=fused_merged,
                                      fused_quant=fused_quant,
                                      fused_dtype=fused_dtype, device=dev)
        if n_windows > 1:
            candidate, tmax, fmax, win, Dthresh = detect_w(rx_packed)
        else:
            candidate, tmax, fmax, Dthresh, _ = detect(
                rx_packed[:, :2 * Nmf + M + Ncp])
            win = torch.zeros((B,), dtype=torch.int32, device=dev)
        xr, xi = rx_packed[..., 0], rx_packed[..., 1]
        if refine_fn is not None:
            tmax, fmax = refine_fn(xr, xi, tmax, fmax)

        # align first: shift each row left by start = tmax - Ncp, one
        # conditional power-of-two shift per bit of start, the last sample
        # replicated at the tail (x[min(t + start, T - 1)])
        start = torch.clamp(tmax - Ncp, min=0)
        for k in range(nbits):
            sh = 1 << k
            bit = (((start >> k) & 1) > 0)[:, None]
            xr = torch.where(bit, shift(xr, sh), xr)
            xi = torch.where(bit, shift(xi, sh), xi)
        n_keep = T - n_windows * Nmf           # worst-case usable tail
        xr, xi = xr[:, :n_keep], xi[:, :n_keep]
        # then derotate by fmax, with each row's absolute-time phase offset
        ar, ai = derotate(xr, xi, fmax, start, n_keep)

        if extended:
            # CP frequency discriminator: each symbol's CP repeats M samples
            # later, so the angle of the summed conj(cp) * tail measures the
            # residual within +-Fs/2M; snapped to the 1/Tmf alias grid of
            # the pilot metric, applied only near a nonzero multiple
            d_skip = Ncp // 2                 # skip the multipath ISI region
            w_cp = Ncp - d_skip
            n_sym = min(2 * (Ns + 1), max(1, (n_keep - M - Ncp) // (M + Ncp)))
            cr = ci = 0.0
            for k in range(n_sym):
                st_ = k * (M + Ncp) + d_skip
                a_r, a_i = ar[:, st_:st_ + w_cp], ai[:, st_:st_ + w_cp]
                b_r = ar[:, st_ + M:st_ + M + w_cp]
                b_i = ai[:, st_ + M:st_ + M + w_cp]
                cr = cr + (a_r * b_r + a_i * b_i).sum(dim=1)
                ci = ci + (a_r * b_i - a_i * b_r).sum(dim=1)
            f_res = torch.atan2(ci, cr) * (Fs / (2.0 * np.pi * M))
            f_alias = float(1.0 / cfg.Tmf)
            k = torch.clamp(torch.round(f_res / f_alias), -3.0, 3.0)
            near = torch.abs(f_res - k * f_alias) < 3.0
            f_res = torch.where((k != 0.0) & near, k * f_alias, 0.0)
            ar, ai = derotate(ar, ai, f_res, torch.zeros_like(start), n_keep)
            fmax = fmax + f_res

        # edge-pad up to every window the frame loop and the EOO scan read
        need = (n_frames - 1) * Nmf + frame_len
        if eoo:
            need = max(need, (n_frames + 1) * Nmf + Ncp + M + Ncp)
        pad_n = max(0, need - n_keep)
        if pad_n:
            ar = torch.cat([ar, ar[:, -1:].expand(B, pad_n)], dim=1)
            ai = torch.cat([ai, ai[:, -1:].expand(B, pad_n)], dim=1)

        if fused:
            state = fused_core.decoder_state_zero(B, dev,
                                                  merged=bool(fused_merged))
        else:
            state = decoder.zero_state(B, dev)
        feats = []
        for k in range(n_frames):
            off = k * Nmf
            f, state = step(dec_params, torch.stack(
                [ar[:, off:off + frame_len], ai[:, off:off + frame_len]],
                dim=-1), state)
            feats.append(f)
        feats = torch.stack(feats, dim=1)
        if not extended:
            return feats, candidate, tmax, fmax
        out = {"features": feats, "candidate": candidate, "tmax": tmax,
               "fmax": fmax, "win": win, "snrdB_3k": _est_snr(ar, ai)}
        if eoo:
            out.update(_eoo_scan(ar, ai, Dthresh))
        return out

    def _est_snr(ar, ai):
        """Per-stream SNR (dB in 3 kHz) from the decoded frames' pilot
        rows: each pilot row rotated by its LS channel estimate's phase,
        total power against quadrature (noise-only) power, floored, the
        calibration line applied, averaged over the frames."""
        po = Ncp + cfg.time_offset
        pr = torch.stack([ar[:, k * Nmf + po:k * Nmf + po + M]
                          for k in range(n_frames)], dim=1)    # (B, K, M)
        pi_ = torch.stack([ai[:, k * Nmf + po:k * Nmf + po + M]
                           for k in range(n_frames)], dim=1)
        P_sym = ofdm.dft(cplx.C(pr, pi_), Wfwd)                # (B, K, Nc)
        R = P_sym * pilots_ops.est_pilots_ls(P_sym, ls).unit().conj()
        S1 = P_sym.abs2().sum(dim=-1)                          # (B, K)
        S2 = (R.im ** 2).sum(dim=-1) + 1e-12
        snr = torch.clamp(S1 / (2.0 * S2) - 1.0, min=0.1)
        snr_db = (10.0 * torch.log10(snr)
                  - calibration.SNR_CAL_C) / calibration.SNR_CAL_M
        Rs = Fs / M
        snr3k = (snr_db + 10.0 * np.log10(Rs * Nc / 3000.0)
                 + 10.0 * np.log10((M + Ncp) / M))
        return snr3k.mean(dim=1)

    pend = cplx.const(cfg.pend, dev)
    invP = cplx.const((1.0 / cfg.P).astype(np.complex64), dev)
    invPend = cplx.const((1.0 / cfg.Pend).astype(np.complex64), dev)

    def _eoo_scan(ar, ai, Dthresh):
        """End-of-over detection on the aligned, derotated buffer: the
        correlation of both `pend` copies of each frame position against
        the acquisition threshold (reference: dsp.py:300-320; EOO layout
        P,E..E radae.py:206-222), then the detected frame's data symbols
        by a mean-phase per-carrier EQ over its three known symbols
        (reference: dsp.py:513-524)."""
        B = ar.shape[0]
        K = n_frames + 1
        o1 = [k * Nmf + Ncp + M + Ncp for k in range(K)]
        o2 = [k * Nmf + Ncp + Nmf for k in range(K)]

        def corr_abs(offs):                     # |sum conj(e) * pend|
            er = torch.stack([ar[:, o:o + M] for o in offs], dim=1)  # (B,K,M)
            ei = torch.stack([ai[:, o:o + M] for o in offs], dim=1)
            cr = er @ pend.re + ei @ pend.im
            ci = er @ pend.im - ei @ pend.re
            return torch.sqrt(cr * cr + ci * ci)

        hit = corr_abs(o1) + corr_abs(o2) > Dthresh[:, None]      # (B, K)
        eoo_detected = hit.any(dim=1)
        first = torch.argmax(hit.to(torch.uint8), dim=1).to(torch.int32)
        eoo_frame = torch.where(eoo_detected, first, K)
        # the detected frame's Ns+2 symbol rows from its frame boundary
        wlen = Nmf + M + Ncp
        sel = torch.clamp(eoo_frame, 0, K - 1).long()
        rows = (sel * Nmf)[:, None] + torch.arange(wlen, device=ar.device)
        wr, wi = torch.gather(ar, 1, rows), torch.gather(ai, 1, rows)
        n_rs = wlen // (M + Ncp)                               # Ns + 2
        rxw = cplx.C(wr, wi).reshape(B, n_rs, M + Ncp)
        rx_sym = ofdm.dft(ofdm.strip_cp(rxw, M, Ncp, cfg.time_offset), Wfwd)
        Nse = Ns + 1
        s = (cplx.mul_const(rx_sym[:, 0, :], invP)
             + cplx.mul_const(rx_sym[:, 1, :], invPend)
             + cplx.mul_const(rx_sym[:, Nse, :], invPend))     # (B, Nc)
        rot = s.unit().conj()
        eq = rx_sym * cplx.C(rot.re[:, None, :], rot.im[:, None, :])
        data = eq[:, 2:Nse, :].reshape(B, -1)
        return {"eoo_detected": eoo_detected,
                "eoo_frame": eoo_frame.to(torch.int32),
                "eoo_bits": ofdm.qpsk_demap(data)}

    return rx
