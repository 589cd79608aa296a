"""Batch inference: features -> tx -> channel -> rx -> features_hat (port of
`radae_tpu/tools/inference.py`; reference: inference.py:1-302).

Loads a checkpoint (or draws a random model from --seed), rounds the
features to modem frames, loads H/G channel files, runs RADAE.forward on the
device, prints target against measured Eb/No, C/No, SNR and PAPR, and
writes features_hat, latents, tx and rx streams, the rx optionally with an
EOO frame, pre/appended noise and a sine interferer (numpy draws from
default_rng(seed + 1), as radae_tpu's).

    python -m radae_tpu_torch inference model.npz features.f32 \
        features_hat.f32 [flags] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..channel.doppler import load_g_file
from ..config import RADAEConfig
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32, write_f32
from ..models.core import distortion_loss
from ..models.radae import RADAE
from .tx_batch import load_params


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_name", type=str,
                   help="checkpoint (.npz or .pth), or random")
    p.add_argument("features", type=str)
    p.add_argument("features_hat", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--write_latent", type=str, default="")
    p.add_argument("--EbNodB", type=float, default=100)
    p.add_argument("--passthru", action="store_true")
    p.add_argument("--mp_test", action="store_true")
    p.add_argument("--ber_test", action="store_true")
    p.add_argument("--h_file", type=str, default="")
    p.add_argument("--g_file", type=str, default="")
    p.add_argument("--rate_Fs", action="store_true")
    p.add_argument("--write_rx", type=str, default="")
    p.add_argument("--rx_gain", type=float, default=1.0)
    p.add_argument("--write_tx", type=str, default="")
    p.add_argument("--phase_offset", type=float, default=0)
    p.add_argument("--freq_offset", type=float, default=0)
    p.add_argument("--time_offset", type=int, default=0)
    p.add_argument("--df_dt", type=float, default=0)
    p.add_argument("--gain", type=float, default=1.0)
    p.add_argument("--pilots", action="store_true")
    p.add_argument("--pilot_eq", action="store_true")
    p.add_argument("--eq_ls", action="store_true")
    p.add_argument("--cp", type=float, default=0.0)
    p.add_argument("--coarse_mag", action="store_true")
    p.add_argument("--bottleneck", type=int, default=1)
    p.add_argument("--loss_test", type=float, default=0.0)
    p.add_argument("--prepend_noise", type=float, default=0.0)
    p.add_argument("--append_noise", type=float, default=0.0)
    p.add_argument("--end_of_over", action="store_true")
    p.add_argument("--correct_freq_offset", action="store_true")
    p.add_argument("--sine_amp", type=float, default=0.0)
    p.add_argument("--sine_freq", type=float, default=1000.0)
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    return p


def _c64(x) -> np.ndarray:
    """A C of device tensors -> host complex64."""
    return (x.re.cpu().numpy() + 1j * x.im.cpu().numpy()).astype(np.complex64)


def run(args):
    num_features = 21 if args.auxdata else 20
    cfg = RADAEConfig(
        feature_dim=num_features, latent_dim=args.latent_dim,
        EbNodB=args.EbNodB, ber_test=args.ber_test, rate_Fs=args.rate_Fs,
        phase_offset=args.phase_offset, freq_offset=args.freq_offset,
        df_dt=args.df_dt, gain=args.gain, pilots=args.pilots,
        pilot_eq=args.pilot_eq, eq_mean6=not args.eq_ls,
        cyclic_prefix=args.cp, time_offset=args.time_offset,
        coarse_mag=args.coarse_mag, bottleneck=args.bottleneck,
        correct_freq_offset=args.correct_freq_offset)

    features_in = read_f32(args.features, NB_TOTAL_FEATURES)
    if args.passthru:
        write_f32(args.features_hat, features_in)
        return {}

    model = RADAE(cfg, args.device)
    params = load_params(args.model_name, lambda: model.init(args.seed))

    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(features_in.shape[0])
    feats = features_in[None, :T, :NUM_USED_FEATURES].copy()
    if args.auxdata:
        aux = -np.ones((1, T, 1), np.float32)
        feats = np.concatenate([feats, aux], axis=2)
    print(f"Processing: {T} feature vectors", file=sys.stderr)

    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    Nc, Rs, B = cfg.Nc, cfg.Rs, 3000

    # rate-Rs channel H
    H = model.default_H(1, n_rs)
    if args.mp_test:
        # contrived notch channel H = |G1 + G2 e^{-j w d Rs}| (inference.py:134-143)
        G1 = G2 = 1.0
        d = 0.002
        for c in range(Nc):
            omega = 2 * np.pi * c
            H[0, :, c] = np.abs(G1 + G2 * np.exp(-1j * omega * d * Rs))
    if args.h_file:
        Hf = read_f32(args.h_file, Nc)
        if Hf.shape[0] < n_rs:
            print("Multipath H file too short", file=sys.stderr)
            sys.exit(1)
        H = Hf[None, :n_rs, :]

    # rate-Fs channel G
    G = None
    if cfg.rate_Fs:
        n_fs = cfg.num_timesteps_at_rate_Fs(n_rs)
        if args.g_file:
            Gf = load_g_file(args.g_file)
            if Gf.shape[0] < n_fs:
                print("Multipath Doppler spread file too short",
                      file=sys.stderr)
                sys.exit(1)
            G = Gf[None, :n_fs, :]
        else:
            G = model.default_G(1, n_fs)

    key = torch.Generator(device=model.device)
    key.manual_seed(args.seed)
    with torch.no_grad():
        out = model.forward(params, feats, H, G, key=key)

    # -- target/measured operating point (inference.py:187-229) -------------
    EbNo = 10 ** (args.EbNodB / 10)
    SNRdB = 10 * np.log10(EbNo * cfg.Rb / B)
    CNodB = 10 * np.log10(EbNo * cfg.Rb)
    print("          Eb/No   C/No     SNR3k  Rb'    Eq     PAPR")
    print(f"Target..: {args.EbNodB:6.2f}  {CNodB:6.2f}  {SNRdB:6.2f}  "
          f"{int(cfg.Rb_dash):d}")
    sigma = float(out["sigma"].flatten()[0])
    if cfg.rate_Fs:
        tx = _c64(out["tx"])
        S = np.mean(np.abs(tx) ** 2)
        N = sigma ** 2
        CNodB_meas = 10 * np.log10(S * cfg.Fs / N)
        EbNodB_meas = CNodB_meas + 10 * np.log10(cfg.M / (cfg.Fs * Nc * cfg.bps))
        SNRdB_meas = CNodB_meas - 10 * np.log10(B)
        PAPRdB = 20 * np.log10(np.max(np.abs(tx)) / np.sqrt(S))
        print(f"Measured: {EbNodB_meas:6.2f}  {CNodB_meas:6.2f}  "
              f"{SNRdB_meas:6.2f}                {PAPRdB:5.2f}")
    else:
        tx_sym = _c64(out["tx_sym"])
        Eq_meas = np.mean(np.abs(tx_sym) ** 2)
        No = sigma ** 2
        EqNodB_meas = 10 * np.log10(Eq_meas / No)
        SNRdB_meas = EqNodB_meas + 10 * np.log10(Rs * Nc / B)
        if cfg.bottleneck == 3:
            tx = _c64(out["tx"])
            S = np.mean(np.abs(tx) ** 2)
            PAPRdB = 20 * np.log10(np.max(np.abs(tx)) / np.sqrt(S))
            print(f"Measured: {EqNodB_meas-3:6.2f}          {SNRdB_meas:6.2f}"
                  f"       {Eq_meas:7.2f} {PAPRdB:5.2f}")
        else:
            print(f"Measured: {EqNodB_meas-3:6.2f}          {SNRdB_meas:6.2f}"
                  f"       {Eq_meas:7.2f}")

    if args.ber_test:
        n_bits = int(out["n_bits"])
        n_err = int(out["n_errors"])
        print(f"n_bits: {n_bits:d} BER: {n_err/n_bits:5.3f}")

    features_hat = out["features_hat"].cpu().numpy()
    pad = np.zeros(features_hat.shape[:2]
                   + (NB_TOTAL_FEATURES - NUM_USED_FEATURES,), np.float32)
    write_f32(args.features_hat,
              np.concatenate([features_hat[:, :, :NUM_USED_FEATURES], pad],
                             axis=-1))

    loss = float(distortion_loss(torch.as_tensor(feats),
                                 torch.as_tensor(features_hat))[0])
    if args.auxdata:
        x = (feats[..., 20] * features_hat[..., 20]).flatten()
        ber = float((x < 0).mean())
        print(f"loss: {loss:5.3f} Auxdata BER: {ber:5.3f}")
    else:
        print(f"loss: {loss:5.3f}")
    if args.loss_test > 0.0:
        print("PASS" if loss < args.loss_test else "FAIL")

    if args.write_latent:
        write_f32(args.write_latent, out["z_hat"].cpu().numpy())

    rng = np.random.default_rng(args.seed + 1)
    if args.write_rx:
        if not cfg.rate_Fs:
            print("\nWARNING: Need --rate_Fs for --write_rx", file=sys.stderr)
        else:
            rx = _c64(out["rx"]).flatten()
            if args.end_of_over:
                eoo = cfg.eoo.flatten().astype(np.complex64)
                # continue the phase/freq track through the EOO
                # (inference.py:263-276)
                n = len(eoo)
                freq = args.freq_offset + args.df_dt * np.arange(n) / cfg.Fs
                lin_phase = np.exp(1j * np.cumsum(freq * 2 * np.pi / cfg.Fs))
                fp = _c64(out["final_phase"])[0]
                eoo = eoo * lin_phase * fp
                eoo = eoo + sigma * _cn(rng, n)
                rx = np.concatenate([rx, eoo])
            if args.prepend_noise > 0:
                n = int(cfg.Fs * args.prepend_noise)
                rx = np.concatenate([sigma * _cn(rng, n), rx])
            if args.append_noise > 0:
                n = int(cfg.Fs * args.append_noise)
                rx = np.concatenate([rx, sigma * _cn(rng, n)])
            if args.sine_amp > 0:
                rx = rx + args.sine_amp * np.exp(
                    1j * np.arange(len(rx)) * 2 * np.pi * args.sine_freq / cfg.Fs)
            (args.rx_gain * rx).astype(np.complex64).tofile(args.write_rx)

    if args.write_tx:
        if cfg.bottleneck == 3 or cfg.rate_Fs:
            _c64(out["tx"]).flatten().tofile(args.write_tx)
        else:
            print("\nWARNING: Need --bottleneck 3 for --write_tx", file=sys.stderr)
    return {"loss": loss}


def _cn(rng, n):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2)).astype(np.complex64)


def main(argv=None):
    run(build_parser().parse_args(argv))
    return 0


if __name__ == "__main__":
    sys.exit(main())
