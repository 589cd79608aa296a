"""Pilot-statistics SNR estimator prototype + calibration sweep (port of
`radae_tpu/tools/est_snr.py`).

Equivalent of the reference est_snr.py (reference: est_snr.py:45-244):
sweeps target SNR, passes pilot symbols through an AWGN (or fading)
channel, estimates SNR from the pilot-row statistics (the same estimator
embedded in the streaming receiver, dsp.py:437-456), and fits the
straight-line correction snr_est = m*snr + c used at runtime.

The sweep is numpy.  `--refit` (`refit_pipeline`) refits the line on the
port's own per-frame transmitter and receiver (`dsp/streaming.py`), which
run on `--device` (default cuda; refused without a card).
"""

from __future__ import annotations

import argparse

import numpy as np

from ..config import flagship_config


def pilot_snr_est(rx_pilots_eq, rx_pilot_row):
    """SNR estimate from one received pilot row: signal power from total,
    noise power from the quadrature component after phase correction."""
    S1 = np.sum(np.abs(rx_pilot_row) ** 2)
    S2 = np.sum(rx_pilots_eq.imag ** 2) + 1e-12
    snr = S1 / (2 * S2) - 1
    return max(snr, 0.1)


def run_sweep(snr_range, nframes=50, fading=False, rng=None, verbose=False):
    """Returns (target_snrdB[], est_snrdB[]) over the sweep."""
    if rng is None:
        rng = np.random.default_rng(0)
    cfg = flagship_config()
    P = cfg.P
    Nc = cfg.Nc
    targets, ests = [], []
    for snrdB in snr_range:
        snr = 10 ** (snrdB / 10)
        # per-symbol noise so that pilot-row SNR = snr
        sigma = np.sqrt(np.mean(np.abs(P) ** 2) / (2 * snr))
        est_acc = []
        for _ in range(nframes):
            h = np.ones(Nc, np.complex64)
            if fading:
                h = ((rng.standard_normal(Nc) + 1j * rng.standard_normal(Nc))
                     / np.sqrt(2)).astype(np.complex64)
            rx_row = h * P + sigma * (rng.standard_normal(Nc)
                                      + 1j * rng.standard_normal(Nc))
            # genie phase correction (perfect channel phase)
            eq = rx_row * np.exp(-1j * np.angle(h * P))
            est_acc.append(pilot_snr_est(eq, rx_row))
        est_dB = 10 * np.log10(np.mean(est_acc))
        targets.append(snrdB)
        ests.append(est_dB)
        if verbose:
            print(f"target: {snrdB:6.2f} est: {est_dB:6.2f}")
    return np.array(targets), np.array(ests)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--first", type=float, default=-5)
    p.add_argument("--last", type=float, default=20)
    p.add_argument("--step", type=float, default=2.5)
    p.add_argument("--fading", action="store_true")
    p.add_argument("--nframes", type=int, default=50)
    p.add_argument("--refit", action="store_true",
                   help="refit m/c on THIS pipeline (refit_pipeline) and "
                        "print the update instructions for "
                        "radae_tpu_torch/calibration.py")
    p.add_argument("--device", default="cuda",
                   help="torch device of --refit's transmitter and receiver "
                        "(default cuda; cpu runs them on the host)")
    args = p.parse_args(argv)
    if args.refit:
        from .. import calibration
        m, c, _, _ = refit_pipeline(verbose=True, device=args.device)
        print(f"refit on this pipeline: m: {m:.4f} c: {c:.3f}")
        print(f"deployed (radae_tpu_torch/calibration.py): "
              f"m: {calibration.SNR_CAL_M} c: {calibration.SNR_CAL_C}")
        print("to deploy: edit SNR_CAL_M/SNR_CAL_C in "
              "radae_tpu_torch/calibration.py and radae_tpu/calibration.py "
              "(a test holds the two packages' constants equal), then "
              "regenerate native/snr_cal.h via "
              "calibration.write_native_header()")
        return
    t, e = run_sweep(np.arange(args.first, args.last, args.step),
                     nframes=args.nframes, fading=args.fading, verbose=True)
    m, c = np.polyfit(t, e, 1)
    print(f"straight line fit: m: {m:.4f} c: {c:.3f}")
    print(f"(runtime correction applies snrdB_est = (est - c)/m;"
          f" deployed constants m=0.8070 c=2.513)")


def pipeline_stream(cfg, nframes, rng, device="cuda"):
    """The transmitted stream refit_pipeline measures: nframes + 2 frames of
    +-100 latents through TransmitterOne, as complex64 numpy."""
    from ..dsp.streaming import TransmitterOne
    tx1 = TransmitterOne(cfg, device)
    z = 100 * np.sign(rng.standard_normal(
        (1, cfg.Nzmf, cfg.latent_dim))).astype(np.float32)
    return np.concatenate([tx1.transmit(np.roll(z, i))
                           for i in range(nframes + 2)])


def raw_stats(receiver, segment) -> np.ndarray:
    """The receiver's pilot statistics [S1, S2] of one P DDDD P segment
    (ReceiverOne._rx, where radae_tpu calls _jit_rx)."""
    from ..ops import cplx
    _, stats = receiver._rx(cplx.from_c64(segment, receiver.device))
    return stats.cpu().numpy()


def refit_pipeline(snr3k_range=None, nframes=20, seed=0, verbose=False,
                   device="cuda"):
    """Refit the m/c straight line on THIS pipeline (TransmitterOne ->
    calibrated AWGN -> ReceiverOne raw pilot statistics), rather than
    reusing the reference's empirical fit (reference: dsp.py:415-416).

    Returns (m, c, fitted_targets, raw_estimates)."""
    import math
    from ..dsp.streaming import ReceiverOne

    if snr3k_range is None:
        snr3k_range = np.arange(-6.0, 16.0, 2.0)
    rng = np.random.default_rng(seed)
    cfg = flagship_config()
    stream = pipeline_stream(cfg, nframes, rng, device)
    S = (np.abs(stream) ** 2).mean()
    Rs = cfg.Fs / cfg.M
    conv = (10 * math.log10(Rs * cfg.Nc / 3000)
            + 10 * math.log10((cfg.M + cfg.Ncp) / cfg.M))

    r = ReceiverOne(cfg, device)
    targets, raws = [], []
    for snr3k in snr3k_range:
        sigma2 = S / 10 ** (snr3k / 10) * cfg.Fs / 3000
        noisy = stream + np.sqrt(sigma2 / 2) * (
            rng.standard_normal(len(stream))
            + 1j * rng.standard_normal(len(stream)))
        ests = []
        for i in range(nframes):
            seg = noisy[i * cfg.Nmf: i * cfg.Nmf + cfg.Nmf + cfg.M + cfg.Ncp]
            S1, S2 = raw_stats(r, seg.astype(np.complex64))
            ests.append(max(S1 / (2 * S2) - 1, 0.1))
        raw_dB = 10 * np.log10(np.mean(ests))
        true_pilot_dB = snr3k - conv
        targets.append(true_pilot_dB)
        raws.append(raw_dB)
        if verbose:
            print(f"snr3k {snr3k:6.2f} pilot-true {true_pilot_dB:6.2f} "
                  f"raw est {raw_dB:6.2f}")
    m, c = np.polyfit(targets, raws, 1)
    return float(m), float(c), np.array(targets), np.array(raws)


if __name__ == "__main__":
    main()
