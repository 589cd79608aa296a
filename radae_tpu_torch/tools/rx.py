"""Standalone file receiver: acquisition + decode of a rate-Fs IQ file (port
of `radae_tpu/tools/rx.py`; reference: rx.py:1-298).

BPF, the pilot acquisition state machine (search -> candidate with 3
consecutive matches -> acquired), fine refinement, frequency shift, then
either the vanilla batch receiver (RADAE.receiver: the whole file through
the unmerged f32 decoder kernel in one launch at B=1) or, with --stateful,
the per-frame receiver (dsp.streaming.ReceiverOne) and the same kernel one
modem frame (3 z-steps) a launch with its state carried, as apps/rxe.py
decodes.  --acq_test measures P(fail) and the mean acquisition time over
repeated trials (reference: rx.py:163-195).  The BPF and the acquisition
run on the host (numpy), the demod and the decoder on the device.

    python -m radae_tpu_torch rx model.npz rx.f32 features_hat.f32 \
        [--stateful] [--acq_test] [--device cpu]

A stream with nothing to acquire exits with status 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..config import RADAEConfig
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, write_f32
from ..dsp.acquisition import Acquisition
from ..dsp.bpf import ComplexBPF
from ..dsp.streaming import ReceiverOne
from ..models.radae import RADAE
from ..ops import fused_core
from .tx_batch import load_params


def acquire(cfg, rx, max_tries=None, verbose=False):
    """Run the acquisition state machine over the stream.

    Returns (acquired, tmax, fmax, frame_idx)."""
    acq = Acquisition(cfg.Fs, cfg.Rs, cfg.M, cfg.Ncp, cfg.Nmf, cfg.p, cfg.pend)
    Nmf = cfg.Nmf
    buflen = 2 * Nmf + cfg.M + cfg.Ncp
    state = "search"
    tmax_candidate = 0
    valid_count = 0
    mf = 0
    nframes = (len(rx) - buflen) // Nmf
    if max_tries is not None:
        nframes = min(nframes, max_tries)
    while mf < nframes:
        buf = rx[mf * Nmf: mf * Nmf + buflen]
        candidate, tmax, fmax = acq.detect_pilots(buf)
        if verbose:
            print(f"{mf:3d} state: {state:10s} candidate: {candidate:d} "
                  f"tmax: {tmax:4d} fmax: {fmax:6.2f}", file=sys.stderr)
        next_state = state
        if state == "search":
            if candidate:
                next_state = "candidate"
                tmax_candidate = tmax
                valid_count = 1
        elif state == "candidate":
            if candidate and abs(tmax - tmax_candidate) < 0.02 * cfg.M:
                valid_count += 1
                if valid_count > 3:
                    # fine refinement (rx.py:201-205)
                    tmax, fmax = acq.refine(
                        buf, tmax, fmax,
                        np.arange(max(0, tmax - 1), tmax + 2),
                        np.arange(fmax - 10, fmax + 10, 0.25))
                    return True, mf * Nmf + tmax, fmax, mf
            else:
                next_state = "search"
                valid_count = 0
        state = next_state
        mf += 1
    return False, 0, 0.0, mf


def decode_stateful(cfg, weights, rx, device):
    """Frame by frame: ReceiverOne's demod of each PDDDDP window, then the
    decoder kernel (nz = Nzmf a launch at B=1) with its state carried.
    Returns features (1, T, F) on the device."""
    r1 = ReceiverOne(cfg, device)
    state = fused_core.decoder_state_zero(1, r1.device)
    chunks = []
    nmf = (len(rx) - (cfg.M + cfg.Ncp)) // cfg.Nmf
    for i in range(nmf):
        seg = rx[i * cfg.Nmf: i * cfg.Nmf + cfg.Nmf + cfg.M + cfg.Ncp]
        z_hat = r1.receive(seg.astype(np.complex64))
        fh, state = fused_core.fused_decoder_step(weights, z_hat, state)
        chunks.append(fh)
    return torch.cat(chunks, dim=1)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_name", type=str)
    p.add_argument("rx", type=str, help="rate Fs IQ .f32 file")
    p.add_argument("features_hat", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--bottleneck", type=int, default=3)
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--time_offset", type=int, default=-16)
    p.add_argument("--coarse_mag", action="store_true", default=True)
    p.add_argument("--no_bpf", dest="bpf", action="store_false")
    p.add_argument("--stateful", action="store_true",
                   help="per-frame streaming receiver + stateful decoder")
    p.add_argument("--acq_test", action="store_true")
    p.add_argument("--ntrials", type=int, default=10)
    p.add_argument("--fmax_target", type=float, default=0.0)
    p.add_argument("-v", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.set_defaults(bpf=True)
    args = p.parse_args(argv)

    num_features = 21 if args.auxdata else 20
    cfg = RADAEConfig(feature_dim=num_features, latent_dim=args.latent_dim,
                      EbNodB=100, rate_Fs=True, pilots=True, pilot_eq=True,
                      eq_mean6=False, cyclic_prefix=0.004,
                      coarse_mag=args.coarse_mag,
                      time_offset=args.time_offset,
                      bottleneck=args.bottleneck)
    model = RADAE(cfg, args.device)

    rx = np.fromfile(args.rx, dtype=np.complex64)
    if args.bpf:
        w = cfg.w
        bw = 1.2 * (w[-1] - w[0]) * cfg.Fs / (2 * np.pi)
        centre = (w[-1] + w[0]) * cfg.Fs / (2 * np.pi) / 2
        bpf = ComplexBPF(101, cfg.Fs, bw, centre, len(rx))
        rx = bpf.bpf(rx)

    if args.acq_test:
        # repeated acquisition trials over slices (rx.py:163-195)
        fails, acq_times = 0, []
        Nmf = cfg.Nmf
        for trial in range(args.ntrials):
            start = trial * Nmf
            ok, t, f, mf = acquire(cfg, rx[start:], max_tries=13,
                                   verbose=args.v > 1)
            took = (mf + 1) * Nmf / cfg.Fs
            ferr = abs(f - args.fmax_target)
            if not ok or ferr > 1.0:
                fails += 1
            else:
                acq_times.append(took)
            if args.v:
                print(f"trial {trial}: ok {ok} t {took:.2f}s ferr {ferr:.2f}",
                      file=sys.stderr)
        Pfail = fails / args.ntrials
        mean_acq = np.mean(acq_times) if acq_times else 0.0
        print(f"P(fail): {Pfail:.2f} mean acq time: {mean_acq:.2f} s")
        return 0

    ok, t0, fmax, _ = acquire(cfg, rx, verbose=args.v > 0)
    if not ok:
        print("Acquisition failed", file=sys.stderr)
        sys.exit(1)
    print(f"Acquired: t: {t0} fmax: {fmax:.2f}", file=sys.stderr)

    # freq shift and trim to the modem frame boundary (rx.py:223-228)
    rx = rx * np.exp(-1j * 2 * np.pi * fmax * np.arange(len(rx)) / cfg.Fs)
    rx = rx[t0 - cfg.Ncp:]

    params = load_params(args.model_name, lambda: model.init(args.seed))

    with torch.no_grad():
        if args.stateful:
            features_hat = decode_stateful(
                cfg, model.kernel_weights(params, "decoder"), rx, model.device)
        else:
            features_hat, _ = model.receiver(params, rx.astype(np.complex64))
    features_hat = features_hat.cpu().numpy()

    out = np.zeros(features_hat.shape[1:2] + (NB_TOTAL_FEATURES,), np.float32)
    out[:, :NUM_USED_FEATURES] = features_hat[0, :, :NUM_USED_FEATURES]
    write_f32(args.features_hat, out)
    print(f"Wrote {out.shape[0]} feature vectors", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
