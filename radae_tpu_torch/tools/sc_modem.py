"""Single-carrier modem CLIs for the BBFM path: z symbols <-> int16 samples
over an FM radio (reference: sc_tx.py, sc_rx.py).  A copy of
`radae_tpu/tools/sc_modem.py`: numpy only, the same code, so it runs on
the host and takes no --device.

    python -m radae_tpu_torch sc_tx [--ber_test] < z.f32 > tx.int16
    python -m radae_tpu_torch sc_rx [--ber_test] < tx.int16 > z.f32
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from ..dsp.single_carrier import SingleCarrier


def _common(p):
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--fcentreHz", type=float, default=1500)
    p.add_argument("--Rs", type=float, default=2400)
    p.add_argument("--Fs", type=float, default=9600)
    p.add_argument("--complex", dest="real", action="store_false",
                   help="complex 2*int16 samples (default real)")
    p.add_argument("--ber_test", action="store_true")
    p.set_defaults(real=True)


def sc_tx(argv=None):
    p = argparse.ArgumentParser(
        description="z.f32 frames on stdin -> int16 modem samples on stdout")
    _common(p)
    p.add_argument("--scale", type=float, default=16384.0)
    args = p.parse_args(argv)

    if args.fcentreHz < args.Rs / 2 and args.real and args.fcentreHz != 0:
        print("Warning - aliasing likely with real output, consider --complex",
              file=sys.stderr)
    modem = SingleCarrier(Rs=int(args.Rs), Fs=int(args.Fs),
                          fcentreHz=args.fcentreHz)
    assert modem.Npayload_syms == args.latent_dim

    if args.ber_test:
        tx_symbs = (1 - 2 * (modem.rng.random(args.latent_dim) > 0.5) + 0j
                    ).astype(np.complex64)

    nbytes = args.latent_dim * 4
    frames = 0
    while True:
        buf = sys.stdin.buffer.read(nbytes)
        if len(buf) != nbytes:
            break
        z = np.frombuffer(buf, np.float32).astype(np.complex64)
        tx = args.scale * modem.tx(tx_symbs if args.ber_test else z)
        if args.real:
            tx = tx.real
            out = tx.astype(np.int16)
        else:
            out = np.zeros(2 * len(tx), np.int16)
            out[::2] = tx.real.astype(np.int16)
            out[1::2] = tx.imag.astype(np.int16)
        sys.stdout.buffer.write(out.tobytes())
        frames += 1
    print(f"{frames} frames processed", file=sys.stderr)


def sc_rx(argv=None):
    p = argparse.ArgumentParser(
        description="int16 modem samples on stdin -> z.f32 frames on stdout")
    _common(p)
    p.add_argument("-v", type=int, default=2)
    p.add_argument("--target_ber", type=float, default=2.0)
    args = p.parse_args(argv)

    modem = SingleCarrier(Rs=int(args.Rs), Fs=int(args.Fs),
                          fcentreHz=args.fcentreHz)
    assert modem.Npayload_syms == args.latent_dim
    ints = 1 if args.real else 2

    if args.ber_test:
        tx_symbs = (1 - 2 * (modem.rng.random(args.latent_dim) > 0.5) + 0j
                    ).astype(np.complex64)
        total_errors = total_bits = 0

    frames = 0
    while True:
        nbytes = modem.nin * ints * 2
        buf = sys.stdin.buffer.read(nbytes)
        if len(buf) != nbytes:
            break
        tmp = np.frombuffer(buf, np.int16)
        rx = np.zeros(modem.nin, np.complex64)
        if args.real:
            rx.real = tmp
        else:
            rx.real = tmp[::2]
            rx.imag = tmp[1::2]
        z_hat = modem.rx(rx)
        if modem.state == "sync":
            z_out = (modem.g * z_hat.real).astype(np.float32)
            sys.stdout.buffer.write(z_out.tobytes())
            if args.ber_test:
                n_errors = int(np.sum(z_out * tx_symbs.real < 0))
                total_errors += n_errors
                total_bits += len(tx_symbs)
        if args.v:
            print(f"state: {modem.state:6s} nin: {modem.nin:4d} "
                  f"rx_timing: {modem.norm_rx_timing:5.2f}", file=sys.stderr)
        frames += 1
    print(f"{frames} frames processed", file=sys.stderr)
    if args.ber_test:
        ber = total_errors / total_bits if total_bits else 0.0
        print(f"total_bits: {total_bits:4d} total_errors: {total_errors:4d} "
              f"BER: {ber:5.4f}", file=sys.stderr)
        if args.target_ber < 1:
            print("PASS" if ber <= args.target_ber else "FAIL", file=sys.stderr)
    return 0
