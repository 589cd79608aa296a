"""Sample format converters: f32 <-> int16 streams, numpy only (a copy of
`radae_tpu/tools/converters.py`;
reference: f32toint16.py, int16tof32.py)."""

from __future__ import annotations

import argparse
import sys

import numpy as np


def f32toint16(argv=None):
    p = argparse.ArgumentParser(description="f32 stream -> int16 on stdout")
    p.add_argument("--scale", type=float, default=8192.0)
    p.add_argument("--real", action="store_true",
                   help="input is IQIQ complex, output real (I) only")
    args = p.parse_args(argv)
    while True:
        buf = sys.stdin.buffer.read(4096 * 4)
        if not buf:
            break
        x = np.frombuffer(buf, np.float32)
        if args.real:
            x = x[::2]
        y = np.clip(x * args.scale, -32767, 32767).astype(np.int16)
        sys.stdout.buffer.write(y.tobytes())


def int16tof32(argv=None):
    p = argparse.ArgumentParser(description="int16 stream -> f32 on stdout")
    p.add_argument("--scale", type=float, default=8192.0)
    p.add_argument("--zeropad", action="store_true",
                   help="output IQ with Q=0 from a real input")
    args = p.parse_args(argv)
    while True:
        buf = sys.stdin.buffer.read(4096 * 2)
        if not buf:
            break
        x = np.frombuffer(buf, np.int16).astype(np.float32) / args.scale
        if args.zeropad:
            y = np.zeros(2 * len(x), np.float32)
            y[::2] = x
            x = y
        sys.stdout.buffer.write(x.tobytes())
