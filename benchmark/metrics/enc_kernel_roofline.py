"""The encoder kernel's share of its roofline (device trace; its counts in
kernels/enc_kernel.py)."""

from benchmark.kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "enc_kernel")
