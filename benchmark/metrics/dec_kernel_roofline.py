"""The decoder kernel's share of its roofline (device trace; its counts in
kernels/dec_kernel.py)."""

from benchmark.kernels import roofline_pct


def read(ctx):
    return roofline_pct(ctx, "dec_kernel")
