"""The whole step's share of the card's peak while the card is busy: the
model FLOPs of the traced window's calls (the core net's matrix products,
reference/roofline.py) over the seconds in which a device operation ran
over 989 TFLOP/s (device trace)."""

from benchmark.reference import roofline


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0.0:
        return None
    flops = sum(roofline.model_flops(w, ctx.cfg) for w in ctx.work)
    return 100.0 * flops / ctx.trace.busy_s / roofline.PEAK_FLOPS
