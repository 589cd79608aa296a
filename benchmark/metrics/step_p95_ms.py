"""The 95th percentile, over every call of the window, of a call's time from
its issue to its outputs being ready: CUDA events on the card's clock, one
recorded on the idle stream before the call is issued and one after it
returns, read once the call is synchronised (nearest rank)."""

import math


def read(ctx):
    if not ctx.call_dev_s:
        return None
    q = sorted(ctx.call_dev_s)
    return 1e3 * q[math.ceil(0.95 * len(q)) - 1]
