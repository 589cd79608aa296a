"""Device ms a call of every operation that is not a core codec kernel (one
with a file under kernels/): the modem's front end or modulator and the
step's glue (device trace)."""

from benchmark.kernels import is_core


def read(ctx):
    if ctx.trace is None or not ctx.trace.kernels:
        return None
    return 1e3 * sum(d for n, _, d in ctx.trace.kernels
                     if not is_core(n)) / ctx.calls
