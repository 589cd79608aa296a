"""Host ms a call inside the program's top-level modem span (`rx.front_end`,
`tx.modulate` or `file.front_end`, radae_tpu_torch/trace.py): issuing the
modem's operations (host clock, traced run)."""

from benchmark import spans


def read(ctx):
    found = spans.modem(ctx)
    if found is None:
        return None
    return sum(s.host_ms for s in found) / ctx.calls
