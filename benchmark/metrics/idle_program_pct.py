"""The share of the traced window in which no device operation ran while
the host was inside one of the program's top-level spans: the card waiting
on the program's own host work (device trace; None off the card).

Each call's top-level spans are placed on the card's clock by that call's
start there (`spans.card_calls`): the harness's CUDA event before the call
fires, on an idle stream, as the call's first span begins (tens of us
before it)."""

from benchmark import spans


def read(ctx):
    calls = spans.card_calls(ctx)
    if calls is None:
        return None
    top = sorted((s for s in spans.records(ctx) if s.parent is None),
                 key=lambda s: s.t0_ns)
    n, rest = divmod(len(top), ctx.calls)
    if rest:
        raise RuntimeError(f"{len(top)} top-level spans for {ctx.calls} "
                           "calls")
    on_card = []
    for k, c in enumerate(calls):
        group = top[k * n:(k + 1) * n]
        shift = c.start - 1e-9 * group[0].t0_ns
        on_card += [(1e-9 * s.t0_ns + shift, 1e-9 * s.t1_ns + shift)
                    for s in group]
    busy = [(a, a + d) for _, a, d in ctx.trace.kernels]
    return 100.0 * spans.uncovered(on_card, busy) / ctx.trace.window_s
