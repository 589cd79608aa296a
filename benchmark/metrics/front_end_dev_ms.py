"""Card ms a call of the program's own modem: the busy time of the device
operations inside the card window of the top-level modem span
(`rx.front_end`, `tx.modulate` or `file.front_end`), with no harness
gathers and no kernel-wrapper glue (device trace; None off the card).

The window is as long as the card time between the span's CUDA events and
sits where they fired, on the card's clock (`spans.card_calls`): from the
call's start on an idle stream when the modem comes first (rx, a file),
up to the core kernel; from the core kernel's end when it follows (tx).
The card's waits on the host's issue inside it are not counted."""

import bisect

from benchmark import spans
from benchmark.kernels import is_core

# the host time from the harness's event before a call to the modem span's
# first event, while the stream idles: the window's end may be that late
SLACK_S = 1e-4


def read(ctx):
    calls = spans.card_calls(ctx)
    if calls is None:
        return None
    ops = sorted((a, a + d) for n, a, d in ctx.trace.kernels
                 if not is_core(n))
    starts = [a for a, _ in ops]
    busy = 0.0
    for c in calls:
        span_s = 1e-3 * c.modem.card_ms
        if c.modem_after:
            w0, w1 = c.core[1], c.core[1] + span_s
        else:
            w0, w1 = c.start, min(c.start + span_s + SLACK_S, c.core[0])
        i = bisect.bisect_left(starts, w0)
        j = bisect.bisect_left(starts, w1, lo=i)
        busy += spans.covered([(a, min(b, w1)) for a, b in ops[i:j]])
    return 1e3 * busy / ctx.calls
