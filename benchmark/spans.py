"""The program's own spans (`radae_tpu_torch/trace.py`) as the per-layer
metrics read them.

The program records a span only while a torch profiler runs, so after a
traced run its buffer holds the spans of the measured window (`records`):
each `(name, parent, t0_ns, t1_ns, card_ms)`, t0_ns and t1_ns on the clock
of the device trace (`time.time_ns()`, kineto's), card_ms between the
span's CUDA events (None off the card).  A checkout of the program without the
module has no spans, and every reader then returns None.
"""

from __future__ import annotations

from typing import NamedTuple

from benchmark.kernels import is_core

# the top-level span of each serving path's modem: the rx front end, the
# tx modulator, a file's front end
MODEM = ("rx.front_end", "tx.modulate", "file.front_end")


class Call(NamedTuple):
    """One call of the window on the card's clock (s)."""
    start: float        # the harness's CUDA event before the call fired
    core: tuple         # (start, end) of the core codec kernel it launched
    modem: object       # its top-level modem span
    modem_after: bool   # the modem's work follows the core kernel (tx)


def records(ctx):
    """The program's span records of the run `ctx` reads, oldest first; []
    where the program has no trace module.  The run's first reader takes
    them out of the program's buffer and keeps them on ctx, so each of
    several traced runs in one process reads its own window's."""
    kept = getattr(ctx, "program_spans", None)
    if kept is None:
        try:
            from radae_tpu_torch import trace
        except ImportError:
            kept = []
        else:
            kept = trace.spans()
            trace.reset()
        ctx.program_spans = kept
    return kept


def modem(ctx):
    """The top-level modem spans of the window, one a call, or None where
    the buffer holds no span; raises where the count is not one a call."""
    recs = records(ctx)
    if not recs:
        return None
    found = [s for s in recs if s.parent is None and s.name in MODEM]
    if len(found) != ctx.calls:
        raise RuntimeError(f"{len(found)} top-level modem spans "
                           f"{sorted({s.name for s in found})} for "
                           f"{ctx.calls} calls")
    return found


def card_calls(ctx):
    """The window's calls on the card's clock, or None off the card or
    with no spans.

    The card's clock and the host's (the spans', the profiler's host
    events) drift apart by tenths of a ms within a window, so each call
    is placed on the card by the card's own times: its one core codec
    kernel (the k-th of the trace's is the k-th call's) and the harness's
    CUDA events around it (ctx.call_dev_s).  The event after the call
    fires when the call's last operation ends: the core kernel's end, or,
    where the modem's work follows it, that end plus the modem span's card
    ms; the event before the call fired ctx.call_dev_s earlier, on an idle
    stream.  Raises where the calls and core kernels do not pair up."""
    found = modem(ctx)
    if (found is None or ctx.trace is None or not ctx.trace.kernels
            or not ctx.call_dev_s or any(s.card_ms is None for s in found)):
        return None
    cores = sorted((a, a + d) for n, a, d in ctx.trace.kernels
                   if is_core(n))
    launched = sorted(s.t0_ns for s in records(ctx)
                      if s.name.startswith("kernel."))
    if not len(cores) == len(launched) == len(ctx.call_dev_s) == ctx.calls:
        raise RuntimeError(f"{len(cores)} core kernels and {len(launched)} "
                           f"kernel spans for {ctx.calls} calls")
    calls = []
    for m, core, k0, dev_s in zip(sorted(found, key=lambda s: s.t0_ns),
                                  cores, launched, ctx.call_dev_s):
        after = m.t0_ns > k0
        end = core[1] + (1e-3 * m.card_ms if after else 0.0)
        calls.append(Call(end - dev_s, core, m, after))
    return calls


def union(intervals):
    """The sorted, disjoint union of (start, end) intervals."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        elif b > a:
            merged.append([a, b])
    return merged


def covered(intervals):
    """The length of the union of (start, end) intervals."""
    return sum(b - a for a, b in union(intervals))


def uncovered(inside, cover):
    """The length of union(inside) that union(cover) does not cover."""
    inside, cover = union(inside), union(cover)
    total = covered(inside)
    j = 0
    for a, b in inside:
        while j < len(cover) and cover[j][1] <= a:
            j += 1
        k = j
        while k < len(cover) and cover[k][0] < b:
            total -= min(b, cover[k][1]) - max(a, cover[k][0])
            k += 1
    return total
