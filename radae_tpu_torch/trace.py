"""The port's spans and counters: where the serving work spends its time,
and how often it launches, packs, builds and loads.

Spans.  `span(name, device)` marks a range of the program's host work:

    with trace.span("rx.front_end", dev):
        ...

When no torch profiler is running it returns a shared no-op context, and
one check of `torch.autograd._profiler_enabled()` is its whole cost.
While a profiler runs, a span
  * opens a profiler range named `name` (torch's C++ record function,
    `torch._C._profiler._RecordFunctionFast`, as torch's own ops record
    theirs), so it shows in the profiler's events, its tables and any
    chrome trace it writes.  On the H100's host, under the benchmark's
    profiler, the serving paths' `torch.profiler.record_function` ranges
    cost 0.27-0.41 ms of host issue a call, these less than the runs'
    noise, and being no user annotations they draw no range on the
    device's timeline;
  * reads `time.time_ns()` at its entry and exit: the clock on which the
    profiler (kineto) stamps its events, host and device, so a span and
    the device's kernels can be joined;
  * given a CUDA device, records a timing CUDA event on the current
    stream at each edge: their difference is the card time from the start
    of the span's work to its end, the card's waits on the host included.
    Under the profiler's CUDA tracing the pair costs about 52 us of host
    time on an H100's host, so the serving paths give a device only to
    their top-level modem spans, whose card time a reader needs;
  * appends (name, parent, t0_ns, t1_ns, events) to a bounded buffer,
    parent being the name of the span it opened inside (None at the top
    level); a span that finds the buffer full is counted in `dropped()`.
So the buffer holds what the program did while a profiler ran, and nothing
else.  `spans()` gives the records with the card ms resolved (after a
synchronise); `reset()` empties the buffer.

Counters.  `COUNTERS` holds families of counters, always on (a dict
increment where the event happens):
  launch  kernel launches by form (`ops.fused_core.LAUNCHES` is this dict):
          the core codec's forms and `rx_demod`, the rx front end's kernel
          (`ops.ofdm.rx_front_end`)
  pack    `decoder`, `encoder`: kernel weight sets packed by
          `models.radae.CoreCodec.kernel_weights`; `mma`: weight sets
          packed for the tensor cores (`ops.fused_core._mma_args`)
  build   nvcc runs by library, and their seconds under `<lib>_s`
          (`ops._kernels.start_build`, `finish_build`)
  load    kernel libraries loaded (`ops._kernels.library`)

Spans and the buffer are the serving thread's: the port issues its work
from one thread.
"""

from __future__ import annotations

import time
from typing import List, NamedTuple, Optional

import torch

CAPACITY = 1 << 17      # records the buffer holds

# launch: the rx front end's kernel here, the core codec's forms added by
# ops/fused_core.py (its LAUNCHES)
COUNTERS = {"launch": {"rx_demod": 0},
            "pack": {"decoder": 0, "encoder": 0, "mma": 0},
            "build": {}, "load": {}}


class Span(NamedTuple):
    name: str
    parent: Optional[str]        # the enclosing span's name, None at the top
    t0_ns: int                   # time.time_ns() at entry and exit
    t1_ns: int
    card_ms: Optional[float]     # between the span's CUDA events; None
                                 # without a CUDA device

    @property
    def host_ms(self) -> float:
        return 1e-6 * (self.t1_ns - self.t0_ns)


_records: list = []     # [name, parent, t0_ns, t1_ns, events or card ms]
_open: list = []        # names of the spans entered and not yet left
_dropped = 0


class _Noop:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NOOP = _Noop()


class _Span:
    __slots__ = ("name", "cuda", "parent", "fn", "ev", "t0")

    def __init__(self, name, device):
        self.name = name
        self.cuda = device is not None and torch.device(device).type == "cuda"

    def __enter__(self):
        self.parent = _open[-1] if _open else None
        _open.append(self.name)
        self.fn = torch._C._profiler._RecordFunctionFast(self.name)
        self.fn.__enter__()
        self.t0 = time.time_ns()
        if self.cuda:
            self.ev = (torch.cuda.Event(enable_timing=True),
                       torch.cuda.Event(enable_timing=True))
            self.ev[0].record()
        return None

    def __exit__(self, *exc):
        global _dropped
        if self.cuda:
            self.ev[1].record()
        t1 = time.time_ns()
        self.fn.__exit__(*exc)
        _open.pop()
        if len(_records) < CAPACITY:
            _records.append([self.name, self.parent, self.t0, t1,
                             self.ev if self.cuda else None])
        else:
            _dropped += 1
        return False


def span(name: str, device=None):
    """A context that marks `name` while a torch profiler runs (see the
    module's doc), or a shared no-op one when none does.  device: where
    the card time of the span's work is wanted, the device it runs on; a
    CUDA one times it with two CUDA events."""
    if not torch.autograd._profiler_enabled():
        return _NOOP
    return _Span(name, device)


def spans() -> List[Span]:
    """The buffer's records, oldest first, with each span's card ms read
    from its CUDA events (call after the work is synchronised).  The
    buffer is kept."""
    for r in _records:
        if isinstance(r[4], tuple):
            r[4] = r[4][0].elapsed_time(r[4][1])
    return [Span(*r) for r in _records]


def dropped() -> int:
    """Spans left out since the last reset because the buffer was full."""
    return _dropped


def reset():
    """Empty the span buffer (the counters are kept)."""
    global _dropped
    _records.clear()
    _dropped = 0


def count(family: str, key: str, n=1):
    """Add n to counter `key` of `family`."""
    fam = COUNTERS[family]
    fam[key] = fam.get(key, 0) + n
