"""The traced run's reading of torch.profiler (CUPTI): device activity and
the harness's host ranges, in memory, with no trace file written.

The harness marks its host work with record_function ranges: `window`
around the measured loop, and inside it `traffic` (picking the call's
input), `issue` (the call, until it returns), `check` (the kept rows'
gathers) and `sync` (torch.cuda.synchronize()).  From the events this
module gives the device's busy time inside the window (the union of every
device activity), each kernel's launches with start and duration, and the
idle gaps labelled by the host range that covers each gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import NamedTuple

import torch

RANGES = ("traffic", "issue", "check", "sync")
TOP = 10
NAME_MAX = 120         # a kernel's name in the breakdown, cut


class Trace(NamedTuple):
    window_s: float                  # the `window` range's length
    busy_s: float                    # device activity inside it, merged
    kernels: list                    # (name, start_s, duration_s) inside it
    idle_by_range: dict              # host range -> idle seconds
    device_ops: list                 # [[name, seconds], ...] most first


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   record_shapes=False, with_stack=False,
                   profile_memory=False)


def _span(e):
    start = e.start_ns()
    return start * 1e-9, (start + e.duration_ns()) * 1e-9


def _annotation(e):
    """A range of the host's drawn on the device's timeline (CUPTI marks
    record_function ranges there too): no device activity."""
    return e.is_user_annotation() or e.name() in RANGES + ("window",)


def read(prof) -> Trace:
    host = defaultdict(list)
    device = []
    window = None
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            name = e.name()
            if name == "window":
                window = _span(e)
            elif name in RANGES:
                host[name].append(_span(e))
        elif not _annotation(e):
            a, b = _span(e)
            device.append((a, b, e.name()))
    if window is None:
        raise RuntimeError("the trace has no window range")
    w0, w1 = window
    device = sorted((max(a, w0), min(b, w1), n) for a, b, n in device
                    if b > w0 and a < w1)
    by_name = defaultdict(float)
    merged = []
    for a, b, n in device:
        by_name[n] += b - a
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged)
    marks = sorted((a, b, n) for n, spans in host.items() for a, b in spans)
    starts = [m[0] for m in marks]
    idle = defaultdict(float)
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    for g0, g1 in zip(edges[0::2], edges[1::2]):
        if g1 <= g0:
            continue
        mid = 0.5 * (g0 + g1)
        i = bisect.bisect_right(starts, mid) - 1
        label = marks[i][2] if i >= 0 and marks[i][1] >= mid else "between"
        idle[label] += g1 - g0
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    ops = [(n.replace("(anonymous namespace)::", "")[:NAME_MAX], s)
           for n, s in ops]
    return Trace(w1 - w0, busy, [(n, a, b - a) for a, b, n in device],
                 dict(idle), [[n, s] for n, s in ops])
