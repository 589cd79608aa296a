"""The port's core codec kernels (csrc/fused_core.cu), one file each.

`benchmark/kernels/<kernel>.py` gives
  MATCH           the text every launch of the kernel carries in the name a
                  trace gives it, demangled or not;
  cost(work, cfg) the (FLOP, bytes) the kernel must at least spend on one
                  call's work (reference/roofline.py), or None where the
                  kernel does no part of it.

A kernel with a file here is of the core codec kernels' layer; every other
device operation is the modem's and the step's glue (`modem_dev_ms`).  A
route to another kernel form adds its file here and, for its share of the
roofline, a reader `metrics/<kernel>_roofline.py` that names it.
"""

from __future__ import annotations

import importlib.util
from functools import lru_cache
from pathlib import Path

from benchmark.reference import roofline

HERE = Path(__file__).resolve().parent


@lru_cache(maxsize=None)
def kernel(name: str):
    path = HERE / f"{name}.py"
    if not path.exists():
        raise FileNotFoundError(f"no kernel file {path}")
    spec = importlib.util.spec_from_file_location(f"benchmark_kernel_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def names():
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")


def is_core(trace_name: str) -> bool:
    return any(kernel(k).MATCH in trace_name for k in names())


def roofline_pct(ctx, name: str):
    """Kernel `name`'s share of its roofline over the traced window: the
    least time of the calls' work it did over the time its launches took;
    None where the trace holds no launch of it."""
    if ctx.trace is None:
        return None
    k = kernel(name)
    took = sum(d for n, _, d in ctx.trace.kernels if k.MATCH in n)
    costs = [c for c in (k.cost(w, ctx.cfg) for w in ctx.work) if c]
    if took <= 0.0 or not costs:
        return None
    return 100.0 * sum(roofline.least_s(*c) for c in costs) / took
