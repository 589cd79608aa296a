"""Host ms a call inside the program's kernel-wrapper spans (`kernel.*`:
the checks, state allocation, ctypes marshalling and the launch) and, on
the file path, its weight stamp (`codec.weights`) (host clock, traced
run; None where no such span ran)."""

from benchmark import spans


def read(ctx):
    found = [s for s in spans.records(ctx)
             if s.name.startswith("kernel.") or s.name == "codec.weights"]
    if not found:
        return None
    return sum(s.host_ms for s in found) / ctx.calls
