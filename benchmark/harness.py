"""One run of one cell: set-up, the measured window, the traced reading,
the check, and the result line.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file the harness finds by the name BENCHMARK.json gives it:

  configuration  the entry's `file` (benchmark/configs/<name>.json)
  traffic mix    benchmark/traffic/<traffic>.json, whose `entry` names
  the entry      benchmark/entries/<entry>.py (its `Cell`: the timed call
                 of the program and the check of what it produced)
  metric         benchmark/metrics/<name>.py (its `read(ctx)`), or for a
                 name split by cells, `<stem>.<part>`, the stem's reader
  core kernel    benchmark/kernels/<kernel>.py (its trace name and cost)
  limits         benchmark/limits/<cell>.json (each compared number's limit)

The measured window runs the cell's calls back to back until `seconds`
have passed; each call is issued, timed on the host clock and on the
card's (a CUDA event before the issue and one after), and synchronised
before the next is issued; the last call completes inside the window.
Nothing is built or compiled in it: the set-up's warm-up calls ran every
shape the window sends.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import sys
import time
from contextlib import nullcontext
from pathlib import Path
from types import SimpleNamespace

import torch

from benchmark import trace as tracing

BANNED = ("jax", "jaxlib", "flax", "radae_tpu")
SHARE_MAX = 100.0       # a metric in % above this is a fault: a share of a
                        # roofline or a peak counted too high


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no module file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Spec:
    """BENCHMARK.json and the files its names lead to."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def workload(self, name):
        for w in self.data["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.data["configs"]:
            if c["name"] == name:
                return json.loads((self.root / c["file"]).read_text())
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name):
        return json.loads((self.bench / "traffic" / f"{name}.json").read_text())

    def entry(self, name):
        return load_module(self.bench / "entries" / f"{name}.py",
                           f"benchmark_entry_{name}")

    def limits(self, cell):
        path = self.bench / "limits" / f"{cell}.json"
        return json.loads(path.read_text()) if path.exists() else None

    def metrics(self, cell, trace: bool):
        """The metrics a run of `cell` reports: its end-to-end ones, or with
        a trace the per-layer ones that move one of those.  A metric with
        `workloads` is reported in the cells it lists, one without in every
        cell."""
        def ours(m):
            return "workloads" not in m or cell in m["workloads"]
        e2e = [m for m in self.data["end_to_end"] if ours(m)]
        if not trace:
            return e2e
        moved = {m["name"] for m in e2e}
        return [m for m in self.data["per_layer"]
                if ours(m) and m["moves"] in moved]

    def reader(self, metric):
        name = metric["name"]
        path = self.bench / "metrics" / f"{name}.py"
        if not path.exists():
            path = self.bench / "metrics" / f"{name.split('.')[0]}.py"
        return load_module(path, "benchmark_metric_" + name.replace(".", "_"))


def banned_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)
                   if m.split(".")[0] in BANNED})


def built_since(root, t_start):
    """Whether this process built a kernel library into the checkout's
    build/ (the first run of a checkout): its set-up holds the build."""
    began = time.time() - (time.perf_counter() - t_start)
    return any(p.stat().st_mtime >= began
               for p in (Path(root) / "build").rglob("*.so"))


def device_info(device):
    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
                "count": 1}
    return {"platform": "cpu", "kind": "cpu", "count": 1}


def run_cell(root, name, seed, seconds, trace, device, t_start,
             sut="program", overrides=None):
    """Run cell `name` once; returns the result line as a dict, the
    compared numbers under `checks` (each with its limit, None where the
    cell has no limits file).  `overrides` replace traffic parameters (the
    CPU tests' small sizes); `sut` "control" puts the reference in TF32 in
    the program's place."""
    spec = Spec(root)
    wl = spec.workload(name)
    cfg = spec.config(wl["config"])
    traffic = dict(spec.traffic(wl["traffic"]), **(overrides or {}))
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    # the traffic and the reference compute in full f32; the program sets
    # its own precision, which is checked after its set-up
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    cell = spec.entry(traffic["entry"]).Cell(cfg, traffic, seed, device,
                                             spec.root, sut)
    cell.setup()
    sync()
    if cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on: the configurations run f32")
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    mark = torch.profiler.record_function if trace else (lambda _: nullcontext())
    prof = tracing.profiler() if trace else nullcontext()
    issue_s, call_s, dev_s, works, audio = [], [], [], [], 0.0
    ev = (torch.cuda.Event(enable_timing=True),
          torch.cuda.Event(enable_timing=True)) if cuda else None
    # the set-up's objects out of the collector's reach: a full collection
    # over them takes tens of ms, which the window would count
    gc.collect()
    gc.freeze()
    with prof:
        with mark("window"):
            t0 = time.perf_counter()
            while True:
                a = time.perf_counter()
                with mark("traffic"):
                    x = cell.next_input()
                with mark("issue"):
                    if cuda:
                        ev[0].record()
                    out = cell.call(x)
                    if cuda:
                        ev[1].record()
                b = time.perf_counter()
                with mark("check"):
                    cell.keep(out)
                with mark("sync"):
                    sync()
                e = time.perf_counter()
                issue_s.append(b - a)
                call_s.append(e - a)
                if cuda:
                    dev_s.append(1e-3 * ev[0].elapsed_time(ev[1]))
                works.append(cell.work())
                audio += cell.audio_s()
                if e - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
    gc.unfreeze()
    dev = device_info(device)
    dev["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                if cuda else 0)
    traced = tracing.read(prof) if trace else None
    calls = len(call_s)

    ctx = SimpleNamespace(cell=name, cfg=cfg, traffic=traffic, seed=seed,
                          setup_s=setup_s, window_s=window_s, calls=calls,
                          audio_s=audio, issue_s=issue_s, call_s=call_s,
                          call_dev_s=dev_s, work=works, trace=traced)
    metrics = {}
    for m in spec.metrics(name, trace):
        value = spec.reader(m).read(ctx)
        if value is None:
            continue
        if m["unit"] == "%" and not value <= SHARE_MAX:
            raise RuntimeError(f"{m['name']} reads {value} %: the "
                               "operations or bytes are counted too high")
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if traced is not None:
        dev["busy_s"] = traced.busy_s
        dev["window_s"] = traced.window_s

    cell.free()
    del out
    checks = cell.check()
    limits = spec.limits(name) if sut == "program" else None
    compared = {k: {"value": v, "limit": None if limits is None
                    else limits[k]} for k, v in checks.items()}
    correct = (limits is not None
               and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                       for c in compared.values()))
    line = {"correct": correct, "attempted": calls, "failed": 0,
            "metrics": metrics, "device": dev}
    if traced is not None:
        idle = sorted(traced.idle_by_range.items(), key=lambda kv: -kv[1])
        line["breakdown"] = {"device_ops": traced.device_ops,
                             "idle_gaps": [[k, v] for k, v in idle][:10]}
    q = sorted(dev_s or call_s)
    line["calls_ms"] = {"clock": "card" if dev_s else "host",
                        "issue_median": 1e3 * sorted(issue_s)[len(q) // 2],
                        "min": 1e3 * q[0], "median": 1e3 * q[len(q) // 2],
                        "max": 1e3 * q[-1], "first": 1e3 * (dev_s or call_s)[0]}
    line["setup"] = {"first_call_s": cell.first_call_s,
                     "kernels_built": built_since(spec.root, t_start)}
    line["checks"] = compared
    return line
