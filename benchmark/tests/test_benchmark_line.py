"""The result line's schema, the refusal without a card, and the check that
no module of JAX or the JAX package was loaded."""

import ast
import json
import subprocess
import sys
import types

import pytest

from conftest import CELLS, ROOT, run_small
from benchmark import harness

DEVICE_KEYS = {"platform", "kind", "count", "memory_peak_bytes"}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_result_line_schema(cell, trace):
    line = run_small(cell, trace=trace)
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert line["attempted"] >= 1 and line["failed"] == 0
    assert DEVICE_KEYS <= set(line["device"])
    spec = harness.Spec(ROOT)
    declared = {m["name"]: m for m in spec.metrics(cell, trace)}
    for name, m in line["metrics"].items():
        assert declared[name]["unit"] == m["unit"]
        assert isinstance(m["value"], float) and m["value"] > 0
    # the CPU has no card and no device trace: the host's metrics read, and
    # none of the device's is written from a CPU run
    assert set(line["metrics"]) == {n for n, m in declared.items()
                                    if m["source"] == "host_clock"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert set(line["setup"]) == {"first_call_s", "kernels_built"}
    limits = spec.limits(cell)
    assert set(line["checks"]) == set(limits)
    for k, c in line["checks"].items():
        assert c["limit"] == limits[k] and 0 <= c["value"] <= c["limit"]
    json.dumps(line)


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_what_it_must(cell):
    """setup_s, one other end-to-end metric, and with a trace per-layer
    metrics that each move an end-to-end metric the cell reports."""
    spec = harness.Spec(ROOT)
    e2e = {m["name"] for m in spec.metrics(cell, False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = spec.metrics(cell, True)
    assert layer and all(m["moves"] in e2e for m in layer)
    for m in layer:
        assert spec.reader(m).read is not None
    file_cell = "step_p95_ms" in e2e
    assert all(m["name"].endswith(".file") == file_cell for m in layer
               if m["moves"] != "setup_s")


def test_run_refuses_without_a_card():
    r = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "flagship.rx_streams", "--seed", "1", "--seconds",
                        "1", "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    if r.returncode == 0:
        pytest.skip("this machine has a card")
    assert r.stdout.strip() == ""


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, 'benchmark/tests'); "
            "from conftest import run_small; from benchmark import harness; "
            "line = run_small('flagship.rx_file', trace=True); "
            "run_small('flagship.tx_streams'); "
            "print(line['correct'], harness.banned_modules())")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip().splitlines()[-1] == "True []"


def test_banned_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "radae_tpu_torch_extra",
                        types.ModuleType("radae_tpu_torch_extra"))
    assert "radae_tpu_torch_extra" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    monkeypatch.setitem(sys.modules, "radae_tpu.ops",
                        types.ModuleType("radae_tpu.ops"))
    found = harness.banned_modules()
    assert "jax" in found and "radae_tpu" in found
    assert "radae_tpu_torch" not in found


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "benchmark/reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and node.level == 0 else [])
            for n in names:
                assert n.split(".")[0] not in (
                    "jax", "jaxlib", "flax", "radae_tpu", "radae_tpu_torch"), \
                    (path.name, n)
