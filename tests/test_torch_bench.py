"""Supervisor-level gates of the port's benchmark (radae_tpu_torch/bench.py),
written like tests/test_bench.py for bench.py.

`python -m radae_tpu_torch.bench` must always print exactly one JSON line,
whatever the card does.  These tests run its torch-free parent with the
child on the CPU (the BENCH_PLATFORM test hook), and every run_bench mode
at a small batch on the CPU (the kernels' plain versions); the card runs the
ladder in chip_smoke.py."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(env_extra, timeout):
    env = dict(os.environ)
    env.update(env_extra)
    out = subprocess.run([sys.executable, "-m", "radae_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=REPO)
    lines = [ln for ln in out.stdout.strip().splitlines() if ln.strip()]
    assert len(lines) == 1, f"expected exactly ONE json line, got: {out.stdout!r}"
    return json.loads(lines[0])


def test_bench_banks_cheap_rung_on_cpu():
    # the B=8 rung banks a number in seconds (4 s on an idle CPU); the
    # parent stops harvesting at 95% of the budget.  One thread a process: the steps are hundreds
    # of tiny ops, which threads that wait on each other slow down many
    # times over when other processes share the CPU
    res = _run({"BENCH_PLATFORM": "cpu", "BENCH_BUDGET_S": "30",
                "OMP_NUM_THREADS": "1"}, timeout=120)
    assert res["metric"] == "streaming_rx_decode"
    assert res["unit"] == "audio-seconds/s/chip"
    assert res["value"] > 0, res
    assert res["vs_baseline"] > 0
    assert res["config"].startswith(("B=8,fused=False,scan=1",
                                     "B=256,fused=False,scan=8")), res


def test_bench_emits_error_json_when_budget_expires_resultless():
    # no rung can complete in 0.2 s: still one well-formed line, value 0.0
    res = _run({"BENCH_PLATFORM": "cpu", "BENCH_BUDGET_S": "0.2"}, timeout=90)
    assert res["metric"] == "streaming_rx_decode"
    assert res["value"] == 0.0
    assert "error" in res


def test_bench_cache_banking_atomic_and_never_downgrades(tmp_path,
                                                         monkeypatch):
    """_record must (a) never downgrade the banked best, (b) recover from
    a corrupt cache file, and (c) publish by atomic rename."""
    import importlib
    import radae_tpu_torch.bench as bench_mod
    bench = importlib.reload(bench_mod)

    cache = tmp_path / "cache.json"
    monkeypatch.setattr(bench, "CACHE", str(cache))
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)

    bench._record(1_000_000.0, "cfg-big")
    assert json.loads(cache.read_text())["value"] == 1_000_000.0

    # a smaller value must not clobber the banked best, only last_run
    bench._best["value"] = None
    bench._record(5_000.0, "cfg-small")
    data = json.loads(cache.read_text())
    assert data["value"] == 1_000_000.0, data
    assert data["last_run"]["value"] == 5_000.0

    # a corrupt (truncated) cache: the next bank succeeds with valid JSON
    cache.write_text('{"value": 1000000.0, "last_run": ')
    bench._best["value"] = None
    bench._record(7_000.0, "cfg-after-corruption")
    data = json.loads(cache.read_text())
    assert data["value"] == 7_000.0
    assert not (tmp_path / "cache.json.tmp").exists()

    # implausible values are discarded entirely
    bench._best["value"] = None
    bench._record(3e10, "cfg-artifact")
    assert json.loads(cache.read_text())["value"] == 7_000.0


def test_parent_imports_no_torch():
    code = ("import sys, radae_tpu_torch.bench\n"
            "assert 'torch' not in sys.modules, 'torch imported'\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0, r.stderr


@pytest.fixture(scope="module")
def one_thread():
    """B=4 steps are hundreds of tiny ops: one torch thread runs them
    without waiting on the others, whatever else shares the CPU."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", [False, True, "int8", "int8bf16", "int8m",
                                  "mergedf32", "padf32", "padi8", "frame",
                                  "frame_vmem"])
def test_run_bench_every_mode_on_cpu(one_thread, mode):
    from radae_tpu_torch import bench
    from radae_tpu_torch.ops import fused_core as fc
    fc.reset_launches()
    v = bench.run_bench(4, n_frames=2, fused=mode, scan=2, device="cpu")
    assert np.isfinite(v) and v > 0
    assert not any(fc.LAUNCHES.values())     # the CPU runs the plain versions


def test_init_is_radae_tpus_draw():
    """run_bench's weights: the port's CoreDecoder.init(1) gives radae_tpu's
    numpy arrays exactly."""
    from radae_tpu.models.core import CoreDecoder as JDec
    from radae_tpu_torch.models.core import CoreDecoder

    def same(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                same(a[k], b[k])
            else:
                assert a[k].dtype == np.asarray(b[k]).dtype
                np.testing.assert_array_equal(a[k], np.asarray(b[k]))

    same(CoreDecoder(80, 21).init(1), JDec(80, 21).init(1))
