"""A configuration, a traffic mix, a metric, a core kernel and a cell added
as files of their own plus BENCHMARK.json entries are found with no edit to
a file the benchmark has."""

import json
import shutil
import subprocess
import sys

from conftest import ROOT


def test_added_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    for name in ("radae_tpu_torch", "fixtures"):
        (tmp_path / name).symlink_to(ROOT / name)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp_path / "benchmark"
    cfg = json.loads((b / "configs/flagship.json").read_text())
    (b / "configs/flagship_twin.json").write_text(json.dumps(
        dict(cfg, name="flagship_twin")))
    (b / "traffic/rx_few.json").write_text(json.dumps(dict(
        json.loads((b / "traffic/rx_streams.json").read_text()),
        streams=3, pool_frames=2, check_streams=2)))
    (b / "metrics/calls_per_s.py").write_text(
        "def read(ctx):\n    return ctx.calls / ctx.window_s\n")
    (b / "kernels/twin_kernel.py").write_text(
        "MATCH = 'twin_kernel'\n\n\ndef cost(work, cfg):\n"
        "    return 1.0, 1.0\n")
    (b / "metrics/twin_kernel_roofline.py").write_text(
        "from benchmark.kernels import is_core, roofline_pct\n\n\n"
        "def read(ctx):\n    assert is_core('void twin_kernel<false>()')\n"
        "    return roofline_pct(ctx, 'twin_kernel')\n")
    (b / "limits/flagship_twin.rx_few.json").write_text(
        (b / "limits/flagship.rx_streams.json").read_text())
    spec["configs"].append(dict(spec["configs"][0], name="flagship_twin",
                                file="benchmark/configs/flagship_twin.json"))
    spec["workloads"].append(dict(name="flagship_twin.rx_few",
                                  config="flagship_twin", traffic="rx_few",
                                  chips=1, why="a test cell"))
    for m in spec["end_to_end"]:
        if m["name"] == "audio_s_per_s":
            m["workloads"].append("flagship_twin.rx_few")
    spec["per_layer"].append(dict(name="calls_per_s", unit="1/s",
                                  better="higher", source="host_clock",
                                  layer="serving step",
                                  moves="audio_s_per_s"))
    spec["per_layer"].append(dict(name="twin_kernel_roofline", unit="%",
                                  better="higher", source="device_trace",
                                  layer="core codec kernels",
                                  moves="audio_s_per_s",
                                  workloads=["flagship_twin.rx_few"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, time, json, torch; sys.path.insert(0, sys.argv[1]); "
            "from pathlib import Path; from benchmark import harness; "
            "assert harness.__file__.startswith(sys.argv[1]); "
            "line = harness.run_cell(Path(sys.argv[1]), 'flagship_twin.rx_few', "
            "5, 0.2, True, torch.device('cpu'), time.perf_counter()); "
            "print(json.dumps(line))")
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path)],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["metrics"]["calls_per_s"]["value"] > 0
    # the CPU traces no kernel: the roofline's reader ran and found none
    assert "twin_kernel_roofline" not in line["metrics"]
