"""A traced run on the CPU reads the program's spans: the host-span
metrics appear in the line, one modem span a call, and the device ones,
which need CUDA events and kernels, do not."""

import pytest

from conftest import CELLS, run_small

HOST = ("front_end_host_ms", "kernel_host_ms")
DEVICE = ("front_end_dev_ms", "idle_program_pct")


@pytest.mark.parametrize("cell", CELLS)
def test_traced_cpu_run_reads_the_spans(cell):
    from radae_tpu_torch import trace

    trace.reset()
    line = run_small(cell, trace=True)
    # the readers took the window's spans out of the buffer
    assert trace.spans() == []
    assert line["correct"] is True
    part = ".file" if cell.endswith("rx_file") else ""
    got = line["metrics"]
    for stem in HOST:
        assert got[stem + part]["value"] > 0, got
    for stem in DEVICE:
        assert stem + part not in got, got


def test_each_of_two_traced_runs_reads_its_own_window():
    """Two traced runs in one process: each reads one modem span a call
    (the modem readers fail the run otherwise)."""
    for cell in ("flagship.tx_streams", "flagship.rx_file"):
        line = run_small(cell, trace=True)
        part = ".file" if cell.endswith("rx_file") else ""
        assert line["metrics"]["front_end_host_ms" + part]["value"] > 0


def test_an_untraced_run_has_no_span_metrics():
    from radae_tpu_torch import trace

    trace.reset()
    line = run_small("flagship.rx_streams", trace=False)
    assert trace.spans() == []
    assert not any(k.startswith(("front_end", "kernel_host", "idle_program"))
                   for k in line["metrics"])
