"""Shared settings of the benchmark's CPU tests: the harness at sizes a
test run holds, and the marker of the tests that need the card."""

import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# each traffic mix cut to a few streams, frames or files
SMALL = {"rx_streams": dict(streams=4, pool_frames=4, check_streams=3),
         "tx_streams": dict(streams=4, pool_frames=4, check_streams=3),
         "rx_file": dict(files=3, seconds=[0.5, 1.0], check_files=2)}
CELLS = ("flagship.rx_streams", "l40.rx_streams", "flagship.tx_streams",
         "flagship.rx_file")


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips "
                            "without one (decided inside the test)")


def run_small(cell, seed=20260101, seconds=0.3, trace=False, sut="program",
              root=ROOT):
    """One run of `cell` on the CPU at its small size; the result line."""
    import torch
    from benchmark import harness

    traffic = harness.Spec(root).workload(cell)["traffic"]
    return harness.run_cell(root, cell, seed, seconds, trace,
                            torch.device("cpu"), time.perf_counter(),
                            sut=sut, overrides=SMALL[traffic])


@pytest.fixture
def card():
    """The CUDA device, or a skip where the machine has none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
