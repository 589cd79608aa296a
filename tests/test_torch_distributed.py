"""Data-parallel training in the port over torch.distributed on the CPU.

Two OS processes join one Gloo group (`python -m
radae_tpu_torch.parallel.distributed <rank> 2`), each takes half of a
global batch and runs three train steps of the demo problem (rate Fs,
multipath fading, quantization noise on), the gradients averaged across
the group.  Both ranks must report the same loss, and the trajectory must
equal one process's on the whole batch at rtol 2e-5 (as radae_tpu's
tests/test_distributed.py holds its two processes against one): each rank
draws the whole batch's noise and keeps its rows, and the multipath
normalisation's mean is the whole batch's, so the world size does not
change the math."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from tests.test_torch_channel import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_gloo_processes_match_one_process():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "radae_tpu_torch.parallel.distributed",
             str(rank), "2", "--steps", "3", "--init",
             f"tcp://127.0.0.1:{port}"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO)
        for rank in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two-process demo timed out")
        assert p.returncode == 0, err[-2000:]
        outs.append(out)
    losses = [[float(x) for x in next(
        ln for ln in out.splitlines() if ln.startswith("LOSSES")).split()[1:]]
        for out in outs]
    assert len(losses[0]) == 3
    np.testing.assert_allclose(losses[0], losses[1], rtol=0, atol=0)

    from radae_tpu_torch.parallel.distributed import demo_single_process
    np.testing.assert_allclose(losses[0], demo_single_process(steps=3),
                               rtol=2e-5)
