"""The port's PTT session loop (tools/ptt_loop.py) on the CPU, on the
fixture checkpoint and fixtures/speech_feats.f32.

The port's receiving loop (`receive_session`) runs on radae_tpu's session IQ
and must give radae_tpu's per-over reports exactly, in the two cases of
tests/test_session.py (AWGN at 3 dB, two 4 s overs; MPP at 3 dB, 5 s
overs).  The two transmitters draw their quantization noise from different
generators, so the port's own sessions differ from radae_tpu's value by
value: they are held to the gates of tests/test_session.py."""

import os

import numpy as np
import pytest
import threadpoolctl
import torch

from radae_tpu.tools import ptt_loop as jptt
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.tools import ptt_loop

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
FEATS = os.path.join(ROOT, "fixtures", "speech_feats.f32")
CASES = {"awgn": dict(n_overs=2, over_secs=4.0, gap_secs=2.0, snrdB=3.0,
                      seed=1),
         "mpp": dict(n_overs=2, over_secs=5.0, gap_secs=2.0, channel="mpp",
                     snrdB=3.0, seed=1)}


@pytest.fixture(scope="module")
def one_thread():
    """Small tensors: one thread, in torch and in numpy's BLAS (the random
    weights' QR), runs them faster than pools that the test workers share,
    whose spinning threads slowed a random model's init thirtyfold beside
    three other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def fixture():
    params, _ = load_checkpoint(CKPT)
    feats = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    return params, feats


def _gates(case, reports):
    for i, r in enumerate(reports):
        assert r["acquired"], (i, reports)
        if case == "awgn":
            assert r["eoo"], (i, reports)
            assert r["frames_decoded"] >= 20, (i, reports)
        else:
            assert r["frames_decoded"] >= 25, (i, reports)
    if case == "awgn":
        assert any(r["unsynced_after"] for r in reports), reports
    else:    # a fade may swallow one over's EOO, not all
        assert any(r["eoo"] for r in reports), reports


@pytest.mark.parametrize("case", sorted(CASES))
def test_receiving_loop_matches_jax_on_its_session(one_thread, fixture,
                                                   case):
    params, feats = fixture
    want, session, marks = jptt.run_session(params, feats, **CASES[case])
    got, counts = ptt_loop.receive_session(params, session, marks,
                                           device="cpu")
    assert got == want
    _gates(case, got)
    assert counts["decoded"] >= sum(r["frames_decoded"] for r in got)
    assert counts["frames"] >= len(session) // 1120


@pytest.mark.parametrize("case", sorted(CASES))
def test_own_session_passes_the_gates(one_thread, fixture, case):
    params, feats = fixture
    reports, session, marks = ptt_loop.run_session(params, feats,
                                                   device="cpu", **CASES[case])
    _gates(case, reports)
    assert len(marks) == 2 and marks[0][1] <= marks[1][0]
    assert session.dtype == np.complex64
    if case == "awgn":
        edges = []
        ptt_loop.emit_session(session, marks, os.devnull,
                              ptt_hook=lambda on: edges.append(on))
        assert edges == [True, False, True, False]


def test_ptt_loop_main_keys_the_rig(one_thread, tmp_path):
    """The CLI on the CPU: a 2-over session written to --rig-out with the
    PTT hooks run at each edge, exit code 0 when every over acquired and
    ended with an EOO."""
    log, out = tmp_path / "ptt.log", tmp_path / "rig.f32"
    rc = ptt_loop.main([CKPT, FEATS, "--over-secs", "2", "--gap-secs", "1",
                        "--snrdB", "10", "--rig-out", str(out),
                        "--ptt-on-cmd", f"echo on >> {log}",
                        "--ptt-off-cmd", f"echo off >> {log}",
                        "--device", "cpu"])
    assert rc == 0
    assert log.read_text().split() == ["on", "off", "on", "off"]
    assert out.stat().st_size > 2 * 2 * 8000 * 8
