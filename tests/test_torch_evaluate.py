"""The port's evaluation sweep (tools/evaluate.py) on the CPU: the grid
batch against radae_tpu's, the sweep (each rank's rows reduced into
per-cell sums, one all_reduce) over a real two-process Gloo group against
one process and against per-row losses averaged in numpy, the --ber grid,
and --audio refused until the vocoder is ported."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from radae_tpu.config import RADAEConfig as JRADAEConfig
from radae_tpu.tools.evaluate import build_grid_batch as jbuild_grid_batch
from radae_tpu_torch.config import RADAEConfig
from radae_tpu_torch.models.core import distortion_loss
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.ops import cplx
from radae_tpu_torch.parallel.trainstep import step_generator
from radae_tpu_torch.tools import evaluate
from tests.test_torch_channel import one_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS = os.path.join(REPO, "fixtures", "speech_feats.f32")
EVAL_CFG = dict(feature_dim=20, latent_dim=80, EbNodB=100, rate_Fs=True,
                pilots=True, pilot_eq=True, eq_mean6=False,
                cyclic_prefix=0.004, coarse_mag=True, time_offset=-16,
                bottleneck=3)
SWEEP = ["--channels", "awgn,mpp", "--EbNodB", "0,10", "--reps", "2",
         "--seconds", "1.2", "--shard_map"]


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_grid_batch_matches_jax():
    feats = np.random.default_rng(1).standard_normal((120, 21)).astype(
        np.float32)
    got = evaluate.build_grid_batch(RADAEConfig(**EVAL_CFG), feats,
                                    ["awgn", "mpp", "mpd"], [0.0, 6.0], 2,
                                    np.random.default_rng(3))
    want = jbuild_grid_batch(JRADAEConfig(**EVAL_CFG), feats,
                             ["awgn", "mpp", "mpd"], [0.0, 6.0], 2,
                             np.random.default_rng(3))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]


def _run_sweep_here():
    model = RADAE(RADAEConfig(**EVAL_CFG), "cpu")
    params = model.init(0)
    f = np.fromfile(FEATS, np.float32).reshape(-1, 36)[:120, :20]
    return model, params, f


def test_sweep_ranks_over_two_processes_match_run_sweep(tmp_path):
    """`python -m radae_tpu_torch evaluate` in two processes of one Gloo
    group (torchrun's environment) gives run_sweep's table in one process,
    and that is the per-row losses of one forward of the grid averaged per
    cell (run_sweep's one-hot sums against numpy's means)."""
    port = _free_port()
    out = str(tmp_path / "table.json")
    procs = []
    for rank in (0, 1):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1",
                   WORLD_SIZE="2", RANK=str(rank), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "radae_tpu_torch", "evaluate", "random",
             FEATS, "--json", out, "--device", "cpu"] + SWEEP,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            env=env, cwd=REPO))
    for p in procs:
        try:
            _, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("the two-process sweep timed out")
        assert p.returncode == 0, err[-2000:]
    with open(out) as f:
        got = json.load(f)

    model, params, feats = _run_sweep_here()
    one = evaluate.run_sweep(model, params, feats, ["awgn", "mpp"],
                             [0.0, 10.0], reps=2)
    f, H, G, ebno, rows = evaluate.build_grid_batch(
        model.cfg, feats, ["awgn", "mpp"], [0.0, 10.0], 2,
        np.random.default_rng(0))
    with torch.no_grad():
        out = model.forward(params, f, H, cplx.pack_np(G),
                            key=step_generator("cpu", 0, 0), EbNodB=ebno)
        rowloss = distortion_loss(torch.as_tensor(f[..., :20]),
                                  out["features_hat"][..., :20]).numpy()
    assert set(got) == {f"{ch}@{e}" for ch, e, _ in rows}
    for ch, e, _ in rows:
        v = np.mean([x for (c, ee, _), x in zip(rows, rowloss)
                     if (c, ee) == (ch, e)])
        assert np.isfinite(v)
        np.testing.assert_allclose(one[(ch, e)], v, rtol=1e-6)
        np.testing.assert_allclose(got[f"{ch}@{e}"], v, rtol=1e-5)


def test_ber_grid(tmp_path):
    """--ber: the BER of random bits through the bottleneck-1 waveform, 0
    at 30 dB and well above 0 at 0 dB."""
    out = str(tmp_path / "ber.json")
    evaluate.main(["random", FEATS, "--ber", "--channels", "awgn",
                   "--EbNodB", "0,30", "--reps", "2", "--seconds", "1.2",
                   "--json", out, "--device", "cpu"])
    with open(out) as f:
        table = json.load(f)
    assert table["awgn@30.0"] == 0.0
    assert table["awgn@0.0"] > 0.01


def test_audio_is_refused_until_the_vocoder_is_ported():
    with pytest.raises(SystemExit, match="vocoder"):
        evaluate.main(["random", FEATS, "--audio", "out", "--device", "cpu"])
