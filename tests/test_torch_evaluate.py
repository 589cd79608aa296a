"""The port's evaluation sweep (tools/evaluate.py) on the CPU: the grid
batch against radae_tpu's, the sweep (each rank's rows reduced into
per-cell sums, one all_reduce) over a real two-process Gloo group against
one process and against per-row losses averaged in numpy, the --ber grid,
and --audio's listening material (write_audio_cells) against radae_tpu's
on the same features, weights, seed and channel draw."""

import json
import os
import socket
import subprocess
import sys
import wave

import numpy as np
import pytest
import torch

from radae_tpu.config import RADAEConfig as JRADAEConfig
from radae_tpu.models.radae import RADAE as JRADAE
from radae_tpu.tools.evaluate import build_grid_batch as jbuild_grid_batch
from radae_tpu.tools.evaluate import write_audio_cells as jwrite_audio_cells
from radae_tpu_torch.config import RADAEConfig
from radae_tpu_torch.models.core import distortion_loss
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.ops import cplx
from radae_tpu_torch.parallel.trainstep import step_generator
from radae_tpu_torch.tools import evaluate
from tests.test_torch_channel import one_thread, same_noise  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATS = os.path.join(REPO, "fixtures", "speech_feats.f32")
EVAL_CFG = dict(feature_dim=20, latent_dim=80, EbNodB=100, rate_Fs=True,
                pilots=True, pilot_eq=True, eq_mean6=False,
                cyclic_prefix=0.004, coarse_mag=True, time_offset=-16,
                bottleneck=3)
# the neural vocoder's f32 phase cumsum rounds otherwise in torch than in
# jax: up to 13 of the clean reference's pcm over 96 frames, and the SSB
# wavs are made from it
PCM_TOL = 16
FWSEG_TOL = 0.05        # dB
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


def _wav(path):
    with wave.open(path, "rb") as w:
        return w.getframerate(), np.frombuffer(
            w.readframes(w.getnframes()), np.int16).astype(np.int32)


def test_audio_cells_match_jax(tmp_path, same_noise):
    """write_audio_cells (evaluate --audio) against radae_tpu's on the same
    features, weights (init(0)) and seed, quant noise off and the channel's
    draw shared (same_noise): per file the same rate and length; the clean
    reference zz_*_orig.wav, each cell's decoded wav, and the SSB wavs
    (zz_*_ssb.wav and each cell's _ssb.wav, made from the clean reference
    with the numpy rng both draw alike) within PCM_TOL; each README's measured
    Eb/No, PAPR, C/No and SNR3k and SSB line equal as printed, and its
    fwSegSNR within FWSEG_TOL dB."""
    kw = dict(EVAL_CFG, quant_noise=False)
    model, jmodel = RADAE(RADAEConfig(**kw), "cpu"), JRADAE(JRADAEConfig(**kw))
    params = model.init(0)
    feats = np.fromfile(FEATS, np.float32).reshape(-1, 36)[
        :model.cfg.num_10ms_times_steps_rounded_to_modem_frames(96), :20]
    dirs = [str(tmp_path / d) for d in ("ours", "ref")]
    cells = (["awgn", "mpp"], [6.0])
    got = evaluate.write_audio_cells(model, params, feats, *cells, dirs[0],
                                     seed=3, name="f")
    want = jwrite_audio_cells(jmodel, params, feats, *cells, dirs[1],
                              seed=3, name="f")
    assert [os.path.basename(b) for b in got] == \
        [os.path.basename(b) for b in want] == ["f_6dB_awgn", "f_6dB_mpp"]
    names = sorted(os.listdir(dirs[0]))
    assert names == sorted(os.listdir(dirs[1])) and len(names) == 8
    for name in names:
        a, b = (os.path.join(d, name) for d in dirs)
        if name.endswith(".wav"):
            (fa, xa), (fb, xb) = _wav(a), _wav(b)
            assert fa == fb and len(xa) == len(xb) > 1000, name
            err = int(np.abs(xa - xb).max())
            assert err <= PCM_TOL, (name, err)
            continue
        la, lb = open(a).read().splitlines(), open(b).read().splitlines()
        assert la[:3] == lb[:3], (la, lb)
        qa, qb = (float(ln[3].split()[-2]) for ln in (la, lb))
        assert abs(qa - qb) <= FWSEG_TOL, (qa, qb)
