"""The port's calibration and measurement tools on the CPU against
radae_tpu's: chirp and C/No (tools/chirp.py) exactly, the SNR estimator's
raw statistics and its refit (tools/est_snr.py), the pilot trainer
(tools/ml_pilots.py) on radae_tpu's draws, the OTA driver and its channel
(tools/ota.py), the web transmit front end (tools/webtx.py), the
training-step breakdown (tools/profile.py) and the data-parallel scaling
rows over Gloo ranks (tools/scaling.py)."""

import os
import threading
import urllib.request
import wave

import numpy as np
import pytest
import threadpoolctl
import torch

from radae_tpu.tools import chirp as jchirp
from radae_tpu_torch.tools import chirp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
FEATS = os.path.join(ROOT, "fixtures", "speech_feats.f32")
TOL = dict(rtol=1e-4, atol=1e-5)


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


def test_chirp_and_cno_match_jax(tmp_path):
    for T, amp in ((4.0, 0.25), (2.0, 0.7)):
        assert np.array_equal(chirp.gen_chirp(T=T, amp=amp),
                              jchirp.gen_chirp(T=T, amp=amp))
    rng = np.random.default_rng(0)
    c = chirp.gen_chirp(T=2.0)
    rx = np.concatenate([np.zeros(4000, np.complex64), c,
                         np.zeros(8000, np.complex64)])
    rx = rx + 0.05 * (rng.standard_normal(len(rx))
                      + 1j * rng.standard_normal(len(rx)))
    for secs in (2.0, 4.0):
        assert chirp.est_CNo(rx, chirp_secs=secs) == \
            jchirp.est_CNo(rx, chirp_secs=secs)
    assert chirp.est_CNo(rx[:100]) == jchirp.est_CNo(rx[:100])
    out = str(tmp_path / "c.f32")
    chirp.chirp_main([out, "--secs", "1.5", "--amp", "0.3"])
    assert np.array_equal(np.fromfile(out, np.complex64),
                          jchirp.gen_chirp(T=1.5, amp=0.3))


@pytest.mark.parametrize("flip", [0.0, 0.2])
def test_eoo_ber_matches_jax(flip, tmp_path, capsys):
    rng = np.random.default_rng(3)
    tx = np.sign(rng.standard_normal(112)).astype(np.float32)
    frames = [tx * np.where(rng.random(112) < f, -1, 1)
              for f in (flip, 0.3, flip)]
    txf, rxf = str(tmp_path / "tx.f32"), str(tmp_path / "rx.f32")
    tx.tofile(txf)
    np.concatenate(frames).astype(np.float32).tofile(rxf)
    rc = chirp.eoo_ber_main([txf, rxf])
    ours = capsys.readouterr().out
    jrc = jchirp.eoo_ber_main([txf, rxf])
    assert (rc, ours) == (jrc, capsys.readouterr().out)
    assert rc == (0 if flip == 0.0 else 1)


def test_est_snr_sweep_matches_jax():
    from radae_tpu.tools.est_snr import run_sweep as jrun_sweep
    from radae_tpu_torch.tools.est_snr import run_sweep
    for fading in (False, True):
        t, e = run_sweep(np.arange(0, 16, 5.0), nframes=20, fading=fading)
        jt, je = jrun_sweep(np.arange(0, 16, 5.0), nframes=20, fading=fading)
        assert np.array_equal(t, jt) and np.array_equal(e, je)
    assert np.all(np.diff(e) > 0)


def test_est_snr_stats_and_refit_match_jax(one_thread):
    """ReceiverOne._rx's raw pilot statistics against radae_tpu's _jit_rx
    on the same noisy segments, and the refit line on 3 SNRs, 4 frames."""
    from radae_tpu.config import flagship_config as jflagship
    from radae_tpu.dsp.streaming import ReceiverOne as JReceiverOne
    from radae_tpu.ops import cplx as jcplx
    from radae_tpu.tools.est_snr import refit_pipeline as jrefit
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.dsp.streaming import ReceiverOne
    from radae_tpu_torch.tools.est_snr import (pipeline_stream, raw_stats,
                                               refit_pipeline)
    cfg = flagship_config()
    rng = np.random.default_rng(5)
    stream = pipeline_stream(cfg, 4, rng, "cpu")
    r, jr = ReceiverOne(cfg, "cpu"), JReceiverOne(jflagship())
    win = cfg.Nmf + cfg.M + cfg.Ncp
    for sigma in (0.0, 0.05, 0.2):
        noisy = (stream + sigma * (rng.standard_normal(len(stream))
                                   + 1j * rng.standard_normal(len(stream)))
                 ).astype(np.complex64)
        for i in range(4):
            seg = noisy[i * cfg.Nmf: i * cfg.Nmf + win]
            got = raw_stats(r, seg)
            want = np.asarray(jr._jit_rx(jcplx.pack_np(seg))[1])
            np.testing.assert_allclose(got, want, **TOL)
    snrs = np.array([0.0, 6.0, 12.0])
    m, c, t, raws = refit_pipeline(snrs, nframes=4, device="cpu")
    jm, jc, jt, jraws = jrefit(snrs, nframes=4)
    np.testing.assert_allclose(t, jt, rtol=0, atol=1e-12)
    np.testing.assert_allclose(raws, jraws, rtol=0, atol=1e-3)
    assert abs(m - jm) < 1e-3 and abs(c - jc) < 1e-3


def test_ml_pilots_follows_jax_on_its_draws(one_thread, monkeypatch):
    """5 epochs x 3 batches, the port's `normal` replaced by the draws of
    radae_tpu's keys [epoch, b + seed] (each split into the real and the
    imaginary half, in radae_tpu's order)."""
    import jax
    from radae_tpu.tools.ml_pilots import train_pilots as jtrain
    from radae_tpu_torch.config import RADAEConfig
    from radae_tpu_torch.tools import ml_pilots
    M = RADAEConfig(latent_dim=40, EbNodB=100, rate_Fs=True, pilots=True,
                    cyclic_prefix=0.004).M
    draws = []
    for epoch in range(5):
        for b in range(3):
            kr, ki = jax.random.split(jax.numpy.asarray(
                np.array([epoch, b], np.uint32)))
            draws += [np.array(jax.random.normal(k, (M,))) for k in (kr, ki)]
    it = iter(draws)
    monkeypatch.setattr(ml_pilots, "normal", lambda gen, shape: torch.as_tensor(
        next(it), device=gen.device))
    params, papr = ml_pilots.train_pilots(EsNodB=10, epochs=5, batches=3,
                                          device="cpu")
    assert next(it, None) is None
    jparams, jpapr = jtrain(EsNodB=10, epochs=5, batches=3)
    for k in ("Pr", "Pi"):
        np.testing.assert_allclose(params[k], np.asarray(jparams[k]),
                                   rtol=1e-5, atol=0)
    assert abs(papr - float(jpapr)) < 1e-4


def test_ml_pilots_main_on_its_own_draws(one_thread, tmp_path, capsys):
    from radae_tpu_torch.tools import ml_pilots
    out = str(tmp_path / "p.c64")
    ml_pilots.main(["--epochs", "2", "--out", out, "--device", "cpu"])
    assert "trained pilot PAPR" in capsys.readouterr().out
    p = np.fromfile(out, np.complex64)
    assert p.shape == (15,) and np.isfinite(p).all()


def test_ota_channel_and_tx_match_jax():
    from radae_tpu.tools import ota as jota
    from radae_tpu_torch.tools import ota
    rng = np.random.default_rng(0)
    iq = (0.3 * (rng.standard_normal(16000)
                 + 1j * rng.standard_normal(16000))).astype(np.complex64)
    tx, secs = ota.build_ota_tx(iq)
    jtx, jsecs = jota.build_ota_tx(iq)
    assert secs == jsecs and np.array_equal(tx, jtx)
    for channel in ("awgn", "mpp"):
        got = ota.apply_channel(tx, 40.0, channel,
                                rng=np.random.default_rng(1))
        want = jota.apply_channel(tx, 40.0, channel,
                                  rng=np.random.default_rng(1))
        assert np.array_equal(got, want)


def test_ota_main_on_the_cpu(one_thread, tmp_path, capsys):
    from radae_tpu_torch.tools.ota import main
    f = np.zeros((480, 36), np.float32)
    f[:, :20] = np.random.default_rng(0).standard_normal((480, 20)) * 0.3
    fin = str(tmp_path / "f.f32")
    f.tofile(fin)
    assert main(["random", fin, "--CNodB", "50", "--device", "cpu"]) == 0
    assert "OTA PASS" in capsys.readouterr().out


def test_webtx_roundtrip(one_thread, tmp_path):
    """POST a wav to the port's web tx service on 127.0.0.1 (port 0): the IQ
    has radae_tpu's length for the same wav (its vocoder analysis and
    framing), and the port's RadaeRx acquires it and finds its EOO."""
    from http.server import ThreadingHTTPServer
    from radae_tpu.config import flagship_config as jflagship_config
    from radae_tpu.vocoder import get_vocoder as jget_vocoder
    from radae_tpu_torch.apps.rxe import RadaeRx
    from radae_tpu_torch.tools.webtx import make_handler
    from radae_tpu_torch.vocoder import MelVocoder, SPEECH_FS

    from radae_tpu_torch.convert import load_checkpoint
    params, _ = load_checkpoint(CKPT)
    feats = np.fromfile(FEATS, np.float32).reshape(-1, 36)
    srv = ThreadingHTTPServer(("127.0.0.1", 0),
                              make_handler(params, device="cpu"))
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    try:
        url = f"http://127.0.0.1:{srv.server_port}"
        assert b"form" in urllib.request.urlopen(url).read()
        # 3 s of speech (vocoder synthesis from the fixture's features)
        pcm = MelVocoder().synthesize(feats[:300]).astype(np.int16)
        wav_path = tmp_path / "in.wav"
        with wave.open(str(wav_path), "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(SPEECH_FS)
            w.writeframes(pcm.tobytes())
        req = urllib.request.Request(url + "/tx", data=wav_path.read_bytes(),
                                     method="POST")
        iq = np.frombuffer(urllib.request.urlopen(req).read(),
                           np.float32).view(np.complex64)
    finally:
        srv.shutdown()
        srv.server_close()

    # radae_tpu's handler: its vocoder's frames, Nmf samples each, and
    # its EOO frame
    jcfg = jflagship_config()
    jlen = len(jget_vocoder().extract(pcm)) // 12 * jcfg.Nmf + jcfg.eoo.size
    assert len(iq) == jlen > 8000

    rx = RadaeRx(params=params, auxdata=True, v=0, device="cpu")
    out = np.zeros(rx.get_n_floats_out(), np.float32)
    stream = np.concatenate([iq, np.zeros(16000, np.complex64)])
    got_valid = got_eoo = False
    ptr = 0
    while ptr + rx.get_nin() <= len(stream):
        nin = rx.get_nin()
        ret = rx.do_radae_rx(stream[ptr:ptr + nin], out)
        got_valid |= bool(ret & 1)
        got_eoo |= bool(ret & 2)
        ptr += nin
    assert got_valid and got_eoo


def test_profile_train_breakdown_rows(one_thread):
    from radae_tpu_torch.tools.profile import ROWS, train_breakdown
    rows = train_breakdown([2], T=48, scan=1, n1=1, n2=4, slopes=3,
                           device="cpu")
    assert len(rows) == 1 and rows[0]["B"] == 2
    assert set(rows[0]) - {"B"} == set(ROWS)
    assert all(rows[0][k] > 0 for k in ROWS), rows


def test_profile_rx_step_and_trace(one_thread, tmp_path, capsys):
    from radae_tpu_torch.tools.profile import main
    main(["--batch", "4", "--device", "cpu", "--trace", str(tmp_path)])
    out = capsys.readouterr().out
    assert "streaming rx step B=4" in out
    assert os.path.getsize(tmp_path / "rx_step_trace.json") > 1000
    # the traced steps' spans, ten a name, and their clock offset
    for name in ("rx.front_end", "rx.front_end.dft", "rx.front_end.pilot_eq",
                 "rx.front_end.demap", "rx.decode"):
        assert f"{name:>24}   10 " in out, out
    assert "span start - profiler range start: mean" in out


def test_scaling_rows_do_not_depend_on_the_ranks(one_thread):
    from radae_tpu_torch.tools.scaling import measure_scaling
    rows = measure_scaling((1, 2), B=4, T=48, device="cpu", eval_reps=1,
                           train_reps=1, threads=1)
    assert [r["devices"] for r in rows] == [1, 2]
    assert all(r["eval_s"] > 0 and r["train_s"] > 0 for r in rows)
    assert abs(rows[0]["loss0"] - rows[1]["loss0"]) < 1e-5, rows
