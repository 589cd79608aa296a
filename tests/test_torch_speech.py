"""The port's speech back end against radae_tpu's on the CPU: the vocoders
(vocoder.py, vocoder_nn.py), data/augment.py, utils/quality.py, tools/ch.py,
the wav pipeline and evaluate --audio.

The numpy copies (MelVocoder, augment, quality, ch, envelope_correct) give
radae_tpu's outputs exactly.  The neural vocoder's frame net and spectral
loss agree at rtol 1e-4 on T <= 50 frames.  Its synth agrees at 1e-4
normwise (ℓ2 of the difference over ℓ2 of radae_tpu's waveform): the
oscillators' phase is an f32 cumsum over the whole input, which jax's CPU
scan associates otherwise than torch's (0.125 apart at 1.09e6 after 50
frames), and up to 64 harmonics multiply that phase, so single samples
near zero differ by more than an elementwise rtol allows.  One Adam update
agrees with optax's at rtol 1e-5 (atol 1% of lr, the test says why), and
the rates after it with optax's schedule (cosine decay on and off).  The CLIs run
as tests/test_tools2.py runs radae_tpu's, with --device cpu."""

import os
import re
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radae_tpu import vocoder as jvoc
from radae_tpu import vocoder_nn as JV
from radae_tpu.data import augment as jaug
from radae_tpu.tools import ch as jch
from radae_tpu.utils import quality as jq
from radae_tpu_torch import vocoder as voc
from radae_tpu_torch import vocoder_nn as V
from radae_tpu_torch.data import augment as aug
from radae_tpu_torch.tools import ch, evaluate, wav_pipeline
from radae_tpu_torch.utils import quality as q
from tests.test_tools import make_feature_file
from tests.test_torch_bbfm import same_quant_noise  # noqa: F401
from tests.test_torch_channel import one_thread, same_noise  # noqa: F401
from tests.test_vocoder_nn import HOLDOUT, WAV_DIR

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHTS = os.path.join(ROOT, "fixtures", "vocoder_nn.npz")
FEATS = os.path.join(ROOT, "fixtures", "speech_feats.f32")
TOL = dict(rtol=1e-4, atol=1e-6)
CPU = ["--device", "cpu"]
WAV_LOSS_TOL = 0.001    # one in the printout's last place


@pytest.fixture(scope="module")
def feats36():
    return np.fromfile(FEATS, np.float32).reshape(-1, 36)


@pytest.fixture(scope="module")
def weights():
    return V.params_to_torch(V.load_params(WEIGHTS), "cpu"), \
        JV.load_params(WEIGHTS)


def _voiced(seconds=0.5, f0=130.0, seed=0):
    """A harmonic-rich voiced int16 signal with a little noise."""
    t = np.arange(int(16000 * seconds)) / 16000
    x = sum(np.cos(2 * np.pi * f0 * h * t) / (1 + 0.3 * h) for h in range(1, 20))
    x = x + 0.05 * np.random.default_rng(seed).standard_normal(len(t))
    return (x / np.abs(x).max() * 12000).astype(np.int16)


def _write_wav(path, pcm, fs=16000):
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(np.asarray(pcm, np.int16).tobytes())


# -- numpy copies -----------------------------------------------------------

def test_mel_vocoder_copy_equals_jax(feats36):
    a, b = voc.MelVocoder(), jvoc.MelVocoder()
    pcm = _voiced()
    np.testing.assert_array_equal(a.extract(pcm), b.extract(pcm))
    np.testing.assert_array_equal(a.synthesize(feats36[:30]),
                                  b.synthesize(feats36[:30]))


def test_augment_copy_equals_jax(tmp_path):
    pcm = _voiced(0.3).astype(np.float32)
    for f in (0.85, 1.0, 1.16):
        np.testing.assert_array_equal(aug.warp(pcm, f), jaug.warp(pcm, f))
    np.testing.assert_array_equal(aug.tilt(pcm, -0.4), jaug.tilt(pcm, -0.4))
    for fn in ("reverb", "bandlimit"):
        np.testing.assert_array_equal(
            getattr(aug, fn)(pcm, np.random.default_rng(3)),
            getattr(jaug, fn)(pcm, np.random.default_rng(3)))
    kw = dict(speeds=(0.92, 1.0), tilts=(0.0, 0.4), reverse=True, room=True)
    ours = list(aug.augment_pcm(pcm, np.random.default_rng(5), **kw))
    ref = list(jaug.augment_pcm(pcm, np.random.default_rng(5), **kw))
    assert len(ours) == len(ref) == 8
    for x, y in zip(ours, ref):
        np.testing.assert_array_equal(x, y)
    _write_wav(tmp_path / "a.wav", pcm)
    np.testing.assert_array_equal(aug.read_wav(str(tmp_path / "a.wav")),
                                  jaug.read_wav(str(tmp_path / "a.wav")))
    outs = [str(tmp_path / n) for n in ("ours.f32", "ref.f32")]
    for mod, out in zip((aug, jaug), outs):
        assert mod.build_corpus(str(tmp_path), out, speeds=(1.0,),
                                tilts=(0.0,), verbose=False) > 0
    np.testing.assert_array_equal(np.fromfile(outs[0], np.float32),
                                  np.fromfile(outs[1], np.float32))


def test_quality_copy_equals_jax():
    ref = _voiced(0.6).astype(np.float32)
    syn = np.roll(ref, 40) * 0.7 + 300 * np.random.default_rng(1) \
        .standard_normal(len(ref))
    assert q.fwsegsnr(ref, syn) == jq.fwsegsnr(ref, syn)
    assert q.fwsegsnr_aligned(ref, syn) == jq.fwsegsnr_aligned(ref, syn)
    np.testing.assert_array_equal(q._bark_bank(512, 16000.0),
                                  jq._bark_bank(512, 16000.0))


@pytest.mark.parametrize("fading", [None, "mpp"])
def test_ch_copy_equals_jax(fading):
    x = np.exp(1j * 2 * np.pi * 300 * np.arange(8000) / 8000).astype(
        np.complex64)
    y, cno = ch.apply_ch(x, -20.0, fading=fading, rng=np.random.default_rng(2))
    yr, cnor = jch.apply_ch(x, -20.0, fading=fading,
                            rng=np.random.default_rng(2))
    np.testing.assert_array_equal(y, yr)
    assert cno == cnor
    pcm = _voiced(0.5).astype(np.float32)[::2]
    np.testing.assert_array_equal(ch.analog_compressor(pcm),
                                  jch.analog_compressor(pcm))


def test_ch_cli(tmp_path, capsys):
    """`ch` on an IQ file as radae_tpu's: the same samples and C/No line."""
    x = np.exp(1j * 2 * np.pi * 500 * np.arange(4000) / 8000).astype(
        np.complex64)
    fin = str(tmp_path / "x.c64")
    x.tofile(fin)
    outs = [str(tmp_path / n) for n in ("ours.c64", "ref.c64")]
    ch.main([fin, outs[0], "--No", "-25", "--fading", "mpg", "--seed", "4"])
    jch.main([fin, outs[1], "--No", "-25", "--fading", "mpg", "--seed", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0] == lines[1] and lines[0].startswith("C/No:")
    np.testing.assert_array_equal(np.fromfile(outs[0], np.complex64),
                                  np.fromfile(outs[1], np.complex64))


# -- the neural vocoder ------------------------------------------------------

@pytest.mark.parametrize("seed, hid", [(0, 192), (3, 32)])
def test_init_params_match_jax(seed, hid):
    a, b = V.init_params(seed, hid), JV.init_params(seed, hid)
    for k1 in b:
        for k2 in b[k1]:
            np.testing.assert_array_equal(a[k1][k2], np.asarray(b[k1][k2]))


def test_frame_net_matches_jax(weights, feats36):
    tp, jp = weights
    f = feats36[None, 100:150, :20].copy()
    with torch.no_grad():
        got = V.frame_net(tp, torch.as_tensor(f))
    for g, w in zip(got, JV.frame_net(jp, jnp.asarray(f))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("start", [0, 300, 1000])
def test_synth_matches_jax(weights, feats36, start):
    tp, jp = weights
    T = 50
    f = feats36[None, start:start + T, :20].copy()
    nz = np.random.default_rng(start).standard_normal(
        (1, (T - 1) * V.FRAME)).astype(np.float32)
    with torch.no_grad():
        y = V.synth(tp, torch.as_tensor(f), torch.as_tensor(nz)).numpy()
    ref = np.asarray(JV.synth(jp, jnp.asarray(f), jnp.asarray(nz)))
    assert y.shape == ref.shape == (1, (T - 1) * V.FRAME)
    assert np.linalg.norm(y - ref) <= 1e-4 * np.linalg.norm(ref)


def test_spectral_loss_matches_jax():
    rng = np.random.default_rng(6)
    pred = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    target = rng.standard_normal((2, 4000)).astype(np.float32) * 0.1
    got = float(V.spectral_loss(torch.as_tensor(pred), torch.as_tensor(target)))
    want = float(JV.spectral_loss(jnp.asarray(pred), jnp.asarray(target)))
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("decay_steps", [None, 3], ids=["constant", "cosine"])
def test_train_step_matches_optax(decay_steps):
    """One Adam update of the spectral loss against radae_tpu's optax step
    on the same batch: the loss at rtol 1e-4, each leaf's gradient within
    1e-4 of its max |g| of jax.grad's, the params at rtol 1e-5, atol 1% of
    lr (Adam's first step is lr * g / (|g| + eps), so the 1e-6 by which the
    two packages' sums differ, on a gradient of 1e-6, moves it by about a
    percent of lr); then the rate of each later step against optax's
    schedule at rtol 1e-6."""
    import optax
    p0 = V.init_params(1, hid=32)
    B, T = 2, 11
    rng = np.random.default_rng(0)
    feats = np.zeros((B, T, 20), np.float32)
    feats[..., :18] = rng.standard_normal((B, T, 18)) * 0.3
    feats[..., 18] = 0.1
    feats[..., 19] = 0.3
    S = (T - 1) * V.FRAME
    nz = rng.standard_normal((B, S)).astype(np.float32)
    target = (0.1 * np.sin(2 * np.pi * 150 * np.arange(S) / 16000)
              * np.ones((B, 1))).astype(np.float32)
    lr = 3e-3
    init, step = V.make_train_step(lr, decay_steps)
    state = init(p0, "cpu")
    state, loss = step(state, *(torch.as_tensor(a)
                                for a in (feats, target, nz)))
    opt, jstep = JV.make_train_step(lr, decay_steps)
    jp = jax.tree_util.tree_map(jnp.asarray, p0)
    jgrad = jax.jit(jax.grad(lambda p: JV.spectral_loss(JV.synth(
        p, jnp.asarray(feats), jnp.asarray(nz)), jnp.asarray(target))))(jp)
    jp, _, jloss = jstep(jp, opt.init(jp), jnp.asarray(feats),
                         jnp.asarray(target), jnp.asarray(nz))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    for k1 in p0:
        for k2 in p0[k1]:
            g, jg = state.params[k1][k2].grad.numpy(), np.asarray(
                jgrad[k1][k2])
            assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max(), (k1, k2)
            np.testing.assert_allclose(
                state.params[k1][k2].detach().numpy(), np.asarray(jp[k1][k2]),
                rtol=1e-5, atol=0.01 * lr, err_msg=f"{k1}.{k2}")
    sched = (optax.constant_schedule(3e-3) if decay_steps is None else
             optax.cosine_decay_schedule(3e-3, decay_steps, alpha=0.2))
    for s in range(1, 6):      # the rate the update of step s runs at
        np.testing.assert_allclose(state.optimizer.param_groups[0]["lr"],
                                   float(sched(s)), rtol=1e-6)
        state.scheduler.step()


def test_params_roundtrip_and_carry(tmp_path):
    """save/load round-trips, a file either package writes loads in the
    other, and params_to_torch keeps radae_tpu's tree and layouts."""
    p = V.init_params(3)
    t = V.params_to_torch(p, "cpu")
    path = str(tmp_path / "w.npz")
    V.save_params(path, t)
    back, ref = V.load_params(path), JV.load_params(path)
    jpath = str(tmp_path / "j.npz")
    JV.save_params(jpath, JV.init_params(3))
    for k1 in p:
        for k2 in p[k1]:
            assert t[k1][k2].dtype == torch.float32
            assert tuple(t[k1][k2].shape) == p[k1][k2].shape
            np.testing.assert_array_equal(back[k1][k2], p[k1][k2])
            np.testing.assert_array_equal(np.asarray(ref[k1][k2]), p[k1][k2])
            np.testing.assert_array_equal(V.load_params(jpath)[k1][k2],
                                          p[k1][k2])


def test_envelope_correct_copy_equals_jax(feats36):
    y = np.random.default_rng(2).standard_normal(31 * V.FRAME).astype(
        np.float32) * 0.05
    np.testing.assert_array_equal(V.envelope_correct(y, feats36[:30, :20]),
                                  JV.envelope_correct(y, feats36[:30, :20]))


def test_neural_vocoder_matches_jax(feats36):
    """NeuralVocoder.synthesize on 50 frames (render, post-filter, int16)
    within 8 of 32767 of radae_tpu's pcm (the render's 1e-4 normwise
    difference through the post-filter's gains), and clean_metric within
    1e-3 relative."""
    ours = V.NeuralVocoder(WEIGHTS, device="cpu")
    ref = JV.NeuralVocoder(WEIGHTS)
    a = ours.synthesize(feats36[:50]).astype(np.int32)
    b = ref.synthesize(feats36[:50]).astype(np.int32)
    assert a.shape == b.shape and np.abs(a - b).max() <= 8
    np.testing.assert_allclose(V.clean_metric(ours.params, feats36[:50]),
                               JV.clean_metric(ref.params, feats36[:50]),
                               rtol=1e-3)


def test_trained_fixture_beats_classical_synthesis(feats36):
    """radae_tpu's test_trained_fixture_beats_classical_synthesis on the
    port: 500 frames synthesized and re-analysed, the neural vocoder's
    cepstral distance to the input below MelVocoder's."""
    f = feats36[:500]
    d_neural = V.cepstral_distance(f, V.NeuralVocoder(
        WEIGHTS, device="cpu").synthesize(f))
    assert d_neural < V.cepstral_distance(f, voc.MelVocoder().synthesize(f))


def test_fwsegsnr_holdout_regression():
    """radae_tpu's holdout gate on the port: skips, as radae_tpu's does,
    while the reference wav files are not in the repository."""
    if not os.path.isdir(WAV_DIR):
        pytest.skip("reference wav fixtures not present")
    mel, nv = voc.MelVocoder(), V.NeuralVocoder(WEIGHTS, device="cpu")
    for name in HOLDOUT:
        pcm = aug.read_wav(os.path.join(WAV_DIR, name))
        feats = mel.extract(pcm.astype(np.int16))
        q_classical = q.fwsegsnr_aligned(pcm, np.asarray(
            mel.synthesize(feats), np.float32))
        q_neural = q.fwsegsnr_aligned(pcm, np.asarray(nv.synthesize(feats),
                                                      np.float32))
        assert q_neural > q_classical and q_classical > 8.0 \
            and q_neural > 12.0, (name, q_neural, q_classical)


def test_get_vocoder_backends(monkeypatch):
    monkeypatch.delenv("RADAE_LPCNET_DEMO", raising=False)
    monkeypatch.setattr(voc.shutil, "which", lambda name: None)
    assert isinstance(voc.get_vocoder(backend="mel"), voc.MelVocoder)
    for backend in ("auto", "neural"):
        v = voc.get_vocoder(backend=backend, device="cpu")
        assert isinstance(v, V.NeuralVocoder) and v.device.type == "cpu"
    monkeypatch.setenv("RADAE_LPCNET_DEMO", __file__)
    assert isinstance(voc.get_vocoder(device="cpu"), voc.FARGANVocoder)


# -- the CLIs ------------------------------------------------------------

def test_wav_pipeline(tmp_path, capsys, same_noise, same_quant_noise):
    """radae_tpu's test_wav_pipeline_passthru (neural back end, the same
    pcm within 8), and the full path through inference with the mel back
    end in both packages, the channel's draw and the quant noise shared:
    the decoded features' loss (inference's printout, to 3 decimals)
    within WAV_LOSS_TOL of radae_tpu's, and the wavs within 8 pcm."""
    from radae_tpu.tools.wav_pipeline import main as jmain
    pcm = _voiced(0.5, f0=150.0)
    win = str(tmp_path / "in.wav")
    wav_pipeline.write_wav(win, pcm)
    outs = [str(tmp_path / n) for n in ("ours.wav", "ref.wav")]
    wav_pipeline.main(["random", win, outs[0], "--passthru"] + CPU)
    jmain(["random", win, outs[1], "--passthru"])
    a, b = (wav_pipeline.read_wav(o).astype(np.int32) for o in outs)
    assert len(a) == len(b) > 6000 and np.abs(a - b).max() <= 8
    capsys.readouterr()
    losses = []
    for run, out, extra in ((wav_pipeline.main, outs[0], CPU),
                            (jmain, outs[1], [])):
        run(["random", win, out, "--vocoder", "mel", "--EbNodB", "20"]
            + extra)
        losses.append(float(re.search(r"loss: *([-0-9.]+)",
                                      capsys.readouterr().out).group(1)))
    assert abs(losses[0] - losses[1]) <= WAV_LOSS_TOL, losses
    a, b = (wav_pipeline.read_wav(o).astype(np.int32) for o in outs)
    assert len(a) == len(b) > 6000 and np.abs(a).max() > 0
    assert np.abs(a - b).max() <= 8


def test_vocoder_nn_cli(tmp_path, feats36):
    """corpus from two wavs, two epochs of train (the loss finite, weights
    written), then synth with the trained weights and with the fixture
    (the fixture's pcm as NeuralVocoder.synthesize gives it)."""
    wavs = tmp_path / "wavs"
    wavs.mkdir()
    for k, f0 in enumerate((120.0, 180.0)):
        _write_wav(wavs / f"s{k}.wav", _voiced(1.3, f0=f0, seed=k))
    corpus, out = str(tmp_path / "c.npz"), str(tmp_path / "run")
    assert V.main(["corpus", str(wavs), corpus] + CPU) == 0
    assert V.main(["train", corpus, out, "--epochs", "2", "--batch", "8",
                   "--hid", "32"] + CPU) == 0
    w = os.path.join(out, "vocoder_ep2.npz")
    trained = V.load_params(w)
    assert trained["gru"]["w_ih"].shape == (96, 32)
    ff = str(tmp_path / "f.f32")
    feats36[:40].tofile(ff)
    for weights in (w, WEIGHTS):
        pcm_out = str(tmp_path / "o.pcm")
        assert V.main(["synth", weights, ff, pcm_out] + CPU) == 0
        got = np.fromfile(pcm_out, np.int16)
        assert len(got) == 39 * V.FRAME
    np.testing.assert_array_equal(got, V.NeuralVocoder(
        WEIGHTS, device="cpu").synthesize(feats36[:40]))


def test_evaluate_audio_cells(tmp_path):
    """radae_tpu's test_evaluate_audio_cells on the port: per cell a decoded
    wav (16 kHz), an SSB wav (8 kHz) at the same C/No, and a README."""
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin, nframes=48)
    adir = str(tmp_path / "audio")
    evaluate.main(["random", fin, "--channels", "awgn,mpp", "--EbNodB", "6",
                   "--reps", "1", "--seconds", "0.48", "--audio", adir] + CPU)
    for cell in ("f_6dB_awgn", "f_6dB_mpp"):
        for suffix, fs in ((".wav", 16000), ("_ssb.wav", 8000)):
            with wave.open(os.path.join(adir, cell + suffix), "rb") as w:
                assert w.getframerate() == fs
                assert w.getnframes() > 1000
        txt = open(os.path.join(adir, cell + "_zREADME.txt")).read()
        assert "Radio Autoencoder" in txt and "SSB" in txt
        lines = txt.splitlines()
        assert abs(float(lines[1].split()[-2]) - float(lines[2].split()[-2])) \
            < 1.0, txt
        assert "fwSegSNR" in lines[3]
    assert os.path.exists(os.path.join(adir, "zz_f_orig.wav"))
    assert os.path.exists(os.path.join(adir, "zz_f_ssb.wav"))
