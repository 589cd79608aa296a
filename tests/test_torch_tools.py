"""The port's file tools (tools/inference.py, rx.py, loss.py, stateful.py)
and the batch tools' random model against radae_tpu's on the CPU, run as
radae_tpu's tests/test_tools.py and test_tools2.py run them: model `random`,
`--device cpu` (the kernels' plain versions).

inference's written features, latents, tx and rx (with the EOO, the pre-
and appended noise and the sine interferer) equal radae_tpu's at rtol 1e-4,
atol 1e-5 with quantization noise off and the channel's Gaussian draw
replaced by the same arrays in both; the inference -> rx -> loss pipeline
passes the gates of tests/test_tools.py; rx --stateful agrees with the
vanilla decode (distortion loss between the two below the stateful tools'
0.01); both stateful tools pass and write radae_tpu's latents."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from radae_tpu.models.radae import RADAE as JRADAE
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES
from radae_tpu_torch.models.core import distortion_loss
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.tools import inference, loss, rx, stateful
from tests.test_tools import make_feature_file
from tests.test_torch_channel import one_thread, same_noise  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-4, atol=1e-5)
CPU = ["--device", "cpu"]
FLAGSHIP = ["--pilots", "--pilot_eq", "--eq_ls", "--cp", "0.004",
            "--rate_Fs", "--bottleneck", "3", "--coarse_mag"]


def _feats(path):
    return np.fromfile(path, np.float32).reshape(-1, NB_TOTAL_FEATURES)


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    """tests/test_tools.py's pipeline on the port: inference at 30 dB with a
    2 Hz offset, the EOO and pre/appended noise written as IQ, then rx
    vanilla and --stateful on it."""
    d = tmp_path_factory.mktemp("pipeline")
    fin, rxf = str(d / "f.f32"), str(d / "rx.f32")
    make_feature_file(fin, nframes=480)
    inference.main(["random", fin, "/dev/null", "--EbNodB", "30"] + FLAGSHIP
                   + ["--time_offset", "-16", "--freq_offset", "2",
                      "--write_rx", rxf, "--prepend_noise", "0.5",
                      "--append_noise", "0.3", "--end_of_over"] + CPU)
    outs = {}
    for name, flag in (("vanilla", []), ("stateful", ["--stateful"])):
        outs[name] = str(d / f"fhat_{name}.f32")
        assert rx.main(["random", rxf, outs[name], "--bottleneck", "3"]
                       + flag + CPU) == 0
    return fin, rxf, outs


def test_inference_rx_loss_pipeline(pipeline, capsys):
    fin, _, outs = pipeline
    rc = loss.main([fin, outs["vanilla"], "--clip_end", "100",
                    "--acq_time_test", "1.5"] + CPU)
    out = capsys.readouterr().out
    assert rc == 0 and "PASS" in out and "acq_time:" in out


def test_rx_stateful_agrees_with_vanilla(pipeline, capsys):
    """The per-frame receiver + the decoder kernel one frame a launch gives
    the vanilla decode (whole-stream EQ, one launch) on the frames both
    give; loss --compare passes on the two."""
    fin, _, outs = pipeline
    a, b = _feats(outs["vanilla"]), _feats(outs["stateful"])
    n = min(len(a), len(b))
    assert n > 400 and abs(len(a) - len(b)) <= 12
    d = float(distortion_loss(torch.as_tensor(a[None, :n, :20]),
                              torch.as_tensor(b[None, :n, :20]))[0])
    assert d < 0.01, d
    rc = loss.main([fin, outs["vanilla"], "--clip_end", "100",
                    "--features_hat2", outs["stateful"], "--compare"] + CPU)
    out = capsys.readouterr().out
    assert rc == 0 and "delta:" in out and out.strip().endswith("PASS")


def test_rx_acq_test(pipeline, capsys):
    _, rxf, _ = pipeline
    assert rx.main(["random", rxf, "/dev/null", "--acq_test", "--ntrials",
                    "3", "--fmax_target", "2"] + CPU) == 0
    assert "P(fail): 0.00" in capsys.readouterr().out


def test_rx_does_not_acquire_on_noise(tmp_path):
    rng = np.random.default_rng(0)
    rxf = str(tmp_path / "noise.f32")
    n = 8000 * 4
    ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) / np.sqrt(2)
     ).astype(np.complex64).tofile(rxf)
    with pytest.raises(SystemExit) as e:
        rx.main(["random", rxf, "/dev/null", "--bottleneck", "3"] + CPU)
    assert e.value.code == 1


def test_loss_gates(tmp_path, capsys):
    fin, fhat = str(tmp_path / "f.f32"), str(tmp_path / "fh.f32")
    f = make_feature_file(fin)
    shifted = f[30:200].copy()
    shifted[:, :20] += 0.01
    shifted.tofile(fhat)
    assert loss.main([fin, fhat, "--loss_test", "0.05",
                      "--acq_time_test", "0.5"] + CPU) == 0
    out = capsys.readouterr().out
    assert "start: 30 acq_time:  0.30 s" in out and "PASS" in out
    assert loss.main([fin, fhat, "--acq_time_test", "0.2"] + CPU) == 1
    assert capsys.readouterr().out.strip().endswith("FAIL")
    assert loss.main([fin, fhat, "--clip_start", "10", "--loss_test",
                      "1e-6"] + CPU) == 1


def test_find_loss_matches_jax(tmp_path, capsys):
    """The vectorised alignment scan and its per-frame losses."""
    from radae_tpu.tools import loss as jloss
    fin, fhat = str(tmp_path / "f.f32"), str(tmp_path / "fh.f32")
    make_feature_file(fin, nframes=300)
    make_feature_file(fhat, nframes=220, seed=1)
    got = loss.find_loss(fin, fhat, 5, 7, "cpu")
    want = jloss.find_loss(fin, fhat, 5, 7)
    assert got[1] == want[1]
    np.testing.assert_allclose(got[0], want[0], **TOL)
    np.testing.assert_allclose(got[2], np.asarray(want[2]), **TOL)
    out = capsys.readouterr().out.splitlines()
    assert out[:2] == out[2:]


def test_inference_ber_printout(tmp_path, capsys):
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin)
    inference.main(["random", fin, "/dev/null", "--EbNodB", "100",
                    "--pilots", "--pilot_eq", "--eq_ls", "--cp", "0.004",
                    "--rate_Fs", "--ber_test"] + CPU)
    out = capsys.readouterr().out
    assert "BER: 0.000" in out and "Measured:" in out


@pytest.fixture
def noise_off(monkeypatch, same_noise):
    """Quantization noise off and the same channel draw in both packages;
    radae_tpu's forward under jax.jit."""
    monkeypatch.setattr(JRADAE, "_noise_key", lambda self, key: None)
    monkeypatch.setattr(RADAE, "_noise_key", lambda self, key: None)
    real = JRADAE.forward

    def jitted(self, params, feats, H, G=None, key=None, EbNodB=None):
        return jax.jit(lambda p, f, h, g, k: real(self, p, f, h, g, key=k))(
            params, feats, H, G, key)

    monkeypatch.setattr(JRADAE, "forward", jitted)


def test_inference_matches_jax(tmp_path, capsys, noise_off):
    """Written features, latents, tx and rx (EOO with phase continuity,
    pre/appended noise, sine interferer) and the printed lines."""
    from radae_tpu.tools import inference as jinference
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin, nframes=250)
    outs = {}
    for name, run, extra in (("jax", jinference.main, []),
                             ("port", inference.main, CPU)):
        d = tmp_path / name
        d.mkdir()
        run(["random", fin, str(d / "fh.f32"), "--EbNodB", "100", "--seed",
             "2", "--auxdata", "--time_offset", "-16", "--freq_offset",
             "2.5", "--df_dt", "0.1", "--write_rx", str(d / "rx.f32"),
             "--write_latent", str(d / "z.f32"), "--write_tx",
             str(d / "tx.f32"), "--end_of_over", "--prepend_noise", "0.25",
             "--append_noise", "0.125", "--sine_amp", "0.1", "--rx_gain",
             "0.9"] + FLAGSHIP + extra)
        outs[name] = (d, capsys.readouterr().out)
    (jd, jout), (pd, pout) = outs["jax"], outs["port"]
    assert pout == jout and "loss:" in pout and "Auxdata BER:" in pout
    for fn, dtype in (("fh.f32", np.float32), ("z.f32", np.float32),
                      ("tx.f32", np.complex64), ("rx.f32", np.complex64)):
        a = np.fromfile(pd / fn, dtype)
        b = np.fromfile(jd / fn, dtype)
        assert a.shape == b.shape and a.size, fn
        np.testing.assert_allclose(a, b, err_msg=fn, **TOL)


def test_stateful_tools_pass_and_match_jax(tmp_path, capsys):
    from radae_tpu.tools import stateful as jstateful
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin, nframes=120)
    zp, zj = str(tmp_path / "zp.f32"), str(tmp_path / "zj.f32")
    assert stateful.stateful_encoder(["random", fin, "--write_latent", zp]
                                     + CPU) == 0
    out = capsys.readouterr().out
    assert "mean |z_vanilla - z_stream|: 0.0000" in out and "PASS" in out
    assert jstateful.stateful_encoder(["random", fin, "--write_latent",
                                       zj]) == 0
    capsys.readouterr()
    np.testing.assert_allclose(np.fromfile(zp, np.float32),
                               np.fromfile(zj, np.float32), **TOL)
    assert stateful.stateful_decoder(["random", fin] + CPU) == 0
    out = capsys.readouterr().out
    assert "loss delta vanilla vs streaming: 0.0000" in out and "PASS" in out
    assert stateful.stateful_decoder(["random", fin, "--read_latent", zj]
                                     + CPU) == 0
    assert stateful.stateful_encoder(["random", fin, "--read_latent", zj]
                                     + CPU) == 0
    assert capsys.readouterr().out.count("PASS") == 2


def test_batch_tools_random_model_match_jax(tmp_path, capsys):
    """tx_batch and rx_batch take model `random` with --seed, as radae_tpu's
    do: the same weights, so the same IQ and features."""
    from radae_tpu.tools import rx_batch as jrx
    from radae_tpu.tools import tx_batch as jtx
    from radae_tpu_torch.tools import rx_batch, tx_batch
    feats = np.fromfile(os.path.join(ROOT, "fixtures", "speech_feats.f32"),
                        np.float32).reshape(-1, 36)
    fn = str(tmp_path / "in.f32")
    f36 = np.zeros((4 * 12, 36), np.float32)
    f36[:, :20] = feats[:48, :20]
    f36.tofile(fn)
    args = ["random", "--seed", "5"]
    assert jtx.main([args[0], str(tmp_path / "jax"), fn] + args[1:]) == 0
    assert tx_batch.main([args[0], str(tmp_path / "port"), fn] + args[1:]
                         + CPU) == 0
    a = np.fromfile(tmp_path / "port" / "in_iq.f32", np.complex64)
    b = np.fromfile(tmp_path / "jax" / "in_iq.f32", np.complex64)
    np.testing.assert_allclose(a, b, **TOL)
    iq = np.concatenate([np.zeros(300, np.complex64), a,
                         np.zeros(2000, np.complex64)])
    iqf = str(tmp_path / "iq.f32")
    iq.tofile(iqf)
    flags = ["--n-windows", "2"] + args[1:]
    capsys.readouterr()
    assert jrx.main(["random", str(tmp_path / "jrx"), iqf] + flags) == 0
    ref = capsys.readouterr().out
    assert rx_batch.main(["random", str(tmp_path / "prx"), iqf] + flags
                         + CPU) == 0
    assert capsys.readouterr().out == ref and "acquired 1" in ref
    np.testing.assert_allclose(
        np.fromfile(tmp_path / "prx" / "iq_feat.f32", np.float32),
        np.fromfile(tmp_path / "jrx" / "iq_feat.f32", np.float32),
        rtol=1e-4, atol=2e-4)


def test_cli_runs_the_new_tools(tmp_path):
    """`python -m radae_tpu_torch <tool>` dispatches the file tools."""
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin, nframes=60)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "radae_tpu_torch", "--help"],
                       cwd=ROOT, capture_output=True, text=True, timeout=60)
    for name in ("inference", "rx", "loss", "stateful_encoder",
                 "stateful_decoder"):
        assert f"  {name}\n" in r.stdout
    r = subprocess.run([sys.executable, "-m", "radae_tpu_torch", "loss", fin,
                        fin, "--loss_test", "1e-6"] + CPU, cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and "PASS" in r.stdout, r.stderr
