"""The port's BBFM (config.BBFMConfig, models/bbfm.py, tools/bbfm.py), its
analog FM channel (channel/fm.py), single-carrier modem (dsp/
single_carrier.py, tools/sc_modem.py) against radae_tpu's on the CPU.

BBFMConfig's properties are equal; init equal draw for draw; forward and
receiver on fixtures/model_bbfm.npz at rtol 1e-4, atol 1e-5 with quant
noise off (BBFMConfig(quant_noise=False)) and the channel's Gaussian draw
replaced in both by the same numpy array (radae_tpu's inline
jax.random.normal and the port's `models.bbfm.normal`, monkeypatched in
the test only).  The numpy copies (fm, single_carrier, sc_modem) give
radae_tpu's outputs exactly.  The CLIs run as tests/test_tools2.py runs
radae_tpu's, with --device cpu."""

import io
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radae_tpu.channel import fm as jfm
from radae_tpu.config import BBFMConfig as JBBFMConfig
from radae_tpu.convert import load_checkpoint as jload_checkpoint
from radae_tpu.dsp import single_carrier as jsc
from radae_tpu.models import layers as jlayers
from radae_tpu.models.bbfm import BBFM as JBBFM
from radae_tpu.models.core import distortion_loss as jdistortion_loss
from radae_tpu_torch.channel import fm
from radae_tpu_torch.config import BBFMConfig
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES
from radae_tpu_torch.dsp import single_carrier as sc
from radae_tpu_torch.models import bbfm as bbfm_mod
from radae_tpu_torch.models.bbfm import BBFM
from radae_tpu_torch.models import layers
from radae_tpu_torch.models.core import distortion_loss
from radae_tpu_torch.models.radae import tree_leaves
from radae_tpu_torch.ops import fused_core
from radae_tpu_torch.parallel.trainstep import leaf_tree
from radae_tpu_torch.tools import bbfm as tools
from radae_tpu_torch.tools import sc_modem
from chip_smoke import modem_loopback
from tests.test_tools import make_feature_file
from tests.test_torch_channel import one_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_bbfm.npz")
FEATS = os.path.join(ROOT, "fixtures", "speech_feats.f32")
TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4          # of each leaf's max |g|
CPU = ["--device", "cpu"]


@pytest.fixture(scope="module")
def fixture():
    params, _ = load_checkpoint(CKPT)
    feats = np.fromfile(FEATS, np.float32).reshape(-1, 36)[:, :20]
    return params, feats


@pytest.fixture
def same_draw(monkeypatch):
    """The FM channel's N(0, 1) draw in both packages: the same numpy array
    for a shape (made once per shape)."""
    rng = np.random.default_rng(11)
    draws = {}

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in draws:
            draws[shape] = rng.standard_normal(shape).astype(np.float32)
        return draws[shape]

    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(draw(shape), dtype))
    monkeypatch.setattr(bbfm_mod, "normal",
                        lambda gen, shape: torch.as_tensor(draw(shape)))


@pytest.fixture
def same_quant_noise(monkeypatch):
    """quant_noise in both packages adds the same numpy-made U(-.5, .5)/127:
    the k-th application of a shape in a call gets the k-th draw of that
    shape (made once), in each package apart."""
    rng = np.random.default_rng(13)
    draws, seen = {}, {}

    def draw(pkg, shape):
        shape = tuple(int(s) for s in shape)
        k = seen.get((pkg, shape), 0)
        seen[(pkg, shape)] = k + 1
        bank = draws.setdefault(shape, [])
        if k == len(bank):
            bank.append(rng.uniform(-0.5, 0.5, shape).astype(np.float32))
        return bank[k]

    monkeypatch.setattr(jlayers, "quant_noise", lambda key, x: jnp.clip(
        x + jnp.asarray(draw("jax", x.shape)) / 127.0, -1.0, 1.0))
    monkeypatch.setattr(layers, "quant_noise", lambda gen, x: torch.clamp(
        x + torch.as_tensor(draw("torch", x.shape)) / 127.0, -1.0, 1.0))


# -- config, init ---------------------------------------------------------------

@pytest.mark.parametrize("kw", [{}, dict(latent_dim=80, CNRdB=10.0),
                                dict(fd_Hz=2500.0, fm_Hz=3500.0)],
                         ids=["default", "fixture", "narrow"])
def test_config_properties_equal_jax(kw):
    a, b = BBFMConfig(**kw), JBBFMConfig(**kw)
    for name in ("feature_dim", "latent_dim", "CNRdB", "enc_stride",
                 "dec_stride", "Tf", "Tz", "Rz", "Rb", "beta", "BWfm", "Gfm"):
        assert getattr(a, name) == getattr(b, name), name
    for n in (0, 7, 96, 2400, 2401):
        assert a.num_timesteps_at_rate_Rs(n) == b.num_timesteps_at_rate_Rs(n)
        assert (a.num_10ms_times_steps_rounded_to_modem_frames(n)
                == b.num_10ms_times_steps_rounded_to_modem_frames(n))


@pytest.mark.parametrize("seed", [0, 5])
def test_init_matches_jax_exactly(seed):
    cfg = dict(feature_dim=20, latent_dim=80)
    a = BBFM(BBFMConfig(**cfg), "cpu").init(seed)
    b = JBBFM(JBBFMConfig(**cfg)).init(seed)
    for side in ("encoder", "decoder"):
        assert a[side].keys() == b[side].keys()
        for layer in a[side]:
            for k in a[side][layer]:
                np.testing.assert_array_equal(
                    a[side][layer][k], np.asarray(b[side][layer][k]),
                    err_msg=f"{side}/{layer}/{k}")


# -- forward, receiver ------------------------------------------------------------

def _fade(n_rs, rng):
    """A slow Rayleigh-like fade that dips below the 12 dB FM threshold."""
    t = np.arange(n_rs) / 2000.0
    return (0.3 + np.abs(np.sin(2 * np.pi * 3.0 * t + rng.uniform(0, 6)))
            ).astype(np.float32)[None, :, None]


@pytest.mark.parametrize("CNRdB, faded", [(10.0, False), (20.0, True)],
                         ids=["cnr10", "cnr20_faded"])
def test_forward_matches_jax(fixture, same_draw, CNRdB, faded):
    params, feats = fixture
    kw = dict(feature_dim=20, latent_dim=80, CNRdB=CNRdB, quant_noise=False)
    model, jmodel = BBFM(BBFMConfig(**kw), "cpu"), JBBFM(JBBFMConfig(**kw))
    T = 96
    f = feats[None, 200:200 + T].copy()
    n_rs = model.cfg.num_timesteps_at_rate_Rs(T)
    H = (_fade(n_rs, np.random.default_rng(3)) if faded
         else np.ones((1, n_rs, 1), np.float32))
    with torch.no_grad():
        out = model.forward(params, f, H)
    ref = jmodel.forward(params, f, H, key=jax.random.PRNGKey(0))
    assert set(out) == set(ref)
    for k in out:
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), **TOL,
                                   err_msg=k)
    if faded:     # both sides of the threshold were exercised
        assert (out["CNRdB"] < 12).any() and (out["CNRdB"] > 12).any()


def test_receiver_matches_jax(fixture):
    params, _ = fixture
    cfg = dict(feature_dim=20, latent_dim=80)
    z = np.tanh(np.random.default_rng(4).standard_normal((1, 10, 80))
                ).astype(np.float32)
    with torch.no_grad():
        got = BBFM(BBFMConfig(**cfg), "cpu").receiver(params, z)
    want = JBBFM(JBBFMConfig(**cfg)).receiver(params, z)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_noise_free_calls_run_the_kernels(fixture, monkeypatch):
    """Quant noise off and no gradient: the encoder (bottleneck 1) and the
    decoder each run as their kernel's entry point once over the sequence;
    with quant noise, or under a gradient, the plain nets."""
    params, feats = fixture
    calls = []
    for name in ("fused_encoder_step", "fused_decoder_step"):
        real = getattr(fused_core, name)
        monkeypatch.setattr(fused_core, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, tuple(a[1].shape), a[3:] + tuple(
                                k.values()))) or _r(*a, **k))
    f = feats[None, :48].copy()
    cfg = dict(feature_dim=20, latent_dim=80, CNRdB=15.0)
    H = np.ones((1, BBFMConfig(**cfg).num_timesteps_at_rate_Rs(48), 1),
                np.float32)
    model = BBFM(BBFMConfig(quant_noise=False, **cfg), "cpu")
    with torch.no_grad():
        model.forward(params, f, H)
        model.receiver(params, np.zeros((1, 12, 80), np.float32))
    assert calls == [("fused_encoder_step", (1, 48, 20), (1,)),
                     ("fused_decoder_step", (1, 12, 80), ()),
                     ("fused_decoder_step", (1, 12, 80), ())]
    calls.clear()
    with torch.no_grad():
        BBFM(BBFMConfig(**cfg), "cpu").forward(params, f, H)
    leaves = leaf_tree(params, "cpu")
    loss = distortion_loss(torch.as_tensor(f), model.forward(
        leaves, f, H)["features_hat"]).mean()
    loss.backward()
    assert calls == [] and leaves["encoder"]["dense_1"]["w"].grad is not None


# -- the training loss and its gradient --------------------------------------

@pytest.mark.parametrize("CNRdB, faded", [(10.0, False), (20.0, True)],
                         ids=["cnr10", "cnr20_faded"])
def test_bbfm_loss_gradient_matches_jax(fixture, same_draw, same_quant_noise,
                                        CNRdB, faded):
    """train_bbfm's loss (tools.bbfm.make_loss_fn: the plain encoder with
    bottleneck 1, the FM channel's relus and clamp, the plain decoder, quant
    noise on in both nets) and its autograd gradient against
    jax.value_and_grad of radae_tpu's train_bbfm loss, on model_bbfm.npz at
    B=2, T=48, with the channel's draw and the quant noise shared: the loss
    at rtol 1e-5, each leaf within 1e-4 of that leaf's max |g|."""
    params, feats = fixture
    kw = dict(feature_dim=20, latent_dim=80, CNRdB=CNRdB)
    model, jmodel = BBFM(BBFMConfig(**kw), "cpu"), JBBFM(JBBFMConfig(**kw))
    B, T = 2, 48
    f = np.stack([feats[300 + 97 * b:300 + 97 * b + T] for b in range(B)])
    n_rs = model.cfg.num_timesteps_at_rate_Rs(T)
    H = (np.concatenate([_fade(n_rs, np.random.default_rng(3 + b))
                         for b in range(B)]) if faded
         else np.ones((B, n_rs, 1), np.float32))

    leaves = leaf_tree(params, "cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    loss = tools.make_loss_fn(model)(leaves, torch.as_tensor(f),
                                     torch.as_tensor(H), gen, CNRdB)
    loss.backward()

    jparams, _ = jload_checkpoint(CKPT)
    key = jax.random.PRNGKey(0)

    def jloss(p):        # radae_tpu/tools/bbfm.py train_bbfm's loss_fn
        out_f, _ = jmodel.core_encoder(p["encoder"], f, key=key)
        z_hat, _, _ = jmodel.channel(key, out_f, H, CNRdB)
        fh, _ = jmodel.core_decoder(p["decoder"], z_hat, key=key)
        return jdistortion_loss(jnp.asarray(f), fh).mean()

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jparams)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=LOSS_RTOL)
    n = 0
    for side in ("encoder", "decoder"):
        assert leaves[side].keys() == jg[side].keys()
        for layer in leaves[side]:
            for k, t in leaves[side][layer].items():
                want = np.asarray(jg[side][layer][k])
                scale = np.abs(want).max()
                assert scale > 0 and np.isfinite(t.grad.numpy()).all()
                err = np.abs(t.grad.numpy() - want).max()
                assert err <= GRAD_TOL * scale, (side, layer, k, err / scale)
                n += 1
    assert n == len(list(tree_leaves(leaves)))


# -- the FM channel and the single-carrier modem (numpy copies) -------------

def test_fm_copy_equals_jax():
    rng = np.random.default_rng(0)
    audio = np.sin(2 * np.pi * 700 * np.arange(4800) / 96000) * 0.8
    for kw in ({}, dict(pre_emp=True, de_emp=True), dict(ph_dont_limit=True,
                                                        output_filter=False)):
        a, b = fm.AnalogFM(fm.FMConfig(**kw)), jfm.AnalogFM(jfm.FMConfig(**kw))
        np.testing.assert_array_equal(a.bin, b.bin)
        np.testing.assert_array_equal(a.bout, b.bout)
        tx = a.mod(audio)
        np.testing.assert_array_equal(tx, b.mod(audio))
        noisy = (tx + 0.05 * (rng.standard_normal(len(tx))
                              + 1j * rng.standard_normal(len(tx)))
                 ).astype(np.complex64)
        np.testing.assert_array_equal(a.demod(noisy), b.demod(noisy))
    assert fm.AnalogFM().snr_test(20.0, nsec=0.2) == \
        jfm.AnalogFM().snr_test(20.0, nsec=0.2)


def test_single_carrier_copy_equals_jax():
    """tx frames, then rx state machine frame by frame (search -> sync,
    timing, nin, phase, gain) on a clock-offset, frequency-shifted, noisy
    stream, and run_test's BER path: equal to radae_tpu's."""
    a, b = sc.SingleCarrier(fcentreHz=1500), jsc.SingleCarrier(fcentreHz=1500)
    rng = np.random.default_rng(1)
    frames = [np.sign(rng.standard_normal(80)).astype(np.complex64)
              for _ in range(12)]
    tx_a = np.concatenate([a.tx(s) for s in frames])
    tx_b = np.concatenate([b.tx(s) for s in frames])
    np.testing.assert_array_equal(tx_a, tx_b)
    rx = sc.sample_clock_offset(tx_a, 200) * np.exp(
        1j * 2 * np.pi * 0.7 * np.arange(len(tx_a)) / 9600)
    rx = (rx + 0.05 * (rng.standard_normal(len(rx))
                       + 1j * rng.standard_normal(len(rx)))
          ).astype(np.complex64)
    ra, rb = sc.SingleCarrier(fcentreHz=1500), jsc.SingleCarrier(fcentreHz=1500)
    n = 0
    while len(rx) - n >= ra.nin:
        assert ra.nin == rb.nin
        ya, yb = ra.rx(rx[n:n + ra.nin]), rb.rx(rx[n:n + rb.nin])
        np.testing.assert_array_equal(ya, yb)
        assert (ra.state, ra.g, ra.norm_rx_timing) == (rb.state, rb.g,
                                                       rb.norm_rx_timing)
        n += ra.nin
    assert ra.state == "sync"
    for kw in (dict(Nframes=10), dict(Nframes=20, sample_clock_offset_ppm=-100,
                                      EbNodB=4, freq_off=1, mag=100)):
        assert sc.SingleCarrier().run_test(**kw) == \
            jsc.SingleCarrier().run_test(**kw)


# -- the CLIs --------------------------------------------------------------

def _feats36(path):
    return np.fromfile(path, np.float32).reshape(-1, NB_TOTAL_FEATURES)


def test_bbfm_inference_and_rx(tmp_path, capsys):
    """As radae_tpu's test_bbfm_inference_and_rx: inference (quant noise on)
    then the standalone decoder on its latents; bbfm_rx (no noise) equals
    radae_tpu's bbfm_rx on the same latents at TOL."""
    from radae_tpu.tools.bbfm import bbfm_rx as jbbfm_rx
    fin, fhat, zf = (str(tmp_path / n) for n in ("f.f32", "fh.f32", "z.f32"))
    make_feature_file(fin, nframes=96)
    tools.bbfm_inference(["random", fin, fhat, "--CNRdB", "20",
                          "--write_latent", zf, "--write_CNRdB",
                          str(tmp_path / "cnr.f32")] + CPU)
    out = _feats36(fhat)
    assert out.shape[0] == 96 and np.isfinite(out).all()
    assert "loss:" in capsys.readouterr().out
    assert np.fromfile(zf, np.float32).size == 24 * 80
    np.testing.assert_allclose(np.fromfile(tmp_path / "cnr.f32", np.float32),
                               20.0, atol=1e-5)

    fhat2, fhat3 = str(tmp_path / "fh2.f32"), str(tmp_path / "fh3.f32")
    tools.bbfm_rx(["random", zf, fhat2] + CPU)
    jbbfm_rx(["random", zf, fhat3])
    out2 = _feats36(fhat2)
    np.testing.assert_allclose(out2, _feats36(fhat3), **TOL)
    # the inference decoder ran with quantization dither, the rx decoder
    # without (radae_tpu's test allows the same)
    np.testing.assert_allclose(out2[:, :20], out[:, :20], atol=0.03)
    tools.bbfm_inference(["random", fin, fhat, "--passthru"] + CPU)
    np.testing.assert_array_equal(_feats36(fhat), _feats36(fin))


def test_train_bbfm_one_epoch(tmp_path, capsys):
    fin = str(tmp_path / "f.f32")
    make_feature_file(fin, nframes=48 * 8)
    out = str(tmp_path / "runb")
    tools.train_bbfm([fin, out, "--epochs", "1", "--batch-size", "4",
                      "--sequence-length", "48", "--CNRdB", "10"] + CPU)
    ckpt = os.path.join(out, "checkpoints", "checkpoint_epoch_1.npz")
    params, meta = load_checkpoint(ckpt)
    assert meta["epoch"] == 1 and meta["latent_dim"] == 80
    assert np.isfinite(meta["loss"]) and "epoch 1: loss" in \
        capsys.readouterr().err
    # the checkpoint loads in radae_tpu's BBFM too
    from radae_tpu.convert import load_checkpoint as jload
    jparams, _ = jload(ckpt)
    np.testing.assert_array_equal(params["decoder"]["output"]["w"],
                                  jparams["decoder"]["output"]["w"])


def _pipe(monkeypatch, fn, argv, data: bytes) -> bytes:
    out = io.BytesIO()
    monkeypatch.setattr(sys, "stdin", type("S", (), {"buffer": io.BytesIO(data)})())
    monkeypatch.setattr(sys, "stdout", type("S", (), {"buffer": out})())
    fn(argv)
    return out.getvalue()


def test_sc_tx_rx_pipe(monkeypatch, capsys):
    """z frames through the single-carrier modem pipe in BER test mode
    (radae_tpu's test_sc_tx_rx_pipe); the samples equal radae_tpu's
    sc_tx's, and a payload pipe gives radae_tpu's sc_rx bytes."""
    from radae_tpu.tools.sc_modem import sc_rx as jsc_rx, sc_tx as jsc_tx
    z = np.zeros(80 * 20, np.float32).tobytes()
    tx = _pipe(monkeypatch, sc_modem.sc_tx, ["--ber_test"], z)
    assert tx == _pipe(monkeypatch, jsc_tx, ["--ber_test"], z)
    _pipe(monkeypatch, sc_modem.sc_rx, ["--ber_test", "--target_ber", "0.0",
                                        "-v", "0"], tx)
    assert "PASS" in capsys.readouterr().err

    payload = np.tanh(np.random.default_rng(2).standard_normal(80 * 12)
                      ).astype(np.float32).tobytes()
    tx = _pipe(monkeypatch, sc_modem.sc_tx, ["--complex"], payload)
    assert tx == _pipe(monkeypatch, jsc_tx, ["--complex"], payload)
    got = _pipe(monkeypatch, sc_modem.sc_rx, ["--complex", "-v", "0"], tx)
    assert got and got == _pipe(monkeypatch, jsc_rx, ["--complex", "-v", "0"],
                                tx)


def test_bbfm_through_sc_modem(fixture):
    """radae_tpu's test_bbfm_through_sc_modem on the port (the fixture, a
    clean channel): z (the encoder kernel's plain version, bottleneck 1)
    through the single-carrier modem, decoded by the decoder's: correlation
    above 0.98 and the loss within 0.02 of the direct decode's."""
    params, feats = fixture
    model = BBFM(BBFMConfig(feature_dim=20, latent_dim=80), "cpu")
    T = 480
    f = feats[None, :T].copy()
    with torch.no_grad():
        z = model._encode(params, torch.as_tensor(f), None)[0].numpy()
        fh_direct = model.receiver(params, z[None])
    loss_direct = float(distortion_loss(torch.as_tensor(f), fh_direct)[0])
    z_rx, best, off = modem_loopback(z)
    with torch.no_grad():
        fh = model.receiver(params, z_rx[None])
    ref = torch.as_tensor(f[:, off * 4:off * 4 + fh.shape[1]])
    loss_modem = float(distortion_loss(ref, fh)[0])
    assert best > 0.98, best
    assert abs(loss_modem - loss_direct) < 0.02, (loss_direct, loss_modem)
