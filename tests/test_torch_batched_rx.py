"""The port's whole-over batched receiver and its acquisition op
(radae_tpu_torch/runtime.py `make_batched_receiver`,
radae_tpu_torch/ops/acquisition_op.py) against radae_tpu's on the CPU, on
fixture transmissions with numpy-made offsets, fades and noise (no jax
keys).  radae_tpu's fused int8 decoder runs its Pallas kernel in interpret
mode, as tests/test_batched_rx.py runs it.

Tolerances: the acquisition decisions (candidate, tmax, win, eoo_frame)
must be equal; fmax to 1e-4 Hz (the coarse and fine grids are the same
f32 values, the CP correction goes through an arctan; measured equal); the
SNR estimate to 1e-3 dB (measured 2.1e-4), the EOO soft bits and the
features to rtol 1e-4, atol 2e-4 (measured 7.9e-05 and 1.25e-04 with the CP
correction, 4.8e-06 without): the derotation's sin/cos of angles up to
hundreds of radians and the products run in another sum order than XLA's,
and the decoder's GRUs carry the differences over the frames."""

import os

import numpy as np
import pytest
import torch

from radae_tpu.ops import fused_core as jfc
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.ops import fused_core as fc

FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "fixtures")
B = 4
N_DATA = 4          # data frames of each over
K = 12              # acquisition windows of the product receiver
PADS = [0, 257, 600, 911]
FOFFS = [0.0, -31.0, 12.5, 40.0]


@pytest.fixture(scope="module")
def flagship():
    tree, _ = load_checkpoint(os.path.join(FIX, "model_fs_flagship.npz"))
    feats = np.fromfile(os.path.join(FIX, "speech_feats.f32"),
                        np.float32).reshape(-1, 36)
    return tree, feats


def _over(tree, feats, n_frames, eoo):
    """n_frames of the fixture's features through the port's plain tx step
    (one stream), followed by the end-of-over frame."""
    from radae_tpu_torch.models.core import CoreEncoder
    from radae_tpu_torch.runtime import make_streaming_tx_step
    cfg = flagship_config()
    tx = make_streaming_tx_step(cfg, CoreEncoder(21, 80, 3), 1, device="cpu")
    p = params_to_torch(tree["encoder"], "cpu")
    f = np.zeros((1, 12 * n_frames, 21), np.float32)
    f[0, :, :20] = feats[:12 * n_frames, :20]
    f[0, :, 20] = -1.0
    out, st = [], None
    for k in range(n_frames):
        s, st = tx(p, torch.as_tensor(f[:, 12 * k:12 * (k + 1)]), st)
        out.append(s[0].numpy())
    iq = np.concatenate(out)
    over = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
    if eoo:
        over = np.concatenate([over, cfg.eoo.flatten().astype(np.complex64)])
    return cfg, over


def _fade(x, rng, fd=1.0, Fs=8000):
    """A slow two-ray fade from numpy draws (Doppler fd Hz, 2 ms delay)."""
    n = np.arange(len(x)) / Fs
    g = [np.exp(1j * (2 * np.pi * fd * rng.uniform(0.5, 1.5) * n
                      + rng.uniform(0, 2 * np.pi))) * a for a in (1.0, 0.5)]
    y = x * g[0]
    y[16:] += x[:-16] * g[1][16:]
    return (y * np.sqrt((np.abs(x) ** 2).mean()
                        / (np.abs(y) ** 2).mean())).astype(np.complex64)


def _streams(cfg, over, T, rng, snr_db=10.0, fade=False):
    streams = np.zeros((B, T), np.complex64)
    S = (np.abs(over) ** 2).mean()
    sigma2 = S / 10 ** (snr_db / 10) * cfg.Fs / 3000
    for b in range(B):
        n = np.arange(len(over))
        s = over * np.exp(1j * 2 * np.pi * FOFFS[b] * n / cfg.Fs)
        if fade:
            s = _fade(s, rng)
        streams[b, PADS[b]:PADS[b] + len(over)] = s
    streams += np.sqrt(sigma2 / 2) * (rng.standard_normal(streams.shape)
                                      + 1j * rng.standard_normal(streams.shape))
    return np.stack([streams.real, streams.imag], -1).astype(np.float32)


@pytest.fixture(scope="module")
def signals(flagship):
    """Two B=4 buffers: a faded over with its EOO sized for 12 windows,
    and a short one for the one-shot detector."""
    tree, feats = flagship
    cfg, over = _over(tree, feats, N_DATA, eoo=True)
    rng = np.random.default_rng(7)
    T12 = max((K + 1) * cfg.Nmf + cfg.M + cfg.Ncp,
              max(PADS) + K * cfg.Nmf + (N_DATA + 1) * cfg.Nmf + cfg.Ncp
              + cfg.M)
    long_ = _streams(cfg, over, T12, rng, fade=True)
    short = _streams(cfg, over, max(PADS) + len(over) + cfg.Nmf, rng)
    return cfg, long_, short


def test_detectors_and_refine_match_jax(signals):
    from radae_tpu.config import flagship_config as jcfg
    from radae_tpu.ops import acquisition_op as jacq
    from radae_tpu_torch.ops import acquisition_op as acq
    cfg, long_, short = signals
    jc = jcfg()
    n1 = 2 * cfg.Nmf + cfg.M + cfg.Ncp
    ours = acq.make_detect_pilots(cfg, device="cpu")(torch.as_tensor(short[:, :n1]))
    ref = jacq.make_detect_pilots(jc, B)(short[:, :n1])
    for o, r in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_allclose(ours[3].numpy(), np.asarray(ref[3]), rtol=1e-4)
    assert np.asarray(ref[0]).all()

    ours = acq.make_detect_pilots_windowed(cfg, K, device="cpu")(
        torch.as_tensor(long_))
    ref = jacq.make_detect_pilots_windowed(jc, B, K)(long_)
    for o, r in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    np.testing.assert_allclose(ours[4].numpy(), np.asarray(ref[4]), rtol=1e-4)
    assert np.asarray(ref[0]).all()

    t, f = ours[1], ours[2]
    xr, xi = torch.as_tensor(long_[..., 0]), torch.as_tensor(long_[..., 1])
    t_o, f_o = acq.make_refine(cfg, device="cpu")(xr, xi, t, f)
    t_r, f_r = jacq.make_refine(jc, B)(long_[..., 0], long_[..., 1],
                                       t.numpy(), f.numpy())
    np.testing.assert_array_equal(t_o.numpy(), np.asarray(t_r))
    np.testing.assert_array_equal(f_o.numpy(), np.asarray(f_r))


def _jax_receiver(flagship, n_frames, fused_quant=None, **kw):
    """radae_tpu's receiver, its int8 decoder in interpret mode."""
    from radae_tpu.config import flagship_config as jcfg
    from radae_tpu.models.core import CoreDecoder as JDec
    from radae_tpu.runtime import make_batched_receiver as jmbr
    tree, _ = flagship
    orig = jfc.make_fused_decoder_step
    jfc.make_fused_decoder_step = (
        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    try:
        rx = jmbr(jcfg(), JDec(80, 21), B, n_frames, fused=True,
                  fused_tile=B, fused_quant=fused_quant, **kw)
        w = tuple(jfc.decoder_weights(tree["decoder"], quant=fused_quant))
        return rx, w, orig
    except BaseException:
        jfc.make_fused_decoder_step = orig
        raise


@pytest.mark.parametrize("form", ["dict", "legacy"])
def test_batched_receiver_int8_matches_jax(flagship, signals, form):
    """dict: 12 windows, refine, EOO, CP correction; legacy: the one-shot
    detector and the 4-tuple.  Both through the fused int8 decoder."""
    from radae_tpu_torch.models.core import CoreDecoder
    from radae_tpu_torch.runtime import make_batched_receiver
    tree, _ = flagship
    cfg, long_, short = signals
    kw = (dict(n_windows=K, refine=True, eoo=True) if form == "dict" else {})
    sig = long_ if form == "dict" else short
    rx_j, w_j, orig = _jax_receiver(flagship, N_DATA, "int8", **kw)
    try:
        ref = rx_j(w_j, sig)
    finally:
        jfc.make_fused_decoder_step = orig
    rx = make_batched_receiver(cfg, CoreDecoder(80, 21), B, N_DATA,
                               fused=True, fused_quant="int8", device="cpu",
                               **kw)
    fc.reset_launches()
    with torch.no_grad():
        out = rx(fc.decoder_weights(tree["decoder"], "cpu", quant="int8"), sig)
    if form == "legacy":
        assert isinstance(out, tuple) and len(out) == 4
        keys = ("features", "candidate", "tmax", "fmax")
        out, ref = dict(zip(keys, out)), dict(zip(keys, ref))
    else:
        for k in ("win", "eoo_frame", "eoo_detected"):
            np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
        np.testing.assert_allclose(out["snrdB_3k"].numpy(),
                                   np.asarray(ref["snrdB_3k"]), atol=1e-3)
        np.testing.assert_allclose(out["eoo_bits"].numpy(),
                                   np.asarray(ref["eoo_bits"]), rtol=1e-4,
                                   atol=2e-4)
        assert np.asarray(ref["eoo_detected"]).all()
    for k in ("candidate", "tmax"):
        np.testing.assert_array_equal(out[k].numpy(), np.asarray(ref[k]))
    assert np.asarray(ref["candidate"]).all()
    np.testing.assert_allclose(out["fmax"].numpy(), np.asarray(ref["fmax"]),
                               atol=1e-4)
    assert out["features"].shape == (B, N_DATA, 12, 21)
    np.testing.assert_allclose(out["features"].numpy(),
                               np.asarray(ref["features"]), rtol=1e-4,
                               atol=2e-4)
    assert not any(fc.LAUNCHES.values())     # the CPU runs the plain version


def test_batched_receiver_refuses_what_it_cannot_run(flagship):
    from radae_tpu_torch.models.core import CoreDecoder
    from radae_tpu_torch.runtime import make_batched_receiver
    tree, _ = flagship
    cfg = flagship_config()
    dec = CoreDecoder(80, 21)
    # bf16 products and the padded layout run (tests/test_torch_bf16_pad.py);
    # still refused: fused_dtype without fused=True, and a type other than
    # f32 or bf16
    with pytest.raises(ValueError, match="need fused=True"):
        make_batched_receiver(cfg, dec, B, 2, fused_dtype=torch.bfloat16,
                              device="cpu")
    with pytest.raises(ValueError, match="fused_dtype must be"):
        make_batched_receiver(cfg, dec, B, 2, fused=True,
                              fused_dtype=torch.float16, device="cpu")
    rx = make_batched_receiver(cfg, dec, B, 2, fused=True, fused_quant="int8",
                               device="cpu")
    sig = np.zeros((B + 1, 4 * cfg.Nmf, 2), np.float32)
    with pytest.raises(ValueError, match="built for batch=4"):
        rx(fc.decoder_weights(tree["decoder"], "cpu", quant="int8"), sig)
    with pytest.raises(ValueError, match="fused_quant='int8' got weights of "
                                         "quant=None"):
        rx(fc.decoder_weights(tree["decoder"], "cpu"), sig[:B])


@pytest.mark.parametrize("flags", [["--n-windows", "2"],
                                   ["--n-windows", "1", "--no-refine",
                                    "--no-eoo"]], ids=["windows2", "legacy"])
def test_rx_batch_cli_matches_jax(flagship, tmp_path, capsys, flags):
    """The port's rx_batch prints radae_tpu's status lines and writes its
    feature files (tolerance as above), on two offset, noisy overs."""
    from radae_tpu.tools import rx_batch as jrx
    from radae_tpu_torch.tools import rx_batch
    tree, feats = flagship
    cfg, over = _over(tree, feats, N_DATA, eoo=True)
    rng = np.random.default_rng(2)
    files = []
    for k, (pad, foff) in enumerate([(0, 0.0), (500, -15.0)]):
        n = np.arange(len(over))
        s = np.zeros(pad + len(over) + cfg.Nmf, np.complex64)
        s[pad:pad + len(over)] = over * np.exp(2j * np.pi * foff * n / cfg.Fs)
        s += 0.02 * (rng.standard_normal(len(s))
                     + 1j * rng.standard_normal(len(s)))
        fn = tmp_path / f"s{k}.f32"
        s.astype(np.complex64).tofile(fn)
        files.append(str(fn))
    ckpt = os.path.join(FIX, "model_fs_flagship.npz")
    assert jrx.main([ckpt, str(tmp_path / "jax")] + files + flags) == 0
    ref_lines = capsys.readouterr().out
    assert rx_batch.main([ckpt, str(tmp_path / "port")] + files + flags
                         + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out
    assert lines == ref_lines and lines.count("acquired 1") == 2, lines
    for k in range(2):
        a = np.fromfile(tmp_path / "port" / f"s{k}_feat.f32", np.float32)
        b = np.fromfile(tmp_path / "jax" / f"s{k}_feat.f32", np.float32)
        assert len(a) == len(b) > 0
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=2e-4)
