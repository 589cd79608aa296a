"""The port's host-side copies (dsp/bpf, dsp/acquisition, dsp/rrc,
channel/doppler), its set_eoo_bits and its quantization noise against
radae_tpu on the CPU.  The copies must give the same outputs exactly;
set_eoo_bits at atol 1e-6; the noise is held to its distribution, since
torch cannot reproduce jax's stream."""

import numpy as np
import pytest
import torch

from radae_tpu.channel import doppler as jdoppler
from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.dsp import acquisition as jacq
from radae_tpu.dsp import bpf as jbpf
from radae_tpu.dsp import rrc as jrrc
from radae_tpu.ops import ofdm as jofdm
from radae_tpu_torch.channel import doppler
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.dsp import acquisition, bpf, rrc
from radae_tpu_torch.dsp.streaming import TransmitterOne
from radae_tpu_torch.models import layers
from radae_tpu_torch.ops import ofdm

N_FRAMES = 8


def _noise(rng, n, sigma):
    return (sigma * (rng.standard_normal(n) + 1j * rng.standard_normal(n))
            / np.sqrt(2)).astype(np.complex64)


@pytest.fixture(scope="module")
def stream():
    """N_FRAMES modem frames of random latents from the port's transmitter,
    after 500 samples of silence."""
    cfg = flagship_config()
    tx = TransmitterOne(cfg, "cpu")
    rng = np.random.default_rng(11)
    z = np.tanh(rng.standard_normal((N_FRAMES, 1, cfg.Nzmf, cfg.latent_dim)))
    frames = [tx.transmit(z[k]) for k in range(N_FRAMES)]
    return cfg, np.concatenate([np.zeros(500, np.complex64)] + frames)


def _channel(name, x, Fs):
    rng = np.random.default_rng(5)
    if name == "clean":
        return x
    if name == "foff_noise":
        n = np.arange(len(x))
        y = x * np.exp(2j * np.pi * 12.5 * n / Fs)
        return (y + _noise(rng, len(x), 0.5)).astype(np.complex64)
    y = doppler.fade_two_path(x, "mpp", Fs, rng=rng)
    return (y + _noise(rng, len(x), 0.3)).astype(np.complex64)


@pytest.mark.parametrize("channel", ["clean", "foff_noise", "faded"])
def test_acquisition_matches_jax(stream, channel):
    cfg, x = stream
    x = _channel(channel, x, cfg.Fs)
    args = (cfg.Fs, cfg.Rs, cfg.M, cfg.Ncp, cfg.Nmf, cfg.p, cfg.pend)
    ours, ref = acquisition.Acquisition(*args), jacq.Acquisition(*args)
    n_buf = 2 * cfg.Nmf + cfg.M + cfg.Ncp
    n_cand = 0
    for k in range(N_FRAMES - 2):
        buf = np.ascontiguousarray(x[k * cfg.Nmf:k * cfg.Nmf + n_buf])
        got, want = ours.detect_pilots(buf), ref.detect_pilots(buf)
        assert got == want
        for a in ("Dthresh", "Dtmax12", "Dtmax12_eoo"):
            assert getattr(ours, a) == getattr(ref, a), a
        np.testing.assert_array_equal(ours.Dt1, ref.Dt1)
        cand, tmax, fmax = want
        n_cand += int(cand)
        tmax = int(np.clip(tmax, cfg.M + 8, cfg.Nmf - 8))
        tfine = np.arange(max(0, tmax - 8), tmax + 8)
        ffine = np.arange(fmax - 1, fmax + 1, 0.1)
        assert ours.refine(buf, tmax, fmax, tfine, ffine) == ref.refine(
            buf, tmax, fmax, tfine, ffine)
        assert ours.check_pilots(buf, tmax, fmax) == ref.check_pilots(
            buf, tmax, fmax)
        assert ours.est_cp_corr(buf, tmax, fmax) == ref.est_cp_corr(
            buf, tmax, fmax)
        assert ours.est_cp_foff(buf, tmax, fmax) == ref.est_cp_foff(
            buf, tmax, fmax)
    if channel == "clean":
        assert n_cand >= 1


def test_bpf_matches_jax():
    cfg = flagship_config()
    w = cfg.w
    bw = 1.2 * (w[-1] - w[0]) * cfg.Fs / (2 * np.pi)
    centre = (w[-1] + w[0]) * cfg.Fs / (2 * np.pi) / 2
    ours = bpf.ComplexBPF(101, cfg.Fs, bw, centre, cfg.Fs)
    ref = jbpf.ComplexBPF(101, cfg.Fs, bw, centre, cfg.Fs)
    x = _noise(np.random.default_rng(2), 4 * cfg.Nmf, 1.0)
    for n in (cfg.Nmf, cfg.Nmf - cfg.M, cfg.Nmf + cfg.M, cfg.Nmf):
        chunk, x = x[:n], x[n:]
        np.testing.assert_array_equal(ours.bpf(chunk), ref.bpf(chunk))
    assert bpf.bpf_self_test() and jbpf.bpf_self_test()


def test_rrc_matches_jax(stream):
    _, x = stream
    np.testing.assert_array_equal(rrc.gen_rn_coeffs(0.25, 1 / 8000, 2000, 6, 4),
                                  jrrc.gen_rn_coeffs(0.25, 1 / 8000, 2000, 6, 4))
    for ppm in (200, -200, 5000):
        np.testing.assert_array_equal(rrc.sample_clock_offset(x, ppm),
                                      jrrc.sample_clock_offset(x, ppm))


def test_doppler_matches_jax(stream, tmp_path):
    cfg, x = stream
    np.testing.assert_array_equal(
        doppler.doppler_spread(1.0, 8000, 12000, np.random.default_rng(3)),
        jdoppler.doppler_spread(1.0, 8000, 12000, np.random.default_rng(3)))
    names = {}
    for pkg, tag in ((doppler, "ours"), (jdoppler, "ref")):
        H_fn, G_fn = str(tmp_path / f"{tag}.h"), str(tmp_path / f"{tag}.g")
        names[tag] = (pkg.multipath_samples(
            "mpd", cfg.Fs, cfg.Rs_dash, cfg.Nc, 1.5, H_fn, G_fn,
            rng=np.random.default_rng(4)), H_fn, G_fn)
    (H, G, gain), H_fn, G_fn = names["ours"]
    (Hr, Gr, gainr), Hr_fn, Gr_fn = names["ref"]
    np.testing.assert_array_equal(H, Hr)
    np.testing.assert_array_equal(G, Gr)
    assert gain == gainr
    np.testing.assert_array_equal(doppler.load_g_file(G_fn),
                                  jdoppler.load_g_file(Gr_fn))
    np.testing.assert_array_equal(doppler.load_h_file(H_fn, cfg.Nc),
                                  jdoppler.load_h_file(Hr_fn, cfg.Nc))
    for ch in ("mpg", "mpp", "lmr60"):
        np.testing.assert_array_equal(
            doppler.fade_two_path(x, ch, rng=np.random.default_rng(6)),
            jdoppler.fade_two_path(x, ch, rng=np.random.default_rng(6)))


def test_set_eoo_bits_matches_jax():
    cfg, jcfg = flagship_config(), jax_flagship_config()
    bits = np.sign(np.random.default_rng(65647).random(cfg.Nseoo * cfg.bps)
                   - 0.5).astype(np.float32)
    got, want = ofdm.set_eoo_bits(cfg, bits), jofdm.set_eoo_bits(jcfg, bits)
    assert got.dtype == np.complex64 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_quant_noise_range_and_clamp():
    gen = torch.Generator().manual_seed(0)
    x = torch.linspace(-0.98, 0.98, 20001)
    d = layers.quant_noise(gen, x) - x
    assert float(d.abs().max()) <= 0.5 / 127 + 1e-7
    edge = torch.tensor([-1.0, -0.999, 0.999, 1.0] * 2000)
    y = layers.quant_noise(gen, edge)
    assert float(y.min()) >= -1.0 and float(y.max()) <= 1.0
    assert bool((y == 1.0).any()) and bool((y == -1.0).any())


def test_quant_noise_moments():
    n = 400_000
    d = layers.quant_noise(torch.Generator().manual_seed(1),
                           torch.zeros(n, dtype=torch.float64))
    sigma = 1 / (127 * np.sqrt(12))
    assert abs(float(d.mean())) < 5 * sigma / np.sqrt(n)
    assert abs(float(d.std()) / sigma - 1) < 0.01


def test_quant_noise_one_seed_same_draws():
    x = torch.zeros(3, 5, 64)
    a = layers.quant_noise(torch.Generator().manual_seed(7), x)
    b = layers.quant_noise(torch.Generator().manual_seed(7), x)
    c = layers.quant_noise(torch.Generator().manual_seed(8), x)
    assert torch.equal(a, b) and not torch.equal(a, c)
