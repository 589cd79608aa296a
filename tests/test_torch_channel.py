"""The port's simulated channel (channel/simulate.py), its pilot EQ variants
(ops/pilots.py), strip_pilots and the split-complex additions against
radae_tpu on the CPU, and the channel's draws and calibration by statistics.

Deterministic parts agree with radae_tpu at rtol 1e-4, atol 1e-5 on the
same numpy-made inputs, the sigma formulas to f32 (one rounding); the
channel's Gaussian draws are replaced by the same numpy arrays in both
packages where a test compares values, since torch cannot reproduce jax's
stream.  The draws themselves, the measured Eb/No, the BER against theory
and the trained checkpoints' loss bands are held as radae_tpu's own tests
hold them (tests/test_channel.py, test_forward.py, test_trained.py)."""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import threadpoolctl
import torch

from radae_tpu.channel import simulate as jsim
from radae_tpu.config import RADAEConfig as JRADAEConfig
from radae_tpu.ops import cplx as jcplx
from radae_tpu.ops import ofdm as jofdm
from radae_tpu.ops import pilots as jpilots
from radae_tpu_torch.channel import doppler, simulate
from radae_tpu_torch.config import RADAEConfig, flagship_config
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.models.core import distortion_loss
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.ops import cplx, ofdm, pilots
from radae_tpu_torch.ops.cplx import C

TOL = dict(rtol=1e-4, atol=1e-5)
FIX = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "fixtures")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The products here are small (B <= 4): one thread, in torch and in
    numpy's BLAS (the weights' QR), runs them faster than pools that the
    test workers share, whose spinning threads slowed these files fourfold
    beside two others."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with threadpoolctl.threadpool_limits(1):
        yield
    torch.set_num_threads(n)


def _cn(rng, shape, scale=1.0):
    return (scale * (rng.standard_normal(shape)
                     + 1j * rng.standard_normal(shape))).astype(np.complex64)


def _jc(x):
    return jcplx.of(np.asarray(x, np.complex64))


def _tc(x):
    x = np.asarray(x, np.complex64)
    return C(torch.as_tensor(x.real.copy()), torch.as_tensor(x.imag.copy()))


def _close(got: C, want, tol=TOL):
    np.testing.assert_allclose(got.re.numpy(), np.asarray(want.re), **tol)
    np.testing.assert_allclose(got.im.numpy(), np.asarray(want.im), **tol)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# -- split-complex additions, strip_pilots ---------------------------------

def test_cplx_division_abs_expj():
    rng = np.random.default_rng(0)
    a, b = _cn(rng, (3, 7)), _cn(rng, (3, 7))
    _close(_tc(a) / _tc(b), _jc(a) / _jc(b))
    _close(_tc(a) / 2.5, _jc(a) / 2.5)
    np.testing.assert_allclose(_tc(a).abs().numpy(),
                               np.asarray(_jc(a).abs()), **TOL)
    th = rng.uniform(-4, 4, (5,)).astype(np.float32)
    _close(cplx.expj(torch.as_tensor(th)), jcplx.expj(jnp.asarray(th)))
    z = cplx.zeros((2, 3), "cpu")
    assert z.re.shape == (2, 3) and not z.re.any() and not z.im.any()


def test_strip_pilots():
    rng = np.random.default_rng(1)
    x = _cn(rng, (2, 3 * 5, 30))
    _close(ofdm.strip_pilots(_tc(x), 4), jofdm.strip_pilots(_jc(x), 4),
           dict(rtol=0, atol=0))


# -- pilot EQ ---------------------------------------------------------------

def _frames(cfg, nmf, seed=2, B=2):
    """(B, nmf, Ns+1, Nc) symbols: pilot rows P * h + noise and random
    data, h a per-frame channel with a phase and magnitude."""
    rng = np.random.default_rng(seed)
    h = (rng.uniform(0.5, 1.5, (B, nmf, 1, cfg.Nc))
         * np.exp(1j * rng.uniform(-np.pi, np.pi, (B, nmf, 1, 1))))
    x = _cn(rng, (B, nmf, cfg.Ns + 1, cfg.Nc), 0.7)
    x[:, :, 0, :] = cfg.P * cfg.pilot_gain
    return (h * x + _cn(rng, x.shape, 0.05)).astype(np.complex64)


EQ_CASES = {
    "ls": dict(eq_mean6=False),
    "mean3": dict(eq_mean6=True),
    "carrier_mean": dict(per_carrier_eq=False),
    "ls_coarse_mag_b3": dict(eq_mean6=False, coarse_mag=True, bottleneck=3),
    "mean3_coarse_mag_b1": dict(eq_mean6=True, coarse_mag=True, bottleneck=1),
    "phase_mag_eq": dict(eq_mean6=False, phase_mag_eq=True),
    "latent40_ls_coarse_mag": dict(latent_dim=40, eq_mean6=False,
                                   coarse_mag=True, bottleneck=3),
}


@pytest.mark.parametrize("nmf", [1, 4])
@pytest.mark.parametrize("case", sorted(EQ_CASES))
def test_pilot_eq_matches_jax(case, nmf):
    kw = dict(latent_dim=80, rate_Fs=True, pilots=True, pilot_eq=True,
              cyclic_prefix=0.004)
    kw.update(EQ_CASES[case])
    cfg, jcfg = RADAEConfig(**kw), JRADAEConfig(**kw)
    x = _frames(cfg, nmf)
    k = pilots.ls_consts(cfg.P, cfg.w, cfg.Fs, "cpu")
    got = pilots.pilot_eq(cfg, _tc(x), k)
    want = jpilots.pilot_eq(jcfg, _jc(x))
    _close(got, want)


def test_eq_parts_match_jax():
    """The estimator, the interpolation (phase and phase+magnitude) and the
    coarse magnitude correction one at a time."""
    cfg = flagship_config()
    x = _frames(cfg, 3, seed=4)
    k = pilots.ls_consts(cfg.P, cfg.w, cfg.Fs, "cpu")
    idx = jpilots.window3_index(cfg.Nc)
    rows = x[:, :, 0, :]
    m3 = pilots.est_pilots_mean3(_tc(rows), k)
    _close(m3, jpilots.est_pilots_mean3(_jc(rows), cfg.P, idx))
    est = _cn(np.random.default_rng(5), rows.shape)
    for pm in (False, True):
        _close(pilots.interp_pilot_eq(_tc(x), _tc(est), cfg.Ns, pm),
               jpilots.interp_pilot_eq(_jc(x), _jc(est), cfg.Ns, pm))
    for bn in (1, 3):
        got, mag = pilots.coarse_mag_correction(_tc(x), _tc(est), 1.3, 0.8, bn)
        want, jmag = jpilots.coarse_mag_correction(_jc(x), _jc(est), 1.3, 0.8,
                                                   bn)
        _close(got, want)
        np.testing.assert_allclose(mag.numpy(), np.asarray(jmag), **TOL)


# -- the channel's deterministic parts --------------------------------------

def test_multipath_two_path_matches_jax():
    rng = np.random.default_rng(6)
    n = 4000
    tx = _cn(rng, (2, n))
    G = _cn(rng, (2, n, 2), 0.6)
    got = simulate.multipath_two_path(_tc(tx), _tc(G), 16)
    _close(got, jsim.multipath_two_path(_jc(tx), _jc(G), 16))
    # power normalised (tests/test_channel.py)
    assert abs(float(got.abs2().mean()) / float(np.mean(np.abs(tx) ** 2))
               - 1.0) < 0.05


@pytest.mark.parametrize("bottleneck", [1, 2, 3])
def test_sigma_formulas_match_jax(bottleneck):
    cfg = RADAEConfig(latent_dim=80, bottleneck=bottleneck)
    jcfg = JRADAEConfig(latent_dim=80, bottleneck=bottleneck)
    EbNodB = np.linspace(-6.0, 20.0, 27, dtype=np.float32).reshape(-1, 1, 1)
    EbNo = (10.0 ** (EbNodB / 10.0)).astype(np.float32)
    one_ulp = dict(rtol=2.0 ** -23, atol=0)
    np.testing.assert_allclose(
        simulate._sigma_rate_fs(cfg, torch.as_tensor(EbNo)).numpy(),
        np.asarray(jsim._sigma_rate_fs(jcfg, jnp.asarray(EbNo))), **one_ulp)
    np.testing.assert_allclose(
        simulate._sigma_rate_rs(cfg, torch.as_tensor(EbNodB)).numpy(),
        np.asarray(jsim._sigma_rate_rs(jcfg, jnp.asarray(EbNodB))),
        rtol=2.0 ** -22, atol=0)
    if bottleneck == 3:
        # the closed forms (tests/test_channel.py)
        s = simulate._sigma_rate_fs(cfg, torch.ones(1, 1))
        assert abs(float(s) - math.sqrt(cfg.Fs / cfg.Rb)) < 1e-5
    else:
        s = simulate._sigma_rate_fs(cfg, torch.full((1, 1), 10 ** 0.3))
        assert abs(float(s) - (10 ** 0.3 * cfg.M) ** -0.5) < 1e-6


@pytest.fixture
def same_noise(monkeypatch):
    """complex_normal in both packages returns the same numpy-made draw for
    a shape (made once per shape)."""
    rng = np.random.default_rng(7)
    draws = {}

    def draw(shape):
        shape = tuple(int(s) for s in shape)
        if shape not in draws:
            draws[shape] = (rng.standard_normal(shape + (2,)) / np.sqrt(2)
                            ).astype(np.float32)
        return draws[shape]

    monkeypatch.setattr(jsim, "complex_normal", lambda key, shape: jcplx.C(
        jnp.asarray(draw(shape)[..., 0]), jnp.asarray(draw(shape)[..., 1])))
    monkeypatch.setattr(simulate, "complex_normal", lambda gen, shape: C(
        torch.as_tensor(draw(shape)[..., 0]),
        torch.as_tensor(draw(shape)[..., 1])))


OFFSETS = {
    "awgn_b3": dict(bottleneck=3),
    "phase": dict(phase_offset=0.7, bottleneck=1),
    "freq_dfdt": dict(freq_offset=2.0, df_dt=0.5, bottleneck=3),
    "freq_corrected_gain": dict(freq_offset=-7.3, correct_freq_offset=True,
                                gain=0.6, bottleneck=2),
}


@pytest.mark.parametrize("case", sorted(OFFSETS))
def test_rate_fs_channel_matches_jax(case, same_noise):
    """Multipath, the phase/frequency/df_dt offsets, gain, the frequency
    correction, sigma and final_phase, with the same noise draw."""
    kw = dict(latent_dim=80, rate_Fs=True, EbNodB=5.0)
    kw.update(OFFSETS[case])
    cfg, jcfg = RADAEConfig(**kw), JRADAEConfig(**kw)
    rng = np.random.default_rng(8)
    n = 9000
    tx = _cn(rng, (2, n), 0.5)
    G = _cn(rng, (2, n, 2), 0.6)
    EbNodB = np.array([5.0, 9.0], np.float32).reshape(2, 1, 1)
    rx, sigma, fp = simulate.rate_fs_channel(cfg, _gen(), _tc(tx), _tc(G),
                                             torch.as_tensor(EbNodB))
    jrx, jsigma, jfp = jsim.rate_fs_channel(jcfg, jax.random.PRNGKey(0),
                                            _jc(tx), _jc(G),
                                            jnp.asarray(EbNodB))
    _close(rx, jrx)
    np.testing.assert_allclose(sigma.numpy(), np.asarray(jsigma), rtol=1e-6)
    _close(fp, jfp)


def test_rate_rs_channel_matches_jax(same_noise):
    for bn in (1, 3):
        kw = dict(latent_dim=80, phase_offset=0.4, bottleneck=bn)
        cfg, jcfg = RADAEConfig(**kw), JRADAEConfig(**kw)
        rng = np.random.default_rng(9)
        tx = _cn(rng, (2, 20, cfg.Nc))
        H = rng.uniform(0.2, 1.5, (2, 20, cfg.Nc)).astype(np.float32)
        EbNodB = np.array([2.0, 12.0], np.float32).reshape(2, 1, 1)
        got = simulate.rate_rs_channel(cfg, _gen(), _tc(tx),
                                       torch.as_tensor(H),
                                       torch.as_tensor(EbNodB))
        want = jsim.rate_rs_channel(jcfg, jax.random.PRNGKey(0), _jc(tx),
                                    jnp.asarray(H),
                                    jnp.asarray(EbNodB))
        _close(got[0], want[0])
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   rtol=1e-6)
        _close(got[2], want[2])


# -- the draws, by statistics -------------------------------------------------

def test_complex_normal_variance():
    x = simulate.complex_normal(_gen(), (100000,))
    assert abs(float(x.abs2().mean()) - 1.0) < 0.02
    assert abs(float(x.re.var()) - 0.5) < 0.01
    assert abs(float((x.re * x.im).mean())) < 0.01


def test_range_EbNo_draw():
    cfg = RADAEConfig(latent_dim=80, range_EbNo=True, range_EbNo_start=-6.0)
    e = simulate.draw_EbNodB(cfg, _gen(), 1000).numpy().flatten()
    assert e.min() >= -6.0 and e.max() <= 14.0
    assert e.std() > 4.0   # roughly uniform over 20 dB
    fixed = simulate.draw_EbNodB(RADAEConfig(latent_dim=80, EbNodB=3.5),
                                 _gen(), 4)
    assert fixed.shape == (4, 1, 1) and bool((fixed == 3.5).all())


def test_freq_rand_and_gain_rand():
    """Per-row random phase (uniform), frequency offset (+-20 Hz) and gain
    (+-20 dB, the SNR unchanged): read back from a noise-free unit carrier."""
    B, n = 400, 800
    cfg = RADAEConfig(latent_dim=80, rate_Fs=True, EbNodB=200.0,
                      freq_rand=True, gain_rand=True)
    tx = C(torch.ones(B, n), torch.zeros(B, n))
    G = C(torch.cat([torch.ones(B, n, 1), torch.zeros(B, n, 1)], -1),
          torch.zeros(B, n, 2))
    rx, sigma, _ = simulate.rate_fs_channel(cfg, _gen(3), tx, G,
                                            torch.full((B, 1, 1), 200.0))
    r = rx.re.double() + 1j * rx.im.double()
    gain_dB = 20 * torch.log10(r.abs().mean(dim=1))
    assert float(gain_dB.min()) >= -20.01 and float(gain_dB.max()) <= 20.01
    assert float(gain_dB.std()) > 9.0
    phase0 = torch.angle(r[:, 0])
    assert float(phase0.std()) > 1.5
    freq = (torch.angle(r[:, 1:] * r[:, :-1].conj()).mean(dim=1)
            * cfg.Fs / (2 * math.pi))
    assert float(freq.min()) >= -20.01 and float(freq.max()) <= 20.01
    assert float(freq.std()) > 9.0
    # the noise is scaled with the gain: sigma is the channel's, pre-gain
    assert sigma.shape == (B, 1)


# -- calibration and BER, through RADAE.forward -------------------------------

def ber_cfg(**kw):
    """radae_tpu's tests/test_forward.py ber_cfg: bottleneck 1, rate Fs,
    pilots + CP + LS pilot EQ, ber_test."""
    base = dict(feature_dim=20, latent_dim=80, rate_Fs=True, pilots=True,
                pilot_eq=True, eq_mean6=False, cyclic_prefix=0.004,
                bottleneck=1, ber_test=True)
    base.update(kw)
    return RADAEConfig(**base)


def _forward(cfg, B, T, seed, G=None, params=None):
    model = RADAE(cfg, "cpu")
    params = model.init(0) if params is None else params
    feats = (0.3 * np.random.default_rng(0).standard_normal(
        (B, T, cfg.feature_dim))).astype(np.float32)
    with torch.no_grad():
        return model.forward(params, feats, G=G, key=_gen(seed)), feats


def test_measured_EbNo_matches_target_rate_fs():
    cfg = ber_cfg(EbNodB=6.0)
    out, _ = _forward(cfg, 1, 240, 3)
    S = float(out["tx"].abs2().mean())
    N = float(out["sigma"].flatten()[0]) ** 2
    CNodB = 10 * np.log10(S * cfg.Fs / N)
    EbNodB = CNodB + 10 * np.log10(cfg.M / (cfg.Fs * cfg.Nc * cfg.bps))
    assert abs(EbNodB - 6.0) < 0.5


def test_ber_no_noise_is_zero():
    out, _ = _forward(ber_cfg(EbNodB=100.0), 1, 240, 4)
    assert int(out["n_errors"]) == 0
    assert float(out["ber_row"].sum()) == 0.0


def test_ber_awgn_vs_theory_rate_rs():
    cfg = RADAEConfig(feature_dim=20, latent_dim=80, EbNodB=0.0,
                      ber_test=True)
    out, _ = _forward(cfg, 2, 240, 5)
    ber = float(out["n_errors"]) / out["n_bits"]
    theory = 0.5 * math.erfc(math.sqrt(10 ** (0.0 / 10)))
    budget = 0.5 * math.erfc(math.sqrt(10 ** (-2.0 / 10)))
    assert theory * 0.5 < ber < budget, (ber, theory, budget)
    np.testing.assert_allclose(float(out["ber_row"].mean()), ber, rtol=1e-6)


def test_ber_awgn_vs_theory_rate_fs_pilots():
    out, _ = _forward(ber_cfg(EbNodB=0.0), 2, 240, 6)
    ber = float(out["n_errors"]) / out["n_bits"]
    budget = 0.5 * math.erfc(math.sqrt(10 ** (-2.0 / 10)))
    assert ber < budget, (ber, budget)


def test_ber_mpp_vs_rayleigh_theory():
    """Rate-Fs MPP fading at Eb/No = 0 dB against Rayleigh theory, 2 dB
    budget (tests/test_forward.py: reference test/inference_ber_mpp.sh)."""
    cfg = ber_cfg(EbNodB=0.0, freq_offset=1.0, correct_freq_offset=True)
    B, T = 4, 720
    n_fs = cfg.num_timesteps_at_rate_Fs(cfg.num_timesteps_at_rate_Rs(T))
    rng = np.random.default_rng(42)
    G = np.zeros((B, n_fs, 2), np.complex64)
    for b in range(B):
        _, Gs, hf_gain = doppler.multipath_samples(
            "mpp", cfg.Fs, cfg.Rs_dash, cfg.Nc, n_fs / cfg.Fs + 1, rng=rng)
        G[b] = hf_gain * Gs[:n_fs]
    out, _ = _forward(cfg, B, T, 9, G=G)
    ber = float(out["n_errors"]) / out["n_bits"]
    EbNo_budget = 10 ** (-2.0 / 10)
    target = 0.5 * (1 - math.sqrt(EbNo_budget / (EbNo_budget + 1)))
    theory = 0.5 * (1 - math.sqrt(1.0 / 2.0))
    assert 0.5 * theory < ber < target, (ber, theory, target)


# -- the trained checkpoints' bands (tests/test_trained.py) -------------------

def test_trained_loss_at_operating_point():
    params, _ = load_checkpoint(os.path.join(FIX, "model_rs_ep150.npz"))
    feats = np.fromfile(os.path.join(FIX, "speech_feats.f32"),
                        np.float32).reshape(-1, 36)[:, :20]
    cfg = RADAEConfig(feature_dim=20, latent_dim=80, EbNodB=10.0)
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(2400)
    f = torch.as_tensor(feats[None, :T])
    losses = {}
    for ebno in (10.0, 0.0):
        model = RADAE(RADAEConfig(feature_dim=20, latent_dim=80,
                                  EbNodB=ebno), "cpu")
        with torch.no_grad():
            out = model.forward(params, f, key=_gen(0))
        losses[ebno] = float(distortion_loss(f, out["features_hat"])[0])
    assert losses[10.0] < 0.25, losses
    assert losses[0.0] > losses[10.0] + 0.05, losses
    # after training |z| ~ 1 (radae.py:480-481)
    with torch.no_grad():
        z, _ = model.core_encoder(model._tensors(params)["encoder"], f)
    assert 0.5 < float(z.pow(2).mean().sqrt()) <= 1.0


def test_trained_latent40_operating_point():
    params, meta = load_checkpoint(os.path.join(FIX, "model_l40.npz"))
    cfg = RADAEConfig(feature_dim=21, latent_dim=40, EbNodB=13.0,
                      rate_Fs=True, pilots=True, pilot_eq=True,
                      eq_mean6=False, cyclic_prefix=0.004, coarse_mag=True,
                      time_offset=-16, bottleneck=3)
    feats = np.fromfile(os.path.join(FIX, "speech_feats.f32"),
                        np.float32).reshape(-1, 36)
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(2400)
    f = np.concatenate([feats[:T, :20], -np.ones((T, 1), np.float32)],
                       axis=1)[None]
    model = RADAE(cfg, "cpu")
    with torch.no_grad():
        out = model.forward(params, f, key=_gen(0))
    fh = out["features_hat"]
    loss = float(distortion_loss(torch.as_tensor(f[..., :20]),
                                 fh[..., :20])[0])
    assert loss < float(meta.get("loss", 0.5)) + 0.15, (loss, meta)
    assert float((torch.as_tensor(f[..., 20]) * fh[..., 20] < 0)
                 .float().mean()) < 0.05
