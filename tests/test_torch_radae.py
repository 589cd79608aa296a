"""The port's RADAE model (models/radae.py) against radae_tpu's on the CPU:
init draw for draw, forward's whole output dict over the configurations
radae_tpu serves, and the vanilla receiver.

Both packages get the same numpy-made features, fades and channel noise:
inside each test the channel's Gaussian draw (`channel.simulate.
complex_normal`) is replaced in both by the same arrays, and quantization
noise is off (cfg.quant_noise False), so the port's core nets run as the
kernels' plain versions (ops/fused_core.py on CPU tensors).  rtol 1e-4,
atol 1e-5.  radae_tpu's forward runs under jax.jit (its eager run is
several times slower to start)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radae_tpu.config import RADAEConfig as JRADAEConfig
from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.models.core import CoreDecoder as JCoreDecoder
from radae_tpu.models.core import CoreEncoder as JCoreEncoder
from radae_tpu.models.radae import RADAE as JRADAE
from radae_tpu.ops import cplx as jcplx
from radae_tpu_torch.config import RADAEConfig, flagship_config
from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder
from radae_tpu_torch.models.radae import RADAE
from radae_tpu_torch.ops import fused_core
from radae_tpu_torch.ops.cplx import C
from tests.test_torch_channel import one_thread, same_noise  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _leaves(tree, prefix=""):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from _leaves(v, prefix + k + "/")
        else:
            yield prefix + k, np.asarray(v)


# -- init ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("widths", [(21, 80), (20, 40)])
def test_init_matches_jax_exactly(seed, widths):
    F, latent = widths
    pairs = ((CoreEncoder(F, latent, 3), JCoreEncoder(F, latent, bottleneck=3)),
             (CoreDecoder(latent, F), JCoreDecoder(latent, F)))
    for mine, ref in pairs:
        a, b = dict(_leaves(mine.init(seed))), dict(_leaves(ref.init(seed)))
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype == np.float32, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg = flagship_config(feature_dim=F, latent_dim=latent)
    jcfg = jax_flagship_config(feature_dim=F, latent_dim=latent)
    a = dict(_leaves(RADAE(cfg, "cpu").init(seed)))
    b = dict(_leaves(JRADAE(jcfg).init(seed)))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


# -- forward --------------------------------------------------------------------

BN1 = dict(feature_dim=20, latent_dim=80, rate_Fs=True, pilots=True,
           pilot_eq=True, eq_mean6=False, cyclic_prefix=0.004, bottleneck=1)
# name -> (config kwargs, flagship_config or RADAEConfig, extras)
CASES = {
    "rate_rs": (dict(feature_dim=20, latent_dim=80, EbNodB=10.0), False, {}),
    "rate_rs_pilots_mean3": (dict(feature_dim=20, latent_dim=80, EbNodB=4.0,
                                  pilots=True, pilot_eq=True), False,
                             {"H": True}),
    "rate_rs_pilots_carrier_mean_b3": (dict(
        feature_dim=20, latent_dim=80, EbNodB=4.0, pilots=True, pilot_eq=True,
        per_carrier_eq=False, bottleneck=3), False, {"H": True}),
    "rate_rs_b2": (dict(feature_dim=20, latent_dim=80, EbNodB=6.0,
                        bottleneck=2), False, {}),
    "flagship_fading": (dict(EbNodB=3.0), True, {"G": True}),
    "rate_fs_mean3_coarse_mag": (dict(BN1, eq_mean6=True, coarse_mag=True,
                                      EbNodB=8.0), False, {}),
    "rate_fs_phase_mag_eq": (dict(BN1, phase_mag_eq=True, EbNodB=12.0),
                             False, {}),
    "rate_fs_b1_offsets_per_row": (dict(
        BN1, phase_offset=0.3, freq_offset=3.0, df_dt=0.2, gain=0.8),
        False, {"EbNodB": [2.0, 9.0]}),
    "rate_fs_b2_freq_corrected": (dict(BN1, bottleneck=2, EbNodB=5.0,
                                correct_freq_offset=True, freq_offset=-2.0),
                           False, {}),
    "latent40": (dict(feature_dim=20, latent_dim=40, EbNodB=10.0,
                      rate_Fs=True, pilots=True, pilot_eq=True,
                      eq_mean6=False, cyclic_prefix=0.004, bottleneck=3,
                      coarse_mag=True), False, {}),
}


def _as_np(v):
    if isinstance(v, (C, jcplx.C)):
        return np.stack([np.asarray(v.re), np.asarray(v.im)])
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


@pytest.mark.parametrize("name", sorted(CASES))
def test_forward_matches_jax(name, same_noise):
    kw, flag, extra = CASES[name]
    kw = dict(kw, quant_noise=False)
    cfg = (flagship_config if flag else RADAEConfig)(**kw)
    jcfg = (jax_flagship_config if flag else JRADAEConfig)(**kw)
    model, jmodel = RADAE(cfg, "cpu"), JRADAE(jcfg)
    params = model.init(3)
    B, T = 2, 48
    rng = np.random.default_rng(11)
    feats = (0.3 * rng.standard_normal((B, T, cfg.feature_dim))).astype(
        np.float32)
    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    H = (rng.uniform(0.3, 1.4, (B, n_rs, cfg.Nc)).astype(np.float32)
         if extra.get("H") else model.default_H(B, n_rs))
    G = None
    if extra.get("G"):
        n_fs = cfg.num_timesteps_at_rate_Fs(n_rs)
        G = (0.7 * rng.standard_normal((B, n_fs, 2, 2))).astype(np.float32)
    ebno = extra.get("EbNodB")
    ebno = None if ebno is None else np.asarray(ebno, np.float32)

    with torch.no_grad():
        got = model.forward(params, feats, H, G, EbNodB=ebno)
    jfwd = jax.jit(lambda p, f, h, g, e: jmodel.forward(
        p, f, h, g, key=jax.random.PRNGKey(0), EbNodB=e))
    want = jfwd(params, feats, H, G, ebno)
    assert set(got) == set(want)
    for k in sorted(want):
        if want[k] is None:
            assert got[k] is None, k
            continue
        np.testing.assert_allclose(_as_np(got[k]), _as_np(want[k]),
                                   err_msg=k, **TOL)


def test_forward_ber_test_rows(same_noise):
    """ber_test: the bits are drawn (torch and jax streams differ), so hold
    the counts' consistency and BER 0 without noise."""
    cfg = RADAEConfig(**dict(BN1, ber_test=True, EbNodB=100.0,
                             quant_noise=False))
    out = RADAE(cfg, "cpu").forward(RADAE(cfg, "cpu").init(0),
                                    np.zeros((3, 48, 20), np.float32))
    assert set(np.unique(out["z"].numpy())) <= {-1.0, 1.0}
    assert out["n_bits"] == out["z"].numel()
    assert int(out["n_errors"]) == 0
    assert out["ber_row"].shape == (3,) and not out["ber_row"].any()


def test_forward_routes_through_the_kernels(monkeypatch):
    """Noise off: the encoder and the decoder each run once as the kernels'
    entry points over the whole batch and sequence, on weights packed once
    per params tree; noise on (the default config): neither."""
    calls = []
    for name in ("fused_encoder_step", "fused_decoder_step",
                 "encoder_weights", "decoder_weights"):
        real = getattr(fused_core, name)
        monkeypatch.setattr(fused_core, name,
                            lambda *a, _r=real, _n=name, **k:
                            calls.append((_n, tuple(a[1].shape)
                                          if _n.startswith("fused") else ()))
                            or _r(*a, **k))
    cfg = flagship_config(quant_noise=False)
    model = RADAE(cfg, "cpu")
    params = model.init(0)
    feats = np.zeros((2, 48, 21), np.float32)
    with torch.no_grad():
        model.forward(params, feats)
        model.forward(params, feats)
    assert calls == [("encoder_weights", ()),
                     ("fused_encoder_step", (2, 48, 21)),
                     ("decoder_weights", ()),
                     ("fused_decoder_step", (2, 12, 80)),
                     ("fused_encoder_step", (2, 48, 21)),
                     ("fused_decoder_step", (2, 12, 80))]
    calls.clear()
    noisy = RADAE(flagship_config(), "cpu")
    with torch.no_grad():
        a = noisy.forward(params, feats)["features_hat"]
        b = noisy.forward(params, feats)["features_hat"]
        c = noisy.forward(params, feats, key=_gen(5))["features_hat"]
    assert calls == []
    # key=None is a fixed generator: the same noise every call
    assert torch.equal(a, b) and not torch.equal(a, c)


def _leaf_tensors(tree):
    return {k: _leaf_tensors(v) if isinstance(v, dict)
            else torch.tensor(v, requires_grad=True) for k, v in tree.items()}


def _tensors(tree):
    for v in tree.values():
        yield from _tensors(v) if isinstance(v, dict) else (v,)


def _count_kernel_calls(monkeypatch):
    calls = []
    for name in ("fused_encoder_step", "fused_decoder_step"):
        real = getattr(fused_core, name)
        monkeypatch.setattr(fused_core, name, lambda *a, _r=real, _n=name,
                            **k: calls.append(_n) or _r(*a, **k))
    return calls


def test_forward_needing_a_gradient_runs_the_plain_nets(monkeypatch):
    """Noise off, weights that require grad, grad mode on: the kernels have
    no backward, so the core nets run plain and features_hat carries a
    gradient to all 78 leaves; under no_grad, or on weights that need
    none, the kernels run as before."""
    calls = _count_kernel_calls(monkeypatch)
    model = RADAE(flagship_config(quant_noise=False, EbNodB=8.0), "cpu")
    tree = model.init(0)
    params = _leaf_tensors(tree)
    feats = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 48, 21)).astype(np.float32) * 0.3)
    out = model.forward(params, feats)
    assert out["features_hat"].requires_grad and calls == []
    out["features_hat"].square().sum().backward()
    grads = [t.grad for t in _tensors(params)]
    assert len(grads) == 78 and all(
        g is not None and torch.isfinite(g).all() and g.abs().max() > 0
        for g in grads)
    with torch.no_grad():
        model.forward(params, feats)
    model.forward(tree, feats)
    assert calls == ["fused_encoder_step", "fused_decoder_step"] * 2


def test_kernels_repack_after_an_in_place_update(monkeypatch):
    """The kernels' weights are packed from the tree's tensors; an in-place
    update of the same tensors (what an optimizer step does) packs them
    again: the noise-free forward and receiver then equal the plain nets on
    the updated tensors."""
    calls = _count_kernel_calls(monkeypatch)
    model = RADAE(flagship_config(quant_noise=False, EbNodB=8.0), "cpu")
    params = _leaf_tensors(model.init(0))
    feats = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 48, 21)).astype(np.float32) * 0.3)
    rng = np.random.default_rng(4)
    with torch.no_grad():
        model.forward(params, feats)
        for t in _tensors(params):
            t.add_(torch.as_tensor(0.05 * rng.standard_normal(t.shape)
                                   .astype(np.float32)))
        out = model.forward(params, feats)
        z = model.core_encoder(params["encoder"], feats)[0]
        fh = model.core_decoder(params["decoder"], out["z_hat"])[0]
        rx = (out["rx"].re[0] + 1j * out["rx"].im[0]).numpy()
        fr, zr = model.receiver(params, rx.astype(np.complex64))
        fr_plain = model.core_decoder(params["decoder"], zr)[0]
    assert calls == ["fused_encoder_step", "fused_decoder_step"] * 2 + [
        "fused_decoder_step"]
    np.testing.assert_allclose(out["z"].numpy(), z.numpy(), **TOL)
    np.testing.assert_allclose(out["features_hat"].numpy(), fh.numpy(), **TOL)
    np.testing.assert_allclose(fr.numpy(), fr_plain.numpy(), **TOL)


# -- receiver -------------------------------------------------------------------

@pytest.mark.parametrize("latent", [80, 40])
def test_receiver_matches_jax(latent):
    """RADAE.receiver (noise off: the decoder kernel's plain version over
    the whole stream at B=1) on the flagship modem's own noisy tx."""
    cfg = flagship_config(latent_dim=latent)
    jcfg = jax_flagship_config(latent_dim=latent)
    model, jmodel = RADAE(cfg, "cpu"), JRADAE(jcfg)
    params = model.init(1)
    rng = np.random.default_rng(12)
    z = np.tanh(rng.standard_normal((1, 4 * cfg.Nzmf, latent))).astype(
        np.float32)
    tx = model.transmitter(z, cfg.num_timesteps_at_rate_Rs(16 * cfg.Nzmf))
    s = (tx.re + 1j * tx.im).numpy()[0].astype(np.complex64)
    s = s * np.exp(1j * 0.6) + (0.05 * (rng.standard_normal(s.shape)
                                        + 1j * rng.standard_normal(s.shape))
                                ).astype(np.complex64)
    s = s.astype(np.complex64)
    with torch.no_grad():
        f, zh = model.receiver(params, s)
    jf, jzh = jax.jit(lambda p, r: jmodel.receiver(p, r))(params, jcplx.of(s))
    np.testing.assert_allclose(zh.numpy(), np.asarray(jzh), **TOL)
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), **TOL)
    assert f.shape == (1, 16 * cfg.Nzmf, cfg.feature_dim)
    # the transmitter is radae_tpu's too
    jtx = jmodel.transmitter(jnp.asarray(z),
                             cfg.num_timesteps_at_rate_Rs(16 * cfg.Nzmf))
    np.testing.assert_allclose(tx.re.numpy(), np.asarray(jtx.re), **TOL)
    np.testing.assert_allclose(tx.im.numpy(), np.asarray(jtx.im), **TOL)


def test_est_snr_matches_jax():
    cfg, jcfg = flagship_config(), jax_flagship_config()
    rng = np.random.default_rng(13)
    r = (np.asarray(cfg.p_cp[cfg.Ncp:cfg.Ncp + cfg.M])
         + 0.1 * (rng.standard_normal(cfg.M)
                  + 1j * rng.standard_normal(cfg.M))).astype(np.complex64)
    assert abs(RADAE(cfg, "cpu").est_snr(r) - JRADAE(jcfg).est_snr(r)) < 1e-6
