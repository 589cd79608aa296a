"""The port's per-frame transmitter and receiver (dsp/streaming.py) and its
core nets with quantization noise, against radae_tpu on the CPU: the
fixture weights, random latents through a noisy channel, a few chained
frames (rtol 1e-4, atol 1e-5; the SNR estimate within 1e-3 dB; the EOO
soft bits at atol 1e-5).  Noise is held to its size, not its values:
torch cannot reproduce jax's stream."""

import jax
import numpy as np
import pytest
import torch

from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.dsp.streaming import ReceiverOne as JReceiverOne
from radae_tpu.dsp.streaming import TransmitterOne as JTransmitterOne
from radae_tpu.models import core as jcore
from radae_tpu.ops import ofdm as jofdm
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
from radae_tpu_torch.dsp.streaming import ReceiverOne, TransmitterOne
from radae_tpu_torch.models import core

TOL = dict(rtol=1e-4, atol=1e-5)
NF = 5          # chained frames


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint("fixtures/model_fs_flagship.npz")[0]


def _awgn(x, sigma, seed):
    rng = np.random.default_rng(seed)
    n = rng.standard_normal(len(x)) + 1j * rng.standard_normal(len(x))
    return (0.8 * np.exp(0.7j) * x + sigma * n / np.sqrt(2)).astype(
        np.complex64)


@pytest.fixture(scope="module")
def latents():
    cfg = flagship_config()
    rng = np.random.default_rng(21)
    return np.tanh(2 * rng.standard_normal(
        (NF + 1, 1, cfg.Nzmf, cfg.latent_dim))).astype(np.float32)


def test_transmitter_one_matches_jax(latents):
    ours = TransmitterOne(flagship_config(), "cpu")
    ref = JTransmitterOne(jax_flagship_config())
    for z in latents:
        got, want = ours.transmit(z), ref.transmit(z)
        assert got.dtype == np.complex64 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)


def test_receiver_one_matches_jax_over_chained_frames(latents):
    cfg = flagship_config()
    tx = JTransmitterOne(jax_flagship_config())
    sig = _awgn(np.concatenate([tx.transmit(z) for z in latents]), 0.3, 4)
    ours, ref = ReceiverOne(cfg, "cpu"), JReceiverOne(jax_flagship_config())
    n = cfg.Nmf + cfg.M + cfg.Ncp
    for k in range(NF):
        rx = sig[k * cfg.Nmf:k * cfg.Nmf + n]
        z_hat = ours.receive(rx)
        want = ref.receive(rx)
        assert isinstance(z_hat, torch.Tensor) and z_hat.device.type == "cpu"
        np.testing.assert_allclose(z_hat.numpy(), want, **TOL)
        assert abs(ours.snrdB_3k_est - ref.snrdB_3k_est) < 1e-3
    assert ours.snrdB_3k_est != 0.0


def test_receiver_one_eoo_soft_bits_match_jax():
    cfg, jcfg = flagship_config(), jax_flagship_config()
    bits = np.sign(np.random.default_rng(65647).random(cfg.Nseoo * cfg.bps)
                   - 0.5).astype(np.float32)
    eoo = _awgn(jofdm.set_eoo_bits(jcfg, bits).flatten(), 0.3, 1)
    got = ReceiverOne(cfg, "cpu").receive(eoo, endofover=True).numpy()
    want = JReceiverOne(jcfg).receive(eoo, endofover=True)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert float(np.mean(np.sign(got.flatten()[:len(bits)]) != bits)) < 0.05


def _speech(B, T):
    raw = read_f32("fixtures/speech_feats.f32", NB_TOTAL_FEATURES)
    f = np.zeros((B, T, 21), np.float32)
    for b in range(B):
        f[b, :, :20] = raw[37 * b:37 * b + T, :20]
    f[:, :, 20] = -1.0
    return f


def _rms(a, b):
    return float(np.sqrt(np.mean((np.asarray(a) - np.asarray(b)) ** 2)))


NOISE_SEEDS = 4


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_core_noise_size_matches_jax(tree, side):
    """key=None gives the same bits on every call and radae_tpu's values;
    a generator adds noise whose effect on the output, RMS against the
    noise-off output averaged over NOISE_SEEDS seeds, is within a factor
    1.5 of radae_tpu's under as many jax keys (one draw alone spreads by
    +-15% on the encoder, whose recurrence carries each draw)."""
    params = params_to_torch(tree, "cpu")[side]
    if side == "encoder":
        x = _speech(4, 48)
        ours, ref = core.CoreEncoder(21, 80, 3), jcore.CoreEncoder(21, 80, 3)
    else:
        x = np.tanh(np.random.default_rng(3).standard_normal(
            (4, 12, 80))).astype(np.float32)
        ours, ref = core.CoreDecoder(80, 21), jcore.CoreDecoder(80, 21)
    y_off, _ = ours(params, torch.as_tensor(x), key=None)
    y_off2, _ = ours(params, torch.as_tensor(x))
    assert torch.equal(y_off, y_off2)
    r_off = jax.jit(lambda p, x: ref(p, x, key=None)[0])(tree[side], x)
    np.testing.assert_allclose(y_off.numpy(), np.asarray(r_off), **TOL)
    ref_on = jax.jit(lambda p, x, k: ref(p, x, key=k)[0])
    rms, rms_ref = [], []
    for seed in range(NOISE_SEEDS):
        y_on, st = ours(params, torch.as_tensor(x),
                        key=torch.Generator().manual_seed(seed))
        assert bool(torch.isfinite(y_on).all())
        assert all(bool(torch.isfinite(v).all()) for v in st.values())
        rms.append(_rms(y_on, y_off))
        rms_ref.append(_rms(ref_on(tree[side], x, jax.random.PRNGKey(seed)),
                            r_off))
    ratio = np.mean(rms) / np.mean(rms_ref)
    assert min(rms_ref) > 0 and 1 / 1.5 < ratio < 1.5, (rms, rms_ref)


def test_core_noise_one_seed_same_output(tree):
    params = params_to_torch(tree, "cpu")["encoder"]
    x = torch.as_tensor(_speech(1, 12))
    enc = core.CoreEncoder(21, 80, 3)
    a, _ = enc(params, x, key=torch.Generator().manual_seed(0))
    b, _ = enc(params, x, key=torch.Generator().manual_seed(0))
    assert torch.equal(a, b)
