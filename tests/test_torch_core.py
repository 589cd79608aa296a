"""The port's checkpoint loading and core nets against radae_tpu on the CPU
(fixture weights, quantization noise off; rtol 1e-4, atol 1e-5)."""

import numpy as np
import pytest
import torch

from radae_tpu.convert import load_checkpoint as jax_load_checkpoint
from radae_tpu.models import core as jcore
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
from radae_tpu_torch.models import core

CKPT = "fixtures/model_fs_flagship.npz"
TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint(CKPT)[0]


@pytest.fixture(scope="module")
def params(tree):
    return params_to_torch(tree, device="cpu")


def _speech(B, T):
    raw = read_f32("fixtures/speech_feats.f32", NB_TOTAL_FEATURES)
    f = np.zeros((B, T, 21), np.float32)
    for b in range(B):
        f[b, :, :20] = raw[37 * b:37 * b + T, :20]
    f[:, :, 20] = -1.0
    return f


def _latents(B, Tz, seed):
    return np.tanh(np.random.default_rng(seed).standard_normal(
        (B, Tz, 80))).astype(np.float32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def test_load_checkpoint_matches_jax(tree):
    ref, ref_meta = jax_load_checkpoint(CKPT)
    ours, meta = load_checkpoint(CKPT)
    assert meta == ref_meta
    a, b = _flat(ours), _flat(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_params_to_torch_keeps_keys_and_layouts(tree, params):
    a, b = _flat(params), _flat(tree)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == torch.float32 and a[k].device.type == "cpu"
        np.testing.assert_array_equal(a[k].numpy(), b[k])
    assert tuple(params["decoder"]["conv1"]["w"].shape) == (32, 192, 2)


@pytest.fixture(scope="module")
def jax_whole(tree):
    """radae_tpu's encoder and decoder over whole sequences from the zero
    state: (features, z, final state) and (z_hat, features, final state)."""
    f, z = _speech(4, 36), _latents(4, 9, 1)
    z_ref, enc_state = jcore.CoreEncoder(21, 80, 3)(tree["encoder"], f, key=None)
    f_ref, dec_state = jcore.CoreDecoder(80, 21)(tree["decoder"], z, key=None)
    return {"encoder": (f, z_ref, enc_state), "decoder": (z, f_ref, dec_state)}


NETS = {"encoder": (lambda: core.CoreEncoder(21, 80, 3), 12),
        "decoder": (lambda: core.CoreDecoder(80, 21), 3)}


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_core_net_matches_jax(params, jax_whole, side):
    x, y_ref, state_ref = jax_whole[side]
    y, state = NETS[side][0]()(params[side], torch.as_tensor(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    for key in state_ref:
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(state_ref[key]), **TOL)


@pytest.mark.parametrize("side", ["encoder", "decoder"])
def test_core_net_in_3_chunks_matches_jax_whole_sequence(params, jax_whole,
                                                         side):
    """Streaming with carried state equals radae_tpu's whole-sequence run,
    outputs and final state."""
    x, y_ref, state_ref = jax_whole[side]
    make, step = NETS[side]
    net, state, outs = make(), None, []
    for k in range(3):
        y, state = net(params[side],
                       torch.as_tensor(x[:, k * step:(k + 1) * step]),
                       state=state)
        outs.append(y.numpy())
    np.testing.assert_allclose(np.concatenate(outs, 1), np.asarray(y_ref),
                               **TOL)
    for key in state_ref:
        np.testing.assert_allclose(state[key].numpy(),
                                   np.asarray(state_ref[key]), **TOL)


@pytest.mark.parametrize("nf", [20, 21])
def test_distortion_loss_matches_jax(nf):
    rng = np.random.default_rng(3)
    y_true = rng.standard_normal((3, 50, nf)).astype(np.float32)
    y_pred = rng.standard_normal((3, 50, nf)).astype(np.float32)
    ref = np.asarray(jcore.distortion_loss(y_true, y_pred))
    ours = core.distortion_loss(torch.as_tensor(y_true),
                                torch.as_tensor(y_pred)).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)


def test_quantization_noise_key_is_refused(params):
    with pytest.raises(NotImplementedError):
        core.CoreDecoder(80, 21)(params["decoder"],
                                 torch.zeros((1, 1, 80)), key=0)
