"""The port's batched streaming tx/rx serving steps against radae_tpu's on
the CPU: the fixture checkpoint, 4 streams of fixtures/speech_feats.f32,
3 frames, frame-aligned rx windows (rtol 1e-4, atol 1e-5)."""

import numpy as np
import pytest
import torch

from radae_tpu import runtime as jrt
from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.models.core import CoreDecoder as JDecoder, CoreEncoder as JEncoder
from radae_tpu_torch import runtime
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder
from radae_tpu_torch.ops import fused_core as fc

TOL = dict(rtol=1e-4, atol=1e-5)
B, NF = 4, 3


@pytest.fixture(scope="module")
def setup():
    tree = load_checkpoint("fixtures/model_fs_flagship.npz")[0]
    raw = read_f32("fixtures/speech_feats.f32", NB_TOTAL_FEATURES)
    feats = np.zeros((B, 12 * NF, 21), np.float32)
    for b in range(B):
        feats[b, :, :20] = raw[37 * b:37 * b + 12 * NF, :20]
    feats[:, :, 20] = -1.0
    cfg = jax_flagship_config()
    tx = jrt.make_streaming_tx_step(cfg, JEncoder(21, 80, 3), B)
    st, sig = None, []
    for k in range(NF):
        s, st = tx(tree["encoder"], feats[:, 12 * k:12 * (k + 1)], st)
        sig.append(np.asarray(s))
    sig.append(np.zeros((B, cfg.M + cfg.Ncp, 2), np.float32))
    return tree, feats, np.concatenate(sig, 1)


def _weights(tree, side, fused):
    if fused:
        return (fc.decoder_weights if side == "decoder"
                else fc.encoder_weights)(tree[side], "cpu")
    return params_to_torch(tree, "cpu")[side]


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_tx_step_matches_jax(setup, fused):
    tree, feats, sig = setup
    cfg = flagship_config()
    tx = runtime.make_streaming_tx_step(cfg, CoreEncoder(21, 80, 3), B,
                                        fused=fused, device="cpu")
    w = _weights(tree, "encoder", fused)
    st = fc.encoder_state_zero(B, "cpu") if fused else None
    for k in range(NF):
        s, st = tx(w, torch.as_tensor(feats[:, 12 * k:12 * (k + 1)]), st)
        np.testing.assert_allclose(s.numpy(), sig[:, k * cfg.Nmf:(k + 1) * cfg.Nmf],
                                   **TOL)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_rx_step_matches_jax(setup, fused):
    tree, _, sig = setup
    cfg = flagship_config()
    jrx = jrt.make_streaming_rx_step(jax_flagship_config(), JDecoder(80, 21), B)
    rx = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                        fused=fused, device="cpu")
    w = _weights(tree, "decoder", fused)
    st = fc.decoder_state_zero(B, "cpu") if fused else None
    jst = None
    win = cfg.Nmf + cfg.M + cfg.Ncp
    for k in range(NF):
        x = sig[:, k * cfg.Nmf:k * cfg.Nmf + win]
        f, st = rx(w, torch.as_tensor(x), st)
        f_ref, jst = jrx(tree["decoder"], x, jst)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)


def test_rx_step_two_frames_per_step_matches_jax(setup):
    tree, _, sig = setup
    cfg = flagship_config()
    jrx = jrt.make_streaming_rx_step(jax_flagship_config(), JDecoder(80, 21), B)
    rx = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                        fused=True, frames_per_step=2,
                                        device="cpu")
    f, _ = rx(fc.decoder_weights(tree["decoder"], "cpu"),
              torch.as_tensor(sig[:, :2 * cfg.Nmf + cfg.M + cfg.Ncp]),
              fc.decoder_state_zero(B, "cpu"))
    jst, ref = None, []
    for k in range(2):
        f_k, jst = jrx(tree["decoder"],
                       sig[:, k * cfg.Nmf:(k + 1) * cfg.Nmf + cfg.M + cfg.Ncp],
                       jst)
        ref.append(np.asarray(f_k))
    np.testing.assert_allclose(f.numpy(), np.concatenate(ref, 1), **TOL)


@pytest.mark.parametrize("fps", [1, 2])
def test_rx_step_merged_matches_jax(setup, fps):
    """The port's rx step on the chain-merged decoder (fused_merged=True)
    against radae_tpu's rx step, frames_per_step 1 (3 chained calls) and 2
    (one call over two frames)."""
    tree, _, sig = setup
    cfg = flagship_config()
    jrx = jrt.make_streaming_rx_step(jax_flagship_config(), JDecoder(80, 21), B)
    rx = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                        fused=True, fused_merged=True,
                                        frames_per_step=fps, device="cpu")
    w = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    st = fc.decoder_state_zero(B, "cpu", merged=True)
    jst, ref = None, []
    for k in range(NF):
        f_k, jst = jrx(tree["decoder"],
                       sig[:, k * cfg.Nmf:(k + 1) * cfg.Nmf + cfg.M + cfg.Ncp],
                       jst)
        ref.append(np.asarray(f_k))
    win = fps * cfg.Nmf + cfg.M + cfg.Ncp
    for c in range(NF // fps):
        f, st = rx(w, torch.as_tensor(sig[:, c * fps * cfg.Nmf:
                                          c * fps * cfg.Nmf + win]), st)
        assert len(st) == 15
        np.testing.assert_allclose(
            f.numpy(), np.concatenate(ref[c * fps:(c + 1) * fps], 1), **TOL)


def test_rx_step_refuses_weights_of_the_other_layout(setup):
    tree = setup[0]
    cfg = flagship_config()
    win = cfg.Nmf + cfg.M + cfg.Ncp
    for merged in (False, True):
        rx = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                            fused=True, fused_merged=merged,
                                            device="cpu")
        with pytest.raises(ValueError, match="fused_merged"):
            rx(fc.decoder_weights(tree["decoder"], "cpu", merged=not merged),
               torch.zeros((B, win, 2)),
               fc.decoder_state_zero(B, "cpu", merged=not merged))


def test_steps_check_their_batch(setup):
    cfg = flagship_config()
    rx = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                        device="cpu")
    with pytest.raises(ValueError, match="rx step built for"):
        rx(None, torch.zeros((B + 1, cfg.Nmf + cfg.M + cfg.Ncp, 2)), None)
