"""The fused core kernels' plain versions (radae_tpu_torch/ops/fused_core.py)
against radae_tpu's Pallas kernels in interpret mode, as tests/test_fused.py
runs them on the CPU (fixture weights; rtol 1e-4, atol 1e-5).  The CUDA
kernels themselves are held against these plain versions on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

from radae_tpu.ops import fused_core as jfc
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.ops import fused_core as fc

TOL = dict(rtol=1e-4, atol=1e-5)
B = 8


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint("fixtures/model_fs_flagship.npz")[0]


@pytest.mark.parametrize("side", ["decoder", "encoder"])
def test_packed_weights_equal_jax(tree, side):
    ours = (fc.decoder_weights if side == "decoder"
            else fc.encoder_weights)(tree[side], "cpu")
    ref = (jfc.decoder_weights if side == "decoder"
           else jfc.encoder_weights)(tree[side])
    assert ours.names == tuple(jfc._fused_weights(tree[side], side)[1])
    assert len(ours.arrays) == len(ref)
    for a, r in zip(ours.arrays, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        assert a.data_ptr() % 16 == 0 and a.untyped_storage().data_ptr() \
            == ours.buf.untyped_storage().data_ptr()


def _z(rng):
    return np.tanh(rng.standard_normal((B, 3, 80))).astype(np.float32)


@pytest.mark.parametrize("merged", [False, True], ids=["unmerged", "merged"])
def test_decoder_plain_matches_pallas_interpret(tree, merged):
    """3 chained frames with carried state; the JAX chain-merged layout
    computes the same features as the unmerged form the port takes."""
    w = fc.decoder_weights(tree["decoder"], "cpu")
    step = jfc.make_fused_decoder_step(80, 21, B, tile=4, interpret=True,
                                       merged=merged)
    jw = jfc.decoder_weights(tree["decoder"], merged=merged)
    jstate = jfc.decoder_state_zero(B, merged=merged)
    state = fc.decoder_state_zero(B, "cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        z = _z(rng)
        f, state = fc.decoder_step_plain(w, torch.as_tensor(z), state)
        f_ref, jstate = step(jw, z, *jstate)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)
        if not merged:
            for s, r in zip(state, jstate):
                np.testing.assert_allclose(s.numpy(), np.asarray(r), **TOL)


def _enc_state_from_jax(jstate):
    """radae_tpu's flat 128-padded history rings -> (B, d, cin)."""
    from radae_tpu.models.core import _ENC_CONV_DIMS
    out = [np.asarray(h) for h in jstate[:5]]
    for (cin, _, d), ring in zip(_ENC_CONV_DIMS, jstate[5:]):
        c128 = -(-cin // 128) * 128
        out.append(np.asarray(ring).reshape(B, d, c128)[:, :, :cin])
    return out


def test_encoder_plain_matches_pallas_interpret(tree):
    w = fc.encoder_weights(tree["encoder"], "cpu")
    step = jfc.make_fused_encoder_step(21, 80, B, tile=4, interpret=True)
    jw = jfc.encoder_weights(tree["encoder"])
    jstate = jfc.encoder_state_zero(B)
    state = fc.encoder_state_zero(B, "cpu")
    rng = np.random.default_rng(1)
    for _ in range(3):
        f = (0.3 * rng.standard_normal((B, 12, 21))).astype(np.float32)
        z, state = fc.encoder_step_plain(w, torch.as_tensor(f), state)
        z_ref, jstate = step(jw, f, *jstate)
        np.testing.assert_allclose(z.numpy(), np.asarray(z_ref), **TOL)
        for s, r in zip(state, _enc_state_from_jax(jstate)):
            np.testing.assert_allclose(s.numpy(), r, **TOL)


def test_merged_decoder_weights_equal_jax(tree):
    ours = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    ref = jfc.decoder_weights(tree["decoder"], merged=True)
    assert ours.names == tuple(
        jfc._fused_weights(tree["decoder"], "decoder", merged=True)[1])
    assert len(ours.arrays) == len(ref) == 34 and fc.is_merged(ours)
    for a, r in zip(ours.arrays, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
        assert a.data_ptr() % 16 == 0 and a.untyped_storage().data_ptr() \
            == ours.buf.untyped_storage().data_ptr()
    for a, r in zip(fc.decoder_state_zero(B, "cpu", merged=True),
                    jfc.decoder_state_zero(B, merged=True)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))


@pytest.mark.parametrize("nz", [3, 6])
def test_merged_decoder_plain_matches_pallas_interpret(tree, nz):
    """radae_tpu's chain-merged kernel against the port's merged plain
    version: features and all 15 state tensors over 3 chained calls."""
    w = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    step = jfc.make_fused_decoder_step(80, 21, B, tile=4, nz=nz,
                                       interpret=True, merged=True)
    jw = jfc.decoder_weights(tree["decoder"], merged=True)
    jstate = jfc.decoder_state_zero(B, merged=True)
    state = fc.decoder_state_zero(B, "cpu", merged=True)
    rng = np.random.default_rng(3)
    for _ in range(3):
        z = np.tanh(rng.standard_normal((B, nz, 80))).astype(np.float32)
        f, state = fc.decoder_merged_step_plain(w, torch.as_tensor(z), state)
        f_ref, jstate = step(jw, z, *jstate)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **TOL)
        assert len(state) == len(jstate) == 15
        for s, r in zip(state, jstate):
            np.testing.assert_allclose(s.numpy(), np.asarray(r), **TOL)


def test_merged_and_unmerged_plain_give_the_same_features(tree):
    w = fc.decoder_weights(tree["decoder"], "cpu")
    wm = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    s, sm = fc.decoder_state_zero(B, "cpu"), fc.decoder_state_zero(
        B, "cpu", merged=True)
    rng = np.random.default_rng(4)
    for _ in range(3):
        z = torch.as_tensor(_z(rng))
        f, s = fc.decoder_step_plain(w, z, s)
        fm, sm = fc.decoder_merged_step_plain(wm, z, sm)
        torch.testing.assert_close(fm, f, **TOL)
        torch.testing.assert_close(sm[:5], s[:5], **TOL)


def test_wrappers_run_the_plain_version_on_cpu_without_launching(tree):
    fc.reset_launches()
    w = fc.decoder_weights(tree["decoder"], "cpu")
    z = torch.as_tensor(_z(np.random.default_rng(2)))
    s0 = fc.decoder_state_zero(B, "cpu")
    f, s = fc.fused_decoder_step(w, z, s0)
    f_ref, s_ref = fc.decoder_step_plain(w, z, s0)
    torch.testing.assert_close(f, f_ref, rtol=0, atol=0)
    wm = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    sm0 = fc.decoder_state_zero(B, "cpu", merged=True)
    fm, sm = fc.fused_decoder_step(wm, z, sm0)
    fm_ref, _ = fc.decoder_merged_step_plain(wm, z, sm0)
    torch.testing.assert_close(fm, fm_ref, rtol=0, atol=0)
    assert len(sm) == 15
    ew = fc.encoder_weights(tree["encoder"], "cpu")
    x = torch.zeros((B, 12, 21))
    zz, _ = fc.fused_encoder_step(ew, x, fc.encoder_state_zero(B, "cpu"))
    assert tuple(zz.shape) == (B, 3, 80)
    from radae_tpu_torch.config import flagship_config
    cfg = flagship_config()
    rw = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    rx = torch.zeros((B, (cfg.Ns + 2) * (cfg.M + cfg.Ncp), 2))
    ff, _ = fc.make_fused_rx_frame_step(cfg, B, device="cpu")(rw, rx, s0)
    ff_ref, _ = fc.rx_frame_step_plain(rw, rx, s0)
    torch.testing.assert_close(ff, ff_ref, rtol=0, atol=0)
    assert fc.LAUNCHES == {"fused_decoder_step": 0,
                           "fused_decoder_merged_step": 0,
                           "fused_rx_frame_step": 0, "fused_encoder_step": 0,
                           "fused_decoder_step_int8": 0,
                           "fused_decoder_merged_step_int8": 0,
                           "fused_encoder_step_int8": 0}


def test_wrappers_refuse_other_devices(tree):
    w = fc.decoder_weights(tree["decoder"], "cpu")
    z = torch.zeros((B, 3, 80), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        fc.fused_decoder_step(w, z, fc.decoder_state_zero(B, "cpu"))


@pytest.mark.parametrize("side, rows, want", [
    ("encoder", (2, 4), 21_835_776),    # the first kernels: 2-row GRU, 4-row tiles
    ("encoder", (16, 16), 3_738_624),   # one 16-row tile a block: each weight read once
    ("encoder", (8, 8), 7_477_248),     # two 8-row tiles a block
    ("decoder", (2, 4), 24_786_944),
    ("decoder", (16, 16), 3_616_256),
    ("decoder", (8, 8), 7_232_512),
    ("merged", (2, 4), 22_575_104),     # PR 2's merged kernel: dot<2, 2> on wih
    ("merged", (16, 16), 3_616_256),    # the same 904,064 floats as unmerged
], ids=["rows2-4", "rows16", "rows8", "dec-rows2-4", "dec-rows16", "dec-rows8",
        "decm-rows2-4", "decm-rows16"])
def test_encoder_weight_fetch_bytes(tree, side, rows, want):
    """chip_smoke's count of the weight bytes one 16-stream block of the
    encoder kernel, of the unmerged or of the chain-merged decoder kernel,
    fetches into its SM per z-step, at the flagship widths."""
    import chip_smoke
    if side == "merged":
        w = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
    else:
        w = (fc.encoder_weights if side == "encoder" else fc.decoder_weights)(
            tree[side], "cpu")
    assert chip_smoke.weight_fetch_bytes(w, *rows, 16) == want
    assert chip_smoke.weight_fetch_bytes(w, 16, 16, 16) == 4 * sum(
        a.numel() for a in w.arrays if a.dim() == 2)
