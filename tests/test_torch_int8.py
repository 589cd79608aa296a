"""The port's int8 weights and int8 steps against radae_tpu's on the CPU.

The packing (`decoder_weights` / `encoder_weights` with quant="int8") must
give radae_tpu's int8 matrices and scale rows bit for bit.  The plain int8
steps (radae_tpu_torch/ops/fused_core.py) are held against radae_tpu's
Pallas kernels in interpret mode, as tests/test_fused.py runs them, at
rtol 1e-4, atol 1e-5; the CUDA kernels are held against the plain versions
on the card by chip_smoke.py.  Then the runtime steps with
fused_quant="int8" and the tx_batch CLI against radae_tpu's."""

import os

import numpy as np
import pytest
import torch

from radae_tpu.ops import fused_core as jfc
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.ops import fused_core as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
TOL = dict(rtol=1e-4, atol=1e-5)
B = 4


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint(CKPT)[0]


@pytest.mark.parametrize("side, merged, excl, n_scales", [
    ("decoder", False, (), 27),
    ("decoder", True, (), 17),
    ("encoder", False, (), 22),
    ("decoder", False, ("whh",), 27),
], ids=["unmerged", "merged", "encoder", "exclude-whh"])
def test_int8_weights_equal_jax(tree, side, merged, excl, n_scales):
    if side == "decoder":
        ours = fc.decoder_weights(tree[side], "cpu", merged=merged,
                                  quant="int8", quant_exclude=excl)
        ref = jfc.decoder_weights(tree[side], quant="int8",
                                  quant_exclude=excl, merged=merged)
    else:
        ours = fc.encoder_weights(tree[side], "cpu", quant="int8")
        ref = jfc.encoder_weights(tree[side], quant="int8")
    assert ours.quant == "int8" and len(ours.scales) == n_scales
    assert len(ours.arrays) + n_scales == len(ref)
    for a, r in zip(ours.arrays + ours.scales, ref):
        r = np.asarray(r)
        assert a.numpy().dtype == r.dtype and a.shape == r.shape
        np.testing.assert_array_equal(a.numpy(), r)
        # every array is a view of the one buffer, each start 16-byte aligned
        assert a.data_ptr() % 16 == 0 and a.untyped_storage().data_ptr() \
            == ours.buf.untyped_storage().data_ptr()
    kinds = {a.dtype for a in ours.arrays if a.dim() == 2}
    assert kinds == ({torch.int8, torch.float32} if excl else {torch.int8})
    # one byte a weight: the int8 buffer is about a quarter of the f32 one
    f32 = (fc.decoder_weights(tree[side], "cpu", merged=merged)
           if side == "decoder" else fc.encoder_weights(tree[side], "cpu"))
    assert ours.buf.numel() < (0.5 if excl else 0.3) * f32.buf.numel()


def test_unmatched_quant_exclude_suffix_raises(tree):
    with pytest.raises(ValueError, match="matched no weight name"):
        fc.decoder_weights(tree["decoder"], "cpu", merged=True, quant="int8",
                           quant_exclude=("whh",))
    with pytest.raises(ValueError, match="quant must be one of"):
        fc.encoder_weights(tree["encoder"], "cpu", quant="int4")


@pytest.mark.parametrize("form", ["unmerged", "merged", "encoder"])
def test_int8_plain_matches_pallas_interpret(tree, form):
    """3 chained calls with carried state: outputs and every state tensor."""
    rng = np.random.default_rng(11)
    if form == "encoder":
        w = fc.encoder_weights(tree["encoder"], "cpu", quant="int8")
        jw = jfc.encoder_weights(tree["encoder"], quant="int8")
        step = jfc.make_fused_encoder_step(21, 80, B, tile=B, interpret=True,
                                           quant="int8")
        st, jst = fc.encoder_state_zero(B, "cpu"), jfc.encoder_state_zero(B)
    else:
        merged = form == "merged"
        w = fc.decoder_weights(tree["decoder"], "cpu", merged=merged,
                               quant="int8")
        jw = jfc.decoder_weights(tree["decoder"], quant="int8", merged=merged)
        step = jfc.make_fused_decoder_step(80, 21, B, tile=B, interpret=True,
                                           quant="int8", merged=merged)
        st = fc.decoder_state_zero(B, "cpu", merged=merged)
        jst = jfc.decoder_state_zero(B, merged=merged)
    for _ in range(3):
        if form == "encoder":
            x = (0.3 * rng.standard_normal((B, 12, 21))).astype(np.float32)
            y, st = fc.encoder_step_plain(w, torch.as_tensor(x), st)
            ref = step(jw, x, *jst)
            jst = ref[1]
            # radae_tpu's flat 128-padded history rings -> (B, d, cin)
            ref_st = [np.asarray(h) for h in jst[:5]] + [
                np.asarray(r).reshape(B, s.shape[1], -1)[:, :, :s.shape[2]]
                for r, s in zip(jst[5:], st[5:])]
        else:
            x = np.tanh(rng.standard_normal((B, 3, 80))).astype(np.float32)
            y, st = (fc.decoder_merged_step_plain if form == "merged"
                     else fc.decoder_step_plain)(w, torch.as_tensor(x), st)
            ref = step(jw, x, *jst)
            jst = ref[1]
            ref_st = [np.asarray(r) for r in jst]
        np.testing.assert_allclose(y.numpy(), np.asarray(ref[0]), **TOL)
        assert len(st) == len(ref_st)
        for s, r in zip(st, ref_st):
            np.testing.assert_allclose(s.numpy(), r, **TOL)


def _interpret(name):
    """Patch radae_tpu's kernel factory `name` to interpret mode; returns
    the original."""
    orig = getattr(jfc, name)
    setattr(jfc, name, lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    return orig


@pytest.mark.parametrize("side", ["rx", "tx"])
def test_runtime_int8_steps_match_jax(tree, side):
    from radae_tpu.config import flagship_config as jcfg
    from radae_tpu import runtime as jrt
    from radae_tpu.models.core import CoreDecoder as JDec, CoreEncoder as JEnc
    from radae_tpu_torch import runtime
    from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder
    cfg = flagship_config()
    rng = np.random.default_rng(5)
    name = ("make_fused_decoder_step" if side == "rx"
            else "make_fused_encoder_step")
    orig = _interpret(name)
    try:
        if side == "rx":
            jstep = jrt.make_streaming_rx_step(jcfg(), JDec(80, 21), B,
                                               fused=True, fused_tile=B,
                                               fused_quant="int8")
            step = runtime.make_streaming_rx_step(
                cfg, CoreDecoder(80, 21), B, fused=True, fused_quant="int8",
                device="cpu")
            jw = tuple(jfc.decoder_weights(tree["decoder"], quant="int8"))
            w = fc.decoder_weights(tree["decoder"], "cpu", quant="int8")
            jst, st = jfc.decoder_state_zero(B), fc.decoder_state_zero(B, "cpu")
        else:
            jstep = jrt.make_streaming_tx_step(jcfg(), JEnc(21, 80, 3), B,
                                               fused=True, fused_tile=B,
                                               fused_quant="int8")
            step = runtime.make_streaming_tx_step(
                cfg, CoreEncoder(21, 80, 3), B, fused=True,
                fused_quant="int8", device="cpu")
            jw = tuple(jfc.encoder_weights(tree["encoder"], quant="int8"))
            w = fc.encoder_weights(tree["encoder"], "cpu", quant="int8")
            jst, st = jfc.encoder_state_zero(B), fc.encoder_state_zero(B, "cpu")
        for _ in range(2):
            if side == "rx":
                x = (0.5 * rng.standard_normal(
                    (B, cfg.Nmf + cfg.M + cfg.Ncp, 2))).astype(np.float32)
            else:
                x = (0.3 * rng.standard_normal((B, 12, 21))).astype(np.float32)
            y, st = step(w, torch.as_tensor(x), st)
            y_ref, jst = jstep(jw, x, jst)
            np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    finally:
        setattr(jfc, name, orig)
    # a weight set of the other kind raises before any launch
    with pytest.raises(ValueError, match="fused_quant='int8' got weights"):
        step(fc.decoder_weights(tree["decoder"], "cpu") if side == "rx"
             else fc.encoder_weights(tree["encoder"], "cpu"),
             torch.as_tensor(x), st)


def test_runtime_refuses_bf16_and_pad(tree):
    from radae_tpu_torch import runtime
    from radae_tpu_torch.models.core import CoreDecoder
    cfg = flagship_config()
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 2"):
        runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B, fused=True,
                                       fused_dtype=torch.bfloat16,
                                       device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 2"):
        runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B, fused=True,
                                       fused_merged="pad", device="cpu")
    with pytest.raises(ValueError, match="need fused=True"):
        runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                       fused_quant="int8", device="cpu")


def test_kernel_wrappers_refuse_other_weight_kinds(tree):
    """A weight set the kernels do not take raises before a launch (on a
    tensor of the meta device, which reaches the checks and no kernel)."""
    w = fc.decoder_weights(tree["decoder"], "cpu", quant="int8")
    bad = w._replace(arrays=tuple(a.to(torch.bfloat16) if a.dim() == 2 else a
                                  for a in w.arrays))
    with pytest.raises(ValueError, match="f32 or int8 weights"):
        fc._check_kinds(bad, "fused_decoder_step", fc.N_DEC)
    with pytest.raises(ValueError, match="f32 or int8 weights"):
        fc._check_kinds(w._replace(scales=w.scales[:-1]),
                        "fused_decoder_step", fc.N_DEC)
    fc._check_kinds(w, "fused_decoder_step", fc.N_DEC)


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused-int8"])
def test_tx_batch_cli_matches_jax(tmp_path, capsys, fused):
    """The port's tx_batch writes radae_tpu's IQ files (within the f32 sum
    order) and prints its lines; --fused is the int8 encoder on both."""
    from radae_tpu.tools import tx_batch as jtx
    from radae_tpu_torch.tools import tx_batch
    feats = np.fromfile(os.path.join(ROOT, "fixtures", "speech_feats.f32"),
                        np.float32).reshape(-1, 36)
    files = []
    for k, n in enumerate([3 * 12, 2 * 12 + 5]):
        f36 = np.zeros((n, 36), np.float32)
        f36[:, :20] = feats[50 * k:50 * k + n, :20]
        fn = tmp_path / f"in{k}.f32"
        f36.tofile(fn)
        files.append(str(fn))
    flag = ["--fused"] if fused else []
    orig = _interpret("make_fused_encoder_step")
    try:
        assert jtx.main([CKPT, str(tmp_path / "jax")] + files + flag) == 0
    finally:
        jfc.make_fused_encoder_step = orig
    ref_lines = capsys.readouterr().out
    assert tx_batch.main([CKPT, str(tmp_path / "port")] + files + flag
                         + ["--device", "cpu"]) == 0
    assert capsys.readouterr().out == ref_lines
    for k in range(2):
        a = np.fromfile(tmp_path / "port" / f"in{k}_iq.f32", np.complex64)
        b = np.fromfile(tmp_path / "jax" / f"in{k}_iq.f32", np.complex64)
        assert len(a) == len(b) == (3 - k) * 960 + 1152
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)


def _reference_state_dict(glu_naming, nested_gru, rng):
    """A reference-style state_dict (DataParallel prefixes, the decoder's
    GLU gates under one of the three namings the converter reads) of small
    random tensors: the converter checks names, not shapes."""
    def arr(*shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32))

    sd = {}
    for side, prefix in (("encoder", "core_encoder.module."),
                         ("decoder", "core_decoder.module.")):
        sd[prefix + "dense_1.weight"], sd[prefix + "dense_1.bias"] = arr(6, 5), arr(6)
        for i in range(1, 6):
            g = f"gru{i}.gru" if nested_gru else f"gru{i}"
            for n, shape in (("weight_ih_l0", (9, 6)), ("weight_hh_l0", (9, 3)),
                             ("bias_ih_l0", (9,)), ("bias_hh_l0", (9,))):
                sd[f"{prefix}{g}.{n}"] = arr(*shape)
            sd[f"{prefix}conv{i}.conv.weight"] = arr(4, 7, 2)
            sd[f"{prefix}conv{i}.conv.bias"] = arr(4)
            if side == "decoder":
                gate = f"{prefix}glu{i}.gate."
                if glu_naming == "parametrized":
                    sd[gate + "parametrizations.weight.original0"] = arr(4, 1)
                    sd[gate + "parametrizations.weight.original1"] = arr(4, 4)
                elif glu_naming == "weight_norm":
                    sd[gate + "weight_g"], sd[gate + "weight_v"] = arr(4, 1), arr(4, 4)
                else:
                    sd[gate + "weight"] = arr(4, 4)
        out = "output" if side == "decoder" else "z_dense"
        sd[f"{prefix}{out}.weight"], sd[f"{prefix}{out}.bias"] = arr(3, 6), arr(3)
    return sd


@pytest.mark.parametrize("glu_naming, nested_gru", [
    ("parametrized", False), ("weight_norm", True), ("fused", False)])
def test_torch_checkpoint_loader_matches_jax(tmp_path, glu_naming, nested_gru):
    """The port's copy of the .pth loader gives radae_tpu's params tree, from
    a state_dict and from a saved checkpoint."""
    from radae_tpu import convert as jconvert
    from radae_tpu_torch import convert

    def assert_same_tree(a, b):
        assert sorted(a) == sorted(b)
        for k in a:
            if isinstance(a[k], dict):
                assert_same_tree(a[k], b[k])
            else:
                np.testing.assert_array_equal(a[k], b[k])

    sd = _reference_state_dict(glu_naming, nested_gru,
                               np.random.default_rng(3))
    ours = convert.torch_state_dict_to_params(sd)
    assert sorted(ours) == ["decoder", "encoder"]
    assert_same_tree(ours, jconvert.torch_state_dict_to_params(sd))
    path = str(tmp_path / "model.pth")
    torch.save({"state_dict": sd}, path)
    assert_same_tree(convert.load_torch_checkpoint(path),
                     jconvert.load_torch_checkpoint(path))
