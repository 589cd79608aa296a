"""bf16 weights and bf16 products, and the padded chain-merged layout
(merged="pad"), against radae_tpu on the CPU.

The packing must give radae_tpu's arrays bit for bit: bf16 matrices as the
same uint16 bits, the padded layout (f32 and int8) exactly.  The plain
versions with compute_dtype=torch.bfloat16 are held against radae_tpu's
Pallas kernels with compute_dtype=jnp.bfloat16 in interpret mode over 3
chained calls at rtol 2e-3, atol 2e-3 (the two round the same values to
bf16 and sum the exact products in f32 in another order, so an input that
sits on a bf16 rounding boundary can round the other way), and both stay
within tests/test_fused.py's band of the f32 step (max error < 0.12 and
mean < 0.01 of the f32 output's mean magnitude).  A few elements (the
encoder: up to 7 of 960 a call, the decoder on bf16 weights: 1 of 1008)
miss 2e-3, by up to 0.043 on outputs of mean magnitude 46: flips of bf16
inputs, which the same steps with f32 products do not show
(tests/test_torch_fused_core.py holds those at rtol 1e-4, atol 1e-5).  So
the comparison allows at most 1% of the elements past 2e-3, each within
2^-7 of the output's mean magnitude (a bf16 step), and prints the counts.
The padded plain version
is held against radae_tpu's merged="pad" kernel at rtol 1e-4, atol 1e-5.
The CUDA instances are held against these plain versions on the card by
chip_smoke.py."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.ops import fused_core as jfc
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.ops import fused_core as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
TOL = dict(rtol=1e-4, atol=1e-5)
TOL_BF16 = dict(rtol=2e-3, atol=2e-3)
B = 4
TORCH_DTYPE = {"f32": torch.float32, "bf16": torch.bfloat16}
JAX_DTYPE = {"f32": jnp.float32, "bf16": jnp.bfloat16}


@pytest.fixture(scope="module")
def tree():
    return load_checkpoint(CKPT)[0]


def _bits(a):
    """An array's bits as numpy: uint16 for bf16, else the values."""
    if isinstance(a, torch.Tensor):
        return (a.view(torch.int16).numpy().view(np.uint16)
                if a.dtype == torch.bfloat16 else a.numpy())
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == jnp.bfloat16 else a


def _assert_same_arrays(ours, ref):
    assert len(ours) == len(ref)
    for a, r in zip(ours, ref):
        a, r = _bits(a), _bits(r)
        assert a.dtype == r.dtype and a.shape == r.shape
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("side, kw", [
    ("decoder", {}), ("decoder", {"merged": True}),
    ("decoder", {"merged": "pad"}), ("encoder", {}),
    ("decoder", {"quant": "int8", "quant_exclude": ("whh", "out_w")}),
    ("rx", {})], ids=["unmerged", "merged", "pad", "encoder",
                      "int8-exclude", "rx-frame"])
def test_bf16_weights_equal_jax(tree, side, kw):
    """dtype=bf16: every matrix (and in an int8 set every quant_exclude
    matrix) the same bf16 bits as radae_tpu's, biases and scales f32."""
    if side == "rx":
        ours = fc.fused_rx_weights(tree["decoder"], flagship_config(), "cpu",
                                   dtype=torch.bfloat16)
        ref = jfc.fused_rx_weights(tree["decoder"], jax_flagship_config(),
                                   dtype=jnp.bfloat16)
        arrs = ours.w.arrays[:len(ref)]
        samp = ours.samp         # Wr, Wi: radae_tpu pads 192 rows to 256
        ref = [np.asarray(r)[:samp] for r in ref[:2]] + list(ref[2:])
    elif side == "encoder":
        ours = fc.encoder_weights(tree[side], "cpu", dtype=torch.bfloat16)
        ref = jfc.encoder_weights(tree[side], dtype=jnp.bfloat16)
        arrs = ours.arrays + ours.scales
    else:
        ours = fc.decoder_weights(tree[side], "cpu", dtype=torch.bfloat16, **kw)
        ref = jfc.decoder_weights(tree[side], dtype=jnp.bfloat16, **kw)
        arrs = ours.arrays + ours.scales
    _assert_same_arrays(arrs, ref)
    kinds = {a.dtype for a in arrs if a.dim() == 2}
    assert torch.bfloat16 in kinds and (torch.int8 in kinds) == ("quant" in kw)
    for a in arrs:
        assert a.data_ptr() % 16 == 0


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_pad_weights_equal_jax(tree, quant):
    """merged="pad": the x operands' rows on 128-row segments, zero rows
    between, exactly radae_tpu's (int8: the gap rows are 0 and the column
    scales the merged layout's); the state is the merged one."""
    ours = fc.decoder_weights(tree["decoder"], "cpu", merged="pad", quant=quant)
    ref = jfc.decoder_weights(tree["decoder"], merged="pad", quant=quant)
    _assert_same_arrays(ours.arrays + ours.scales, ref)
    merged = fc.decoder_weights(tree["decoder"], "cpu", merged=True,
                                quant=quant)
    for a, m in zip(ours.scales, merged.scales):
        torch.testing.assert_close(a, m, rtol=0, atol=0)
    assert fc.merged_layout(ours) == "pad" and fc.is_merged(ours)
    assert tuple(ours.arrays[-2].shape) == (1408, 84)
    assert [tuple(s.shape) for s in fc.decoder_state_zero(B, "cpu", "pad")] \
        == [tuple(s.shape) for s in fc.decoder_state_zero(B, "cpu", True)]


def _bf16_close(what, got, ref):
    """got against ref at TOL_BF16, but for at most 1% of the elements
    (bf16 input flips), each within 2^-7 of max(1, ref's mean magnitude);
    returns the max abs err."""
    err = np.abs(got - ref)
    over = err > TOL_BF16["atol"] + TOL_BF16["rtol"] * np.abs(ref)
    scale = max(float(np.abs(ref).mean()), 1.0)
    if over.any():
        print(f"{what}: {int(over.sum())} of {err.size} past 2e-3, max "
              f"{float(err.max()):.3g} (scale {scale:.3g})")
    assert over.sum() <= 0.01 * err.size and err.max() < 2.0 ** -7 * scale, \
        (what, int(over.sum()), float(err.max()), scale)
    return float(err.max())


def _f32_band(what, got, ref):
    """tests/test_fused.py's band of the f32 step: max < 0.12 and mean <
    0.01 of max(1, the f32 output's mean magnitude)."""
    err = (got - ref).abs()
    scale = max(float(ref.abs().mean()), 1.0)
    print(f"{what}: max abs err against the f32 step {float(err.max()):.3g}, "
          f"mean {float(err.mean()):.3g} (scale {scale:.3g})")
    assert float(err.max()) < 0.12 * scale and float(err.mean()) < 0.01 * scale


# body -> (weight dtype, quant); the decoder on each weight kind the
# bf16-product instance takes, the merged decoder in both layouts, the frame
# and encoder
BODIES = {"decoder-f32w": ("f32", None), "decoder-bf16w": ("bf16", None),
          "decoder-int8": ("f32", "int8"), "merged": ("f32", None),
          "frame": ("f32", None), "encoder": ("f32", None),
          "merged-pad": ("f32", None)}
# the merged bodies' layouts (merged=)
LAYOUTS = {"merged": True, "merged-pad": "pad"}


@pytest.mark.parametrize("body", list(BODIES))
def test_bf16_plain_matches_pallas_interpret(tree, body):
    """3 chained calls with carried state: outputs and every state tensor
    against radae_tpu's kernel with compute_dtype=bf16, the output also
    against the port's f32 step."""
    dt, quant = BODIES[body]
    rng = np.random.default_rng(13)
    bf = torch.bfloat16
    if body == "frame":
        cfg, jcfg = flagship_config(), jax_flagship_config()
        w = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
        jw = jfc.fused_rx_weights(tree["decoder"], jcfg)
        step = jfc.make_fused_rx_frame_step(jcfg, B, tile=4, interpret=True,
                                            compute_dtype=jnp.bfloat16)
        st = st32 = fc.decoder_state_zero(B, "cpu")
        jst = jfc.decoder_state_zero(B)
        ours = lambda x, s: fc.rx_frame_step_plain(w, x, s, bf)
        f32 = lambda x, s: fc.rx_frame_step_plain(w, x, s)
        n = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)
        draw = lambda: (0.5 * rng.standard_normal((B, n, 2))).astype(np.float32)
    elif body == "encoder":
        w = fc.encoder_weights(tree["encoder"], "cpu")
        jw = jfc.encoder_weights(tree["encoder"])
        step = jfc.make_fused_encoder_step(21, 80, B, tile=4, interpret=True,
                                           compute_dtype=jnp.bfloat16)
        st = st32 = fc.encoder_state_zero(B, "cpu")
        jst = jfc.encoder_state_zero(B)
        ours = lambda x, s: fc.encoder_step_plain(w, x, s, 3, bf)
        f32 = lambda x, s: fc.encoder_step_plain(w, x, s)
        draw = lambda: (0.3 * rng.standard_normal((B, 12, 21))).astype(np.float32)
    else:
        merged = LAYOUTS.get(body, False)
        w = fc.decoder_weights(tree["decoder"], "cpu", merged=merged,
                               quant=quant, dtype=TORCH_DTYPE[dt])
        w32 = fc.decoder_weights(tree["decoder"], "cpu", merged=merged)
        jw = jfc.decoder_weights(tree["decoder"], merged=merged, quant=quant,
                                 dtype=JAX_DTYPE[dt])
        step = jfc.make_fused_decoder_step(80, 21, B, tile=4, interpret=True,
                                           quant=quant, merged=merged,
                                           compute_dtype=jnp.bfloat16)
        st = st32 = fc.decoder_state_zero(B, "cpu", merged=merged)
        jst = jfc.decoder_state_zero(B, merged=merged)
        plain = (fc.decoder_merged_step_plain if merged
                 else fc.decoder_step_plain)
        ours = lambda x, s: plain(w, x, s, bf)
        f32 = lambda x, s: plain(w32, x, s)
        draw = lambda: np.tanh(rng.standard_normal((B, 3, 80))).astype(np.float32)
    step = jax.jit(step)     # one trace for the 3 calls
    worst = 0.0
    for call in range(3):
        x = draw()
        y, st = ours(torch.as_tensor(x), st)
        y32, st32 = f32(torch.as_tensor(x), st32)
        ref = step(jw, x, *jst)
        jst = ref[1]
        if body == "encoder":      # radae_tpu's flat 128-padded rings
            ref_st = [np.asarray(h) for h in jst[:5]] + [
                np.asarray(r).reshape(B, s.shape[1], -1)[:, :, :s.shape[2]]
                for r, s in zip(jst[5:], st[5:])]
        else:
            ref_st = [np.asarray(r) for r in jst]
        for i, (a, r) in enumerate(zip((y,) + tuple(st),
                                       [np.asarray(ref[0])] + ref_st)):
            worst = max(worst, _bf16_close(f"{body} call {call} [{i}]",
                                           a.numpy(), r))
        _f32_band(f"{body} call {call} (port)", y, y32)
        _f32_band(f"{body} call {call} (radae_tpu)",
                  torch.as_tensor(np.array(ref[0])), y32)
    print(f"{body}: max abs err against radae_tpu's bf16 kernel {worst:.3g}")


@pytest.mark.parametrize("quant", [None, "int8"], ids=["f32", "int8"])
def test_pad_plain_matches_pallas_interpret(tree, quant):
    """The padded plain version against radae_tpu's merged="pad" kernel,
    3 chained calls, features and all 15 state tensors; and the merged
    plain version on the same inputs (the same math, sums reassociated)."""
    rng = np.random.default_rng(17)
    w = fc.decoder_weights(tree["decoder"], "cpu", merged="pad", quant=quant)
    wm = fc.decoder_weights(tree["decoder"], "cpu", merged=True, quant=quant)
    jw = jfc.decoder_weights(tree["decoder"], merged="pad", quant=quant)
    step = jax.jit(jfc.make_fused_decoder_step(80, 21, B, tile=4,
                                               interpret=True, quant=quant,
                                               merged="pad"))
    st = stm = fc.decoder_state_zero(B, "cpu", merged="pad")
    jst = jfc.decoder_state_zero(B, merged="pad")
    for _ in range(3):
        z = np.tanh(rng.standard_normal((B, 3, 80))).astype(np.float32)
        y, st = fc.decoder_merged_step_plain(w, torch.as_tensor(z), st)
        ym, stm = fc.decoder_merged_step_plain(wm, torch.as_tensor(z), stm)
        f_ref, jst = step(jw, z, *jst)
        np.testing.assert_allclose(y.numpy(), np.asarray(f_ref), **TOL)
        assert len(st) == len(jst) == 15
        for s, r, m in zip(st, jst, stm):
            np.testing.assert_allclose(s.numpy(), np.asarray(r), **TOL)
            torch.testing.assert_close(s, m, **TOL)
        torch.testing.assert_close(y, ym, **TOL)


@pytest.mark.parametrize("form", ["rx-bf16", "rx-pad", "rx-merged-bf16"])
def test_runtime_steps_match_jax_unfused(tree, form):
    """make_streaming_rx_step with fused_dtype=bf16 (unmerged on bf16
    weights, merged on f32 weights) and with fused_merged="pad", against
    radae_tpu's unfused step over 3 chained frames: pad at rtol 1e-4, atol
    1e-5, bf16 within the f32 band."""
    from radae_tpu import runtime as jrt
    from radae_tpu.models.core import CoreDecoder as JDec
    from radae_tpu_torch import runtime
    from radae_tpu_torch.models.core import CoreDecoder
    cfg = flagship_config()
    rng = np.random.default_rng(19)
    bf16 = form.endswith("bf16")
    jstep = jrt.make_streaming_rx_step(jax_flagship_config(), JDec(80, 21), B)
    merged = "merged" in form if bf16 else "pad"
    step = runtime.make_streaming_rx_step(
        cfg, CoreDecoder(80, 21), B, fused=True, fused_merged=merged,
        fused_dtype=torch.bfloat16 if bf16 else None, device="cpu")
    w = fc.decoder_weights(tree["decoder"], "cpu", merged=merged,
                           dtype=torch.bfloat16 if form == "rx-bf16"
                           else torch.float32)
    jp, st = tree["decoder"], fc.decoder_state_zero(B, "cpu", merged)
    jst = None
    for k in range(3):
        x = (0.5 * rng.standard_normal(
            (B, cfg.Nmf + cfg.M + cfg.Ncp, 2))).astype(np.float32)
        y, st = step(w, torch.as_tensor(x), st)
        y_ref, jst = jstep(jp, x, jst)
        if bf16:
            _f32_band(f"{form} frame {k}", y, torch.as_tensor(np.array(y_ref)))
        else:
            np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    # a weight set of another layout raises before any launch
    if form == "rx-pad":
        with pytest.raises(ValueError, match="fused_merged='pad'"):
            step(fc.decoder_weights(tree["decoder"], "cpu", merged=True),
                 torch.as_tensor(x), st)
        rx_m = runtime.make_streaming_rx_step(cfg, CoreDecoder(80, 21), B,
                                              fused=True, fused_merged=True,
                                              device="cpu")
        with pytest.raises(ValueError, match="fused_merged=True"):
            rx_m(w, torch.as_tensor(x), st)
