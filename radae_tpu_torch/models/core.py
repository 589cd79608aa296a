"""Core RADAE encoder/decoder as stateful functions (port of
`radae_tpu/models/core.py`).

Every network is `(params, x, state) -> (y, state)`, where `state` carries
GRU hidden vectors and causal-conv history under the JAX package's keys
(`gru{i}`: (B, H), `conv{i}`: (B, dilation, in)).  Batch processing is a run
from the zero state; streaming threads the state between calls.

Architecture (DenseNet-style concatenative skip stacks):
  Encoder: 4x10ms feature frames -> dense(64) -> 5x[GRU(64) | conv k2(96)]
           with concat skips -> dense(864 -> latent_dim) [+tanh if bottleneck 1]
  Decoder: dense(96) -> 5x[GRU(96)+GLU | conv k2(32)] -> dense(736 -> 4*out)

8-bit quantization noise n(x) follows every activation where radae_tpu
applies it (reference: radae_base.py:80-81) when `key` is a torch.Generator
on the input's device; key=None turns it off (the serving steps, and every
parity test: torch cannot reproduce jax's stream, so noise is held to its
distribution only).

remat=True (training, radae_tpu's jax.checkpoint) stores for the backward
only each GRU/conv block's input and outputs: the backward runs the blocks
again one at a time, so only one block's activations are held at once.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from .. import resolve_device
from ..ops import draws
from . import layers as L

Params = Dict[str, Any]
State = Dict[str, Any]

FRAMES_PER_STEP = 4

# (in_dim, hidden) per GRU and (in_dim, out_dim, dilation) per conv
_ENC_GRU_DIMS = [(64, 64), (224, 64), (384, 64), (544, 64), (704, 64)]
_ENC_CONV_DIMS = [(128, 96, 1), (288, 96, 2), (448, 96, 2), (608, 96, 2), (768, 96, 2)]
_ENC_CAT_DIM = 864

_DEC_GRU_DIMS = [(96, 96), (224, 96), (352, 96), (480, 96), (608, 96)]
_DEC_CONV_DIMS = [(192, 32, 1), (320, 32, 1), (448, 32, 1), (576, 32, 1), (704, 32, 1)]
_DEC_CAT_DIM = 736


class _NoiseStream:
    """The quantization-noise applications of one call: quant_noise with
    the generator `key` (a torch.Generator or an `ops.draws.BatchRows`), or
    nothing when key is None."""

    def __init__(self, key: Optional[torch.Generator]):
        if key is not None and not isinstance(key, (torch.Generator,
                                                    draws.BatchRows)):
            # radae_tpu takes a jax key here: its stream is not ported
            raise NotImplementedError(
                f"key must be a torch.Generator, BatchRows or None, got "
                f"{type(key).__name__}")
        self.key = key

    def __call__(self, x):
        return x if self.key is None else L.quant_noise(self.key, x)


def _run_block(block, x, key, remat: bool):
    """block(x), or under remat (when a gradient is being recorded) as a
    torch.utils.checkpoint segment that the backward runs again.  The run
    again sets the generator of `key` back to the state the first run
    started from, and restores it after, so it draws the same quantization
    noise (checkpoint's preserve_rng_state covers only the global
    generators)."""
    if not (remat and torch.is_grad_enabled()):
        return block(x)
    run = block
    if key is not None:
        gen = key.gen if isinstance(key, draws.BatchRows) else key
        start, first = gen.get_state(), [True]

        def run(x):
            if first[0]:
                first[0] = False
                return block(x)
            now = gen.get_state()
            gen.set_state(start)
            try:
                return block(x)
            finally:
                gen.set_state(now)
    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


def _zero_state(gru_dims, conv_dims, batch, device, dtype) -> State:
    device = resolve_device(device)
    s: State = {}
    for i, ((_, gh), (cin, _, dil)) in enumerate(zip(gru_dims, conv_dims),
                                                 start=1):
        s[f"gru{i}"] = torch.zeros((batch, gh), dtype=dtype, device=device)
        s[f"conv{i}"] = torch.zeros((batch, dil, cin), dtype=dtype,
                                    device=device)
    return s


class CoreEncoder:
    """Maps vocoder features to latent PSK symbols z."""

    FRAMES_PER_STEP = FRAMES_PER_STEP

    def __init__(self, feature_dim: int, output_dim: int, bottleneck: int = 1):
        self.feature_dim = feature_dim
        self.output_dim = output_dim
        self.bottleneck = bottleneck
        self.input_dim = FRAMES_PER_STEP * feature_dim

    def init(self, seed) -> Params:
        """Random weights (numpy) from an int seed: radae_tpu's
        `CoreEncoder.init(seed)` draw for draw."""
        rng = L.as_rng(seed)
        p: Params = {"dense_1": L.init_dense(rng, self.input_dim, 64)}
        for i, ((gin, gh), (cin, cout, _)) in enumerate(
                zip(_ENC_GRU_DIMS, _ENC_CONV_DIMS), start=1):
            p[f"gru{i}"] = L.init_gru(rng, gin, gh)
            p[f"conv{i}"] = L.init_conv2tap(rng, cin, cout)
        p["z_dense"] = L.init_dense(rng, _ENC_CAT_DIM, self.output_dim)
        return p

    def zero_state(self, batch: int, device="cuda",
                   dtype=torch.float32) -> State:
        return _zero_state(_ENC_GRU_DIMS, _ENC_CONV_DIMS, batch, device, dtype)

    def __call__(self, params: Params, features, key=None,
                 state: Optional[State] = None,
                 remat: bool = False) -> Tuple[torch.Tensor, State]:
        """features (B, T10ms, F), T10ms divisible by 4 ->
        (z (B, T10ms//4, output_dim), new_state)."""
        B, T, F = features.shape
        if state is None:
            state = self.zero_state(B, features.device, features.dtype)
        n = _NoiseStream(key)
        new_state: State = {}
        # group FRAMES_PER_STEP frames into one step (radae_base.py:199)
        x = features.reshape(B, T // FRAMES_PER_STEP, FRAMES_PER_STEP * F)
        x = n(torch.tanh(L.dense(params["dense_1"], x)))
        for i, (_, _, dil) in enumerate(_ENC_CONV_DIMS, start=1):
            def block(x, i=i, dil=dil):
                y, h = L.gru(params[f"gru{i}"], x, state[f"gru{i}"])
                x = torch.cat([x, n(y)], dim=-1)
                y, hist = L.conv2tap(params[f"conv{i}"], x, state[f"conv{i}"],
                                     dilation=dil)
                return torch.cat([x, n(y)], dim=-1), h, hist
            x, new_state[f"gru{i}"], new_state[f"conv{i}"] = _run_block(
                block, x, key, remat)
        z = L.dense(params["z_dense"], x)
        if self.bottleneck == 1:
            z = torch.tanh(z)
        return z, new_state


class CoreDecoder:
    """Reconstructs vocoder features from received latents z_hat."""

    FRAMES_PER_STEP = FRAMES_PER_STEP

    def __init__(self, input_dim: int, output_dim: int):
        self.input_dim = input_dim
        self.output_dim = output_dim

    def init(self, seed) -> Params:
        """Random weights (numpy) from an int seed: radae_tpu's
        `CoreDecoder.init(seed)` draw for draw."""
        rng = L.as_rng(seed)
        p: Params = {"dense_1": L.init_dense(rng, self.input_dim, 96)}
        for i, ((gin, gh), (cin, cout, _)) in enumerate(
                zip(_DEC_GRU_DIMS, _DEC_CONV_DIMS), start=1):
            p[f"gru{i}"] = L.init_gru(rng, gin, gh)
            p[f"glu{i}"] = L.init_glu(rng, gh)
            p[f"conv{i}"] = L.init_conv2tap(rng, cin, cout)
        p["output"] = L.init_dense(rng, _DEC_CAT_DIM,
                                   FRAMES_PER_STEP * self.output_dim)
        return p

    def zero_state(self, batch: int, device="cuda",
                   dtype=torch.float32) -> State:
        return _zero_state(_DEC_GRU_DIMS, _DEC_CONV_DIMS, batch, device, dtype)

    def __call__(self, params: Params, z, key=None,
                 state: Optional[State] = None,
                 remat: bool = False) -> Tuple[torch.Tensor, State]:
        """z (B, Tz, input_dim) -> (features (B, 4*Tz, output_dim), new_state)."""
        B, Tz, _ = z.shape
        if state is None:
            state = self.zero_state(B, z.device, z.dtype)
        n = _NoiseStream(key)
        new_state: State = {}
        x = n(torch.tanh(L.dense(params["dense_1"], z)))
        for i, (_, _, dil) in enumerate(_DEC_CONV_DIMS, start=1):
            def block(x, i=i, dil=dil):
                y, h = L.gru(params[f"gru{i}"], x, state[f"gru{i}"])
                x = torch.cat([x, n(L.glu(params[f"glu{i}"], n(y)))], dim=-1)
                y, hist = L.conv2tap(params[f"conv{i}"], x, state[f"conv{i}"],
                                     dilation=dil)
                return torch.cat([x, n(y)], dim=-1), h, hist
            x, new_state[f"gru{i}"], new_state[f"conv{i}"] = _run_block(
                block, x, key, remat)
        x = L.dense(params["output"], x)
        return x.reshape(B, Tz * FRAMES_PER_STEP, self.output_dim), new_state


def distortion_loss(y_true, y_pred):
    """Feature-domain distortion loss (reference: radae_base.py:50-68).

    Cepstral L2 + pitch-weighted L1 + voicing-correlation L2 (+ auxdata L2
    when 21 features).  Returns the per-sequence loss, shape (B,)."""
    nf = y_true.shape[-1]
    if nf not in (20, 21):
        raise ValueError("distortion loss is designed for 20 or 21 features")
    ceps_error = y_pred[..., :18] - y_true[..., :18]
    pitch_error = 2.0 * (y_pred[..., 18] - y_true[..., 18])
    corr_error = y_pred[..., 19] - y_true[..., 19]
    pitch_weight = torch.relu(y_true[..., 19] + 0.5) ** 2
    # the 1-wide pitch/corr/data terms enter at full weight while the
    # cepstral error enters as its mean (as in the reference)
    loss = (ceps_error ** 2).mean(dim=-1)
    loss = loss + 3.0 * (10.0 / 18.0) * torch.abs(pitch_error) * pitch_weight
    loss = loss + (1.0 / 18.0) * corr_error ** 2
    if nf == 21:
        data_error = y_pred[..., 20] - y_true[..., 20]
        loss = loss + (0.5 / 18.0) * data_error ** 2
    return loss.mean(dim=-1)             # mean over time
