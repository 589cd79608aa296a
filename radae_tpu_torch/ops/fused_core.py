"""Fused core codec steps: the whole recurrent encoder or decoder stack for
nz latent steps in one CUDA kernel (port of `radae_tpu/ops/fused_core.py`,
unmerged f32 forms).

`fused_decoder_step` / `fused_encoder_step` launch the hand-written kernels
of `csrc/fused_core.cu` for CUDA tensors and run their plain PyTorch
versions (`decoder_step_plain` / `encoder_step_plain`, the same math in the
order of the Pallas kernels) for CPU tensors.  There is no fallback: a
CUDA tensor goes to the kernel or the call raises.

Weights are packed once, pre-transposed to (in, out), into one contiguous
f32 buffer; the kernel takes the buffer plus the offset of each array.
State is a tuple of 10 tensors in the unmerged layout:
  decoder: 5 GRU h (B, 96) + 5 conv histories (B, in) (dilation 1)
  encoder: 5 GRU h (B, 64) + 5 conv history rings (B, d, in), oldest first
(the `CoreDecoder` / `CoreEncoder` state squeezed or kept per layer).
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..models.core import (
    _DEC_CONV_DIMS, _DEC_GRU_DIMS, _ENC_CONV_DIMS, _ENC_GRU_DIMS,
    FRAMES_PER_STEP)
from .. import resolve_device
from . import _kernels

# kernel launches per wrapper since the last reset_launches()
LAUNCHES = {"fused_decoder_step": 0, "fused_encoder_step": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PackedWeights(NamedTuple):
    """Weights of one fused stack in one contiguous f32 buffer."""
    buf: torch.Tensor            # (n,) float32
    offsets: Tuple[int, ...]     # start of each array in buf (16-byte aligned)
    arrays: Tuple[torch.Tensor, ...]   # views of buf, in kernel order
    names: Tuple[str, ...]


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _fused_weights(params: Dict[str, Any], side: str, device) -> PackedWeights:
    """Flatten a decoder/encoder param tree (numpy or torch leaves) into the
    order of radae_tpu's `_fused_weights` (f32, unmerged): d1_w, d1_b, per
    layer g_wih, g_whh, g_bih, g_bhh, [glu_w,] c_w0, c_w1, c_b, then
    out_w, out_b.  Matrices are transposed to (in, out)."""
    arrs, names = [], []

    def add(name, a):
        arrs.append(np.ascontiguousarray(a, np.float32))
        names.append(name)

    def addT(name, a):
        add(name, _np(a).T)

    addT("d1_w", params["dense_1"]["w"]); add("d1_b", _np(params["dense_1"]["b"]))
    for i in range(1, 6):
        g = params[f"gru{i}"]
        addT(f"g{i}_wih", g["w_ih"]); addT(f"g{i}_whh", g["w_hh"])
        add(f"g{i}_bih", _np(g["b_ih"])); add(f"g{i}_bhh", _np(g["b_hh"]))
        if side == "decoder":
            glu = params[f"glu{i}"]
            v, gg = _np(glu["v"]), _np(glu["g"])
            addT(f"glu{i}_w",
                 gg[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True))
        cw = _np(params[f"conv{i}"]["w"])
        addT(f"c{i}_w0", cw[:, :, 0]); addT(f"c{i}_w1", cw[:, :, 1])
        add(f"c{i}_b", _np(params[f"conv{i}"]["b"]))
    out = params["output" if side == "decoder" else "z_dense"]
    addT("out_w", out["w"]); add("out_b", _np(out["b"]))

    offsets, n = [], 0
    for a in arrs:
        offsets.append(n)
        n += -(-a.size // 4) * 4          # keep every start 16-byte aligned
    flat = np.zeros(n, np.float32)
    for o, a in zip(offsets, arrs):
        flat[o:o + a.size] = a.ravel()
    buf = torch.as_tensor(flat, device=resolve_device(device))
    views = tuple(buf[o:o + a.size].view(a.shape)
                  for o, a in zip(offsets, arrs))
    return PackedWeights(buf, tuple(offsets), views, tuple(names))


def decoder_weights(params, device="cuda") -> PackedWeights:
    return _fused_weights(params, "decoder", device)


def encoder_weights(params, device="cuda") -> PackedWeights:
    return _fused_weights(params, "encoder", device)


def decoder_state_zero(batch, device="cuda"):
    dev = resolve_device(device)
    s = [torch.zeros((batch, gh), device=dev) for _, gh in _DEC_GRU_DIMS]
    s += [torch.zeros((batch, cin), device=dev)
          for cin, _, _ in _DEC_CONV_DIMS]
    return tuple(s)


def encoder_state_zero(batch, device="cuda"):
    dev = resolve_device(device)
    s = [torch.zeros((batch, gh), device=dev) for _, gh in _ENC_GRU_DIMS]
    s += [torch.zeros((batch, d, cin), device=dev)
          for cin, _, d in _ENC_CONV_DIMS]
    return tuple(s)


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' reference)
# ---------------------------------------------------------------------------

def _gru_step(w_ih, b_ih, w_hh, b_hh, x, h):
    xg = x @ w_ih + b_ih
    hg = h @ w_hh + b_hh
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1.0 - z) * n + z * h


def decoder_step_plain(weights: PackedWeights, z, state):
    """z (B, nz, latent) -> (features (B, 4*nz, F), new_state)."""
    w = weights.arrays
    B, nz, _ = z.shape
    h, hist = list(state[:5]), list(state[5:])
    outs = []
    for step in range(nz):
        x = torch.tanh(z[:, step] @ w[0] + w[1])
        for i in range(5):
            wih, whh, bih, bhh, gluw, cw0, cw1, cb = w[2 + 8 * i:10 + 8 * i]
            h[i] = _gru_step(wih, bih, whh, bhh, x, h[i])
            x = torch.cat([x, h[i] * torch.sigmoid(h[i] @ gluw)], dim=-1)
            yc = torch.tanh(hist[i] @ cw0 + x @ cw1 + cb)
            hist[i] = x
            x = torch.cat([x, yc], dim=-1)
        outs.append(x @ w[-2] + w[-1])
    feats = torch.stack(outs, dim=1)
    F = feats.shape[-1] // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(h + hist)


def encoder_step_plain(weights: PackedWeights, feats, state, bottleneck=3):
    """feats (B, 4*nz, F) -> (z (B, nz, latent), new_state)."""
    w = weights.arrays
    B, T, F = feats.shape
    nz = T // FRAMES_PER_STEP
    f = feats.reshape(B, nz, FRAMES_PER_STEP * F)
    h, hist = list(state[:5]), list(state[5:])
    outs = []
    for step in range(nz):
        x = torch.tanh(f[:, step] @ w[0] + w[1])
        for i in range(5):
            wih, whh, bih, bhh, cw0, cw1, cb = w[2 + 7 * i:9 + 7 * i]
            h[i] = _gru_step(wih, bih, whh, bhh, x, h[i])
            x = torch.cat([x, h[i]], dim=-1)
            yc = torch.tanh(hist[i][:, 0] @ cw0 + x @ cw1 + cb)
            hist[i] = torch.cat([hist[i][:, 1:], x[:, None]], dim=1)
            x = torch.cat([x, yc], dim=-1)
        zk = x @ w[-2] + w[-1]
        outs.append(torch.tanh(zk) if bottleneck == 1 else zk)
    return torch.stack(outs, dim=1), tuple(h + hist)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

def _ready(t: torch.Tensor, shape, dev, what) -> torch.Tensor:
    if t.device != dev or t.dtype != torch.float32:
        raise ValueError(f"{what}: expected float32 on {dev}, got "
                         f"{t.dtype} on {t.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{what}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _ptrs(ts):
    return (ctypes.c_void_p * len(ts))(*[t.data_ptr() for t in ts])


def _launch(fn, weights: PackedWeights, x, out, state, new_state, args):
    offs = (ctypes.c_int * len(weights.offsets))(*weights.offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(weights.buf.data_ptr(), ctypes.addressof(offs),
                  len(weights.offsets), x.data_ptr(), out.data_ptr(), *args,
                  _ptrs(state[:5]), _ptrs(state[5:]),
                  _ptrs(new_state[:5]), _ptrs(new_state[5:]), stream)


def fused_decoder_step(weights: PackedWeights, z, state):
    """Decoder stack for nz z-steps: z (B, nz, latent) ->
    (features (B, 4*nz, F), new_state).  CPU tensors take the plain
    version; CUDA tensors launch the kernel (radae_fused_decoder_step)."""
    if z.device.type == "cpu":
        return decoder_step_plain(weights, z, state)
    if z.device.type != "cuda":
        raise ValueError(f"fused_decoder_step: unsupported device {z.device}")
    dev = z.device
    B, nz, latent = z.shape
    out_dim = weights.arrays[-1].shape[0]
    if weights.buf.device != dev or len(weights.arrays) != 44:
        raise ValueError("fused_decoder_step: weights must come from "
                         f"decoder_weights(params, device={str(dev)!r})")
    z = _ready(z, (B, nz, latent), dev, "z")
    shapes = ([(B, gh) for _, gh in _DEC_GRU_DIMS]
              + [(B, cin) for cin, _, _ in _DEC_CONV_DIMS])
    state = [_ready(s, sh, dev, f"state[{i}]")
             for i, (s, sh) in enumerate(zip(state, shapes))]
    feats = torch.empty((B, nz, out_dim), device=dev)
    new_state = [torch.empty(sh, device=dev) for sh in shapes]
    lib = _kernels.library("fused_core")
    status = _launch(lib.radae_fused_decoder_step, weights, z, feats, state,
                     new_state, (B, nz, latent, out_dim))
    _kernels.check(status, "radae_fused_decoder_step")
    LAUNCHES["fused_decoder_step"] += 1
    F = out_dim // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(new_state)


def fused_encoder_step(weights: PackedWeights, feats, state, bottleneck=3):
    """Encoder stack: feats (B, 4*nz, F) -> (z (B, nz, latent), new_state).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (radae_fused_encoder_step)."""
    if feats.device.type == "cpu":
        return encoder_step_plain(weights, feats, state, bottleneck)
    if feats.device.type != "cuda":
        raise ValueError(f"fused_encoder_step: unsupported device {feats.device}")
    dev = feats.device
    B, T, F = feats.shape
    nz = T // FRAMES_PER_STEP
    if T % FRAMES_PER_STEP:
        raise ValueError(f"fused_encoder_step: {T} frames is not a multiple "
                         f"of {FRAMES_PER_STEP}")
    latent = weights.arrays[-1].shape[0]
    if weights.buf.device != dev or len(weights.arrays) != 39:
        raise ValueError("fused_encoder_step: weights must come from "
                         f"encoder_weights(params, device={str(dev)!r})")
    x = _ready(feats, (B, T, F), dev, "feats")
    shapes = ([(B, gh) for _, gh in _ENC_GRU_DIMS]
              + [(B, d, cin) for cin, _, d in _ENC_CONV_DIMS])
    state = [_ready(s, sh, dev, f"state[{i}]")
             for i, (s, sh) in enumerate(zip(state, shapes))]
    z = torch.empty((B, nz, latent), device=dev)
    new_state = [torch.empty(sh, device=dev) for sh in shapes]
    lib = _kernels.library("fused_core")
    status = _launch(lib.radae_fused_encoder_step, weights, x, z, state,
                     new_state, (B, nz, FRAMES_PER_STEP * F, latent,
                                 int(bottleneck)))
    _kernels.check(status, "radae_fused_encoder_step")
    LAUNCHES["fused_encoder_step"] += 1
    return z, tuple(new_state)
