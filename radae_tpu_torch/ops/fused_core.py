"""Fused core codec steps: the whole recurrent encoder or decoder stack for
nz latent steps in one CUDA kernel, and the whole rx frame (OFDM demod,
LS pilot EQ, coarse magnitude, demap and decoder) in one more (port of
`radae_tpu/ops/fused_core.py`, f32 forms).

`fused_decoder_step` / `fused_encoder_step` / `fused_rx_frame_step` launch
the hand-written kernels of `csrc/fused_core.cu` for CUDA tensors and run
their plain PyTorch versions (`decoder_step_plain`,
`decoder_merged_step_plain`, `encoder_step_plain`, `rx_frame_step_plain`:
the same math in the order of the Pallas kernels) for CPU tensors.  There
is no fallback: a CUDA tensor goes to the kernel or the call raises.

Weights are packed once, pre-transposed to (in, out), into one contiguous
f32 buffer; the kernel takes the buffer plus the offset of each array.
The decoder comes in two layouts (`decoder_weights(merged=...)`):
  unmerged: per layer wih, whh, bih, bhh, glu, conv tap 0, tap 1, bias;
  merged:   per layer wih, wgg = [whh | glu], bih, bhh, cw = [tap1 | tap0],
            bias (the TPU's chain-merged form: 17 serial products a z-step
            instead of 27).
State is a tuple of tensors:
  decoder, unmerged: 5 GRU h (B, 96) + 5 conv histories (B, in)
  decoder, merged:   5 GRU h (B, 96) + 5 projected hh rows h @ whh (B, 288)
                     + 5 projected conv tap-0 rows hist @ tap0 (B, 32); the
                     biases are added where the projections are used, so
                     the zero state is all zeros in both layouts
  encoder:           5 GRU h (B, 64) + 5 conv history rings (B, d, in),
                     oldest first
(the `CoreDecoder` / `CoreEncoder` state squeezed or kept per layer).  A
merged and an unmerged run from zero give the same features, but their
states are not interchangeable.
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
from .pilots import LOCAL_PATH_DELAY_S, ls_pmat, window3_index

# kernel launches per kernel since the last reset_launches()
LAUNCHES = {"fused_decoder_step": 0, "fused_decoder_merged_step": 0,
            "fused_rx_frame_step": 0, "fused_encoder_step": 0}
N_DEC, N_DEC_MERGED, N_ENC = 2 + 5 * 8 + 2, 2 + 5 * 6 + 2, 2 + 5 * 7 + 2


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


def _fused_arrays(params: Dict[str, Any], side: str, merged=False):
    """Flatten a decoder/encoder param tree (numpy or torch leaves) into the
    order of radae_tpu's `_fused_weights` (f32): d1_w, d1_b, per layer
    g_wih, g_whh, g_bih, g_bhh, [glu_w,] c_w0, c_w1, c_b (merged, decoder
    only: g_wih, g_wgg, g_bih, g_bhh, c_w, c_b), then out_w, out_b.
    Matrices are transposed to (in, out).  Returns (arrays, names)."""
    if merged and side != "decoder":
        raise ValueError("the merged layout is decoder-only")
    arrs, names = [], []

    def add(name, a):
        arrs.append(np.ascontiguousarray(a, np.float32))
        names.append(name)

    def addT(name, a):
        add(name, _np(a).T)

    addT("d1_w", params["dense_1"]["w"]); add("d1_b", _np(params["dense_1"]["b"]))
    for i in range(1, 6):
        g = params[f"gru{i}"]
        cw = _np(params[f"conv{i}"]["w"])
        if side == "decoder":
            glu = params[f"glu{i}"]
            v, gg = _np(glu["v"]), _np(glu["g"])
            glu_w = gg[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
        if merged:
            addT(f"g{i}_wih", g["w_ih"])
            add(f"g{i}_wgg", np.concatenate([_np(g["w_hh"]).T, glu_w.T], axis=1))
            add(f"g{i}_bih", _np(g["b_ih"])); add(f"g{i}_bhh", _np(g["b_hh"]))
            add(f"c{i}_w", np.concatenate([cw[:, :, 1].T, cw[:, :, 0].T], axis=1))
            add(f"c{i}_b", _np(params[f"conv{i}"]["b"]))
            continue
        addT(f"g{i}_wih", g["w_ih"]); addT(f"g{i}_whh", g["w_hh"])
        add(f"g{i}_bih", _np(g["b_ih"])); add(f"g{i}_bhh", _np(g["b_hh"]))
        if side == "decoder":
            addT(f"glu{i}_w", glu_w)
        addT(f"c{i}_w0", cw[:, :, 0]); addT(f"c{i}_w1", cw[:, :, 1])
        add(f"c{i}_b", _np(params[f"conv{i}"]["b"]))
    out = params["output" if side == "decoder" else "z_dense"]
    addT("out_w", out["w"]); add("out_b", _np(out["b"]))
    return arrs, names


def _pack(arrs, names, device) -> PackedWeights:
    """Copy arrays into one f32 buffer on `device`, every start 16-byte
    aligned."""
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


def decoder_weights(params, device="cuda", merged=False) -> PackedWeights:
    """The decoder's fused weights, unmerged (44 arrays) or chain-merged
    (34 arrays, radae_tpu's `decoder_weights(merged=True)`)."""
    return _pack(*_fused_arrays(params, "decoder", merged), device)


def encoder_weights(params, device="cuda") -> PackedWeights:
    return _pack(*_fused_arrays(params, "encoder"), device)


def is_merged(weights: PackedWeights) -> bool:
    return len(weights.arrays) == N_DEC_MERGED


def _dec_state_shapes(batch, merged=False):
    s = [(batch, gh) for _, gh in _DEC_GRU_DIMS]
    if merged:
        s += [(batch, 3 * gh) for _, gh in _DEC_GRU_DIMS]
        s += [(batch, co) for _, co, _ in _DEC_CONV_DIMS]
    else:
        s += [(batch, cin) for cin, _, _ in _DEC_CONV_DIMS]
    return s


def decoder_state_zero(batch, device="cuda", merged=False):
    """Zero decoder state: 10 tensors, or 15 in the merged layout (whose
    projections of a zero state are zero too)."""
    dev = resolve_device(device)
    return tuple(torch.zeros(sh, device=dev)
                 for sh in _dec_state_shapes(batch, merged))


def encoder_state_zero(batch, device="cuda"):
    dev = resolve_device(device)
    s = [torch.zeros((batch, gh), device=dev) for _, gh in _ENC_GRU_DIMS]
    s += [torch.zeros((batch, d, cin), device=dev)
          for cin, _, d in _ENC_CONV_DIMS]
    return tuple(s)


def rx_demod_consts(cfg, device="cuda"):
    """The OFDM receive front end folded into matrices (radae_tpu's
    `rx_demod_consts` without the TPU's 256-row lane pad):

    * Wr, Wi (M+Ncp, Nc): the forward DFT with the CP strip at
      Ncp+time_offset folded in as zero rows, so `symbol_row @ W` is
      strip_cp + dft;
    * Er, Ei (Nc, Nc): the whole LS pilot estimator (known-pilot ratio,
      3-carrier window, per-carrier LS projection, 2-ray recombination),
      which is linear in the received pilot row."""
    M, Ncp, Nc = cfg.M, cfg.Ncp, cfg.Nc
    st = Ncp + cfg.time_offset
    if not (0 <= st and st + M <= M + Ncp):
        raise ValueError(f"time_offset {cfg.time_offset} leaves the symbol")
    Wbig = np.zeros((M + Ncp, Nc), np.complex64)
    Wbig[st:st + M] = cfg.Wfwd

    idx = window3_index(Nc)
    Pmat = ls_pmat(cfg.w, cfg.Fs)
    a = LOCAL_PATH_DELAY_S * cfg.Fs
    phase = np.exp(-1j * np.asarray(cfg.w) * a)
    invP = 1.0 / np.asarray(cfg.P)
    E = np.zeros((Nc, Nc), np.complex64)
    for c in range(Nc):
        for k in range(3):
            j = idx[c, k]
            E[j, c] += invP[j] * (Pmat[c, 0, k] + Pmat[c, 1, k] * phase[c])

    dev = resolve_device(device)
    return tuple(torch.as_tensor(np.ascontiguousarray(x, np.float32),
                                 device=dev)
                 for x in (Wbig.real, Wbig.imag, E.real, E.imag))


def _frame_y_width(nc: int) -> int:
    """Floats of the frame kernel's [Yr | Yi] row: 2Nc rounded up to a
    multiple of 4."""
    return -(-2 * nc // 4) * 4


class RxFrameWeights(NamedTuple):
    """`fused_rx_weights`: one buffer holding Wr, Wi, Er, Ei, the 44
    unmerged decoder arrays with dense_1's rows permuted, and the two
    real block matrices the frame kernel multiplies by; plus the modem
    scalars of the frame step."""
    w: PackedWeights
    n_sym: int          # symbol rows a frame: Ns + 2 (pilot, data, pilot)
    samp: int           # samples a symbol row: M + Ncp
    mag_k: float        # coarse-magnitude scale: |P0| / pilot_gain at bottleneck 3
    coarse_mag: bool

    @property
    def geometry(self) -> Tuple[int, int, int, int, int]:
        """(Ns, Nc, M+Ncp, latent, nz): the modem geometry the frame
        kernel is launched with."""
        ns, nc = self.n_sym - 2, self.w.arrays[0].shape[1]
        latent = self.w.arrays[4].shape[0]
        return ns, nc, self.samp, latent, 2 * ns * nc // latent

    @property
    def decoder(self) -> PackedWeights:
        """The decoder part, as `decoder_weights` lays it out."""
        sl = slice(4, 4 + N_DEC)
        w = self.w
        return PackedWeights(w.buf, w.offsets[sl], w.arrays[sl], w.names[sl])


def fused_rx_weights(params, cfg, device="cuda") -> RxFrameWeights:
    """Demod constants + decoder weights for the frame step.  dense_1's
    rows are permuted so the step feeds [re(0..L/2-1), im(0..L/2-1)]
    instead of the interleaved QPSK demap (the interleave is folded into
    the product).  Two more arrays give the kernel its layout, with 2Nc
    padded to yw, a multiple of 4 (the kernel's float4 columns):
      dft_w (2(M+Ncp), yw): interleaved IQ of a symbol row -> [Yr | Yi | 0];
      ls_w (yw, yw): [Yr | Yi | 0] of a pilot row -> [hr | hi | 0] (zero
      rows and columns at the pad)."""
    Wr, Wi, Er, Ei = (t.numpy() for t in rx_demod_consts(cfg, "cpu"))
    arrs, names = _fused_arrays(params, "decoder")
    L = arrs[0].shape[0]
    perm = np.concatenate([np.arange(0, L, 2), np.arange(1, L, 2)])
    arrs[0] = np.ascontiguousarray(arrs[0][perm])
    S, Nc = Wr.shape
    yw = _frame_y_width(Nc)
    dft_w = np.zeros((2 * S, yw), np.float32)
    dft_w[0::2, :Nc], dft_w[1::2, :Nc] = Wr, -Wi
    dft_w[0::2, Nc:2 * Nc], dft_w[1::2, Nc:2 * Nc] = Wi, Wr
    ls_w = np.zeros((yw, yw), np.float32)
    ls_w[:2 * Nc, :2 * Nc] = np.block([[Er, Ei], [-Ei, Er]])
    packed = _pack([Wr, Wi, Er, Ei] + arrs + [dft_w, ls_w],
                   ["Wr", "Wi", "Er", "Ei"] + names + ["dft_w", "ls_w"],
                   device)
    mag_k = (float(np.abs(cfg.P[0])) / cfg.pilot_gain
             if cfg.bottleneck == 3 else 1.0)
    return RxFrameWeights(packed, cfg.Ns + 2, cfg.M + cfg.Ncp, mag_k,
                          bool(cfg.coarse_mag))


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


def decoder_merged_step_plain(weights: PackedWeights, z, state):
    """The chain-merged decoder (radae_tpu's `kernel_merged`): z (B, nz,
    latent) -> (features (B, 4*nz, F), new 15-tensor state).  hg is the
    carried hh projection plus b_hh; h @ [whh | glu] gives the next
    step's projection and this step's GLU gate; x @ [tap1 | tap0] gives
    this step's tap 1 and the next step's tap 0 (no bias until used)."""
    w = weights.arrays
    B, nz, _ = z.shape
    h, hgp, hpp = list(state[:5]), list(state[5:10]), list(state[10:])
    outs = []
    for step in range(nz):
        x = torch.tanh(z[:, step] @ w[0] + w[1])
        for i in range(5):
            wih, wgg, bih, bhh, cw, cb = w[2 + 6 * i:8 + 6 * i]
            H, co = h[i].shape[-1], cb.shape[0]
            xg = x @ wih + bih
            hg = hgp[i] + bhh
            r = torch.sigmoid(xg[:, :H] + hg[:, :H])
            zz = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
            n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
            h[i] = (1.0 - zz) * n + zz * h[i]
            gh = h[i] @ wgg
            hgp[i] = gh[:, :3 * H]
            x = torch.cat([x, h[i] * torch.sigmoid(gh[:, 3 * H:])], dim=-1)
            cc = x @ cw
            yc = torch.tanh(hpp[i] + cc[:, :co] + cb)
            hpp[i] = cc[:, co:]
            x = torch.cat([x, yc], dim=-1)
        outs.append(x @ w[-2] + w[-1])
    feats = torch.stack(outs, dim=1)
    F = feats.shape[-1] // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(h + hgp + hpp)


def rx_frame_step_plain(weights: RxFrameWeights, rx_packed, state):
    """One whole rx frame (radae_tpu's `make_fused_rx_frame_step` kernel,
    in its order): rx_packed (B, (Ns+2)(M+Ncp), 2) -> (features (B, 4*nz,
    F), new unmerged decoder state).  DFT of every symbol row, LS pilot
    estimates of the two pilot rows, coarse magnitude, linear pilot
    interpolation with phase EQ, then the decoder on [re | im] latents."""
    Wr, Wi, Er, Ei = weights.w.arrays[:4]
    B = rx_packed.shape[0]
    n_sym, Ns = weights.n_sym, weights.n_sym - 2
    rx = rx_packed.reshape(B, n_sym, weights.samp, 2)
    xr, xi = rx[..., 0], rx[..., 1]
    Yr = xr @ Wr - xi @ Wi                         # (B, n_sym, Nc)
    Yi = xr @ Wi + xi @ Wr

    def ls(s):
        return (Yr[:, s] @ Er - Yi[:, s] @ Ei, Yr[:, s] @ Ei + Yi[:, s] @ Er)

    (hp0r, hp0i), (hp1r, hp1i) = ls(0), ls(n_sym - 1)
    if weights.coarse_mag:
        p2 = hp0r * hp0r + hp0i * hp0i + hp1r * hp1r + hp1i * hp1i
        mag = (torch.sqrt(0.5 * p2.mean(dim=-1, keepdim=True)) + 1e-6) \
            * weights.mag_k
        inv_mag = 1.0 / mag
    else:
        inv_mag = 1.0
    dr, di = [], []
    for s in range(1, Ns + 1):
        t = s / (Ns + 1)
        hr = hp0r * (1.0 - t) + hp1r * t
        hi = hp0i * (1.0 - t) + hp1i * t
        scale = torch.rsqrt(hr * hr + hi * hi + 1e-12) * inv_mag
        dr.append((Yr[:, s] * hr + Yi[:, s] * hi) * scale)
        di.append((Yi[:, s] * hr - Yr[:, s] * hi) * scale)
    Dr = torch.cat(dr, dim=-1)                     # (B, Ns*Nc), row-major
    Di = torch.cat(di, dim=-1)
    dec = weights.decoder
    per_z = dec.arrays[0].shape[0] // 2
    nz = Dr.shape[-1] // per_z
    z = torch.stack([torch.cat([Dr[:, k * per_z:(k + 1) * per_z],
                                Di[:, k * per_z:(k + 1) * per_z]], dim=-1)
                     for k in range(nz)], dim=1)
    return decoder_step_plain(dec, z, state)


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
                  _ptrs(state), _ptrs(new_state), stream)


def _ready_state(state, shapes, dev):
    if len(state) != len(shapes):
        raise ValueError(f"expected {len(shapes)} state tensors, got "
                         f"{len(state)}")
    return [_ready(s, sh, dev, f"state[{i}]")
            for i, (s, sh) in enumerate(zip(state, shapes))]


def fused_decoder_step(weights: PackedWeights, z, state):
    """Decoder stack for nz z-steps: z (B, nz, latent) ->
    (features (B, 4*nz, F), new_state).  The weights' layout picks the
    form: unmerged (`decoder_weights`) or chain-merged
    (`decoder_weights(merged=True)`, with the 15-tensor merged state).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (radae_fused_decoder_step or radae_fused_decoder_merged_step)."""
    merged = is_merged(weights)
    if z.device.type == "cpu":
        return (decoder_merged_step_plain if merged
                else decoder_step_plain)(weights, z, state)
    if z.device.type != "cuda":
        raise ValueError(f"fused_decoder_step: unsupported device {z.device}")
    dev = z.device
    B, nz, latent = z.shape
    out_dim = weights.arrays[-1].shape[0]
    if weights.buf.device != dev or len(weights.arrays) not in (N_DEC,
                                                                N_DEC_MERGED):
        raise ValueError("fused_decoder_step: weights must come from "
                         f"decoder_weights(params, device={str(dev)!r})")
    z = _ready(z, (B, nz, latent), dev, "z")
    shapes = _dec_state_shapes(B, merged)
    state = _ready_state(state, shapes, dev)
    feats = torch.empty((B, nz, out_dim), device=dev)
    new_state = [torch.empty(sh, device=dev) for sh in shapes]
    name = "fused_decoder_merged_step" if merged else "fused_decoder_step"
    fn = getattr(_kernels.library("fused_core"), "radae_" + name)
    status = _launch(fn, weights, z, feats, state, new_state,
                     (B, nz, latent, out_dim))
    _kernels.check(status, "radae_" + name)
    LAUNCHES[name] += 1
    F = out_dim // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(new_state)


# the frame kernel's limits on the modem geometry, by the number
# radae_rx_frame_limit (csrc/fused_core.cu `frame_limit`) returns
FRAME_LIMITS = {
    1: "Ns, Nc and nz at least 1, M+Ncp even, latent a positive multiple "
       "of 4",
    2: "the data symbols fill the z-steps (Ns*Nc == nz*latent/2)",
    3: "the block's samples (16 streams x (Ns+2) rows x 2(M+Ncp) floats) "
       "fit the decoder's rings",
    4: "the demod intermediates (16 streams x (Ns+4) rows of [Yr | Yi], 2Nc "
       "padded to a multiple of 4) fit the decoder's scratch",
    5: "latent at most 96 (z is staged in layer 0's GLU window)",
    6: "the z rows (16 x nz x latent floats) fit the block's shared memory "
       "after the decoder's",
}


def fused_rx_frame_step(weights: RxFrameWeights, rx_packed, state):
    """Whole rx frame: rx_packed (B, (Ns+2)(M+Ncp), 2) -> (features
    (B, 4*nz, F), new unmerged decoder state).  CPU tensors take
    `rx_frame_step_plain`; CUDA tensors launch the kernel
    (radae_fused_rx_frame_step) with the weights' modem geometry, or raise
    naming the kernel's limit it breaks (FRAME_LIMITS)."""
    if rx_packed.device.type == "cpu":
        return rx_frame_step_plain(weights, rx_packed, state)
    if rx_packed.device.type != "cuda":
        raise ValueError(
            f"fused_rx_frame_step: unsupported device {rx_packed.device}")
    dev = rx_packed.device
    w = weights.w
    B = rx_packed.shape[0]
    ns, nc, samp, latent, nz = weights.geometry
    if (w.buf.device != dev or len(w.arrays) != 4 + N_DEC + 2
            or tuple(w.arrays[-2].shape) != (2 * samp, _frame_y_width(nc))):
        raise ValueError("fused_rx_frame_step: the kernel takes "
                         "fused_rx_weights(params, cfg, device="
                         f"{str(dev)!r})")
    lib = _kernels.library("fused_core")
    limit = lib.radae_rx_frame_limit(ns, nc, samp, latent, nz)
    if limit:
        raise ValueError(
            f"fused_rx_frame_step: the modem geometry (Ns={ns}, Nc={nc}, "
            f"M+Ncp={samp}, latent={latent}, nz={nz}) is past the frame "
            f"kernel's limit: {FRAME_LIMITS[limit]}")
    rx = _ready(rx_packed, (B, weights.n_sym * samp, 2), dev, "rx_packed")
    shapes = _dec_state_shapes(B)
    state = _ready_state(state, shapes, dev)
    out_dim = weights.decoder.arrays[-1].shape[0]
    feats = torch.empty((B, nz, out_dim), device=dev)
    new_state = [torch.empty(sh, device=dev) for sh in shapes]
    status = _launch(lib.radae_fused_rx_frame_step, w, rx, feats, state,
                     new_state, (B, out_dim, ctypes.c_float(weights.mag_k),
                                 int(weights.coarse_mag), ns, nc, samp,
                                 latent, nz))
    _kernels.check(status, "radae_fused_rx_frame_step")
    LAUNCHES["fused_rx_frame_step"] += 1
    F = out_dim // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(new_state)


def make_fused_rx_frame_step(cfg, batch: int, device="cuda"):
    """The whole streaming rx frame as one step (radae_tpu's
    `make_fused_rx_frame_step`, one frame a call):

    step(weights, rx_packed (B, (Ns+2)(M+Ncp), 2), state)
      -> (features (B, 4*Nzmf, F), new_state)

    weights from `fused_rx_weights(params, cfg, device)`, state the
    unmerged decoder state (`decoder_state_zero(batch, device)`).  CUDA
    tensors launch the frame kernel; CPU tensors take the plain version."""
    dev = resolve_device(device)
    if cfg.Ns * cfg.Nc != cfg.Nzmf * cfg.latent_dim // 2:
        raise ValueError("a frame's data symbols must fill its latent steps")
    n_samp = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)

    def step(weights, rx_packed, state):
        B = rx_packed.shape[0]
        if B != batch:
            raise ValueError(f"fused rx frame step built for batch={batch} "
                             f"but got rx batch {B}")
        for s in state:
            if s.shape[0] != batch:
                raise ValueError(f"fused rx frame step built for batch="
                                 f"{batch} but got state leading dim "
                                 f"{s.shape[0]}")
        if tuple(rx_packed.shape[1:]) != (n_samp, 2):
            raise ValueError(f"fused rx frame step takes ({batch}, {n_samp}, "
                             f"2) samples, got {tuple(rx_packed.shape)}")
        if rx_packed.device.type != dev.type:
            raise ValueError(f"fused rx frame step built for {dev}, got "
                             f"samples on {rx_packed.device}")
        return fused_rx_frame_step(weights, rx_packed, state)

    return step


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
    if weights.buf.device != dev or len(weights.arrays) != N_ENC:
        raise ValueError("fused_encoder_step: weights must come from "
                         f"encoder_weights(params, device={str(dev)!r})")
    x = _ready(feats, (B, T, F), dev, "feats")
    shapes = ([(B, gh) for _, gh in _ENC_GRU_DIMS]
              + [(B, d, cin) for cin, _, d in _ENC_CONV_DIMS])
    state = _ready_state(state, shapes, dev)
    z = torch.empty((B, nz, latent), device=dev)
    new_state = [torch.empty(sh, device=dev) for sh in shapes]
    lib = _kernels.library("fused_core")
    status = _launch(lib.radae_fused_encoder_step, weights, x, z, state,
                     new_state, (B, nz, FRAMES_PER_STEP * F, latent,
                                 int(bottleneck)))
    _kernels.check(status, "radae_fused_encoder_step")
    LAUNCHES["fused_encoder_step"] += 1
    return z, tuple(new_state)
