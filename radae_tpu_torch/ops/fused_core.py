"""Fused core codec steps: the whole recurrent encoder or decoder stack for
nz latent steps in one CUDA kernel, and the whole rx frame (OFDM demod,
LS pilot EQ, coarse magnitude, demap and decoder) in one more (port of
`radae_tpu/ops/fused_core.py`: every body in f32, int8 and bf16 weights,
with f32 or bf16 products, and the chain-merged decoder in its padded
layout).

`fused_decoder_step` / `fused_encoder_step` / `fused_rx_frame_step` launch
the hand-written kernels of `csrc/fused_core.cu` for CUDA tensors and run
their plain PyTorch versions (`decoder_step_plain`,
`decoder_merged_step_plain`, `encoder_step_plain`, `rx_frame_step_plain`:
the same math in the order of the Pallas kernels) for CPU tensors.  There
is no fallback: a CUDA tensor goes to the kernel or the call raises.  Each
wrapper runs inside the span `kernel.<wrapper>` and counts its launches in
`LAUNCHES`, which is `trace.COUNTERS["launch"]` (radae_tpu_torch/trace.py).

Weights are packed once, pre-transposed to (in, out), into one contiguous
buffer; the kernel takes the buffer plus the offset of each array.
dtype=torch.bfloat16 stores every matrix in bf16 (rounded once, to nearest
even; biases stay f32).  With quant="int8" every matrix (but those
`quant_exclude` names, stored in `dtype`) is stored as int8, one byte a
weight, with a per-output-column f32 scale row appended to the buffer; each
product is dequantized on its output, (x @ q) * scale + bias, as in
radae_tpu's `_fused_weights`.
The decoder comes in three layouts (`decoder_weights(merged=...)`):
  unmerged: per layer wih, whh, bih, bhh, glu, conv tap 0, tap 1, bias;
  merged:   per layer wih, wgg = [whh | glu], bih, bhh, cw = [tap1 | tap0],
            bias (the TPU's chain-merged form: 17 serial products a z-step
            instead of 27);
  "pad":    the merged arrays with the rows of the x operands (wih, cw,
            out_w) scattered onto 128-row segments, one a segment of x (x0,
            then each layer's GLU and conv outputs), zero rows between.
compute_dtype=torch.bfloat16 (a keyword of every step) rounds the inputs of
each product to bf16 as radae_tpu's kernels do (`_rounds`); the sums, the
gates and the carried state stay f32.  Where every product is then bf16 x
bf16 (both decoders and the encoder on bf16 or int8 weights, the frame
kernel on any), and for both decoders and the encoder on f32 weights too
(a bf16 x f32 product as three bf16 products, on the weight's bf16 high,
middle and low parts), the kernel multiplies on the tensor cores, on the
weights packed by `mma_weights`: the launch packs them on its first use of
a weight set and keeps them in the set (`PackedWeights.mma`).  So do both
decoders and the encoder on int8 weights with f32 products (x's three bf16
parts against each int8 matrix, exact in bf16), and the padded decoder on
f32 weights with f32 products (x's three parts against each weight's).
State is a tuple of tensors:
  decoder, unmerged: 5 GRU h (B, 96) + 5 conv histories (B, in)
  decoder, merged:   5 GRU h (B, 96) + 5 projected hh rows h @ whh (B, 288)
                     + 5 projected conv tap-0 rows hist @ tap0 (B, 32); the
                     biases are added where the projections are used, so
                     the zero state is all zeros in both layouts (and in
                     "pad", whose state is the merged one)
  encoder:           5 GRU h (B, 64) + 5 conv history rings (B, d, in),
                     oldest first
(the `CoreDecoder` / `CoreEncoder` state squeezed or kept per layer).  A
merged and an unmerged run from zero give the same features, but their
states are not interchangeable.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..models.core import (
    _DEC_CONV_DIMS, _DEC_GRU_DIMS, _ENC_CONV_DIMS, _ENC_GRU_DIMS,
    FRAMES_PER_STEP)
from .. import resolve_device, trace
from . import _kernels
from .pilots import LOCAL_PATH_DELAY_S, ls_pmat, window3_index

N_DEC, N_DEC_MERGED, N_ENC = 2 + 5 * 8 + 2, 2 + 5 * 6 + 2, 2 + 5 * 7 + 2
QUANTS = (None, "int8")
DTYPES = (torch.float32, torch.bfloat16)   # of the matrices, and of products
SEG = 128                                  # rows of a "pad" x segment


def _launch_key(entry, weights, compute_dtype, pad=False):
    """The LAUNCHES key of one form: the entry, then "_pad" for the padded
    layout, the weights' kind ("_int8", "_bf16w" for bf16 matrices) and
    "_bf16" for bf16 products."""
    kind = ("_int8" if weights.quant else
            "_bf16w" if any(a.dtype == torch.bfloat16 for a in weights.arrays)
            else "")
    return (entry + ("_pad" if pad else "") + kind
            + ("_bf16" if compute_dtype == torch.bfloat16 else ""))


# kernel launches per form (kernel instance and weight kind) since the last
# reset_launches(): every form a wrapper can launch; the dict is
# trace.COUNTERS["launch"]
LAUNCHES = trace.COUNTERS["launch"]
LAUNCHES.update({
    e + p + k: 0
    for e, pads, kinds in (
        ("fused_decoder_step", ("",), ("", "_int8")),
        ("fused_decoder_merged_step", ("", "_pad"), ("", "_int8")),
        ("fused_rx_frame_step", ("",), ("",)),
        ("fused_encoder_step", ("",), ("", "_int8")))
    for p in pads
    for k in kinds + tuple(x + "_bf16" for x in kinds + ("_bf16w",))})


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


class PackedWeights(NamedTuple):
    """Weights of one fused stack in one contiguous buffer (f32 words).  An
    int8 matrix takes a quarter of the bytes it would take in f32, a bf16
    one half; its view is int8 or bfloat16."""
    buf: torch.Tensor            # (n,) float32
    offsets: Tuple[int, ...]     # start of each array in buf, in floats
                                 # (16-byte aligned)
    arrays: Tuple[torch.Tensor, ...]   # views of buf, in kernel order
    names: Tuple[str, ...]
    # quant="int8": one (1, out) f32 scale row per matrix, in array order
    # (a unit row for a matrix kept in f32 or bf16 by quant_exclude), and
    # their starts in buf
    scales: Tuple[torch.Tensor, ...] = ()
    scale_offsets: Tuple[int, ...] = ()
    # the matrices packed for the tensor cores (`mma_weights`), made by the
    # first launch that needs them (`_mma_args`): {stamp: MmaWeights};
    # None packs at every such launch
    mma: Optional[Dict[tuple, Any]] = None

    @property
    def quant(self) -> Optional[str]:
        return "int8" if self.scales else None


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, np.float32)


def _bf16_bits(a: np.ndarray) -> np.ndarray:
    """The bf16 bits (uint16) of an f32 array, rounded to nearest even."""
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(
        torch.bfloat16).view(torch.int16).numpy().view(np.uint16)


def _quantize_int8(w: np.ndarray):
    """int8 matrix and (1, out) f32 scales, radae_tpu's `_fused_weights`
    search: per output column, the scale of least squared error among
    absmax/127 and 8 smaller candidates."""
    s0 = np.maximum(np.abs(w).max(axis=0) / 127.0, 1e-12)
    cands = s0[None, :] * np.concatenate(
        [[1.0], 0.64 + 0.045 * np.arange(8)])[:, None]
    best_s, best_m = None, None
    for s in cands:
        q = np.clip(np.round(w / s), -127, 127)
        m = ((q * s - w) ** 2).sum(axis=0)
        if best_s is None:
            best_s, best_m = s.copy(), m
        else:
            take = m < best_m
            best_s[take] = s[take]
            best_m = np.minimum(best_m, m)
    q = np.clip(np.round(w / best_s), -127, 127).astype(np.int8)
    return q, np.asarray(best_s[None, :], np.float32)


def _xsegs(n):
    """Widths of the decoder's x segments after n layers: x0 (dense_1's
    output), then each layer's GLU output and conv output."""
    return ([_DEC_GRU_DIMS[0][0]]
            + [v for j in range(n)
               for v in (_DEC_GRU_DIMS[j][1], _DEC_CONV_DIMS[j][1])])


def _pad_rows(w, widths):
    """The row blocks of w (heights `widths`, the x segments it consumes) at
    starts SEG apart, exact zero rows in the gaps."""
    out = np.zeros((SEG * len(widths), w.shape[1]), np.float32)
    r = 0
    for j, wd in enumerate(widths):
        out[SEG * j:SEG * j + wd] = w[r:r + wd]
        r += wd
    assert r == w.shape[0], (r, w.shape)
    return out


def _x_operand_segs(j):
    """The x segments (`_xsegs`) that array j of a chain-merged set
    multiplies, where it is an x operand (g*_wih, c*_w, out_w); else
    None."""
    if j == N_DEC_MERGED - 2:
        return _xsegs(5)
    i, r = divmod(j - 2, 6)
    if 0 <= i < 5 and r in (0, 4):
        return _xsegs(i) + ([_DEC_GRU_DIMS[i][1]] if r == 4 else [])
    return None


def _fused_arrays(params: Dict[str, Any], side: str, merged=False,
                  quant=None, quant_exclude=(), dtype=torch.float32):
    """Flatten a decoder/encoder param tree (numpy or torch leaves) into the
    order of radae_tpu's `_fused_weights`: d1_w, d1_b, per layer g_wih,
    g_whh, g_bih, g_bhh, [glu_w,] c_w0, c_w1, c_b (merged, decoder only:
    g_wih, g_wgg, g_bih, g_bhh, c_w, c_b), then out_w, out_b.  Matrices
    are transposed to (in, out); merged="pad" scatters the rows of g_wih,
    c_w and out_w onto SEG-row segments (`_pad_rows`).  Matrices are stored
    in `dtype` (bf16 as its uint16 bits); quant="int8" stores each matrix
    as int8 with a scale row, but those whose name ends with a
    `quant_exclude` suffix, which stay in `dtype` with a unit scale row; a
    suffix that matches no name raises.  Returns (arrays, names, scales);
    scales is [] unless quant."""
    if merged and side != "decoder":
        raise ValueError("the merged layout is decoder-only")
    if merged not in (False, True, "pad"):
        raise ValueError(f'merged must be False, True or "pad", got {merged!r}')
    if quant not in QUANTS:
        raise ValueError(f"quant must be one of {QUANTS}, got {quant!r}")
    if dtype not in DTYPES:
        raise ValueError(f"dtype must be one of {DTYPES}, got {dtype!r}")
    pad = merged == "pad"
    arrs, names, scales = [], [], []
    matched = set()

    def add(name, a):
        a = np.ascontiguousarray(a, np.float32)
        if a.ndim >= 2:
            excl = [x for x in quant_exclude if name.endswith(x)]
            if quant == "int8" and not excl:
                a, sc = _quantize_int8(a)
                scales.append(sc)
            else:
                if quant == "int8":
                    matched.update(excl)
                    scales.append(np.ones((1, a.shape[1]), np.float32))
                if dtype == torch.bfloat16:
                    a = _bf16_bits(a)
        arrs.append(a)
        names.append(name)

    def addT(name, a, segs=None):
        a = _np(a).T
        add(name, _pad_rows(a, segs) if pad and segs else a)

    addT("d1_w", params["dense_1"]["w"]); add("d1_b", _np(params["dense_1"]["b"]))
    for i in range(1, 6):
        g = params[f"gru{i}"]
        cw = _np(params[f"conv{i}"]["w"])
        if side == "decoder":
            glu = params[f"glu{i}"]
            v, gg = _np(glu["v"]), _np(glu["g"])
            glu_w = gg[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
        if merged:
            addT(f"g{i}_wih", g["w_ih"], _xsegs(i - 1))
            add(f"g{i}_wgg", np.concatenate([_np(g["w_hh"]).T, glu_w.T], axis=1))
            add(f"g{i}_bih", _np(g["b_ih"])); add(f"g{i}_bhh", _np(g["b_hh"]))
            addT(f"c{i}_w", np.concatenate([cw[:, :, 1], cw[:, :, 0]], axis=0),
                 _xsegs(i - 1) + [_DEC_GRU_DIMS[i - 1][1]])
            add(f"c{i}_b", _np(params[f"conv{i}"]["b"]))
            continue
        addT(f"g{i}_wih", g["w_ih"]); addT(f"g{i}_whh", g["w_hh"])
        add(f"g{i}_bih", _np(g["b_ih"])); add(f"g{i}_bhh", _np(g["b_hh"]))
        if side == "decoder":
            addT(f"glu{i}_w", glu_w)
        addT(f"c{i}_w0", cw[:, :, 0]); addT(f"c{i}_w1", cw[:, :, 1])
        add(f"c{i}_b", _np(params[f"conv{i}"]["b"]))
    out = params["output" if side == "decoder" else "z_dense"]
    addT("out_w", out["w"], _xsegs(5)); add("out_b", _np(out["b"]))
    unmatched = set(quant_exclude) - matched
    if quant == "int8" and unmatched:
        raise ValueError(
            f"quant_exclude suffixes matched no weight name: "
            f"{sorted(unmatched)}; names are {names}")
    return arrs, names, scales


def _pack(arrs, names, device, scales=()) -> PackedWeights:
    """Copy arrays (f32, int8 or bf16 bits) and then the scale rows into one
    f32 buffer on `device`, every start 16-byte aligned."""
    offsets, n = [], 0
    for a in list(arrs) + list(scales):
        offsets.append(n)
        n += -(-a.nbytes // 16) * 4       # floats, a multiple of 16 bytes
    flat = np.zeros(4 * n, np.uint8)
    for o, a in zip(offsets, list(arrs) + list(scales)):
        flat[4 * o:4 * o + a.nbytes] = np.ascontiguousarray(a).view(np.uint8).ravel()
    buf = torch.as_tensor(flat.view(np.float32), device=resolve_device(device))
    typed = {np.dtype(np.float32): (buf, 1), np.dtype(np.int8): (buf.view(torch.int8), 4),
             np.dtype(np.uint16): (buf.view(torch.bfloat16), 2)}

    def view(o, a):
        b, per = typed[a.dtype]
        return b[per * o:per * o + a.size].view(a.shape)

    views = tuple(view(o, a) for o, a in zip(offsets, list(arrs) + list(scales)))
    k = len(arrs)
    return PackedWeights(buf, tuple(offsets[:k]), views[:k], tuple(names),
                         views[k:], tuple(offsets[k:]), {})


def decoder_weights(params, device="cuda", merged=False, quant=None,
                    quant_exclude=(), dtype=torch.float32) -> PackedWeights:
    """The decoder's fused weights, unmerged (44 arrays) or chain-merged
    (34 arrays, radae_tpu's `decoder_weights(merged=True)`, or its padded
    layout with merged="pad"); quant="int8" adds 27 (unmerged) or 17
    (merged) scale rows; dtype=torch.bfloat16 stores the matrices in bf16."""
    arrs, names, scales = _fused_arrays(params, "decoder", merged, quant,
                                        quant_exclude, dtype)
    return _pack(arrs, names, device, scales)


def encoder_weights(params, device="cuda", quant=None,
                    quant_exclude=(), dtype=torch.float32) -> PackedWeights:
    """The encoder's fused weights (39 arrays); quant="int8" adds 22 scale
    rows; dtype=torch.bfloat16 stores the matrices in bf16."""
    arrs, names, scales = _fused_arrays(params, "encoder", False, quant,
                                        quant_exclude, dtype)
    return _pack(arrs, names, device, scales)


def merged_layout(weights: PackedWeights):
    """The decoder layout of a weight set: False (unmerged), True
    (chain-merged) or "pad" (chain-merged, x operands on SEG-row
    segments)."""
    if len(weights.arrays) != N_DEC_MERGED:
        return False
    return "pad" if weights.arrays[2].shape[0] == SEG else True


def is_merged(weights: PackedWeights) -> bool:
    return bool(merged_layout(weights))


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


def fused_rx_weights(params, cfg, device="cuda",
                     dtype=torch.float32) -> RxFrameWeights:
    """Demod constants + decoder weights (matrices in `dtype`, as
    radae_tpu's `fused_rx_weights(dtype=)`: the demod constants stay f32)
    for the frame step.  dense_1's
    rows are permuted so the step feeds [re(0..L/2-1), im(0..L/2-1)]
    instead of the interleaved QPSK demap (the interleave is folded into
    the product).  Two more arrays give the kernel its layout, with 2Nc
    padded to yw, a multiple of 4 (the kernel's float4 columns):
      dft_w (2(M+Ncp), yw): interleaved IQ of a symbol row -> [Yr | Yi | 0];
      ls_w (yw, yw): [Yr | Yi | 0] of a pilot row -> [hr | hi | 0] (zero
      rows and columns at the pad)."""
    Wr, Wi, Er, Ei = (t.numpy() for t in rx_demod_consts(cfg, "cpu"))
    arrs, names, _ = _fused_arrays(params, "decoder", dtype=dtype)
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
# fragment-packed weights: the B operands of the tensor-core route
# ---------------------------------------------------------------------------

def _mma_pack(w: np.ndarray) -> np.ndarray:
    """The bf16 bits (uint16, nearest even) of a (K, out) matrix in the
    order in which the kernels' tmma reads mma.sync.m16n8k16 B fragments,
    shape (ceil(out/16), ceil(K/16), 32, 8): K and out padded with zeros to
    multiples of 16; for 16-column group cg and K step s, lane 4g + t holds
    rows 16s + 4t + i (i < 4) of column 16cg + 4(g >> 1) + (g & 1) (its
    n8 tile 0) and then of that column + 2 (tile 1).  A lane's 4 rows are
    the fragment's k 2t, 2t+1, 2t+8, 2t+9 (the kernel loads x in the same
    order), and the two tiles give the lane columns 4t..4t+3 of rows g and
    g + 8 as its sums."""
    K, out = w.shape
    nks, ncg = -(-K // 16), -(-out // 16)
    p = np.zeros((16 * nks, 16 * ncg), np.float32)
    p[:K, :out] = w
    # row 16s + 4t + i, column 16cg + 4q + 2n + e (g = 2q + e)
    p = p.reshape(nks, 4, 4, ncg, 4, 2, 2)          # s t i cg q n e
    p = p.transpose(3, 0, 4, 6, 1, 5, 2)            # cg s q e t n i
    return _bf16_bits(p.reshape(ncg, nks, 32, 8))


def split_parts(w: torch.Tensor):
    """(hi, mid, lo) of an f32 matrix, each bf16-valued (nearest even): hi =
    bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid).  Each difference
    is exact in f32, |w - hi - mid| <= 2^-17 |w|, and hi + mid + lo = w but
    where w is tiny (bf16's 8-bit significands hold w's 24 bits in three)."""
    w = w.float()
    hi = _bf16(w)
    mid = _bf16(w - hi)
    return hi, mid, _bf16(w - hi - mid)


def _mma_pack_split(w: np.ndarray) -> np.ndarray:
    """A kind-0 (f32, bf16 x f32 product) matrix for the split route: its
    `split_parts` hi, mid and lo, each packed as `_mma_pack` packs it, the
    three of one 16-column group and K step one after another: shape
    (ceil(out/16), ceil(K/16), 3, 32, 8), so a K step is 96 16-byte words,
    mid 32 and lo 64 words after hi."""
    parts = split_parts(torch.from_numpy(np.ascontiguousarray(w, np.float32)))
    return np.stack([_mma_pack(p.numpy()) for p in parts], axis=2)


class MmaWeights(NamedTuple):
    """`mma_weights`: the matrices a launch multiplies on the tensor cores,
    each as `_mma_pack` lays it out (a kind-0 matrix as `_mma_pack_split`:
    its hi, mid and lo copies), one after another in one buffer."""
    buf: torch.Tensor               # (8 n,) bfloat16
    offsets: Tuple[int, ...]        # per array of the weight set: its start
                                    # in buf in 16-byte words, -1 if none
    kinds: Tuple[int, ...]          # per array: its kind in the launch
                                    # (`_kinds`); a packed matrix of kind 0
                                    # is split (hi, mid and lo)


def _mma_kinds(weights, compute_dtype=torch.bfloat16):
    """The kinds (`_kinds`) of a launch on the tensor cores of a decoder's
    (either layout), the encoder's (PackedWeights) or the frame kernel's
    (RxFrameWeights) weights, and the arrays whose products run there.
    With bf16 products, both decoders (either layout of the chain-merged
    one) and the encoder: every matrix, those of kind 0 (f32 weights: bf16
    x f32 products) split into hi, mid and lo (`_mma_pack_split`), the
    others (int8, bf16, f32 rounded at the product: kinds 1, 2, 3) packed
    once.  The frame set, whose kernel rounds every matrix: the decoder's
    and dft_w (Wr..Ei are not the kernel's; ls_w stays a row product).
    With f32 products the int8 sets of both decoders (either layout of the
    chain-merged one) and of the encoder: every matrix, the int8 ones (kind
    1) packed once and those that quant_exclude keeps in f32 (kind 0)
    split; and the chain-merged decoder's padded f32 set, every matrix of
    kind 0, split; no other f32 set and no frame set."""
    if compute_dtype != torch.bfloat16:
        if not (isinstance(weights, PackedWeights) and (
                weights.quant or merged_layout(weights) == "pad")):
            raise ValueError("mma_weights: with f32 products only int8 "
                             "weights and the padded f32 decoder run on the "
                             "tensor cores")
        kinds = _kinds(weights, _rounds(weights, compute_dtype, "none"))
        return kinds, [j for j, a in enumerate(weights.arrays) if a.dim() == 2]
    if isinstance(weights, RxFrameWeights):
        w = weights.w
        kinds = _kinds(w, _rounds(w, torch.bfloat16, "all"))
        return kinds, [j for j in range(4, len(kinds) - 1) if kinds[j]]
    layout = merged_layout(weights)
    if not layout and len(weights.arrays) not in (N_DEC, N_ENC):
        raise ValueError(f"mma_weights: {len(weights.arrays)} arrays are no "
                         "decoder, encoder or frame weight set")
    kinds = _kinds(weights, _rounds(weights, torch.bfloat16,
                                    "none" if layout else "gru"))
    return kinds, [j for j, a in enumerate(weights.arrays) if a.dim() == 2]


def mma_weights(weights, compute_dtype=torch.bfloat16) -> MmaWeights:
    """The weights that the tensor-core (MM and split) instances read, built
    on the host: for either decoder layout (`decoder_weights`), the encoder
    (`encoder_weights`) and the frame kernel (`fused_rx_weights`) with bf16
    products, and for their int8 sets and the padded f32 decoder set with
    f32 products too (compute_dtype f32: the same bytes as with bf16
    products but for a matrix kept in f32, which is packed split, not
    rounded), each
    matrix that `_mma_kinds` names copied into bf16 (int8
    exactly, its scale row staying on the output; f32 rounded at the
    product, kind 3, to nearest even, as `_bf16`) in `_mma_pack`'s order,
    and each of kind 0 (f32, bf16 x f32) as its hi, mid and lo copies
    (`_mma_pack_split`, six bytes a weight), on the weights' device.  A
    "pad" matrix packs to its merged matrix (the zero rows between the
    SEG-row segments dropped).  The int8 matrices are widened to bf16 here,
    two bytes a weight where the int8 instances read one.  On f32 weights
    the unmerged decoder's and the encoder's GRU matrices are of kind 3 and
    the rest of kind 0; every matrix of the chain-merged decoder's f32 sets
    (either layout) is of kind 0, so each is packed split."""
    kinds, packed = _mma_kinds(weights, compute_dtype)
    arrays = (weights.w if isinstance(weights, RxFrameWeights)
              else weights).arrays
    pad = merged_layout(weights) == "pad" if isinstance(
        weights, PackedWeights) else False
    offsets, parts, n = [-1] * len(arrays), [], 0
    for j in packed:
        a = arrays[j].float()
        a = _bf16(a) if kinds[j] == 3 else a
        a = a.cpu().numpy()
        if pad and _x_operand_segs(j):
            a = np.concatenate([a[SEG * k:SEG * k + wd] for k, wd in
                                enumerate(_x_operand_segs(j))])
        pack = _mma_pack_split if kinds[j] == 0 else _mma_pack
        parts.append(pack(a).ravel())
        offsets[j] = n
        n += parts[-1].size // 8
    bits = np.concatenate(parts).view(np.int16)
    buf = torch.from_numpy(bits).view(torch.bfloat16).to(arrays[0].device)
    return MmaWeights(buf, tuple(offsets), tuple(kinds))


# ---------------------------------------------------------------------------
# plain PyTorch versions (the kernels' reference)
# ---------------------------------------------------------------------------

def _check_compute(compute_dtype):
    if compute_dtype not in DTYPES:
        raise ValueError(f"compute_dtype must be one of {DTYPES}, got "
                         f"{compute_dtype!r}")


def _rounds(weights: PackedWeights, compute_dtype, rule):
    """Per array: whether a step with bf16 products rounds that matrix to
    bf16 at its product inputs, as radae_tpu's kernels do.  Their `dot` is
    jnp.dot(x.astype(cd), w.astype(cd) if quant else w), so an f32 matrix
    of an f32 set stays f32 (bf16 x f32 promotes to f32); but `_gru_step`,
    which the unmerged decoder and the encoder run their GRU products
    through (rule "gru"), and the frame kernel's dot (rule "all") round w
    always.  int8 and bf16 matrices are exact in bf16 either way."""
    if compute_dtype != torch.bfloat16:
        return (False,) * len(weights.arrays)
    return tuple(a.dim() == 2 and (rule == "all" or weights.quant is not None
                                   or (rule == "gru" and n.endswith(("_wih", "_whh"))))
                 for n, a in zip(weights.names, weights.arrays))


def _bf16(x):
    """x rounded to bf16 (nearest even) and back to f32."""
    return x.to(torch.bfloat16).float()


def _products(weights: PackedWeights, compute_dtype=torch.float32,
              rule="none"):
    """mm(x, j) = x @ arrays[j], dequantized on its output as radae_tpu's
    int8 `dot` does, (x @ q) * scale, when the weights are int8 (a matrix
    kept in f32 or bf16 by quant_exclude is multiplied by its unit scale
    row).  With bf16 products x is rounded to bf16 and so is each matrix
    that `_rounds(..., rule)` names; the products of bf16 values are exact
    in f32 and the sum is f32."""
    arrays = weights.arrays
    if compute_dtype == torch.bfloat16:
        rounds = _rounds(weights, compute_dtype, rule)
        ws = [_bf16(a.float()) if r else a.float()
              for a, r in zip(arrays, rounds)]
        mm = lambda x, j: _bf16(x) @ ws[j]
    elif any(a.dtype != torch.float32 for a in arrays):
        ws = [a.float() for a in arrays]
        mm = lambda x, j: x @ ws[j]
    else:
        return lambda x, j: x @ arrays[j]
    if not weights.scales:
        return mm
    rows = iter(weights.scales)
    sc = [next(rows) if a.dim() == 2 else None for a in arrays]
    return lambda x, j: mm(x, j) * sc[j]


def _gru_step(xg, hg, h):
    """h' from the gate sums xg = x @ w_ih + b_ih and hg = h @ w_hh + b_hh."""
    H = h.shape[-1]
    r = torch.sigmoid(xg[:, :H] + hg[:, :H])
    z = torch.sigmoid(xg[:, H:2 * H] + hg[:, H:2 * H])
    n = torch.tanh(xg[:, 2 * H:] + r * hg[:, 2 * H:])
    return (1.0 - z) * n + z * h


def _decoder_steps(w, mm, z, state):
    """The unmerged decoder stack over z's nz steps with the products mm."""
    B, nz, _ = z.shape
    h, hist = list(state[:5]), list(state[5:])
    outs = []
    for step in range(nz):
        x = torch.tanh(mm(z[:, step], 0) + w[1])
        for i in range(5):
            j = 2 + 8 * i      # wih whh bih bhh glu cw0 cw1 cb
            h[i] = _gru_step(mm(x, j) + w[j + 2], mm(h[i], j + 1) + w[j + 3],
                             h[i])
            x = torch.cat([x, h[i] * torch.sigmoid(mm(h[i], j + 4))], dim=-1)
            yc = torch.tanh(mm(hist[i], j + 5) + mm(x, j + 6) + w[j + 7])
            hist[i] = x
            x = torch.cat([x, yc], dim=-1)
        outs.append(mm(x, len(w) - 2) + w[-1])
    feats = torch.stack(outs, dim=1)
    F = feats.shape[-1] // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(h + hist)


def decoder_step_plain(weights: PackedWeights, z, state,
                       compute_dtype=torch.float32):
    """z (B, nz, latent) -> (features (B, 4*nz, F), new_state)."""
    return _decoder_steps(weights.arrays,
                          _products(weights, compute_dtype, "gru"), z, state)


def _pad_x(x):
    """x's segments (`_xsegs`) at starts SEG apart, zeros between: the x
    operand of a "pad" matrix."""
    out = x.new_zeros((x.shape[0], SEG * len(_xsegs(5))))
    r = j = 0
    for wd in _xsegs(5):
        if r == x.shape[1]:
            break
        out[:, SEG * j:SEG * j + wd] = x[:, r:r + wd]
        r, j = r + wd, j + 1
    return out[:, :SEG * j]


def decoder_merged_step_plain(weights: PackedWeights, z, state,
                              compute_dtype=torch.float32):
    """The chain-merged decoder (radae_tpu's `kernel_merged`): z (B, nz,
    latent) -> (features (B, 4*nz, F), new 15-tensor state).  hg is the
    carried hh projection plus b_hh; h @ [whh | glu] gives the next
    step's projection and this step's GLU gate; x @ [tap1 | tap0] gives
    this step's tap 1 and the next step's tap 0 (no bias until used; with
    int8 weights the carried projections are the dequantized ones).  With
    "pad" weights the x operands go in as `_pad_x` lays them out."""
    w, mm = weights.arrays, _products(weights, compute_dtype)
    xmm = ((lambda x, j: mm(_pad_x(x), j))
           if merged_layout(weights) == "pad" else mm)
    B, nz, _ = z.shape
    h, hgp, hpp = list(state[:5]), list(state[5:10]), list(state[10:])
    outs = []
    for step in range(nz):
        x = torch.tanh(mm(z[:, step], 0) + w[1])
        for i in range(5):
            j = 2 + 6 * i      # wih wgg bih bhh cw cb
            H, co = h[i].shape[-1], w[j + 5].shape[0]
            h[i] = _gru_step(xmm(x, j) + w[j + 2], hgp[i] + w[j + 3], h[i])
            gh = mm(h[i], j + 1)
            hgp[i] = gh[:, :3 * H]
            x = torch.cat([x, h[i] * torch.sigmoid(gh[:, 3 * H:])], dim=-1)
            cc = xmm(x, j + 4)
            yc = torch.tanh(hpp[i] + cc[:, :co] + w[j + 5])
            hpp[i] = cc[:, co:]
            x = torch.cat([x, yc], dim=-1)
        outs.append(xmm(x, len(w) - 2) + w[-1])
    feats = torch.stack(outs, dim=1)
    F = feats.shape[-1] // FRAMES_PER_STEP
    return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(h + hgp + hpp)


def rx_frame_step_plain(weights: RxFrameWeights, rx_packed, state,
                        compute_dtype=torch.float32):
    """One whole rx frame (radae_tpu's `make_fused_rx_frame_step` kernel,
    in its order): rx_packed (B, (Ns+2)(M+Ncp), 2) -> (features (B, 4*nz,
    F), new unmerged decoder state).  DFT of every symbol row, LS pilot
    estimates of the two pilot rows, coarse magnitude, linear pilot
    interpolation with phase EQ, then the decoder on [re | im] latents.
    With bf16 products every product rounds both its inputs to bf16 (the
    samples and the DFT, the DFT outputs and the LS matrices, x and every
    decoder matrix), as that kernel's dot does."""
    rnd = _bf16 if compute_dtype == torch.bfloat16 else (lambda t: t)
    Wr, Wi, Er, Ei = (rnd(t) for t in weights.w.arrays[:4])
    B = rx_packed.shape[0]
    n_sym, Ns = weights.n_sym, weights.n_sym - 2
    rx = rx_packed.reshape(B, n_sym, weights.samp, 2)
    xr, xi = rnd(rx[..., 0]), rnd(rx[..., 1])
    Yr = xr @ Wr - xi @ Wi                         # (B, n_sym, Nc)
    Yi = xr @ Wi + xi @ Wr

    def ls(s):
        yr, yi = rnd(Yr[:, s]), rnd(Yi[:, s])
        return (yr @ Er - yi @ Ei, yr @ Ei + yi @ Er)

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
    return _decoder_steps(dec.arrays, _products(dec, compute_dtype, "all"),
                          z, state)


def encoder_step_plain(weights: PackedWeights, feats, state, bottleneck=3,
                       compute_dtype=torch.float32):
    """feats (B, 4*nz, F) -> (z (B, nz, latent), new_state)."""
    w, mm = weights.arrays, _products(weights, compute_dtype, "gru")
    B, T, F = feats.shape
    nz = T // FRAMES_PER_STEP
    f = feats.reshape(B, nz, FRAMES_PER_STEP * F)
    h, hist = list(state[:5]), list(state[5:])
    outs = []
    for step in range(nz):
        x = torch.tanh(mm(f[:, step], 0) + w[1])
        for i in range(5):
            j = 2 + 7 * i      # wih whh bih bhh cw0 cw1 cb
            h[i] = _gru_step(mm(x, j) + w[j + 2], mm(h[i], j + 1) + w[j + 3],
                             h[i])
            x = torch.cat([x, h[i]], dim=-1)
            yc = torch.tanh(mm(hist[i][:, 0], j + 4) + mm(x, j + 5) + w[j + 6])
            hist[i] = torch.cat([hist[i][:, 1:], x[:, None]], dim=1)
            x = torch.cat([x, yc], dim=-1)
        zk = mm(x, len(w) - 2) + w[-1]
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


def _kinds(weights: PackedWeights, rounds):
    """Each array's kind as the C entries take it: 0 f32, 1 int8, 2 bf16,
    3 f32 rounded to bf16 at its products (`_rounds`)."""
    return [1 if a.dtype == torch.int8 else 2 if a.dtype == torch.bfloat16
            else 3 if r else 0 for a, r in zip(weights.arrays, rounds)]


def _launch(fn, weights: PackedWeights, x, out, state, new_state, args,
            kinds=None):
    """Call a C entry on torch's current stream.  kinds (`_kinds`): the
    entry takes, after the offsets, each array's kind and the scale rows'
    offsets (none without int8 matrices); None for the f32 frame entry,
    which takes neither."""
    offs = (ctypes.c_int * len(weights.offsets))(*weights.offsets)
    head = [weights.buf.data_ptr(), ctypes.addressof(offs), len(weights.offsets)]
    if kinds is not None:
        k = (ctypes.c_int * len(kinds))(*kinds)
        so = (ctypes.c_int * max(1, len(weights.scale_offsets)))(
            *weights.scale_offsets)
        head += [ctypes.addressof(k), ctypes.addressof(so),
                 len(weights.scale_offsets)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        return fn(*head, x.data_ptr(), out.data_ptr(), *args, _ptrs(state),
                  _ptrs(new_state), stream)


def _check_kinds(weights: PackedWeights, what: str, n_arrays: int,
                 compute_dtype=torch.float32):
    """Raise unless the weights are what the kernels take: n_arrays arrays,
    f32 vectors and f32, bf16 or int8 matrices (int8 with one scale row a
    matrix), and bf16 matrices only under bf16 products (the instances
    with f32 products read f32 and int8 matrices)."""
    ok = len(weights.arrays) == n_arrays and all(
        a.dtype == torch.float32 or (a.dim() == 2 and (
            a.dtype == torch.bfloat16
            or (a.dtype == torch.int8 and weights.scales)))
        for a in weights.arrays)
    if weights.scales:
        ok = ok and len(weights.scales) == sum(a.dim() == 2
                                               for a in weights.arrays)
    if not ok:
        kinds = sorted({str(a.dtype) for a in weights.arrays})
        raise ValueError(f"{what}: the kernel takes f32, bf16 or int8 weights "
                         f"from the packing functions, got "
                         f"{len(weights.arrays)} arrays of {kinds} with "
                         f"{len(weights.scales)} scale rows")
    if compute_dtype != torch.bfloat16 and any(
            a.dtype == torch.bfloat16 for a in weights.arrays):
        raise ValueError(f"{what}: bf16 weights run with compute_dtype="
                         "torch.bfloat16 on the card")


def _ready_state(state, shapes, dev):
    if len(state) != len(shapes):
        raise ValueError(f"expected {len(shapes)} state tensors, got "
                         f"{len(state)}")
    return [_ready(s, sh, dev, f"state[{i}]")
            for i, (s, sh) in enumerate(zip(state, shapes))]


def _check_pad(weights: PackedWeights):
    """Raise unless each x operand of a "pad" set has SEG rows for each x
    segment it reads (`mma_weights` packs segment j's rows from row
    SEG*j)."""
    segs = [_x_operand_segs(j) for j in range(N_DEC_MERGED)]
    bad = [weights.names[j] for j, sg in enumerate(segs)
           if sg and weights.arrays[j].shape[0] != SEG * len(sg)]
    if bad:
        raise ValueError(f'merged="pad" weights: {bad} do not have {SEG} '
                         "rows an x segment")


def _mma_args(weights, kinds, compute_dtype=torch.bfloat16):
    """The (packed buffer, its offsets) arguments of a launch on the tensor
    cores of a decoder or the encoder (PackedWeights) or of the frame
    kernel (RxFrameWeights), with bf16 products or (the int8 sets of the
    decoders and the encoder) f32 products: `mma_weights(weights,
    compute_dtype)`, kept in the weight set's `mma` under a stamp of what it
    copies (the buffer, its version counter, which every write to it or to
    a view of it bumps, the arrays' offsets and kinds) and packed anew when
    the stamp changes, so a launch never reads another set's or a stale
    copy.  (The C entries refuse a launch without the packed matrices:
    there is no FMA fallback.)"""
    w = weights.w if isinstance(weights, RxFrameWeights) else weights
    stamp = (w.buf.data_ptr(), w.buf._version, w.offsets, tuple(kinds))
    kept = {} if w.mma is None else w.mma
    if stamp not in kept:
        kept.clear()
        kept[stamp] = mma_weights(weights, compute_dtype)
        trace.count("pack", "mma")
    m = kept[stamp]
    return m.buf.data_ptr(), (ctypes.c_int * len(m.offsets))(*m.offsets)


def fused_decoder_step(weights: PackedWeights, z, state,
                       compute_dtype=torch.float32):
    """Decoder stack for nz z-steps: z (B, nz, latent) ->
    (features (B, 4*nz, F), new_state).  The weights' layout picks the
    form: unmerged (`decoder_weights`), chain-merged or padded
    (`decoder_weights(merged=True | "pad")`, with the 15-tensor merged
    state); their kind and compute_dtype the instance: f32 or int8
    matrices with f32 products, or f32, bf16 or int8 matrices with bf16
    products.  CPU tensors take the plain version; CUDA tensors launch the
    kernel (unmerged: radae_fused_decoder_step on f32 weights, else, int8
    or with bf16 products, radae_fused_decoder_mma_step; chain-merged:
    radae_fused_decoder_merged_step on f32 weights, else, padded, int8 or
    with bf16 products, radae_fused_decoder_merged_x_step).  With bf16
    products every product of every layout runs on the tensor cores, on
    the weights packed on first use (`_mma_args`): int8 and bf16 matrices
    as bf16, and on f32 weights each bf16 x f32 product as three bf16
    products, on the weight's hi, mid and lo copies (`split_parts`).  So
    does every layout on int8 weights with f32 products: each f32 x int8
    product as three bf16 products, x's hi, mid and lo against the int8
    matrix widened to bf16 (a matrix kept in f32 as six, against its three
    copies); and the padded layout on f32 weights, each f32 x f32 product
    as those six."""
    _check_compute(compute_dtype)
    layout = merged_layout(weights)
    dev = z.device
    with trace.span("kernel.fused_decoder_step"):
        if dev.type == "cpu":
            return (decoder_merged_step_plain if layout
                    else decoder_step_plain)(weights, z, state, compute_dtype)
        if dev.type != "cuda":
            raise ValueError(f"fused_decoder_step: unsupported device {dev}")
        B, nz, latent = z.shape
        out_dim = weights.arrays[-1].shape[0]
        if weights.buf.device != dev or len(weights.arrays) not in (
                N_DEC, N_DEC_MERGED):
            raise ValueError("fused_decoder_step: weights must come from "
                             f"decoder_weights(params, device={str(dev)!r})")
        _check_kinds(weights, "fused_decoder_step", len(weights.arrays),
                     compute_dtype)
        if layout == "pad":
            _check_pad(weights)
        bf = compute_dtype == torch.bfloat16
        z = _ready(z, (B, nz, latent), dev, "z")
        shapes = _dec_state_shapes(B, layout)
        state = _ready_state(state, shapes, dev)
        feats = torch.empty((B, nz, out_dim), device=dev)
        new_state = [torch.empty(sh, device=dev) for sh in shapes]
        entry = ("fused_decoder_merged_step" if layout
                 else "fused_decoder_step")
        args = (B, nz, latent, out_dim)
        kinds = _kinds(weights, _rounds(weights, compute_dtype,
                                        "none" if layout else "gru"))
        # on the tensor cores: bf16 products, the int8 forms and the padded
        # layout (all but the unmerged and merged layouts' f32 forms)
        mma = bf or bool(weights.quant) or layout == "pad"
        if layout and mma:
            name = "radae_fused_decoder_merged_x_step"
            args += (int(layout == "pad"), int(bf))
        else:
            name = "radae_" + (entry.replace("_step", "_mma_step") if mma
                               else entry)
            args += (int(bf),) if mma else ()
        if mma:
            args += _mma_args(weights, kinds, compute_dtype)
        status = _launch(getattr(_kernels.library("fused_core"), name),
                         weights, z, feats, state, new_state, args, kinds)
        _kernels.check(status, name)
        LAUNCHES[_launch_key(entry, weights, compute_dtype,
                             layout == "pad")] += 1
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


def fused_rx_frame_step(weights: RxFrameWeights, rx_packed, state,
                        compute_dtype=torch.float32):
    """Whole rx frame: rx_packed (B, (Ns+2)(M+Ncp), 2) -> (features
    (B, 4*nz, F), new unmerged decoder state).  CPU tensors take
    `rx_frame_step_plain`; CUDA tensors launch the kernel
    (radae_fused_rx_frame_step, or radae_fused_rx_frame_bf16_step for bf16
    products, which runs its products on the tensor cores, on the weights
    packed on first use: `_mma_args`) with the weights' modem geometry, or raise
    naming the kernel's limit it breaks (FRAME_LIMITS)."""
    _check_compute(compute_dtype)
    dev = rx_packed.device
    with trace.span("kernel.fused_rx_frame_step"):
        if dev.type == "cpu":
            return rx_frame_step_plain(weights, rx_packed, state,
                                       compute_dtype)
        if dev.type != "cuda":
            raise ValueError(f"fused_rx_frame_step: unsupported device {dev}")
        w = weights.w
        B = rx_packed.shape[0]
        ns, nc, samp, latent, nz = weights.geometry
        if (w.buf.device != dev or len(w.arrays) != 4 + N_DEC + 2
                or tuple(w.arrays[-2].shape) != (2 * samp,
                                                 _frame_y_width(nc))):
            raise ValueError("fused_rx_frame_step: the kernel takes "
                             "fused_rx_weights(params, cfg, device="
                             f"{str(dev)!r})")
        _check_kinds(weights.decoder, "fused_rx_frame_step", N_DEC,
                     compute_dtype)
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
        bf = compute_dtype == torch.bfloat16
        name = "radae_fused_rx_frame_" + ("bf16_step" if bf else "step")
        args = (B, out_dim, ctypes.c_float(weights.mag_k),
                int(weights.coarse_mag), ns, nc, samp, latent, nz)
        kinds = _kinds(w, _rounds(w, compute_dtype, "all")) if bf else None
        if bf:
            args += _mma_args(weights, kinds)
        status = _launch(getattr(lib, name), w, rx, feats, state, new_state,
                         args, kinds)
        _kernels.check(status, name)
        LAUNCHES[_launch_key("fused_rx_frame_step", weights.decoder,
                             compute_dtype)] += 1
        F = out_dim // FRAMES_PER_STEP
        return feats.reshape(B, nz * FRAMES_PER_STEP, F), tuple(new_state)


def make_fused_rx_frame_step(cfg, batch: int, device="cuda",
                             compute_dtype=torch.float32):
    """The whole streaming rx frame as one step (radae_tpu's
    `make_fused_rx_frame_step`, one frame a call, with its compute_dtype):

    step(weights, rx_packed (B, (Ns+2)(M+Ncp), 2), state)
      -> (features (B, 4*Nzmf, F), new_state)

    weights from `fused_rx_weights(params, cfg, device)`, state the
    unmerged decoder state (`decoder_state_zero(batch, device)`).  CUDA
    tensors launch the frame kernel; CPU tensors take the plain version.
    radae_tpu's rx_dma and tile place the TPU's sample block and size its
    grid: the CUDA kernel stages each block's samples by cp.async either
    way, so the port has neither."""
    _check_compute(compute_dtype)
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
        return fused_rx_frame_step(weights, rx_packed, state, compute_dtype)

    return step


def fused_encoder_step(weights: PackedWeights, feats, state, bottleneck=3,
                       compute_dtype=torch.float32):
    """Encoder stack: feats (B, 4*nz, F) -> (z (B, nz, latent), new_state).
    The weights' kind and compute_dtype pick the instance: f32 matrices
    with f32 products (radae_fused_encoder_step, on FMA loops), else
    radae_fused_encoder_mma_step: int8 ones with f32 products (x's hi, mid
    and lo bf16 parts against each int8 matrix widened to bf16, six
    products on a matrix kept in f32), or f32, bf16 or int8 ones with bf16
    products (on f32 weights each bf16 x f32 product as three bf16
    products, on the weight's hi, mid and lo copies: `split_parts`); but
    for the first, every product on the tensor cores, on
    the weights packed on first use (`_mma_args`).  CPU tensors take the
    plain version; CUDA tensors launch the kernel."""
    _check_compute(compute_dtype)
    dev = feats.device
    with trace.span("kernel.fused_encoder_step"):
        if dev.type == "cpu":
            return encoder_step_plain(weights, feats, state, bottleneck,
                                      compute_dtype)
        if dev.type != "cuda":
            raise ValueError(f"fused_encoder_step: unsupported device {dev}")
        B, T, F = feats.shape
        nz = T // FRAMES_PER_STEP
        if T % FRAMES_PER_STEP:
            raise ValueError(f"fused_encoder_step: {T} frames is not a "
                             f"multiple of {FRAMES_PER_STEP}")
        latent = weights.arrays[-1].shape[0]
        if weights.buf.device != dev:
            raise ValueError("fused_encoder_step: weights must come from "
                             f"encoder_weights(params, device={str(dev)!r})")
        _check_kinds(weights, "fused_encoder_step", N_ENC, compute_dtype)
        x = _ready(feats, (B, T, F), dev, "feats")
        shapes = ([(B, gh) for _, gh in _ENC_GRU_DIMS]
                  + [(B, d, cin) for cin, _, d in _ENC_CONV_DIMS])
        state = _ready_state(state, shapes, dev)
        z = torch.empty((B, nz, latent), device=dev)
        new_state = [torch.empty(sh, device=dev) for sh in shapes]
        bf = compute_dtype == torch.bfloat16
        mma = bf or bool(weights.quant)     # on the tensor cores
        name = "radae_fused_encoder_" + ("mma_step" if mma else "step")
        kinds = _kinds(weights, _rounds(weights, compute_dtype, "gru"))
        args = (B, nz, FRAMES_PER_STEP * F, latent, int(bottleneck))
        if mma:
            args += (int(bf),) + _mma_args(weights, kinds, compute_dtype)
        status = _launch(getattr(_kernels.library("fused_core"), name),
                         weights, x, z, state, new_state, args, kinds)
        _kernels.check(status, name)
        LAUNCHES[_launch_key("fused_encoder_step", weights,
                             compute_dtype)] += 1
        return z, tuple(new_state)
