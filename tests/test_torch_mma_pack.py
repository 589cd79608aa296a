"""The fragment-packed weights of the tensor-core route (`mma_weights`) on
the CPU, where the kernels cannot run.

The MM instances of both decoders, the encoder and the frame kernel read
their matrices as mma.sync.m16n8k16 B fragments packed on the host.  These
tests hold the packing and its index arithmetic:

  * unpacked, each packed matrix is exactly what the plain version
    multiplies by: the int8 values q, the bf16 values w, and `_bf16(w)` for
    f32 matrices rounded at the product (the frame kernel's, and those an
    int8 set's quant_exclude keeps in f32), for the merged and the unmerged
    decoder and the encoder at latent 80 and 40;
  * f32 sets of both decoders and the encoder pack every matrix: the
    unmerged decoder's and the encoder's GRU matrices (rounded at the
    product) as `_bf16(w)`, the rest, and every matrix of the chain-merged
    decoder (bf16 x f32 products), split into hi = `_bf16(w)`, mid =
    `_bf16(w - hi)` and lo = `_bf16(w - hi - mid)`, three copies a K step,
    with |w - hi - mid| <= 2^-17 |w| and hi + mid + lo = w;
  * a merged="pad" set (f32, int8 or bf16) packs to the same bytes as its
    merged set;
  * a plain torch walk over the packed fragments, with the lane, K
    permutation and column order that `tmma` in csrc/fused_core.cu uses,
    gives `_bf16(x) @ W` (atol 1e-5: the same exact products summed in
    another f32 order), also with a K tail (K = 40, NaN planted in x past
    K, which the kernel must zero rather than multiply by a zero row), an
    `out` of 84 (zero columns to 96) and a K range that starts inside K,
    and on the encoder's own packed matrices: its 84-wide dense_1 (a K
    tail) and its 40-column z_dense at latent 40 (a column tail), and the
    split route's walk over hi, mid and lo in the kernel's sum order on
    the same two matrices of an f32 set and on the merged decoder's
    latent-40 dense_1 (a K tail) and 84-column output, against
    `_bf16(x) @ w`;
  * a launch packs the weight set it is given on first use and keeps the
    copy in that set, and packs anew after a write to the set's buffer.
"""

import os

import numpy as np
import pytest
import torch

from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.ops import fused_core as fc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(ROOT, "fixtures", "model_fs_flagship.npz")
CKPT40 = os.path.join(ROOT, "fixtures", "model_l40.npz")
BF = torch.bfloat16
# the int8 sets with some matrices kept in f32 (chip_smoke.py's MIXED)
EXCLUDE = {"dec": ("whh", "out_w"), "enc": ("whh", "d1_w")}


@pytest.fixture(scope="module")
def dec_tree():
    return load_checkpoint(CKPT)[0]["decoder"]


@pytest.fixture(scope="module")
def trees():
    """The flagship (latent 80) and the latent-40 checkpoints."""
    return {80: load_checkpoint(CKPT)[0], 40: load_checkpoint(CKPT40)[0]}


def _unmerged_set(trees, side, kind, latent):
    """The unmerged decoder's or the encoder's weights of one kind: "f32",
    "bf16", "int8" or "int8-exclude" (EXCLUDE's matrices in f32); side
    "decm": the chain-merged decoder's f32 weights."""
    if side == "decm":
        assert kind == "f32"
        return fc.decoder_weights(trees[latent]["decoder"], "cpu", merged=True)
    kw = {"f32": {}, "bf16": {"dtype": BF}, "int8": {"quant": "int8"},
          "int8-exclude": {"quant": "int8", "quant_exclude": EXCLUDE[side]}}[kind]
    tree = trees[latent]
    return (fc.decoder_weights(tree["decoder"], "cpu", **kw) if side == "dec"
            else fc.encoder_weights(tree["encoder"], "cpu", **kw))


def _blocks(buf, off, K, out, parts=1, part=0):
    """The (ceil(out/16), ceil(K/16), 32, 8) words of one copy of a packed
    matrix: the only one, or part `part` of a split one's `parts`."""
    nks, ncg = -(-K // 16), -(-out // 16)
    return buf[8 * off:8 * off + ncg * nks * 256 * parts].float().reshape(
        ncg, nks, parts, 32, 8)[:, :, part]


def _unpack(buf, off, K, out, parts=1, part=0):
    """The (K, out) f32 values of a packed matrix (of part `part` of a
    split one): the inverse of `_mma_pack`, read lane by lane as the kernel
    reads its B fragments."""
    nks, ncg = -(-K // 16), -(-out // 16)
    blk = _blocks(buf, off, K, out, parts, part)
    w = torch.zeros((16 * nks, 16 * ncg))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for n in range(2):                       # n8 tiles
            col = 4 * (g >> 1) + 2 * n + (g & 1)
            for i in range(4):
                w[4 * t + i::16, col::16] = blk[:, :, lane, 4 * n + i].T
    return w[:K, :out]


def _tmma_walk(x, buf, off, K, out, k0, k1, parts=1):
    """Y[:, :] = x[:, k0:k1] @ W[k0:k1] for 16 rows of x, as tmma computes
    it: per 16-column group and K step, each lane's A registers (two float4
    of x rounded to bf16, zero at k >= k1) and B registers (16 bytes of the
    packed matrix) assembled into the m16n8k16 fragments of the PTX ISA,
    the two n8 tiles' products, and the lane's sums (rows g, g + 8,
    columns 4t..4t+3) written where the kernel's epilogue puts them.
    parts=3: a split matrix, whose step products on lo, mid and hi (B
    registers of each copy) are summed in that order (exactly here; the
    tensor cores truncate the step sum once) and the step sum added to the
    lane's f32 sums."""
    nks, ncg = -(-K // 16), -(-out // 16)
    blks = [_blocks(buf, off, K, out, parts, p) for p in range(parts)]
    xb = fc._bf16(x)
    y = torch.zeros((16, 16 * ncg))
    for cg in range(ncg):
        acc = torch.zeros((32, 2, 4))            # lane, row g / g+8, column
        for k in range(k0, k1, 16):
            A = torch.zeros((16, 16))             # fragment row, fragment k
            Bn = torch.zeros((parts, 2, 16, 8))   # copy, tile, fragment k, column
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                kk = k + 4 * t
                xa = xb[g, kk:kk + 4] if kk < k1 else torch.zeros(4)
                xc = xb[g + 8, kk:kk + 4] if kk < k1 else torch.zeros(4)
                # a0..a3: (row g, k 2t..2t+1), (g+8, 2t..), (g, 2t+8..),
                # (g+8, 2t+8..) from physical k 4t, 4t+1, then 4t+2, 4t+3
                A[g, 2 * t:2 * t + 2], A[g + 8, 2 * t:2 * t + 2] = xa[:2], xc[:2]
                A[g, 2 * t + 8:2 * t + 10] = xa[2:]
                A[g + 8, 2 * t + 8:2 * t + 10] = xc[2:]
                for p, blk in enumerate(blks):
                    b = blk[cg, k // 16, lane]
                    for n in range(2):           # b0, b1 of tile n: column g
                        Bn[p, n, 2 * t:2 * t + 2, g] = b[4 * n:4 * n + 2]
                        Bn[p, n, 2 * t + 8:2 * t + 10, g] = b[4 * n + 2:4 * n + 4]
            # the copies' step products, lo first (the last copy), in f64
            D = sum(torch.stack([A.double() @ Bn[p, 0].double(),
                                 A.double() @ Bn[p, 1].double()])
                    for p in reversed(range(parts))).float()   # (tile, 16, 8)
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):               # c0, c1 of rows g, g + 8
                    r = g + 8 * h
                    acc[lane, h] += torch.stack([
                        D[0, r, 2 * t], D[0, r, 2 * t + 1],
                        D[1, r, 2 * t], D[1, r, 2 * t + 1]])
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            c = 16 * cg + 4 * t
            y[g, c:c + 4], y[g + 8, c:c + 4] = acc[lane, 0], acc[lane, 1]
    return y[:, :out]


@pytest.mark.parametrize("kind", ["int8", "bf16", "f32-rounded"])
def test_pack_round_trip(dec_tree, kind):
    """Every packed matrix unpacks to q (int8), w (bf16) or _bf16(w) (f32
    rounded at the product: the frame kernel's matrices), exactly; the
    others (vectors, and ls_w, Wr..Ei of the frame set) are not packed."""
    if kind == "f32-rounded":
        ws = fc.fused_rx_weights(dec_tree, flagship_config(), "cpu")
        arrays = ws.w.arrays
        want_packed = set(range(4, 4 + fc.N_DEC)) | {len(arrays) - 2}
    else:
        ws = fc.decoder_weights(dec_tree, "cpu", merged=True,
                                **({"quant": "int8"} if kind == "int8"
                                   else {"dtype": BF}))
        arrays = ws.arrays
        want_packed = set(range(len(arrays)))
    m = fc.mma_weights(ws)
    assert m.buf.dtype == BF and len(m.offsets) == len(arrays)
    n_packed = 0
    for j, a in enumerate(arrays):
        if a.dim() != 2 or j not in want_packed:
            assert m.offsets[j] == -1
            continue
        want = fc._bf16(a) if kind == "f32-rounded" else a.float()
        got = _unpack(m.buf, m.offsets[j], *a.shape)
        assert torch.equal(got, want), ws.w.names[j] if kind == "f32-rounded" \
            else ws.names[j]
        n_packed += 1
    # the unmerged decoder's 27 matrices and dft_w; the merged one's 17
    assert n_packed == (27 + 1 if kind == "f32-rounded" else 17)
    # a matrix's packed words: ceil(K/16) ceil(out/16) 16x16 tiles
    sizes = sorted((o, j) for j, o in enumerate(m.offsets) if o >= 0)
    ends = [o for o, _ in sizes[1:]] + [m.buf.numel() // 8]
    for (o, j), e in zip(sizes, ends):
        K, out = arrays[j].shape
        assert e - o == 32 * -(-K // 16) * -(-out // 16)


@pytest.mark.parametrize("kw", [{"quant": "int8"}, {"dtype": BF},
                                {"quant": "int8", "quant_exclude": ("wgg",)},
                                {}],
                         ids=["int8", "bf16", "int8-exclude", "f32"])
def test_pad_packs_as_merged(dec_tree, kw):
    """A merged="pad" set packs to the same bytes as its merged set: the
    zero rows between the 128-row segments are dropped (f32: every matrix
    split, each of its hi, mid and lo copies so)."""
    merged = fc.mma_weights(fc.decoder_weights(dec_tree, "cpu", merged=True,
                                               **kw))
    pad = fc.mma_weights(fc.decoder_weights(dec_tree, "cpu", merged="pad",
                                            **kw))
    assert merged.offsets == pad.offsets and merged.kinds == pad.kinds
    assert torch.equal(merged.buf.view(torch.int16), pad.buf.view(torch.int16))
    if "quant_exclude" in kw:      # the excluded f32 matrices: rounded
        assert set(merged.kinds[j] for j in range(len(merged.kinds))
                   if merged.offsets[j] >= 0) == {1, 3}
    if not kw:                     # f32: every matrix of kind 0, split
        assert sum(o >= 0 for o in pad.offsets) == 17
        assert {pad.kinds[j] for j in range(len(pad.kinds))
                if pad.offsets[j] >= 0} == {0}


@pytest.mark.parametrize("K, out, k0, k1", [
    (96, 64, 0, 96), (40, 96, 0, 40), (40, 96, 32, 40), (736, 84, 384, 736),
    (80, 96, 0, 80)], ids=["k96", "k40-tail", "k40-chunk", "out84-chunk",
                           "k80"])
def test_fragment_walk(K, out, k0, k1):
    """The kernel's walk over the packed fragments gives _bf16(x) @ W over
    its K range, with x past k1 holding NaN (zeroed, not multiplied)."""
    rng = np.random.default_rng(K * 1000 + out + k0)
    # weights and activations of the decoder's scale (outputs of order 1)
    w = (0.1 * rng.standard_normal((K, out))).astype(np.float32)
    x = rng.standard_normal((16, 16 * -(-K // 16) + 8)).astype(np.float32)
    x[:, k1:] = np.nan
    buf = torch.from_numpy(fc._mma_pack(w).ravel().view(np.int16)).view(BF)
    got = _tmma_walk(torch.from_numpy(x), buf, 0, K, out, k0, k1)
    wb = fc._bf16(torch.from_numpy(w))
    want = fc._bf16(torch.from_numpy(x[:, k0:k1])) @ wb[k0:k1]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("latent", [80, 40])
@pytest.mark.parametrize("kind", ["int8", "bf16", "int8-exclude"])
@pytest.mark.parametrize("side", ["dec", "enc"])
def test_pack_round_trip_unmerged_and_encoder(trees, side, kind, latent):
    """Every matrix of the unmerged decoder (27) and of the encoder (22) is
    packed and unpacks to q (int8), w (bf16) or _bf16(w) (kept in f32 by
    quant_exclude: rounded at the product), exactly; no vector is packed,
    and each matrix takes ceil(K/16) ceil(out/16) 16x16 tiles."""
    ws = _unmerged_set(trees, side, kind, latent)
    m = fc.mma_weights(ws)
    mats = [j for j, a in enumerate(ws.arrays) if a.dim() == 2]
    assert len(mats) == (27 if side == "dec" else 22)
    assert [j for j, o in enumerate(m.offsets) if o >= 0] == mats
    for j in mats:
        a = ws.arrays[j]
        want = fc._bf16(a) if a.dtype == torch.float32 else a.float()
        got = _unpack(m.buf, m.offsets[j], *a.shape)
        assert torch.equal(got, want), ws.names[j]
    want_kinds = {"int8": {1}, "bf16": {2}, "int8-exclude": {1, 3}}[kind]
    assert {m.kinds[j] for j in mats} == want_kinds
    assert m.buf.numel() // 8 == sum(
        32 * -(-ws.arrays[j].shape[0] // 16) * -(-ws.arrays[j].shape[1] // 16)
        for j in mats)


@pytest.mark.parametrize("what, latent, k0, k1", [
    ("d1", 80, 0, 32), ("d1", 80, 64, 84), ("z_dense", 40, 448, 864)],
    ids=["d1-chunk0", "d1-tail", "z40-columns"])
def test_fragment_walk_encoder(trees, what, latent, k0, k1):
    """The walk over the encoder's own packed matrices (bf16 weights) gives
    _bf16(x) @ W over the K chunks the kernel gives it: dense_1's K of 84
    ends inside a 16-wide step (x past K holds NaN), and the latent-40
    z_dense's 40 columns are packed as 48 (the epilogue stores none past
    40)."""
    ws = _unmerged_set(trees, "enc", "bf16", latent)
    m = fc.mma_weights(ws)
    j = 0 if what == "d1" else len(ws.arrays) - 2
    K, out = ws.arrays[j].shape
    assert (K, out) == ((84, 64) if what == "d1" else (864, 40))
    rng = np.random.default_rng(K + k0)
    x = rng.standard_normal((16, 16 * -(-K // 16) + 8)).astype(np.float32)
    x[:, k1:] = np.nan
    got = _tmma_walk(torch.from_numpy(x), m.buf, m.offsets[j], K, out, k0, k1)
    want = fc._bf16(torch.from_numpy(x[:, k0:k1])) @ ws.arrays[j].float()[k0:k1]
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _kept(w):
    """The packed copy a weight set keeps (PackedWeights.mma)."""
    (m,) = w.mma.values()
    return m


def test_launch_packs_its_weight_set(dec_tree, monkeypatch):
    """A launch with bf16 products of the merged decoder or the frame kernel
    packs its own weight set on first use and keeps the copy in the set;
    another set with the same kinds, or a write to the set's buffer after
    packing, gets a copy of its own, equal to mma_weights of what the set
    then holds."""
    built = []
    real = fc.mma_weights
    monkeypatch.setattr(fc, "mma_weights",
                        lambda ws, *a: built.append(ws) or real(ws, *a))
    w = fc.decoder_weights(dec_tree, "cpu", merged=True, dtype=BF)
    w2 = fc.decoder_weights(dec_tree, "cpu", merged=True, dtype=BF)
    kinds = fc._kinds(w, fc._rounds(w, BF, "none"))
    a, b = fc._mma_args(w, kinds), fc._mma_args(w, kinds)
    assert a[0] == b[0] and list(a[1]) == list(b[1]) and built == [w]
    c = fc._mma_args(w2, kinds)
    assert c[0] != a[0] and built == [w, w2]
    old = _kept(w2).buf.clone()
    w2.arrays[3].mul_(2.0)            # a write through a view of the buffer
    fc._mma_args(w2, kinds)
    assert len(built) == 3 and len(w2.mma) == 1
    assert torch.equal(_kept(w2).buf.view(torch.int16),
                       real(w2).buf.view(torch.int16))
    assert not torch.equal(_kept(w2).buf.view(torch.int16),
                           old.view(torch.int16))
    # a set without the field packs at every launch
    bare = w._replace(mma=None)
    fc._mma_args(bare, kinds)
    fc._mma_args(bare, kinds)
    assert len(built) == 5
    # the frame kernel keeps its copy in its buffer's set (RxFrameWeights.w)
    rw = fc.fused_rx_weights(dec_tree, flagship_config(), "cpu")
    fk = fc._kinds(rw.w, fc._rounds(rw.w, BF, "all"))
    f1, f2 = fc._mma_args(rw, fk), fc._mma_args(rw, fk)
    assert f1[0] == f2[0] and built[-1] is rw and len(built) == 6
    assert list(f1[1]) == list(real(rw).offsets)


def _merged_rows(w, j):
    """Rows of array j of a chain-merged set as packed: a "pad" x operand's
    merged rows (its zero rows between the segments dropped)."""
    segs = fc._x_operand_segs(j) if fc.merged_layout(w) == "pad" else None
    return sum(segs) if segs else w.arrays[j].shape[0]


def test_what_gets_packed(dec_tree, trees):
    """f32 weights: bf16 x f32 products (kind 0; the unmerged decoder's and
    the encoder's GRU matrices rounded, kind 3).  The chain-merged decoder's
    sets, merged and padded, which its split instance runs: every matrix
    of kind 0 and packed as three copies (ceil(K/16) ceil(out/16) 16x16
    tiles each, K the merged rows), and the buffer passed.  The unmerged
    decoder's and the encoder's, which their split instances run: every
    matrix packed, the kind-0 ones as three copies, the kind-3 ones as
    one, and the buffer passed.  A set of no kernel's layout raises."""
    for wf in (fc.decoder_weights(dec_tree, "cpu", merged=True),
               fc.decoder_weights(dec_tree, "cpu", merged="pad")):
        kinds = fc._kinds(wf, fc._rounds(wf, BF, "none"))
        assert set(kinds) == {0}
        mats = [j for j, a in enumerate(wf.arrays) if a.dim() == 2]
        mf = fc.mma_weights(wf)
        assert [j for j, o in enumerate(mf.offsets) if o >= 0] == mats
        assert len(mats) == 17 and {mf.kinds[j] for j in mats} == {0}
        assert mf.buf.numel() // 8 == sum(
            3 * 32 * -(-_merged_rows(wf, j) // 16)
            * -(-wf.arrays[j].shape[1] // 16) for j in mats)
        buf, offs = fc._mma_args(wf, kinds)
        assert buf is not None and buf == fc._mma_args(wf, kinds)[0]
        assert list(offs) == list(mf.offsets)
    for wf in (fc.decoder_weights(dec_tree, "cpu"),
               fc.encoder_weights(trees[80]["encoder"], "cpu")):
        kinds = fc._kinds(wf, fc._rounds(wf, BF, "gru"))
        assert set(kinds) == {0, 3}
        mats = [j for j, a in enumerate(wf.arrays) if a.dim() == 2]
        assert {kinds[j] for j in mats} == {0, 3}
        assert all((kinds[j] == 3) == wf.names[j].endswith(("_wih", "_whh"))
                   for j in mats)
        mf = fc.mma_weights(wf)
        assert [j for j, o in enumerate(mf.offsets) if o >= 0] == mats
        assert mf.buf.numel() // 8 == sum(
            (3 if kinds[j] == 0 else 1) * 32 * -(-wf.arrays[j].shape[0] // 16)
            * -(-wf.arrays[j].shape[1] // 16) for j in mats)
        buf, offs = fc._mma_args(wf, kinds)
        assert buf == fc._mma_args(wf, kinds)[0] and list(offs) == list(
            mf.offsets)
    wd = fc.decoder_weights(dec_tree, "cpu", dtype=BF)
    with pytest.raises(ValueError, match="no decoder, encoder or frame"):
        fc.mma_weights(wd._replace(arrays=wd.arrays[:-1], names=wd.names[:-1]))


@pytest.mark.parametrize("kind", ["int8", "f32"])
@pytest.mark.parametrize("side", ["dec", "enc"])
def test_launch_packs_unmerged_and_encoder(trees, side, kind):
    """A launch with bf16 products of the unmerged decoder or the encoder
    on int8 or f32 weights packs the set on first use, keeps the copy and
    passes its offsets (one per array, every matrix packed)."""
    w = _unmerged_set(trees, side, kind, 80)
    kinds = fc._kinds(w, fc._rounds(w, BF, "gru"))
    a, b = fc._mma_args(w, kinds), fc._mma_args(w, kinds)
    m = _kept(w)
    assert a[0] == b[0] == m.buf.data_ptr()
    assert list(a[1]) == list(m.offsets) == list(fc.mma_weights(w).offsets)
    assert sum(o >= 0 for o in m.offsets) == (27 if side == "dec" else 22)


@pytest.mark.parametrize("latent", [80, 40])
@pytest.mark.parametrize("side", ["dec", "enc", "decm"])
def test_pack_round_trip_split(trees, side, latent):
    """f32 sets of the unmerged decoder, the encoder and the chain-merged
    decoder: each kind-0 matrix unpacks to hi = _bf16(w), mid = _bf16(w -
    hi), lo = _bf16(w - hi - mid) exactly, with |w - hi - mid| <= 2^-17 |w|
    and hi + mid + lo = w (both with 1e-30 for w near bf16's smallest
    normal), and each kind-3 (GRU) matrix to _bf16(w)."""
    ws = _unmerged_set(trees, side, "f32", latent)
    m = fc.mma_weights(ws)
    n_split = 0
    for j, a in enumerate(ws.arrays):
        if a.dim() != 2:
            assert m.offsets[j] == -1
            continue
        if m.kinds[j] == 3:
            assert torch.equal(_unpack(m.buf, m.offsets[j], *a.shape),
                               fc._bf16(a)), ws.names[j]
            continue
        assert m.kinds[j] == 0
        n_split += 1
        hi, mid, lo = (_unpack(m.buf, m.offsets[j], *a.shape, 3, p)
                       for p in range(3))
        assert torch.equal(hi, fc._bf16(a)), ws.names[j]
        assert torch.equal(mid, fc._bf16(a - hi)), ws.names[j]
        assert torch.equal(lo, fc._bf16(a - hi - mid)), ws.names[j]
        w64 = a.double()
        assert ((w64 - hi.double() - mid.double()).abs()
                <= 2.0 ** -17 * w64.abs() + 1e-30).all(), ws.names[j]
        assert ((w64 - hi.double() - mid.double() - lo.double()).abs()
                <= 2.0 ** -24 * w64.abs() + 1e-30).all(), ws.names[j]
    # d1, the glu, the conv taps and out_w; the encoder's d1, taps,
    # z_dense; every matrix of the merged decoder (d1, wih, wgg, cw, out_w)
    assert n_split == {"dec": 2 + 5 * 3, "enc": 2 + 5 * 2,
                       "decm": 2 + 5 * 3}[side]


@pytest.mark.parametrize("side, what, latent, k0, k1", [
    ("enc", "d1", 80, 0, 32), ("enc", "d1", 80, 64, 84),
    ("enc", "z_dense", 40, 448, 864), ("decm", "d1", 40, 32, 40),
    ("decm", "out_w", 80, 384, 736)],
    ids=["d1-chunk0", "d1-tail", "z40-columns", "decm-d1-40-tail",
         "decm-out-chunk1"])
def test_fragment_walk_split(trees, side, what, latent, k0, k1):
    """The walk over the encoder's and the chain-merged decoder's own split
    matrices (f32 weights): hi, mid and lo's fragments, each step's
    products summed lo first and the step added in f32, give _bf16(x) @ W
    over the kernel's K chunks with W the f32 matrix (rtol 1e-5; atol 1e-6
    for sums that cancel to near zero), on the encoder's dense_1 K tail
    (NaN in x past K) and its latent-40 z_dense's 40 columns, and on the
    merged decoder's latent-40 dense_1 (its second K chunk, 8 rows into a
    16-wide step) and the second K chunk of its output (84 columns)."""
    ws = _unmerged_set(trees, side, "f32", latent)
    m = fc.mma_weights(ws)
    j = 0 if what == "d1" else len(ws.arrays) - 2
    K, out = ws.arrays[j].shape
    assert (K, out) == {("enc", "d1"): (84, 64), ("enc", "z_dense"): (864, 40),
                        ("decm", "d1"): (40, 96),
                        ("decm", "out_w"): (736, 84)}[side, what]
    assert m.kinds[j] == 0
    rng = np.random.default_rng(K + k0 + 1)
    x = rng.standard_normal((16, 16 * -(-K // 16) + 8)).astype(np.float32)
    x[:, k1:] = np.nan
    got = _tmma_walk(torch.from_numpy(x), m.buf, m.offsets[j], K, out, k0,
                     k1, parts=3)
    want = (fc._bf16(torch.from_numpy(x[:, k0:k1])).double()
            @ ws.arrays[j].double()[k0:k1]).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
