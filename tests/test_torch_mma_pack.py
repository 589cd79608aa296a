"""The fragment-packed weights of the tensor-core route (`mma_weights`) on
the CPU, where the kernels cannot run.

The MM instances of both decoders, the encoder and the frame kernel read
their matrices as mma.sync.m16n8k16 B fragments packed on the host.  These
tests hold the packing and its index arithmetic:

  * unpacked, each packed matrix is exactly what the plain version
    multiplies by: the int8 values q, the bf16 values w, and `_bf16(w)` for
    f32 matrices rounded at the product (the frame kernel's, and those an
    int8 set's quant_exclude keeps in f32), for the merged and the unmerged
    decoder and the encoder at latent 80 and 40; f32 sets of the decoders
    and the encoder pack nothing;
  * a merged="pad" set packs to the same bytes as its merged set;
  * a plain torch walk over the packed fragments, with the lane, K
    permutation and column order that `tmma` in csrc/fused_core.cu uses,
    gives `_bf16(x) @ W` (atol 1e-5: the same exact products summed in
    another f32 order), also with a K tail (K = 40, NaN planted in x past
    K, which the kernel must zero rather than multiply by a zero row), an
    `out` of 84 (zero columns to 96) and a K range that starts inside K,
    and on the encoder's own packed matrices: its 84-wide dense_1 (a K
    tail) and its 40-column z_dense at latent 40 (a column tail);
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
    "bf16", "int8" or "int8-exclude" (EXCLUDE's matrices in f32)."""
    kw = {"f32": {}, "bf16": {"dtype": BF}, "int8": {"quant": "int8"},
          "int8-exclude": {"quant": "int8", "quant_exclude": EXCLUDE[side]}}[kind]
    tree = trees[latent]
    return (fc.decoder_weights(tree["decoder"], "cpu", **kw) if side == "dec"
            else fc.encoder_weights(tree["encoder"], "cpu", **kw))


def _unpack(buf, off, K, out):
    """The (K, out) f32 values of a packed matrix: the inverse of
    `_mma_pack`, read lane by lane as the kernel reads its B fragments."""
    nks, ncg = -(-K // 16), -(-out // 16)
    blk = buf[8 * off:8 * off + ncg * nks * 256].float().reshape(
        ncg, nks, 32, 8)
    w = torch.zeros((16 * nks, 16 * ncg))
    for lane in range(32):
        g, t = lane >> 2, lane & 3
        for n in range(2):                       # n8 tiles
            col = 4 * (g >> 1) + 2 * n + (g & 1)
            for i in range(4):
                w[4 * t + i::16, col::16] = blk[:, :, lane, 4 * n + i].T
    return w[:K, :out]


def _tmma_walk(x, buf, off, K, out, k0, k1):
    """Y[:, :] = x[:, k0:k1] @ W[k0:k1] for 16 rows of x, as tmma computes
    it: per 16-column group and K step, each lane's A registers (two float4
    of x rounded to bf16, zero at k >= k1) and B registers (16 bytes of the
    packed matrix) assembled into the m16n8k16 fragments of the PTX ISA,
    the two n8 tiles' products, and the lane's sums (rows g, g + 8,
    columns 4t..4t+3) written where the kernel's epilogue puts them."""
    nks, ncg = -(-K // 16), -(-out // 16)
    blk = buf[8 * off:8 * off + ncg * nks * 256].float().reshape(
        ncg, nks, 32, 8)
    xb = fc._bf16(x)
    y = torch.zeros((16, 16 * ncg))
    for cg in range(ncg):
        acc = torch.zeros((32, 2, 4))            # lane, row g / g+8, column
        for k in range(k0, k1, 16):
            A = torch.zeros((16, 16))             # fragment row, fragment k
            Bn = torch.zeros((2, 16, 8))          # tile, fragment k, column
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
                b = blk[cg, k // 16, lane]
                for n in range(2):               # b0, b1 of tile n: column g
                    Bn[n, 2 * t:2 * t + 2, g] = b[4 * n:4 * n + 2]
                    Bn[n, 2 * t + 8:2 * t + 10, g] = b[4 * n + 2:4 * n + 4]
            D = torch.stack([A @ Bn[0], A @ Bn[1]])   # (tile, 16, 8)
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
                                {"quant": "int8", "quant_exclude": ("wgg",)}],
                         ids=["int8", "bf16", "int8-exclude"])
def test_pad_packs_as_merged(dec_tree, kw):
    """A merged="pad" set packs to the same bytes as its merged set: the
    zero rows between the 128-row segments are dropped."""
    merged = fc.mma_weights(fc.decoder_weights(dec_tree, "cpu", merged=True,
                                               **kw))
    pad = fc.mma_weights(fc.decoder_weights(dec_tree, "cpu", merged="pad",
                                            **kw))
    assert merged.offsets == pad.offsets and merged.kinds == pad.kinds
    assert torch.equal(merged.buf.view(torch.int16), pad.buf.view(torch.int16))
    if "quant_exclude" in kw:      # the excluded f32 matrices: rounded
        assert set(merged.kinds[j] for j in range(len(merged.kinds))
                   if merged.offsets[j] >= 0) == {1, 3}


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
                        lambda ws: built.append(ws) or real(ws))
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


def test_what_gets_packed(dec_tree, trees):
    """f32 weights of either decoder layout and of the encoder: bf16 x f32
    products (kind 0; the unmerged decoder's and the encoder's GRU matrices
    rounded, kind 3), which the FMA instances run: nothing packed and no
    buffer passed.  A set of no kernel's layout raises."""
    for wf, rule in ((fc.decoder_weights(dec_tree, "cpu", merged=True), "none"),
                     (fc.decoder_weights(dec_tree, "cpu"), "gru"),
                     (fc.encoder_weights(trees[80]["encoder"], "cpu"), "gru")):
        kinds = fc._kinds(wf, fc._rounds(wf, BF, rule))
        assert set(kinds) == ({0} if rule == "none" else {0, 3})
        mf = fc.mma_weights(wf)
        assert mf.buf.numel() == 0 and set(mf.offsets) == {-1}
        buf, offs = fc._mma_args(wf, kinds)
        assert buf is None and set(offs) == {-1}
    wd = fc.decoder_weights(dec_tree, "cpu", dtype=BF)
    with pytest.raises(ValueError, match="no decoder, encoder or frame"):
        fc.mma_weights(wd._replace(arrays=wd.arrays[:-1], names=wd.names[:-1]))


@pytest.mark.parametrize("side", ["dec", "enc"])
def test_launch_packs_unmerged_and_encoder(trees, side):
    """A launch with bf16 products of the unmerged decoder or the encoder
    on int8 weights packs the set on first use, keeps the copy and passes
    its offsets (one per array, every matrix packed)."""
    w = _unmerged_set(trees, side, "int8", 80)
    kinds = fc._kinds(w, fc._rounds(w, BF, "gru"))
    a, b = fc._mma_args(w, kinds), fc._mma_args(w, kinds)
    m = _kept(w)
    assert a[0] == b[0] == m.buf.data_ptr()
    assert list(a[1]) == list(m.offsets) == list(fc.mma_weights(w).offsets)
    assert sum(o >= 0 for o in m.offsets) == (27 if side == "dec" else 22)
