"""The int8 forms with f32 products on the tensor cores (both decoders,
the chain-merged one in either layout, and the encoder), and the padded
decoder's f32 form on the same route, on the CPU, where the kernels cannot
run.

radae_tpu multiplies the f32 x by the int8 matrix q in f32 (then scales the
output columns).  The kernels' int8 instances (csrc/fused_core.cu,
KindSplitXArgs) run x @ q on mma.sync: q widened to bf16 (exact), x split
where it is loaded into hi = bf16(x), mid = bf16(x - hi) and lo = bf16(x -
hi - mid), three bf16 products a K step summed lo first, and a matrix that
quant_exclude keeps in f32 packed split and multiplied as six products of
x's and w's parts.  These tests hold:

  * the packing: an int8 set with f32 products packs to the same bytes,
    offsets and kinds as with bf16 products (the merged and padded, the
    unmerged decoder and the encoder, latent 80 and 40), and a MIXED set
    (chip_smoke.py's: the merged decoder's wgg, the unmerged decoder's whh
    and out_w, the encoder's whh and d1_w in f32) packs its f32 matrices
    split (hi, mid, lo = `fc.split_parts(w)`) where bf16 products pack them
    rounded; with f32 products the padded f32 set packs every matrix split
    from its merged rows, the same bytes as an int8 set that keeps every
    matrix in f32, and no other f32 set has a tensor-core route;
  * the fragment walk: a torch walk over the packed fragments with the
    lane, K permutation and column order of `tmma`, x split into its three
    parts, each step's products summed exactly and truncated to f32 and
    added in f32, gives (x @ q) * scale against an f64 reference (rtol and
    atol 1e-6), on a K tail with NaN planted past K, an 84-column output,
    K ranges that start inside K, and the six-product walk of a split f32
    matrix (MIXED wgg, and a K tail of one); on the unmerged decoder and the
    encoder too (the encoder's with x hi's products summed apart): the
    encoder's dense_1 (K = 84, a tail inside a 16-wide
    step; int8 and kept in f32), a GRU wih chunk and whh (int8 and kept in
    f32), and the unmerged decoder's 84-column output (int8 and kept in
    f32); and the padded f32 set's dense_1 at latent 40 (a K tail) and a
    [tap1 | tap0] chunk across the x segments' seams;
  * the arithmetic: the plain int8 step with its products computed the
    route's way (`tools/split_flips.py` `xroute_products`, "xsplit3", and
    "xsplit3s" for the encoder's, x hi's products summed apart) stays within
    chip_smoke.py's TOL of the plain int8 step over
    three chained calls: `decoder_merged_step_plain` merged and padded,
    `decoder_step_plain` and `encoder_step_plain`, full int8 and MIXED,
    latent 80 and 40 (B=8); and the padded f32 step with every product as
    six, against `decoder_merged_step_plain` on the padded f32 set.
"""

import os

import numpy as np
import pytest
import torch

from chip_smoke import MIXED, TOL
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint
from radae_tpu_torch.ops import fused_core as fc
from tools.split_flips import XPAIRS, _trunc, x_parts, xroute_products

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPTS = {80: "model_fs_flagship.npz", 40: "model_l40.npz"}
F32, BF = torch.float32, torch.bfloat16
EXCL = MIXED["fused_decoder_merged_step_int8"]      # ("wgg",)
PAD_F32 = ("_w", "_wih", "_wgg")    # quant_exclude: every decoder matrix f32
# a set's kind -> its int8 form (the key of MIXED) and its rounding rule
# under bf16 products (fc._rounds)
FORMS = {"merged": ("fused_decoder_merged_step_int8", "none"),
         "pad": ("fused_decoder_merged_step_int8", "none"),
         "unmerged": ("fused_decoder_step_int8", "gru"),
         "enc": ("fused_encoder_step_int8", "gru")}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The products here are tiny (B <= 16): one thread runs them faster
    than a pool that the test workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def trees():
    return {lat: load_checkpoint(os.path.join(ROOT, "fixtures", f))[0]
            for lat, f in CKPTS.items()}


def _set(trees, latent, layout="merged", mixed=False):
    """An int8 set of `layout` (a key of FORMS), its MIXED matrices kept in
    f32 when mixed."""
    excl = MIXED[FORMS[layout][0]] if mixed else ()
    if layout == "enc":
        return fc.encoder_weights(trees[latent]["encoder"], "cpu",
                                  quant="int8", quant_exclude=excl)
    merged = {"merged": True, "pad": "pad", "unmerged": False}[layout]
    return fc.decoder_weights(trees[latent]["decoder"], "cpu", merged=merged,
                              quant="int8", quant_exclude=excl)


def _kept(w, layout):
    """The indices of w's matrices that its MIXED set keeps in f32."""
    excl = MIXED[FORMS[layout][0]]
    return [j for j, n in enumerate(w.names)
            if w.arrays[j].dim() == 2 and n.endswith(excl)]


def _bits(m):
    return m.buf.view(torch.int16)


@pytest.mark.parametrize("latent", [80, 40])
@pytest.mark.parametrize("layout", ["merged", "pad", "unmerged", "enc"])
def test_f32_products_pack_as_mm(trees, layout, latent):
    """An int8 set packs the same for f32 products as for bf16 products
    (every matrix of kind 1, widened to bf16), and a launch of either keeps
    one copy in the set."""
    w = _set(trees, latent, layout)
    mf, mb = fc.mma_weights(w, F32), fc.mma_weights(w)
    assert mf.offsets == mb.offsets and mf.kinds == mb.kinds
    assert torch.equal(_bits(mf), _bits(mb))
    mats = [j for j, a in enumerate(w.arrays) if a.dim() == 2]
    assert [j for j, o in enumerate(mf.offsets) if o >= 0] == mats
    assert {mf.kinds[j] for j in mats} == {1}
    kf = fc._kinds(w, fc._rounds(w, F32, FORMS[layout][1]))
    kb = fc._kinds(w, fc._rounds(w, BF, FORMS[layout][1]))
    assert kf == kb
    a, b = fc._mma_args(w, kf, F32), fc._mma_args(w, kb)
    assert a[0] == b[0] and len(w.mma) == 1
    assert list(a[1]) == list(mf.offsets)


@pytest.mark.parametrize("layout", ["merged", "pad", "unmerged", "enc"])
def test_mixed_packs_f32_split(trees, layout):
    """A MIXED set with f32 products: its matrices kept in f32 (the merged
    decoder's wgg, the unmerged decoder's whh and out_w, the encoder's whh
    and d1_w) are of kind 0 and packed as hi, mid and lo
    (`fc.split_parts`), three copies a K step; with bf16 products they are
    of kind 3 and packed rounded."""
    w = _set(trees, 80, layout, mixed=True)
    mf, mb = fc.mma_weights(w, F32), fc.mma_weights(w)
    wgg = _kept(w, layout)
    assert len(wgg) == (5 if layout in ("merged", "pad") else 6)
    mats = [j for j, a in enumerate(w.arrays) if a.dim() == 2]
    for j in mats:
        want = (0, 3) if j in wgg else (1, 1)
        assert (mf.kinds[j], mb.kinds[j]) == want, w.names[j]
    sizes = sorted((o, j) for j, o in enumerate(mf.offsets) if o >= 0)
    ends = [o for o, _ in sizes[1:]] + [mf.buf.numel() // 8]
    for (o, j), e in zip(sizes, ends):
        K, out = w.arrays[j].shape
        if layout == "pad" and fc._x_operand_segs(j):     # its merged rows
            K = sum(fc._x_operand_segs(j))
        assert e - o == (3 if j in wgg else 1) * 32 * -(-K // 16) * -(-out // 16)
    for j in wgg:
        a = w.arrays[j].numpy()
        n = fc._mma_pack(a).size
        got_f = _bits(mf)[8 * mf.offsets[j]:8 * mf.offsets[j] + 3 * n]
        got_b = _bits(mb)[8 * mb.offsets[j]:8 * mb.offsets[j] + n]
        assert np.array_equal(got_f.numpy().view(np.uint16),
                              fc._mma_pack_split(a).ravel()), w.names[j]
        assert np.array_equal(got_b.numpy().view(np.uint16),
                              fc._mma_pack(fc._bf16(torch.from_numpy(a))
                                           .numpy()).ravel()), w.names[j]


@pytest.mark.parametrize("what", ["unmerged-int8", "merged-f32",
                                  "unmerged-f32", "encoder-f32",
                                  "encoder-int8", "frame-f32", "pad-f32"])
def test_f32_products_only_on_merged_int8(trees, what):
    """f32 products reach the tensor cores on every int8 set (each matrix
    packed) and on the padded f32 decoder set (each matrix split from its
    merged rows, bit for bit as an int8 set packs the matrices that
    quant_exclude keeps in f32), and on no other f32 set (the merged and
    unmerged decoders', the encoder's and the frame kernel's raise)."""
    tree = trees[80]
    kind, dtype = what.split("-")
    quant = "int8" if dtype == "int8" else None
    if kind == "encoder":
        w = fc.encoder_weights(tree["encoder"], "cpu", quant=quant)
    elif kind == "frame":
        w = fc.fused_rx_weights(tree["decoder"], flagship_config(), "cpu")
    else:
        w = fc.decoder_weights(tree["decoder"], "cpu", quant=quant,
                               merged="pad" if kind == "pad" else kind == "merged")
    if quant or kind == "pad":
        m = fc.mma_weights(w, F32)
        mats = [j for j, a in enumerate(w.arrays) if a.dim() == 2]
        assert [j for j, o in enumerate(m.offsets) if o >= 0] == mats
        if kind != "pad":
            return
        assert {m.kinds[j] for j in mats} == {0}
        for j in mats:
            a = w.arrays[j].numpy()
            if fc._x_operand_segs(j):                   # its merged rows
                a = np.concatenate([a[fc.SEG * k:fc.SEG * k + wd] for k, wd in
                                    enumerate(fc._x_operand_segs(j))])
            n = 3 * fc._mma_pack(a).size
            got = _bits(m)[8 * m.offsets[j]:8 * m.offsets[j] + n]
            assert np.array_equal(got.numpy().view(np.uint16),
                                  fc._mma_pack_split(a).ravel()), w.names[j]
        kept = fc.decoder_weights(tree["decoder"], "cpu", merged="pad",
                                  quant="int8", quant_exclude=PAD_F32)
        mk = fc.mma_weights(kept, F32)
        assert mk.offsets == m.offsets and mk.kinds == m.kinds
        assert torch.equal(_bits(mk), _bits(m))
        return
    with pytest.raises(ValueError, match="only int8 weights"):
        fc.mma_weights(w, F32)


def _xs_walk(x, buf, off, K, out, k0, k1, n_w, sep=False):
    """Y = x[:, k0:k1] @ W[k0:k1] for 16 rows of x, as tmma<n_w == 3, XS>
    computes it: per 16-column group and K step, each lane's x (two float4,
    zero at k >= k1) split into hi, mid and lo (xparts), assembled with
    the lane's B registers of each of W's n_w packed copies into the
    m16n8k16 fragments of the PTX ISA; the step's products of the route's
    (x part, W copy) pairs summed exactly and truncated to f32, and the
    step sum added to the lane's f32 sums (rows g, g + 8, columns
    4t..4t+3).  sep (XS_SEP): x hi w hi's step sum truncated apart and
    added to the rest's in f32 first."""
    nks, ncg = -(-K // 16), -(-out // 16)
    blk = buf[8 * off:8 * off + ncg * nks * 256 * n_w].float().reshape(
        ncg, nks, n_w, 32, 8)
    pairs = XPAIRS["xsplit3"][n_w > 1]
    y = torch.zeros((16, 16 * ncg))
    for cg in range(ncg):
        acc = torch.zeros((32, 2, 4))            # lane, row g / g+8, column
        for k in range(k0, k1, 16):
            A = torch.zeros((3, 16, 16))          # x part, fragment row, k
            Bn = torch.zeros((n_w, 2, 16, 8))     # copy, tile, fragment k, col
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                kk = k + 4 * t
                xa = x[g, kk:kk + 4] if kk < k1 else torch.zeros(4)
                xc = x[g + 8, kk:kk + 4] if kk < k1 else torch.zeros(4)
                for i, (pa, pc) in enumerate(zip(x_parts(xa), x_parts(xc))):
                    A[i, g, 2 * t:2 * t + 2], A[i, g + 8, 2 * t:2 * t + 2] = pa[:2], pc[:2]
                    A[i, g, 2 * t + 8:2 * t + 10] = pa[2:]
                    A[i, g + 8, 2 * t + 8:2 * t + 10] = pc[2:]
                for p in range(n_w):
                    b = blk[cg, k // 16, p, lane]
                    for n in range(2):
                        Bn[p, n, 2 * t:2 * t + 2, g] = b[4 * n:4 * n + 2]
                        Bn[p, n, 2 * t + 8:2 * t + 10, g] = b[4 * n + 2:4 * n + 4]
            def step_sum(prs):                             # (tile, 16, 8)
                return _trunc(sum(torch.stack([A[i].double() @ Bn[p, 0].double(),
                                               A[i].double() @ Bn[p, 1].double()])
                                  for i, p in prs))
            D = (step_sum(pairs[:-1]) + step_sum(pairs[-1:]) if sep
                 else step_sum(pairs))
            for lane in range(32):
                g, t = lane >> 2, lane & 3
                for h in range(2):
                    r = g + 8 * h
                    e = torch.stack([D[0, r, 2 * t], D[0, r, 2 * t + 1],
                                     D[1, r, 2 * t], D[1, r, 2 * t + 1]])
                    acc[lane, h] += e
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            c = 16 * cg + 4 * t
            y[g, c:c + 4], y[g + 8, c:c + 4] = acc[lane, 0], acc[lane, 1]
    return y[:, :out]


@pytest.mark.parametrize("latent, mixed, name, k0, k1, shape", [
    (40, False, "d1_w", 32, 40, (40, 96)),
    (80, False, "d1_w", 64, 80, (80, 96)),
    (80, False, "out_w", 384, 736, (736, 84)),
    (80, False, "g1_wih", 64, 96, (96, 288)),
    (80, True, "g1_wgg", 0, 96, (96, 384)),
    (40, True, "g2_wgg", 32, 96, (96, 384))],
    ids=["d1-40-tail", "d1-80-tail", "out84-chunk", "wih-chunk1",
         "wgg-split", "wgg-split-chunk"])
def test_fragment_walk_xsplit(trees, latent, mixed, name, k0, k1, shape):
    """The walk over an int8 set's packed matrices with x in three parts
    gives (x @ q) * scale over the kernel's K chunks (x past k1 holds NaN,
    zeroed, not multiplied); over a MIXED set's split wgg (kept in f32) the
    six products give (x @ w) * 1."""
    w = _set(trees, latent, mixed=mixed)
    m = fc.mma_weights(w, F32)
    j = w.names.index(name)
    a = w.arrays[j]
    assert tuple(a.shape) == shape and (a.dtype == torch.float32) == mixed
    K, out = shape
    rng = np.random.default_rng(K * 7 + k0 + out)
    x = np.tanh(rng.standard_normal((16, 16 * -(-K // 16) + 8))).astype(np.float32)
    x[:, k1:] = np.nan
    x = torch.from_numpy(x)
    scale = w.scales[[i for i, b in enumerate(w.arrays) if b.dim() == 2].index(j)]
    got = _xs_walk(x, m.buf, m.offsets[j], K, out, k0, k1,
                   3 if mixed else 1) * scale
    want = ((x[:, k0:k1].double() @ a.double()[k0:k1]) * scale.double()).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_fragment_walk_xsplit_f32_tail():
    """The six-product walk on a split f32 matrix whose K (40) ends inside a
    16-wide step, x past K holding NaN, from a K start inside K."""
    rng = np.random.default_rng(11)
    wf = (0.1 * rng.standard_normal((40, 48))).astype(np.float32)
    buf = torch.from_numpy(fc._mma_pack_split(wf).ravel().view(np.int16)).view(BF)
    x = np.tanh(rng.standard_normal((16, 56))).astype(np.float32)
    x[:, 40:] = np.nan
    x = torch.from_numpy(x)
    got = _xs_walk(x, buf, 0, 40, 48, 16, 40, 3)
    want = (x[:, 16:40].double() @ torch.from_numpy(wf).double()[16:40]).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("latent, name, k0, k1, shape", [
    (40, "d1_w", 32, 40, (40, 96)),
    (80, "c2_w", 128, 256, (320, 64))],
    ids=["d1-40-tail", "cw-segments-chunk1"])
def test_fragment_walk_pad_f32(trees, latent, name, k0, k1, shape):
    """The six-product walk over the padded f32 set's packed matrices (every
    one split, from its merged rows) gives x @ w over the kernel's K ranges
    with x contiguous, x past k1 holding NaN: dense_1 at latent 40 (K = 40
    ends inside a 16-wide step, its second K chunk from 32) and the second
    layer's [tap1 | tap0] (its second K chunk of three, across the x
    segments' seams at 192 and 224)."""
    w = fc.decoder_weights(trees[latent]["decoder"], "cpu", merged="pad")
    m = fc.mma_weights(w, F32)
    j = w.names.index(name)
    a = w.arrays[j]
    if fc._x_operand_segs(j):
        a = torch.cat([a[fc.SEG * k:fc.SEG * k + wd] for k, wd in
                       enumerate(fc._x_operand_segs(j))])
    assert tuple(a.shape) == shape and m.kinds[j] == 0
    K, out = shape
    rng = np.random.default_rng(K * 3 + k0 + out)
    x = np.tanh(rng.standard_normal((16, 16 * -(-K // 16) + 8))).astype(np.float32)
    x[:, k1:] = np.nan
    x = torch.from_numpy(x)
    got = _xs_walk(x, m.buf, m.offsets[j], K, out, k0, k1, 3)
    want = (x[:, k0:k1].double() @ a.double()[k0:k1]).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("layout, latent, mixed, name, k0, k1, shape", [
    ("enc", 80, False, "d1_w", 64, 84, (84, 64)),
    ("enc", 80, True, "d1_w", 64, 84, (84, 64)),
    ("enc", 80, True, "d1_w", 0, 84, (84, 64)),
    ("enc", 40, False, "g2_wih", 0, 224, (224, 192)),
    ("enc", 80, False, "g3_whh", 0, 64, (64, 192)),
    ("enc", 80, True, "g3_whh", 0, 64, (64, 192)),
    ("unmerged", 80, False, "g2_wih", 160, 224, (224, 288)),
    ("unmerged", 80, True, "g1_whh", 0, 96, (96, 288)),
    ("unmerged", 80, False, "out_w", 384, 736, (736, 84)),
    ("unmerged", 40, True, "out_w", 384, 736, (736, 84))],
    ids=["enc-d1-tail", "enc-d1-split-tail", "enc-d1-split", "enc-wih",
         "enc-whh", "enc-whh-split", "dec-wih-chunk1", "dec-whh-split",
         "dec-out84-chunk", "dec-out84-split-40"])
def test_fragment_walk_xsplit_unmerged(trees, layout, latent, mixed, name, k0,
                                       k1, shape):
    """The walk over the encoder's and the unmerged decoder's packed int8
    sets with x in three parts gives (x @ q) * scale over the kernels' K
    ranges (x past k1 holds NaN, zeroed, not multiplied), and over a MIXED
    set's matrices kept in f32 (split) the six products give (x @ w) * 1:
    the encoder's dense_1 (K = 84 ends inside a 16-wide step, its third K
    chunk from 64), GRU wih and whh, and the unmerged decoder's second wih
    half (from 160), whh and its 84-column output (second K chunk)."""
    w = _set(trees, latent, layout, mixed)
    m = fc.mma_weights(w, F32)
    j = w.names.index(name)
    a = w.arrays[j]
    kept = mixed and j in _kept(w, layout)
    assert tuple(a.shape) == shape and (a.dtype == torch.float32) == kept
    assert m.kinds[j] == (0 if kept else 1)
    K, out = shape
    rng = np.random.default_rng(K * 5 + k0 + out + latent)
    x = np.tanh(rng.standard_normal((16, 16 * -(-K // 16) + 8))).astype(np.float32)
    x[:, k1:] = np.nan
    x = torch.from_numpy(x)
    scale = w.scales[[i for i, b in enumerate(w.arrays) if b.dim() == 2].index(j)]
    got = _xs_walk(x, m.buf, m.offsets[j], K, out, k0, k1,
                   3 if kept else 1, sep=layout == "enc") * scale
    want = ((x[:, k0:k1].double() @ a.double()[k0:k1]) * scale.double()).float()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("latent", [80, 40])
@pytest.mark.parametrize("mixed", [False, True], ids=["int8", "mixed"])
@pytest.mark.parametrize("layout", ["unmerged", "enc"])
def test_route_step_within_tol_unmerged(trees, monkeypatch, layout, mixed,
                                        latent):
    """Three chained calls of the unmerged decoder's and the encoder's plain
    int8 steps with their products computed their kernels' way (x's three
    parts, 16-wide step sums truncated to f32 and added in f32, the
    encoder's x hi's products summed apart: "xsplit3s"; six products on a
    kept-f32 matrix) stay within TOL of `decoder_step_plain` and
    `encoder_step_plain`, full int8 and MIXED."""
    w = _set(trees, latent, layout, mixed)
    mm = xroute_products(w, "xsplit3s" if layout == "enc" else "xsplit3")
    rng = np.random.default_rng(17 + latent + 2 * mixed + (layout == "enc"))
    B = 8
    if layout == "enc":
        sk = sp = fc.encoder_state_zero(B, "cpu")
        step = lambda x, st: fc.encoder_step_plain(w, x, st)
        draw = lambda: (0.3 * rng.standard_normal((B, 12, 21))).astype(np.float32)
    else:
        sk = sp = fc.decoder_state_zero(B, "cpu")
        step = lambda x, st: fc.decoder_step_plain(w, x, st)
        draw = lambda: np.tanh(rng.standard_normal((B, 3, latent))).astype(np.float32)
    real = fc._products
    for _ in range(3):
        x = torch.from_numpy(draw())
        fp, sp = step(x, sp)
        monkeypatch.setattr(fc, "_products", lambda *a, **k: mm)
        fk, sk = step(x, sk)
        monkeypatch.setattr(fc, "_products", real)
        for g, want in zip((fk,) + sk, (fp,) + sp):
            torch.testing.assert_close(g, want, **TOL)


@pytest.mark.parametrize("latent", [80, 40])
@pytest.mark.parametrize("mixed", [False, True], ids=["int8", "mixed"])
@pytest.mark.parametrize("layout", ["merged", "pad"])
def test_route_step_within_tol(trees, monkeypatch, layout, mixed, latent):
    """Three chained calls of the int8 merged step with its products
    computed the route's way (x's three parts, 16-wide step sums truncated
    to f32 and added in f32; six products on a kept-f32 matrix), on the
    merged weights as the kernel reads a padded set, stay within TOL of
    `decoder_merged_step_plain` on the set itself."""
    w = _set(trees, latent, layout, mixed)
    w_route = _set(trees, latent, "merged", mixed)
    mm = xroute_products(w_route, "xsplit3")
    rng = np.random.default_rng(latent + 2 * mixed + (layout == "pad"))
    B = 8
    sk = sp = fc.decoder_state_zero(B, "cpu", merged=True)
    real = fc._products
    for _ in range(3):
        z = torch.from_numpy(np.tanh(rng.standard_normal((B, 3, latent)))
                             .astype(np.float32))
        fp, sp = fc.decoder_merged_step_plain(w, z, sp)
        monkeypatch.setattr(fc, "_products", lambda *a, **k: mm)
        fk, sk = fc.decoder_merged_step_plain(w_route, z, sk)
        monkeypatch.setattr(fc, "_products", real)
        for g, want in zip((fk,) + sk, (fp,) + sp):
            torch.testing.assert_close(g, want, **TOL)


@pytest.mark.parametrize("latent", [80, 40])
def test_route_step_within_tol_pad_f32(trees, monkeypatch, latent):
    """Three chained calls of the padded f32 step with every product computed
    its kernel's way (x's three parts against the three parts of each
    matrix, kind 0: six products, 16-wide step sums truncated to f32 and
    added in f32), on the merged weights as the kernel reads a padded set,
    stay within TOL of `decoder_merged_step_plain` on the padded set."""
    w = fc.decoder_weights(trees[latent]["decoder"], "cpu", merged="pad")
    w_route = fc.decoder_weights(trees[latent]["decoder"], "cpu", merged=True)
    mm = xroute_products(w_route, "xsplit3")
    rng = np.random.default_rng(31 + latent)
    B = 8
    sk = sp = fc.decoder_state_zero(B, "cpu", merged=True)
    real = fc._products
    for _ in range(3):
        z = torch.from_numpy(np.tanh(rng.standard_normal((B, 3, latent)))
                             .astype(np.float32))
        fp, sp = fc.decoder_merged_step_plain(w, z, sp)
        monkeypatch.setattr(fc, "_products", lambda *a, **k: mm)
        fk, sk = fc.decoder_merged_step_plain(w_route, z, sk)
        monkeypatch.setattr(fc, "_products", real)
        for g, want in zip((fk,) + sk, (fp,) + sp):
            torch.testing.assert_close(g, want, **TOL)
