"""The streaming rx front end (radae_tpu_torch/ops/ofdm.py `rx_front_end`)
on the CPU: the step's outputs through the plain version are the
composition the step ran before it moved, bit for bit; a torch walk of the
CUDA kernel's order of operations (csrc/rx_demod.cu), on the constants the
kernel is given, stays within rtol 1e-4, atol 1e-5 of the plain version
at the flagship and latent-40 geometries, fps 1 and 2, coarse magnitude on
and off; the wrapper's refusals; the launch counter's key."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from radae_tpu_torch import trace
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.models.core import CoreDecoder
from radae_tpu_torch.ops import cplx, fused_core, ofdm
from radae_tpu_torch.ops import pilots as pilots_ops
from radae_tpu_torch.runtime import make_streaming_rx_step

TOL = dict(rtol=1e-4, atol=1e-5)    # the port's CPU gate (ROADMAP)
B = 6


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _samples(cfg, fps, seed, batch=B):
    """fps frames and the next pilot row of modulated random latents a
    stream, through a two-ray channel (a delay of 1-8 samples, a gain of
    0.5), a random phase and noise (std 0.05)."""
    rng = np.random.default_rng(seed)
    z = torch.as_tensor(np.tanh(rng.standard_normal(
        (batch, (fps + 1) * cfg.Nzmf, cfg.latent_dim))).astype(np.float32))
    tx = ofdm.modulate(cfg, z, cplx.const(cfg.P, "cpu"),
                       cplx.const(cfg.Winv, "cpu")).numpy()
    x = tx[..., 0] + 1j * tx[..., 1]
    n = (fps * (cfg.Ns + 1) + 1) * (cfg.M + cfg.Ncp)
    out = np.empty((batch, n), np.complex64)
    for b in range(batch):
        d = int(rng.integers(1, 9))
        g = 0.5 * np.exp(2j * np.pi * rng.random())
        y = x[b].copy()
        y[d:] += g * x[b, :-d]
        y *= np.exp(2j * np.pi * rng.random())
        out[b] = y[:n] + 0.05 * (rng.standard_normal(n)
                                 + 1j * rng.standard_normal(n))
    return torch.as_tensor(cplx.pack_np(out))


def _old_composition(cfg, fps, rx_packed):
    """The front end as make_streaming_rx_step composed it before it moved
    into ops/ofdm.py (the same operations in the same order)."""
    dev = "cpu"
    Ns, Nc = cfg.Ns, cfg.Nc
    Wfwd = cplx.const(cfg.Wfwd, dev)
    ls = pilots_ops.ls_consts(cfg.P, cfg.w, cfg.Fs, dev)
    pil_idx = torch.as_tensor([f * (Ns + 1) for f in range(fps + 1)])
    dat_idx = torch.as_tensor(np.concatenate(
        [f * (Ns + 1) + 1 + np.arange(Ns) for f in range(fps)]))
    steps = torch.arange(1, Ns + 1, dtype=torch.float32)[None, None, :, None]
    P0_abs = float(np.abs(cfg.P[0]))
    n_rs = fps * (Ns + 1) + 1
    Bx = rx_packed.shape[0]
    rx = cplx.from_last(rx_packed).reshape(Bx, n_rs, cfg.M + cfg.Ncp)
    rx_sym = ofdm.dft(ofdm.strip_cp(rx, cfg.M, cfg.Ncp, cfg.time_offset),
                      Wfwd)
    rx_pilots = pilots_ops.est_pilots_ls(rx_sym[:, pil_idx, :], ls)
    p0, p1 = rx_pilots[:, :-1, :], rx_pilots[:, 1:, :]
    slope = (p1 - p0) * (1.0 / (Ns + 1))
    rx_ch = p0[:, :, None, :] + slope[:, :, None, :] * steps
    data = rx_sym[:, dat_idx, :].reshape(Bx, fps, Ns, Nc) \
        * rx_ch.unit().conj()
    if cfg.coarse_mag:
        p2 = 0.5 * (p0.abs2().mean(dim=-1) + p1.abs2().mean(dim=-1))
        mag = torch.sqrt(p2) + 1e-6
        if cfg.bottleneck == 3:
            mag = mag * P0_abs / cfg.pilot_gain
        data = data * (1.0 / mag)[:, :, None, None]
    return ofdm.qpsk_demap(data.reshape(Bx, -1, cfg.latent_dim // 2))


def _butterfly(v, n):
    """A sum over the last axis (n lanes, a power of two) as the kernel's
    shuffles take it: v += v[lane ^ o] for o = n/2, ..., 1; lane 0's."""
    lane = torch.arange(n)
    o = n // 2
    while o:
        v = v + v[..., lane ^ o]
        o //= 2
    return v[..., 0]


def _butterfly_up(v, first):
    """The same over lanes (..., ks), the offsets rising from first: the
    DFT's sum of its sample lanes (o = cg, 2cg, ..., 16 in lane bits)."""
    n = v.shape[-1]
    lane, o = torch.arange(n), 1
    while o < n:
        v = v + v[..., lane ^ o]
        o *= 2
    return v[..., 0]


def _lane_sums(v, n):
    """(..., Nc) -> (..., n): lane l's sum of elements l, l+n, ..."""
    out = torch.zeros(v.shape[:-1] + (n,))
    for c0 in range(0, v.shape[-1], n):
        part = v[..., c0:c0 + n]
        out[..., :part.shape[-1]] = out[..., :part.shape[-1]] + part
    return out


def _kernel_lanes(Nc):
    """The kernel's DFT lanes across Nc carriers (csrc/rx_demod.cu
    `lanes`, which the wrapper reads from the library on a card): four
    carriers a lane, on the fewest lanes, a power of two, that cover
    them."""
    cg = 1
    while cg * ofdm.RX_TC < Nc:
        cg *= 2
    return cg


def _kernel_walk(rx_packed, k, cg=None):
    """csrc/rx_demod.cu's arithmetic in its order, on the constant buffer
    the wrapper gives it (for cg carrier lanes, the kernel's by default):
    the DFT summed over each sample lane's pairs
    (kg, kg + ks, ...) of the lanes' carrier slots and those lanes' sums
    added by the butterfly, the LS fit's four partial sums over the three
    taps, the coarse magnitude by a butterfly over a warp's lanes,
    interpolation, derotation, scale and demap."""
    cfg = k.cfg
    tc, cg = ofdm.RX_TC, cg or _kernel_lanes(cfg.Nc)
    ks, np_ = 32 // cg, cfg.M // 2
    cst = torch.as_tensor(ofdm._rx_kernel_consts(cfg, cg))
    T = -(-np_ // ks)
    n_w = T * tc * ks * cg * 4
    W = cst[:n_w].reshape(T, tc, ks, cg, 2, 2)      # t, j, kg, g, s, re|im
    W = W.permute(0, 2, 4, 3, 1, 5).reshape(T * ks * 2, cg * tc, 2)
    L = cst[n_w:].reshape(cfg.Nc, 16)
    Bx, Nc, Ns, fps = rx_packed.shape[0], cfg.Nc, cfg.Ns, k.fps
    st = cfg.Ncp + cfg.time_offset
    x = rx_packed.reshape(Bx, k.n_rs, cfg.M + cfg.Ncp, 2)[:, :, st:st + cfg.M]
    part = []
    for kg in range(ks):
        re = torch.zeros((Bx, k.n_rs, cg * tc))
        im = torch.zeros_like(re)
        for mp in range(kg, np_, ks):
            for m in (2 * mp, 2 * mp + 1):
                xr, xi = x[:, :, m, 0, None], x[:, :, m, 1, None]
                wr, wi = W[m, :, 0], W[m, :, 1]
                re = re + xr * wr
                re = re + -xi * wi
                im = im + xr * wi
                im = im + xi * wr
        part.append((re, im))
    yr = _butterfly_up(torch.stack([p[0] for p in part], -1), 1)[..., :Nc]
    yi = _butterfly_up(torch.stack([p[1] for p in part], -1), 1)[..., :Nc]
    # LS estimates of the pilot rows f (Ns+1), f = 0..fps
    prow = torch.arange(fps + 1) * (Ns + 1)
    pr, pi = yr[:, prow], yi[:, prow]                  # (B, fps+1, Nc)
    t0 = np.clip(np.arange(Nc), 1, Nc - 2) - 1
    sums = [torch.zeros_like(pr) for _ in range(8)]
    for j in range(3):
        t = t0 + j
        ipr, ipi = L[t, 0], L[t, 1]
        hr = pr[..., t] * ipr - pi[..., t] * ipi
        hi = pr[..., t] * ipi + pi[..., t] * ipr
        p0r, p0i = L[:, 2 + 2 * j], L[:, 3 + 2 * j]
        p1r, p1i = L[:, 8 + 2 * j], L[:, 9 + 2 * j]
        for n, v in enumerate((p0r * hr, p0i * hi, p0r * hi, p0i * hr,
                               p1r * hr, p1i * hi, p1r * hi, p1i * hr)):
            sums[n] = sums[n] + v
    g0r, g0i = sums[0] - sums[1], sums[2] + sums[3]
    g1r, g1i = sums[4] - sums[5], sums[6] + sums[7]
    phr, phi = L[:, 14], L[:, 15]
    er = g0r + (g1r * phr - g1i * phi)
    ei = g0i + (g1r * phi + g1i * phr)
    # each frame's scale, its sum over the warp's lanes
    if cfg.coarse_mag:
        a2 = _butterfly(_lane_sums(er * er + ei * ei, 32), 32)
        p2 = 0.5 * (a2[:, :-1] / Nc + a2[:, 1:] / Nc)
        mag_mul, mag_div = k.args[-2:]
        mg = (torch.sqrt(p2) + 1e-6) * mag_mul / mag_div
        inv = 1.0 / mg                                    # (B, fps)
    else:
        inv = torch.ones((Bx, fps))
    inv_ns1 = torch.tensor(1.0, dtype=torch.float32) / (Ns + 1)
    out = []
    for f in range(fps):
        sr = (er[:, f + 1] - er[:, f]) * inv_ns1
        si = (ei[:, f + 1] - ei[:, f]) * inv_ns1
        for i in range(Ns):
            hr = er[:, f] + sr * float(i + 1)
            hi = ei[:, f] + si * float(i + 1)
            r = torch.sqrt(hr * hr + hi * hi + 1e-12)
            ur, ui = hr / r, hi / r
            row = f * (Ns + 1) + 1 + i
            dr = (yr[:, row] * ur + yi[:, row] * ui) * inv[:, f, None]
            di = (yi[:, row] * ur - yr[:, row] * ui) * inv[:, f, None]
            out.append(torch.stack([dr, di], dim=-1))     # (B, Nc, 2)
    return torch.stack(out, dim=1).reshape(Bx, -1, cfg.latent_dim)


def _tensors(tree):
    return {k: _tensors(v) if isinstance(v, dict)
            else torch.as_tensor(v, dtype=torch.float32)
            for k, v in tree.items()}


GEOMETRIES = {"flagship": {}, "l40": {"latent_dim": 40}}


@pytest.mark.parametrize("fps", [1, 2])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
def test_step_is_the_old_composition_bit_for_bit(fps, fused):
    """The rx step's features on the CPU are the decoder's on the front end
    as the step composed it before the move, to the bit."""
    cfg = flagship_config()
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    params = dec.init(3)
    w = (fused_core.decoder_weights(params, "cpu") if fused
         else _tensors(params))
    state = fused_core.decoder_state_zero(B, "cpu") if fused else None
    step = make_streaming_rx_step(cfg, dec, B, fused=fused,
                                  frames_per_step=fps, device="cpu")
    x = _samples(cfg, fps, 11 + fps)
    with torch.no_grad():
        f, _ = step(w, x, state)
        z = _old_composition(cfg, fps, x)
        assert torch.equal(ofdm.rx_front_end(
            x, ofdm.rx_front_end_consts(cfg, fps, "cpu")), z)
        if fused:
            f_old, _ = fused_core.fused_decoder_step(w, z, state)
        else:
            f_old, _ = dec(w, z, key=None, state=state)
    assert torch.equal(f, f_old)


@pytest.mark.parametrize("coarse_mag", [True, False], ids=["mag", "nomag"])
@pytest.mark.parametrize("fps", [1, 2])
@pytest.mark.parametrize("geometry", sorted(GEOMETRIES))
def test_kernel_walk_matches_plain(geometry, fps, coarse_mag):
    cfg = flagship_config(coarse_mag=coarse_mag, **GEOMETRIES[geometry])
    k = ofdm.rx_front_end_consts(cfg, fps, "cpu")
    x = _samples(cfg, fps, 100 + 10 * fps + coarse_mag)
    want = ofdm.rx_front_end_plain(x, k)
    got = _kernel_walk(x, k)
    assert got.shape == want.shape == (B, fps * cfg.Nzmf, cfg.latent_dim)
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("geometry, cg", [
    ("l40", 4), ("l40", 8), ("l40", 16), ("l40", 32), ("flagship", 8),
    ("flagship", 16), ("flagship", 32)])
def test_carrier_lanes(geometry, cg):
    """The constants for any tiling of cg lanes of four carriers that
    covers Nc (the kernel's own is the fewest, `_kernel_lanes`) put
    carrier g*4+j in lane g's slot j at every sample pair and zeros in
    the slots past Nc; a walk on them stays within the gate."""
    cfg = flagship_config(**GEOMETRIES[geometry])
    assert _kernel_lanes(cfg.Nc) <= cg
    tc, ks, np_ = ofdm.RX_TC, 32 // cg, cfg.M // 2
    T = -(-np_ // ks)
    W = ofdm._rx_kernel_consts(cfg, cg)[:T * tc * ks * cg * 4].reshape(
        T, tc, ks, cg, 2, 2)
    W = W[..., 0] + 1j * W[..., 1]                   # t, j, kg, g, s
    W = W.transpose(0, 2, 4, 3, 1).reshape(T * ks * 2, cg * tc)[:cfg.M]
    np.testing.assert_array_equal(W[:, :cfg.Nc],
                                  cfg.Wfwd.astype(np.complex64))
    assert not W[:, cfg.Nc:].any()
    k = ofdm.rx_front_end_consts(cfg, 1, "cpu")
    x = _samples(cfg, 1, 200 + cg, batch=2)
    torch.testing.assert_close(_kernel_walk(x, k, cg),
                               ofdm.rx_front_end_plain(x, k), **TOL)


@pytest.mark.parametrize("latent", [80, 40])
def test_constants_layout(latent):
    cfg = flagship_config(latent_dim=latent)
    cg, tc = _kernel_lanes(cfg.Nc), ofdm.RX_TC
    ks = 32 // cg
    T = -(-(cfg.M // 2) // ks)
    cst = ofdm._rx_kernel_consts(cfg, cg)
    W = cst[:T * tc * ks * cg * 4].reshape(T, tc, ks, cg, 2, 2)
    t, j, kg, g, s = 7, 1, 3, 2, 1
    c, m = g * tc + j, 2 * (t * ks + kg) + s
    assert W[t, j, kg, g, s, 0] == np.float32(cfg.Wfwd[m, c].real)
    assert W[t, j, kg, g, s, 1] == np.float32(cfg.Wfwd[m, c].imag)
    # carriers Nc.. (slots of the last lanes) hold zeros
    pad = [(gg, jj) for gg in range(cg) for jj in range(tc)
           if gg * tc + jj >= cfg.Nc]
    assert pad and all(not W[:, jj, :, gg].any() for gg, jj in pad)
    L = cst[T * tc * ks * cg * 4:].reshape(cfg.Nc, 8, 2)
    pm = pilots_ops.ls_pmat(cfg.w, cfg.Fs)
    np.testing.assert_array_equal(L[4, 1:7, 0], pm[4].real.ravel())
    np.testing.assert_array_equal(L[4, 0, 1], np.float32((1 / cfg.P[4]).imag))


def test_wrapper_refuses():
    cfg = flagship_config()
    k = ofdm.rx_front_end_consts(cfg, 1, "cpu")
    n = k.n_rs * (cfg.M + cfg.Ncp)
    with pytest.raises(ValueError, match="expected"):
        ofdm.rx_front_end(torch.zeros((B, n - 2, 2)), k)
    with pytest.raises(ValueError, match="expected"):
        ofdm.rx_front_end(torch.zeros((B, n)), k)
    with pytest.raises(ValueError, match="unsupported device"):
        ofdm.rx_front_end(torch.zeros((B, n, 2), device="meta"), k)


def test_cpu_step_launches_no_kernel():
    cfg = flagship_config()
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    step = make_streaming_rx_step(cfg, dec, B, fused=True, device="cpu")
    fused_core.reset_launches()
    with torch.no_grad():
        step(fused_core.decoder_weights(dec.init(0), "cpu"),
             _samples(cfg, 1, 5), fused_core.decoder_state_zero(B, "cpu"))
    assert trace.COUNTERS["launch"]["rx_demod"] == 0


@pytest.mark.parametrize("order", ["trace", "ofdm", "fused_core"])
def test_launch_keys_do_not_depend_on_import_order(order):
    """The launch counter holds rx_demod from trace.py's own definition, and
    the same 24 keys once fused_core is loaded, whichever module comes
    first."""
    code = (f"from radae_tpu_torch.ops import {order}\n" if order != "trace"
            else "from radae_tpu_torch import trace\n") + (
        "from radae_tpu_torch import trace\n"
        "assert 'rx_demod' in trace.COUNTERS['launch']\n"
        "from radae_tpu_torch.ops import fused_core, ofdm\n"
        "print(len(trace.COUNTERS['launch']))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["24"]
