"""The whole-frame rx step (radae_tpu_torch/ops/fused_core.py
`fused_rx_weights`, `rx_frame_step_plain`, `make_fused_rx_frame_step`)
against radae_tpu's `make_fused_rx_frame_step` Pallas kernel in interpret
mode and against the port's own composite rx step, on the CPU (fixture
weights, 3 chained frames; rtol 1e-4, atol 1e-5), for the flagship modem and
for the latent-40 one (Nc=15, fixtures/model_l40.npz; atol 1e-4, see
TOL40).  The CUDA frame kernel is held against `rx_frame_step_plain` on
the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from radae_tpu.config import flagship_config as jax_flagship_config
from radae_tpu.ops import fused_core as jfc
from radae_tpu_torch import runtime
from radae_tpu_torch.config import flagship_config
from radae_tpu_torch.convert import load_checkpoint, params_to_torch
from radae_tpu_torch.models.core import CoreDecoder
from radae_tpu_torch.ops import fused_core as fc

TOL = dict(rtol=1e-4, atol=1e-5)
# At latent 40 the plain step and radae_tpu's kernel differ by up to 6.5e-05
# in the decoder state on these Gaussian-noise frames (the flagship: 5e-06):
# the DFT and LS sums run in another order, and the EQ divides by |h| of
# the LS estimates, which noise makes small on some of the 15 carriers.
TOL40 = dict(rtol=1e-4, atol=1e-4)
B, NF = 8, 3
FLAGSHIP, L40 = "fixtures/model_fs_flagship.npz", "fixtures/model_l40.npz"
# name -> (config overrides, checkpoint, tolerance)
CONFIGS = {"flagship": ({}, FLAGSHIP, TOL),
           "no_coarse_mag": ({"coarse_mag": False}, FLAGSHIP, TOL),
           "latent40": ({"latent_dim": 40}, L40, TOL40)}


@pytest.fixture(scope="module")
def trees():
    return {path: load_checkpoint(path)[0] for path in (FLAGSHIP, L40)}


@pytest.fixture(scope="module")
def tree(trees):
    return trees[FLAGSHIP]


def _frames(cfg, seed):
    """NF frame-aligned rx windows (B, (Ns+2)(M+Ncp), 2) of Gaussian IQ."""
    rng = np.random.default_rng(seed)
    n = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)
    return [(0.5 * rng.standard_normal((B, n, 2))).astype(np.float32)
            for _ in range(NF)]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rx_frame_weights_equal_jax(trees, name):
    overrides, path, _ = CONFIGS[name]
    tree = trees[path]
    cfg = flagship_config(**overrides)
    ours = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    ref = jfc.fused_rx_weights(tree["decoder"],
                               jax_flagship_config(**overrides))
    arrs = ours.w.arrays
    assert len(ref) == 4 + fc.N_DEC and len(arrs) == len(ref) + 2
    samp = cfg.M + cfg.Ncp
    for a, r in zip(arrs[:2], ref[:2]):        # Wr, Wi: 192 of 256 rows
        r = np.asarray(r)
        np.testing.assert_array_equal(a.numpy(), r[:samp])
        assert not r[samp:].any()
    for a, r in zip(arrs[2:len(ref)], ref[2:]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(r))
    for a in arrs:
        assert a.data_ptr() % 16 == 0
    assert ours.n_sym == cfg.Ns + 2 and ours.samp == samp
    assert ours.geometry == (cfg.Ns, cfg.Nc, samp, cfg.latent_dim, cfg.Nzmf)
    assert ours.coarse_mag == cfg.coarse_mag
    assert ours.decoder.names == tuple(
        jfc._fused_weights(tree["decoder"], "decoder")[1])


def test_kernel_block_matrices_compute_the_planes_products(tree):
    """dft_w maps a symbol row's interleaved IQ to [Yr | Yi], and ls_w maps
    [Yr | Yi] of a pilot row to the LS estimate [hr | hi]."""
    cfg = flagship_config()
    w = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    Wr, Wi, Er, Ei = w.w.arrays[:4]
    dft_w, ls_w = w.w.arrays[-2:]
    assert w.w.names[-2:] == ("dft_w", "ls_w")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (B, cfg.M + cfg.Ncp, 2)).astype(np.float32))
    xr, xi = x[..., 0], x[..., 1]
    Yr, Yi = xr @ Wr - xi @ Wi, xr @ Wi + xi @ Wr
    Y = x.reshape(B, -1) @ dft_w
    torch.testing.assert_close(Y, torch.cat([Yr, Yi], -1), **TOL)
    torch.testing.assert_close(
        Y @ ls_w, torch.cat([Yr @ Er - Yi @ Ei, Yr @ Ei + Yi @ Er], -1), **TOL)


def test_padded_block_matrices_give_the_unpadded_products(trees):
    """At latent 40 (Nc=15) the kernel's [Yr | Yi] row is padded from 30
    to 32 columns: dft_w has zero columns and ls_w zero rows and columns
    there, so the products are the unpadded ones followed by zeros."""
    cfg = flagship_config(latent_dim=40)
    w = fc.fused_rx_weights(trees[L40]["decoder"], cfg, "cpu")
    Wr, Wi, Er, Ei = w.w.arrays[:4]
    dft_w, ls_w = w.w.arrays[-2:]
    Nc = cfg.Nc
    assert Nc == 15 and tuple(dft_w.shape) == (2 * (cfg.M + cfg.Ncp), 32)
    assert tuple(ls_w.shape) == (32, 32)
    assert not dft_w[:, 2 * Nc:].any() and not ls_w[2 * Nc:].any() \
        and not ls_w[:, 2 * Nc:].any()
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (B, cfg.M + cfg.Ncp, 2)).astype(np.float32))
    xr, xi = x[..., 0], x[..., 1]
    Yr, Yi = xr @ Wr - xi @ Wi, xr @ Wi + xi @ Wr
    pad = torch.zeros((B, 2))
    Y = x.reshape(B, -1) @ dft_w
    torch.testing.assert_close(Y, torch.cat([Yr, Yi, pad], -1), **TOL)
    torch.testing.assert_close(
        Y @ ls_w,
        torch.cat([Yr @ Er - Yi @ Ei, Yr @ Ei + Yi @ Er, pad], -1), **TOL)


@pytest.mark.parametrize("name, rx_dma",
                         [(n, False) for n in CONFIGS]
                         + [(n, True) for n in CONFIGS],
                         ids=list(CONFIGS) + [f"{n}-rx_dma" for n in CONFIGS])
def test_rx_frame_plain_matches_pallas_interpret(trees, name, rx_dma):
    """Against radae_tpu's frame kernel with the sample block in VMEM
    (rx_dma=False, bench.py's frame_vmem) and copied by hand from HBM
    (rx_dma=True, its frame): the port has one kernel for both (its
    samples staged by cp.async) and one plain version."""
    overrides, path, tol = CONFIGS[name]
    tree = trees[path]
    cfg = flagship_config(**overrides)
    jcfg = jax_flagship_config(**overrides)
    w = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    jstep = jfc.make_fused_rx_frame_step(jcfg, B, tile=4, interpret=True,
                                         rx_dma=rx_dma)
    jw = jfc.fused_rx_weights(tree["decoder"], jcfg)
    state, jstate = fc.decoder_state_zero(B, "cpu"), jfc.decoder_state_zero(B)
    for rx in _frames(cfg, 6):
        f, state = fc.rx_frame_step_plain(w, torch.as_tensor(rx), state)
        f_ref, jstate = jstep(jw, rx, *jstate)
        np.testing.assert_allclose(f.numpy(), np.asarray(f_ref), **tol)
        for s, r in zip(state, jstate):
            np.testing.assert_allclose(s.numpy(), np.asarray(r), **tol)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_rx_frame_step_matches_the_composite_rx_step(trees, name):
    overrides, path, tol = CONFIGS[name]
    tree = trees[path]
    cfg = flagship_config(**overrides)
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    comp = runtime.make_streaming_rx_step(cfg, dec, B, device="cpu")
    step = fc.make_fused_rx_frame_step(cfg, B, device="cpu")
    w = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    params = params_to_torch(tree, "cpu")["decoder"]
    st, cst = fc.decoder_state_zero(B, "cpu"), None
    for rx in _frames(cfg, 7):
        f, st = step(w, torch.as_tensor(rx), st)
        f_ref, cst = comp(params, torch.as_tensor(rx), cst)
        assert tuple(f.shape) == (B, 12, cfg.feature_dim)
        torch.testing.assert_close(f, f_ref, **tol)


def test_rx_frame_step_checks_its_inputs(tree):
    cfg = flagship_config()
    step = fc.make_fused_rx_frame_step(cfg, B, device="cpu")
    w = fc.fused_rx_weights(tree["decoder"], cfg, "cpu")
    n = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)
    with pytest.raises(ValueError, match="built for batch"):
        step(w, torch.zeros((B + 1, n, 2)), fc.decoder_state_zero(B + 1, "cpu"))
    with pytest.raises(ValueError, match="state leading dim"):
        step(w, torch.zeros((B, n, 2)), fc.decoder_state_zero(B - 1, "cpu"))
    with pytest.raises(ValueError, match="samples"):
        step(w, torch.zeros((B, n + 2, 2)), fc.decoder_state_zero(B, "cpu"))
