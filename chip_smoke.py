#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, then at the full width of the
flagship model (21 features, latent 80, bottleneck 3, pilots, 4 ms CP, LS
EQ, coarse magnitude):

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card over
     3 chained calls with carried state: at B=2048 with one frame (3
     latent steps) a call, and at a ragged B=37 with one and with two
     frames a call (rtol 1e-4, atol 1e-4: the sums run in another order
     than cuBLAS);
  3. drives the batched streaming serving path on the fixture checkpoint:
     2048 streams of fixtures/speech_feats.f32 through 20 tx steps, then
     the frame-aligned rx windows through 20 rx steps, both fused; checks
     that both kernels launched, that the features match the same path
     with the plain layers (1e-3), that the mean distortion loss is below
     0.65, and that streams 0-3 give the losses radae_tpu gives on the CPU;
  4. times the steps and the kernels with CUDA events;
  5. prints a `kernels` JSON line, and last the `ok` JSON line.

Any failure exits non-zero without the `ok` line; so does a machine without
a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
B = 2048                 # serving batch: independent streams
RAGGED_B = 37            # not a multiple of the kernels' 16-row block
N_FRAMES = 20            # 120 ms modem frames per stream in phase 3
ROW_STEP = 37            # stream b starts at feature row b*37 (wrapped)
TOL = dict(rtol=1e-4, atol=1e-4)
E2E_TOL = 1e-3
LOSS_LIMIT = 0.65
# per-stream distortion loss of streams 0-3 through radae_tpu's
# make_streaming_tx_step/make_streaming_rx_step on the CPU, same inputs
JAX_LOSS_0_3 = [0.332894, 0.566543, 0.52081007, 0.49320942]
H100_F32_FLOPS = 67e12   # f32 outside the tensor cores (SXM data sheet)
H100_BYTES_S = 3.35e12   # HBM3


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()
    return out[0]


def max_err(a, b) -> float:
    return max(float((x - y).abs().max()) for x, y in zip(a, b))


def check_close(what, got, want, tol):
    import torch
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.allclose(g, w, **tol):
            raise AssertionError(
                f"{what}[{i}]: max abs err {float((g - w).abs().max()):.3g} "
                f"outside {tol}")


def time_ms(fn, n, warmup=3) -> float:
    """Mean device time of fn() over n calls, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def bound(weights, inputs, outputs, nz, batch):
    """Least time for one launch: each input read once and each output
    written once at the HBM rate, or 2 flop per weight-matrix element per
    z-step per stream at the f32 rate, whichever is larger."""
    nbytes = 4 * (weights.buf.numel() + sum(t.numel() for t in inputs)
                  + sum(t.numel() for t in outputs))
    flops = 2.0 * sum(a.numel() for a in weights.arrays if a.dim() == 2) \
        * nz * batch
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint, params_to_torch
    from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32
    from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder, distortion_loss
    from radae_tpu_torch.ops import _kernels
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.runtime import make_streaming_rx_step, make_streaming_tx_step

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.time()
    procs = {name: _kernels.start_build(name) for name in ("fused_core",)}
    for name, proc in procs.items():
        log = _kernels.finish_build(name, proc)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    cfg = flagship_config()
    tree, _ = load_checkpoint(os.path.join(HERE, "fixtures", "model_fs_flagship.npz"))
    dw = fc.decoder_weights(tree["decoder"], dev)
    ew = fc.encoder_weights(tree["encoder"], dev)
    gen = np.random.default_rng(0)
    nz = cfg.Nzmf

    # -- kernels against their plain versions -----------------------------
    errs = {"fused_decoder_step": 0.0, "fused_encoder_step": 0.0}
    with torch.no_grad():
        for batch, steps in ((B, nz), (RAGGED_B, nz), (RAGGED_B, 2 * nz)):
            sk = sp = fc.decoder_state_zero(batch, dev)
            ek = ep = fc.encoder_state_zero(batch, dev)
            for frame in range(3):
                z = torch.as_tensor(np.tanh(gen.standard_normal(
                    (batch, steps, cfg.latent_dim))).astype(np.float32), device=dev)
                fk, sk = fc.fused_decoder_step(dw, z, sk)
                fp, sp = fc.decoder_step_plain(dw, z, sp)
                torch.cuda.synchronize()
                check_close(f"decoder B={batch} nz={steps} call {frame}", (fk,) + sk,
                            (fp,) + sp, TOL)
                f = torch.as_tensor((0.3 * gen.standard_normal(
                    (batch, 4 * steps, cfg.feature_dim))).astype(np.float32),
                    device=dev)
                zk, ek = fc.fused_encoder_step(ew, f, ek, cfg.bottleneck)
                zp, ep = fc.encoder_step_plain(ew, f, ep, cfg.bottleneck)
                torch.cuda.synchronize()
                check_close(f"encoder B={batch} nz={steps} call {frame}", (zk,) + ek,
                            (zp,) + ep, TOL)
                if batch == B:
                    errs["fused_decoder_step"] = max(
                        errs["fused_decoder_step"], max_err((fk,) + sk, (fp,) + sp))
                    errs["fused_encoder_step"] = max(
                        errs["fused_encoder_step"], max_err((zk,) + ek, (zp,) + ep))
    print(f"kernels vs plain (rtol 1e-4, atol 1e-4): max abs err "
          f"decoder {errs['fused_decoder_step']:.3g} "
          f"encoder {errs['fused_encoder_step']:.3g}")

    # -- the serving path on the fixture ----------------------------------
    raw = read_f32(os.path.join(HERE, "fixtures", "speech_feats.f32"),
                   NB_TOTAL_FEATURES)
    T = N_FRAMES * nz * 4
    feats = np.zeros((B, T, cfg.feature_dim), np.float32)
    for b in range(B):
        o = (b * ROW_STEP) % (len(raw) - T)
        feats[b, :, :NUM_USED_FEATURES] = raw[o:o + T, :NUM_USED_FEATURES]
    feats[:, :, NUM_USED_FEATURES] = -1.0          # auxdata column
    feats = torch.as_tensor(feats, device=dev)
    enc = CoreEncoder(cfg.feature_dim, cfg.latent_dim, cfg.bottleneck)
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    params = params_to_torch(tree, dev)
    Nmf, win = cfg.Nmf, cfg.Nmf + cfg.M + cfg.Ncp

    def tx_rx(fused):
        tx = make_streaming_tx_step(cfg, enc, B, fused=fused, device=dev)
        rx = make_streaming_rx_step(cfg, dec, B, fused=fused, device=dev)
        ep, dp = ((ew, dw) if fused else (params["encoder"], params["decoder"]))
        es = fc.encoder_state_zero(B, dev) if fused else None
        ds = fc.decoder_state_zero(B, dev) if fused else None
        sig = []
        for k in range(N_FRAMES):
            s, es = tx(ep, feats[:, 12 * k:12 * (k + 1)], es)
            sig.append(s)
        sig.append(torch.zeros((B, win - Nmf, 2), device=dev))
        sig = torch.cat(sig, dim=1)
        out = []
        for k in range(N_FRAMES):
            f, ds = rx(dp, sig[:, k * Nmf:k * Nmf + win], ds)
            out.append(f)
        return torch.cat(out, dim=1)

    with torch.no_grad():
        fc.reset_launches()
        f_fused = tx_rx(True)
        torch.cuda.synchronize()
        launches = dict(fc.LAUNCHES)
        f_plain = tx_rx(False)
        torch.cuda.synchronize()
    if not all(n > 0 for n in launches.values()):
        raise AssertionError(f"a kernel did not launch on the main path: {launches}")
    if tuple(f_fused.shape) != (B, T, cfg.feature_dim) or not bool(torch.isfinite(f_fused).all()):
        raise AssertionError(f"bad features: shape {tuple(f_fused.shape)}")
    e2e_err = float((f_fused - f_plain).abs().max())
    if e2e_err > E2E_TOL:
        raise AssertionError(f"fused vs plain path: max abs err {e2e_err:.3g} > {E2E_TOL}")
    loss = distortion_loss(feats, f_fused)
    mean_loss = float(loss.mean())
    if not mean_loss < LOSS_LIMIT:
        raise AssertionError(f"mean distortion loss {mean_loss:.4f} >= {LOSS_LIMIT}")
    ref_err = float(np.abs(loss[:4].cpu().numpy() - JAX_LOSS_0_3).max())
    if ref_err > 1e-3:
        raise AssertionError(f"streams 0-3 loss {loss[:4].tolist()} vs "
                             f"radae_tpu {JAX_LOSS_0_3}")
    print(f"serving path B={B} x {N_FRAMES} frames: launches {launches}, "
          f"fused vs plain max abs err {e2e_err:.3g}, mean loss "
          f"{mean_loss:.4f}, streams 0-3 {[round(x, 4) for x in loss[:4].tolist()]} "
          f"(radae_tpu {JAX_LOSS_0_3}, max diff {ref_err:.2g})")

    # -- timing -----------------------------------------------------------
    with torch.no_grad():
        tx = make_streaming_tx_step(cfg, enc, B, fused=True, device=dev)
        rx = make_streaming_rx_step(cfg, dec, B, fused=True, device=dev)
        f12 = feats[:, :12].contiguous()
        rx_win = torch.zeros((B, win, 2), device=dev)
        rx_win[:, :Nmf] = tx(ew, f12, fc.encoder_state_zero(B, dev))[0]
        es, ds = fc.encoder_state_zero(B, dev), fc.decoder_state_zero(B, dev)
        tx_ms = time_ms(lambda: tx(ew, f12, es), 20)
        rx_ms = time_ms(lambda: rx(dw, rx_win, ds), 20)
        z = torch.as_tensor(np.tanh(gen.standard_normal(
            (B, nz, cfg.latent_dim))).astype(np.float32), device=dev)
        f = feats[:, :4 * nz].contiguous()
        dec_ms = time_ms(lambda: fc.fused_decoder_step(dw, z, ds), 50)
        dec_plain_ms = time_ms(lambda: fc.decoder_step_plain(dw, z, ds), 10)
        enc_ms = time_ms(lambda: fc.fused_encoder_step(ew, f, es), 50)
        enc_plain_ms = time_ms(lambda: fc.encoder_step_plain(ew, f, es), 10)
        feats_out, ds1 = fc.decoder_step_plain(dw, z, ds)
        z_out, es1 = fc.encoder_step_plain(ew, f, es)
    frame_s = cfg.Tmf                               # 0.12 s of audio
    print(f"tx step B={B}: {tx_ms:.4f} ms/frame, "
          f"{B * frame_s / (tx_ms / 1e3):.0f} audio-s/s")
    print(f"rx step B={B}: {rx_ms:.4f} ms/frame, "
          f"{B * frame_s / (rx_ms / 1e3):.0f} audio-s/s")
    dec_bound, dec_by = bound(dw, (z,) + ds, (feats_out,) + ds1, nz, B)
    enc_bound, enc_by = bound(ew, (f,) + es, (z_out,) + es1, nz, B)
    print(f"fused_decoder_step: {dec_ms:.4f} ms (plain {dec_plain_ms:.4f} ms, "
          f"bound {dec_bound:.4f} ms by {dec_by})")
    print(f"fused_encoder_step: {enc_ms:.4f} ms (plain {enc_plain_ms:.4f} ms, "
          f"bound {enc_bound:.4f} ms by {enc_by})")

    src = "radae_tpu_torch/csrc/fused_core.cu"
    kernels = [
        {"name": "fused_decoder_step", "route": "cuda", "source": src,
         "replaces": "radae_tpu/ops/fused_core.py:216",
         "launches": launches["fused_decoder_step"],
         "max_abs_err": errs["fused_decoder_step"], "ms": dec_ms,
         "plain_ms": dec_plain_ms, "bound_ms": dec_bound, "bound_by": dec_by,
         "library_ms": None},
        {"name": "fused_encoder_step", "route": "cuda", "source": src,
         "replaces": "radae_tpu/ops/fused_core.py:740",
         "launches": launches["fused_encoder_step"],
         "max_abs_err": errs["fused_encoder_step"], "ms": enc_ms,
         "plain_ms": enc_plain_ms, "bound_ms": enc_bound, "bound_by": enc_by,
         "library_ms": None},
    ]
    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
