#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (radae_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from csrc/ with nvcc, then at the full width of the
flagship model (21 features, latent 80, bottleneck 3, pilots, 4 ms CP, LS
EQ, coarse magnitude):

  1. prints the card's name and power limit (nvidia-smi);
  2. holds each kernel against its plain PyTorch version on the card over
     3 chained calls with carried state (rtol 1e-4, atol 1e-4: the sums
     run in another order than cuBLAS): the unmerged and the chain-merged
     decoder and the encoder at B=2048 with one frame (3 latent steps) a
     call and at a ragged B=37 with one and with two frames a call; the
     whole-frame rx kernel at B=2048 and B=37, one frame a call, on
     fixture tx frames with Gaussian noise, for the flagship modem and for
     the latent-40 one (Nc=15, fixtures/model_l40.npz); and a modem
     geometry past the frame kernel's limits (latent 112) raises without
     launching;
  3. drives the batched streaming serving path on the fixture checkpoint:
     2048 streams of fixtures/speech_feats.f32 through 20 fused tx steps,
     then the frame-aligned rx windows through 20 rx steps, three times:
     the composite rx step on the unmerged decoder kernel, the same step
     on the chain-merged kernel (fused_merged=True), and the whole-frame
     kernel (make_fused_rx_frame_step).  Each run starts with the launch
     counts at 0; each checks that its kernels launched once a frame, that
     the features match the same path with the plain layers (1e-3), that
     the mean distortion loss is below 0.65, and that streams 0-3 give
     the losses radae_tpu gives on the CPU;
  4. drives the batch serving pair on the fixture: 2048 feature streams
     through 20 steps of the int8 encoder kernel (make_streaming_tx_step,
     fused_quant="int8"), the end-of-over frame appended, each stream
     delayed, frequency-shifted and given noise (pair_channel), then
     make_batched_receiver(n_windows=12, refine=True, eoo=True, fused=True,
     fused_quant="int8") with the int8 unmerged decoder kernel, and again
     with the int8 chain-merged one; each run starts with the launch counts
     at 0 and checks its kernels launched once a frame.  Every stream must
     acquire and find its EOO frame, the mean distortion loss of the frames
     before the EOO must be below 0.65 and within 0.01 of the f32-kernel
     receiver's, and streams 0-3 must give the tmax, fmax and loss that
     radae_tpu gives on the CPU (tools/batch_pair_reference.py); then the
     port's tx_batch --fused and rx_batch CLIs on three fixture files;
  5. times the three rx steps, the tx step and the seven kernel forms (the
     four f32 kernels and the int8 encoder, decoder and merged decoder)
     with CUDA events around calls issued from the host, beside each
     kernel's plain version, its bound and its device time in a CUDA graph
     replay (and the frame kernel at latent 40 too), and prints the weight
     bytes one encoder, one unmerged and one chain-merged decoder launch
     fetch into the SMs, f32 and int8, from the tiling the built library
     reports; and the batch pair's ms per frame and audio-s/s, its
     acquisition apart from its decode;
  6. prints a `kernels` JSON line, and last the `ok` JSON line.

Step 2 also holds the int8 instances of the encoder and both decoders
against their plain int8 versions the same way, once with a quant_exclude
set that keeps some matrices in f32, and holds all seven kernel forms, which
all tile their products over the block's rows, to the same bits on two
launches with the same input and state (B=2048 and B=37).

Any failure exits non-zero without the `ok` line; so does a machine without
a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
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
NUM_USED = 20            # feature columns used (data/io.py)
TOL = dict(rtol=1e-4, atol=1e-4)
E2E_TOL = 1e-3
LOSS_LIMIT = 0.65
# per-stream distortion loss of streams 0-3 through radae_tpu's
# make_streaming_tx_step/make_streaming_rx_step on the CPU, same inputs
JAX_LOSS_0_3 = [0.332894, 0.566543, 0.52081007, 0.49320942]
# the batch pair (phase 4): acquisition windows, the channel's SNR in 3 kHz
# and noise seed, and streams 0-3 through radae_tpu's tx (int8 encoder) and
# make_batched_receiver (int8 decoder) on the CPU, same inputs
# (tools/batch_pair_reference.py): tmax, fmax (Hz), loss
PAIR_WINDOWS = 12
PAIR_SNR_DB = 15.0
PAIR_SEED = 3
JAX_PAIR_0_3 = {"tmax": [1952, 2083, 2214, 2345],
                "fmax": [-40.0, -27.0, -14.0, -1.0],
                "loss": [0.39535508, 0.57686758, 0.5337739, 0.54245061]}
PAIR_TOL = 1e-3          # on fmax (Hz) and loss against radae_tpu
H100_F32_FLOPS = 67e12   # f32 outside the tensor cores (SXM data sheet)
H100_BYTES_S = 3.35e12   # HBM3
RX_NOISE = 0.1           # std of the Gaussian noise on the frame-kernel check
SRC = "radae_tpu_torch/csrc/fused_core.cu"
TPU_SRC = "radae_tpu/ops/fused_core.py"
# kernel -> (replaced TPU kernel body, file:line)
REPLACES = {"fused_decoder_step": f"{TPU_SRC}:344",
            "fused_decoder_merged_step": f"{TPU_SRC}:273",
            "fused_rx_frame_step": f"{TPU_SRC}:543",
            "fused_encoder_step": f"{TPU_SRC}:785",
            "fused_decoder_step_int8": f"{TPU_SRC}:344",
            "fused_decoder_merged_step_int8": f"{TPU_SRC}:273",
            "fused_encoder_step_int8": f"{TPU_SRC}:785"}
# a quant_exclude set per int8 form that keeps some matrices in f32
MIXED = {"fused_decoder_step_int8": ("whh", "out_w"),
         "fused_decoder_merged_step_int8": ("wgg",),
         "fused_encoder_step_int8": ("whh", "d1_w")}


def stream_features(raw, n_streams, n_frames, feature_dim):
    """(n_streams, 12 n_frames, feature_dim) features of the fixture: stream
    b starts at row b*37 (wrapped), the auxdata column at -1."""
    T = 12 * n_frames
    feats = np.zeros((n_streams, T, feature_dim), np.float32)
    for b in range(n_streams):
        o = (b * ROW_STEP) % (len(raw) - T)
        feats[b, :, :NUM_USED] = raw[o:o + T, :NUM_USED]
    feats[:, :, NUM_USED] = -1.0
    return feats


def pair_offsets(b):
    """Stream b's start (samples) and frequency offset (Hz) in the pair."""
    return (b * 131) % 800, float((b * 13) % 81 - 40)


def pair_buffer_len(cfg, n_frames):
    """Samples of the receiver's buffer: the acquisition windows and the
    decode of n_frames after the last window (as tools/rx_batch.py)."""
    return max((PAIR_WINDOWS + 1) * cfg.Nmf + cfg.M + cfg.Ncp,
               PAIR_WINDOWS * cfg.Nmf + (n_frames + 1) * cfg.Nmf + cfg.Ncp
               + cfg.M)


def pair_channel(over, cfg, T):
    """Received buffers (n, T, 2) f32 from the overs (n, L, 2): stream b
    delayed and shifted by pair_offsets(b), then complex Gaussian noise at
    PAIR_SNR_DB in 3 kHz from the over's own power (seed PAIR_SEED, so the
    first rows are the same for any n)."""
    n, L = over.shape[:2]
    x = (over[..., 0] + 1j * over[..., 1]).astype(np.complex64)
    out = np.zeros((n, T), np.complex64)
    t = np.arange(L)
    for b in range(n):
        pad, foff = pair_offsets(b)
        out[b, pad:pad + L] = x[b] * np.exp(2j * np.pi * foff * t / cfg.Fs)
    sigma = np.sqrt((np.abs(x) ** 2).mean(axis=1)
                    / 10 ** (PAIR_SNR_DB / 10) * cfg.Fs / 3000 / 2)
    noise = np.random.default_rng(PAIR_SEED).standard_normal(
        (n, T, 2)).astype(np.float32)
    out += (sigma[:, None] * (noise[..., 0] + 1j * noise[..., 1])).astype(
        np.complex64)
    return np.stack([out.real, out.imag], -1).astype(np.float32)


def pair_losses(loss_fn, sent, got, win, n_data):
    """Per-stream distortion loss of the frames decoded before the EOO:
    decoded frame j is sent frame j + win (sent (n, 12 n_data, F), got
    (n, frames, 12, F), both numpy or both torch on the CPU)."""
    got = got.reshape(got.shape[0], -1, got.shape[-1])
    out = np.zeros(len(win))
    for w in sorted(set(int(x) for x in win)):
        idx = np.flatnonzero(np.asarray(win) == w)
        n = 12 * (n_data - w)
        out[idx] = np.asarray(loss_fn(sent[idx][:, 12 * w:12 * n_data],
                                      got[idx][:, :n]))
    return out


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


def graph_ms(fn, n=20, reps=5) -> float:
    """Device time of one fn() call: n calls captured in a CUDA graph, the
    graph replayed reps times between two CUDA events.  Unlike time_ms it
    leaves out the host's time to issue the calls."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        g.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / (n * reps)


def host_ms(fn, reps=2) -> float:
    """Mean time of fn() on the host's clock, from its start to the end of
    its device work (after one warm-up call)."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def demod_flops(cfg) -> float:
    """Flop of one stream's frame front end, counting only what the math
    needs: the DFT of the M kept samples of each symbol row, the 3-tap LS
    fit of the two pilot rows, the coarse magnitude over the carriers and
    the interpolation + EQ of every data symbol (8 flop a complex
    multiply-add)."""
    n_sym, Nc = cfg.Ns + 2, cfg.Nc
    return float(8 * n_sym * cfg.M * Nc + 8 * 2 * 3 * Nc + 8 * Nc
                 + 22 * cfg.Ns * Nc)


def bound(weights, inputs, outputs, nz, batch, extra_flops=0.0):
    """Least time for one launch: each input read once and each output
    written once at the HBM rate, or 2 flop per weight-matrix element per
    z-step per stream (+ extra_flops) at the f32 rate, whichever is
    larger."""
    nbytes = 4 * (weights.buf.numel() + sum(t.numel() for t in inputs)
                  + sum(t.numel() for t in outputs))
    flops = 2.0 * sum(a.numel() for a in weights.arrays if a.dim() == 2) \
        * nz * batch + extra_flops
    t_bytes, t_ops = nbytes / H100_BYTES_S, flops / H100_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes > t_ops
                                       else "operations")


def weight_fetch_bytes(weights, gru_rows, other_rows, block_rows):
    """Weight bytes one block fetches into its SM per z-step when each weight
    load feeds `gru_rows` rows in the GRU products (g*_wih, g*_whh) and
    `other_rows` rows in the others: each matrix (f32 or int8) is read
    block_rows / rows times."""
    return sum(a.element_size() * a.numel() * (block_rows // (
        gru_rows if n.endswith(("_wih", "_whh")) else other_rows))
        for n, a in zip(weights.names, weights.arrays) if a.dim() == 2)


def fetch_line(weights, rows, block_rows, nz, batch, ms) -> str:
    blocks = -(-batch // block_rows)
    per = weight_fetch_bytes(weights, *rows, block_rows)
    total = per * blocks * nz
    return (f"weight fetch {per} B per block per z-step x {blocks} blocks x "
            f"nz {nz} = {total / 1e9:.4f} GB a launch, "
            f"{total / (ms * 1e-3) / 1e12:.2f} TB/s at {ms:.4f} ms")


def main(argv=None) -> int:
    argparse.ArgumentParser(
        description="Smoke test of radae_tpu_torch on one CUDA card; takes "
        "no arguments.").parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint, params_to_torch
    from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
    from radae_tpu_torch.models.core import CoreDecoder, CoreEncoder, distortion_loss
    from radae_tpu_torch.ops import _kernels
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.runtime import (make_batched_receiver, make_streaming_rx_step,
                                         make_streaming_tx_step)
    from radae_tpu_torch.ops.acquisition_op import make_detect_pilots_windowed, make_refine
    from radae_tpu_torch.ops.fused_core import FRAME_LIMITS
    from radae_tpu_torch.tools import rx_batch, tx_batch

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.time()
    procs = {name: _kernels.start_build(name) for name in ("fused_core",)}
    for name, proc in procs.items():
        log = _kernels.finish_build(name, proc)
        for line in log.splitlines():
            if any(k in line for k in ("entry function", "registers", "spill")):
                print(f"ptxas {name}: {line.strip()}")
    print(f"build: {time.time() - t0:.1f} s")

    cfg = flagship_config()
    tree, _ = load_checkpoint(os.path.join(HERE, "fixtures", "model_fs_flagship.npz"))
    dw = fc.decoder_weights(tree["decoder"], dev)
    dwm = fc.decoder_weights(tree["decoder"], dev, merged=True)
    rw = fc.fused_rx_weights(tree["decoder"], cfg, dev)
    ew = fc.encoder_weights(tree["encoder"], dev)
    # the int8 forms: radae_tpu's _fused_weights(quant="int8"), and a set that
    # keeps the MIXED matrices in f32
    packs = {"fused_decoder_step_int8": lambda **k: fc.decoder_weights(
                 tree["decoder"], dev, quant="int8", **k),
             "fused_decoder_merged_step_int8": lambda **k: fc.decoder_weights(
                 tree["decoder"], dev, merged=True, quant="int8", **k),
             "fused_encoder_step_int8": lambda **k: fc.encoder_weights(
                 tree["encoder"], dev, quant="int8", **k)}
    q8 = {name: (pack(), pack(quant_exclude=MIXED[name]))
          for name, pack in packs.items()}
    dwq, dwmq, ewq = (q8[n][0] for n in ("fused_decoder_step_int8",
                                         "fused_decoder_merged_step_int8",
                                         "fused_encoder_step_int8"))
    # the latent-40 modem (Nc=15: [Yr | Yi] padded from 30 to 32 columns)
    cfg40 = flagship_config(latent_dim=40)
    tree40, _ = load_checkpoint(os.path.join(HERE, "fixtures", "model_l40.npz"))
    rw40 = fc.fused_rx_weights(tree40["decoder"], cfg40, dev)
    model40 = (cfg40, CoreEncoder(cfg40.feature_dim, cfg40.latent_dim,
                                  cfg40.bottleneck), params_to_torch(tree40, dev))
    gen = np.random.default_rng(0)
    nz = cfg.Nzmf
    Nmf, win = cfg.Nmf, cfg.Nmf + cfg.M + cfg.Ncp
    enc = CoreEncoder(cfg.feature_dim, cfg.latent_dim, cfg.bottleneck)
    dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    params = params_to_torch(tree, dev)

    # the fixture's features: stream b starts at feature row b*37 (wrapped)
    raw = read_f32(os.path.join(HERE, "fixtures", "speech_feats.f32"),
                   NB_TOTAL_FEATURES)
    T = N_FRAMES * nz * 4
    feats = torch.as_tensor(stream_features(raw, B, N_FRAMES, cfg.feature_dim),
                            device=dev)

    def tx_signal(fused, n_frames=N_FRAMES, model=None):
        """n_frames of tx samples (B, n*Nmf + M+Ncp, 2), zero-padded so the
        last frame has its closing pilot window; model (cfg, encoder,
        params) for the plain step, the flagship by default."""
        c, e, p = model or (cfg, enc, params)
        tx = make_streaming_tx_step(c, e, B, fused=fused, device=dev)
        ep = ew if fused else p["encoder"]
        es = fc.encoder_state_zero(B, dev) if fused else None
        sig = []
        for k in range(n_frames):
            s, es = tx(ep, feats[:, 12 * k:12 * (k + 1)], es)
            sig.append(s)
        sig.append(torch.zeros((B, win - Nmf, 2), device=dev))
        return torch.cat(sig, dim=1)

    def rx_run(step, w, state, sig):
        out = []
        for k in range(N_FRAMES):
            f, state = step(w, sig[:, k * Nmf:k * Nmf + win], state)
            out.append(f)
        return torch.cat(out, dim=1)

    # -- kernels against their plain versions -----------------------------
    errs = {name: 0.0 for name in fc.LAUNCHES}

    def held(name, batch, what, got, want):
        torch.cuda.synchronize()
        check_close(f"{name} B={batch} {what}", got, want, TOL)
        if batch == B:
            errs[name] = max(errs[name], max_err(got, want))

    def kernel_form(name, rng):
        """(kernel call, plain call, zero state, input draw) of the encoder
        or a decoder form, each call taking its weights."""
        if name.startswith("fused_encoder_step"):
            return (lambda w, x, s: fc.fused_encoder_step(w, x, s, cfg.bottleneck),
                    lambda w, x, s: fc.encoder_step_plain(w, x, s, cfg.bottleneck),
                    lambda b: fc.encoder_state_zero(b, dev),
                    lambda b, n: torch.as_tensor((0.3 * rng.standard_normal(
                        (b, 4 * n, cfg.feature_dim))).astype(np.float32), device=dev))
        plain = (fc.decoder_merged_step_plain if "merged" in name
                 else fc.decoder_step_plain)
        return (fc.fused_decoder_step, plain,
                lambda b: fc.decoder_state_zero(b, dev, merged="merged" in name),
                lambda b, n: torch.as_tensor(np.tanh(rng.standard_normal(
                    (b, n, cfg.latent_dim))).astype(np.float32), device=dev))

    with torch.no_grad():
        for batch, steps in ((B, nz), (RAGGED_B, nz), (RAGGED_B, 2 * nz)):
            sk = sp = fc.decoder_state_zero(batch, dev)
            mk = mp = fc.decoder_state_zero(batch, dev, merged=True)
            ek = ep = fc.encoder_state_zero(batch, dev)
            for frame in range(3):
                what = f"nz={steps} call {frame}"
                z = torch.as_tensor(np.tanh(gen.standard_normal(
                    (batch, steps, cfg.latent_dim))).astype(np.float32), device=dev)
                fk, sk = fc.fused_decoder_step(dw, z, sk)
                fp, sp = fc.decoder_step_plain(dw, z, sp)
                held("fused_decoder_step", batch, what, (fk,) + sk, (fp,) + sp)
                fk, mk = fc.fused_decoder_step(dwm, z, mk)
                fp, mp = fc.decoder_merged_step_plain(dwm, z, mp)
                held("fused_decoder_merged_step", batch, what, (fk,) + mk,
                     (fp,) + mp)
                f = torch.as_tensor((0.3 * gen.standard_normal(
                    (batch, 4 * steps, cfg.feature_dim))).astype(np.float32),
                    device=dev)
                zk, ek = fc.fused_encoder_step(ew, f, ek, cfg.bottleneck)
                zp, ep = fc.encoder_step_plain(ew, f, ep, cfg.bottleneck)
                held("fused_encoder_step", batch, what, (zk,) + ek, (zp,) + ep)
        # the int8 forms against their plain int8 versions, the MIXED set
        # once at B=2048 (own seed: the f32 checks' inputs stay as they were)
        qrng = np.random.default_rng(4)
        for name, (wq, wmix) in q8.items():
            kern, plain, zero_state, draw = kernel_form(name, qrng)
            for batch, steps in ((B, nz), (RAGGED_B, nz), (RAGGED_B, 2 * nz)):
                sets = ((wq, ""), (wmix, f" {MIXED[name]} in f32")) \
                    if batch == B else ((wq, ""),)
                for w, mixed in sets:
                    sk = sp = zero_state(batch)
                    for frame in range(3):
                        x = draw(batch, steps)
                        ok_, sk = kern(w, x, sk)
                        op, sp = plain(w, x, sp)
                        held(name, batch, f"nz={steps}{mixed} call {frame}",
                             (ok_,) + sk, (op,) + sp)
        sig3 = tx_signal(False, 3)
        sig40 = tx_signal(False, 3, model40)
        err40 = 0.0
        for c, w, sig in ((cfg, rw, sig3), (cfg40, rw40, sig40)):
            for batch in (B, RAGGED_B):
                step = fc.make_fused_rx_frame_step(c, batch, dev)
                sk = sp = fc.decoder_state_zero(batch, dev)
                for frame in range(3):
                    rx = sig[:batch, frame * Nmf:frame * Nmf + win] + torch.as_tensor(
                        (RX_NOISE * gen.standard_normal((batch, win, 2))).astype(
                            np.float32), device=dev)
                    fk, sk = step(w, rx, sk)
                    fp, sp = fc.rx_frame_step_plain(w, rx, sp)
                    if w is rw:
                        held("fused_rx_frame_step", batch, f"call {frame}",
                             (fk,) + sk, (fp,) + sp)
                    else:
                        torch.cuda.synchronize()
                        check_close(f"fused_rx_frame_step latent 40 B={batch} "
                                    f"call {frame}", (fk,) + sk, (fp,) + sp, TOL)
                        err40 = max(err40, max_err((fk,) + sk, (fp,) + sp))
        # a modem geometry past the kernel's limits raises and launches
        # nothing: latent 112 (Nc=42) leaves no room for z in layer 0's GLU
        # window
        cfg112 = flagship_config(latent_dim=112)
        d112 = dict(tree["decoder"])
        d112["dense_1"] = dict(d112["dense_1"], w=np.pad(
            np.asarray(d112["dense_1"]["w"]), ((0, 0), (0, 112 - cfg.latent_dim))))
        rw112 = fc.fused_rx_weights(d112, cfg112, dev)
        n_before = fc.LAUNCHES["fused_rx_frame_step"]
        try:
            fc.fused_rx_frame_step(rw112, torch.zeros(
                (RAGGED_B, (cfg112.Ns + 2) * (cfg112.M + cfg112.Ncp), 2),
                device=dev), fc.decoder_state_zero(RAGGED_B, dev))
        except ValueError as e:
            if FRAME_LIMITS[5] not in str(e):
                raise
            refused = str(e)
        else:
            raise AssertionError("fused_rx_frame_step ran latent 112")
        if fc.LAUNCHES["fused_rx_frame_step"] != n_before:
            raise AssertionError("a refused frame geometry was launched")
        # the tile kernels give the same bits on two launches (own seeds, so
        # the inputs above and below stay as they were)
        def same_bits(name, batch, call):
            (o1, s1), (o2, s2) = call(), call()
            torch.cuda.synchronize()
            if not all(torch.equal(x, y) for x, y in zip((o1,) + s1, (o2,) + s2)):
                raise AssertionError(f"{name} B={batch}: two launches on the "
                                     "same input differ")

        def rand_state(rng, state):
            return tuple(torch.as_tensor((0.5 * rng.standard_normal(
                tuple(s.shape))).astype(np.float32), device=dev) for s in state)

        drng, rrng = np.random.default_rng(1), np.random.default_rng(2)
        qbrng = np.random.default_rng(5)
        for batch in (B, RAGGED_B):
            f = torch.as_tensor((0.3 * drng.standard_normal(
                (batch, 4 * nz, cfg.feature_dim))).astype(np.float32), device=dev)
            st = rand_state(drng, fc.encoder_state_zero(batch, dev))
            same_bits("fused_encoder_step", batch,
                      lambda: fc.fused_encoder_step(ew, f, st, cfg.bottleneck))
            z = torch.as_tensor(np.tanh(rrng.standard_normal(
                (batch, nz, cfg.latent_dim))).astype(np.float32), device=dev)
            ds = rand_state(rrng, fc.decoder_state_zero(batch, dev))
            same_bits("fused_decoder_step", batch,
                      lambda: fc.fused_decoder_step(dw, z, ds))
            dms = rand_state(rrng, fc.decoder_state_zero(batch, dev, merged=True))
            same_bits("fused_decoder_merged_step", batch,
                      lambda: fc.fused_decoder_step(dwm, z, dms))
            rx = sig3[:batch, :win] + torch.as_tensor((RX_NOISE * rrng.standard_normal(
                (batch, win, 2))).astype(np.float32), device=dev)
            same_bits("fused_rx_frame_step", batch,
                      lambda: fc.fused_rx_frame_step(rw, rx, ds))
            for name, (wq, _) in q8.items():
                kern, _, zero_state, draw = kernel_form(name, qbrng)
                x, st = draw(batch, nz), rand_state(qbrng, zero_state(batch))
                same_bits(name, batch, lambda: kern(wq, x, st))
    print("kernels vs plain (rtol 1e-4, atol 1e-4), max abs err at B=2048: "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f"; frame kernel at latent 40, B={B} and B={RAGGED_B}: {err40:.3g}")
    print(f"refused without a launch: {refused}")
    print(f"all seven kernel forms: two launches bit-identical at B={B} and "
          f"B={RAGGED_B}")

    # -- the serving path on the fixture, three rx paths -------------------
    rx_steps = {
        "composite": (make_streaming_rx_step(cfg, dec, B, fused=True, device=dev),
                      dw, lambda: fc.decoder_state_zero(B, dev),
                      ("fused_decoder_step",)),
        "merged": (make_streaming_rx_step(cfg, dec, B, fused=True,
                                          fused_merged=True, device=dev),
                   dwm, lambda: fc.decoder_state_zero(B, dev, merged=True),
                   ("fused_decoder_merged_step",)),
        "frame": (fc.make_fused_rx_frame_step(cfg, B, dev), rw,
                  lambda: fc.decoder_state_zero(B, dev),
                  ("fused_rx_frame_step",)),
    }
    launches, outs = {}, {}
    with torch.no_grad():
        for path, (step, w, state0, names) in rx_steps.items():
            fc.reset_launches()
            if path == "composite":          # the tx step runs on this path
                sig = tx_signal(True)
                names = names + ("fused_encoder_step",)
            outs[path] = rx_run(step, w, state0(), sig)
            torch.cuda.synchronize()
            counts = dict(fc.LAUNCHES)
            bad = {n: counts[n] for n in names if counts[n] != N_FRAMES}
            if bad:
                raise AssertionError(f"{path} path: kernels launched {bad} "
                                     f"times, not {N_FRAMES}: {counts}")
            for n in names:
                launches[n] = counts[n]
        f_plain = rx_run(make_streaming_rx_step(cfg, dec, B, device=dev),
                         params["decoder"], None, tx_signal(False))
        torch.cuda.synchronize()
    for path, f_out in outs.items():
        if tuple(f_out.shape) != (B, T, cfg.feature_dim) or not bool(
                torch.isfinite(f_out).all()):
            raise AssertionError(f"{path} path: bad features, shape "
                                 f"{tuple(f_out.shape)}")
        e2e_err = float((f_out - f_plain).abs().max())
        if e2e_err > E2E_TOL:
            raise AssertionError(f"{path} path vs plain: max abs err "
                                 f"{e2e_err:.3g} > {E2E_TOL}")
        loss = distortion_loss(feats, f_out)
        mean_loss = float(loss.mean())
        if not mean_loss < LOSS_LIMIT:
            raise AssertionError(f"{path} path: mean distortion loss "
                                 f"{mean_loss:.4f} >= {LOSS_LIMIT}")
        ref_err = float(np.abs(loss[:4].cpu().numpy() - JAX_LOSS_0_3).max())
        if ref_err > 1e-3:
            raise AssertionError(f"{path} path: streams 0-3 loss "
                                 f"{loss[:4].tolist()} vs radae_tpu {JAX_LOSS_0_3}")
        print(f"serving path B={B} x {N_FRAMES} frames, rx {path}: "
              f"vs plain max abs err {e2e_err:.3g}, mean loss {mean_loss:.4f}, "
              f"streams 0-3 {[round(x, 4) for x in loss[:4].tolist()]} "
              f"(radae_tpu {JAX_LOSS_0_3}, max diff {ref_err:.2g})")

    # -- the batch serving pair: int8 tx, the whole-over int8 receiver -----
    T_pair = pair_buffer_len(cfg, N_FRAMES)
    txq = make_streaming_tx_step(cfg, enc, B, fused=True, fused_quant="int8",
                                 device=dev)
    eoo = cfg.eoo.flatten().astype(np.complex64)
    eoo = torch.as_tensor(np.stack([eoo.real, eoo.imag], -1), device=dev)

    def tx_pair():
        """N_FRAMES int8 tx steps of every stream, the EOO frame appended."""
        es, out = fc.encoder_state_zero(B, dev), []
        for k in range(N_FRAMES):
            s, es = txq(ewq, feats[:, 12 * k:12 * (k + 1)], es)
            out.append(s)
        return torch.cat(out + [eoo.expand(B, -1, -1)], dim=1)

    def receiver(weights, **kw):
        return make_batched_receiver(cfg, dec, B, N_FRAMES,
                                     n_windows=PAIR_WINDOWS, refine=True,
                                     eoo=True, fused=True, device=dev, **kw)

    rx_q = receiver(dwq, fused_quant="int8")
    with torch.no_grad():
        fc.reset_launches()
        buf = pair_channel(tx_pair().cpu().numpy(), cfg, T_pair)
        buf = torch.as_tensor(buf, device=dev)
        pair = {"int8": rx_q(dwq, buf)}
        torch.cuda.synchronize()
        want = {"fused_encoder_step_int8": N_FRAMES,
                "fused_decoder_step_int8": N_FRAMES}
        counts = dict(fc.LAUNCHES)
        if any(counts[n] != c for n, c in want.items()):
            raise AssertionError(f"batch pair: kernels launched {counts}, "
                                 f"not {want}")
        launches.update({n: counts[n] for n in want})
        fc.reset_launches()
        pair["int8 merged"] = receiver(dwmq, fused_quant="int8",
                                       fused_merged=True)(dwmq, buf)
        torch.cuda.synchronize()
        n_m = fc.LAUNCHES["fused_decoder_merged_step_int8"]
        if n_m != N_FRAMES:
            raise AssertionError(f"batch pair, merged int8: kernels launched "
                                 f"{dict(fc.LAUNCHES)}")
        launches["fused_decoder_merged_step_int8"] = n_m
        pair["f32"] = receiver(dw)(dw, buf)
        torch.cuda.synchronize()
    feats_cpu = feats.cpu()
    losses = {}
    for what, out in pair.items():
        out = {k: v.cpu() for k, v in out.items()}
        wins = out["win"].numpy()
        if not bool(out["candidate"].all()):
            raise AssertionError(f"batch pair {what}: "
                                 f"{int((~out['candidate']).sum())} streams "
                                 "did not acquire")
        if not (bool(out["eoo_detected"].all()) and np.array_equal(
                out["eoo_frame"].numpy(), N_FRAMES - wins)):
            raise AssertionError(f"batch pair {what}: EOO frames "
                                 f"{out['eoo_frame'][:8].tolist()} against "
                                 f"{(N_FRAMES - wins)[:8].tolist()}")
        f = out["features"]
        if tuple(f.shape) != (B, N_FRAMES, 12, cfg.feature_dim) or not bool(
                torch.isfinite(f).all()):
            raise AssertionError(f"batch pair {what}: bad features, shape "
                                 f"{tuple(f.shape)}")
        losses[what] = pair_losses(distortion_loss, feats_cpu, f, wins, N_FRAMES)
        pair[what] = out
    q, m = pair["int8"], pair["int8 merged"]
    merged_err = float((q["features"] - m["features"]).abs().max())
    if merged_err > E2E_TOL or not torch.equal(q["tmax"], m["tmax"]):
        raise AssertionError(f"batch pair: merged int8 vs int8 features "
                             f"max abs err {merged_err:.3g}")
    mean_q, mean_f = losses["int8"].mean(), losses["f32"].mean()
    if not (mean_q < LOSS_LIMIT and abs(mean_q - mean_f) < 0.01):
        raise AssertionError(f"batch pair: mean loss {mean_q:.4f} (limit "
                             f"{LOSS_LIMIT}), f32-kernel receiver {mean_f:.4f}")
    got = {"tmax": q["tmax"][:4].tolist(), "fmax": q["fmax"][:4].tolist(),
           "loss": losses["int8"][:4].tolist()}
    diffs = {k: float(np.abs(np.subtract(got[k], JAX_PAIR_0_3[k])).max())
             for k in got}
    if diffs["tmax"] != 0 or diffs["fmax"] > PAIR_TOL or diffs["loss"] > PAIR_TOL:
        raise AssertionError(f"batch pair streams 0-3: {got} against "
                             f"radae_tpu {JAX_PAIR_0_3}")
    print(f"batch pair B={B} x {N_FRAMES} frames + EOO, {PAIR_SNR_DB} dB: all "
          f"streams acquired (windows {sorted(set(q['win'].tolist()))}), EOO "
          f"found; mean loss int8 {mean_q:.4f}, f32 kernels {mean_f:.4f}, "
          f"merged int8 {losses['int8 merged'].mean():.4f} (features vs int8 "
          f"{merged_err:.3g}); streams 0-3 {got}, max diff against radae_tpu "
          f"{diffs}")

    # -- the two CLIs on three fixture files -------------------------------
    cli = os.path.join(HERE, "build", "chip_smoke_cli")
    os.makedirs(cli, exist_ok=True)
    ckpt = os.path.join(HERE, "fixtures", "model_fs_flagship.npz")
    files = []
    for k, n in enumerate((8, 6, 10)):
        f36 = np.zeros((12 * n, 36), np.float32)
        f36[:, :NUM_USED] = raw[300 * k:300 * k + 12 * n, :NUM_USED]
        files.append(os.path.join(cli, f"s{k}.f32"))
        f36.tofile(files[-1])
    fc.reset_launches()
    with contextlib.redirect_stdout(io.StringIO()) as o:
        tx_batch.main([ckpt, os.path.join(cli, "iq")] + files + ["--fused"])
    tx_lines = o.getvalue()
    if fc.LAUNCHES["fused_encoder_step_int8"] != 10:
        raise AssertionError(f"tx_batch --fused: {dict(fc.LAUNCHES)}")
    iq = [os.path.join(cli, "iq", f"s{k}_iq.f32") for k in range(3)]
    with contextlib.redirect_stdout(io.StringIO()) as o:
        rx_batch.main([ckpt, os.path.join(cli, "out")] + iq)
    rx_lines = o.getvalue()
    for k, line in enumerate(rx_lines.splitlines()):
        fh = np.fromfile(os.path.join(cli, "out", f"s{k}_iq_feat.f32"),
                         np.float32)
        if "acquired 1" not in line or "eoo_frame  -1" in line or not len(
                fh) or not np.isfinite(fh).all():
            raise AssertionError(f"rx_batch: {line}")
    print("tx_batch --fused: " + "; ".join(tx_lines.splitlines()))
    print("rx_batch: " + "; ".join(rx_lines.splitlines()))
    print(f"launches on the main paths: {launches}")

    # -- timing -----------------------------------------------------------
    frame_s = cfg.Tmf                               # 0.12 s of audio
    with torch.no_grad():
        tx = make_streaming_tx_step(cfg, enc, B, fused=True, device=dev)
        f12 = feats[:, :12].contiguous()
        rx_win = sig[:, :win].contiguous()
        es = fc.encoder_state_zero(B, dev)
        tx_ms = time_ms(lambda: tx(ew, f12, es), 20)
        print(f"tx step B={B}: {tx_ms:.4f} ms/frame, "
              f"{B * frame_s / (tx_ms / 1e3):.0f} audio-s/s")
        for path, (step, w, state0, _) in rx_steps.items():
            st = state0()
            ms = time_ms(lambda: step(w, rx_win, st), 20)
            print(f"rx step {path} B={B}: {ms:.4f} ms/frame, "
                  f"{B * frame_s / (ms / 1e3):.0f} audio-s/s")

        z = torch.as_tensor(np.tanh(gen.standard_normal(
            (B, nz, cfg.latent_dim))).astype(np.float32), device=dev)
        f = feats[:, :4 * nz].contiguous()
        ds, dsm = fc.decoder_state_zero(B, dev), fc.decoder_state_zero(
            B, dev, merged=True)
        runs = {   # kernel -> (kernel call, plain call, bound args)
            "fused_decoder_step": (
                lambda: fc.fused_decoder_step(dw, z, ds),
                lambda: fc.decoder_step_plain(dw, z, ds), (dw, z, ds, 0.0)),
            "fused_decoder_merged_step": (
                lambda: fc.fused_decoder_step(dwm, z, dsm),
                lambda: fc.decoder_merged_step_plain(dwm, z, dsm),
                (dwm, z, dsm, 0.0)),
            "fused_rx_frame_step": (
                lambda: fc.fused_rx_frame_step(rw, rx_win, ds),
                lambda: fc.rx_frame_step_plain(rw, rx_win, ds),
                (rw.decoder, rx_win, ds, demod_flops(cfg) * B)),
            "fused_encoder_step": (
                lambda: fc.fused_encoder_step(ew, f, es),
                lambda: fc.encoder_step_plain(ew, f, es), (ew, f, es, 0.0)),
            "fused_decoder_step_int8": (
                lambda: fc.fused_decoder_step(dwq, z, ds),
                lambda: fc.decoder_step_plain(dwq, z, ds), (dwq, z, ds, 0.0)),
            "fused_decoder_merged_step_int8": (
                lambda: fc.fused_decoder_step(dwmq, z, dsm),
                lambda: fc.decoder_merged_step_plain(dwmq, z, dsm),
                (dwmq, z, dsm, 0.0)),
            "fused_encoder_step_int8": (
                lambda: fc.fused_encoder_step(ewq, f, es),
                lambda: fc.encoder_step_plain(ewq, f, es), (ewq, f, es, 0.0)),
        }
        lib = _kernels.library("fused_core")
        enc_rows = (lib.radae_enc_tile_rows(),) * 2
        dec_rows = (lib.radae_dec_tile_rows(),) * 2
        kernels = []
        for name, (kern, plain, (w, x, st, extra)) in runs.items():
            ms = time_ms(kern, 50)
            plain_ms = time_ms(plain, 10)
            out, st1 = plain()
            b_ms, b_by = bound(w, (x,) + st, (out,) + st1, nz, B, extra)
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms by {b_by}; "
                  f"{graph_ms(kern):.4f} ms in a CUDA graph replay)")
            if name.startswith("fused_encoder_step"):
                print(f"  encoder, {enc_rows[0]}-row tiles: " + fetch_line(
                    w, enc_rows, lib.radae_block_rows(), nz, B, ms))
            if name.startswith("fused_decoder_step"):
                print(f"  decoder, {dec_rows[0]}-row tiles: " + fetch_line(
                    w, dec_rows, lib.radae_block_rows(), nz, B, ms))
            if name.startswith("fused_decoder_merged_step"):
                print(f"  merged decoder, {dec_rows[0]}-row tiles: " + fetch_line(
                    w, dec_rows, lib.radae_block_rows(), nz, B, ms))
            if name == "fused_rx_frame_step":     # the latent-40 modem
                rx40 = sig40[:, :win].contiguous()
                k40 = lambda: fc.fused_rx_frame_step(rw40, rx40, ds)
                ms40 = time_ms(k40, 50)
                out40, st40 = fc.rx_frame_step_plain(rw40, rx40, ds)
                b40, by40 = bound(rw40.decoder, (rx40,) + ds, (out40,) + st40,
                                  nz, B, demod_flops(cfg40) * B)
                print(f"  latent 40 (Nc=15): {ms40:.4f} ms (bound {b40:.4f} ms "
                      f"by {by40}; {graph_ms(k40):.4f} ms in a CUDA graph "
                      f"replay)")
            kernels.append({
                "name": name, "route": "cuda", "source": SRC,
                "replaces": REPLACES[name], "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None})


        # the batch pair: the int8 tx loop, the receiver, and the receiver's
        # acquisition (windowed detector + refine) and decode (its N_FRAMES
        # int8 rx steps) apart
        tx_ms = host_ms(tx_pair) / N_FRAMES
        rx_ms = host_ms(lambda: rx_q(dwq, buf)) / N_FRAMES
        detect = make_detect_pilots_windowed(cfg, PAIR_WINDOWS, device=dev)
        fine = make_refine(cfg, device=dev)
        xr, xi = buf[..., 0], buf[..., 1]
        acq_ms = host_ms(lambda: fine(xr, xi, *detect(buf)[1:3]))
        step_q = make_streaming_rx_step(cfg, dec, B, fused=True,
                                        fused_quant="int8", device=dev)
        dec_ms = host_ms(lambda: rx_run(step_q, dwq, fc.decoder_state_zero(
            B, dev), buf)) / N_FRAMES
        print(f"batch pair B={B}: tx (int8 encoder) {tx_ms:.4f} ms/frame, "
              f"{B * frame_s / (tx_ms / 1e3):.0f} audio-s/s; receiver "
              f"{rx_ms:.4f} ms/frame, {B * frame_s / (rx_ms / 1e3):.0f} "
              f"audio-s/s over {N_FRAMES} frames: acquisition {acq_ms:.4f} ms "
              f"a buffer ({acq_ms / N_FRAMES:.4f} ms/frame), decode "
              f"{dec_ms:.4f} ms/frame (host clock)")

    print(card_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
