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
     launching.  Likewise the instances with bf16 products of all four
     bodies on each weight kind (f32, bf16 and int8; the frame kernel on
     f32 and bf16) and the chain-merged decoder on the padded layout
     (merged="pad": f32 and int8 weights with f32 products, and all three
     with bf16 products), 16 forms more; the padded ones with f32 products
     at 1e-4, the bf16-product ones within 2e-3 but for at most 1e-3 of a
     run's elements (bf16 input flips), each tensor's max and mean error
     within BF16_MAX and BF16_MEAN of its scale (readings in PERF.md).
     All fourteen bf16-product forms multiply on the tensor cores
     (MMA_FORMS: every decoder layout and the encoder on bf16 and int8
     weights and on f32 weights, where each bf16 x f32 product runs as
     three bf16 products, on the weight's hi, mid and lo parts, and the
     frame kernel on f32 and bf16 weights, on the weights packed by
     fc.mma_weights at a set's first such launch), and so do the five
     forms with f32 products (XS_FORMS: the int8 ones of the unmerged
     decoder, the chain-merged one in either layout and the encoder, each
     f32 x int8 product as three bf16 products, x's hi, mid and lo parts
     against the int8 matrix widened to bf16, and a matrix kept in f32 as
     six; and the padded decoder's f32 form, PAD_F32, every product as
     those six), held at the f32 tolerance; the timing phase fails unless
     exactly those nineteen ran on the tensor cores; the frame kernel's
     two, the unmerged decoder's and the encoder's six and the merged and
     padded decoder's two with bf16 products on f32 weights are also held
     at latent 40 (B=2048 and
     37, and to the same bits), and the four int8 forms with f32 products
     on their MIXED sets too, and at latent 40 on full int8 and MIXED sets
     (B=2048 and 37, to the same bits; the encoder's there within TOL of
     its plain version in f64, since the f32 plain version's own rounding
     passes TOL of it at latent 40), and PAD_F32 at latent 40 too (B=2048
     and 37, to the same bits; its distance from its plain version in f64
     printed at both latents); an int8 launch through an f32 entry, or
     with f32 products through an mma or x entry without the packed
     matrices, and a padded f32 launch through the x entry without them,
     are refused and write nothing (no FMA int8 or padded instance is left
     to fall back on);
  3. drives the batched streaming serving path on the fixture checkpoint:
     2048 streams of fixtures/speech_feats.f32 through 20 fused tx steps,
     then the frame-aligned rx windows through 20 rx steps, on each rx
     path: the composite rx step on the unmerged decoder kernel, the same
     step on the chain-merged kernel (fused_merged=True), the whole-frame
     kernel (make_fused_rx_frame_step), and a path for each of the 16 forms
     above: the rx step or the frame step with its fused_merged,
     fused_quant and fused_dtype; the encoder's bf16-product forms each
     through 20 tx steps around the instance, decoded by the composite
     step.  Each run starts with the launch counts at 0 and checks that its
     kernels, and no other, launched once a frame, and that the mean
     distortion loss is below 0.65; the f32 paths also that the features
     match the same path with the plain layers (1e-3) and that streams 0-3
     give the losses radae_tpu gives on the CPU, the int8 and bf16 ones
     that their loss is within 0.01 of the f32 kernels';
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
     radae_tpu gives on the CPU (tools/batch_pair_reference.py); the int8
     receiver once more with bf16 products (fused_dtype), held like the
     merged one; then the port's tx_batch --fused and rx_batch CLIs on
     three fixture files; then the per-frame product path (product_phase:
     apps/txe.py and apps/rxe.py, one radio, one 120 ms frame a call):
     the unmerged f32 decoder kernel at B=1 against its plain version (3
     chained calls, TOL, the same bits on two launches), 40 fixture frames
     + the EOO frame with data bits + 3000 zeros through RadaeTx and
     RadaeRx on the card (sync, at least 34x12 feature rows, aligned loss
     below the checkpoint's + 0.15, EOO BER below 0.05, the decoder kernel
     launched once a decoded frame), the same stream through RadaeRx on the
     CPU (each call's return code, state, nin, tmax and fmax equal,
     features at TOL, SNR estimate within 0.01 dB) and RadaeTx's noise-off
     step on the card against the CPU (3 frames, 1e-4); it prints both
     apps' ms a frame and the B=1 kernel's time beside its bound; then the
     file tools (file_tools_phase: tools/inference.py, rx.py, loss.py,
     stateful.py on the first 30 s of the fixture, 750 z-steps): the f32
     decoder and encoder kernels at B=1 against their plain versions over
     the whole file in one launch and chained at nz=1 (decoder) and nz=3
     (encoder), TOL and the same bits on two launches; `python -m
     radae_tpu_torch inference` with the flagship flags at 10 dB, a 2 Hz
     offset, the EOO and pre/appended noise written as IQ, then rx, rx
     --stateful, loss (acquisition time below 1.5 s, loss below the
     checkpoint's + 0.15, the two decodes within 0.01), inference
     --ber_test (BER 0.000) and both stateful tools (PASS), each with its
     kernel launches counted; the card's noise-off RADAE.forward (the
     channel's draw shared) and receiver against the CPU's (TOL); it
     prints each tool's wall time and both kernels' times at these shapes
     beside their bounds; then training (train_phase: parallel/
     trainstep.py, tools/train.py, tools/evaluate.py, the flagship's
     training flags): one train step from the checkpoint on 8 fixture
     sequences on the card and on the CPU (quant noise off, a fixed
     Eb/No, the channel's draw shared; loss within 1e-4 relative, each of
     the 78 gradient leaves within 1e-3 of its max |g|, all finite and
     nonzero on the card, no kernel launched), `python -m radae_tpu_torch
     train` for 2 epochs with a --g_file of mpp fading (the loss falls,
     the checkpoint loads with radae_tpu's meta keys and its noise-free
     forward runs both kernels), the hand-off to serving (the noise-free
     forward and receiver under no_grad on the tree the optimizer updated
     in place launch both kernels on weights packed again, within TOL of
     the plain nets), the step's times at B=32 and 512 (and remat at 512,
     whose gradients must match the plain step's and whose peak memory
     must stay under REMAT_PEAK_MAX of the plain step's),
     T=252, forward, backward and optimizer apart, with audio-s/s and
     peak memory, a one-rank NCCL group against no group, and a short
     `evaluate` sweep (every cell finite, 10 dB no worse than 0 dB);
     then BBFM and the speech back end (speech_phase: models/bbfm.py,
     tools/{bbfm,sc_modem,wav_pipeline}.py, vocoder.py, vocoder_nn.py,
     evaluate --audio, at 20 features on fixtures/model_bbfm.npz): the
     loss at 10 dB below 0.2 on 24 s, the f32 encoder kernel with
     bottleneck 1 (in_dim 80) and the f32 decoder kernel (out_dim 80) at
     B=1 over 600 z-steps within TOL of their plain versions and to the
     same bits on two launches, timed beside their bounds; z through the
     single-carrier modem on a clean channel (correlation above 0.98, loss
     within 0.02 of the direct decode), bbfm_inference and bbfm_rx; a
     BBFM train loss and gradient card against CPU and train_bbfm at B=32
     (the loss falls); a wav through `wav --vocoder neural`, the neural
     vocoder's pcm card against CPU and its cepstral distance below
     MelVocoder's, its synthesis time; vocoder_nn corpus and train on wavs
     it writes; evaluate --audio on two cells; each path with the launch
     counts at 0 before it and checked after it;
     then the last modules (tools_phase: tools/{ptt_loop,ota,est_snr,
     webtx,ml_pilots,profile,scaling}.py on the flagship checkpoint): two
     PTT sessions (tests/test_session.py's AWGN and MPP cases at 3 dB) made
     by RadaeTx on the card and received by one RadaeRx across every over
     and gap, the f32 decoder kernel launched once a decoded frame at B=1,
     the session tests' gates and the CPU's receiving loop on the same
     session IQ giving the same reports, each session's ms a frame and the
     kernel's share of it; the ptt_loop CLI with its PTT hooks; ota at 50
     dB on 10 s (exit 0, each tool's wall time); est_snr --refit and the
     refit's raw estimates card against CPU (1e-4); a webtx round trip on
     loopback received on the card (acquired, EOO); ml_pilots card against
     CPU on shared draws (1e-5) and its CLI; profile (the plain rx step at
     B=2048, the training-step breakdown at B=32, a torch.profiler trace)
     and scaling over the cards present;
     then the port's benchmark as a user runs it,
     `python -m radae_tpu_torch.bench` (its one line must carry a value
     from a fused rung at B >= 2048), and its run_bench for the modes that
     are not on its ladder, at B=2048;
  5. times the rx steps, the tx step and the 23 kernel forms (FORMS)
     with CUDA events around calls issued from the host, beside each
     kernel's plain version, its bound (each product at the f32 rate, or
     at the tensor cores' bf16 rate where both its operands are bf16, or
     as three bf16 products where the split route runs an f32 matrix; on
     the tensor-core route each packed matrix's bytes or its own, the
     smaller), which products it runs on the tensor cores (the `kernels`
     line says "mma" or "fma"), on that route the packed bytes a launch
     reads (printed, not in the `kernels` line: a count, not a reading), and
     its device time in CUDA graph replays, min/median/max over
     GRAPH_REPS replays (and the frame kernel at latent 40 too), and prints
     the weight bytes one encoder, one unmerged and one chain-merged decoder
     launch fetch into the SMs, f32, bf16 and int8, from the tiling the
     built library reports; and the batch pair's ms per frame and
     audio-s/s, its acquisition apart from its decode;
  6. prints a `kernels` JSON line, and last the `ok` JSON line.

Step 2 also holds the int8 instances of the encoder and both decoders
against their plain int8 versions the same way, once with a quant_exclude
set that keeps some matrices in f32 (MIXED), and holds all 23 kernel forms,
which all tile their products over the block's rows, to the same bits on
two launches with the same input and state (B=2048 and B=37).

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
H100_BF16_FLOPS = 989e12  # bf16 products with f32 sums, tensor cores (dense)
H100_BYTES_S = 3.35e12   # HBM3
RX_NOISE = 0.1           # std of the Gaussian noise on the frame-kernel check
SRC = "radae_tpu_torch/csrc/fused_core.cu"
TPU_SRC = "radae_tpu/ops/fused_core.py"
# wrapper -> the TPU kernel body it replaces, file:line
BODIES = {"fused_decoder_step": f"{TPU_SRC}:344",
          "fused_decoder_merged_step": f"{TPU_SRC}:273",
          "fused_rx_frame_step": f"{TPU_SRC}:543",
          "fused_encoder_step": f"{TPU_SRC}:785"}
# the forms of the kernels (fused_core.LAUNCHES keys, every one a wrapper
# can launch) that this script checks, drives on a main path and times:
# f32 and int8, then the bf16-product instances on f32, int8 and bf16
# weights, and the padded chain-merged decoder with f32 and bf16 products
FORMS = ("fused_decoder_step", "fused_decoder_merged_step",
         "fused_rx_frame_step", "fused_encoder_step",
         "fused_decoder_step_int8", "fused_decoder_merged_step_int8",
         "fused_encoder_step_int8",
         "fused_decoder_step_bf16", "fused_decoder_step_bf16w_bf16",
         "fused_decoder_step_int8_bf16", "fused_decoder_merged_step_bf16",
         "fused_decoder_merged_step_bf16w_bf16",
         "fused_decoder_merged_step_int8_bf16",
         "fused_rx_frame_step_bf16", "fused_rx_frame_step_bf16w_bf16",
         "fused_encoder_step_bf16", "fused_encoder_step_bf16w_bf16",
         "fused_encoder_step_int8_bf16",
         "fused_decoder_merged_step_pad", "fused_decoder_merged_step_pad_int8",
         "fused_decoder_merged_step_pad_bf16",
         "fused_decoder_merged_step_pad_bf16w_bf16",
         "fused_decoder_merged_step_pad_int8_bf16")
# the forms whose products run on the tensor cores (tmma): every bf16-
# product form; on f32 weights each bf16 x f32 product runs as SPLIT_PARTS
# bf16 products (the split instances of both decoders, either layout of the
# chain-merged one, and of the encoder, on the weight's hi, mid and lo
# parts: fc.split_parts)
MMA_FORMS = ("fused_decoder_step_bf16", "fused_encoder_step_bf16",
             "fused_decoder_merged_step_bf16",
             "fused_decoder_merged_step_pad_bf16",
             "fused_decoder_step_bf16w_bf16", "fused_decoder_step_int8_bf16",
             "fused_decoder_merged_step_bf16w_bf16",
             "fused_decoder_merged_step_int8_bf16",
             "fused_decoder_merged_step_pad_bf16w_bf16",
             "fused_decoder_merged_step_pad_int8_bf16",
             "fused_rx_frame_step_bf16", "fused_rx_frame_step_bf16w_bf16",
             "fused_encoder_step_bf16w_bf16", "fused_encoder_step_int8_bf16",
             "fused_decoder_step_int8", "fused_encoder_step_int8",
             "fused_decoder_merged_step_int8",
             "fused_decoder_merged_step_pad_int8",
             "fused_decoder_merged_step_pad")
# of those, the forms with f32 products: x split into XSPLIT_PARTS bf16
# parts against each int8 matrix (exact in bf16), and XW_PRODUCTS products
# of x's and w's parts for a matrix kept in f32, every matrix of the padded
# f32 form (PAD_F32); held at TOL like every f32-product form
PAD_F32 = "fused_decoder_merged_step_pad"
XS_FORMS = ("fused_decoder_step_int8", "fused_encoder_step_int8",
            "fused_decoder_merged_step_int8",
            "fused_decoder_merged_step_pad_int8", PAD_F32)
XSPLIT_PARTS = 3
XW_PRODUCTS = 6
# of those, the encoder's: its int8 step is so ill-conditioned (its z
# output cancels in its sums) that the f32 plain version's own rounding
# takes it past TOL of the same step in f64 at latent 40 (up to 3.2 times
# on an H100, PERF.md), and so does every f32 kernel now and then, the FMA
# loops too.  Its MIXED and latent-40 checks hold it within TOL of the
# plain version in f64 (plain_f64)
XS_F64 = ("fused_encoder_step_int8",)
# bf16 products against their plain version: an input of a product that
# sits on a bf16 rounding boundary rounds the other way under another f32
# sum order, and the recurrence carries the flip.  So at most BF16_FLIPS of
# a run's elements (3 chained calls, every tensor) may miss BF16_TOL, and
# each tensor's max and mean abs error stay within BF16_MAX and BF16_MEAN of
# max(1, its mean magnitude); each limit about 3 times the largest reading
# on an H100 (PERF.md: flips 2.7e-4, max 0.0115, the frame forms 0.0199,
# which also round the samples and the DFT, mean 1.9e-4)
BF16_TOL = dict(rtol=2e-3, atol=2e-3)
BF16_FLIPS = 1e-3
BF16_MAX = {"fused_rx_frame_step": 0.06, "": 0.03}
BF16_MEAN = 1e-3
SPLIT_PARTS = 3          # bf16 products a kind-0 (f32) matrix takes, split
GRAPH_REPS = 7           # replays a kernel form's graph is timed over
# the port's benchmark: its budget, and run_bench's modes that are not on its
# ladder, run at B with BENCH_SCAN chained frames
BENCH_BUDGET_S = 300
OFF_LADDER = ("int8bf16", "padf32", "padi8", "frame", "frame_vmem")
BENCH_SCAN = 64
# the streaming rx front end's kernel (rx_demod_phase): its launch key,
# the batches it is held at (a ragged last tile at 37), the std of the
# noise on its samples, and its geometries (the flagship modem and the
# latent-40 one) at 1 and 2 frames a call
DEMOD = "rx_demod"
DEMOD_B = (65536, 2048, 37)
DEMOD_TIME_B = (65536, 2048)
DEMOD_NOISE = 0.05
DEMOD_GEOMETRIES = {"flagship": {}, "l40": {"latent_dim": 40}}
DEMOD_FPS = (1, 2)
DEMOD_STEP_CALLS = 3
DEMOD_FPS_PAST = 40      # frames a call whose rows no warp's shared memory holds
# a quant_exclude set per int8 form that keeps some matrices in f32
MIXED = {"fused_decoder_step_int8": ("whh", "out_w"),
         "fused_decoder_merged_step_int8": ("wgg",),
         "fused_encoder_step_int8": ("whh", "d1_w")}


# the per-frame product path (product_phase): modem frames transmitted, the
# silence after the EOO frame, the EOO bits' seed (apps/txe.py
# --eoo_data_test), the rx features' rows and loss margin and the EOO BER
# (tests/test_streaming_trained.py), the card-against-CPU SNR estimate
PRODUCT_FRAMES = 40
PRODUCT_ZEROS = 3000
EOO_SEED = 65647
PRODUCT_MIN_ROWS = 34 * 12
PRODUCT_LOSS_MARGIN = 0.15
EOO_BER_LIMIT = 0.05
SNR_TOL_DB = 0.01
B1_CALLS = 3             # chained calls of the decoder kernel at B=1
# the file tools (file_tools_phase): the first FILE_SECONDS of the fixture's
# features at B=1, the channel's Eb/No, the chained calls of the per-step
# checks, the acquisition-time gate (tests/test_tools.py) and the seed of
# the channel draw the card's and the CPU's forward share
FILE_SECONDS = 30
FILE_EBNODB = 10.0
FILE_CALLS = 3
FILE_ACQ_S = 1.5
FILE_DRAW_SEED = 17
FLAGSHIP_FLAGS = ["--rate_Fs", "--pilots", "--pilot_eq", "--eq_ls", "--cp",
                  "0.004", "--bottleneck", "3", "--coarse_mag", "--auxdata",
                  "--time_offset", "-16"]


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


def tol_ratio(got, want) -> float:
    """The largest |got - want| / (atol + rtol |want|) of TOL over the
    tensors (1 or less: within TOL), in f64."""
    return max(float(((g.double() - w.double()).abs() / (
        TOL["atol"] + TOL["rtol"] * w.double().abs())).max())
        for g, w in zip(got, want))


def plain_f64(plain, weights, x, state):
    """plain(weights, x, state) run in f64: each product x @ w (times its
    int8 scale row) and everything after it, so each sum is rounded once
    (the f32 plain version's own rounding reaches TOL on the int8 encoder:
    PERF.md).  Returns (output, state) in f64."""
    from radae_tpu_torch.ops import fused_core as fc
    ws = [a.double() for a in weights.arrays]
    rows = iter(weights.scales)
    sc = [next(rows).double() if weights.scales and a.dim() == 2 else 1.0
          for a in weights.arrays]
    real = fc._products
    fc._products = lambda *a, **k: (lambda v, j: (v.double() @ ws[j]) * sc[j])
    try:
        return plain(weights, x.double(), tuple(t.double() for t in state))
    finally:
        fc._products = real


def bf16_errs(got, want):
    """Per tensor of a bf16-product call: (elements past BF16_TOL, elements,
    max abs err / scale, mean abs err / scale), scale = max(1, mean
    |want|)."""
    out = []
    for g, w in zip(got, want):
        err = (g - w).abs()
        scale = max(float(w.abs().mean()), 1.0)
        out.append((int((err > BF16_TOL["atol"] + BF16_TOL["rtol"] * w.abs())
                        .sum()), err.numel(), float(err.max()) / scale,
                    float(err.mean()) / scale))
    return out


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


def graph_runs(fn, n=20, reps=5) -> list:
    """Device time of one fn() call in each of reps replays: n calls
    captured in a CUDA graph, each replay between two CUDA events.  Unlike
    time_ms it leaves out the host's time to issue the calls."""
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
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    ev[0].record()
    for e in ev[1:]:
        g.replay()
        e.record()
    torch.cuda.synchronize()
    return [a.elapsed_time(b) / n for a, b in zip(ev, ev[1:])]


def graph_ms(fn, n=20, reps=5) -> float:
    """The mean of graph_runs(fn, n, reps)."""
    runs = graph_runs(fn, n, reps)
    return sum(runs) / len(runs)


def spread(runs) -> str:
    """min/median/max of a list of times (ms)."""
    r = sorted(runs)
    return f"{r[0]:.4f}/{r[len(r) // 2]:.4f}/{r[-1]:.4f}"


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


def demod_flops(cfg):
    """Flop of one stream's frame front end, counting only what the math
    needs, as (DFT, the rest): the DFT of the M kept samples of each symbol
    row, then the 3-tap LS fit of the two pilot rows, the coarse magnitude
    over the carriers and the interpolation + EQ of every data symbol (8
    flop a complex multiply-add)."""
    n_sym, Nc = cfg.Ns + 2, cfg.Nc
    return (float(8 * n_sym * cfg.M * Nc),
            float(8 * 2 * 3 * Nc + 8 * Nc + 22 * cfg.Ns * Nc))


def packed_sizes(mma):
    """Bytes of each matrix packed for the tensor cores (fc.mma_weights),
    by its index in the weight set."""
    offs = sorted((o, j) for j, o in enumerate(mma.offsets) if o >= 0)
    ends = [o for o, _ in offs[1:]] + [mma.buf.numel() // 8]
    return {j: 16 * (e - o) for (o, j), e in zip(offs, ends)}


def mma_terms(w, mma, nz, batch, block_rows):
    """For a launch on the tensor-core route: ((the bytes bound() counts
    for the packed matrices, the bytes of the weight set's matrices they
    stand in for), the bytes of the packed copy, the packed bytes the
    launch reads into the SMs).  bound() counts per matrix the smaller of
    its packed copy and its own: the function needs the bf16 values of an
    f32 matrix rounded at the product, and only the one byte a weight of an
    int8 matrix, which the packed copy widens to two.  Every block reads
    each packed matrix once a z-step, the frame kernel's dft_w once.  w:
    the PackedWeights whose arrays mma indexes."""
    sizes = packed_sizes(mma)
    own = {j: w.arrays[j].element_size() * w.arrays[j].numel() for j in sizes}
    blocks = -(-batch // block_rows)
    dft = len(w.arrays) - 2 if w.names[-2:] == ("dft_w", "ls_w") else -1
    read = sum(b * blocks * (1 if j == dft else nz) for j, b in sizes.items())
    return ((sum(min(b, own[j]) for j, b in sizes.items()), sum(own.values())),
            sum(sizes.values()), read)


def bound(weights, inputs, outputs, nz, batch, bf16=None, extra=(0.0, 0.0),
          packed=(0, 0)):
    """Least time for one launch: each input read once and each output
    written once at the HBM rate, or the operations at the peak rate of
    their operands' type, whichever is larger.  2 flop per weight-matrix
    element per z-step per stream, at the tensor cores' bf16 rate where
    both operands of the product are bf16 (bf16[j] for weights.arrays[j]:
    the number of bf16 products, SPLIT_PARTS for an f32 matrix on the split
    route) and else at the f32 rate outside the tensor cores, plus extra = (f32
    flop, bf16 flop); the two kinds' times add.  (The padded layout's bound
    is the merged weights': its zero rows are not work.)  packed = (bytes
    counted for the matrices packed for the tensor cores, bytes of the
    matrices they stand in for: `mma_terms`): a launch on that route reads
    the packed copy instead."""
    nbytes = 4 * (weights.buf.numel() + sum(t.numel() for t in inputs)
                  + sum(t.numel() for t in outputs)) + packed[0] - packed[1]
    flops = [extra[0], extra[1]]
    for j, a in enumerate(weights.arrays):
        if a.dim() == 2:
            n = int(bf16[j]) if bf16 else 0
            flops[n > 0] += max(n, 1) * 2.0 * a.numel() * nz * batch
    t_bytes = nbytes / H100_BYTES_S
    t_ops = flops[0] / H100_F32_FLOPS + flops[1] / H100_BF16_FLOPS
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


def rx_frames(rx, stream, timed=False):
    """Feed stream to the per-frame receiver rx (apps/rxe.py) nin samples a
    call.  Returns per call (return code, state, nin, tmax, fmax, SNR
    estimate, features or EOO soft bits when the code is not 0, host ms of
    the call when timed)."""
    import torch
    out = np.zeros(rx.get_n_floats_out(), np.float32)
    recs, ptr = [], 0
    while ptr + rx.get_nin() <= len(stream):
        nin = rx.get_nin()
        t0 = time.perf_counter()
        ret = rx.do_radae_rx(stream[ptr:ptr + nin], out)
        if timed:
            torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0)
        ptr += nin
        recs.append((ret, rx.state, rx.nin, rx.tmax, rx.fmax,
                     rx.receiver.snrdB_3k_est, out.copy() if ret else None,
                     ms))
    return recs


def rx_samples(cfg, fps, batch, seed, dev):
    """(batch, fps*Nmf + M+Ncp, 2) rx samples on dev: fps frames and the
    next pilot row of random latents through the port's modulator, a
    second ray 3 samples late at half the gain and a random phase, a
    random phase a stream, Gaussian noise (std DEMOD_NOISE)."""
    import torch
    from radae_tpu_torch.ops import cplx, ofdm
    g = torch.Generator(device=dev).manual_seed(seed)
    z = torch.tanh(torch.randn((batch, (fps + 1) * cfg.Nzmf, cfg.latent_dim),
                               generator=g, device=dev))
    tx = ofdm.modulate(cfg, z, cplx.const(cfg.P, dev),
                       cplx.const(cfg.Winv, dev))
    n = (fps * (cfg.Ns + 1) + 1) * (cfg.M + cfg.Ncp)
    x = torch.complex(tx[..., 0], tx[..., 1])[:, :n]

    def phase():
        return torch.exp(2j * np.pi * torch.rand((batch, 1), generator=g,
                                                 device=dev))
    y = x.clone()
    y[:, 3:] += 0.5 * phase() * x[:, :-3]
    y = y * phase() + DEMOD_NOISE * torch.complex(
        torch.randn(y.shape, generator=g, device=dev),
        torch.randn(y.shape, generator=g, device=dev))
    return torch.stack([y.real, y.imag], dim=-1).contiguous()


def rx_demod_phase(dev, card):
    """The streaming rx front end's kernel (csrc/rx_demod.cu) against its
    plain version (ofdm.rx_front_end_plain) at TOL's rtol and 1e-5 atol:
    the flagship and latent-40 modems, 1 and 2 frames a call, each batch of
    DEMOD_B, coarse magnitude on (and off at B=2048); two launches to the
    same bits; one launch a call of the rx step, counted; a geometry past
    the kernel's limits refused without a launch; its time by CUDA events
    over graph replays beside its bound and the plain version's at
    DEMOD_TIME_B.  An isolated check: its launches are not main-path
    launches, and it counts none of them there."""
    import torch
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.models.core import CoreDecoder
    from radae_tpu_torch.ops import fused_core as fc, ofdm
    from radae_tpu_torch.runtime import make_streaming_rx_step
    from radae_tpu_torch.utils.hostio import device_put_tree
    tol = dict(rtol=TOL["rtol"], atol=1e-5)
    rows = []
    with torch.no_grad():
        for geo, kw in DEMOD_GEOMETRIES.items():
            for fps in DEMOD_FPS:
                for mag in (True, False):
                    cfg = flagship_config(coarse_mag=mag, **kw)
                    k = ofdm.rx_front_end_consts(cfg, fps, dev)
                    for batch in DEMOD_B if mag else (B,):
                        x = rx_samples(cfg, fps, batch, 1000 * fps + batch,
                                       dev)
                        fc.reset_launches()
                        got = ofdm.rx_front_end(x, k)
                        again = ofdm.rx_front_end(x, k)
                        want = ofdm.rx_front_end_plain(x, k)
                        torch.cuda.synchronize()
                        if fc.LAUNCHES[DEMOD] != 2 or sum(
                                fc.LAUNCHES.values()) != 2:
                            raise AssertionError(
                                f"{DEMOD}: launches {dict(fc.LAUNCHES)}")
                        what = f"{DEMOD} {geo} fps={fps} mag={mag} B={batch}"
                        check_close(what, got, want, tol)
                        if not torch.equal(got, again):
                            raise AssertionError(f"{what}: two launches "
                                                 "differ")
                        row = {"geometry": geo, "fps": fps, "mag": mag,
                               "B": batch, "err": max_err(got, want)}
                        if mag and batch in DEMOD_TIME_B:
                            # the bytes the kernel moves: the M stripped
                            # samples of each row in (the CP's 128-byte
                            # runs are never fetched) and the latents out
                            nbytes = 4 * (batch * k.n_rs * cfg.M * 2
                                          + got.numel())
                            flop = 8.0 * batch * k.n_rs * cfg.M * cfg.Nc
                            runs = graph_runs(
                                lambda: ofdm.rx_front_end(x, k),
                                reps=GRAPH_REPS)
                            row.update(
                                ms=sorted(runs)[len(runs) // 2],
                                spread=spread(runs),
                                bound_ms=1e3 * max(nbytes / H100_BYTES_S,
                                                   flop / H100_F32_FLOPS),
                                by=("bytes" if nbytes / H100_BYTES_S
                                    > flop / H100_F32_FLOPS else "operations"),
                                plain_ms=graph_ms(
                                    lambda: ofdm.rx_front_end_plain(x, k), 5))
                        rows.append(row)
                        print(f"{what}: max abs err {row['err']:.3g}, same "
                              "bits" + (f"; kernel {row['ms']:.4f} ms "
                                        f"({row['spread']}), bound "
                                        f"{row['bound_ms']:.4f} ({row['by']}),"
                                        f" plain {row['plain_ms']:.4f}"
                                        if "ms" in row else ""), flush=True)
        # one launch a call of the rx step, whatever the decoder
        cfg = flagship_config()
        dec = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
        params = dec.init(5)
        x = rx_samples(cfg, 1, RAGGED_B, 5, dev)
        for fused in (False, True):
            step = make_streaming_rx_step(cfg, dec, RAGGED_B, fused=fused,
                                          device=dev)
            w = (fc.decoder_weights(params, dev) if fused
                 else device_put_tree(params, dev))
            st = fc.decoder_state_zero(RAGGED_B, dev) if fused else None
            fc.reset_launches()
            for _ in range(DEMOD_STEP_CALLS):
                _, st = step(w, x, st)
            torch.cuda.synchronize()
            want = {DEMOD: DEMOD_STEP_CALLS}
            if fused:
                want["fused_decoder_step"] = DEMOD_STEP_CALLS
            got = {n: c for n, c in fc.LAUNCHES.items() if c}
            if got != want:
                raise AssertionError(f"rx step fused={fused}: launches {got}, "
                                     f"not {want}")
        # a geometry past the kernel's limits: too many frames a call
        fc.reset_launches()
        try:
            ofdm.rx_front_end_consts(flagship_config(), DEMOD_FPS_PAST, dev)
            raise AssertionError(f"{DEMOD}: frames_per_step {DEMOD_FPS_PAST} "
                                 "not refused")
        except ValueError as e:
            refused = str(e)
        if any(fc.LAUNCHES.values()):
            raise AssertionError(f"{DEMOD}: refused geometry launched")
    print(f"{DEMOD}: refused without a launch: {refused}")
    print(f"{DEMOD}: one launch a rx step call (plain and fused decoder, "
          f"B={RAGGED_B}, {DEMOD_STEP_CALLS} calls)")
    print(json.dumps({DEMOD: rows, "card": card}))


def product_phase(dev, raw, card):
    """The per-frame product path as an operator runs it (apps/txe.py,
    apps/rxe.py: one radio, one 120 ms frame a call) on the card, on the
    fixture checkpoint with auxdata.  First the unmerged f32 decoder
    kernel at B=1 (its 16-row tile with 15 rows masked) against its plain
    version over B1_CALLS chained calls at TOL and to the same bits on two
    launches; then PRODUCT_FRAMES frames of the fixture's features through
    RadaeTx, the EOO frame with data bits and PRODUCT_ZEROS zeros, received
    frame by frame: sync, the rows, the aligned loss and the EOO BER gates
    of tests/test_streaming_trained.py, the decoder kernel launched once a
    decoded frame and nothing else; the same stream through RadaeRx on the
    CPU, frame by frame; RadaeTx's noise-off step on the card against the
    CPU over 3 chained frames.  Prints the ms a frame of both apps and the
    B=1 kernel's time beside its bound.  Returns the product path's
    decoder launches and the kernel's B=1 readings."""
    import torch
    from radae_tpu_torch.apps.rxe import RadaeRx
    from radae_tpu_torch.apps.txe import RadaeTx
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.models.core import distortion_loss
    from radae_tpu_torch.ops import fused_core as fc

    tree, meta = load_checkpoint(os.path.join(HERE, "fixtures",
                                              "model_fs_flagship.npz"))
    rx = RadaeRx(params=tree, auxdata=True, v=0, device=dev)
    w, cfg = rx.weights, rx.cfg
    gen = np.random.default_rng(12)
    zs = [torch.as_tensor(np.tanh(gen.standard_normal(
        (1, cfg.Nzmf, cfg.latent_dim))).astype(np.float32), device=dev)
        for _ in range(B1_CALLS)]
    b1_err = 0.0
    with torch.no_grad():
        sk = sp = fc.decoder_state_zero(1, dev)
        for k, z in enumerate(zs):
            fk, sk1 = fc.fused_decoder_step(w, z, sk)
            again = fc.fused_decoder_step(w, z, sk)
            fp, sp1 = fc.decoder_step_plain(w, z, sp)
            torch.cuda.synchronize()
            check_close(f"fused_decoder_step B=1 call {k}", (fk,) + sk1,
                        (fp,) + sp1, TOL)
            if not all(torch.equal(a, b) for a, b in zip(
                    (fk,) + sk1, (again[0],) + again[1])):
                raise AssertionError(f"fused_decoder_step B=1 call {k}: two "
                                     "launches gave different bits")
            b1_err = max(b1_err, max_err((fk,) + sk1, (fp,) + sp1))
            sk, sp = sk1, sp1
    print(f"fused_decoder_step at B=1: {B1_CALLS} chained calls within TOL "
          f"of its plain version (max abs err {b1_err:.3g}), the same bits "
          "on two launches")

    # -- the round trip on the card, then the same stream on the CPU ------
    tx = RadaeTx(params=tree, auxdata=True, device=dev)
    bits = np.sign(np.random.default_rng(EOO_SEED).random(
        tx.get_Neoo_bits()) - 0.5).astype(np.float32)
    tx.set_eoo_bits(bits)
    rx = RadaeRx(params=tree, auxdata=True, v=0, device=dev)
    n_in = tx.get_n_floats_in()
    fc.reset_launches()
    frames, tx_ms = [], []
    for k in range(PRODUCT_FRAMES):
        t0 = time.perf_counter()
        frames.append(tx.do_radae_tx(raw[12 * k:12 * (k + 1)].reshape(n_in)))
        tx_ms.append(1e3 * (time.perf_counter() - t0))
    stream = np.concatenate(frames + [tx.do_eoo(), np.zeros(
        PRODUCT_ZEROS, np.complex64)])
    if not np.isfinite(stream.view(np.float32)).all():
        raise AssertionError("product path: tx samples not finite")
    recs = rx_frames(rx, stream, timed=True)
    torch.cuda.synchronize()
    n_valid = sum(r[0] & 1 for r in recs)
    launches = dict(fc.LAUNCHES)
    if (launches["fused_decoder_step"] != n_valid
            or sum(launches.values()) != n_valid):
        raise AssertionError(
            f"product path: kernels launched "
            f"{ {n: c for n, c in launches.items() if c} }, not "
            f"{n_valid} fused_decoder_step (one a decoded frame)")
    out = np.concatenate([r[6].reshape(-1, 36) for r in recs if r[0] & 1]
                         or [np.zeros((0, 36), np.float32)])
    eoo = [r[6] for r in recs if r[0] & 2]
    if out.shape[0] < PRODUCT_MIN_ROWS or not np.isfinite(out).all():
        raise AssertionError(f"product path: {out.shape[0]} feature rows "
                             f"(at least {PRODUCT_MIN_ROWS}), finite "
                             f"{bool(np.isfinite(out).all())}")
    n = out.shape[0]
    ref = torch.as_tensor(raw[:12 * PRODUCT_FRAMES, :NUM_USED])
    got = torch.as_tensor(out[None, :, :NUM_USED])
    loss = min(float(distortion_loss(ref[None, s:s + n], got)[0])
               for s in range(0, 12 * PRODUCT_FRAMES - n + 1))
    limit = float(meta["loss"]) + PRODUCT_LOSS_MARGIN
    if not loss < limit:
        raise AssertionError(f"product path: aligned loss {loss:.4f} >= "
                             f"{limit:.4f}")
    if len(eoo) != 1:
        raise AssertionError(f"product path: {len(eoo)} EOO frames found")
    ber = float((eoo[0][:len(bits)] * bits < 0).mean())
    if not ber < EOO_BER_LIMIT:
        raise AssertionError(f"product path: EOO BER {ber:.3f}")

    with torch.no_grad():
        recs_cpu = rx_frames(RadaeRx(params=tree, auxdata=True, v=0,
                                     device="cpu"), stream)
    if len(recs_cpu) != len(recs):
        raise AssertionError(f"product path: {len(recs)} rx calls on the "
                             f"card, {len(recs_cpu)} on the CPU")
    f_err = snr_err = 0.0
    for k, (a, b) in enumerate(zip(recs, recs_cpu)):
        if a[:5] != b[:5]:
            raise AssertionError(f"product path frame {k}: card (ret, state, "
                                 f"nin, tmax, fmax) {a[:5]}, CPU {b[:5]}")
        snr_err = max(snr_err, abs(a[5] - b[5]))
        if snr_err > SNR_TOL_DB:
            raise AssertionError(f"product path frame {k}: SNR estimate "
                                 f"{a[5]:.4f} dB on the card, {b[5]:.4f} "
                                 "on the CPU")
        if a[0]:
            if not np.allclose(a[6], b[6], **TOL):
                raise AssertionError(
                    f"product path frame {k}: features max abs err "
                    f"{float(np.abs(a[6] - b[6]).max()):.3g} outside {TOL}")
            f_err = max(f_err, float(np.abs(a[6] - b[6]).max()))

    # -- the tx step, noise off, on the card against the CPU --------------
    tx_cpu = RadaeTx(params=tree, auxdata=True, device="cpu")
    sg, sc = tx.encoder.zero_state(1, dev), tx_cpu.encoder.zero_state(1, "cpu")
    tx_err = 0.0
    with torch.no_grad():
        for k in range(3):
            f = np.full((1, 12, cfg.feature_dim), -1.0, np.float32)
            f[0, :, :NUM_USED] = raw[12 * k:12 * (k + 1), :NUM_USED]
            a, sg = tx._step(tx.params, torch.as_tensor(f, device=dev), sg,
                             None)
            b, sc = tx_cpu._step(tx_cpu.params, torch.as_tensor(f), sc, None)
            tx_err = max(tx_err, float((a.cpu() - b).abs().max()))
    if not tx_err <= TOL["atol"]:
        raise AssertionError(f"product path: tx noise off, card against CPU "
                             f"max abs err {tx_err:.3g} > {TOL['atol']}")

    sync_ms = [r[7] for r in recs if r[0] & 1]
    period = 1e3 * cfg.Tmf
    print(f"product path on the card: {PRODUCT_FRAMES} frames + EOO + "
          f"{PRODUCT_ZEROS} zeros; sync, {n} feature rows, aligned loss "
          f"{loss:.4f} (limit {limit:.4f}), EOO BER {ber:.4f}; "
          f"fused_decoder_step launched {n_valid} times, once a decoded "
          f"frame; against RadaeRx on the CPU: {len(recs)} calls with the "
          f"same return code, state, nin, tmax and fmax, features max abs "
          f"err {f_err:.3g}, SNR estimate max diff {snr_err:.3g} dB; tx noise "
          f"off card against CPU max abs err {tx_err:.3g}")
    print(f"product path ms a frame (host clock; min/median/max): "
          f"do_radae_tx {spread(tx_ms)} over {len(tx_ms)} frames, "
          f"do_radae_rx {spread(sync_ms)} over the {len(sync_ms)} decoded "
          f"frames, against the {period:.0f} ms frame period ({card})")

    # -- the decoder kernel's time at B=1 beside its bound ----------------
    z, s0 = zs[0], fc.decoder_state_zero(1, dev)
    with torch.no_grad():
        kern = lambda: fc.fused_decoder_step(w, z, s0)
        plain = lambda: fc.decoder_step_plain(w, z, s0)
        ms = time_ms(kern, 50)
        runs = graph_runs(kern, reps=GRAPH_REPS)
        plain_ms = time_ms(plain, 10)
        out1, s1 = plain()
        b_ms, b_by = bound(w, (z,) + s0, (out1,) + s1, cfg.Nzmf, 1)
    print(f"fused_decoder_step at B=1: {ms:.4f} ms (CUDA events), CUDA graph "
          f"replay min/median/max {spread(runs)} ms over {GRAPH_REPS} "
          f"replays, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms by {b_by} "
          f"({card})")
    return n_valid


def held_chain(what, form, xs):
    """form = (kernel call, plain call, zero state) over the inputs xs,
    chained from the zero state: TOL and the same bits on two launches.
    Returns the max abs err and the (kernel, plain) outputs."""
    import torch
    kern, plain, zero = form
    sk = sp = zero()
    err, outs = 0.0, []
    for k, x in enumerate(xs):
        ok, sk1 = kern(x, sk)
        again = kern(x, sk)
        op, sp1 = plain(x, sp)
        torch.cuda.synchronize()
        got, want = (ok,) + sk1, (op,) + sp1
        check_close(f"{what} call {k}", got, want, TOL)
        if not all(torch.equal(a, b) for a, b in zip(
                got, (again[0],) + again[1])):
            raise AssertionError(f"{what} call {k}: two launches gave "
                                 "different bits")
        err = max(err, max_err(got, want))
        outs.append((ok, op))
        sk, sp = sk1, sp1
    return err, outs


def b1_times(name, form, w, x, frames_per_step, n, reps, card):
    """Print the kernel of form (as `held_chain` takes it) on x from the zero
    state: CUDA events over n calls, graph replays, its plain version and
    its bound (one stream, x.shape[1] / frames_per_step z-steps).  Returns
    (ms, plain ms, bound ms, bound by)."""
    import torch
    kern, plain, zero = form
    s0 = zero()
    steps = x.shape[1] // frames_per_step
    with torch.no_grad():
        k = lambda: kern(x, s0)
        ms = time_ms(k, n, warmup=1)
        runs = graph_runs(k, n=n, reps=reps)
        plain_ms = time_ms(lambda: plain(x, s0), 2, warmup=1)
        o, s1 = plain(x, s0)
        b_ms, b_by = bound(w, (x,) + s0, (o,) + s1, steps, 1)
    print(f"{name} at B=1, nz={steps}:"
          f" {ms:.4f} ms (CUDA events), CUDA graph replay min/median/max "
          f"{spread(runs)} ms over {reps} replays, plain {plain_ms:.4f} "
          f"ms, bound {b_ms:.4f} ms by {b_by} ({card})")
    return ms, plain_ms, b_ms, b_by


def run_tool(name, argv, want, launched, wall, label=None):
    """Run a tool of radae_tpu_torch's dispatcher table in this process
    with the launch counts at 0, its stdout and stderr captured; want,
    where given, is the launches it must make.  Adds its launches to
    `launched` and its wall time to `wall` under label (default: name).
    Returns (rc, stdout, launches, stderr)."""
    import importlib
    import torch
    from radae_tpu_torch.__main__ import TOOLS
    from radae_tpu_torch.ops import fused_core as fc
    mod, fn = TOOLS[name]
    out, err = io.StringIO(), io.StringIO()
    fc.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = getattr(importlib.import_module(mod), fn)(list(argv))
    torch.cuda.synchronize()
    label = label or name
    wall[label] = time.perf_counter() - t0
    counts = {k: v for k, v in fc.LAUNCHES.items() if v}
    if want is not None and counts != want:
        raise AssertionError(f"{label}: kernels launched {counts}, not "
                             f"{want}")
    for k, v in counts.items():
        launched[k] = launched.get(k, 0) + v
    return rc, out.getvalue(), counts, err.getvalue()


def file_tools_phase(dev, raw, card):
    """The file tools (tools/inference.py, rx.py, loss.py, stateful.py) on
    the card at full width, on the fixture checkpoint and the first
    FILE_SECONDS of the fixture's features.  First the two kernels on their
    path at B=1 against their plain versions (TOL, the same bits on two
    launches): the unmerged f32 decoder over the whole file in one launch
    (nz in the hundreds, on the encoder's latents) and at nz=1 over
    FILE_CALLS chained calls; the f32 encoder over the whole file and at
    nz=3 over FILE_CALLS chained calls.  Then the tools as a user runs them:
    `python -m radae_tpu_torch inference` (a subprocess) with the flagship
    flags, a 2 Hz offset, the EOO and pre/appended noise written as IQ; rx,
    rx --stateful, loss (the acquisition-time gate and the checkpoint's
    loss + PRODUCT_LOSS_MARGIN, the two decodes compared), inference
    --ber_test at 100 dB and both stateful tools, through the dispatcher's
    table in this process, each with the launch counts at 0 before it and
    checked after it.  Last the card's noise-off forward (the channel's
    draw shared) and receiver against the CPU's.  Prints each tool's wall
    time and both kernels' times at these shapes beside their bounds;
    returns the launches of each kernel form on these paths."""
    import torch
    from radae_tpu_torch.channel import simulate
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.models.radae import RADAE
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.ops.cplx import C

    ckpt = os.path.join(HERE, "fixtures", "model_fs_flagship.npz")
    tree, meta = load_checkpoint(ckpt)
    cfg = flagship_config()
    rows = cfg.num_10ms_times_steps_rounded_to_modem_frames(
        100 * FILE_SECONDS)
    nz = rows // 4
    f = np.full((1, rows, cfg.feature_dim), -1.0, np.float32)
    f[0, :, :NUM_USED] = raw[:rows, :NUM_USED]
    feats = torch.as_tensor(f, device=dev)
    model = RADAE(cfg, dev)
    ew = model.kernel_weights(tree, "encoder")
    dw = model.kernel_weights(tree, "decoder")

    # -- the two kernels at B=1 against their plain versions --------------
    enc = (lambda x, s: fc.fused_encoder_step(ew, x, s, cfg.bottleneck),
           lambda x, s: fc.encoder_step_plain(ew, x, s, cfg.bottleneck),
           lambda: fc.encoder_state_zero(1, dev))
    dec = (lambda x, s: fc.fused_decoder_step(dw, x, s),
           lambda x, s: fc.decoder_step_plain(dw, x, s),
           lambda: fc.decoder_state_zero(1, dev))

    with torch.no_grad():
        e_file, ((zk, z),) = held_chain(
            f"fused_encoder_step B=1 nz={nz}", enc, [feats])
        e_frames, _ = held_chain("fused_encoder_step B=1 nz=3", enc, [
            feats[:, 12 * k:12 * (k + 1)] for k in range(FILE_CALLS)])
        d_file, ((fk, fp),) = held_chain(
            f"fused_decoder_step B=1 nz={nz}", dec, [z])
        d_steps, _ = held_chain("fused_decoder_step B=1 nz=1", dec, [
            z[:, k:k + 1] for k in range(FILE_CALLS)])
    # does the error grow over a long launch?  first and last tenth
    tenth = nz // 10
    step_err = lambda a, b: (a - b).abs().reshape(nz, -1).amax(dim=1)
    ze, fe = step_err(zk, z), step_err(fk, fp)
    print(f"file kernels at B=1 within TOL of their plain versions, the "
          f"same bits on two launches: fused_encoder_step nz={nz} (one "
          f"launch) max abs err {e_file:.3g} (first/last {tenth} z-steps "
          f"{float(ze[:tenth].max()):.3g}/{float(ze[-tenth:].max()):.3g}), "
          f"nz=3 x {FILE_CALLS} chained {e_frames:.3g}; fused_decoder_step "
          f"nz={nz} (one launch) {d_file:.3g} (first/last "
          f"{float(fe[:tenth].max()):.3g}/{float(fe[-tenth:].max()):.3g}), "
          f"nz=1 x {FILE_CALLS} chained {d_steps:.3g}")

    # -- the tools as a user runs them ----------------------------------
    work = os.path.join(HERE, "build", "chip_smoke_files")
    os.makedirs(work, exist_ok=True)
    fin = os.path.join(work, "s30.f32")
    f36 = np.zeros((rows, 36), np.float32)
    f36[:, :NUM_USED] = raw[:rows, :NUM_USED]
    f36.tofile(fin)
    path = {n: os.path.join(work, n + ".f32") for n in (
        "rx", "fh", "fh_vanilla", "fh_stateful", "z")}
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    wall = {}

    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "radae_tpu_torch", "inference", ckpt, fin,
         path["fh"], "--EbNodB", str(FILE_EBNODB), "--freq_offset", "2",
         "--write_rx", path["rx"], "--end_of_over", "--prepend_noise", "0.5",
         "--append_noise", "0.3"] + FLAGSHIP_FLAGS + dev_args, cwd=HERE,
        capture_output=True, text=True, timeout=600)
    wall["inference (subprocess)"] = time.perf_counter() - t0
    if run.returncode != 0 or "loss:" not in run.stdout:
        raise AssertionError(f"inference: {run.stdout!r} {run.stderr[-2000:]!r}")
    inf_lines = [ln for ln in run.stdout.splitlines()
                 if ln.startswith(("Measured", "loss"))]

    launched = {}

    def tool(name, *argv, want=None):
        label = " ".join([name] + [a for a in argv
                                   if a in ("--stateful", "--ber_test")])
        return run_tool(name, list(argv) + dev_args, want, launched, wall,
                        label)[:3]

    rows_of = lambda fn: np.fromfile(fn, np.float32).size // 36
    tool("rx", ckpt, path["rx"], path["fh_vanilla"], "--auxdata",
         want={"fused_decoder_step": 1})
    n_vanilla = rows_of(path["fh_vanilla"])
    counts = tool("rx", ckpt, path["rx"], path["fh_stateful"], "--auxdata",
                  "--stateful")[2]
    n_stateful = rows_of(path["fh_stateful"])
    n_frames = n_stateful // 12
    if not n_frames or counts != {"fused_decoder_step": n_frames}:
        raise AssertionError(f"rx --stateful: {n_stateful} rows from "
                             f"launches {counts} (one a frame)")
    limit = float(meta["loss"]) + PRODUCT_LOSS_MARGIN
    rc, loss_out, _ = tool("loss", fin, path["fh_vanilla"], "--acq_time_test",
                        str(FILE_ACQ_S), "--loss_test", f"{limit:.4f}",
                        "--clip_end", "100", "--features_hat2",
                        path["fh_stateful"], "--compare", want={})
    if rc != 0 or loss_out.count("PASS") != 2:
        raise AssertionError(f"loss: {loss_out!r} (limit {limit:.4f})")
    rc, ber_out, _ = tool("inference", ckpt, fin, "/dev/null", "--ber_test",
                       *FLAGSHIP_FLAGS, want={})
    if "BER: 0.000" not in ber_out:
        raise AssertionError(f"inference --ber_test: {ber_out!r}")
    rc_e, enc_out, _ = tool("stateful_encoder", ckpt, fin, "--auxdata",
                         "--write_latent", path["z"],
                         want={"fused_encoder_step": 1 + rows // 12})
    rc_d, dec_out, _ = tool("stateful_decoder", ckpt, fin, "--auxdata",
                         want={"fused_encoder_step": 1,
                               "fused_decoder_step": 1 + nz})
    if (rc_e, rc_d) != (0, 0) or "PASS" not in enc_out + dec_out:
        raise AssertionError(f"stateful tools: {enc_out!r} {dec_out!r}")

    # -- the card's noise-off forward and receiver against the CPU's ------
    # (no frequency offset: its phase is a cumsum over the whole file, whose
    # f32 sum order differs between the card and the CPU by enough to move
    # the features past TOL over 30 s)
    real_draw = simulate.complex_normal

    def shared_draw(gen, shape):
        x = np.random.default_rng(FILE_DRAW_SEED).standard_normal(
            tuple(shape) + (2,)) / np.sqrt(2)
        t = torch.as_tensor(x.astype(np.float32), device=gen.device)
        return C(t[..., 0], t[..., 1])

    ncfg = flagship_config(quant_noise=False, EbNodB=FILE_EBNODB)
    outs = []
    simulate.complex_normal = shared_draw
    try:
        with torch.no_grad():
            for where in (dev, torch.device("cpu")):
                m = RADAE(ncfg, where)
                fc.reset_launches()
                out = m.forward(tree, f)
                rx = (out["rx"].re[0] + 1j * out["rx"].im[0]).cpu().numpy()
                fh, zh = m.receiver(tree, rx.astype(np.complex64))
                torch.cuda.synchronize()
                if not outs:
                    counts = {k: v for k, v in fc.LAUNCHES.items() if v}
                    if dev.type == "cuda" and counts != {
                            "fused_encoder_step": 1, "fused_decoder_step": 2}:
                        raise AssertionError(
                            f"forward + receiver: kernels launched {counts}, "
                            "not one encoder and two decoder launches")
                    for k, v in counts.items():
                        launched[k] = launched.get(k, 0) + v
                outs.append([(k, out[k]) for k in sorted(out)] + [
                    ("receiver features", fh), ("receiver z_hat", zh)])
    finally:
        simulate.complex_normal = real_draw
    fr_err = 0.0
    for (k, a), (_, b) in zip(*outs):
        if a is None:
            continue
        a, b = ((torch.stack([t.re, t.im]) if isinstance(t, C) else t).cpu()
                for t in (a, b))
        check_close(f"forward/receiver {k} card against CPU", (a,), (b,), TOL)
        fr_err = max(fr_err, float((a - b).abs().max()))

    # -- the kernels' times at these shapes beside their bounds -----------
    b1_times("fused_encoder_step", enc, ew, feats, 4, 2, 3, card)
    b1_times("fused_encoder_step", enc, ew, feats[:, :12].contiguous(), 4, 20,
             GRAPH_REPS, card)
    b1_times("fused_decoder_step", dec, dw, z, 1, 2, 3, card)
    b1_times("fused_decoder_step", dec, dw, z[:, :1].contiguous(), 1, 20,
             GRAPH_REPS, card)

    loss_line = next(ln for ln in loss_out.splitlines() if "loss:" in ln)
    print(f"file tools on the card ({FILE_SECONDS} s, the checkpoint, "
          f"{FILE_EBNODB} dB, 2 Hz): inference {'; '.join(inf_lines)}; rx "
          f"{n_vanilla} rows (one decoder launch), rx --stateful "
          f"{n_stateful} rows ({n_frames} launches, nz=3); {loss_line.strip()} "
          f"(limit {limit:.4f}, acq. time gate {FILE_ACQ_S} s), the two "
          f"decodes: {loss_out.splitlines()[-2].strip()}; --ber_test "
          f"{ber_out.strip().splitlines()[-2].strip()}; "
          f"{enc_out.splitlines()[0]}; {dec_out.splitlines()[0]}; noise-off "
          f"forward and receiver card against CPU max abs err {fr_err:.3g}")
    print("file tools wall time (host clock): " + "; ".join(
        f"{k} {v:.2f} s" for k, v in wall.items()) + f" ({card})")
    print(f"file tools launches: {launched}")
    return launched


TRAIN_FLAGS = ["--rate_Fs", "--pilots", "--pilot_eq", "--eq_ls", "--cp",
               "0.004", "--bottleneck", "3", "--range_EbNo", "--auxdata"]
# the configuration tools/train.py builds from TRAIN_FLAGS
TRAIN_CFG = dict(feature_dim=21, latent_dim=80, EbNodB=0.0, range_EbNo=True,
                 rate_Fs=True, bottleneck=3, pilots=True, pilot_eq=True,
                 eq_mean6=False, cyclic_prefix=0.004)
# frames a sequence: train.py's default, 256, is not a whole number of
# 120 ms modem frames (12 feature frames), on which the forward reshapes
# (radae_tpu's too), so the nearest below it
TRAIN_T = 252
TRAIN_CHECK_B = 8        # the card's step against the CPU's
TRAIN_CHECK_EBNODB = 5.0
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-3    # of each leaf's max |g|
TRAIN_TIMED = ((32, False), (512, False), (512, True))   # (B, remat)
REMAT_PEAK_MAX = 0.75    # remat's peak memory over the plain step's, same B
TRAIN_WARMUP, TRAIN_REPS = 1, 3
TRAIN_TOOL_SEQ, TRAIN_TOOL_SEQS, TRAIN_TOOL_B = 120, 48, 8
TRAIN_TOOL_EPOCHS = 2
TRAIN_G_SEED = 23
EVAL_ARGS = ["--channels", "awgn,mpp", "--EbNodB", "0,6,10", "--reps", "2",
             "--seconds", "4"]
CKPT_META = {"model_args", "dataset_args", "batch_size", "lr",
             "lr_decay_factor", "sequence_length", "adam_betas", "epoch",
             "loss"}


def train_phase(dev, raw, card):
    """Training (parallel/trainstep.py, tools/train.py, tools/evaluate.py)
    on the card at the flagship's full width (TRAIN_FLAGS).

    1. One train step from the fixture checkpoint on TRAIN_CHECK_B fixture
       sequences of TRAIN_T frames, on the card and on the CPU: quant noise
       off, a fixed Eb/No, the channel's Gaussian draw shared (the only
       draw left); the loss within TRAIN_LOSS_RTOL, each of the 78 gradient
       leaves within TRAIN_GRAD_TOL of its max |g|, and every leaf's
       gradient on the card finite and nonzero.  The step launches no
       kernel (the kernels have no backward).
    2. `python -m radae_tpu_torch train` (through the dispatcher's table,
       in this process) with TRAIN_FLAGS
       and a --g_file written by channel/doppler.multipath_samples("mpp")
       for TRAIN_TOOL_EPOCHS epochs: the epoch loss falls, the last
       checkpoint loads in the port with radae_tpu's meta keys, and its
       noise-free forward runs both kernels.
    3. The hand-off to serving on the tree the optimizer of 1 updated in
       place: the noise-free forward and receiver under no_grad launch
       the encoder and decoder kernels on weights packed again after the
       update, within TOL of the plain nets on the same tensors.
    4. Times the step (host-issued, CUDA events): forward, backward and
       optimizer apart and the whole train_step, min/median/max of
       TRAIN_REPS, audio-s/s (B*T*0.01/step) and the peak memory, for each
       of TRAIN_TIMED, quant noise and the Eb/No draw on; remat's loss and
       gradients against the plain step's on the same draws (TRAIN_LOSS_RTOL,
       TRAIN_GRAD_TOL), and its peak under REMAT_PEAK_MAX of the plain
       step's at the same B.
    5. A one-rank group (NCCL on the card): two steps give the losses of
       two steps without a group.
    6. `evaluate` on the fixture checkpoint (EVAL_ARGS): every cell finite,
       each channel's loss at 10 dB no higher than at 0 dB.
    Returns the kernel launches of 2 and 3."""
    import importlib
    import re
    import socket
    import torch
    import torch.distributed as dist
    from radae_tpu_torch.__main__ import TOOLS
    from radae_tpu_torch.channel import doppler, simulate
    from radae_tpu_torch.config import RADAEConfig
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.data.dataset import make_aux_symbols
    from radae_tpu_torch.models.radae import RADAE, tree_leaves
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.ops.cplx import C
    from radae_tpu_torch.parallel.distributed import initialize
    from radae_tpu_torch.parallel.trainstep import (make_loss_fn,
                                                    make_train_step,
                                                    step_generator)

    ckpt = os.path.join(HERE, "fixtures", "model_fs_flagship.npz")
    tree, _ = load_checkpoint(ckpt)
    cpu = torch.device("cpu")
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    T = TRAIN_T
    n_seq = raw.shape[0] // T
    aux_rng = np.random.default_rng(0)

    def batch(B):
        """B fixture sequences of T frames (repeated past the fixture's),
        the auxdata column drawn as the dataset draws it."""
        f = np.stack([raw[(i % n_seq) * T:(i % n_seq + 1) * T, :NUM_USED]
                      for i in range(B)])
        aux = np.stack([make_aux_symbols(T, aux_rng) for _ in range(B)])
        return np.concatenate([f, aux], axis=2).astype(np.float32)

    def names(t):
        return [k for k, _ in _named_leaves(t)]

    launched = {}
    fc.reset_launches()

    def count(what, want=None):
        """Check the launches since the last count (or the phase's start)
        against want, add them to the phase's and set the counts to 0."""
        counts = {k: v for k, v in fc.LAUNCHES.items() if v}
        if want is not None and counts != want:
            raise AssertionError(f"{what}: kernels launched {counts}, not "
                                 f"{want}")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
        fc.reset_launches()

    # -- 1. one step, card against CPU ------------------------------------
    ncfg = RADAEConfig(**dict(TRAIN_CFG, quant_noise=False, range_EbNo=False,
                              EbNodB=TRAIN_CHECK_EBNODB))
    f8 = batch(TRAIN_CHECK_B)
    real_draw = simulate.complex_normal

    def shared_draw(gen, shape):
        x = np.random.default_rng(FILE_DRAW_SEED).standard_normal(
            tuple(shape) + (2,)) / np.sqrt(2)
        t = torch.as_tensor(x.astype(np.float32), device=gen.device)
        return C(t[..., 0], t[..., 1])

    steps = {}
    simulate.complex_normal = shared_draw
    try:
        for where in (dev, cpu):
            m = RADAE(ncfg, where)
            init, step = make_train_step(m, aux_ber=True)
            st = init(tree)
            if where == dev:
                # pack the kernels' weights before the update (3. below)
                with torch.no_grad():
                    m.forward(st.params, f8[:1])
                packed_before = {s: m.kernel_weights(st.params, s)
                                 for s in ("encoder", "decoder")}
                bufs_before = {s: w.buf.clone()
                               for s, w in packed_before.items()}
                count("forward before the step", {
                    "fused_encoder_step": 1, "fused_decoder_step": 1})
            t0 = time.perf_counter()
            st, met = step(st, torch.as_tensor(f8, device=where), None, None,
                           0)
            torch.cuda.synchronize()
            steps[where.type] = (m, st, float(met["loss"][0]),
                                 float(met["ber"][0]),
                                 [t.grad.cpu() for t in tree_leaves(st.params)],
                                 time.perf_counter() - t0)
            if where == dev:
                count("the train step", {})
    finally:
        simulate.complex_normal = real_draw
    (m, st, loss_d, ber_d, g_d, s_d), (_, _, loss_c, _, g_c, s_c) = (
        steps[dev.type], steps["cpu"])
    if not abs(loss_d - loss_c) <= TRAIN_LOSS_RTOL * abs(loss_c):
        raise AssertionError(f"train step loss card {loss_d} CPU {loss_c}")
    leaf_names = names(st.params)
    if len(leaf_names) != 78:
        raise AssertionError(f"{len(leaf_names)} leaves, not 78")
    worst = (0.0, "")
    for k, a, b in zip(leaf_names, g_d, g_c):
        if not (torch.isfinite(a).all() and a.abs().max() > 0):
            raise AssertionError(f"gradient of {k} on the card: not finite "
                                 "and nonzero")
        r = float((a - b).abs().max() / b.abs().max())
        if not r <= TRAIN_GRAD_TOL:
            raise AssertionError(f"gradient of {k}: card against CPU {r:.3g} "
                                 f"of its max |g|, limit {TRAIN_GRAD_TOL}")
        worst = max(worst, (r, k))
    print(f"train step B={TRAIN_CHECK_B} T={T} (quant noise off, "
          f"{TRAIN_CHECK_EBNODB} dB, the channel's draw shared), card against "
          f"CPU: loss {loss_d:.6f} / {loss_c:.6f} (rel "
          f"{abs(loss_d - loss_c) / abs(loss_c):.3g}), aux BER {ber_d:.3f}; "
          f"78 leaves finite and nonzero on the card, the largest gradient "
          f"difference {worst[0]:.3g} of the leaf's max |g| ({worst[1]}); "
          f"first step (host clock) card {s_d:.2f} s, CPU {s_c:.2f} s")

    # -- 3. the hand-off: kernels on the tree updated in place ------------
    tol_err = 0.0
    with torch.no_grad():
        f1 = torch.as_tensor(f8[:2], device=dev)
        out = m.forward(st.params, f1)
        count("forward after the step", {"fused_encoder_step": 1,
                                         "fused_decoder_step": 1})
        for s in ("encoder", "decoder"):
            w = m.kernel_weights(st.params, s)
            if w is packed_before[s] or torch.equal(w.buf, bufs_before[s]):
                raise AssertionError(f"the {s}'s kernel weights were not "
                                     "packed again after the update")
        z = m.core_encoder(st.params["encoder"], f1)[0]
        fh = m.core_decoder(st.params["decoder"], out["z_hat"])[0]
        check_close("forward z, kernel against the plain net", (out["z"],),
                    (z,), TOL)
        check_close("forward features_hat, kernel against the plain net",
                    (out["features_hat"],), (fh,), TOL)
        rx = (out["rx"].re[0] + 1j * out["rx"].im[0]).cpu().numpy()
        fr, zr = m.receiver(st.params, rx.astype(np.complex64))
        count("receiver", {"fused_decoder_step": 1})
        fr_plain = m.core_decoder(st.params["decoder"], zr)[0]
        check_close("receiver, kernel against the plain net", (fr,),
                    (fr_plain,), TOL)
        tol_err = max(max_err((out["z"], out["features_hat"], fr),
                              (z, fh, fr_plain)), tol_err)
    print(f"hand-off: the noise-free forward and receiver on the updated tree "
          f"ran the encoder and decoder kernels on weights packed again, "
          f"within TOL of the plain nets (max abs err {tol_err:.3g})")

    # -- 2. the train tool ------------------------------------------------
    work = os.path.join(HERE, "build", "chip_smoke_train")
    os.makedirs(work, exist_ok=True)
    fin = os.path.join(work, "train.f32")
    rows = TRAIN_TOOL_SEQ * TRAIN_TOOL_SEQS
    f36 = np.zeros((rows, 36), np.float32)
    f36[:, :NUM_USED] = raw[:rows, :NUM_USED]
    f36.tofile(fin)
    gfile = os.path.join(work, "mpp.g")
    tcfg = RADAEConfig(**TRAIN_CFG)
    doppler.multipath_samples("mpp", tcfg.Fs, tcfg.Rs_dash, tcfg.Nc, 30.0,
                              G_fn=gfile,
                              rng=np.random.default_rng(TRAIN_G_SEED))
    out_dir = os.path.join(work, "out")
    mod, fn = TOOLS["train"]
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(log):
        rc = getattr(importlib.import_module(mod), fn)(
            [fin, out_dir] + TRAIN_FLAGS + [
                "--g_file", gfile, "--sequence-length", str(TRAIN_TOOL_SEQ),
                "--batch-size", str(TRAIN_TOOL_B), "--epochs",
                str(TRAIN_TOOL_EPOCHS)] + dev_args)
    tool_s = time.perf_counter() - t0
    count("train", {})
    epochs = [ln for ln in log.getvalue().splitlines()
              if re.match(r"epoch \d+: loss", ln)]
    losses = [float(re.search(r"loss ([-\d.]+)", ln).group(1))
              for ln in epochs]
    if rc or len(losses) != TRAIN_TOOL_EPOCHS or not (
            losses[-1] < losses[0]):
        raise AssertionError(f"train: rc {rc}, epochs {epochs} "
                             f"{log.getvalue()[-2000:]!r}")
    last = os.path.join(out_dir, "checkpoints",
                        f"checkpoint_epoch_{TRAIN_TOOL_EPOCHS}.npz")
    trained, meta = load_checkpoint(last)
    if sorted(names(trained)) != sorted(names(tree)) or \
            set(meta) != CKPT_META or \
            meta["epoch"] != TRAIN_TOOL_EPOCHS:
        raise AssertionError(f"checkpoint {last}: meta {sorted(meta)}")
    tm = RADAE(RADAEConfig(**dict(TRAIN_CFG, quant_noise=False,
                                  range_EbNo=False, EbNodB=10.0)), dev)
    with torch.no_grad():
        fh = tm.forward(trained, f8[:2])["features_hat"]
    count("the trained checkpoint's forward", {"fused_encoder_step": 1,
                                               "fused_decoder_step": 1})
    if not torch.isfinite(fh).all():
        raise AssertionError("the trained checkpoint's forward: not finite")
    print(f"train tool ({TRAIN_TOOL_SEQS} sequences of {TRAIN_TOOL_SEQ}, "
          f"B={TRAIN_TOOL_B}, --g_file mpp, {tool_s:.1f} s through "
          "the dispatcher's table): "
          + "; ".join(epochs) + f"; checkpoint epoch {meta['epoch']} loaded, "
          "its noise-free forward on both kernels finite")

    # -- 4. timing ----------------------------------------------------------
    model = RADAE(RADAEConfig(**TRAIN_CFG), dev)
    ev = lambda: torch.cuda.Event(enable_timing=True)
    peaks = {}
    for B, remat in TRAIN_TIMED:
        # what earlier phases hold is not the step's
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        fb = torch.as_tensor(batch(B), device=dev)
        init, step = make_train_step(model, aux_ber=True, remat=remat)
        loss_fn = make_loss_fn(model, aux_ber=True, remat=remat)
        st = init(tree)
        if remat:
            # the same draws through both: the blocks' runs again in the
            # backward must draw the noise of their first runs
            leaves = list(tree_leaves(st.params))
            got = [torch.autograd.grad(l, leaves) + (l.detach(),) for l in (
                make_loss_fn(model, aux_ber=True, remat=r)(
                    st.params, fb, None, None, step_generator(dev, 0, 0))[0]
                for r in (False, True))]
            worst = max(float((a - b).abs().max() / a.abs().max())
                        for a, b in zip(got[0][:-1], got[1][:-1]))
            rel = float(abs(got[1][-1] - got[0][-1]) / abs(got[0][-1]))
            print(f"train step B={B} remat against the plain step on the "
                  f"card, the same draws: loss rel {rel:.1e}, the largest "
                  f"gradient difference {worst:.2e} of the leaf's max |g|")
            if not (rel <= TRAIN_LOSS_RTOL and worst <= TRAIN_GRAD_TOL):
                raise AssertionError(f"train step B={B}: remat's loss or "
                                     "gradient differs from the plain step's")
            del got
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        parts = []
        for i in range(TRAIN_WARMUP + TRAIN_REPS):
            e = [ev() for _ in range(4)]
            e[0].record()
            st.optimizer.zero_grad(set_to_none=True)
            loss, _ = loss_fn(st.params, fb, None, None,
                              step_generator(dev, 0, i))
            e[1].record()
            loss.backward()
            e[2].record()
            st.optimizer.step()
            st.scheduler.step()
            e[3].record()
            if i >= TRAIN_WARMUP:
                parts.append(e)
        whole = []
        for i in range(TRAIN_WARMUP + TRAIN_REPS):
            e = [ev(), ev()]
            e[0].record()
            st, met = step(st, fb, None, None, 0)
            e[1].record()
            if i >= TRAIN_WARMUP:
                whole.append(e)
        torch.cuda.synchronize()
        peak = peaks[B, remat] = (torch.cuda.max_memory_allocated()
                                  - held) / 2 ** 20
        fwd, bwd, opt = ([e[j].elapsed_time(e[j + 1]) for e in parts]
                         for j in range(3))
        ms = [e[0].elapsed_time(e[1]) for e in whole]
        med = sorted(ms)[len(ms) // 2]
        if not np.isfinite(float(met["loss"][0])):
            raise AssertionError(f"train step B={B}: loss not finite")
        print(f"train step B={B} T={T}{' remat' if remat else ''} (flagship "
              f"flags, quant noise on): train_step min/median/max "
              f"{spread(ms)} ms, {B * T * 0.01 / (med / 1e3):.1f} audio-s/s; "
              f"forward {spread(fwd)}, backward {spread(bwd)}, optimizer "
              f"{spread(opt)} ms (CUDA events, host-issued, {TRAIN_REPS} "
              f"steps); peak memory {peak:.1f} MiB (the state, the batch "
              f"and the step's); loss "
              f"{float(met['loss'][0]):.4f} ({card})")
    for B, remat in TRAIN_TIMED:
        if dev.type != "cuda":          # no allocator to read on the CPU
            break
        if remat and not peaks[B, True] < REMAT_PEAK_MAX * peaks[B, False]:
            raise AssertionError(
                f"train step B={B}: remat's peak {peaks[B, True]:.1f} MiB "
                f"is not under {REMAT_PEAK_MAX} of {peaks[B, False]:.1f}")

    # -- 5. a one-rank group ----------------------------------------------
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    backend = "nccl" if dev.type == "cuda" else "gloo"
    group = initialize(backend, 1, 0, f"tcp://127.0.0.1:{port}",
                       device=dev if dev.type == "cuda" else None)
    f32b = torch.as_tensor(batch(32), device=dev)
    try:
        got = []
        for g in (None, group):
            init, step = make_train_step(model, aux_ber=True, group=g)
            st = init(tree)
            got.append([float(step(st, f32b, None, None, 0)[1]["loss"][0])
                        for _ in range(2)])
    finally:
        dist.destroy_process_group()
    if not np.allclose(got[1], got[0], rtol=1e-5, atol=0):
        raise AssertionError(f"one-rank {backend} group: losses {got[1]}, "
                             f"without a group {got[0]}")
    print(f"one-rank {backend} group: two steps' losses {got[1]}, without a "
          f"group {got[0]}")

    # -- 6. evaluate --------------------------------------------------------
    fev = os.path.join(work, "eval.f32")
    f36[:400].tofile(fev)
    js = os.path.join(work, "eval.json")
    mod, fn = TOOLS["evaluate"]
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        getattr(importlib.import_module(mod), fn)(
            [ckpt, fev] + EVAL_ARGS + ["--json", js] + dev_args)
    ev_s = time.perf_counter() - t0
    count("evaluate", {})
    with open(js) as fj:
        table = json.load(fj)
    if not all(np.isfinite(v) for v in table.values()) or not all(
            table[f"{ch}@10.0"] <= table[f"{ch}@0.0"]
            for ch in ("awgn", "mpp")):
        raise AssertionError(f"evaluate: {table}")
    print(f"evaluate ({ev_s:.1f} s): " + "; ".join(
        ln.strip() for ln in out.getvalue().splitlines()))
    print(f"train phase launches: {launched}")
    return launched


SPEECH_T = 2400          # 24 s of the fixture: BBFM's operating point
BBFM_CNRDB = 10.0
BBFM_LOSS_LIMIT = 0.2    # radae_tpu's gate (tests/test_bbfm_trained.py)
SC_T = 960               # feature frames through the single-carrier modem
SC_CORR_MIN = 0.98       # radae_tpu's gates through the modem, clean channel
SC_LOSS_DELTA = 0.02
BBFM_TRAIN_B, BBFM_TRAIN_T = 32, 96     # train_bbfm on fixture sequences
BBFM_TRAIN_EPOCHS = 2
BBFM_TRAIN_LR = 1e-3
BBFM_DRAW_SEED = 29
VOC_CHECK_T = 50         # the neural vocoder card against CPU, frames
VOC_PCM_TOL = 8          # of its int16 pcm: the render's rounding (PERF.md)
VOC_CEP_T = 500          # frames of the cepstral-distance gate
VOC_WAV_T = 400          # the wav the pipeline takes: 4 s
VOC_CORPUS = ((1000, 300), (5000, 300))  # (first frame, frames) a wav
VOC_EPOCHS = 2
SPEECH_EVAL_ARGS = ["--channels", "awgn,mpp", "--EbNodB", "10", "--reps",
                    "1", "--seconds", "4"]


def modem_loopback(z):
    """z frames (nz, 80) through the single-carrier modem on a clean
    channel (tests/test_bbfm_trained.py): the frames the receiver gives
    once in sync, scaled by its gain, cut to those that line up with z;
    the correlation of the first with the best of z's first four; and
    that offset."""
    from radae_tpu_torch.dsp.single_carrier import SingleCarrier
    tx, rx = SingleCarrier(fcentreHz=1500), SingleCarrier(fcentreHz=1500)
    samples = np.concatenate([tx.tx(zk.astype(np.complex64)) for zk in z]
                             + [tx.tx(np.zeros(z.shape[1], np.complex64))])
    recovered, n = [], 0
    while len(samples) - n >= rx.nin:
        nin = rx.nin
        syms = rx.rx(samples[n:n + nin])
        if rx.state == "sync":
            recovered.append((rx.g * syms.real).astype(np.float32))
        n += nin
    z_rx = np.stack(recovered)
    corr, off = max((np.corrcoef(z_rx[0], z[o])[0, 1], o) for o in range(4))
    return z_rx[:min(len(z_rx), len(z) - off)], corr, off


def speech_phase(dev, raw, card):
    """BBFM, the single-carrier modem and the speech back end (models/
    bbfm.py, tools/{bbfm,sc_modem,wav_pipeline,evaluate}.py, vocoder.py,
    vocoder_nn.py) on the card at full width, on the fixtures.

    1. BBFM's operating point: fixtures/model_bbfm.npz at BBFM_CNRDB on
       SPEECH_T frames, quant noise on (the plain nets): loss below
       BBFM_LOSS_LIMIT.
    2. Both kernels with noise off at BBFM's widths: the f32 encoder with
       bottleneck 1 (in_dim 80) and the unmerged f32 decoder (out_dim 80)
       at B=1 over the SPEECH_T/4 z-steps in one launch, each within TOL
       of its plain version and the same bits on two launches, timed
       beside their bounds; the noise-off forward launches each once.
    3. z of SC_T frames (the encoder kernel) through SingleCarrier on a
       clean channel, decoded by the decoder kernel: correlation above
       SC_CORR_MIN, loss within SC_LOSS_DELTA of the direct decode's.
       Then `bbfm_inference` (quant noise on) and `bbfm_rx` (one decoder
       launch) as tools on the SPEECH_T frames.
    4. One BBFM training loss and gradient on the card and on the CPU
       (BBFM_TRAIN_B fixture sequences; the channel's draw and the quant
       noise, which train_bbfm's loss always draws, shared): loss within
       TRAIN_LOSS_RTOL, each leaf within TRAIN_GRAD_TOL of its max |g|;
       then `train_bbfm` for
       BBFM_TRAIN_EPOCHS epochs at B=BBFM_TRAIN_B: finite, falling loss.
    5. Speech out: a wav made by MelVocoder from the fixture through `wav
       --vocoder neural` (the flagship checkpoint); the neural vocoder's
       pcm on VOC_CHECK_T frames card against CPU within VOC_PCM_TOL; on
       VOC_CEP_T frames its cepstral distance below MelVocoder's; its
       synthesis time a second of audio.
    6. `vocoder_nn corpus` on wavs written under a temp dir, then `train`
       for VOC_EPOCHS epochs: finite losses, weights written.
    7. `evaluate --audio` on 4 s, two cells: each cell's wav pair and
       README, the clean references.
    Returns the kernel launches of 2 (the forward), 3 and the tools."""
    import shutil
    import tempfile
    import wave
    import torch
    from radae_tpu_torch import vocoder_nn as V
    from radae_tpu_torch.config import BBFMConfig
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.models import bbfm as bbfm_mod
    from radae_tpu_torch.models import layers
    from radae_tpu_torch.models.bbfm import BBFM
    from radae_tpu_torch.models.core import distortion_loss
    from radae_tpu_torch.models.radae import tree_leaves
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.parallel.trainstep import leaf_tree
    from radae_tpu_torch.tools.bbfm import make_loss_fn
    from radae_tpu_torch.tools.wav_pipeline import read_wav, write_wav
    from radae_tpu_torch.vocoder import NEURAL_WEIGHTS, MelVocoder

    t_phase = time.perf_counter()
    cpu = torch.device("cpu")
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    ckpt = os.path.join(HERE, "fixtures", "model_bbfm.npz")
    flagship = os.path.join(HERE, "fixtures", "model_fs_flagship.npz")
    fixture = os.path.join(HERE, "fixtures", "speech_feats.f32")
    tree, _ = load_checkpoint(ckpt)
    T, nz = SPEECH_T, SPEECH_T // 4
    feats = torch.as_tensor(np.ascontiguousarray(raw[None, :T, :NUM_USED]),
                            device=dev)
    kw = dict(feature_dim=NUM_USED, latent_dim=80, CNRdB=BBFM_CNRDB)
    model = BBFM(BBFMConfig(**kw), dev)
    quiet = BBFM(BBFMConfig(quant_noise=False, **kw), dev)
    H = np.ones((1, model.cfg.num_timesteps_at_rate_Rs(T), 1), np.float32)
    launched, wall = {}, {}

    def count(what, want):
        counts = {k: v for k, v in fc.LAUNCHES.items() if v}
        if dev.type == "cuda" and counts != want:
            raise AssertionError(f"{what}: kernels launched {counts}, not "
                                 f"{want}")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v

    # -- 1. the operating point, quant noise on ---------------------------
    with torch.no_grad():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        fc.reset_launches()
        out = model.forward(tree, feats, H, key=gen)
        torch.cuda.synchronize()
        count("BBFM forward with quant noise", {})
        loss_op = float(distortion_loss(feats, out["features_hat"])[0])
    if not loss_op < BBFM_LOSS_LIMIT:
        raise AssertionError(f"BBFM loss {loss_op} at {BBFM_CNRDB} dB, "
                             f"limit {BBFM_LOSS_LIMIT}")

    # -- 2. both kernels, noise off, at BBFM's widths ---------------------
    ew = quiet.kernel_weights(tree, "encoder")
    dw = quiet.kernel_weights(tree, "decoder")
    enc = (lambda x, s: fc.fused_encoder_step(ew, x, s, 1),
           lambda x, s: fc.encoder_step_plain(ew, x, s, 1),
           lambda: fc.encoder_state_zero(1, dev))
    dec = (lambda x, s: fc.fused_decoder_step(dw, x, s),
           lambda x, s: fc.decoder_step_plain(dw, x, s),
           lambda: fc.decoder_state_zero(1, dev))
    with torch.no_grad():
        e_err, ((zk, z),) = held_chain(
            f"BBFM fused_encoder_step bottleneck 1 B=1 nz={nz}", enc, [feats])
        d_err, _ = held_chain(f"BBFM fused_decoder_step F=20 B=1 nz={nz}",
                              dec, [z])
    print(f"BBFM kernels at B=1, nz={nz}, within TOL of their plain versions, "
          f"the same bits on two launches: fused_encoder_step (bottleneck 1, "
          f"in_dim 80) max abs err {e_err:.3g}, |z| max "
          f"{float(z.abs().max()):.4f}; fused_decoder_step (out_dim 80) "
          f"{d_err:.3g}")
    b1_times("BBFM fused_encoder_step", enc, ew, feats, 4, 3, 3, card)
    b1_times("BBFM fused_decoder_step", dec, dw, z, 1, 3, 3, card)
    with torch.no_grad():
        fc.reset_launches()
        out0 = quiet.forward(tree, feats, H)
        torch.cuda.synchronize()
        count("BBFM noise-off forward", {"fused_encoder_step": 1,
                                         "fused_decoder_step": 1})
        loss_quiet = float(distortion_loss(feats, out0["features_hat"])[0])

    # -- 3. z through the single-carrier modem, then the tools ------------
    with torch.no_grad():
        f_sc = feats[:, :SC_T].contiguous()
        fc.reset_launches()
        z_sc = fc.fused_encoder_step(ew, f_sc, fc.encoder_state_zero(1, dev),
                                     1)[0]
        fh_direct = quiet.receiver(tree, z_sc)
        torch.cuda.synchronize()
        count("BBFM encoder + direct decode", {"fused_encoder_step": 1,
                                               "fused_decoder_step": 1})
        loss_direct = float(distortion_loss(f_sc, fh_direct)[0])
    t0 = time.perf_counter()
    z_rx, corr, off = modem_loopback(z_sc[0].cpu().numpy())
    modem_s = time.perf_counter() - t0
    with torch.no_grad():
        fc.reset_launches()
        fh_modem = quiet.receiver(tree, z_rx[None])
        torch.cuda.synchronize()
        count("BBFM decode after the modem", {"fused_decoder_step": 1})
        loss_modem = float(distortion_loss(
            f_sc[:, off * 4:off * 4 + fh_modem.shape[1]], fh_modem)[0])
    if not (corr > SC_CORR_MIN and abs(loss_modem - loss_direct)
            < SC_LOSS_DELTA):
        raise AssertionError(f"BBFM through the modem: correlation {corr}, "
                             f"loss {loss_modem} against {loss_direct}")

    work = os.path.join(HERE, "build", "chip_smoke_speech")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    path = {k: os.path.join(work, k + ".f32") for k in ("f", "fh", "z", "fh_rx")}
    f36 = np.zeros((T, 36), np.float32)
    f36[:, :NUM_USED] = raw[:T, :NUM_USED]
    f36.tofile(path["f"])
    _, inf_out, _, _ = run_tool(
        "bbfm_inference", [ckpt, path["f"], path["fh"], "--CNRdB",
                           str(BBFM_CNRDB), "--write_latent", path["z"],
                           "--loss_test", str(BBFM_LOSS_LIMIT)] + dev_args,
        {}, launched, wall)
    run_tool("bbfm_rx", [ckpt, path["z"], path["fh_rx"]] + dev_args,
             {"fused_decoder_step": 1}, launched, wall)
    fh_rx = np.fromfile(path["fh_rx"], np.float32).reshape(-1, 36)
    if "PASS" not in inf_out or fh_rx.shape[0] != T or not np.isfinite(
            fh_rx).all():
        raise AssertionError(f"bbfm_inference | bbfm_rx: {inf_out!r}, "
                             f"{fh_rx.shape} rows")
    print(f"BBFM ({BBFM_CNRDB} dB, {T} frames): loss {loss_op:.4f} (quant "
          f"noise on, limit {BBFM_LOSS_LIMIT}), noise off {loss_quiet:.4f}; "
          f"through the single-carrier modem ({SC_T} frames, clean, "
          f"{len(z_rx)} frames recovered in line, host {modem_s:.2f} s): correlation "
          f"{corr:.4f}, loss {loss_modem:.4f} against {loss_direct:.4f} "
          f"direct; bbfm_inference {inf_out.strip().splitlines()[0]}")

    # -- 4. training: the card's first loss and gradient, then the tool ----
    B, Tt = BBFM_TRAIN_B, BBFM_TRAIN_T
    n_seq = raw.shape[0] // Tt
    fb = np.stack([raw[(k % n_seq) * Tt:(k % n_seq + 1) * Tt, :NUM_USED]
                   for k in range(B)])
    Hb = np.ones((B, quiet.cfg.num_timesteps_at_rate_Rs(Tt), 1), np.float32)
    draw = np.random.default_rng(BBFM_DRAW_SEED).standard_normal(
        Hb.shape).astype(np.float32)
    qrng = np.random.default_rng(BBFM_DRAW_SEED + 1)
    bank, seen = {}, {}

    def shared_quant_noise(gen, x):
        """The k-th application of a shape adds the same U(-.5, .5)/127 on
        the card and on the CPU."""
        shape = tuple(x.shape)
        k = seen[shape] = seen.get(shape, -1) + 1
        drawn = bank.setdefault(shape, [])
        if k == len(drawn):
            drawn.append(qrng.uniform(-0.5, 0.5, shape).astype(np.float32))
        return torch.clamp(x + torch.as_tensor(drawn[k], device=x.device)
                           / 127.0, -1.0, 1.0)

    real = bbfm_mod.normal, layers.quant_noise
    bbfm_mod.normal = lambda gen, shape: torch.as_tensor(draw,
                                                         device=gen.device)
    layers.quant_noise = shared_quant_noise
    res = []
    try:
        for where in (dev, cpu):
            seen.clear()
            m = BBFM(BBFMConfig(**kw), where)
            params = leaf_tree(tree, where)
            gen = torch.Generator(device=where)
            gen.manual_seed(0)
            fc.reset_launches()
            loss = make_loss_fn(m)(params, torch.as_tensor(fb, device=where),
                                   torch.as_tensor(Hb, device=where), gen,
                                   BBFM_CNRDB)
            loss.backward()
            if where == dev:
                torch.cuda.synchronize()
                count("BBFM train loss and gradient", {})
            res.append((float(loss.detach()), [t.grad.cpu() for t in
                                      tree_leaves(params)]))
    finally:
        bbfm_mod.normal, layers.quant_noise = real
    (l_card, g_card), (l_cpu, g_cpu) = res
    rel = abs(l_card - l_cpu) / abs(l_cpu)
    g_err = max(float((a - b).abs().max() / b.abs().max())
                for a, b in zip(g_card, g_cpu))
    if rel > TRAIN_LOSS_RTOL or g_err > TRAIN_GRAD_TOL or not all(
            torch.isfinite(g).all() for g in g_card):
        raise AssertionError(f"BBFM train step card against CPU: loss "
                             f"{l_card} / {l_cpu}, gradient {g_err:.3g}")
    run_dir = os.path.join(work, "train")
    _, _, _, tr_err = run_tool(
        "train_bbfm", [fixture, run_dir, "--epochs", str(BBFM_TRAIN_EPOCHS),
                       "--batch-size", str(B), "--sequence-length", str(Tt),
                       "--CNRdB", str(BBFM_CNRDB), "--lr", str(BBFM_TRAIN_LR)]
        + dev_args, {}, launched, wall)
    ep = [float(ln.split()[-1]) for ln in tr_err.splitlines()
          if ln.startswith("epoch ")]
    if len(ep) != BBFM_TRAIN_EPOCHS or not all(np.isfinite(ep)) or not (
            ep[-1] < ep[0]) or not os.path.exists(os.path.join(
                run_dir, "checkpoints",
                f"checkpoint_epoch_{BBFM_TRAIN_EPOCHS}.npz")):
        raise AssertionError(f"train_bbfm: {tr_err!r}")
    print(f"BBFM training: loss card {l_card:.6f} CPU {l_cpu:.6f} (rel "
          f"{rel:.3g}), gradient {g_err:.3g} of each leaf's max |g| "
          f"(B={B}, T={Tt}, the draws shared); train_bbfm "
          f"B={B}: epoch losses {ep} ({raw.shape[0] // Tt // B} steps an "
          f"epoch)")

    # -- 5. speech out ----------------------------------------------------
    mel = MelVocoder()
    wav_in, wav_out = (os.path.join(work, n) for n in ("mel.wav", "out.wav"))
    write_wav(wav_in, mel.synthesize(raw[:VOC_WAV_T]))
    _, _, _, wav_err = run_tool(
        "wav", [flagship, wav_in, wav_out, "--vocoder", "neural",
                "--auxdata"] + dev_args, {}, launched, wall)
    y = read_wav(wav_out)
    if len(y) < (VOC_WAV_T - 12) * 160 or not np.abs(y).max() > 0:
        raise AssertionError(f"wav: {len(y)} samples; {wav_err[-2000:]!r}")
    nv = V.NeuralVocoder(NEURAL_WEIGHTS, device=dev)
    nc = V.NeuralVocoder(NEURAL_WEIGHTS, device=cpu)
    pcm_d = nv.synthesize(raw[:VOC_CHECK_T]).astype(np.int32)
    pcm_c = nc.synthesize(raw[:VOC_CHECK_T]).astype(np.int32)
    pcm_err = int(np.abs(pcm_d - pcm_c).max())
    f5 = np.ascontiguousarray(raw[None, :VOC_CEP_T, :20])
    nz5 = np.random.default_rng(0).standard_normal(
        (1, (VOC_CEP_T - 1) * 160)).astype(np.float32)
    with torch.no_grad():
        r_d = V.synth(nv.params, torch.as_tensor(f5, device=dev),
                      torch.as_tensor(nz5, device=dev))[0].cpu().numpy()
        r_c = V.synth(nc.params, torch.as_tensor(f5), torch.as_tensor(nz5)
                      )[0].numpy()
    r_rel = float(np.linalg.norm(r_d - r_c) / np.linalg.norm(r_c))
    d_neural = V.cepstral_distance(raw[:VOC_CEP_T],
                                   nv.synthesize(raw[:VOC_CEP_T]))
    d_mel = V.cepstral_distance(raw[:VOC_CEP_T],
                                mel.synthesize(raw[:VOC_CEP_T]))
    if pcm_err > VOC_PCM_TOL or not d_neural < d_mel:
        raise AssertionError(f"neural vocoder: pcm card against CPU "
                             f"{pcm_err}, cepstral distance {d_neural} "
                             f"against MelVocoder's {d_mel}")
    secs = (VOC_CEP_T - 1) * 160 / 16000
    with torch.no_grad():
        fd, nzd = (torch.as_tensor(a, device=dev) for a in (f5, nz5))
        synth_ms = time_ms(lambda: V.synth(nv.params, fd, nzd), 5)
    t0 = time.perf_counter()
    nv.synthesize(raw[:VOC_CEP_T])
    synth_host_s = time.perf_counter() - t0
    print(f"neural vocoder: pcm card against CPU on {VOC_CHECK_T} frames max "
          f"{pcm_err} (limit {VOC_PCM_TOL}); render on {VOC_CEP_T} frames "
          f"card against CPU {r_rel:.3g} normwise; cepstral distance on "
          f"{VOC_CEP_T} frames {d_neural:.4f} against MelVocoder's "
          f"{d_mel:.4f}; synth (torch.gru, cuDNN) {synth_ms:.3f} ms for "
          f"{secs:.2f} s of audio ({synth_ms / secs:.3f} ms a second, CUDA "
          f"events), synthesize with the host post-filter {synth_host_s:.3f} "
          f"s ({synth_host_s / secs:.4f} real-time factor) ({card})")

    # -- 6. vocoder training on wavs written here ---------------------------
    with tempfile.TemporaryDirectory(dir=work) as tmp:
        wavs = os.path.join(tmp, "wavs")
        os.makedirs(wavs)
        for k, (a, n) in enumerate(VOC_CORPUS):
            write_wav(os.path.join(wavs, f"s{k}.wav"),
                      mel.synthesize(raw[a:a + n]))
        corpus = os.path.join(tmp, "corpus.npz")
        run_tool("vocoder_nn", ["corpus", wavs, corpus] + dev_args, {},
                 launched, wall, "vocoder_nn corpus")
        _, tr_out, _, _ = run_tool(
            "vocoder_nn", ["train", corpus, os.path.join(tmp, "run"),
                           "--epochs", str(VOC_EPOCHS)] + dev_args, {},
            launched, wall, "vocoder_nn train")
        vl = [float(ln.split()[-1]) for ln in tr_out.splitlines()
              if ln.startswith("vocoder epoch")]
        if len(vl) != VOC_EPOCHS or not all(np.isfinite(vl)) or not \
                os.path.exists(os.path.join(tmp, "run",
                                            f"vocoder_ep{VOC_EPOCHS}.npz")):
            raise AssertionError(f"vocoder_nn train: {tr_out!r}")
        n_frames = int(np.load(corpus)["bounds"][-1])
    print(f"vocoder_nn: corpus of {n_frames} frames from {len(VOC_CORPUS)} "
          f"wavs, train epoch losses {vl}")

    # -- 7. evaluate --audio ----------------------------------------------
    adir = os.path.join(work, "audio")
    _, _, _, ev_err = run_tool(
        "evaluate", [flagship, fixture] + SPEECH_EVAL_ARGS
        + ["--audio", adir] + dev_args, {}, launched, wall, "evaluate --audio")
    readme = []
    for cell in ("speech_feats_10dB_awgn", "speech_feats_10dB_mpp"):
        for suffix, fs in ((".wav", 16000), ("_ssb.wav", 8000)):
            with wave.open(os.path.join(adir, cell + suffix), "rb") as w:
                if w.getframerate() != fs or w.getnframes() < fs:
                    raise AssertionError(f"evaluate --audio: {cell}{suffix}")
        lines = open(os.path.join(adir, cell + "_zREADME.txt")).read(
        ).splitlines()
        readme.append(f"{cell}: {lines[3].split(':')[-1].strip()} fwSegSNR, "
                      f"C/No {lines[1].split()[-2]} / SSB {lines[2].split()[-2]}")
    if not all(os.path.exists(os.path.join(adir, f"zz_speech_feats_{k}.wav"))
               for k in ("orig", "ssb")):
        raise AssertionError(f"evaluate --audio: {sorted(os.listdir(adir))}")
    print("evaluate --audio: " + "; ".join(readme))
    print("speech tools wall time (host clock): " + "; ".join(
        f"{k} {v:.2f} s" for k, v in wall.items()) + f" ({card})")
    print(f"speech phase launches: {launched}")
    print(f"speech phase: {time.perf_counter() - t_phase:.1f} s")
    return launched


PTT_CASES = {   # tests/test_session.py's two sessions
    "awgn": dict(n_overs=2, over_secs=4.0, gap_secs=2.0, snrdB=3.0, seed=1),
    "mpp": dict(n_overs=2, over_secs=5.0, gap_secs=2.0, channel="mpp",
                snrdB=3.0, seed=1)}
OTA_ROWS = 1000          # 10 s of the fixture through the OTA driver
OTA_CNODB = 50.0
REFIT_SNRS = (0.0, 6.0, 12.0)
REFIT_FRAMES = 4
REFIT_RTOL = 1e-4
PILOT_EPOCHS = 5
PILOT_RTOL = 1e-5
PILOT_DRAW_SEED = 31
WEBTX_ROWS = 300         # 3 s of speech through the web tx service
PROFILE_B = 32           # the training-step breakdown's batch (train.py's)
PROFILE_T = 48           # and sequence; one chained iteration a call, one
                         # slope (radae_tpu's T=240, 8 and 3 take minutes)
SCALING_REPS = 2         # slopes of the eval and the train step (3 and 5)


def ptt_gates(case, reports):
    """tests/test_session.py's gates on one session's per-over reports."""
    for i, r in enumerate(reports):
        ok = r["acquired"] and r["frames_decoded"] >= (
            20 if case == "awgn" else 25) and (r["eoo"] or case != "awgn")
        if not ok:
            raise AssertionError(f"ptt_loop {case} over {i}: {reports}")
    if case == "awgn" and not any(r["unsynced_after"] for r in reports):
        raise AssertionError(f"ptt_loop awgn: sync never dropped: {reports}")
    if not any(r["eoo"] for r in reports):
        raise AssertionError(f"ptt_loop {case}: no EOO found: {reports}")


def tools_phase(dev, raw, card):
    """The last modules (tools/{ptt_loop,ota,est_snr,webtx,ml_pilots,
    profile,scaling}.py) on the card at the flagship's full width, on the
    fixture checkpoint and the fixture's features.

    1. The PTT session (the main path of this phase): each of PTT_CASES
       (AWGN at 3 dB with two 4 s overs, MPP at 3 dB with two 5 s overs,
       seed 1) made by the port's RadaeTx on the card and received by one
       RadaeRx across every over and gap (`ptt_loop.make_session` and
       `receive_session`, which `run_session` chains): the gates of
       tests/test_session.py; the f32 decoder kernel launched once a
       decoded frame at B=1 and nothing else; the same session IQ through
       the receiving loop on the CPU gives the same reports.  Then the
       `ptt_loop` CLI with its PTT hooks and --rig-out.
    2. `ota` at OTA_CNODB dB on OTA_ROWS fixture rows: exit 0.
    3. `est_snr --refit`, and refit_pipeline on REFIT_SNRS, REFIT_FRAMES
       frames on the card against the CPU: raw estimates at REFIT_RTOL.
    4. A `webtx` round trip on loopback: the IQ of a WEBTX_ROWS-frame wav
       received on the card acquires and finds its EOO.
    5. `ml_pilots`: PILOT_EPOCHS epochs on the card against the CPU on
       shared host draws (params at PILOT_RTOL), then the CLI.
    6. `profile` at B (the plain rx step, a torch.profiler trace of it),
       its training-step breakdown at PROFILE_B, PROFILE_T, and `scaling`
       over the cards present (SCALING_REPS slopes).
    Prints each session's ms a frame, the B=1 kernel's share of it and
    each tool's wall time; returns the kernel launches of 1 and 2."""
    import contextlib
    import shutil
    import threading
    import urllib.request
    import wave
    from http.server import ThreadingHTTPServer
    import torch
    from radae_tpu_torch.apps.rxe import RadaeRx
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.tools import (est_snr, ml_pilots, profile, ptt_loop,
                                       scaling)
    from radae_tpu_torch.tools.webtx import make_handler
    from radae_tpu_torch.vocoder import MelVocoder, SPEECH_FS

    t_phase = time.perf_counter()
    dev_args = [] if dev.type == "cuda" else ["--device", "cpu"]
    ckpt = os.path.join(HERE, "fixtures", "model_fs_flagship.npz")
    fixture = os.path.join(HERE, "fixtures", "speech_feats.f32")
    work = os.path.join(HERE, "build", "chip_smoke_tools")
    os.makedirs(work, exist_ok=True)
    tree, _ = load_checkpoint(ckpt)
    launched, wall = {}, {}

    # -- 1. the PTT session -------------------------------------------------
    w = fc.decoder_weights(tree["decoder"], dev)
    with torch.no_grad():
        z = torch.as_tensor(np.tanh(np.random.default_rng(13).standard_normal(
            (1, 3, 80))).astype(np.float32), device=dev)
        s0 = fc.decoder_state_zero(1, dev)
        k_ms = time_ms(lambda: fc.fused_decoder_step(w, z, s0), 50)
    fc.reset_launches()
    for case, kw in PTT_CASES.items():
        t0 = time.perf_counter()
        session, marks = ptt_loop.make_session(tree, raw, device=dev, **kw)
        tx_s = time.perf_counter() - t0
        fc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports, counts = ptt_loop.receive_session(tree, session, marks,
                                                   device=dev)
        torch.cuda.synchronize()
        rx_s = time.perf_counter() - t0
        got = {k: v for k, v in fc.LAUNCHES.items() if v}
        if got != {"fused_decoder_step": counts["decoded"]} or not \
                counts["decoded"]:
            raise AssertionError(f"ptt_loop {case}: kernels launched {got}, "
                                 f"not {counts['decoded']} fused_decoder_step "
                                 "(one a decoded frame)")
        launched["fused_decoder_step"] = launched.get(
            "fused_decoder_step", 0) + counts["decoded"]
        ptt_gates(case, reports)
        with torch.no_grad():
            cpu_reports, cpu_counts = ptt_loop.receive_session(
                tree, session, marks, device="cpu")
        if (cpu_reports, cpu_counts) != (reports, counts):
            raise AssertionError(f"ptt_loop {case}: card {reports} {counts}, "
                                 f"CPU {cpu_reports} {cpu_counts}")
        n_tx = kw["n_overs"] * (max(2, int(kw["over_secs"] / 0.12)) + 1)
        rx_ms = 1e3 * rx_s / counts["frames"]
        print(f"ptt_loop {case}: {len(session) / 8000:.2f} s session, "
              f"{counts['frames']} frames received, {counts['decoded']} "
              f"decoded, reports {reports} (the CPU's the same); tx "
              f"{1e3 * tx_s / n_tx:.3f} ms a frame ({n_tx} frames with the "
              f"EOO), rx {rx_ms:.3f} ms a frame against the 120 ms period; "
              f"fused_decoder_step at B=1 {k_ms:.4f} ms (CUDA events), "
              f"{counts['decoded'] * k_ms / (1e3 * rx_s):.4f} of the "
              f"receiving loop's time ({card})")
    rig = os.path.join(work, "rig.f32")
    rc, _, counts_cli, err = run_tool(
        "ptt_loop", [ckpt, fixture, "--over-secs", "4", "--snrdB", "3",
                     "--seed", "1", "--rig-out", rig, "--ptt-on-cmd", "true",
                     "--ptt-off-cmd", "true"] + dev_args, None, launched,
        wall)
    if rc != 0 or set(counts_cli) != {"fused_decoder_step"} or \
            os.path.getsize(rig) < 2 * 4 * 8000 * 8:
        raise AssertionError(f"ptt_loop CLI: rc {rc}, {counts_cli}: {err}")

    # -- 2. the OTA driver --------------------------------------------------
    feats = os.path.join(work, "ota_feats.f32")
    raw[:OTA_ROWS].tofile(feats)
    rc, out, counts_ota, err = run_tool(
        "ota", [ckpt, feats, "--CNodB", str(OTA_CNODB)] + dev_args, None,
        launched, wall)
    if rc != 0 or "OTA PASS" not in out:
        raise AssertionError(f"ota: rc {rc}: {out} {err}")
    print(f"ota at {OTA_CNODB} dB on {OTA_ROWS / 100:.0f} s: PASS, kernels "
          f"{counts_ota}; {next(ln for ln in err.splitlines() if ln.startswith('ota wall'))}; "
          + "; ".join(ln.strip() for ln in out.splitlines()
                      if ln.startswith("chirp C/No") or "acq_time" in ln))

    # -- 3. est_snr --refit -------------------------------------------------
    rc, out, _, _ = run_tool("est_snr", ["--refit"] + dev_args, {},
                             launched, wall)
    fit = next(ln for ln in out.splitlines() if ln.startswith("refit"))
    got = est_snr.refit_pipeline(np.array(REFIT_SNRS), REFIT_FRAMES,
                                 device=dev)
    want = est_snr.refit_pipeline(np.array(REFIT_SNRS), REFIT_FRAMES,
                                  device="cpu")
    if not np.allclose(got[3], want[3], rtol=REFIT_RTOL, atol=0):
        raise AssertionError(f"est_snr refit raw estimates: card {got[3]}, "
                             f"CPU {want[3]}")
    print(f"est_snr --refit: {fit}; on {REFIT_SNRS} dB, {REFIT_FRAMES} "
          f"frames, raw estimates card {np.round(got[3], 5).tolist()} "
          f"against the CPU's, max diff "
          f"{float(np.abs(got[3] - want[3]).max()):.3g} dB")

    # -- 4. webtx on loopback -------------------------------------------------
    srv = ThreadingHTTPServer(("127.0.0.1", 0), make_handler(tree,
                                                             device=dev))
    th = threading.Thread(target=srv.serve_forever, daemon=True)
    th.start()
    try:
        pcm = MelVocoder().synthesize(raw[:WEBTX_ROWS]).astype(np.int16)
        buf = io.BytesIO()
        with wave.open(buf, "wb") as wv:
            wv.setnchannels(1)
            wv.setsampwidth(2)
            wv.setframerate(SPEECH_FS)
            wv.writeframes(pcm.tobytes())
        t0 = time.perf_counter()
        with contextlib.redirect_stderr(io.StringIO()):
            iq = np.frombuffer(urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{srv.server_port}/tx", data=buf.getvalue(),
                method="POST"), timeout=300).read(), np.float32).view(
                    np.complex64)
        wall["webtx POST"] = time.perf_counter() - t0
    finally:
        srv.shutdown()
        srv.server_close()
    rx = RadaeRx(params=tree, auxdata=True, v=0, device=dev)
    recs = rx_frames(rx, np.concatenate([iq, np.zeros(16000, np.complex64)]))
    if not (any(r[0] & 1 for r in recs) and any(r[0] & 2 for r in recs)):
        raise AssertionError(f"webtx: {len(iq)} samples, the receiver did "
                             "not acquire and find the EOO")
    print(f"webtx: {WEBTX_ROWS / 100:.0f} s wav -> {len(iq)} samples in "
          f"{wall['webtx POST']:.3f} s, acquired with EOO on the card")

    # -- 5. ml_pilots ----------------------------------------------------------
    real_normal = ml_pilots.normal
    res = {}
    for d in (dev, torch.device("cpu")):
        host = np.random.default_rng(PILOT_DRAW_SEED)
        ml_pilots.normal = lambda gen, shape, host=host: torch.as_tensor(
            host.standard_normal(shape).astype(np.float32), device=gen.device)
        try:
            res[d.type] = ml_pilots.train_pilots(epochs=PILOT_EPOCHS,
                                                 batches=10, device=d)
        finally:
            ml_pilots.normal = real_normal
    pr_err = max(float(np.abs(res[dev.type][0][k] - res["cpu"][0][k]).max())
                 for k in ("Pr", "Pi"))
    if not all(np.allclose(res[dev.type][0][k], res["cpu"][0][k],
                           rtol=PILOT_RTOL, atol=0) for k in ("Pr", "Pi")):
        raise AssertionError(f"ml_pilots: card against CPU max abs err "
                             f"{pr_err:.3g}")
    rc, out, _, _ = run_tool("ml_pilots", ["--epochs", str(PILOT_EPOCHS)]
                             + dev_args, {}, launched, wall)
    print(f"ml_pilots: {PILOT_EPOCHS} epochs card against CPU on shared "
          f"draws, params max abs err {pr_err:.3g}, PAPR "
          f"{res[dev.type][1]:.4f} / {res['cpu'][1]:.4f} dB; the CLI: "
          f"{out.strip().splitlines()[-1]}")

    # -- 6. profile and scaling ---------------------------------------------
    trace = os.path.join(work, "trace")
    rc, out, counts, _ = run_tool("profile", ["--batch", str(B), "--trace",
                                              trace] + dev_args, None,
                                  launched, wall)
    if set(counts) != ({DEMOD} if dev.type == "cuda" else set()):
        raise AssertionError(f"profile: kernels launched {counts}, not the "
                             f"rx front end's alone (its plain rx step)")
    trace_b = os.path.getsize(os.path.join(trace, "rx_step_trace.json"))
    shutil.rmtree(trace)
    if not trace_b:
        raise AssertionError("profile --trace wrote nothing")
    o = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(o):
        rows = profile.train_breakdown([PROFILE_B], T=PROFILE_T, scan=1,
                                       slopes=1, device=dev)
    wall["profile train_breakdown"] = time.perf_counter() - t0
    if set(rows[0]) != {"B", *profile.ROWS}:
        raise AssertionError(f"profile train_breakdown: {rows}")
    print(f"profile --batch {B} --trace (a torch.profiler trace of {trace_b} "
          f"B) and train_breakdown([{PROFILE_B}], T={PROFILE_T}) ({card}):")
    for ln in (out + o.getvalue()).strip().splitlines():
        print(f"  {ln}")
    t0 = time.perf_counter()
    rows = scaling.measure_scaling(
        (1,) if dev.type == "cpu" else (1, 2, 4, 8), device=dev.type,
        eval_reps=SCALING_REPS, train_reps=SCALING_REPS)
    wall["scaling"] = time.perf_counter() - t0
    if not all(np.isfinite(r["loss0"]) for r in rows):
        raise AssertionError(f"scaling: {rows}")
    o = io.StringIO()
    with contextlib.redirect_stdout(o):
        scaling.print_rows(rows, dev.type)
    print(f"scaling, {torch.cuda.device_count()} card(s) present, "
          f"{SCALING_REPS} slopes ({card}):")
    for ln in o.getvalue().strip().splitlines():
        print(f"  {ln}")
    print("last tools wall time (host clock): " + "; ".join(
        f"{k} {v:.2f} s" for k, v in wall.items()) + f" ({card})")
    print(f"tools phase launches: {launched}")
    print(f"tools phase: {time.perf_counter() - t_phase:.1f} s")
    return launched


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, prefix + k + "/")
        else:
            yield prefix + k, v

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
    from radae_tpu_torch import bench

    dev = torch.device("cuda")
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    # -- build ------------------------------------------------------------
    t0 = time.time()
    procs = {name: _kernels.start_build(name)
             for name in ("fused_core", "rx_demod")}
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
    bf = torch.bfloat16
    # the new forms: name -> (weights, the weights its bound counts): bf16
    # products on f32, bf16 and int8 weights, and the padded chain-merged
    # layout (bounded by the merged layout's weights)
    def dec_w(**k):
        return fc.decoder_weights(tree["decoder"], dev, **k)

    dwb, dwmb = dec_w(dtype=bf), dec_w(merged=True, dtype=bf)
    rwb = fc.fused_rx_weights(tree["decoder"], cfg, dev, dtype=bf)
    dwp, dwpq = dec_w(merged="pad"), dec_w(merged="pad", quant="int8")
    new_w = {"fused_decoder_step_bf16": (dw, dw),
             "fused_decoder_step_bf16w_bf16": (dwb, dwb),
             "fused_decoder_step_int8_bf16": (dwq, dwq),
             "fused_decoder_merged_step_bf16": (dwm, dwm),
             "fused_decoder_merged_step_bf16w_bf16": (dwmb, dwmb),
             "fused_decoder_merged_step_int8_bf16": (dwmq, dwmq),
             "fused_rx_frame_step_bf16": (rw, rw.decoder),
             "fused_rx_frame_step_bf16w_bf16": (rwb, rwb.decoder),
             "fused_encoder_step_bf16": (ew, ew),
             "fused_encoder_step_bf16w_bf16": (
                 fc.encoder_weights(tree["encoder"], dev, dtype=bf),) * 2,
             "fused_encoder_step_int8_bf16": (ewq, ewq),
             "fused_decoder_merged_step_pad": (dwp, dwm),
             "fused_decoder_merged_step_pad_int8": (dwpq, dwmq),
             "fused_decoder_merged_step_pad_bf16": (dwp, dwm),
             "fused_decoder_merged_step_pad_bf16w_bf16": (
                 dec_w(merged="pad", dtype=bf), dwmb),
             "fused_decoder_merged_step_pad_int8_bf16": (dwpq, dwmq)}
    if set(FORMS) | {DEMOD} != set(fc.LAUNCHES) or set(FORMS[7:]) != set(
            new_w):
        raise AssertionError("FORMS must hold every form a wrapper launches: "
                             f"{sorted(set(fc.LAUNCHES) ^ set(FORMS))}")
    rx_demod_phase(dev, card)

    def bf16_mask(name, w, mma=None):
        """Per array of w: the bf16 products its product takes on the
        tensor cores in form name: 1 where both operands are bf16 (the
        rounding rule of the form's body, fc._rounds), SPLIT_PARTS for an
        f32 matrix that the launches packed split (mma, their kept
        fc.mma_weights copy), else 0 (f32 work); in XS_FORMS XSPLIT_PARTS
        for an int8 matrix and XW_PRODUCTS for one kept in f32."""
        if name in XS_FORMS:
            return [0 if a.dim() != 2 else XSPLIT_PARTS
                    if a.dtype == torch.int8 else XW_PRODUCTS for a in w.arrays]
        if not name.endswith("_bf16"):
            return None
        rule = ("all" if "rx_frame" in name else
                "none" if "merged" in name else "gru")
        split = [mma is not None and mma.offsets[j] >= 0 and mma.kinds[j] == 0
                 for j in range(len(w.arrays))]
        return [SPLIT_PARTS if sp else int(r or a.dtype == bf) for a, r, sp in
                zip(w.arrays, fc._rounds(w, bf, rule), split)]

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

    def tx_signal(fused, n_frames=N_FRAMES, model=None, bf16_weights=None):
        """n_frames of tx samples (B, n*Nmf + M+Ncp, 2), zero-padded so the
        last frame has its closing pilot window; model (cfg, encoder,
        params) for the plain step, the flagship by default.  bf16_weights
        (with fused=False): the plain step's encoder is the encoder kernel's
        bf16-product instance on these weights (radae_tpu's tx step has no
        compute_dtype; its encoder factory has)."""
        c, e, p = model or (cfg, enc, params)
        ep = ew if fused else p["encoder"]
        es = fc.encoder_state_zero(B, dev) if fused else None
        if bf16_weights is not None:
            e = lambda w, x, key, state: fc.fused_encoder_step(
                w, x, state, c.bottleneck, bf)
            ep, es = bf16_weights, fc.encoder_state_zero(B, dev)
        tx = make_streaming_tx_step(c, e, B, fused=fused, device=dev)
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
    # bf16-product forms: (name, batch) -> [elements past BF16_TOL,
    # elements]; name -> the largest max and mean err / scale of a tensor
    flips, bf16_read = {}, {}

    def held(name, batch, what, got, want):
        torch.cuda.synchronize()
        if name.endswith("_bf16"):
            lim = BF16_MAX["fused_rx_frame_step" if "rx_frame" in name else ""]
            f = flips.setdefault((name, batch), [0, 0])
            r = bf16_read.setdefault(name, [0.0, 0.0])
            for i, (n_over, n, mx, mean) in enumerate(bf16_errs(got, want)):
                f[0] += n_over
                f[1] += n
                r[0], r[1] = max(r[0], mx), max(r[1], mean)
                if not (mx < lim and mean < BF16_MEAN):
                    raise AssertionError(
                        f"{name} B={batch} {what}[{i}]: max abs err {mx:.3g} "
                        f"and mean {mean:.3g} of the scale, limits {lim} and "
                        f"{BF16_MEAN}")
        else:
            check_close(f"{name} B={batch} {what}", got, want, TOL)
        if batch == B:
            errs[name] = max(errs[name], max_err(got, want))

    def kernel_form(name, rng, latent=None):
        """(kernel call, plain call, zero state, input draw) of the encoder
        or a decoder form (and, once sig3 is made, of a frame form),
        each call taking its weights; the draw takes the batch, the z-steps
        and the call's number; a decoder's latents are `latent` wide (the
        flagship's by default)."""
        cd = bf if name.endswith("_bf16") else torch.float32
        if name.startswith("fused_encoder_step"):
            return (lambda w, x, s: fc.fused_encoder_step(w, x, s, cfg.bottleneck, cd),
                    lambda w, x, s: fc.encoder_step_plain(w, x, s, cfg.bottleneck, cd),
                    lambda b: fc.encoder_state_zero(b, dev),
                    lambda b, n, k=0: torch.as_tensor((0.3 * rng.standard_normal(
                        (b, 4 * n, cfg.feature_dim))).astype(np.float32), device=dev))
        if name.startswith("fused_rx_frame_step"):
            return (lambda w, x, s: fc.fused_rx_frame_step(w, x, s, cd),
                    lambda w, x, s: fc.rx_frame_step_plain(w, x, s, cd),
                    lambda b: fc.decoder_state_zero(b, dev),
                    lambda b, n, k=0: sig3[:b, k * Nmf:k * Nmf + win] + torch.as_tensor(
                        (RX_NOISE * rng.standard_normal((b, win, 2))).astype(
                            np.float32), device=dev))
        merged = "pad" if "_pad" in name else "merged" in name
        plain = (fc.decoder_merged_step_plain if merged
                 else fc.decoder_step_plain)
        return (lambda w, x, s: fc.fused_decoder_step(w, x, s, cd),
                lambda w, x, s: plain(w, x, s, cd),
                lambda b: fc.decoder_state_zero(b, dev, merged=merged),
                lambda b, n, k=0: torch.as_tensor(np.tanh(rng.standard_normal(
                    (b, n, latent or cfg.latent_dim))).astype(np.float32),
                    device=dev))

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
        # the new forms against their plain versions (own seed): the frame
        # form one frame a call, the others one and two frames
        nrng = np.random.default_rng(6)
        for name, (w, _) in new_w.items():
            kern, plain, zero_state, draw = kernel_form(name, nrng)
            runs_ = ((B, nz), (RAGGED_B, nz)) + (
                () if "frame" in name else ((RAGGED_B, 2 * nz),))
            for batch, steps in runs_:
                sk = sp = zero_state(batch)
                for frame in range(3):
                    x = draw(batch, steps, frame)
                    ok_, sk = kern(w, x, sk)
                    op, sp = plain(w, x, sp)
                    held(name, batch, f"nz={steps} call {frame}",
                         (ok_,) + sk, (op,) + sp)
        # the frame kernel's tensor-core instance at latent 40 too (dense_1's
        # K = 40 ends inside a 16-wide K step), on f32 and bf16 weights
        frame40 = {"fused_rx_frame_step_bf16": rw40,
                   "fused_rx_frame_step_bf16w_bf16": fc.fused_rx_weights(
                       tree40["decoder"], cfg40, dev, dtype=bf)}
        for name, w in frame40.items():
            kern, plain, zero_state, _ = kernel_form(name, nrng)
            for batch in (B, RAGGED_B):
                sk = sp = zero_state(batch)
                for frame in range(3):
                    x = sig40[:batch, frame * Nmf:frame * Nmf + win] + torch.as_tensor(
                        (RX_NOISE * nrng.standard_normal((batch, win, 2))).astype(
                            np.float32), device=dev)
                    ok_, sk = kern(w, x, sk)
                    op, sp = plain(w, x, sp)
                    held(name, f"{batch} latent 40", f"call {frame}",
                         (ok_,) + sk, (op,) + sp)
        # the unmerged decoder's and the encoder's tensor-core instances at
        # latent 40 (own seed), the split ones on f32 weights too, and the
        # merged decoder's split instance in both layouts: dense_1's K = 40
        # ends inside a 16-wide K step, the encoder's z_dense has 40 columns
        # (48 packed)
        lrng = np.random.default_rng(7)
        l40 = {"fused_decoder_step_bf16": fc.decoder_weights(
                   tree40["decoder"], dev),
               "fused_encoder_step_bf16": fc.encoder_weights(
                   tree40["encoder"], dev),
               "fused_decoder_step_bf16w_bf16": fc.decoder_weights(
                   tree40["decoder"], dev, dtype=bf),
               "fused_decoder_step_int8_bf16": fc.decoder_weights(
                   tree40["decoder"], dev, quant="int8"),
               "fused_encoder_step_bf16w_bf16": fc.encoder_weights(
                   tree40["encoder"], dev, dtype=bf),
               "fused_encoder_step_int8_bf16": fc.encoder_weights(
                   tree40["encoder"], dev, quant="int8"),
               "fused_decoder_merged_step_bf16": fc.decoder_weights(
                   tree40["decoder"], dev, merged=True),
               "fused_decoder_merged_step_pad_bf16": fc.decoder_weights(
                   tree40["decoder"], dev, merged="pad")}
        for name, w in l40.items():
            kern, plain, zero_state, draw = kernel_form(name, lrng, cfg40.latent_dim)
            for batch in (B, RAGGED_B):
                sk = sp = zero_state(batch)
                for frame in range(3):
                    x = draw(batch, nz, frame)
                    ok_, sk = kern(w, x, sk)
                    op, sp = plain(w, x, sp)
                    held(name, f"{batch} latent 40", f"call {frame}",
                         (ok_,) + sk, (op,) + sp)
        # the int8 forms with f32 products (x split on the tensor cores) at
        # TOL, on draws of their own generator (seed 8, in this order): on
        # the MIXED sets (the matrices kept in f32 take six products: the
        # merged decoder's wgg, the unmerged decoder's whh and 84-column
        # out_w, the encoder's whh and d1_w, whose K = 84 ends inside a K
        # step) and at latent 40 (the decoders' dense_1 K = 40 ends inside a
        # K step, the encoder's z_dense has 40 columns) on full int8 and
        # MIXED sets; the encoder's (XS_F64) within TOL of its plain version
        # in f64 on every call.  The first call of its latent-40 MIXED set
        # at B=2048 holds a row whose dense_1 sums cancel, where the f32
        # plain version is 3.2 TOL from the f64 one (PERF.md)
        def xs_weights(name, tr, excl):
            if name.startswith("fused_encoder_step"):
                return fc.encoder_weights(tr["encoder"], dev, quant="int8",
                                          quant_exclude=excl)
            merged = ("pad" if "_pad" in name else "merged" in name)
            return fc.decoder_weights(tr["decoder"], dev, merged=merged,
                                      quant="int8", quant_exclude=excl)

        xrng = np.random.default_rng(8)
        xs_sets = [(name, latent, excl, xs_weights(name, tr, excl))
                   for name in sorted(XS_FORMS, key=lambda n: "merged" not in n)
                   if name != PAD_F32
                   for latent, tr in ((cfg.latent_dim, tree), (cfg40.latent_dim, tree40))
                   for excl in ((), MIXED[name.replace("_pad", "")])
                   if excl or latent != cfg.latent_dim]
        xs_err, xs_f64, xs_calls, past_f64 = {}, {}, {}, []
        for name, latent, excl, w in xs_sets:
            kern, plain, zero_state, draw = kernel_form(name, xrng, latent)
            tag = f"latent {latent}" + (f" {excl} in f32" if excl else "")
            for batch in (B, RAGGED_B):
                sk = sp = s64 = zero_state(batch)
                for frame in range(3):
                    x = draw(batch, nz, frame)
                    ok_, sk = kern(w, x, sk)
                    op, sp = plain(w, x, sp)
                    got, want = (ok_,) + sk, (op,) + sp
                    xs_err[name, tag] = max(xs_err.get((name, tag), 0.0),
                                            max_err(got, want))
                    if name not in XS_F64:
                        held(name, f"{batch} {tag}", f"call {frame}", got, want)
                        continue
                    o64, s64 = plain_f64(plain, w, x, s64)
                    exact = (o64,) + s64
                    torch.cuda.synchronize()
                    r_k, r_p = tol_ratio(got, exact), tol_ratio(want, exact)
                    if not r_k <= 1.0:
                        past_f64.append(
                            f"{name} B={batch} {tag} call {frame}: {r_k:.3f} "
                            f"of TOL from the plain step in f64 (the f32 plain "
                            f"step {r_p:.3f}, {max_err(got, want):.3g} from it)")
                    k0, p0 = xs_f64.get((name, tag), (0.0, 0.0))
                    xs_f64[name, tag] = (max(k0, r_k), max(p0, r_p))
                    xs_calls.setdefault((name, tag), []).append(
                        f"B={batch} call {frame} {r_k:.3f} "
                        f"({max_err(got, want):.3g})")
        if past_f64:
            raise AssertionError("; ".join(past_f64))
        # the padded f32 form on x's parts (every matrix six products) at
        # latent 40 as well as at 80 (B=2048 and 37), held at TOL against its
        # plain version, and its distance from the plain version in f64 (own
        # seed 10)
        prng = np.random.default_rng(10)
        pad_sets = [(c.latent_dim, fc.decoder_weights(tr["decoder"], dev,
                                                      merged="pad"))
                    for c, tr in ((cfg, tree), (cfg40, tree40))]
        pad_f64 = {}
        for latent, w in pad_sets:
            kern, plain, zero_state, draw = kernel_form(PAD_F32, prng, latent)
            for batch in (B, RAGGED_B):
                sk = sp = s64 = zero_state(batch)
                for frame in range(3):
                    x = draw(batch, nz, frame)
                    ok_, sk = kern(w, x, sk)
                    op, sp = plain(w, x, sp)
                    got, want = (ok_,) + sk, (op,) + sp
                    held(PAD_F32, f"{batch} latent {latent}", f"call {frame}",
                         got, want)
                    o64, s64 = plain_f64(plain, w, x, s64)
                    exact = (o64,) + s64
                    k0, p0 = pad_f64.get(latent, (0.0, 0.0))
                    pad_f64[latent] = (max(k0, tol_ratio(got, exact)),
                                       max(p0, tol_ratio(want, exact)))
        for (name, batch), (n_over, n) in flips.items():
            if n_over > BF16_FLIPS * n:
                raise AssertionError(f"{name} B={batch}: {n_over} of {n} "
                                     f"elements past {BF16_TOL}")
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
        # launches the C entries refuse, writing nothing (outputs and state
        # stay NaN): int8 ones through the f32 entries (no FMA int8 instance
        # is left) and, with f32 products (bf16 flag 0), through the mma
        # entries and the merged decoder's x entry without the packed
        # matrices; a padded f32 one through the x entry without them (no
        # FMA padded instance is left)
        clib = _kernels.library("fused_core")
        n_before = dict(fc.LAUNCHES)

        def refuse(what, entry, w, x, out_shape, state, args, rule):
            out = torch.full(out_shape, float("nan"), device=dev)
            new = [torch.full(tuple(t.shape), float("nan"), device=dev)
                   for t in state]
            status = fc._launch(getattr(clib, entry), w, x, out, state, new,
                                args, fc._kinds(w, fc._rounds(w, torch.float32, rule)))
            torch.cuda.synchronize()
            if status == 0 or not all(bool(torch.isnan(t).all())
                                      for t in [out] + new):
                raise AssertionError(f"{what}: {entry} took the launch "
                                     f"(status {status})")
            return f"{what} through {entry} (cudaError_t {status})"

        zq = torch.zeros((RAGGED_B, nz, cfg.latent_dim), device=dev)
        fq = torch.zeros((RAGGED_B, 4 * nz, cfg.feature_dim), device=dev)
        dq = (RAGGED_B, nz, dwq.arrays[-1].shape[0])
        eq = (RAGGED_B, nz, cfg.latent_dim)
        da, ea = (RAGGED_B, nz, cfg.latent_dim, dq[-1]), (
            RAGGED_B, nz, 4 * cfg.feature_dim, cfg.latent_dim, cfg.bottleneck)
        zs, zms = (fc.decoder_state_zero(RAGGED_B, dev),
                   fc.decoder_state_zero(RAGGED_B, dev, merged=True))
        es0 = fc.encoder_state_zero(RAGGED_B, dev)
        refused_q = [
            refuse("unmerged int8", "radae_fused_decoder_step", dwq, zq, dq,
                   zs, da, "gru"),
            refuse("unmerged int8", "radae_fused_decoder_mma_step", dwq, zq,
                   dq, zs, da + (0, None, None), "gru"),
            refuse("merged int8", "radae_fused_decoder_merged_step", dwmq, zq,
                   dq, zms, da, "none"),
            refuse("merged int8", "radae_fused_decoder_merged_x_step", dwmq,
                   zq, dq, zms, da + (0, 0, None, None), "none"),
            refuse("encoder int8", "radae_fused_encoder_step", ewq, fq, eq,
                   es0, ea, "gru"),
            refuse("encoder int8", "radae_fused_encoder_mma_step", ewq, fq,
                   eq, es0, ea + (0, None, None), "gru"),
            refuse("padded f32", "radae_fused_decoder_merged_x_step", dwp,
                   zq, dq, zms, da + (1, 0, None, None), "none")]
        if dict(fc.LAUNCHES) != n_before:
            raise AssertionError("a refused launch was counted")
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
            for name, (w, _) in new_w.items():
                kern, _, zero_state, draw = kernel_form(name, qbrng)
                x, st = draw(batch, nz), rand_state(qbrng, zero_state(batch))
                same_bits(name, batch, lambda: kern(w, x, st))
            for name, w in frame40.items():
                kern, _, zero_state, _ = kernel_form(name, qbrng)
                x = sig40[:batch, :win] + torch.as_tensor((RX_NOISE * qbrng.standard_normal(
                    (batch, win, 2))).astype(np.float32), device=dev)
                st = rand_state(qbrng, zero_state(batch))
                same_bits(f"{name} latent 40", batch, lambda: kern(w, x, st))
            for name, w in l40.items():
                kern, _, zero_state, draw = kernel_form(name, lrng, cfg40.latent_dim)
                x, st = draw(batch, nz), rand_state(lrng, zero_state(batch))
                same_bits(f"{name} latent 40", batch, lambda: kern(w, x, st))
            for name, latent, excl, w in xs_sets:
                kern, _, zero_state, draw = kernel_form(name, xrng, latent)
                x, st = draw(batch, nz), rand_state(xrng, zero_state(batch))
                same_bits(f"{name} latent {latent} {excl}", batch,
                          lambda: kern(w, x, st))
            for latent, w in pad_sets:
                kern, _, zero_state, draw = kernel_form(PAD_F32, prng, latent)
                x, st = draw(batch, nz), rand_state(prng, zero_state(batch))
                same_bits(f"{PAD_F32} latent {latent}", batch,
                          lambda: kern(w, x, st))
    print("kernels vs plain (rtol 1e-4, atol 1e-4; the bf16-product forms "
          f"{BF16_TOL} but for at most {BF16_FLIPS} of a run's elements, "
          f"max and mean err within {BF16_MAX} and {BF16_MEAN} of the scale),"
          " max abs err at B=2048: "
          + ", ".join(f"{k} {errs[k]:.3g}" for k in FORMS)
          + f"; frame kernel at latent 40, B={B} and B={RAGGED_B}: {err40:.3g}"
          + f"; at latent 40 also {sorted(frame40) + sorted(l40)}")
    for name, r in bf16_read.items():
        print(f"  {name}: past {BF16_TOL} " + ", ".join(
            f"B={b} {n_over} of {n} ({n_over / n:.3g})"
            for (f, b), (n_over, n) in flips.items() if f == name)
            + f"; largest max err {r[0]:.3g} and mean {r[1]:.3g} of the scale")
    print("int8 forms with f32 products on the tensor cores (x split in "
          f"{XSPLIT_PARTS} parts), max abs err against the plain version at "
          f"B={B} and B={RAGGED_B} (within {TOL} but {XS_F64}; for those, the "
          "largest |err| / (atol + rtol |want|) against the plain version in "
          "f64, and the f32 plain version's, in brackets, then each call's, "
          "with its max abs err against the f32 plain version): " + ", ".join(
              f"{n} {t} {e:.3g}" + (f" (f64: {xs_f64[n, t][0]:.3f}, the f32 "
                                   f"plain version {xs_f64[n, t][1]:.3f}; "
                                   + ", ".join(xs_calls[n, t]) + ")"
                                   if (n, t) in xs_f64 else "")
              for (n, t), e in xs_err.items()))
    print(f"{PAD_F32} on x's parts ({XW_PRODUCTS} products a matrix), within "
          f"{TOL} of the plain version at B={B} and B={RAGGED_B}; the largest "
          "|err| / (atol + rtol |want|) against the plain version in f64 (the "
          "f32 plain version's in brackets): " + ", ".join(
              f"latent {lat} {k:.4f} ({p:.4f})" for lat, (k, p) in pad_f64.items()))
    print(f"refused without a launch: {refused}")
    print("launches refused, nothing written: " + "; ".join(refused_q))
    print(f"all {len(FORMS)} kernel forms: two launches bit-identical at B={B} "
          f"and B={RAGGED_B} (the frame kernel's bf16 forms, the unmerged "
          "decoder's and the encoder's tensor-core forms and the merged "
          "decoder's split forms also at latent 40, the int8 forms with f32 "
          "products also on the MIXED sets and at latent 40)")

    # -- the serving path on the fixture: the rx paths ----------------------
    # path -> (step, weights, zero state, the forms it launches, encoder
    # weights).  Every path decodes the f32 tx signal that the composite path
    # makes (its tx step runs the encoder kernel), but those of the encoder's
    # bf16-product forms: each makes its signal with the tx step around that
    # instance (on the encoder weights) and decodes it with the composite
    # step.  The f32 paths are held to the plain layers and to radae_tpu's
    # losses, the int8 and bf16 ones to the f32 loss.
    zero, zero_m = (lambda: fc.decoder_state_zero(B, dev)), (
        lambda: fc.decoder_state_zero(B, dev, merged=True))
    composite = make_streaming_rx_step(cfg, dec, B, fused=True, device=dev)
    rx_steps = {
        "composite": (composite, dw, zero, ("fused_decoder_step", DEMOD),
                      None),
        "merged": (make_streaming_rx_step(cfg, dec, B, fused=True,
                                          fused_merged=True, device=dev),
                   dwm, zero_m, ("fused_decoder_merged_step", DEMOD), None),
        "frame": (fc.make_fused_rx_frame_step(cfg, B, dev), rw, zero,
                  ("fused_rx_frame_step",), None)}
    for name, (w, _) in new_w.items():      # a path for each new form
        merged = "pad" if "_pad" in name else "merged" in name
        cd = bf if name.endswith("_bf16") else None
        if name.startswith("fused_encoder_step"):
            rx_steps[name] = (composite, dw, zero,
                              (name, "fused_decoder_step", DEMOD), w)
        elif name.startswith("fused_rx_frame_step"):
            rx_steps[name] = (fc.make_fused_rx_frame_step(
                cfg, B, dev, compute_dtype=cd), w, zero, (name,), None)
        else:
            rx_steps[name] = (make_streaming_rx_step(
                cfg, dec, B, fused=True, fused_merged=merged,
                fused_quant="int8" if "_int8" in name else None,
                fused_dtype=cd, device=dev), w, zero_m if merged else zero,
                (name, DEMOD), None)
    f32_paths = [p for p, v in rx_steps.items()
                 if not any(k in v[3][0] for k in ("_int8", "_bf16"))]
    launches, outs = {}, {}
    with torch.no_grad():
        for path, (step, w, state0, names, enc_w) in rx_steps.items():
            fc.reset_launches()
            if path == "composite":          # the tx step runs on this path
                sig = tx_signal(True)
                names = names + ("fused_encoder_step",)
            outs[path] = rx_run(step, w, state0(), sig if enc_w is None else
                                tx_signal(False, bf16_weights=enc_w))
            torch.cuda.synchronize()
            counts = dict(fc.LAUNCHES)
            bad = {n: counts[n] for n in names if counts[n] != N_FRAMES}
            if bad or sum(counts.values()) != len(names) * N_FRAMES:
                raise AssertionError(f"{path} path: kernels launched "
                                     f"{ {n: c for n, c in counts.items() if c} }, "
                                     f"not {N_FRAMES} of each of {names}")
            for n in names:
                launches[n] = counts[n] + (launches.get(n, 0) if n == DEMOD
                                           else 0)
        f_plain = rx_run(make_streaming_rx_step(cfg, dec, B, device=dev),
                         params["decoder"], None, tx_signal(False))
        torch.cuda.synchronize()
    mean_f32 = None
    for path, f_out in outs.items():
        if tuple(f_out.shape) != (B, T, cfg.feature_dim) or not bool(
                torch.isfinite(f_out).all()):
            raise AssertionError(f"{path} path: bad features, shape "
                                 f"{tuple(f_out.shape)}")
        loss = distortion_loss(feats, f_out)
        mean_loss = float(loss.mean())
        if not mean_loss < LOSS_LIMIT:
            raise AssertionError(f"{path} path: mean distortion loss "
                                 f"{mean_loss:.4f} >= {LOSS_LIMIT}")
        if path not in f32_paths:            # int8 or bf16: the f32 loss
            if abs(mean_loss - mean_f32) > 0.01:
                raise AssertionError(f"{path} path: mean loss {mean_loss:.4f} "
                                     f"against the f32 kernels' {mean_f32:.4f}")
            print(f"serving path B={B} x {N_FRAMES} frames, rx {path}: mean "
                  f"loss {mean_loss:.4f} (f32 kernels {mean_f32:.4f})")
            continue
        mean_f32 = mean_f32 if mean_f32 is not None else mean_loss
        e2e_err = float((f_out - f_plain).abs().max())
        if e2e_err > E2E_TOL:
            raise AssertionError(f"{path} path vs plain: max abs err "
                                 f"{e2e_err:.3g} > {E2E_TOL}")
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
                "fused_decoder_step_int8": N_FRAMES, DEMOD: N_FRAMES}
        counts = dict(fc.LAUNCHES)
        if any(counts[n] != c for n, c in want.items()):
            raise AssertionError(f"batch pair: kernels launched {counts}, "
                                 f"not {want}")
        launches.update({n: counts[n] for n in want if n != DEMOD})
        launches[DEMOD] += counts[DEMOD]
        fc.reset_launches()
        pair["int8 merged"] = receiver(dwmq, fused_quant="int8",
                                       fused_merged=True)(dwmq, buf)
        torch.cuda.synchronize()
        n_m = fc.LAUNCHES["fused_decoder_merged_step_int8"]
        if n_m != N_FRAMES or fc.LAUNCHES[DEMOD] != N_FRAMES:
            raise AssertionError(f"batch pair, merged int8: kernels launched "
                                 f"{dict(fc.LAUNCHES)}")
        launches["fused_decoder_merged_step_int8"] = n_m
        launches[DEMOD] += fc.LAUNCHES[DEMOD]
        # int8 weights with bf16 products (bench.py's int8bf16)
        fc.reset_launches()
        pair["int8 bf16"] = receiver(dwq, fused_quant="int8",
                                     fused_dtype=bf)(dwq, buf)
        torch.cuda.synchronize()
        n_b = fc.LAUNCHES["fused_decoder_step_int8_bf16"]
        if n_b != N_FRAMES or fc.LAUNCHES[DEMOD] != N_FRAMES or sum(
                fc.LAUNCHES.values()) != 2 * N_FRAMES:
            raise AssertionError(f"batch pair, int8 bf16: kernels launched "
                                 f"{ {n: c for n, c in fc.LAUNCHES.items() if c} }")
        launches["fused_decoder_step_int8_bf16"] = n_b
        launches[DEMOD] += fc.LAUNCHES[DEMOD]
        fc.reset_launches()
        pair["f32"] = receiver(dw)(dw, buf)
        torch.cuda.synchronize()
        if fc.LAUNCHES[DEMOD] != N_FRAMES:
            raise AssertionError(f"batch pair, f32: kernels launched "
                                 f"{ {n: c for n, c in fc.LAUNCHES.items() if c} }")
        launches[DEMOD] += fc.LAUNCHES[DEMOD]
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
    mean_qb = losses["int8 bf16"].mean()
    if not (mean_q < LOSS_LIMIT and abs(mean_q - mean_f) < 0.01
            and mean_qb < LOSS_LIMIT and abs(mean_qb - mean_f) < 0.01):
        raise AssertionError(f"batch pair: mean loss {mean_q:.4f}, int8 bf16 "
                             f"{mean_qb:.4f} (limit {LOSS_LIMIT}), f32-kernel "
                             f"receiver {mean_f:.4f}")
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
          f"{merged_err:.3g}), int8 with bf16 products {mean_qb:.4f} "
          f"(windows {sorted(set(pair['int8 bf16']['win'].tolist()))}); "
          f"streams 0-3 {got}, max diff against radae_tpu {diffs}")

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

    # -- the per-frame product path: txe and rxe --------------------------
    launches["fused_decoder_step"] += product_phase(dev, raw, card)

    # -- the file tools: inference, rx, loss, stateful --------------------
    for name, n in file_tools_phase(dev, raw, card).items():
        launches[name] += n

    # -- training: the step, the train and evaluate tools, the hand-off ---
    for name, n in train_phase(dev, raw, card).items():
        launches[name] += n

    # -- BBFM, the single-carrier modem, the speech back end --------------
    for name, n in speech_phase(dev, raw, card).items():
        launches[name] += n

    # -- the last modules: the PTT session, OTA, calibration, measurement ---
    for name, n in tools_phase(dev, raw, card).items():
        launches[name] += n
    print(f"launches on the main paths: {launches}")

    # -- the port's benchmark, as a user runs it, then its other modes ------
    t0 = time.time()
    env = dict(os.environ, BENCH_BUDGET_S=str(BENCH_BUDGET_S))
    env.pop("BENCH_PLATFORM", None)
    run = subprocess.run([sys.executable, "-m", "radae_tpu_torch.bench"],
                         cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=BENCH_BUDGET_S + 60)
    lines = [ln for ln in run.stdout.splitlines() if ln.strip()]
    for ln in run.stderr.splitlines():
        if ln.startswith(("rung ", "discarding")):
            print(f"bench {ln}")
    res = json.loads(lines[-1]) if len(lines) == 1 else {}
    rung = dict(kv.split("=") for kv in str(res.get("config", "")).split(",")
                if "=" in kv)
    if not (res.get("value", 0) > 0 and "error" not in res
            and int(rung.get("B", 0)) >= B and rung.get("fused") != "False"):
        raise AssertionError(f"radae_tpu_torch.bench: {run.stdout!r} "
                             f"{run.stderr[-2000:]!r}")
    print(f"bench ({time.time() - t0:.1f} s): {lines[0]}")
    with torch.no_grad():
        for mode in OFF_LADDER:
            t0 = time.time()
            v = bench.run_bench(B, fused=mode, scan=BENCH_SCAN)
            print(f"bench run_bench B={B}, fused={mode}, scan={BENCH_SCAN}: "
                  f"{v:.1f} audio-s/s ({time.time() - t0:.1f} s)")

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
        for path, (step, w, state0, _, enc_w) in rx_steps.items():
            if enc_w is not None:            # the composite step again
                continue
            st = state0()
            ms = time_ms(lambda: step(w, rx_win, st), 20)
            print(f"rx step {path} B={B}: {ms:.4f} ms/frame, "
                  f"{B * frame_s / (ms / 1e3):.0f} audio-s/s")

        z = torch.as_tensor(np.tanh(gen.standard_normal(
            (B, nz, cfg.latent_dim))).astype(np.float32), device=dev)
        f = feats[:, :4 * nz].contiguous()
        ds, dsm = fc.decoder_state_zero(B, dev), fc.decoder_state_zero(
            B, dev, merged=True)

        def demod(name):
            """The frame front end's (f32, bf16) flop at B streams: the bf16
            frame forms round both operands of the DFT."""
            dft, rest = (B * n for n in demod_flops(cfg))
            return (rest, dft) if name.endswith("_bf16") else (dft + rest, 0.0)

        none = (0.0, 0.0)
        runs = {   # kernel -> (kernel call, plain call, bound args)
            "fused_decoder_step": (
                lambda: fc.fused_decoder_step(dw, z, ds),
                lambda: fc.decoder_step_plain(dw, z, ds), (dw, z, ds, none)),
            "fused_decoder_merged_step": (
                lambda: fc.fused_decoder_step(dwm, z, dsm),
                lambda: fc.decoder_merged_step_plain(dwm, z, dsm),
                (dwm, z, dsm, none)),
            "fused_rx_frame_step": (
                lambda: fc.fused_rx_frame_step(rw, rx_win, ds),
                lambda: fc.rx_frame_step_plain(rw, rx_win, ds),
                (rw.decoder, rx_win, ds, demod("fused_rx_frame_step"))),
            "fused_encoder_step": (
                lambda: fc.fused_encoder_step(ew, f, es),
                lambda: fc.encoder_step_plain(ew, f, es), (ew, f, es, none)),
            "fused_decoder_step_int8": (
                lambda: fc.fused_decoder_step(dwq, z, ds),
                lambda: fc.decoder_step_plain(dwq, z, ds), (dwq, z, ds, none)),
            "fused_decoder_merged_step_int8": (
                lambda: fc.fused_decoder_step(dwmq, z, dsm),
                lambda: fc.decoder_merged_step_plain(dwmq, z, dsm),
                (dwmq, z, dsm, none)),
            "fused_encoder_step_int8": (
                lambda: fc.fused_encoder_step(ewq, f, es),
                lambda: fc.encoder_step_plain(ewq, f, es), (ewq, f, es, none)),
        }
        lib = _kernels.library("fused_core")
        enc_rows = (lib.radae_enc_tile_rows(),) * 2
        dec_rows = (lib.radae_dec_tile_rows(),) * 2
        # name -> mma_terms of the forms whose launches ran on the tensor
        # cores: a bf16 form, or one of XS_FORMS, whose weight set keeps a
        # packed copy with a matrix in it (fc._mma_args made it at the
        # form's first launch)
        mma_of, kept_of = {}, {}
        for name, (w, bw) in new_w.items():   # the new forms, same inputs
            kern, plain, zero_state, _ = kernel_form(name, gen)
            x = (rx_win if "frame" in name else
                 f if "encoder" in name else z)
            st = (es if "encoder" in name else
                  dsm if "merged" in name else ds)
            runs[name] = ((lambda k=kern, w=w, x=x, st=st: k(w, x, st)),
                          (lambda p=plain, w=w, x=x, st=st: p(w, x, st)),
                          (bw, x, st, demod(name) if "frame" in name
                           else none))
        # the new forms and the int8 ones (on dwq, dwmq, ewq)
        for name, ws, bw in [(n, w.w if "frame" in n else w, bw)
                             for n, (w, bw) in new_w.items()] + [
                                 (n, w, w) for n, w in (
                                     ("fused_decoder_step_int8", dwq),
                                     ("fused_encoder_step_int8", ewq),
                                     ("fused_decoder_merged_step_int8", dwmq))]:
            kept = (list(ws.mma.values()) if name.endswith("_bf16")
                    or name in XS_FORMS else [])
            if kept and any(o >= 0 for o in kept[0].offsets):
                mma_of[name] = mma_terms(ws if "frame" in name else bw,
                                         kept[0], nz, B, lib.radae_block_rows())
                if "frame" not in name:       # bw's arrays are kept[0]'s
                    kept_of[name] = kept[0]
        if set(mma_of) != set(MMA_FORMS):
            raise AssertionError(
                f"forms on the tensor cores: {sorted(mma_of)}; MMA_FORMS: "
                f"{sorted(MMA_FORMS)}")
        kernels = []
        for name, (kern, plain, (w, x, st, extra)) in runs.items():
            ms = time_ms(kern, 50)
            plain_ms = time_ms(plain, 10)
            out, st1 = plain()
            swap, packed_b, read = mma_of.get(name, ((0, 0), 0, 0))
            mask = bf16_mask(name, w, kept_of.get(name))
            b_ms, b_by = bound(w, (x,) + st, (out,) + st1, nz, B, mask,
                               extra, swap)
            print(f"{name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, "
                  f"bound {b_ms:.4f} ms by {b_by}; CUDA graph replay "
                  f"min/median/max {spread(graph_runs(kern, reps=GRAPH_REPS))} "
                  f"ms over {GRAPH_REPS} replays); products "
                  f"on {'the tensor cores (mma.sync)' if name in mma_of else 'FMA loops'}"
                  + (f" (f32 x int8: x split, {XSPLIT_PARTS} bf16 products)"
                     if name in XS_FORMS and name != PAD_F32 else
                     f" (f32 x f32: x and w split, {XW_PRODUCTS} bf16 products)"
                     if name == PAD_F32 else
                     f" (f32 matrices split, {SPLIT_PARTS} bf16 products)"
                     if SPLIT_PARTS in (mask or ()) else "")
                  + (f", packed weights {packed_b} B (the bound counts "
                     f"{swap[0]} B for them), {read / 1e9:.4f} GB a launch "
                     f"({read / (ms * 1e-3) / 1e12:.2f} TB/s)"
                     if name in mma_of else ""))
            if name.startswith("fused_encoder_step") and name not in mma_of:
                print(f"  encoder, {enc_rows[0]}-row tiles: " + fetch_line(
                    w, enc_rows, lib.radae_block_rows(), nz, B, ms))
            if name.startswith("fused_decoder_step") and name not in mma_of:
                print(f"  decoder, {dec_rows[0]}-row tiles: " + fetch_line(
                    w, dec_rows, lib.radae_block_rows(), nz, B, ms))
            if name.startswith("fused_decoder_merged_step") and name not in mma_of:
                print(f"  merged decoder, {dec_rows[0]}-row tiles: " + fetch_line(
                    w, dec_rows, lib.radae_block_rows(), nz, B, ms))
            if name == "fused_rx_frame_step":     # the latent-40 modem
                rx40 = sig40[:, :win].contiguous()
                k40 = lambda: fc.fused_rx_frame_step(rw40, rx40, ds)
                ms40 = time_ms(k40, 50)
                out40, st40 = fc.rx_frame_step_plain(rw40, rx40, ds)
                b40, by40 = bound(rw40.decoder, (rx40,) + ds, (out40,) + st40,
                                  nz, B, extra=(B * sum(demod_flops(cfg40)),
                                                0.0))
                print(f"  latent 40 (Nc=15): {ms40:.4f} ms (bound {b40:.4f} ms "
                      f"by {by40}; {graph_ms(k40):.4f} ms in a CUDA graph "
                      f"replay)")
            if name in ("fused_rx_frame_step_bf16", "fused_rx_frame_step_bf16w_bf16"):
                k40 = (lambda k=kernel_form(name, gen)[0], w=frame40[name],
                        rx=sig40[:, :win].contiguous(): k(w, rx, ds))
                print(f"  latent 40 (Nc=15): {time_ms(k40, 50):.4f} ms "
                      f"({graph_ms(k40):.4f} ms in a CUDA graph replay)")
            kernels.append({
                "name": name, "route": "cuda", "source": SRC,
                "replaces": BODIES[next(b for b in BODIES
                                        if name.startswith(b))],
                "launches": launches[name],
                "max_abs_err": errs[name], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                "products": "mma" if name in mma_of else "fma"})


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
