"""Batch file transmitter: encode many feature files into modem IQ streams
at once (port of `radae_tpu/tools/tx_batch.py`), the serving surface of
runtime.make_streaming_tx_step.

B independent streams go through the stateful encoder + OFDM mod + PA
model one 120 ms frame at a time, all streams in one step; with --fused
the encoder is the int8 kernel of ops/fused_core.py
(`encoder_weights(quant="int8")`), otherwise the plain CoreEncoder.

    python -m radae_tpu_torch.tools.tx_batch model.npz out_dir in1_feat.f32 [...]

Inputs are 36-col vocoder feature files; per stream the tool writes
out_dir/<stem>_iq.f32 (rate-Fs complex IQ, ..IQIQ..) cut to that stream's
own frame count, with an end-of-over marker appended (disable with
--no-eoo), and prints one line.  It runs on the card (--device cuda, the
default) or, when asked, on the CPU with the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import flagship_config
from ..convert import load_checkpoint, load_torch_checkpoint, params_to_torch
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32
from ..models.core import CoreEncoder
from ..ops import fused_core
from ..runtime import make_streaming_tx_step


def load_params(p, args):
    """The model's params tree (numpy) from an .npz or a .pth checkpoint."""
    if args.model_name in ("", "random"):
        p.error("a random model is drawn by radae_tpu's jax.random init, "
                "which the port does not have: give a checkpoint")
    if args.model_name.endswith(".pth"):
        return load_torch_checkpoint(args.model_name)
    return load_checkpoint(args.model_name)[0]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("feat_files", nargs="+", help="36-col feature .f32 files")
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--bottleneck", type=int, default=3)
    p.add_argument("--auxdata", action="store_true", default=True)
    p.add_argument("--no-auxdata", dest="auxdata", action="store_false")
    p.add_argument("--no-eoo", dest="eoo", action="store_false")
    p.add_argument("--fused", action="store_true",
                   help="the fused int8 encoder kernel (any batch)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")
    p.set_defaults(eoo=True)
    args = p.parse_args(argv)

    num_features = 21 if args.auxdata else 20
    cfg = flagship_config(feature_dim=num_features,
                          latent_dim=args.latent_dim,
                          bottleneck=args.bottleneck)
    encoder = CoreEncoder(num_features, args.latent_dim,
                          bottleneck=args.bottleneck)
    params = load_params(p, args)

    rows_per_frame = cfg.Nzmf * cfg.enc_stride          # 12 x 10 ms
    feats_in = []
    for f in args.feat_files:
        x = read_f32(f, NB_TOTAL_FEATURES)[:, :NUM_USED_FEATURES]
        n = len(x) // rows_per_frame * rows_per_frame
        feats_in.append(x[:n])
    B = len(feats_in)
    n_frames = [len(x) // rows_per_frame for x in feats_in]
    NF = max(n_frames)
    feats = np.zeros((B, NF * rows_per_frame, num_features), np.float32)
    for b, x in enumerate(feats_in):
        feats[b, : len(x), :NUM_USED_FEATURES] = x
        if args.auxdata:
            feats[b, :, NUM_USED_FEATURES] = -1.0

    quant = "int8" if args.fused else None
    step = make_streaming_tx_step(cfg, encoder, B, fused=args.fused,
                                  fused_quant=quant, device=args.device)
    dev = torch.device(args.device)
    if args.fused:
        enc_params = fused_core.encoder_weights(params["encoder"], dev,
                                                quant=quant)
        state = fused_core.encoder_state_zero(B, dev)
    else:
        enc_params = params_to_torch(params["encoder"], dev)
        state = encoder.zero_state(B, dev)

    frames = torch.as_tensor(feats, device=dev).reshape(
        B, NF, rows_per_frame, num_features)
    tx = []
    with torch.no_grad():
        for k in range(NF):
            s, state = step(enc_params, frames[:, k], state)
            tx.append(s)
    tx = torch.stack(tx, dim=1).cpu().numpy()          # (B, NF, Nmf, 2)
    eoo = (cfg.eoo.flatten().astype(np.complex64) if args.eoo
           else np.zeros(0, np.complex64))

    os.makedirs(args.out_dir, exist_ok=True)
    for b, f in enumerate(args.feat_files):
        stem = os.path.splitext(os.path.basename(f))[0]
        iq = tx[b, : n_frames[b]].reshape(-1, 2)
        s = (iq[:, 0] + 1j * iq[:, 1]).astype(np.complex64)
        s = np.concatenate([s, eoo])
        s.tofile(os.path.join(args.out_dir, f"{stem}_iq.f32"))
        print(f"{stem}: {n_frames[b]} frames -> {len(s)} samples")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
