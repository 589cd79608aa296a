"""Batch file receiver: decode many raw IQ streams at once (port of
`radae_tpu/tools/rx_batch.py`), the serving surface of
runtime.make_batched_receiver.

All streams are acquired (windowed retry + consecutive-match + fine refine,
the product receiver's acquisition budget, reference: rx.py:146-205),
aligned, derotated and decoded together, with per-stream end-of-over
detection.  Like radae_tpu's tool it decodes with the plain CoreDecoder;
the fused kernels reach the receiver through
make_batched_receiver(fused=True, fused_quant=...).

    python -m radae_tpu_torch.tools.rx_batch model.npz out_dir in1.f32 [...]

Inputs are rate-Fs complex IQ .f32 files (interleaved ..IQIQ..).  Per
stream the tool writes out_dir/<stem>_feat.f32 (36-col feature layout,
decoded frames only: from acquisition up to the detected EOO) and prints
one status line (acquired?, tmax, fmax, acquisition window, EOO frame,
SNR).  Streams that never acquire give no feature file.  It runs on the
card (--device cuda, the default) or, when asked, on the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import flagship_config
from ..convert import params_to_torch
from ..data.io import write_f32
from ..models.core import CoreDecoder
from ..runtime import make_batched_receiver
from .tx_batch import load_params


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("model_name", type=str)
    p.add_argument("out_dir", type=str)
    p.add_argument("rx_files", nargs="+", help="rate Fs IQ .f32 files")
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--bottleneck", type=int, default=3)
    p.add_argument("--auxdata", action="store_true", default=True)
    p.add_argument("--no-auxdata", dest="auxdata", action="store_false")
    p.add_argument("--n-windows", type=int, default=12,
                   help="acquisition retry budget (12 = the product 1.5 s)")
    p.add_argument("--n-frames", type=int, default=0,
                   help="frames to decode per stream (0 = fit the "
                        "longest input)")
    p.add_argument("--no-refine", dest="refine", action="store_false")
    p.add_argument("--no-eoo", dest="eoo", action="store_false")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    p.set_defaults(refine=True, eoo=True)
    args = p.parse_args(argv)

    num_features = 21 if args.auxdata else 20
    cfg = flagship_config(feature_dim=num_features,
                          latent_dim=args.latent_dim,
                          bottleneck=args.bottleneck)
    decoder = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    params = load_params(p, args)

    streams = [np.fromfile(f, dtype=np.complex64) for f in args.rx_files]
    B = len(streams)
    Nmf, M, Ncp = cfg.Nmf, cfg.M, cfg.Ncp
    n_frames = args.n_frames
    if n_frames <= 0:
        longest = max(len(s) for s in streams)
        n_frames = max(1, longest // Nmf - 1)
    T = max(max(len(s) for s in streams),
            (args.n_windows + 1) * Nmf + M + Ncp,
            args.n_windows * Nmf + (n_frames + 1) * Nmf + Ncp + M)
    buf = np.zeros((B, T), np.complex64)
    for b, s in enumerate(streams):
        buf[b, : len(s)] = s
    packed = np.stack([buf.real, buf.imag], -1).astype(np.float32)

    rx = make_batched_receiver(cfg, decoder, B, n_frames,
                               n_windows=args.n_windows,
                               refine=args.refine, eoo=args.eoo,
                               device=args.device)
    with torch.no_grad():
        out = rx(params_to_torch(params["decoder"], args.device), packed)
    if not isinstance(out, dict):
        # legacy 4-tuple form (--n-windows 1 --no-refine --no-eoo)
        out = {"features": out[0], "candidate": out[1],
               "tmax": out[2], "fmax": out[3],
               "win": np.zeros(B, np.int32),
               "snrdB_3k": np.full(B, np.nan, np.float32)}
    out = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
           for k, v in out.items()}
    feats = out["features"].reshape(B, -1, cfg.feature_dim)
    cand, tmax, fmax, win = (out[k] for k in ("candidate", "tmax", "fmax",
                                              "win"))
    if args.eoo:
        eoo_det, eoo_frame = out["eoo_detected"], out["eoo_frame"]

    os.makedirs(args.out_dir, exist_ok=True)
    rows_per_frame = feats.shape[1] // n_frames
    for b, f in enumerate(args.rx_files):
        stem = os.path.splitext(os.path.basename(f))[0]
        ef = int(eoo_frame[b]) if args.eoo and eoo_det[b] else -1
        snr = float(out["snrdB_3k"][b])
        print(f"{stem}: acquired {int(cand[b])} tmax {int(tmax[b]):6d} "
              f"fmax {float(fmax[b]):+7.2f} Hz win {int(win[b]):2d} "
              f"eoo_frame {ef:3d} snr3k {snr:+6.1f} dB")
        if not cand[b]:
            continue
        fh = feats[b]
        if ef >= 0:
            fh = fh[: ef * rows_per_frame]
        out36 = np.zeros((len(fh), 36), np.float32)
        out36[:, :20] = fh[:, :20]
        write_f32(os.path.join(args.out_dir, f"{stem}_feat.f32"), out36)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
