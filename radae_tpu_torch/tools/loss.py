"""Feature-domain loss between two feature files, with min-loss time
alignment (the acquisition time) and PASS/FAIL gates (port of
`radae_tpu/tools/loss.py`; reference: loss.py:58-133).

The shorter decoded file is aligned against the original by scanning its
start offset for the minimum loss; offset * 10 ms is the acquisition time.
All offsets are scored in one batched `distortion_loss` on the device.

    python -m radae_tpu_torch loss features.f32 features_hat.f32 \
        [--loss_test L] [--acq_time_test S] [--clip_start N] [--clip_end N] \
        [--features_hat2 f2.f32 --compare] [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32
from ..models.core import distortion_loss
from ..runtime import f32_device


def load_features(fn):
    """(1, T, 20) f32 numpy: the used columns of a 36-column feature file."""
    return read_f32(fn, NB_TOTAL_FEATURES)[None, :, :NUM_USED_FEATURES]


def find_loss(features_fn, features_hat_fn, clip_start=0, clip_end=0,
              device="cuda"):
    """Align features_hat against features and print the loss.  Returns
    (min loss, start offset in 10 ms frames, per-frame losses at it)."""
    dev = f32_device(device)
    features = torch.as_tensor(load_features(features_fn), device=dev)
    features_hat = torch.as_tensor(load_features(features_hat_fn), device=dev)
    features_hat = features_hat[:, clip_start:features_hat.shape[1] - clip_end]
    Tf, Th = features.shape[1], features_hat.shape[1]
    if not (Th and Tf):
        raise ValueError(f"empty feature file: {Tf} and {Th} frames after "
                         "clipping")
    # decoded stream longer than the original (e.g. trailing noise decoded
    # after the signal ends): compare over the original's length
    if Th > Tf:
        features_hat = features_hat[:, :Tf]
        Th = Tf

    # every start offset at once: windows (n_off, Th, F) as a strided view
    windows = features[0].unfold(0, Th, 1).permute(0, 2, 1)
    losses = distortion_loss(windows, features_hat.expand_as(windows))
    min_start = int(torch.argmin(losses))
    min_loss = float(losses[min_start])
    print(f"Loss between {features_fn:s} and {features_hat_fn:s}")
    print(f"  loss: {min_loss:5.3f} start: {min_start:d} "
          f"acq_time: {min_start*0.01:5.2f} s")

    per_frame = distortion_loss(
        features[0, min_start:min_start + Th, None, :],
        features_hat[0, :, None, :])
    return min_loss, min_start, per_frame.cpu().numpy()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("features", type=str)
    p.add_argument("features_hat", type=str)
    p.add_argument("--features_hat2", type=str, default="")
    p.add_argument("--loss_test", type=float, default=0.0)
    p.add_argument("--acq_time_test", type=float, default=0)
    p.add_argument("--clip_start", type=int, default=0)
    p.add_argument("--clip_end", type=int, default=0)
    p.add_argument("--compare", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")
    args = p.parse_args(argv)

    min_loss, min_start, _ = find_loss(args.features, args.features_hat,
                                       args.clip_start, args.clip_end,
                                       args.device)
    if args.loss_test > 0.0 and min_loss > args.loss_test:
        print("FAIL")
        return 1
    if args.acq_time_test > 0 and min_start * 0.01 > args.acq_time_test:
        print("FAIL")
        return 1
    if args.loss_test > 0.0 or args.acq_time_test:
        print("PASS")

    if args.features_hat2:
        min_loss2, _, _ = find_loss(args.features, args.features_hat2,
                                    args.clip_start, args.clip_end,
                                    args.device)
        if args.compare:
            delta = abs(min_loss - min_loss2)
            print(f"loss1: {min_loss:5.3f} loss2: {min_loss2:5.3f} "
                  f"delta: {delta:5.3f}")
            if delta < 0.01:
                print("PASS")
    return 0


if __name__ == "__main__":
    sys.exit(main())
