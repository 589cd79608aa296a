"""Where the port's train step spends its time on the card.

Runs `radae_tpu_torch.parallel.trainstep.make_train_step` at the flagship's
training flags (README's train command: rate Fs, pilots, LS EQ, 4 ms CP,
bottleneck 3, Eb/No drawn over its range, auxdata, quant noise on) from the
fixture checkpoint on fixture sequences, warms it up, and traces --steps
steps with torch.profiler.  Prints per batch size: the step's wall time
(CUDA events around host-issued steps), the device's busy time (the sum of
the kernels' durations: one stream, so they do not overlap) and its idle
share, the kernels launched a step, the host's launch calls a step, and the
kernels that take the most device time.

    python tools/train_profile.py [--batch 32,512] [--T 252] [--steps 3]
        [--remat]

Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from collections import Counter

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", default="32,512")
    p.add_argument("--T", type=int, default=252)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--remat", action="store_true")
    args = p.parse_args(argv)
    import torch
    from torch.profiler import ProfilerActivity, profile
    from radae_tpu_torch.config import RADAEConfig
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.data.dataset import make_aux_symbols
    from radae_tpu_torch.data.io import NB_TOTAL_FEATURES, read_f32
    from radae_tpu_torch.models.radae import RADAE
    from radae_tpu_torch.parallel.trainstep import make_train_step

    if not torch.cuda.is_available():
        print("train_profile: no CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    cfg = RADAEConfig(feature_dim=21, latent_dim=80, EbNodB=0.0,
                      range_EbNo=True, rate_Fs=True, bottleneck=3,
                      pilots=True, pilot_eq=True, eq_mean6=False,
                      cyclic_prefix=0.004)
    model = RADAE(cfg, dev)
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           "model_fs_flagship.npz"))
    raw = read_f32(os.path.join(ROOT, "fixtures", "speech_feats.f32"),
                   NB_TOTAL_FEATURES)
    T = args.T
    n_seq = raw.shape[0] // T
    rng = np.random.default_rng(0)
    for B in (int(b) for b in args.batch.split(",")):
        f = np.stack([raw[(i % n_seq) * T:(i % n_seq + 1) * T, :20]
                      for i in range(B)])
        aux = np.stack([make_aux_symbols(T, rng) for _ in range(B)])
        feats = torch.as_tensor(np.concatenate([f, aux], 2).astype(np.float32),
                                device=dev)
        init, step = make_train_step(model, aux_ber=True, remat=args.remat)
        st = init(tree)
        for _ in range(2):
            st, _ = step(st, feats, None, None, 0)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            e0.record()
            for _ in range(args.steps):
                st, met = step(st, feats, None, None, 0)
            e1.record()
            torch.cuda.synchronize()
        wall = e0.elapsed_time(e1) / args.steps
        kern = [e for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy = sum(e.time_range.elapsed_us() for e in kern) / 1e3 / args.steps
        launches = sum(1 for e in prof.events() if e.name in (
            "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
        by_name = Counter()
        for e in kern:
            by_name[e.name] += e.time_range.elapsed_us() / 1e3 / args.steps
        print(f"train_step B={B} T={T}{' remat' if args.remat else ''}: "
              f"{wall:.2f} ms a step (CUDA events, traced), device busy "
              f"{busy:.2f} ms, idle share {1 - busy / wall:.3f}; "
              f"{len(kern) / args.steps:.0f} kernels and "
              f"{launches / args.steps:.0f} launch calls a step; loss "
              f"{float(met['loss'][0]):.4f} ({card})")
        for name, ms in by_name.most_common(8):
            print(f"  {ms:8.3f} ms a step  {name[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
