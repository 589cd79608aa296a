"""SNR x channel evaluation sweep (port of `radae_tpu/tools/evaluate.py`).

The reference's evaluate.sh / evaluate_loop.sh harness (reference:
evaluate_loop.sh:43-53 sweeps SNR over {AWGN, MPG, MPP, MPD} channel
classes by invoking inference again and again) as one batch: each row of
the (channel x Eb/No x realisation) grid is an independent channel draw,
and the whole grid goes through one forward.  Prints a loss (or, with
--ber, a BER) table per (channel, Eb/No) cell, optionally as JSON.

Over several cards (`torchrun --nproc_per_node N`) `run_sweep` runs each
rank's rows of the grid, reduces them into per-cell sums with a one-hot
product and combines the ranks with one all_reduce of sums and counts
(radae_tpu's `run_sweep_shard_map`).  Each rank draws the whole grid's
noise and keeps its rows (ops/draws.py), so a grid that splits evenly
gives one process's table.  --shard_map is accepted, so radae_tpu's
command lines run, and changes nothing: one function serves both.

--audio (per-cell listening material) needs the vocoder and
utils/quality.py, which the port does not have yet: it is refused.

    python -m radae_tpu_torch evaluate model.npz features.f32 \\
        [--channels awgn,mpp] [--EbNodB 0,3,6,10] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from ..channel.doppler import multipath_samples
from ..config import RADAEConfig
from ..convert import load_checkpoint
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32
from ..models.core import distortion_loss
from ..models.radae import RADAE
from ..ops import cplx
from ..ops.draws import BatchRows
from ..parallel.distributed import join_from_env
from ..parallel.mesh import rank_rows
from ..parallel.trainstep import step_generator
from .tx_batch import load_params

CHANNELS = ["awgn", "mpg", "mpp", "mpd"]


def build_grid_batch(cfg, feats_seq, channels, EbNodB_list, reps, rng):
    """One batch row per (channel, EbNo, rep): features replicated, H/G per
    row an independent realisation."""
    B = len(channels) * len(EbNodB_list) * reps
    T = feats_seq.shape[0]
    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    n_fs = cfg.num_timesteps_at_rate_Fs(n_rs)

    feats = np.broadcast_to(feats_seq[None], (B, T, feats_seq.shape[1])).copy()
    H = np.ones((B, n_rs, cfg.Nc), np.float32)
    G = np.zeros((B, n_fs, 2), np.complex64)
    G[:, :, 0] = 1
    ebno = np.zeros((B,), np.float32)

    rows = []
    i = 0
    for ch in channels:
        for e in EbNodB_list:
            for rep in range(reps):
                ebno[i] = e
                if ch != "awgn":
                    nsec = n_fs / cfg.Fs + 1
                    _, Gs, hf_gain = multipath_samples(
                        ch, cfg.Fs, cfg.Rs_dash, cfg.Nc, nsec, rng=rng)
                    G[i] = hf_gain * Gs[:n_fs]
                rows.append((ch, e, rep))
                i += 1
    return feats, H, G, ebno, rows


def run_sweep(model, params, feats_seq, channels, EbNodB_list, reps=2,
              group=None, seed=0, metric="loss"):
    """The grid through one forward, EbNodB riding in as a per-row tensor.
    Returns {(channel, EbNo): mean over the reps}.  With a group each rank
    runs its rows of the grid only: its rows reduced into per-(channel,
    EbNo) sums by a one-hot product, then one all_reduce of sums and
    counts, so no rank gathers per-row values (radae_tpu's
    `run_sweep_shard_map`; its jit-sharded `run_sweep` is this without a
    group).  Rows that pad the grid to a multiple of the world size fall
    in a dead cell."""
    cfg = model.cfg
    rng = np.random.default_rng(seed)
    feats, H, G, ebno, rows = build_grid_batch(cfg, feats_seq, channels,
                                               EbNodB_list, reps, rng)
    world = 1
    if group is not None:
        import torch.distributed as dist
        world = dist.get_world_size(group)
    cells = {(ch, e): i for i, (ch, e) in enumerate(
        (c, e) for c in channels for e in EbNodB_list)}
    n_cells = len(cells)
    cell_id = np.array([cells[(ch, e)] for ch, e, _ in rows], np.int64)
    pad = (-len(rows)) % world
    if pad:
        feats, H, G, ebno = (np.concatenate([a, a[:pad]])
                             for a in (feats, H, G, ebno))
        cell_id = np.concatenate([cell_id, np.full(pad, n_cells)])
    onehot = np.eye(n_cells + 1, dtype=np.float32)[cell_id][:, :n_cells]
    sl = rank_rows(len(cell_id), group)
    key = step_generator(model.device, seed, 0)
    if group is not None:
        key = BatchRows(key, len(cell_id), sl.start, sl.stop, group)
    with torch.no_grad():            # per-row loss on the first 20, or BER
        out = model.forward(params, feats[sl], H[sl], cplx.pack_np(G[sl]),
                            key=key, EbNodB=ebno[sl])
        if metric == "ber":
            losses = out["ber_row"]
        else:
            f = model._tensor(feats[sl])
            losses = distortion_loss(f[..., :20],
                                     out["features_hat"][..., :20])
    oh = torch.as_tensor(onehot[sl], device=model.device)
    sums = torch.cat([oh.T @ losses.float(), oh.sum(dim=0)])
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(sums, group=group)       # ONE collective
    means = (sums[:n_cells] / sums[n_cells:].clamp(min=1.0)).cpu().numpy()
    return {k: float(means[i]) for k, i in cells.items()}


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_name", type=str,
                   help="checkpoint (.npz or .pth), or random")
    p.add_argument("features", type=str)
    p.add_argument("--channels", type=str, default="awgn,mpp")
    p.add_argument("--EbNodB", type=str, default="0,3,6,10")
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--seconds", type=float, default=4.0)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--json", type=str, default="")
    p.add_argument("--ber", action="store_true",
                   help="QPSK substitution BER grid instead of feature "
                        "loss (reference ofdm_sync.sh BER-vs-EbNo curves, "
                        "the whole curve as one batch)")
    p.add_argument("--shard_map", action="store_true",
                   help="accepted for radae_tpu's command lines; the sweep "
                        "is the same with or without it")
    p.add_argument("--audio", type=str, default="",
                   help="per-cell listening audio: not ported yet (needs "
                        "the vocoder and utils/quality.py); refused")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; with torchrun, "
                        "cuda:LOCAL_RANK)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.audio:
        raise SystemExit("evaluate --audio: the listening material needs the "
                         "vocoder and utils/quality.py, which radae_tpu_torch "
                         "does not have yet; run without --audio")
    device, group, rank, world = join_from_env(args.device)
    try:
        run(args, device, group, rank)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args, device, group, rank):
    # Native checkpoints record their model args: infer --auxdata from the
    # checkpoint so a trained-with-aux model evaluates correctly without
    # the flag (a mismatch otherwise fails deep in the encoder matmul).
    if (not args.auxdata and args.model_name not in ("", "random")
            and not args.model_name.endswith(".pth")):
        _, meta = load_checkpoint(args.model_name)
        if meta.get("model_args", {}).get("auxdata"):
            if rank == 0:
                print("note: checkpoint was trained with auxdata; enabling it",
                      file=sys.stderr)
            args.auxdata = True

    nf = 21 if args.auxdata else 20
    common = dict(feature_dim=nf, latent_dim=args.latent_dim, EbNodB=100,
                  rate_Fs=True, pilots=True, pilot_eq=True, eq_mean6=False,
                  cyclic_prefix=0.004)
    if args.ber:
        # BER calibration waveform: bottleneck 1, no PA clip / coarse mag
        # (reference model05, test/inference_ber_awgn.sh + ofdm_sync.sh)
        cfg = RADAEConfig(bottleneck=1, ber_test=True, **common)
    else:
        cfg = RADAEConfig(coarse_mag=True, time_offset=-16, bottleneck=3,
                          **common)
    model = RADAE(cfg, device)
    params = load_params(args.model_name, lambda: model.init(args.seed))

    f = read_f32(args.features, NB_TOTAL_FEATURES)[:, :NUM_USED_FEATURES]
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(
        min(f.shape[0], int(args.seconds * 100)))
    feats_seq = f[:T].astype(np.float32)
    if args.auxdata:
        aux = -np.ones((T, 1), np.float32)
        feats_seq = np.concatenate([feats_seq, aux], axis=1)

    channels = args.channels.split(",")
    ebnos = [float(x) for x in args.EbNodB.split(",")]
    metric = "ber" if args.ber else "loss"
    t0 = time.time()
    table = run_sweep(model, params, feats_seq, channels, ebnos,
                      reps=args.reps, group=group, seed=args.seed,
                      metric=metric)
    dt = time.time() - t0
    if rank != 0:
        return table

    print(f"{'channel':8s} " + " ".join(f"{e:7.1f}" for e in ebnos))
    for ch in channels:
        print(f"{ch:8s} " + " ".join(f"{table[(ch, e)]:7.3f}" for e in ebnos))
    print(f"sweep: {len(channels)*len(ebnos)*args.reps} cells in {dt:.1f}s",
          file=sys.stderr)
    if args.json:
        with open(args.json, "w") as fj:
            json.dump({f"{ch}@{e}": v for (ch, e), v in table.items()}, fj)
    return table


if __name__ == "__main__":
    main()
