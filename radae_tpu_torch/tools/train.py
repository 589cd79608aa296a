"""Training CLI (port of `radae_tpu/tools/train.py`; reference train.py).

Per-epoch checkpoints carrying the model and dataset args (reference:
train.py:80-101,298-303), Adam(0.8, 0.95) with 1/(1+decay*step) LR decay,
per-sequence Eb/No range draws, optional auxdata BER reporting, and the
loss-vs-Eq/No evaluation mode (--plot_EqNo, reference: train.py:161-226).

Data parallel over cards with torch.distributed: launched by `torchrun
--nproc_per_node N`, each process takes the card LOCAL_RANK and its rows
of every global batch (--batch-size is the global batch), the gradients
are averaged over the group (parallel/trainstep.py), rank 0 logs and
writes the checkpoints.  WORLD_SIZE, RANK and LOCAL_RANK come from the
environment (torchrun's) in place of radae_tpu's --n_devices; without
them it runs in one process.

    python -m radae_tpu_torch train features.f32 out_dir --rate_Fs \\
        --pilots --pilot_eq --eq_ls --cp 0.004 --bottleneck 3 \\
        --range_EbNo --auxdata --sequence-length 252 [--device cpu]

--sequence-length must be a whole number of 120 ms modem frames (12
feature frames): the default, radae_tpu's 256, is not, and is refused
with the nearest length that is (252).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

from ..config import RADAEConfig
from ..convert import load_checkpoint, save_checkpoint
from ..data.dataset import RADAEDataset
from ..models.radae import RADAE
from ..ops import cplx
from ..parallel.distributed import join_from_env
from ..parallel.mesh import shard_batch
from ..parallel.trainstep import make_eval_step, make_train_step


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("features", type=str)
    p.add_argument("output", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--EbNodB", type=float, default=0)
    p.add_argument("--range_EbNo", action="store_true")
    p.add_argument("--range_EbNo_start", type=float, default=-6.0)
    p.add_argument("--h_file", type=str, default="")
    p.add_argument("--g_file", type=str, default="")
    p.add_argument("--rate_Fs", action="store_true")
    p.add_argument("--freq_rand", action="store_true")
    p.add_argument("--gain_rand", action="store_true")
    p.add_argument("--bottleneck", type=int, default=1)
    p.add_argument("--pilots", action="store_true")
    p.add_argument("--pilot_eq", action="store_true")
    p.add_argument("--eq_ls", action="store_true")
    p.add_argument("--cp", type=float, default=0.0)
    p.add_argument("--batch-size", type=int, default=32,
                   help="the global batch, split over the ranks")
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--sequence-length", type=int, default=256)
    p.add_argument("--lr-decay-factor", type=float, default=2.5e-5)
    p.add_argument("--initial-checkpoint", type=str, default=None)
    p.add_argument("--plot_EqNo", type=str, default="")
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--aux_weight_boost", type=float, default=1.0,
                   help="training-time extra weight on the aux symbol loss")
    p.add_argument("--scan-steps", type=int, default=1,
                   help="batches counted in groups of this many: the "
                        "epoch's last incomplete group is dropped, as "
                        "radae_tpu drops it (it runs a group in one call)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; with torchrun, "
                        "cuda:LOCAL_RANK)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device, group, rank, world = join_from_env(args.device)
    try:
        run(args, device, group, rank, world)
    finally:
        if group is not None:
            import torch.distributed as dist
            dist.destroy_process_group()


def run(args, device, group, rank, world):
    log = (lambda msg: print(msg, file=sys.stderr)) if rank == 0 else (
        lambda msg: None)
    num_features = 21 if args.auxdata else 20
    cfg = RADAEConfig(
        feature_dim=num_features, latent_dim=args.latent_dim,
        EbNodB=args.EbNodB, range_EbNo=args.range_EbNo,
        range_EbNo_start=args.range_EbNo_start, rate_Fs=args.rate_Fs,
        freq_rand=args.freq_rand, gain_rand=args.gain_rand,
        bottleneck=args.bottleneck, pilots=args.pilots,
        pilot_eq=args.pilot_eq, eq_mean6=not args.eq_ls,
        cyclic_prefix=args.cp)
    model = RADAE(cfg, device)
    dev = model.device
    log(cfg.summary())
    frame = cfg.enc_stride * cfg.Nzmf
    if args.sequence_length % frame:
        # radae_tpu fails here deep in the forward's reshape
        near = max(frame, args.sequence_length // frame * frame)
        raise SystemExit(f"--sequence-length {args.sequence_length} is not a "
                         f"whole number of modem frames ({frame} feature "
                         f"frames each): use {near}")
    if args.batch_size % world:
        raise SystemExit(f"--batch-size {args.batch_size} does not split "
                         f"evenly over {world} ranks")

    params = model.init(args.seed)
    start_epoch = 1
    if args.initial_checkpoint:
        params, meta = load_checkpoint(args.initial_checkpoint)
        start_epoch = int(meta.get("epoch", 0)) + 1
        log(f"Loaded {args.initial_checkpoint} (epoch {start_epoch-1})")

    # dataset with the reference's H/G sequence-length derivation
    H_seq = cfg.num_timesteps_at_rate_Rs(args.sequence_length)
    G_seq = cfg.num_timesteps_at_rate_Fs(H_seq)
    ds = RADAEDataset(args.features, args.sequence_length, H_seq, cfg.Nc,
                      G_seq, h_file=args.h_file, g_file=args.g_file,
                      rate_Fs=args.rate_Fs, auxdata=args.auxdata)
    log(f"dataset: {len(ds)} sequences of {args.sequence_length} frames")

    ckpt_dir = os.path.join(args.output, "checkpoints")
    if rank == 0:
        os.makedirs(ckpt_dir, exist_ok=True)
    meta_common = dict(
        model_args=dict(num_features=num_features, latent_dim=args.latent_dim,
                        EbNodB=args.EbNodB, range_EbNo=args.range_EbNo,
                        rate_Fs=args.rate_Fs, bottleneck=args.bottleneck,
                        pilots=args.pilots, pilot_eq=args.pilot_eq,
                        cp=args.cp, auxdata=args.auxdata),
        dataset_args=dict(features=args.features,
                          sequence_length=args.sequence_length,
                          H_sequence_length=H_seq, Nc=cfg.Nc,
                          G_sequence_length=G_seq),
        batch_size=args.batch_size, lr=args.lr,
        lr_decay_factor=args.lr_decay_factor,
        sequence_length=args.sequence_length, adam_betas=[0.8, 0.95])

    # every rank draws the same global batches; each keeps its rows
    rng = np.random.default_rng(args.seed)

    if args.plot_EqNo:
        if rank == 0:
            _loss_vs_EqNo(args, cfg, model, params, ds, rng)
        return

    scan = max(1, args.scan_steps)
    init_state, train_step = make_train_step(
        model, lr=args.lr, lr_decay_factor=args.lr_decay_factor,
        aux_ber=args.auxdata, aux_weight_boost=args.aux_weight_boost,
        group=group)
    state = init_state(params)

    def to_dev(x):
        return None if x is None else torch.as_tensor(x).to(dev)

    log_interval = 10
    # radae_tpu runs `scan` steps a call and drops the epoch's last
    # incomplete group; here the steps run one by one, the same ones
    n_run = len(ds) // args.batch_size // scan * scan
    metrics = None
    for epoch in range(start_epoch, args.epochs + 1):
        t0 = time.time()
        running = torch.zeros((), device=dev)
        nb = 0
        for feats, H, G in ds.batches(args.batch_size, rng):
            if nb == n_run:
                continue        # still drawn: the rng runs as radae_tpu's
            # benign channels are built in the forward: only ship real data
            Hb = H if args.h_file else None
            Gb = cplx.pack_np(G) if (cfg.rate_Fs and args.g_file) else None
            feats, Hb, Gb = (to_dev(x) for x in shard_batch(
                (feats, Hb, Gb), group))
            state, metrics = train_step(state, feats, Hb, Gb, args.seed)
            running += metrics["loss"][0]      # the group's mean
            nb += 1
            if nb % log_interval == 0:
                msg = f"epoch {epoch} batch {nb} loss {float(running)/nb:.4f}"
                if args.auxdata:
                    msg += f" BER {float(metrics['ber'][0]):.3f}"
                log(msg)
        epoch_loss = float(running) / max(nb, 1)
        dt = time.time() - t0
        ber_str = ""
        if args.auxdata and metrics is not None and "ber" in metrics:
            ber_str = f" BER {float(metrics['ber'][0]):.3f}"
        log(f"epoch {epoch}: loss {epoch_loss:.4f}{ber_str} "
            f"({nb} batches, {dt:.1f}s, "
            f"{nb*args.batch_size*args.sequence_length*0.01/dt:.0f} "
            f"audio-sec/s)")
        if rank == 0:
            save_checkpoint(
                os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch}.npz"),
                state.params, dict(meta_common, epoch=epoch, loss=epoch_loss))


def _loss_vs_EqNo(args, cfg, model, params, ds, rng):
    """One frozen pass collecting per-sequence (Eq/No, loss) into 1 dB bins
    (reference: train.py:161-226).  Every batch draws the same noise (one
    seed), as radae_tpu reuses one key."""
    ev = make_eval_step(model)
    rows = []
    for feats, H, G in ds.batches(args.batch_size, rng, shuffle=False):
        Gp = cplx.pack_np(G) if cfg.rate_Fs else None
        loss, ebno, sigma = ev(params, feats, H, Gp, args.seed)
        loss = loss.cpu().numpy()
        # measured Eq/No from sigma (rate Rs): Eq ~ 2, No = sigma^2
        No = sigma[:, 0].cpu().numpy() ** 2
        EqNodB = 10 * np.log10(2.0 / No)
        rows.append(np.stack([EqNodB, loss], 1))
    rows = np.concatenate(rows)
    lo, hi = int(np.ceil(rows[:, 0].min())), int(np.ceil(rows[:, 0].max()))
    out = []
    for e in range(lo, hi):
        sel = np.abs(rows[:, 0] - e) < 0.5
        if sel.any():
            out.append((e, rows[sel, 1].mean()))
    np.savetxt(args.plot_EqNo + "_loss_EqNodB.txt", np.array(out))
    print(f"wrote {args.plot_EqNo}_loss_EqNodB.txt ({len(out)} bins)",
          file=sys.stderr)


if __name__ == "__main__":
    main()
