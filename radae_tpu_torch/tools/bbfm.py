"""BBFM CLIs: inference (enc + FM channel + dec), standalone decoder, and
training (port of `radae_tpu/tools/bbfm.py`; reference: bbfm_inference.py,
bbfm_rx.py, train_bbfm.py).

    python -m radae_tpu_torch bbfm_inference model.npz f.f32 fh.f32 \\
        [--CNRdB 10] [--write_latent z.f32] [--device cpu]
    python -m radae_tpu_torch bbfm_rx model.npz z.f32 fh.f32 [--device cpu]
    python -m radae_tpu_torch train_bbfm f.f32 out_dir [--device cpu]

They run on the card (--device cuda, the default) or, when asked, on the
CPU.  bbfm_rx decodes a file with the decoder kernel at B=1 in one launch
(no noise, no gradient); bbfm_inference runs the plain nets while quant
noise is on (the default), as radae_tpu's forward draws it; train_bbfm
differentiates the plain nets with autograd, Adam(0.8, 0.95) with
1/(1+decay*step) LR decay (`parallel/trainstep.make_optimizer`), on
`data/dataset.RADAEDataset` with Nc = 1.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..config import BBFMConfig
from ..convert import save_checkpoint
from ..data.dataset import RADAEDataset
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32, write_f32
from ..models.bbfm import BBFM
from ..models.core import distortion_loss
from ..models.radae import tree_leaves
from ..parallel.trainstep import leaf_tree, make_optimizer, step_generator
from .tx_batch import load_params


def _device_arg(p):
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs the plain "
                        "versions)")


def _pad36(fh: np.ndarray) -> np.ndarray:
    pad = np.zeros(fh.shape[:2] + (NB_TOTAL_FEATURES - NUM_USED_FEATURES,),
                   np.float32)
    return np.concatenate([fh, pad], axis=-1)


def bbfm_inference(argv=None):
    p = argparse.ArgumentParser(
        description="BBFM enc + FM channel + dec (reference bbfm_inference.py)")
    p.add_argument("model_name", type=str)
    p.add_argument("features", type=str)
    p.add_argument("features_hat", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--write_latent", type=str, default="")
    p.add_argument("--CNRdB", type=float, default=100)
    p.add_argument("--passthru", action="store_true")
    p.add_argument("--h_file", type=str, default="")
    p.add_argument("--write_CNRdB", type=str, default="")
    p.add_argument("--loss_test", type=float, default=0.0)
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    args = p.parse_args(argv)

    cfg = BBFMConfig(feature_dim=NUM_USED_FEATURES,
                     latent_dim=args.latent_dim, CNRdB=args.CNRdB)
    model = BBFM(cfg, args.device)

    features_in = read_f32(args.features, NB_TOTAL_FEATURES)
    if args.passthru:
        write_f32(args.features_hat, features_in)
        return

    params = load_params(args.model_name, lambda: model.init(args.seed))
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(features_in.shape[0])
    feats = features_in[None, :T, :NUM_USED_FEATURES].copy()
    print(f"Processing: {T} feature vectors", file=sys.stderr)

    n_rs = cfg.num_timesteps_at_rate_Rs(T)
    H = np.ones((1, n_rs, 1), np.float32)
    if args.h_file:
        Hf = read_f32(args.h_file, 1)
        if Hf.shape[0] < n_rs:
            print("H file too short", file=sys.stderr)
            sys.exit(1)
        H = Hf[None, :n_rs, :]

    key = torch.Generator(device=model.device)
    key.manual_seed(args.seed)
    with torch.no_grad():
        out = model.forward(params, feats, H, key=key)

    fh = out["features_hat"].cpu().numpy()
    write_f32(args.features_hat, _pad36(fh))
    loss = float(distortion_loss(torch.as_tensor(feats),
                                 torch.as_tensor(fh))[0])
    print(f"loss: {loss:5.3f}")
    if args.loss_test > 0.0:
        print("PASS" if loss < args.loss_test else "FAIL")
    if args.write_latent:
        write_f32(args.write_latent, out["z_hat"].cpu().numpy())
    if args.write_CNRdB:
        write_f32(args.write_CNRdB, out["CNRdB"].cpu().numpy())


def bbfm_rx(argv=None):
    p = argparse.ArgumentParser(
        description="BBFM standalone decoder: z_hat.f32 -> features.f32")
    p.add_argument("model_name", type=str)
    p.add_argument("z_hat", type=str)
    p.add_argument("features_hat", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    args = p.parse_args(argv)

    cfg = BBFMConfig(feature_dim=NUM_USED_FEATURES, latent_dim=args.latent_dim)
    model = BBFM(cfg, args.device)
    params = load_params(args.model_name, lambda: model.init(args.seed))

    z_hat = read_f32(args.z_hat, args.latent_dim)[None]
    print(f"Processing: {z_hat.shape[1]} modem frames", file=sys.stderr)
    with torch.no_grad():
        fh = model.receiver(params, z_hat.astype(np.float32)).cpu().numpy()
    write_f32(args.features_hat, _pad36(fh))


def make_loss_fn(model: BBFM):
    """loss_fn(params, feats, H, key, CNRdB) -> the batch's mean distortion
    loss through the plain encoder, the FM channel and the plain decoder
    (params a tree of tensors on the model's device), the encoder's quant
    noise, the channel and the decoder's quant noise drawn from the
    generator `key` in that order (radae_tpu's train_bbfm `loss_fn`, which
    passes its key to both nets whatever cfg.quant_noise says)."""

    def loss_fn(params, feats, H, key, CNRdB):
        z, _ = model.core_encoder(params["encoder"], feats, key=key)
        z_hat, _, _ = model.channel(key, z, H, CNRdB)
        fh, _ = model.core_decoder(params["decoder"], z_hat, key=key)
        return distortion_loss(feats, fh).mean()

    return loss_fn


def train_bbfm(argv=None):
    """BBFM training loop (reference train_bbfm.py): CNRdB instead of
    EbNodB, Nc=1 fading sequences."""
    p = argparse.ArgumentParser()
    p.add_argument("features", type=str)
    p.add_argument("output", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--CNRdB", type=float, default=100)
    p.add_argument("--range_CNRdB", action="store_true")
    p.add_argument("--range_CNRdB_start", type=float, default=-3.0)
    p.add_argument("--h_file", type=str, default="")
    p.add_argument("--batch-size", type=int, default=32)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--sequence-length", type=int, default=256)
    p.add_argument("--lr-decay-factor", type=float, default=2.5e-5)
    p.add_argument("--initial-checkpoint", type=str, default=None)
    p.add_argument("--seed", type=int, default=0)
    _device_arg(p)
    args = p.parse_args(argv)

    cfg = BBFMConfig(feature_dim=NUM_USED_FEATURES,
                     latent_dim=args.latent_dim, CNRdB=args.CNRdB)
    model = BBFM(cfg, args.device)
    dev = model.device
    params = leaf_tree(load_params(args.initial_checkpoint or "random",
                                   lambda: model.init(args.seed)), dev)

    H_seq = cfg.num_timesteps_at_rate_Rs(args.sequence_length)
    ds = RADAEDataset(args.features, args.sequence_length, H_seq, 1, 1,
                      h_file=args.h_file)
    opt, sched = make_optimizer(args.lr, args.lr_decay_factor)(
        list(tree_leaves(params)))
    loss_fn = make_loss_fn(model)

    rng = np.random.default_rng(args.seed)
    ckpt_dir = os.path.join(args.output, "checkpoints")
    os.makedirs(ckpt_dir, exist_ok=True)
    for epoch in range(1, args.epochs + 1):
        losses = []
        for feats, H, _ in ds.batches(args.batch_size, rng):
            key = step_generator(dev, epoch, len(losses))
            CNRdB = args.CNRdB
            if args.range_CNRdB:
                CNRdB = float(args.range_CNRdB_start + 20 * rng.random())
            opt.zero_grad(set_to_none=True)
            loss = loss_fn(params, torch.as_tensor(feats, device=dev),
                           H[..., :1], key, CNRdB)
            loss.backward()
            opt.step()
            sched.step()
            losses.append(loss.detach())
        running = float(torch.stack(losses).sum()) if losses else 0.0
        nb = len(losses)
        print(f"epoch {epoch}: loss {running/max(nb,1):.4f}", file=sys.stderr)
        save_checkpoint(os.path.join(ckpt_dir, f"checkpoint_epoch_{epoch}.npz"),
                        params, dict(epoch=epoch, loss=running / max(nb, 1),
                                     CNRdB=args.CNRdB,
                                     latent_dim=args.latent_dim))


if __name__ == "__main__":
    bbfm_inference()
