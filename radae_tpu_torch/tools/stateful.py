"""Streaming against whole-sequence encoder/decoder checks (port of
`radae_tpu/tools/stateful.py`; reference: stateful_encoder.py:73-109,
stateful_decoder.py:44-109).

Both runs go through the hand-written kernels on packed weights
(`ops.fused_core.fused_encoder_step` / `fused_decoder_step`, the unmerged f32
forms, B=1): the whole file in one launch, then the stream one modem frame
(3 z-steps) a launch for the encoder and one z-step a launch for the
decoder, the state carried between launches.  The tools gate the mean |z|
difference (encoder) or the loss between the two decodes (decoder) at 0.01;
--read_latent compares with latents from elsewhere (a C encoder port).

    python -m radae_tpu_torch stateful_encoder model.npz features.f32 \
        [--read_latent z.f32] [--write_latent z.f32] [--device cpu]
    python -m radae_tpu_torch stateful_decoder model.npz features.f32 [...]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from ..config import flagship_config
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES, read_f32, write_f32
from ..models.core import distortion_loss
from ..models.radae import RADAE
from ..ops import fused_core
from .tx_batch import load_params


def _setup(args):
    num_features = 21 if args.auxdata else 20
    cfg = flagship_config(feature_dim=num_features,
                          latent_dim=args.latent_dim)
    model = RADAE(cfg, args.device)
    params = load_params(args.model_name, lambda: model.init(0))
    feats = read_f32(args.features, NB_TOTAL_FEATURES)
    T = cfg.num_10ms_times_steps_rounded_to_modem_frames(feats.shape[0])
    f = feats[None, :T, :NUM_USED_FEATURES].copy()
    if args.auxdata:
        aux = -np.ones((1, T, 1), np.float32)
        f = np.concatenate([f, aux], axis=2)
    return cfg, model, params, torch.as_tensor(f, device=model.device)


def _encode(cfg, model, params, feats, state=None):
    """The encoder kernel over feats (1, 4*nz, F) -> (z, new state)."""
    if state is None:
        state = fused_core.encoder_state_zero(1, model.device)
    return fused_core.fused_encoder_step(
        model.kernel_weights(params, "encoder"), feats, state, cfg.bottleneck)


def _read_latent(fn, cfg, device):
    return torch.as_tensor(read_f32(fn, cfg.latent_dim)[None], device=device)


def _common(p):
    p.add_argument("model_name", type=str)
    p.add_argument("features", type=str)
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--auxdata", action="store_true")
    p.add_argument("--read_latent", type=str, default="",
                   help="compare against externally-produced z (C encoder)")
    p.add_argument("--write_latent", type=str, default="")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda)")


@torch.no_grad()
def stateful_encoder(argv=None):
    p = argparse.ArgumentParser()
    _common(p)
    args = p.parse_args(argv)
    cfg, model, params, feats = _setup(args)

    z_van, _ = _encode(cfg, model, params, feats)

    # streaming: one modem frame (12 feature frames) at a time
    state = None
    chunks = []
    step = cfg.enc_stride * cfg.Nzmf
    for i in range(0, feats.shape[1], step):
        zc, state = _encode(cfg, model, params, feats[:, i:i + step], state)
        chunks.append(zc)
    z_str = torch.cat(chunks, dim=1)

    if args.read_latent:
        z_str = _read_latent(args.read_latent, cfg, model.device)
        z_str = z_str[:, : z_van.shape[1], :]

    delta = float((z_van - z_str).abs().mean())
    print(f"mean |z_vanilla - z_stream|: {delta:6.4f}")
    if args.write_latent:
        write_f32(args.write_latent, z_str.cpu().numpy())
    ok = delta < 0.01
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


@torch.no_grad()
def stateful_decoder(argv=None):
    p = argparse.ArgumentParser()
    _common(p)
    args = p.parse_args(argv)
    cfg, model, params, feats = _setup(args)

    z, _ = _encode(cfg, model, params, feats)
    if args.read_latent:
        z = _read_latent(args.read_latent, cfg, model.device)

    dw = model.kernel_weights(params, "decoder")
    f_van, _ = fused_core.fused_decoder_step(
        dw, z, fused_core.decoder_state_zero(1, model.device))

    # streaming: one z-step (4 feature frames) at a time
    state = fused_core.decoder_state_zero(1, model.device)
    chunks = []
    for i in range(z.shape[1]):
        fc, state = fused_core.fused_decoder_step(dw, z[:, i:i + 1], state)
        chunks.append(fc)
    f_str = torch.cat(chunks, dim=1)

    loss = float(distortion_loss(f_van[..., :NUM_USED_FEATURES],
                                 f_str[..., :NUM_USED_FEATURES])[0])
    print(f"loss delta vanilla vs streaming: {loss:6.4f}")
    ok = loss < 0.01
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1
