"""Baseband-FM variant: the same core autoencoder over an analog-FM channel
model (port of `radae_tpu/models/bbfm.py`).

The channel is an FM-demod SNR piecewise model built from relus so it stays
differentiable, parameterised by carrier-to-noise ratio CNRdB and Carson's
rule FM gain (reference: radae/bbfm.py:157-197).

`key` is a torch.Generator on the model's device, or None for one seeded 0
(radae_tpu's None is a fixed key, so noise stays on there too): it drives
the encoder's quantization noise, the channel's Gaussian draw and the
decoder's quantization noise, in radae_tpu's order.  The core calls are
routed as RADAE's are (`models.radae.CoreCodec`): without quantization
noise and without a gradient asked for, the encoder runs as the f32 encoder
kernel with bottleneck 1 (the tanh on z) and the decoder as the unmerged
f32 decoder kernel, each at B=1 over the whole sequence in one launch;
otherwise the plain nets.
"""

from __future__ import annotations

import torch

from ..ops import draws
from .core import CoreDecoder, CoreEncoder
from .radae import CoreCodec


def normal(gen, shape) -> torch.Tensor:
    """The channel's N(0, 1) draw (radae_tpu's inline jax.random.normal),
    one function so that a test can give both packages the same draws."""
    return draws.randn(gen, shape)


class BBFM(CoreCodec):
    def __init__(self, cfg, device="cuda"):
        super().__init__(CoreEncoder(cfg.feature_dim, cfg.latent_dim,
                                     bottleneck=1),
                         CoreDecoder(cfg.latent_dim, cfg.feature_dim), device)
        self.cfg = cfg

    def channel(self, key, z, H, CNRdB=None):
        """Apply the FM-demod noise model to latents.

        z: (B, Tz, latent_dim) in [-1, 1]; H: (B, T_Rs, 1) fade magnitudes,
        one per symbol.  Returns (z_hat, sigma, CNRdB_vec)
        (reference: bbfm.py:170-190)."""
        cfg = self.cfg
        B = z.shape[0]
        n_rs = z.shape[1] * cfg.latent_dim
        z_flat = z.reshape(B, n_rs, 1)
        if CNRdB is None:
            CNRdB = cfg.CNRdB
        CNRdB_vec = 20.0 * torch.log10(self._tensor(H)) + CNRdB
        # piecewise FM demod SNR: above threshold (12 dB) SNR = CNR + Gfm;
        # below, a steeper 1+Gfm/3 dB/dB slope models threshold collapse
        SNRdB = torch.relu(CNRdB_vec - 12.0) + 12.0 + cfg.Gfm
        SNRdB = SNRdB - torch.relu(-(CNRdB_vec - 12.0)) * (1.0 + cfg.Gfm / 3.0)
        SNR = 10.0 ** (SNRdB / 10.0)
        sigma = 1.0 / torch.sqrt(SNR)
        n = sigma * normal(key, z_flat.shape)
        z_hat = torch.clamp(z_flat + n, -1.0, 1.0)
        return z_hat.reshape(z.shape), sigma, CNRdB_vec

    def forward(self, params, features, H, key=None):
        """features: (B, T10ms, F); H: (B, T_Rs, 1) with T_Rs = Rb * seconds
        (reference: bbfm.py:157-197)."""
        cfg = self.cfg
        features = self._tensor(features)
        B, T, _ = features.shape
        n_rs = cfg.num_timesteps_at_rate_Rs(T)
        if tuple(H.shape) != (B, n_rs, 1):
            raise ValueError(f"H has shape {tuple(H.shape)}, expected "
                             f"{(B, n_rs, 1)}")
        gen = key
        if gen is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(0)

        z = self._encode(params, features, self._noise_key(gen))
        z_hat, sigma, CNRdB = self.channel(gen, z, H)
        features_hat = self._decode(params, z_hat, self._noise_key(gen))
        return {"features_hat": features_hat, "z": z, "z_hat": z_hat,
                "sigma": sigma, "CNRdB": CNRdB}

    def receiver(self, params, z_hat, key=None):
        """Stand-alone receiver: symbols -> features (reference:
        bbfm.py:135-145).  Without a key (or with quant noise off) the
        decoder kernel over the whole sequence in one launch."""
        return self._decode(params, self._tensor(z_hat),
                            self._noise_key(key))
