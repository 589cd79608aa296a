"""Streaming RADAE transmitter ("embedded" tx): features in, IQ out (port
of `radae_tpu/apps/txe.py`).

One 120 ms modem frame per call: the stateful core encoder step with
quantization noise, then the OFDM transmitter (`dsp.streaming.
TransmitterOne.modulate`), with an optional Tx band-pass filter and
magnitude clip on the host (reference: radae_txe.py:47-144).

The encoder is the plain `CoreEncoder` with its noise drawn from a
torch.Generator on the device, seeded to 0 every frame: the same noise
pattern each frame, as radae_tpu's jax.random.PRNGKey(0) every frame (the
two streams differ; only their distribution is the same).  The fused
encoder kernel computes the noise-free net, another function, so it does
not serve here.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..config import flagship_config
from ..convert import load_checkpoint, load_torch_checkpoint, params_to_torch
from ..data.io import NB_TOTAL_FEATURES, NUM_USED_FEATURES
from ..dsp.bpf import ComplexBPF
from ..dsp.streaming import TransmitterOne
from ..models.core import CoreEncoder
from ..ops import cplx, ofdm
from ..runtime import f32_device

NOISE_SEED = 0      # the generator's seed, set anew every frame


class RadaeTx:
    def __init__(self, model_path: str = "", latent_dim: int = 80,
                 auxdata: bool = True, bottleneck: int = 3,
                 txbpf_en: bool = False, bypass_enc: bool = False,
                 params=None, device="cuda"):
        self.auxdata = auxdata
        self.bypass_enc = bypass_enc
        self.txbpf_en = txbpf_en
        self.device = dev = f32_device(device)
        num_features = 21 if auxdata else 20
        self.cfg = flagship_config(feature_dim=num_features,
                                   latent_dim=latent_dim,
                                   bottleneck=bottleneck)
        cfg = self.cfg
        self.encoder = CoreEncoder(num_features, latent_dim,
                                   bottleneck=bottleneck)
        if params is None and model_path and not bypass_enc:
            if model_path.endswith(".pth"):
                params = load_torch_checkpoint(model_path)
            else:
                params, _ = load_checkpoint(model_path)
        self.params = (params_to_torch(params["encoder"], dev) if params
                       else None)
        self.enc_state = None
        self._eoo = cfg.eoo.copy()
        self._tx1 = TransmitterOne(cfg, dev)
        self._gen = torch.Generator(device=dev)

        if txbpf_en:
            w = cfg.w
            bw = 1.2 * (w[-1] - w[0]) * cfg.Fs / (2 * np.pi)
            centre = (w[-1] + w[0]) * cfg.Fs / (2 * np.pi) / 2
            self.txbpf = ComplexBPF(101, cfg.Fs, bw, centre, cfg.Fs)

        # input floats per processing frame
        if not bypass_enc:
            self.n_floats_in = cfg.Nzmf * cfg.enc_stride * NB_TOTAL_FEATURES
        else:
            self.n_floats_in = cfg.Nzmf * latent_dim
        self.Nmf = cfg.Nmf
        self.Neoo = int((cfg.Ns + 2) * (cfg.M + cfg.Ncp))

    # -- C-API style getters (reference: radae_txe.py:95-106) ---------------
    def get_n_features_in(self):
        return self.cfg.Nzmf * self.cfg.enc_stride * NB_TOTAL_FEATURES

    def get_n_floats_in(self):
        return self.n_floats_in

    def get_Nmf(self):
        return self.Nmf

    def get_Neoo(self):
        return self.Neoo

    def get_Neoo_bits(self):
        return self.cfg.Nseoo * self.cfg.bps

    def set_eoo_bits(self, eoo_bits):
        self._eoo = ofdm.set_eoo_bits(self.cfg, np.asarray(eoo_bits))

    # -- device step: encoder + OFDM mod ------------------------------------
    def _step(self, params, features, state, gen):
        """features (1, 12, F) on the device -> (packed (Nmf, 2), new
        state); gen is the quantization noise's generator, None for none."""
        z, state = self.encoder(params, features, key=gen, state=state)
        return self._tx1.modulate(z).reshape(-1, 2), state

    @torch.no_grad()
    def do_radae_tx(self, buffer_f32: np.ndarray) -> np.ndarray:
        """One frame: n_floats_in floats -> Nmf complex64 samples."""
        cfg = self.cfg
        if not self.bypass_enc:
            feats = np.reshape(buffer_f32,
                               (1, cfg.Nzmf * cfg.enc_stride, NB_TOTAL_FEATURES))
            feats = feats[:, :, :NUM_USED_FEATURES]
            if self.auxdata:
                aux = -np.ones((1, feats.shape[1], 1), np.float32)
                feats = np.concatenate([feats, aux], axis=2)
            feats = torch.as_tensor(np.array(feats, np.float32),
                                    device=self.device)
            if self.enc_state is None:
                self.enc_state = self.encoder.zero_state(1, self.device)
            self._gen.manual_seed(NOISE_SEED)
            pair, self.enc_state = self._step(self.params, feats,
                                              self.enc_state, self._gen)
            tx = cplx.to_c64(pair)
        else:
            z = np.reshape(buffer_f32, (1, cfg.Nzmf, cfg.latent_dim))
            tx = self._tx1.transmit(z)
        if self.txbpf_en:
            tx = self.txbpf.bpf(tx)
            tx = np.clip(np.abs(tx), 0, 1) * np.exp(1j * np.angle(tx))
        return tx.astype(np.complex64)

    def do_eoo(self) -> np.ndarray:
        eoo = self._eoo.flatten()
        if self.txbpf_en:
            eoo = self.txbpf.bpf(eoo)
            eoo = np.clip(np.abs(eoo), 0, 1) * np.exp(1j * np.angle(eoo))
        return eoo.astype(np.complex64)

    def reset(self):
        self.enc_state = None


def main(argv=None):
    import argparse
    parser = argparse.ArgumentParser(
        description="RADAE streaming transmitter: features.f32 on stdin, IQ.f32 on stdout")
    parser.add_argument("--model_name", type=str, default="")
    parser.add_argument("--noauxdata", dest="auxdata", action="store_false")
    parser.add_argument("--txbpf", action="store_true")
    parser.add_argument("--bypass_enc", action="store_true")
    parser.add_argument("--eoo_data_test", action="store_true")
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device (default cuda; cpu runs the "
                        "plain layers on the host)")
    parser.set_defaults(auxdata=True)
    args = parser.parse_args(argv)

    tx = RadaeTx(model_path=args.model_name, auxdata=args.auxdata,
                 txbpf_en=args.txbpf, bypass_enc=args.bypass_enc,
                 device=args.device)
    if args.eoo_data_test:
        rng = np.random.default_rng(65647)
        tx_bits = np.sign(rng.random(tx.get_Neoo_bits()) - 0.5).astype(np.float32)
        tx.set_eoo_bits(tx_bits)
        tx_bits.tofile("eoo_tx.f32")

    nbytes = tx.n_floats_in * 4
    while True:
        buf = sys.stdin.buffer.read(nbytes)
        if len(buf) != nbytes:
            break
        out = tx.do_radae_tx(np.frombuffer(buf, np.float32))
        sys.stdout.buffer.write(out.tobytes())
    eoo = tx.do_eoo()
    sys.stdout.buffer.write(eoo.tobytes())
    if args.eoo_data_test:
        sys.stdout.buffer.write(np.zeros(tx.Neoo, np.complex64).tobytes())
    sys.stdout.buffer.flush()


if __name__ == "__main__":
    main()
