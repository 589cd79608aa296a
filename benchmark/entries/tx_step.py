"""The tx stream cell's timed entry: `runtime.make_streaming_tx_step(cfg,
CoreEncoder, B, fused=True)`, one frame of features of every stream a call
(the encoder kernel, then the QPSK map, pilots, IDFT, CP and the PA's
tanh).  Its inputs: (B, 12, F) features; its outputs: (B, Nmf, 2) samples
and the encoder state."""

from __future__ import annotations

import torch

from benchmark import generator
from benchmark.program import program_config
from benchmark.reference import radae_ref as R
from benchmark.streams import StreamCell


class Cell(StreamCell):

    def make_pool(self, nets, modem, src):
        return generator.stream_features(self.root, self.traffic, self.cfg,
                                         src)

    def program_step(self):
        from radae_tpu_torch.convert import load_checkpoint
        from radae_tpu_torch.models.core import CoreEncoder
        from radae_tpu_torch.ops import fused_core
        from radae_tpu_torch.runtime import make_streaming_tx_step

        pc = program_config(self.cfg)
        tree, _ = load_checkpoint(str(self.root / self.cfg["weights"]))
        step = make_streaming_tx_step(
            pc, CoreEncoder(pc.feature_dim, pc.latent_dim, pc.bottleneck),
            self.B, fused=True, device=self.device)
        return (step, fused_core.encoder_weights(tree["encoder"], self.device),
                fused_core.encoder_state_zero(self.B, self.device))

    def zero_state(self, nets):
        return nets.encoder_zero_state(self.B, self.device)

    def reference_step(self, nets, modem, x, state):
        z, state = nets.encoder(x, state, self.cfg["bottleneck"])
        return R.packed(modem.modulate(z)), state

    def replay(self, nets, modem, calls):
        """The sampled streams from the zero state: the encoder over every
        call's features, then the modulator frame by frame."""
        feats = self.pool.index_select(1, self.sample)   # (P, S, 12, F)
        state = nets.encoder_zero_state(len(self.sample), self.device)
        outs = []
        for c0, c1 in self.segments(calls):
            f = feats[self.frame_index(c0, c1)].transpose(0, 1).flatten(1, 2)
            z, state = nets.encoder(f, state, self.cfg["bottleneck"])
            tx = modem.modulate(z).reshape(z.shape[0], c1 - c0, -1)
            outs.append(R.packed(tx))
        return torch.cat(outs, dim=1).transpose(0, 1)

    def call_work(self):
        return {"direction": "tx", "streams": self.B, "frames": 1}
