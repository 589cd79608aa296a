"""The rx stream cells' timed entry: `runtime.make_streaming_rx_step(cfg,
CoreDecoder, B, fused=True)`, one frame of every stream a call (CP strip,
DFT, LS pilot EQ, coarse magnitude and demap, then the decoder kernel).
Its inputs: (B, Nmf+M+Ncp, 2) samples; its outputs: (B, 12, F) features
and the decoder state."""

from __future__ import annotations

import torch

from benchmark import generator
from benchmark.program import program_config
from benchmark.reference import radae_ref as R
from benchmark.streams import StreamCell


class Cell(StreamCell):

    def make_pool(self, nets, modem, src):
        return generator.stream_iq(self.root, self.traffic, self.cfg, nets,
                                   modem, src)

    def program_step(self):
        from radae_tpu_torch.convert import load_checkpoint
        from radae_tpu_torch.models.core import CoreDecoder
        from radae_tpu_torch.ops import fused_core
        from radae_tpu_torch.runtime import make_streaming_rx_step

        pc = program_config(self.cfg)
        tree, _ = load_checkpoint(str(self.root / self.cfg["weights"]))
        step = make_streaming_rx_step(
            pc, CoreDecoder(pc.latent_dim, pc.feature_dim), self.B,
            fused=True, device=self.device)
        return (step, fused_core.decoder_weights(tree["decoder"], self.device),
                fused_core.decoder_state_zero(self.B, self.device))

    def zero_state(self, nets):
        return nets.decoder_zero_state(self.B, self.device)

    def reference_step(self, nets, modem, x, state):
        return nets.decoder(modem.rx_frame(R.unpacked(x)), state)

    def replay(self, nets, modem, calls):
        """The sampled streams from the zero state: the front end of each
        pool frame once, then the decoder over every call's latents."""
        P = self.pool.shape[0]
        z = torch.stack([modem.rx_frame(R.unpacked(
            self.pool[k].index_select(0, self.sample))) for k in range(P)],
            dim=1)                                      # (S, P, 3, latent)
        state = nets.decoder_zero_state(len(self.sample), self.device)
        outs = []
        for c0, c1 in self.segments(calls):
            zs = z[:, self.frame_index(c0, c1)].flatten(1, 2)
            f, state = nets.decoder(zs, state)
            outs.append(f.reshape(f.shape[0], c1 - c0, 12, -1))
        return torch.cat(outs, dim=1).transpose(0, 1)

    def call_work(self):
        return {"direction": "rx", "streams": self.B, "frames": 1}
