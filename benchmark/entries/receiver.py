"""The file cell's timed entry: `RADAE.receiver(params, rx)` with no key
(the rx tool's path): a whole recorded file, time and frequency aligned,
through the CP strip, DFT and the pilot EQ over the file, then the decoder
kernel over the whole chain from the zero state, at B=1.  One file a call,
each synchronised before the next, as one operator decodes recordings.

The check compares every call, in the window and its warm-up, of a seeded
sample of the files, the longest among them, with the plain reference:
  feat_gap  the features, largest difference over largest magnitude;
  zhat_gap  the latents the front end handed the decoder, the same way.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import generator
from benchmark.generator import Source
from benchmark.program import program_config
from benchmark.reference import radae_ref as R
from benchmark.streams import rel_gap, synchronize


class Cell:

    def __init__(self, cfg, traffic, seed, device, root, sut="program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.root, self.sut = device, root, sut

    def setup(self):
        self.src = Source(self.seed, self.device)
        self.ref_weights = R.load_weights(self.root / self.cfg["weights"],
                                          self.device)
        nets, modem = R.Nets(self.ref_weights), R.Modem(self.cfg, self.device)
        self.files = generator.file_iq(self.root, self.traffic, self.cfg, nets,
                                       modem, self.src)
        self.frames = generator.file_frames(self.traffic)
        if self.sut == "program":
            self.receive = self.program_receiver()
        elif self.sut == "control":
            tn = R.Nets(self.ref_weights, "tf32")
            tm = R.Modem(self.cfg, self.device, "tf32")
            self.receive = lambda x: self.reference(tn, tm, x)
        else:
            raise ValueError(f"sut must be program or control, got {self.sut!r}")
        # warm-up: every file once, so every length has run
        self.order = list(range(len(self.files)))
        self.k, self.kept = 0, []
        t = time.perf_counter()
        self.keep(self.call(self.next_input()))
        synchronize(self.device)
        self.first_call_s = time.perf_counter() - t
        for _ in self.files[1:]:
            self.keep(self.call(self.next_input()))

    def program_receiver(self):
        from radae_tpu_torch.convert import load_checkpoint
        from radae_tpu_torch.models.radae import RADAE

        model = RADAE(program_config(self.cfg), self.device)
        tree, _ = load_checkpoint(str(self.root / self.cfg["weights"]))
        return lambda x: model.receiver(tree, x)

    @staticmethod
    def reference(nets, modem, x):
        z = modem.rx_file(R.unpacked(x))
        return nets.decoder(z, nets.decoder_zero_state(1, x.device))[0], z

    def next_input(self):
        if self.k >= len(self.order):
            self.order += generator.file_order(self.traffic, self.src,
                                               len(self.files))
        self.file = self.order[self.k]
        return self.files[self.file]

    def call(self, x):
        with torch.no_grad():
            out = self.receive(x)
        self.k += 1
        return out

    def keep(self, out):
        self.kept.append((self.file, out))

    def audio_s(self):
        return self.frames[self.file] * 0.12

    def work(self):
        return {"direction": "rx", "streams": 1,
                "frames": self.frames[self.file]}

    def free(self):
        self.receive = None

    def check(self):
        called = sorted({f for f, _ in self.kept})
        longest = max(called, key=lambda f: self.frames[f])
        rest = [f for f in called if f != longest]
        n = min(self.traffic["check_files"] - 1, len(rest))
        rng = np.random.default_rng((self.seed, 1))   # not the order's draws
        sample = {longest} | {rest[i] for i in rng.choice(
            len(rest), n, replace=False)}
        nets, modem = R.Nets(self.ref_weights), R.Modem(self.cfg, self.device)
        gaps = {"feat_gap": 0.0, "zhat_gap": 0.0}
        with torch.no_grad():
            for f in sorted(sample):
                want_f, want_z = self.reference(nets, modem, self.files[f])
                for g, (got_f, got_z) in self.kept:
                    if g == f:
                        gaps["feat_gap"] = max(gaps["feat_gap"],
                                               rel_gap(got_f, want_f))
                        gaps["zhat_gap"] = max(gaps["zhat_gap"],
                                               rel_gap(got_z, want_z))
        return gaps
