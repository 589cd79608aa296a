"""What the stream cells share: many independent streams, one frame of
every stream a call, the state carried from call to call, and the check
that judges the calls.

A stream cell cycles through a pool of frames made at set-up.  Its warm-up
calls start from the zero state and the window goes on from theirs, so
every call from the first is one chain.  Each call hands back its outputs;
the rows of a seeded sample of streams are kept (a gather queued behind the
call), and the last call's input state and outputs are held.  Once the
window has closed the check computes, with the plain reference:

  replay_gap      the sampled streams' outputs of every call, against the
                  reference run from the zero state through the same frames;
  last_gap        the last call's outputs, every stream, against the
                  reference run from the state the program took in;
  last_state_gap  the state that call handed back, against the reference's.

Each gap is the largest absolute difference over the largest magnitude of
the reference's values (of each state tensor, for the state).
"""

from __future__ import annotations

import time

import torch

from .generator import Source
from .reference import radae_ref as R

SEGMENT_CALLS = 256     # calls the replay runs layer by layer at once
KEEP_CHUNK = 256        # calls a block of kept rows holds: the window's
                        # gathers write into blocks made 256 calls at a time


def synchronize(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def rel_gap(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def state_gap(got, want) -> float:
    return max(rel_gap(g, w) for g, w in zip(got, want))


class StreamCell:
    """Subclasses give `make_pool`, `program_step`, `reference_step`
    (nets, modem, x, state) -> (out, state), and `replay` (nets, modem,
    calls) -> the sampled streams' outputs of every call."""

    frame_s = 0.12

    def __init__(self, cfg, traffic, seed, device, root, sut="program"):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device, self.root, self.sut = device, root, sut
        self.B = traffic["streams"]

    def setup(self):
        src = Source(self.seed, self.device)
        self.ref_weights = R.load_weights(self.root / self.cfg["weights"],
                                          self.device)
        nets, modem = R.Nets(self.ref_weights), R.Modem(self.cfg, self.device)
        self.pool = self.make_pool(nets, modem, src)
        n = min(self.traffic["check_streams"], self.B)
        self.sample = torch.as_tensor(sorted(src.rng.choice(
            self.B, n, replace=False)), device=self.device)
        if self.sut == "program":
            self.step, self.weights, self.state = self.program_step()
        elif self.sut == "control":
            self.step, self.weights, self.state = self.control_step()
        else:
            raise ValueError(f"sut must be program or control, got {self.sut!r}")
        self.k, self.kept = 0, []
        self._work = self.call_work()
        t = time.perf_counter()
        self.keep(self.call(self.next_input()))
        synchronize(self.device)
        self.first_call_s = time.perf_counter() - t
        for _ in range(self.traffic["warmup_calls"] - 1):
            self.keep(self.call(self.next_input()))

    def control_step(self):
        """The reference in TF32 in the program's place."""
        nets = R.Nets(self.ref_weights, "tf32")
        modem = R.Modem(self.cfg, self.device, "tf32")
        state = self.zero_state(nets)
        return (lambda w, x, s: self.reference_step(nets, modem, x, s),
                None, state)

    def next_input(self):
        return self.pool[self.k % self.pool.shape[0]]

    def call(self, x):
        self.last_in = (self.k, self.state)
        out, self.state = self.step(self.weights, x, self.state)
        self.last_out = (out, self.state)
        self.k += 1
        return out

    def keep(self, out):
        c, j = divmod(self.k - 1, KEEP_CHUNK)
        if c == len(self.kept):
            self.kept.append(out.new_empty((KEEP_CHUNK, len(self.sample))
                                           + tuple(out.shape[1:])))
        torch.index_select(out, 0, self.sample, out=self.kept[c][j])

    def work(self):
        return self._work

    def audio_s(self):
        return self.B * self.frame_s

    def free(self):
        """Drop the program's weights and step; the traffic, the kept
        outputs and the last call's state stay for the check."""
        self.step = self.weights = self.state = None

    def check(self):
        nets, modem = R.Nets(self.ref_weights), R.Modem(self.cfg, self.device)
        with torch.no_grad():
            got = torch.cat(self.kept)[:self.k]
            want = self.replay(nets, modem, self.k)
            k, state_in = self.last_in
            out, state_out = self.last_out
            ref_out, ref_state = self.reference_step(
                nets, modem, self.pool[k % self.pool.shape[0]], state_in)
            return {"replay_gap": rel_gap(got, want),
                    "last_gap": rel_gap(out, ref_out),
                    "last_state_gap": state_gap(state_out, ref_state)}

    def segments(self, calls):
        for c0 in range(0, calls, SEGMENT_CALLS):
            yield c0, min(calls, c0 + SEGMENT_CALLS)

    def frame_index(self, c0, c1):
        return torch.arange(c0, c1, device=self.device) % self.pool.shape[0]
