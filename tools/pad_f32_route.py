#!/usr/bin/env python3
"""The padded chain-merged decoder's f32 form against the int8 instance
with f32 products on the same matrices, on one CUDA card, in turns.

    python3 tools/pad_f32_route.py [--latent 80 40] [--seeds 2] [--chain 3]
                                   [--reps 9]

Two weight sets of the fixture's decoder in the padded layout
(merged="pad"), holding the same f32 matrices (checked):

  f32      decoder_weights(merged="pad"): the padded f32 form
           (fused_decoder_merged_step_pad);
  xsplit   decoder_weights(merged="pad", quant="int8", quant_exclude=
           ("_w", "_wih", "_wgg")): every matrix kept in f32 with a unit
           scale row, which the int8 instance with f32 products runs as
           the six products of x's and w's bf16 parts
           (fused_decoder_merged_step_pad_int8).

For each latent and seed, --chain calls chained from the zero state (B=2048,
nz=3, latents drawn as chip_smoke.py draws them) go through both forms
(fused_decoder_step), the plain f32 step and the plain step in f64
(chip_smoke.plain_f64).  It prints each form's largest |err| / (atol + rtol
|want|) of chip_smoke.py's TOL against both (1 or less: within TOL) and
whether the two forms give the same bits.  Then it times both on a random
state, in turns, --reps rounds with the order reversed every round (CUDA
graphs of 20 launches: chip_smoke.graph_runs), and prints each form's
median, the ptxas lines of dec_merged_kernel's instances and the card's
name and power limit.  Exits 1 if a form is past TOL of the plain f32 step.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (TOL, card_line, graph_runs, plain_f64,  # noqa: E402
                        tol_ratio)

B = 2048
CHECKPOINTS = {80: "model_fs_flagship.npz", 40: "model_l40.npz"}
EVERY_MATRIX = ("_w", "_wih", "_wgg")   # quant_exclude: every matrix f32


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--latent", type=int, nargs="+", choices=sorted(CHECKPOINTS),
                    default=[80, 40])
    ap.add_argument("--seeds", type=int, default=2)
    ap.add_argument("--chain", type=int, default=3)
    ap.add_argument("--reps", type=int, default=9)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("pad_f32_route: no CUDA card", file=sys.stderr)
        return 1
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.ops import _kernels
    from radae_tpu_torch.ops import fused_core as fc

    card = card_line()
    print(f"card: {card}")
    log = _kernels.finish_build("fused_core", _kernels.start_build("fused_core"))
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and "dec_merged_kernel" in line:
            print("ptxas " + " ".join(x.strip() for x in lines[i:i + 4]
                                      if any(k in x for k in ("entry", "registers",
                                                              "spill"))))
    dev = torch.device("cuda")
    nz = 3
    broke = []
    with torch.no_grad():
        for latent in args.latent:
            tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                                   CHECKPOINTS[latent]))
            forms = {"f32": fc.decoder_weights(tree["decoder"], dev, merged="pad"),
                     "xsplit": fc.decoder_weights(
                         tree["decoder"], dev, merged="pad", quant="int8",
                         quant_exclude=EVERY_MATRIX)}
            w = forms["f32"]
            if not all(torch.equal(a, b) for a, b in
                       zip(w.arrays, forms["xsplit"].arrays)):
                raise AssertionError("the two sets hold other matrices")
            zero = fc.decoder_state_zero(B, dev, merged=True)
            plain = fc.decoder_merged_step_plain
            for seed in range(args.seeds):
                rng = np.random.default_rng(seed)
                sp = s64 = zero
                sk = {v: zero for v in forms}
                for call in range(args.chain):
                    x = torch.as_tensor(np.tanh(rng.standard_normal(
                        (B, nz, latent))).astype(np.float32), device=dev)
                    op, sp = plain(w, x, sp)
                    o64, s64 = plain_f64(plain, w, x, s64)
                    got = {}
                    for v, wv in forms.items():
                        ok_, sk[v] = fc.fused_decoder_step(wv, x, sk[v])
                        got[v] = (ok_,) + sk[v]
                    torch.cuda.synchronize()
                    want, exact = (op,) + sp, (o64,) + s64
                    same = all(torch.equal(a, b) for a, b in
                               zip(got["f32"], got["xsplit"]))
                    print(f"latent {latent} seed {seed} call {call}: plain f32 "
                          f"{tol_ratio(want, exact):.4f} of TOL from f64; "
                          + "; ".join(f"{v} {tol_ratio(g, want):.4f} from plain "
                                      f"f32, {tol_ratio(g, exact):.4f} from f64"
                                      for v, g in got.items())
                          + f"; the two the same bits: {same}", flush=True)
                    broke += [(latent, seed, call, v) for v, g in got.items()
                              if not tol_ratio(g, want) <= 1.0]
            rng = np.random.default_rng(100 + latent)
            x = torch.as_tensor(np.tanh(rng.standard_normal(
                (B, nz, latent))).astype(np.float32), device=dev)
            st = tuple(torch.as_tensor((0.5 * rng.standard_normal(
                tuple(s.shape))).astype(np.float32), device=dev) for s in zero)
            runs = {v: [] for v in forms}
            order = list(forms)
            for r in range(args.reps):
                for v in (order if r % 2 == 0 else order[::-1]):
                    runs[v] += graph_runs(
                        lambda wv=forms[v]: fc.fused_decoder_step(wv, x, st),
                        n=20, reps=1)
            print(f"latent {latent} B={B}, graph replays of 20 launches in "
                  f"turns, {args.reps} rounds: " + "; ".join(
                      f"{v} median {sorted(t)[len(t) // 2]:.4f} ms (min "
                      f"{min(t):.4f}, max {max(t):.4f})" for v, t in runs.items()),
                  flush=True)
    print(card)
    if broke:
        print(f"past TOL of the plain f32 step (latent, seed, call, form): "
              f"{broke}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
