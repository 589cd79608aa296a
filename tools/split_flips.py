#!/usr/bin/env python3
"""How often the split route's products flip a bf16 input, on the CPU.

    python3 tools/split_flips.py [--latent 80|40] [--batch 2048] [--seed 6]

The unmerged decoder and the encoder with bf16 products on f32 weights
multiply bf16 x by f32 w (kind 0).  Their split instances run that product
on the tensor cores as bf16 products on the parts of w (`fc.split_parts`:
hi = bf16(w), mid = bf16(w - hi), lo = bf16(w - hi - mid)).  This tool runs
the plain step (`decoder_step_plain`, `encoder_step_plain`) on the fixture
weights, 3 chained calls of one frame at --batch streams on inputs drawn
as chip_smoke.py draws them, once with its own products and once for each
route below, and counts the elements past chip_smoke.py's BF16_TOL against
the plain version (its BF16_FLIPS limit: 1e-3 of them) and the largest max
error of a tensor over its scale (BF16_MAX: 0.03):

  exact   x @ w summed in f64 and rounded once: a kernel without rounding
          error, flipping only where the plain version's f32 sums round;
  split2  x hi + x mid, two parts: |w - hi - mid| reaches 2^-17 |w|;
  split3  x hi + x mid + x lo, three parts: the split instances' route.

The split routes sum each 16-wide K step's products exactly and truncate
the step sum to f32 (as the tensor cores do once a step), then add it to an
f32 running sum (the kernel's order), for every matrix; the GRU matrices
are rounded at the product (kind 3) on every route.  Nothing here runs a
kernel: it sizes a route's rounding error, not its bits on a card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BF16_FLIPS, BF16_MAX, bf16_errs  # noqa: E402
from radae_tpu_torch.convert import load_checkpoint  # noqa: E402
from radae_tpu_torch.ops import fused_core as fc  # noqa: E402

BF = torch.bfloat16
ROUTES = ("exact", "split2", "split3")
CHECKPOINTS = {80: "model_fs_flagship.npz", 40: "model_l40.npz"}


def _trunc(v: torch.Tensor) -> torch.Tensor:
    """f64 values truncated (toward zero) to f32."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def route_products(w, route):
    """mm(x, j) = bf16(x) @ arrays[j] on the route: the kind-3 (GRU)
    matrices rounded to bf16, the kind-0 ones as `route` says."""
    ws = []
    for a, r in zip(w.arrays, fc._rounds(w, BF, "gru")):
        a = a.float()
        if a.dim() != 2 or r or route == "exact":
            ws.append([(fc._bf16(a) if r else a).double()])
        else:
            parts = fc.split_parts(a)
            ws.append([p.double() for p in parts[:int(route[-1])]])

    def mm(x, j):
        xb = fc._bf16(x).double()
        if route == "exact":
            return (xb @ ws[j][0]).float()
        d = torch.zeros((xb.shape[0], ws[j][0].shape[1]))
        for k in range(0, xb.shape[1], 16):
            d = d + _trunc(sum(xb[:, k:k + 16] @ p[k:k + 16] for p in ws[j]))
        return d
    return mm


def flips(side, w, batch, latent, seed):
    """route -> [elements past BF16_TOL, elements, largest max err / scale]
    over 3 chained calls from the zero state."""
    rng = np.random.default_rng(seed)
    zero = (fc.decoder_state_zero if side == "dec"
            else fc.encoder_state_zero)(batch, "cpu")
    st, sp = {r: zero for r in ROUTES}, zero
    out = {r: [0, 0, 0.0] for r in ROUTES}
    real = fc._products
    for _ in range(3):
        if side == "dec":
            x = torch.as_tensor(np.tanh(rng.standard_normal(
                (batch, 3, latent))).astype(np.float32))
            want, sp_new = fc.decoder_step_plain(w, x, sp, BF)
        else:
            x = torch.as_tensor((0.3 * rng.standard_normal(
                (batch, 12, 21))).astype(np.float32))
            want, sp_new = fc.encoder_step_plain(w, x, sp, 3, BF)
        for r in ROUTES:
            mm = route_products(w, r)
            fc._products = lambda *a, mm=mm, **k: mm
            try:
                got, st[r] = (fc.decoder_step_plain(w, x, st[r], BF)
                              if side == "dec" else
                              fc.encoder_step_plain(w, x, st[r], 3, BF))
            finally:
                fc._products = real
            for n_over, n, mx, _ in bf16_errs((got,) + st[r], (want,) + sp_new):
                out[r][0] += n_over
                out[r][1] += n
                out[r][2] = max(out[r][2], mx)
        sp = sp_new
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--latent", type=int, choices=sorted(CHECKPOINTS),
                    default=80)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=6)
    args = ap.parse_args(argv)
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           CHECKPOINTS[args.latent]))
    for side in ("dec", "enc"):
        w = (fc.decoder_weights(tree["decoder"], "cpu") if side == "dec"
             else fc.encoder_weights(tree["encoder"], "cpu"))
        res = flips(side, w, args.batch, args.latent, args.seed)
        base = res["exact"][0]
        for r, (n_over, n, mx) in res.items():
            print(f"{side} latent {args.latent} B={args.batch} {r}: {n_over} "
                  f"of {n} past the bf16 tolerance ({n_over / n:.3g}; limit "
                  f"{BF16_FLIPS}), {n_over / max(base, 1):.2f}x exact; largest "
                  f"max err {mx:.4f} of the scale (limit {BF16_MAX['']})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
