#!/usr/bin/env python3
"""How often the split route's products flip a bf16 input, on the CPU.

    python3 tools/split_flips.py [--kernel dec|enc|decm ...] [--pad]
                                 [--latent 80|40] [--batch 2048] [--seed 6]

The unmerged decoder (dec), the encoder (enc) and the chain-merged decoder
(decm) with bf16 products on f32 weights multiply bf16 x by f32 w (kind 0).
Their split instances run that product on the tensor cores as bf16
products on the parts of w (`fc.split_parts`: hi = bf16(w), mid = bf16(w -
hi), lo = bf16(w - hi - mid)).  This tool runs the plain step
(`decoder_step_plain`, `encoder_step_plain`, `decoder_merged_step_plain`)
on the fixture weights, 3 chained calls of one frame at --batch streams on
inputs drawn as chip_smoke.py draws them, once with its own products and
once for each route below, and counts the elements past chip_smoke.py's
BF16_TOL against the plain version (its BF16_FLIPS limit: 1e-3 of them)
and the largest max error of a tensor over its scale (BF16_MAX: 0.03):

  exact   x @ w summed in f64 and rounded once: a kernel without rounding
          error, flipping only where the plain version's f32 sums round;
  split2  x hi + x mid, two parts: |w - hi - mid| reaches 2^-17 |w|;
  split3  x hi + x mid + x lo, three parts: the split instances' route.

The split routes sum each 16-wide K step's products exactly and truncate
the step sum to f32 (as the tensor cores do once a step), then add it to an
f32 running sum (the kernel's order), for every matrix; the unmerged
decoder's and the encoder's GRU matrices are rounded at the product (kind
3) on every route, and the merged decoder rounds none (every matrix of
kind 0).  --kernel may be given more than once (default: dec and enc).
--pad holds the merged decoder's padded layout (merged="pad"): the plain
version runs on the padded weights and the routes on the merged ones, as
the kernel runs a padded matrix packed as its merged one, in K steps of
the merged rows.  Nothing here runs a kernel: it sizes a route's rounding
error, not its bits on a card.
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
# --kernel -> the rounding rule of its plain version (fc._rounds)
RULES = {"dec": "gru", "enc": "gru", "decm": "none"}


def _trunc(v: torch.Tensor) -> torch.Tensor:
    """f64 values truncated (toward zero) to f32."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def route_products(w, route, rule):
    """mm(x, j) = bf16(x) @ arrays[j] on the route: the matrices that
    `fc._rounds(w, bf16, rule)` names rounded to bf16, the kind-0 ones as
    `route` says."""
    ws = []
    for a, r in zip(w.arrays, fc._rounds(w, BF, rule)):
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


def _step(side, w, x, state):
    """One call of the kernel's plain version with bf16 products."""
    if side == "enc":
        return fc.encoder_step_plain(w, x, state, 3, BF)
    if side == "dec":
        return fc.decoder_step_plain(w, x, state, BF)
    return fc.decoder_merged_step_plain(w, x, state, BF)


def flips(side, w, batch, latent, seed, w_route=None):
    """route -> [elements past BF16_TOL, elements, largest max err / scale]
    over 3 chained calls from the zero state; the routes run on w_route's
    weights (w's by default)."""
    w_route = w if w_route is None else w_route
    rng = np.random.default_rng(seed)
    zero = (fc.encoder_state_zero(batch, "cpu") if side == "enc" else
            fc.decoder_state_zero(batch, "cpu", merged=side == "decm"))
    st, sp = {r: zero for r in ROUTES}, zero
    out = {r: [0, 0, 0.0] for r in ROUTES}
    real = fc._products
    for _ in range(3):
        if side == "enc":
            x = torch.as_tensor((0.3 * rng.standard_normal(
                (batch, 12, 21))).astype(np.float32))
        else:
            x = torch.as_tensor(np.tanh(rng.standard_normal(
                (batch, 3, latent))).astype(np.float32))
        want, sp_new = _step(side, w, x, sp)
        for r in ROUTES:
            mm = route_products(w_route, r, RULES[side])
            fc._products = lambda *a, mm=mm, **k: mm
            try:
                got, st[r] = _step(side, w_route, x, st[r])
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
    ap.add_argument("--kernel", choices=sorted(RULES), action="append",
                    help="the kernel's plain version (default: dec and enc)")
    ap.add_argument("--pad", action="store_true",
                    help="decm: the padded layout (merged=\"pad\")")
    ap.add_argument("--latent", type=int, choices=sorted(CHECKPOINTS),
                    default=80)
    ap.add_argument("--batch", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=6)
    args = ap.parse_args(argv)
    sides = args.kernel or ["dec", "enc"]
    if args.pad and sides != ["decm"]:
        ap.error("--pad is the merged decoder's layout: --kernel decm")
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           CHECKPOINTS[args.latent]))
    for side in sides:
        w_route = None
        if side == "enc":
            w = fc.encoder_weights(tree["encoder"], "cpu")
        elif side == "dec":
            w = fc.decoder_weights(tree["decoder"], "cpu")
        else:
            w = fc.decoder_weights(tree["decoder"], "cpu",
                                   merged="pad" if args.pad else True)
            w_route = fc.decoder_weights(tree["decoder"], "cpu", merged=True)
        res = flips(side, w, args.batch, args.latent, args.seed, w_route)
        base = res["exact"][0]
        name = side + (" pad" if args.pad else "")
        for r, (n_over, n, mx) in res.items():
            print(f"{name} latent {args.latent} B={args.batch} {r}: {n_over} "
                  f"of {n} past the bf16 tolerance ({n_over / n:.3g}; limit "
                  f"{BF16_FLIPS}), {n_over / max(base, 1):.2f}x exact; largest "
                  f"max err {mx:.4f} of the scale (limit {BF16_MAX['']})",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
