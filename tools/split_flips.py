#!/usr/bin/env python3
"""How often the split route's products flip a bf16 input, on the CPU; and
how far the f32-product route on int8 weights is from the f32 tolerance.

    python3 tools/split_flips.py [--kernel dec|enc|decm ...] [--pad]
                                 [--latent 80|40] [--batch 2048] [--seed 6]
                                 [--seeds 1] [--quant int8 [--mixed] | none]

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

--quant int8 (--kernel dec, enc or decm, the last in either layout) sizes
the int8 instances with f32 products instead: radae_tpu multiplies the f32
x by the int8 matrix q as f32 (then the column scale), and the kernel runs
x @ q on the tensor cores as bf16 products of x's parts (`x_parts`:
hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi - mid)) and q widened to
bf16 (exact).  Against the plain int8 step (f32 products) it prints, per
route, the largest |err| / (atol + rtol |want|) of chip_smoke.py's TOL over
every tensor of 3 chained calls and --seeds seeds (1 or less: within TOL),
and the elements past TOL:

  exact      x @ q summed in f64 and rounded once;
  xsplit2    x hi + x mid, two parts (the remainder reaches 2^-18 |x|);
  xsplit3    x hi + x mid + x lo, three parts: the kernel's route; a
             matrix that quant_exclude keeps in f32 (--mixed: chip_smoke.py's
             MIXED set of the kernel's int8 form: the merged decoder's wgg,
             the unmerged decoder's whh and out_w, the encoder's whh and
             d1_w) as the six products of x's and w's parts
             (`fc.split_parts`) at or above 2^-18 of hi hi;
  xsplit3w9  the same with all nine products on such a matrix;
  xsplit3s   xsplit3 with x hi's products summed apart: the encoder's
             route (XS_SEP: the step's x hi w sum and the rest's each
             truncated to f32, then added in f32).

Each 16-wide K step's products are summed exactly and truncated to f32,
then added to an f32 running sum, as on the bf16 routes.

--quant none (--kernel decm, either layout) sizes the same routes on the
f32 weights against the plain f32 step: the padded f32 form's instance
runs every matrix as the six products of x's and w's parts (xsplit3), as
the int8 instance runs a matrix kept in f32.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import BF16_FLIPS, BF16_MAX, MIXED, TOL, bf16_errs  # noqa: E402
from radae_tpu_torch.convert import load_checkpoint  # noqa: E402
from radae_tpu_torch.ops import fused_core as fc  # noqa: E402

BF = torch.bfloat16
ROUTES = ("exact", "split2", "split3")
QROUTES = ("exact", "xsplit2", "xsplit3", "xsplit3w9", "xsplit3s")
# the (x part, w part) products of a K step on the f32-product routes:
# against an int8 matrix (one w part) and against one kept in f32 (three)
XPAIRS = {"xsplit2": ([(1, 0), (0, 0)],
                      [(1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]),
          "xsplit3": ([(2, 0), (1, 0), (0, 0)],
                      [(2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0)]),
          "xsplit3w9": ([(2, 0), (1, 0), (0, 0)],
                        [(i, k) for i in range(3) for k in range(3)])}
XPAIRS["xsplit3s"] = XPAIRS["xsplit3"]
CHECKPOINTS = {80: "model_fs_flagship.npz", 40: "model_l40.npz"}
# --kernel -> the rounding rule of its plain version (fc._rounds)
RULES = {"dec": "gru", "enc": "gru", "decm": "none"}


def _trunc(v: torch.Tensor) -> torch.Tensor:
    """f64 values truncated (toward zero) to f32."""
    r = v.float()
    return torch.where(r.double().abs() > v.abs(),
                       torch.nextafter(r, torch.zeros_like(r)), r)


def x_parts(x, n=3):
    """x's first n bf16 parts (hi, mid, lo), each rounded to nearest even
    from what the parts before it leave (every remainder exact in f32)."""
    parts, r = [], x.float()
    for _ in range(n):
        parts.append(fc._bf16(r))
        r = r - parts[-1]
    return parts


def _wsteps(a):
    """A (K, out) matrix as f64 K steps (ceil(K/16), 16, out), zero rows
    past K."""
    K = a.shape[0]
    a = torch.nn.functional.pad(a.double(), (0, 0, 0, -K % 16))
    return a.reshape(-1, 16, a.shape[1])


def _steps(pairs, xs, ws, sep=False):
    """sum over (i, k) in pairs of xs[i] @ ws[k] (ws as `_wsteps`) for each
    16-wide K step, in f64, truncated to f32 (the tensor cores' one
    truncation a step), then added in f32 in K order.  (The x parts that
    meet one w part are added first: exact in f64.)  sep: the last pair's
    (x hi w hi's) step sum truncated apart and added to the rest's in f32
    before the running sum."""
    B, K = xs[0].shape

    def step_sums(prs):                                  # (steps, B, out)
        xw = {}
        for i, k in prs:
            xw[k] = xw.get(k, 0) + xs[i].double()
        return _trunc(sum(torch.bmm(torch.nn.functional.pad(x, (0, -K % 16))
                                    .reshape(B, -1, 16).transpose(0, 1), ws[k])
                          for k, x in xw.items()))
    s = (step_sums(pairs[:-1]) + step_sums(pairs[-1:]) if sep
         else step_sums(pairs))
    d = torch.zeros((B, s.shape[-1]))
    for k in range(s.shape[0]):
        d = d + s[k]
    return d


def xroute_products(w, route):
    """mm(x, j) = x @ arrays[j] times its scale row (none on f32 weights),
    as the instances with f32 products compute it on `route` (QROUTES):
    each int8 matrix as one w part, each f32 one as three."""
    sc = iter(w.scales)
    scale = [(next(sc) if w.scales else 1.0) if a.dim() == 2 else None
             for a in w.arrays]
    ws = [None if a.dim() != 2 else [_wsteps(a)] if a.dtype == torch.int8
          else [_wsteps(p) for p in fc.split_parts(a)] for a in w.arrays]

    def mm(x, j):
        if route == "exact":
            return (x.double() @ w.arrays[j].double()).float() * scale[j]
        pairs = XPAIRS[route][len(ws[j]) > 1]
        return _steps(pairs, x_parts(x), ws[j],
                      route == "xsplit3s") * scale[j]
    return mm


def route_products(w, route, rule):
    """mm(x, j) = bf16(x) @ arrays[j] on the route: the matrices that
    `fc._rounds(w, bf16, rule)` names rounded to bf16, the kind-0 ones as
    `route` says."""
    ws = []
    for a, r in zip(w.arrays, fc._rounds(w, BF, rule)):
        a = a.float()
        if a.dim() != 2 or route == "exact":
            ws.append([(fc._bf16(a) if r else a).double()])
        elif r:
            ws.append([_wsteps(fc._bf16(a))])
        else:
            ws.append([_wsteps(p) for p in fc.split_parts(a)[:int(route[-1])]])

    def mm(x, j):
        if route == "exact":
            return (fc._bf16(x).double() @ ws[j][0]).float()
        return _steps([(0, k) for k in range(len(ws[j]))], [fc._bf16(x)], ws[j])
    return mm


def _step(side, w, x, state, cd=BF):
    """One call of the kernel's plain version with products of type cd."""
    if side == "enc":
        return fc.encoder_step_plain(w, x, state, 3, cd)
    if side == "dec":
        return fc.decoder_step_plain(w, x, state, cd)
    return fc.decoder_merged_step_plain(w, x, state, cd)


def tol_ratio(got, want):
    """(the largest |got - want| / (atol + rtol |want|) of TOL, elements past
    TOL) of one tensor."""
    r = (got - want).abs() / (TOL["atol"] + TOL["rtol"] * want.abs())
    return float(r.max()), int((r > 1).sum())


def flips(side, w, batch, latent, seed, w_route=None, quant=False):
    """route -> [elements past BF16_TOL, elements, largest max err / scale]
    over 3 chained calls from the zero state; the routes run on w_route's
    weights (w's by default).  quant (int8 weights, f32 products): route
    -> [elements past TOL, elements, largest tol_ratio] over QROUTES."""
    w_route = w if w_route is None else w_route
    routes = QROUTES if quant else ROUTES
    cd = torch.float32 if quant else BF
    rng = np.random.default_rng(seed)
    zero = (fc.encoder_state_zero(batch, "cpu") if side == "enc" else
            fc.decoder_state_zero(batch, "cpu", merged=side == "decm"))
    st, sp = {r: zero for r in routes}, zero
    out = {r: [0, 0, 0.0] for r in routes}
    real = fc._products
    for _ in range(3):
        if side == "enc":
            x = torch.as_tensor((0.3 * rng.standard_normal(
                (batch, 12, 21))).astype(np.float32))
        else:
            x = torch.as_tensor(np.tanh(rng.standard_normal(
                (batch, 3, latent))).astype(np.float32))
        want, sp_new = _step(side, w, x, sp, cd)
        for r in routes:
            mm = (xroute_products(w_route, r) if quant
                  else route_products(w_route, r, RULES[side]))
            fc._products = lambda *a, mm=mm, **k: mm
            try:
                got, st[r] = _step(side, w_route, x, st[r], cd)
            finally:
                fc._products = real
            for g, wt in zip((got,) + st[r], (want,) + sp_new):
                if quant:
                    mx, n_over = tol_ratio(g, wt)
                else:
                    n_over, _, mx, _ = bf16_errs((g,), (wt,))[0]
                out[r][0] += n_over
                out[r][1] += g.numel()
                out[r][2] = max(out[r][2], mx)
        sp = sp_new
    return out


# --kernel -> its int8 form (the key of chip_smoke.py's MIXED)
INT8_FORMS = {"dec": "fused_decoder_step_int8",
              "enc": "fused_encoder_step_int8",
              "decm": "fused_decoder_merged_step_int8"}


def int8_sets(tree, side, pad=False, mixed=False, quant="int8"):
    """(the int8 weights of the kernel's plain version, the weights its
    route runs on) for --kernel side: the chain-merged decoder's route runs a
    padded set (pad) on the merged one, as the kernel does; mixed: the
    kernel's MIXED set (quant_exclude); quant None: the f32 set."""
    kw = dict(quant=quant,
              quant_exclude=MIXED[INT8_FORMS[side]] if mixed else ())
    if side == "enc":
        w = fc.encoder_weights(tree["encoder"], "cpu", **kw)
        return w, w
    if side == "dec":
        w = fc.decoder_weights(tree["decoder"], "cpu", **kw)
        return w, w
    return (fc.decoder_weights(tree["decoder"], "cpu",
                               merged="pad" if pad else True, **kw),
            fc.decoder_weights(tree["decoder"], "cpu", merged=True, **kw))


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
    ap.add_argument("--seeds", type=int, default=1,
                    help="--quant int8: seeds --seed.. summed over")
    ap.add_argument("--quant", choices=["int8", "none"], default=None,
                    help="int8 weights with f32 products (QROUTES); none: "
                    "decm's f32 weights on the same routes")
    ap.add_argument("--mixed", action="store_true",
                    help="--quant int8: chip_smoke.py's MIXED set of the "
                    "kernel's int8 form")
    args = ap.parse_args(argv)
    sides = args.kernel or ["dec", "enc"]
    if args.pad and sides != ["decm"]:
        ap.error("--pad is the merged decoder's layout: --kernel decm")
    if args.mixed and args.quant != "int8":
        ap.error("--mixed is an int8 set: --quant int8")
    if args.quant == "none" and sides != ["decm"]:
        ap.error("--quant none sizes the merged decoder's f32 form: --kernel "
                 "decm")
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           CHECKPOINTS[args.latent]))
    if args.quant:
        for side in sides:
            w, w_route = int8_sets(tree, side, args.pad, args.mixed,
                                   None if args.quant == "none" else "int8")
            tot = {r: [0, 0, 0.0] for r in QROUTES}
            for seed in range(args.seed, args.seed + args.seeds):
                for r, (n_over, n, mx) in flips(side, w, args.batch,
                                                args.latent, seed, w_route,
                                                quant=True).items():
                    tot[r] = [tot[r][0] + n_over, tot[r][1] + n,
                              max(tot[r][2], mx)]
            name = (side + (" pad" if args.pad else "")
                    + (" f32" if args.quant == "none" else " int8")
                    + (" mixed" if args.mixed else ""))
            for r, (n_over, n, mx) in tot.items():
                print(f"{name} latent {args.latent} B={args.batch} seeds "
                      f"{args.seed}..{args.seed + args.seeds - 1} {r}: largest "
                      f"|err| / (atol + rtol |want|) {mx:.4f} (TOL {TOL}: 1), "
                      f"{n_over} of {n} past TOL", flush=True)
        return 0
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
