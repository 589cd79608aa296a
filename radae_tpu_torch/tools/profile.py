"""Performance characterisation harness (port of
`radae_tpu/tools/profile.py`).

Equivalent of the reference's cProfile/%-CPU performance ctests
(reference: CMakeLists.txt:420-458, README.md:312-331): per-stage
steady-state timings (the two-point slope method, see bench.py) for the
streaming rx step and the training step, plus an optional torch.profiler
trace for the kernel-level view, with the program's spans and counters
(radae_tpu_torch/trace.py) read from the traced steps.

Everything runs on `--device` (default cuda; refused without a card) and
is timed by CUDA events on a card, by time.perf_counter on the CPU; the
parameters reach the device in one copy (`utils.hostio.device_put_tree`).
The rx step is the plain composite step (`runtime.make_streaming_rx_step`,
fused=False), as radae_tpu's is; on a card its front end is one launch of
the rx front end's kernel (`ops.ofdm.rx_front_end`).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

ROWS = ("forward only (loss)", "encoder fwd+bwd", "decoder fwd+bwd",
        "enc+dec, no channel", "full fwd+bwd (grad)", "full step (+Adam)")


def _elapsed(fn, device) -> float:
    """Seconds from fn()'s start to the end of its device work: CUDA
    events on a card, time.perf_counter on the CPU."""
    if device.type == "cuda":
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        torch.cuda.synchronize(device)
        return t0.elapsed_time(t1) / 1e3
    t = time.perf_counter()
    fn()
    return time.perf_counter() - t


def _slope(fn, mkstate, n1=20, n2=100, device=torch.device("cpu")):
    """(time of fn(n2, state) - time of fn(n1, state)) / (n2 - n1), each on
    a fresh state: the steady-state time of one of fn's iterations."""
    t = {}
    for n in (n1, n2):
        state = mkstate()
        t[n] = _elapsed(lambda: fn(n, state), device)
    return (t[n2] - t[n1]) / (n2 - n1)


def train_breakdown(batches, T=240, remat=False, scan=8,
                    n1=2, n2=8, slopes=3, device="cuda"):
    """Per-component training-step timings.

    Decomposes the train step into encoder fwd+bwd, decoder fwd+bwd,
    autoencoder-without-channel, full grad, and full step (+Adam), each
    timed on its own, so the channel-sim cost and the optimizer cost fall
    out by subtraction.  A timed call runs `scan` chained iterations (each
    consumes the previous one's scalar, keeping them strictly sequential on
    the device), and the per-iteration time is the median of `slopes`
    two-point slopes (radae_tpu's method, whose `scan` iterations run in one
    lax.scan).  Returns one row a batch size: {"B": B, name: seconds an
    iteration} under the names of ROWS."""
    from ..config import flagship_config
    from ..models.core import distortion_loss
    from ..models.radae import RADAE, tree_leaves
    from ..parallel.trainstep import leaf_tree, make_train_step, step_generator
    from ..runtime import f32_device
    from ..utils.hostio import device_put_tree

    if T % 12:
        raise ValueError(f"T={T}: need whole modem frames (12 x 10 ms)")
    dev = f32_device(device)
    cfg = flagship_config(EbNodB=3.0, range_EbNo=True)
    model = RADAE(cfg, dev)
    params_host = model.init(0)
    rng = np.random.default_rng(0)
    Tz = T // 4

    def key():
        # radae_tpu's fixed key: the same draws every call
        return step_generator(dev, 0, 0)

    def full_loss(params, feats):
        out = model.forward(params, feats, None, None, key=key())
        return distortion_loss(feats, out["features_hat"]).mean()

    def nochan_loss(params, feats):
        z, _ = model.core_encoder(params["encoder"], feats)
        fh, _ = model.core_decoder(params["decoder"], z)
        return distortion_loss(feats, fh).mean()

    def enc_loss(params, feats):
        z, _ = model.core_encoder(params["encoder"], feats)
        return (z ** 2).mean()

    def timed(chain, mkstate, per_call_iters):
        dts = [_slope(chain, mkstate, n1=n1, n2=n2, device=dev)
               for _ in range(slopes)]
        return float(np.median(dts)) / per_call_iters

    def zero():
        return torch.zeros((), device=dev)

    rows = []
    for B in batches:
        params = leaf_tree(device_put_tree(params_host, dev), dev)
        leaves = list(tree_leaves(params))
        feats = torch.as_tensor(
            (rng.standard_normal((B, T, 21)) * 0.3).astype(np.float32),
            device=dev)
        z_hat = torch.as_tensor(
            rng.standard_normal((B, Tz, cfg.latent_dim)).astype(np.float32),
            device=dev)

        def dec_loss(params, feats, z_hat=z_hat):
            fh, _ = model.core_decoder(params["decoder"], z_hat)
            return distortion_loss(feats, fh).mean()

        def grad_norm(loss_fn):
            def f(params, feats):
                g = torch.autograd.grad(loss_fn(params, feats), leaves,
                                        allow_unused=True)
                return sum((x ** 2).sum() for x in g if x is not None)
            return f

        def forward_only(params, feats):
            with torch.no_grad():
                return full_loss(params, feats)

        variants = [
            (ROWS[0], forward_only),
            (ROWS[1], grad_norm(enc_loss)),
            (ROWS[2], grad_norm(dec_loss)),
            (ROWS[3], grad_norm(nochan_loss)),
            (ROWS[4], grad_norm(full_loss)),
        ]
        row = {"B": B}
        for name, fn in variants:
            def chain(n, l, fn=fn):
                for _ in range(n * scan):
                    l = fn(params, feats + 0.0 * l.detach())
                return l

            chain(1, zero())                    # warm up
            row[name] = timed(chain, zero, scan)

        # full step incl. the Adam update (a fresh state for each run)
        init_state, tstep = make_train_step(model, remat=remat)

        def tchain(n, state):
            metrics = None
            for _ in range(n * scan):
                state, metrics = tstep(state, feats, None, None, 0)
            return metrics["loss"]

        tchain(1, init_state(params_host))      # warm up
        row[ROWS[5]] = timed(tchain, lambda: init_state(params_host), scan)
        rows.append(row)

    names = [k for k in rows[0] if k != "B"]
    print(f"\ntraining-step breakdown (T={T} frames = {T*0.01:.1f} s audio"
          f"{', remat' if remat else ''}); ms/step:")
    print(f"{'component':>22} " + " ".join(f"B={r['B']:>5}" for r in rows))
    for name in names:
        print(f"{name:>22} " + " ".join(f"{r[name]*1e3:7.1f}" for r in rows))
    chan = [(r["full fwd+bwd (grad)"] - r["enc+dec, no channel"]) * 1e3
            for r in rows]
    print(f"{'-> channel sim (diff)':>22} " + " ".join(f"{c:7.1f}" for c in chan))
    thr = [r["B"] * T * 0.01 / r["full step (+Adam)"] for r in rows]
    print(f"{'audio-s/s training':>22} " + " ".join(f"{t:7,.0f}" for t in thr))
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=1024)
    p.add_argument("--trace", type=str, default="",
                   help="write a torch.profiler trace of 10 rx steps to "
                        "this directory")
    p.add_argument("--train", action="store_true",
                   help="also profile the training step")
    p.add_argument("--train-breakdown", type=str, default="",
                   help="comma-separated batch sizes, e.g. 32,128,512: "
                        "per-component training-step timing table")
    p.add_argument("--remat", action="store_true",
                   help="remat in the breakdown's full step")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu runs on the host)")
    args = p.parse_args(argv)

    from ..runtime import f32_device
    dev = f32_device(args.device)
    if args.train_breakdown:
        train_breakdown([int(b) for b in args.train_breakdown.split(",")],
                        remat=args.remat, device=dev)
        if not (args.train or args.trace):
            return

    from ..config import flagship_config
    from ..models.core import CoreDecoder
    from ..runtime import make_streaming_rx_step
    from ..utils.hostio import device_put_tree

    cfg = flagship_config()
    B = args.batch
    decoder = CoreDecoder(cfg.latent_dim, cfg.feature_dim)
    dp = device_put_tree(decoder.init(1), dev)
    rng = np.random.default_rng(0)
    rx = torch.as_tensor(rng.standard_normal(
        (B, cfg.Nmf + cfg.M + cfg.Ncp, 2)).astype(np.float32), device=dev)

    step = make_streaming_rx_step(cfg, decoder, B, fused=False, device=dev)

    def chain(n, state):
        f = None
        for _ in range(n):
            f, state = step(dp, rx, state)
        return f

    with torch.no_grad():
        chain(1, decoder.zero_state(B, dev))
        dt = _slope(chain, lambda: decoder.zero_state(B, dev), device=dev)
    print(f"streaming rx step B={B}: {dt*1e3:.3f} ms/frame "
          f"-> {B*cfg.Tmf/dt:,.0f} audio-seconds/s/card")

    if args.train:
        from ..models.radae import RADAE
        from ..parallel.trainstep import make_train_step
        model = RADAE(flagship_config(EbNodB=3.0, range_EbNo=True), dev)
        params = model.init(0)
        init_state, tstep = make_train_step(model)
        Bt, T = 32, 240
        feats = torch.as_tensor(
            (rng.standard_normal((Bt, T, 21)) * 0.3).astype(np.float32),
            device=dev)
        tstep(init_state(device_put_tree(params, dev)), feats, None, None, 0)

        def tchain(n, state):
            metrics = None
            for _ in range(n):
                state, metrics = tstep(state, feats, None, None, 0)
            return metrics["loss"]

        # a fresh TrainState for each timing run: the step updates its
        # state in place
        dt = _slope(tchain, lambda: init_state(device_put_tree(params, dev)),
                    n1=10, n2=40, device=dev)
        print(f"train step B={Bt} T={T}: {dt*1e3:.1f} ms "
              f"-> {Bt*T*0.01/dt:,.0f} audio-seconds/s training")

    if args.trace:
        from torch.profiler import ProfilerActivity, profile
        from .. import trace
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        os.makedirs(args.trace, exist_ok=True)
        trace.reset()
        with torch.no_grad(), profile(activities=acts) as prof:
            chain(10, decoder.zero_state(B, dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        print_spans(trace.spans(), prof, trace.COUNTERS)
        path = os.path.join(args.trace, "rx_step_trace.json")
        prof.export_chrome_trace(path)
        print(f"trace written to {path}", file=sys.stderr)


def print_spans(spans, prof, counters):
    """The traced steps' spans (radae_tpu_torch/trace.py): each name's
    count and mean host ms, card ms between its CUDA events (the spans
    given a device) and device ms of the operations launched inside it
    (the profiler's events, joined by correlation id; "-" off the card);
    the mean offset of a span's start from its range's in the profiler's
    events (their shared clock); the counters not at 0."""
    import bisect

    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    starts, launch, device = {}, {}, []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if e.name() in by_name:
                starts.setdefault(e.name(), []).append(e.start_ns())
            elif e.correlation_id() and e.name().startswith("cu"):
                # a CUDA API call (cuda*, cu*): a launch or a copy
                launch[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation():
            device.append((e.correlation_id(), 1e-6 * e.duration_ns()))
    ran = sorted((launch[c], ms) for c, ms in device if c in launch)
    at = [t for t, _ in ran]
    cum = [0.0]
    for _, ms in ran:
        cum.append(cum[-1] + ms)

    def launched(s):
        return (cum[bisect.bisect_right(at, s.t1_ns)]
                - cum[bisect.bisect_left(at, s.t0_ns)])

    print(f"\n{'span':>24} {'n':>4} {'host ms':>9} {'card ms':>9} "
          f"{'dev ms':>9}")
    offsets = []
    for name, ss in by_name.items():
        card = [s.card_ms for s in ss if s.card_ms is not None]
        dev = sum(launched(s) for s in ss) / len(ss)
        print(f"{name:>24} {len(ss):>4} "
              f"{sum(s.host_ms for s in ss) / len(ss):9.4f} "
              + (f"{sum(card) / len(card):9.4f} " if card else f"{'-':>9} ")
              + (f"{dev:9.4f}" if ran else f"{'-':>9}"))
        if len(starts.get(name, ())) == len(ss):
            offsets += [s.t0_ns - t for s, t in zip(
                sorted(ss, key=lambda s: s.t0_ns), sorted(starts[name]))]
    if offsets:
        print(f"span start - profiler range start: mean "
              f"{1e-3 * sum(offsets) / len(offsets):.2f} us over "
              f"{len(offsets)} spans")
    for family, counts in counters.items():
        kept = {k: v for k, v in counts.items() if v}
        if kept:
            print(f"{family}: {kept}")

if __name__ == "__main__":
    main()
