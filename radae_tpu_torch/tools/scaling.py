"""Measured data-parallel scaling curves over torch.distributed ranks (port
of `radae_tpu/tools/scaling.py`).

radae_tpu measures a virtual CPU mesh: N jax devices in one process.  The
port measures what it runs: N processes in a torch.distributed group, one
rank a card over NCCL with `--device cuda` (the default; as many ranks as
there are cards), or Gloo processes on the CPU with `--device cpu`.

Measures the two data-parallel workloads the framework ships — the one-batch
eval forward (`parallel/trainstep.make_eval_step`, tools/evaluate.py's
grid as one batch) and the full training step (`make_train_step` with the
group) — at a fixed global batch (strong scaling) or a fixed batch a rank
(`--weak`), over 1/2/4/8 ranks.  Each rank keeps its rows of the global
batch (`parallel/mesh.shard_batch`) and draws the global batch's noise
(`ops.draws.BatchRows`), so `loss0`, the global batch's mean eval loss, is
the same whatever the number of ranks.  Timing is the two-point slope
method (see bench.py) on the host's clock, each run ending when its device
work has; rank 0's times are reported.

    python -m radae_tpu_torch.tools.scaling [--device cpu] [--weak]
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np

ROW_TAG = "SCALING_ROW "


def _slope(call, n1=1, n2=3, reps=3):
    """Median two-point slope of n chained calls; call(n) runs n calls and
    waits for their device work."""
    dts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        call(n1)
        t1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        call(n2)
        t2 = time.perf_counter() - t0
        dts.append((t2 - t1) / (n2 - n1))
    return float(np.median(dts))


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def worker(rank: int, world: int, init_method: str, device: str, B: int,
           T: int, seed: int = 0, weak: bool = False, eval_reps: int = 3,
           train_reps: int = 5, threads: int = 0):
    """One rank's measurement: returns {devices, eval_s, train_s, loss0}.
    With world > 1 the rank joins the group at init_method (NCCL on the
    card cuda:rank, Gloo on the CPU) and leaves it at the end.  threads:
    torch's threads on the CPU (0: as they are)."""
    import torch
    import torch.distributed as dist
    from ..config import flagship_config
    from ..models.radae import RADAE
    from ..ops.draws import BatchRows
    from ..parallel.distributed import initialize
    from ..parallel.mesh import shard_batch
    from ..parallel.trainstep import (make_eval_step, make_train_step,
                                      step_generator)
    from ..runtime import f32_device

    cuda = torch.device(device).type == "cuda"
    if cuda:
        device = f"cuda:{rank}"
    elif threads:
        torch.set_num_threads(threads)
    dev = f32_device(device)
    group = None
    if world > 1:
        group = initialize("nccl" if cuda else "gloo", world, rank,
                           init_method, device=device if cuda else None)
    try:
        cfg = flagship_config(EbNodB=3.0, range_EbNo=True)
        model = RADAE(cfg, dev)
        params_host = model.init(0)
        rng = np.random.default_rng(seed)
        B_global = B * world if weak else B
        feats_all = (rng.standard_normal((B_global, T, cfg.feature_dim))
                     * 0.3).astype(np.float32)
        (feats,) = shard_batch((feats_all,), group)
        fb = torch.as_tensor(feats, device=dev)
        rows = feats.shape[0]

        def sync():
            if cuda:
                torch.cuda.synchronize(dev)

        def key(step):
            gen = step_generator(dev, seed, step)
            if group is None:
                return gen
            return BatchRows(gen, B_global, rank * rows, (rank + 1) * rows,
                             group)

        # ---- eval forward: per-row loss of the global batch ----
        eval_step = make_eval_step(model)
        losses = eval_step(params_host, fb, None, None, key(0))[0]  # (rows,)
        total = losses.sum().reshape(1)
        if group is not None:
            dist.all_reduce(total, group=group)
        loss0 = float(total[0]) / B_global

        def eval_call(n):
            out = None
            for i in range(n):
                out = eval_step(params_host, fb, None, None, key(1 + i))[0]
            sync()
            return out

        eval_call(1)
        eval_s = _slope(eval_call, reps=eval_reps)

        # ---- full train step ----
        init_state, tstep = make_train_step(model, group=group)

        def train_call(n):
            s = init_state(params_host)
            m = None
            for i in range(n):
                s, m = tstep(s, fb, None, None, seed)
            float(m["loss"][0])
            sync()

        train_call(1)
        train_s = _slope(train_call, n1=1, n2=5, reps=train_reps)
        return {"devices": world, "eval_s": eval_s, "train_s": train_s,
                "loss0": loss0}
    finally:
        if group is not None:
            dist.destroy_process_group()


def available(device: str) -> int:
    """The most ranks the device offers: the cards present, or the CPU's
    cores."""
    import torch
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return os.cpu_count() or 1


def measure_scaling(device_counts=(1, 2, 4, 8), B=32, T=120, seed=0,
                    weak=False, device="cuda", eval_reps=3, train_reps=5,
                    threads=0, timeout=1800):
    """Returns rows of {devices, eval_s, train_s, loss0}, one for each
    count of ranks up to what the device offers.

    weak=False: fixed GLOBAL batch B (strong scaling / overhead isolation).
    weak=True: B is the batch a rank; the global batch grows with the
    ranks, so flat time = perfect weak scaling.
    threads: torch's threads a CPU rank (0: the cores over the ranks).

    One rank runs in this process.  A larger count runs as that many
    fresh processes (`python -m radae_tpu_torch.tools.scaling --worker
    ...`), joined over tcp://127.0.0.1 on a free port; rank 0 reports the
    row."""
    from .. import resolve_device
    cuda = resolve_device(device).type == "cuda"
    most = available(device)
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    rows = []
    for nd in device_counts:
        if nd > most:
            break
        n_threads = threads or max(1, (os.cpu_count() or 1) // nd)
        if nd == 1:                 # one rank: this process, no group
            rows.append(worker(0, 1, "", device, B, T, seed, weak,
                               eval_reps, train_reps, n_threads))
            continue
        init = f"tcp://127.0.0.1:{_free_port()}"
        # a CPU rank's torch and BLAS threads (numpy draws the weights)
        env = dict(os.environ) if cuda else dict(
            os.environ, OMP_NUM_THREADS=str(n_threads))
        procs = [subprocess.Popen(
            [sys.executable, "-m", "radae_tpu_torch.tools.scaling",
             "--worker", json.dumps(dict(
                 rank=r, world=nd, init_method=init, device=device, B=B, T=T,
                 seed=seed, weak=weak, eval_reps=eval_reps,
                 train_reps=train_reps))], cwd=root, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(nd)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=timeout))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        for p, (_, err) in zip(procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"scaling worker of {nd} ranks exited "
                                   f"{p.returncode}: {err[-2000:]}")
        line = next(ln for ln in outs[0][0].splitlines()
                    if ln.startswith(ROW_TAG))
        rows.append(json.loads(line[len(ROW_TAG):]))
    return rows


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--seq", type=int, default=120)
    p.add_argument("--weak", action="store_true",
                   help="--batch is the batch a rank; the global batch "
                        "grows with the ranks (flat time = perfect weak "
                        "scaling)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda: one rank a card over "
                        "NCCL; cpu: Gloo processes on the host)")
    p.add_argument("--worker", help=argparse.SUPPRESS)  # a rank's settings
    args = p.parse_args(argv)
    if args.worker:
        kw = json.loads(args.worker)
        row = worker(**kw)
        if kw["rank"] == 0:
            print(ROW_TAG + json.dumps(row), flush=True)
        return 0
    rows = measure_scaling(B=args.batch, T=args.seq, weak=args.weak,
                           device=args.device)
    print_rows(rows, args.device)
    return 0


def print_rows(rows, device):
    """The rows as a table, each time also as a ratio to one rank's."""
    t1e, t1t = rows[0]["eval_s"], rows[0]["train_s"]
    print(f"{device}: {len(rows)} row(s), up to {rows[-1]['devices']} "
          f"rank(s) of {available(device)} available")
    print(f"{'ranks':>8} {'eval ms':>9} {'vs 1':>8} "
          f"{'train ms':>9} {'vs 1':>8} {'loss0':>10}")
    for r in rows:
        print(f"{r['devices']:>8} {1e3 * r['eval_s']:>9.1f} "
              f"{t1e / r['eval_s']:>8.2f} {1e3 * r['train_s']:>9.1f} "
              f"{t1t / r['train_s']:>8.2f} {r['loss0']:>10.6f}")


if __name__ == "__main__":
    sys.exit(main())
