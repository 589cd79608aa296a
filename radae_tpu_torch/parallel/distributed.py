"""Multi-process data-parallel training with torch.distributed (the port's
counterpart of `radae_tpu/parallel/distributed.py`).

radae_tpu joins processes with `jax.distributed` and jits one SPMD program
over the global mesh.  The port runs one process per card in a process
group: NCCL between cards, Gloo on the CPU (the verification harness).
Nothing here discovers a cluster: the caller gives the group its address,
world size and rank (`torchrun` sets them in the environment, which
`tools/train.py` reads).

  * `initialize` joins the group;
  * `demo_worker`: a real RADAE train step on each rank's rows of a global
    batch, gradients averaged across the group; `tests/
    test_torch_distributed.py` runs two of these on the CPU and checks the
    loss trajectory against `demo_single_process` on the whole batch.

    python -m radae_tpu_torch.parallel.distributed <rank> <world> \\
        --steps 3 --init tcp://127.0.0.1:<port>

prints `LOSSES l1 l2 ...`.
"""

from __future__ import annotations

import numpy as np


def initialize(backend: str, world_size: int, rank: int, init_method: str,
               device=None):
    """Join the process group (backend "nccl" between cards, "gloo" on
    the CPU); device, for NCCL, is this rank's card ("cuda:i"; "cuda"
    keeps the current one).  Returns the group."""
    import torch
    import torch.distributed as dist
    if backend == "nccl" and device is not None and \
            torch.device(device).index is not None:
        torch.cuda.set_device(torch.device(device))
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    return dist.group.WORLD


def join_from_env(device):
    """Join the group torchrun describes in the environment (WORLD_SIZE,
    RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT): NCCL with this rank on
    the card cuda:LOCAL_RANK when `device` is a CUDA device, else Gloo.
    Returns (device, group, rank, world); without WORLD_SIZE above 1,
    (device, None, 0, 1)."""
    import os
    import torch
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1:
        return device, None, 0, 1
    rank = int(os.environ["RANK"])
    if torch.device(device).type == "cuda":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
        group = initialize("nccl", world, rank, "env://", device=device)
    else:
        group = initialize("gloo", world, rank, "env://")
    return device, group, rank, world


def _demo_problem(seed: int = 0, B_global: int = 16, T: int = 48):
    """The problem both demo regimes share: model, params and a global
    batch that is the same however many processes split it.  Rate Fs with
    multipath fading and quantization noise, so the split exercises the
    row draws (ops/draws.py) and the batch-wide multipath mean."""
    from ..channel.doppler import multipath_samples
    from ..config import RADAEConfig
    from ..models.radae import RADAE

    cfg = RADAEConfig(EbNodB=6.0, rate_Fs=True, pilots=True, pilot_eq=True,
                      eq_mean6=False, cyclic_prefix=0.004, bottleneck=3)
    model = RADAE(cfg, "cpu")
    params = model.init(seed)
    rng = np.random.default_rng(seed + 1)
    feats = (rng.standard_normal((B_global, T, cfg.feature_dim))
             .astype(np.float32) * 0.3)
    n_fs = cfg.num_timesteps_at_rate_Fs(cfg.num_timesteps_at_rate_Rs(T))
    _, G, gain = multipath_samples("mpp", cfg.Fs, cfg.Rs_dash, cfg.Nc,
                                   B_global * n_fs / cfg.Fs + 1, rng=rng)
    G = (gain * G[:B_global * n_fs]).reshape(B_global, n_fs, 2)
    return model, params, feats, G


def _run(model, params, feats, G, steps, group=None):
    from .trainstep import make_train_step
    init_state, train_step = make_train_step(model, lr=3e-4, group=group)
    state = init_state(params)
    losses = []
    for _ in range(steps):
        state, metrics = train_step(state, feats, None, G, 0)
        losses.append(float(metrics["loss"][0]))
    return losses


def demo_single_process(steps: int = 3, seed: int = 0) -> list[float]:
    """The reference trajectory: the whole batch in this process."""
    model, params, feats, G = _demo_problem(seed)
    return _run(model, params, feats, G, steps)


def demo_worker(rank: int, world: int, steps: int = 3,
                init_method: str = "tcp://127.0.0.1:29511",
                seed: int = 0) -> list[float]:
    """`steps` train steps on this rank's rows, gradients averaged over the
    group; returns the group's mean loss per step, which must equal
    demo_single_process's."""
    import torch.distributed as dist
    from .mesh import shard_batch

    group = initialize("gloo", world, rank, init_method)
    try:
        model, params, feats, G = _demo_problem(seed)
        feats, G = shard_batch((feats, G), group)
        return _run(model, params, feats, G, steps, group)
    finally:
        dist.destroy_process_group()


def _demo_main(argv=None):
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("rank", type=int)
    p.add_argument("world", type=int)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--init", default="tcp://127.0.0.1:29511")
    args = p.parse_args(argv)
    losses = demo_worker(args.rank, args.world, steps=args.steps,
                         init_method=args.init)
    print("LOSSES " + " ".join(f"{l:.8f}" for l in losses), flush=True)


if __name__ == "__main__":
    _demo_main()
