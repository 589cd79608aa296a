"""Experiment: gradient-train low-PAPR pilot sequences (port of
`radae_tpu/tools/ml_pilots.py`).

Pilots are trainable complex carrier amplitudes; the pipeline is
IDFT -> tanh PA clamp -> AWGN -> correlation detector, with loss
-sum(Dt) + 0.1*std|P| to maximise the detector peak while keeping pilot
power flat (reference: ml_pilots.py:65-128).  Split-complex torch through
autograd, plain SGD (`torch.optim.SGD`, radae_tpu's optax.sgd), on
`--device` (default cuda; refused without a card).

Each step's AWGN comes from a torch.Generator seeded from (epoch, batch +
seed) (`parallel.trainstep.step_generator`), as radae_tpu keys its draw
with [epoch, b + seed]; the draw goes
through `normal`, one function so that a test can give both packages the
same draws.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .. import resolve_device
from ..config import RADAEConfig
from ..ops import draws
from ..ops.cplx import C
from ..parallel.trainstep import step_generator


def normal(gen, shape) -> torch.Tensor:
    """The channel's N(0, 1) draw on gen's device (radae_tpu's
    jax.random.normal of one half of the step's key)."""
    return draws.randn(gen, shape)


def train_pilots(EsNodB=10.0, lr=1e-3, epochs=100, batches=10,
                 latent_dim=40, seed=0, verbose=False, device="cuda"):
    dev = resolve_device(device)
    cfg = RADAEConfig(latent_dim=latent_dim, EbNodB=100, rate_Fs=True,
                      pilots=True, cyclic_prefix=0.004)
    Nc, M, Fs, Rb = cfg.Nc, cfg.M, cfg.Fs, cfg.Rb
    Wr = torch.as_tensor(np.ascontiguousarray(
        cfg.Winv.real.astype(np.float32)), device=dev)
    Wi = torch.as_tensor(np.ascontiguousarray(
        cfg.Winv.imag.astype(np.float32)), device=dev)

    S = 1.0
    EsNo = 10 ** (EsNodB / 10)
    sigma = float(np.sqrt(S * Fs / (EsNo * Rb)))

    rng = np.random.default_rng(seed)
    params = {"Pr": rng.standard_normal(Nc).astype(np.float32),
              "Pi": rng.standard_normal(Nc).astype(np.float32)}
    leaves = {k: torch.tensor(v, device=dev, requires_grad=True)
              for k, v in params.items()}

    def forward(gen):
        P = C(leaves["Pr"], leaves["Pi"])
        scaled = P * (M / np.sqrt(Nc))
        p = C(scaled.re @ Wr - scaled.im @ Wi,
              scaled.re @ Wi + scaled.im @ Wr)            # (M,)
        # PA clamp
        r = torch.sqrt(p.abs2() + 1e-12)
        tx = p * (torch.tanh(r) / r)
        n = C(sigma / np.sqrt(2) * normal(gen, (M,)),
              sigma / np.sqrt(2) * normal(gen, (M,)))
        rx = tx + n
        Dt = (rx.conj() * tx)
        Dt_sum = C(Dt.re.sum(), Dt.im.sum()) * (1.0 / (Nc * M))
        return torch.sqrt(Dt_sum.abs2()), torch.sqrt(P.abs2())

    opt = torch.optim.SGD(list(leaves.values()), lr=lr)
    for epoch in range(epochs):
        total = 0.0
        for b in range(batches):
            opt.zero_grad(set_to_none=True)
            Dt, Pabs = forward(step_generator(dev, epoch, b + seed))
            loss = -Dt + 0.1 * torch.std(Pabs, correction=0)
            loss.backward()
            opt.step()
            total += float(loss.detach())
        if verbose and (epoch % 10 == 0 or epoch == epochs - 1):
            print(f"Epoch {epoch+1:5d} | loss {total/batches:.6f}",
                  file=sys.stderr)

    # report trained pilot stats
    params = {k: v.detach().cpu().numpy() for k, v in leaves.items()}
    P = params["Pr"] + 1j * params["Pi"]
    p = (P * M / np.sqrt(Nc)) @ cfg.Winv
    papr = 20 * np.log10(np.abs(p).max() /
                         np.sqrt(np.mean(np.abs(p) ** 2)))
    return params, papr


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--EsNodB", type=float, default=10.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--out", type=str, default="")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; cpu trains on the host)")
    args = p.parse_args(argv)
    params, papr = train_pilots(args.EsNodB, args.lr, args.epochs,
                                verbose=True, device=args.device)
    print(f"trained pilot PAPR: {papr:5.2f} dB")
    if args.out:
        (params["Pr"] + 1j * params["Pi"]).astype(np.complex64).tofile(args.out)


if __name__ == "__main__":
    main()
