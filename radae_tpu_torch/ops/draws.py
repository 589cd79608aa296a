"""The model's random draws, for a whole batch or for this process's rows
of one.

Every draw of `RADAE.forward` (the Eb/No, the quantization noise, the
BER-test bits, the channel's phase, frequency, gain and Gaussian noise) has
the batch as its leading axis, and goes through `rand` / `randn` here with
`gen` either

  * a `torch.Generator`: the rows asked for are drawn from it; or
  * a `BatchRows`: the whole global batch is drawn from a generator that
    every process seeds alike, and this process keeps its rows lo:hi.

So a data-parallel step draws, row for row, what one process draws for the
whole batch, and the trajectory does not depend on the world size: the
per-row independence radae_tpu gets from one key over a sharded batch
(`radae_tpu/parallel/trainstep.py`, `tests/test_train.py::
test_shard_count_invariance`).  Each process draws world-size times the
numbers it keeps, which is small beside the nets it runs.

`batch_mean` is the forward's one statistic over the batch (the multipath
power normalisation, channel/simulate.py): over a `BatchRows` with a
process group it sums across the group with an all_reduce that carries
the gradient, so the mean, and its gradient, are the global batch's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class BatchRows:
    """Draw for `batch` rows from `gen`; keep rows lo:hi.  `group`: the
    process group whose ranks hold the other rows."""
    gen: torch.Generator
    batch: int
    lo: int
    hi: int
    group: Any

    @property
    def device(self) -> torch.device:
        return self.gen.device


def _draw(fn, gen, shape, dtype):
    shape = tuple(int(s) for s in shape)
    if isinstance(gen, BatchRows):
        if shape[0] != gen.hi - gen.lo:
            raise ValueError(f"a draw of {shape[0]} rows from BatchRows "
                             f"keeping rows {gen.lo}:{gen.hi}")
        full = fn((gen.batch,) + shape[1:], generator=gen.gen,
                  device=gen.device, dtype=dtype)
        return full[gen.lo:gen.hi]
    return fn(shape, generator=gen, device=gen.device, dtype=dtype)


def rand(gen, shape, dtype=torch.float32) -> torch.Tensor:
    """U[0, 1) of `shape`, its leading axis the batch."""
    return _draw(torch.rand, gen, shape, dtype)


def randn(gen, shape) -> torch.Tensor:
    """N(0, 1) of `shape`, its leading axis the batch."""
    return _draw(torch.randn, gen, shape, torch.float32)


class _GroupSum(torch.autograd.Function):
    """The sum of x over the group's ranks; its gradient is the sum of the
    ranks' gradients, each rank's share of d(sum of the ranks' losses)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def batch_mean(gen, x: torch.Tensor) -> torch.Tensor:
    """x.mean() over the global batch (x's leading axis is this process's
    rows of it)."""
    if isinstance(gen, BatchRows):
        total = _GroupSum.apply(x.sum(), gen.group)
        return total / (x.numel() // x.shape[0] * gen.batch)
    return x.mean()
