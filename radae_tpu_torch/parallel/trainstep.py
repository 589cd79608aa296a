"""Training step: the loss differentiated by autograd, Adam(0.8, 0.95) with
1/(1+decay*step) LR decay, data parallel over a torch.distributed group
(port of `radae_tpu/parallel/trainstep.py`).

The reference's optimizer hyperparameters and per-step LambdaLR decay
(reference: train.py:95-97,149-155), which radae_tpu writes as an optax
chain; both take step 0's rate on the first update.  radae_tpu trains by
`jax.value_and_grad` of the plain forward, and its kernels have no
backward: so the forward here runs the plain nets (`RADAE._encode` /
`_decode` route a call that needs a gradient off the kernels).

Each step draws its noise (Eb/No, quantization noise, channel) from a
`torch.Generator` on the device seeded from (seed, step), as radae_tpu
folds `state.step` into its key: every step draws fresh channels.

Data parallel: each rank holds its rows of the global batch and the whole
params tree.  The step draws the global batch's noise on every rank from
the shared seed and keeps its rows (`ops.draws.BatchRows`), the forward's
one batch-wide mean is taken over the group, the gradients are averaged
with one `all_reduce` of a flat buffer (radae_tpu's psum; no
DistributedDataParallel wrapper, since the params are a tree, not a
module), and the reported metrics are the group's means.  So a step gives
the same trajectory whatever the world size (rows split evenly).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import numpy as np
import torch
from torch.optim.lr_scheduler import LambdaLR

from ..models.core import distortion_loss
from ..models.radae import tree_leaves
from ..ops.draws import BatchRows

ADAM_BETAS = (0.8, 0.95)
ADAM_EPS = 1e-8


@dataclass
class TrainState:
    params: Dict[str, Any]        # the tree of leaf tensors on the device
    optimizer: torch.optim.Adam
    scheduler: LambdaLR
    step: int = 0


def make_optimizer(lr: float, lr_decay_factor: float):
    """Adam with the reference's betas and inverse-linear LR decay.
    Returns init(leaves) -> (Adam, LambdaLR), optax's `opt.init`: the
    scheduler is stepped after each update."""
    def init(leaves):
        opt = torch.optim.Adam(leaves, lr=lr, betas=ADAM_BETAS, eps=ADAM_EPS)
        return opt, LambdaLR(opt, lambda s: 1.0 / (1.0 + lr_decay_factor * s))
    return init


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of step `step` of a run seeded `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0]) >> 1)
    return gen


def make_loss_fn(model, aux_ber: bool = False, aux_weight_boost: float = 1.0,
                 remat: bool = False):
    """loss_fn(params, features, H, G, key) -> (loss, aux BER or None):
    the mean distortion loss of the batch (radae_tpu's `loss_fn`,
    trainstep.py:81-94).

    remat=True (radae_tpu's jax.checkpoint of the forward) keeps only each
    core-net block's input and outputs for the backward, which runs the
    blocks again one at a time with the same noise (models/core.py): the
    peak memory falls for about one more forward of the core nets."""

    def loss_fn(params, features, H, G, key):
        fh = model.forward(params, features, H, G, key=key, remat=remat)[
            "features_hat"]
        loss = distortion_loss(features, fh).mean()
        aux = None
        if aux_ber:
            aux = (features[..., 20] * fh[..., 20] < 0).float().mean()
            if aux_weight_boost != 1.0:
                # optional training-time emphasis of the aux data channel
                extra = (features[..., 20] - fh[..., 20]) ** 2
                loss = loss + (aux_weight_boost - 1.0) * (0.5 / 18.0) * \
                    extra.mean()
        return loss, aux

    return loss_fn


def _group_mean(tensors, group, world):
    """Average a list of tensors over the group in one all_reduce."""
    import torch.distributed as dist
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= world
    return list(torch.split(flat, [t.numel() for t in tensors]))


def make_train_step(model, lr: float = 3e-4, lr_decay_factor: float = 2.5e-5,
                    aux_ber: bool = False, aux_weight_boost: float = 1.0,
                    remat: bool = False, group=None):
    """Build (init_state, train_step).

    init_state(params) -> TrainState: the tree (numpy or tensors) copied to
    leaf tensors on model.device that require grad (with a group, rank 0's
    broadcast), and the optimizer over them.

    train_step(state, features, H, G, seed) -> (state, metrics), metrics
    {"loss": (1,), ["ber": (1,)]} on the device; the state is updated in
    place and returned.  features (B, T, F) are this rank's rows of the
    global batch (B * world rows, split evenly); H, G as RADAE.forward
    takes them, or None.  radae_tpu's scan_steps (several steps in one
    lax.scan, to save dispatches) has no counterpart here: eager steps
    issue alike one by one, so train.py's --scan-steps only groups
    batches."""
    init_opt = make_optimizer(lr, lr_decay_factor)
    loss_fn = make_loss_fn(model, aux_ber, aux_weight_boost, remat)
    world, rank = 1, 0
    if group is not None:
        import torch.distributed as dist
        world, rank = dist.get_world_size(group), dist.get_rank(group)

    def init_state(params) -> TrainState:
        def leaf(node):
            if isinstance(node, dict):
                return {k: leaf(v) for k, v in node.items()}
            t = (node.detach().clone() if isinstance(node, torch.Tensor)
                 else torch.tensor(np.asarray(node, np.float32)))
            # contiguous: checkpoints may hold transposed arrays, and NCCL
            # takes contiguous tensors only
            return t.to(device=model.device, dtype=torch.float32
                        ).contiguous().requires_grad_(True)
        tree = leaf(params)
        leaves = list(tree_leaves(tree))
        if group is not None:
            import torch.distributed as dist
            src = dist.get_global_rank(group, 0)
            with torch.no_grad():
                for t in leaves:
                    dist.broadcast(t, src, group=group)
        opt, sched = init_opt(leaves)
        return TrainState(tree, opt, sched, 0)

    def one_step(state: TrainState, features, H, G, seed):
        features = model._tensor(features)
        B = features.shape[0]
        key = step_generator(model.device, seed, state.step)
        if group is not None:
            key = BatchRows(key, B * world, rank * B, (rank + 1) * B, group)
        state.optimizer.zero_grad(set_to_none=True)
        loss, aux = loss_fn(state.params, features, H, G, key)
        loss.backward()
        leaves = list(tree_leaves(state.params))
        if group is not None:
            grads = _group_mean([t.grad for t in leaves], group, world)
            for t, g in zip(leaves, grads):
                t.grad.copy_(g.view_as(t))
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        values = [loss.detach().reshape(1)] + (
            [aux.reshape(1)] if aux_ber else [])
        if group is not None:
            values = _group_mean(values, group, world)
        metrics = {"loss": values[0]}
        if aux_ber:
            metrics["ber"] = values[1]
        return state, metrics

    return init_state, one_step


def make_eval_step(model):
    """Forward-only step returning the per-sequence loss on the first 20
    features, the Eb/No and sigma (for loss-vs-Eq/No collection, reference
    train.py:161-226).  eval_step(params, features, H, G, key): key a
    torch.Generator (or BatchRows) or an int seed."""

    def eval_step(params, features, H, G, key):
        if isinstance(key, int):
            key = step_generator(model.device, key, 0)
        with torch.no_grad():
            features = model._tensor(features)
            out = model.forward(params, features, H, G, key=key)
            loss = distortion_loss(features[..., :20],
                                   out["features_hat"][..., :20])
        return (loss, out["EbNodB"].reshape(-1),
                out["sigma"].reshape(features.shape[0], -1))

    return eval_step
