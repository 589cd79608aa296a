"""Each rank's rows of a global batch (the port's counterpart of
`radae_tpu/parallel/mesh.py`).

radae_tpu shards the batch rows of one jit over a 1-D "dp" device mesh and
lets XLA insert the psum.  The port runs one process per card in a
torch.distributed group: every rank builds the same global batch from the
same seed and keeps its rows, rank r the r-th of world equal parts; the
step (parallel/trainstep.py) reduces across the group itself.
"""

from __future__ import annotations


def rank_rows(batch: int, group=None) -> slice:
    """The rows of a global batch of `batch` that this rank holds (all of
    them without a group).  The batch must split evenly."""
    if group is None:
        return slice(0, batch)
    import torch.distributed as dist
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    if batch % world:
        raise ValueError(f"a batch of {batch} rows does not split evenly "
                         f"over {world} ranks")
    n = batch // world
    return slice(rank * n, (rank + 1) * n)


def shard_batch(arrays, group=None):
    """This rank's rows of each array (numpy or tensor); None stays None."""
    return tuple(None if x is None else x[rank_rows(x.shape[0], group)]
                 for x in arrays)
