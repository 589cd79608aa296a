"""Device <-> host transfer helpers (port of `radae_tpu/utils/hostio.py`).

`to_host` reads a tensor, or the port's split-complex `ops.cplx.C` (a pair
of planes), to a numpy array: complex64 where the value is complex.
`device_put_tree` moves a params tree of numpy f32 arrays to a device in
one host-to-device copy of one flat buffer, each leaf a view of it: radae_tpu's
one-transfer contract (per-leaf copies cost one transfer each).
`convert.params_to_torch`, which the tools use, copies leaf by leaf.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from ..ops.cplx import C


def to_host(x) -> np.ndarray:
    """A numpy array, tensor or split-complex C -> host numpy, complex64
    where complex."""
    if isinstance(x, np.ndarray):
        return x
    if isinstance(x, C):
        return (to_host(x.re) + 1j * to_host(x.im)).astype(np.complex64)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.is_complex():
            return x.numpy().astype(np.complex64)
        return x.numpy()
    return np.asarray(x)


def host_complex(x) -> np.ndarray:
    """Alias of to_host for call sites that document complex intent."""
    return to_host(x)


def _map(fn, tree):
    """fn applied to each leaf of a tree of dicts, lists and tuples."""
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def device_put_tree(tree, device="cuda"):
    """A tree of numpy f32 arrays -> the same tree of f32 tensors on
    `device`, through ONE flat buffer: one host-to-device copy, each leaf
    a view of the buffer."""
    dev = resolve_device(device)
    leaves = []

    def take(x):
        a = to_host(x)
        if a.dtype != np.float32:
            raise TypeError("device_put_tree supports float32 trees only")
        leaves.append(a)
        return len(leaves) - 1

    index = _map(take, tree)
    flat = torch.from_numpy(np.concatenate([a.ravel() for a in leaves])
                            ).to(dev)
    offs = np.cumsum([0] + [a.size for a in leaves])
    return _map(lambda i: flat[offs[i]:offs[i + 1]].view(leaves[i].shape),
                index)
