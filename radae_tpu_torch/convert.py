"""Checkpoints: npz loading and the numpy -> torch weight carry-over.

`load_checkpoint` reads the JAX package's native checkpoint format (one
.npz of flattened `side/layer/name` key paths plus a json metadata blob,
`radae_tpu/convert.py:106-141`) into the same nested dict of numpy arrays.
`params_to_torch` turns such a tree, or one made by `Core*.init`, into
torch tensors with the same keys and layouts:

  encoder/dense_1/{w,b}, encoder/gru{i}/{w_ih,w_hh,b_ih,b_hh},
  encoder/conv{i}/{w,b} (w in torch Conv1d (out, in, k) layout),
  encoder/z_dense/{w,b}
  decoder/dense_1, decoder/gru{i}, decoder/glu{i}/{g,v},
  decoder/conv{i}, decoder/output

so both packages compute the same function from one npz.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def load_checkpoint(path: str):
    """Read a native .npz checkpoint -> (params tree of numpy, meta dict)."""
    data = dict(np.load(path, allow_pickle=False))
    meta = {}
    if "__meta__" in data:
        meta = json.loads(bytes(data.pop("__meta__")).decode())
    return _unflatten(data), meta


def params_to_torch(tree: Dict[str, Any], device="cuda") -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of float32 tensors."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        return torch.as_tensor(np.asarray(node, np.float32), device=dev)

    return conv(tree)
