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
`load_torch_checkpoint` reads a reference .pth checkpoint into the same
tree (`radae_tpu/convert.py:18-99`).  `save_checkpoint` writes a tree of
numpy arrays or tensors in the native format, so a checkpoint written by
either package loads in the other with the same leaves and meta.
"""

from __future__ import annotations

import json
from typing import Any, Dict

import numpy as np
import torch

from . import resolve_device


def _strip_prefix(k: str) -> str:
    for pre in ("core_encoder.module.", "core_decoder.module.",
                "core_encoder.", "core_decoder.", "module."):
        if k.startswith(pre):
            return k[len(pre):]
    return k


def _split_enc_dec(state_dict) -> Dict[str, Dict[str, np.ndarray]]:
    enc, dec = {}, {}
    for k, v in state_dict.items():
        arr = np.asarray(v.detach().cpu().numpy() if hasattr(v, "detach") else v,
                         dtype=np.float32)
        if k.startswith("core_encoder"):
            enc[_strip_prefix(k)] = arr
        elif k.startswith("core_decoder"):
            dec[_strip_prefix(k)] = arr
    return {"encoder": enc, "decoder": dec}


def _convert_side(sd: Dict[str, np.ndarray], side: str) -> Dict[str, Any]:
    """One flat torch-named dict -> a params subtree."""
    p: Dict[str, Any] = {}

    def dense(name):
        return {"w": sd[f"{name}.weight"], "b": sd[f"{name}.bias"]}

    p["dense_1"] = dense("dense_1")
    for i in range(1, 6):
        g = f"gru{i}"
        # streaming checkpoints nest the GRU one level deeper (gru{i}.gru.*)
        base = g if f"{g}.weight_ih_l0" in sd else f"{g}.gru"
        p[g] = {
            "w_ih": sd[f"{base}.weight_ih_l0"],
            "w_hh": sd[f"{base}.weight_hh_l0"],
            "b_ih": sd[f"{base}.bias_ih_l0"],
            "b_hh": sd[f"{base}.bias_hh_l0"],
        }
        c = f"conv{i}"
        p[c] = {"w": sd[f"{c}.conv.weight"], "b": sd[f"{c}.conv.bias"]}
        if side == "decoder":
            glu = f"glu{i}"
            if f"{glu}.gate.parametrizations.weight.original0" in sd:
                g0 = sd[f"{glu}.gate.parametrizations.weight.original0"]
                v = sd[f"{glu}.gate.parametrizations.weight.original1"]
                p[glu] = {"g": g0.reshape(-1), "v": v}
            elif f"{glu}.gate.weight_g" in sd:   # legacy weight_norm naming
                p[glu] = {"g": sd[f"{glu}.gate.weight_g"].reshape(-1),
                          "v": sd[f"{glu}.gate.weight_v"]}
            else:                                 # already-fused weight
                w = sd[f"{glu}.gate.weight"]
                p[glu] = {"g": np.linalg.norm(w, axis=1), "v": w}
    p["output" if side == "decoder" else "z_dense"] = dense(
        "output" if side == "decoder" else "z_dense")
    return p


def torch_state_dict_to_params(state_dict) -> Dict[str, Any]:
    """Reference torch state_dict (`core_encoder.` / `core_decoder.`
    prefixes, weight-norm GLU gates) -> params tree of numpy arrays."""
    split = _split_enc_dec(state_dict)
    out: Dict[str, Any] = {}
    for side, sd in split.items():
        if sd:
            out[side] = _convert_side(sd, side)
    return out


def load_torch_checkpoint(path: str) -> Dict[str, Any]:
    """Load a reference .pth checkpoint into a params tree of numpy."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt["state_dict"] if "state_dict" in ckpt else ckpt
    return torch_state_dict_to_params(sd)


def _flatten(tree: Dict[str, Any], prefix="") -> Dict[str, np.ndarray]:
    """Nested dict -> {"side/layer/name": numpy array} (tensors copied to
    the host)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{k}" if not prefix else f"{prefix}/{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        elif isinstance(v, torch.Tensor):
            out[key] = v.detach().cpu().numpy()
        else:
            out[key] = np.asarray(v)
    return out


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        node = tree
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, params: Dict[str, Any],
                    meta: Dict[str, Any] | None = None):
    """Write a native .npz checkpoint: the flattened tree plus `__meta__`,
    the meta dict as JSON bytes (`radae_tpu/convert.py:128-133`)."""
    flat = _flatten(params)
    flat["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **flat)


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
