"""Weight export for the native C runtime (port of `radae_tpu/export.py`).

Replaces the reference's export_rade_weights.py + weight-exchange +
write_rade_weights.c toolchain (reference: export_rade_weights.py:54-239):
dumps a params tree to

  * an "RTPW" binary blob loadable by native/weights.c at runtime, and/or
  * generated C source with compiled-in arrays (rade_weights_data.c/h).

The tree is the port's: numpy arrays from `convert.load_checkpoint` or
`load_torch_checkpoint`, or tensors on any device (each leaf is copied to
the host first).  GLU gates are exported FUSED (w = g * v / ||v||): the C
runtime has no weight-norm parameterisation (same as the reference
stripping weight_norm, export_rade_weights.py:227-232).  Export runs on the
host only, so it takes no device.
"""

from __future__ import annotations

import struct
import sys
from typing import Any, Dict

import numpy as np

from .utils.hostio import to_host


def _fuse_glu(params: Dict[str, Any]) -> Dict[str, np.ndarray]:
    """Flatten the params tree to name -> array with fused GLU weights."""
    flat: Dict[str, np.ndarray] = {}

    def walk(tree, prefix):
        if isinstance(tree, dict):
            if "v" in tree and "g" in tree and len(tree) == 2:
                v = np.asarray(to_host(tree["v"]), np.float32)
                g = np.asarray(to_host(tree["g"]), np.float32)
                w = g[:, None] * v / np.linalg.norm(v, axis=1, keepdims=True)
                flat[f"{prefix}/w"] = w.astype(np.float32)
                return
            for k, vv in tree.items():
                walk(vv, f"{prefix}/{k}" if prefix else k)
        else:
            flat[prefix] = np.asarray(to_host(tree), np.float32)

    walk(params, "")
    return flat


def write_blob(path: str, params: Dict[str, Any]):
    """Write the RTPW blob (see native/weights.h for the layout)."""
    flat = _fuse_glu(params)
    with open(path, "wb") as f:
        f.write(b"RTPW")
        f.write(struct.pack("<II", 1, len(flat)))
        for name, arr in flat.items():
            nb = name.encode()
            f.write(struct.pack("<I", len(nb)))
            f.write(nb)
            f.write(struct.pack("<I", arr.ndim))
            for d in arr.shape:
                f.write(struct.pack("<I", d))
            f.write(np.ascontiguousarray(arr, np.float32).tobytes())


def write_c_arrays(path_prefix: str, params: Dict[str, Any]):
    """Generate rade_weights_data.c/.h with compiled-in weight arrays and a
    builder that assembles an rw_blob from them."""
    flat = _fuse_glu(params)

    def cname(name):
        return "rw_" + name.replace("/", "_")

    with open(path_prefix + ".h", "w") as h:
        h.write("/* generated by radae_tpu_torch.export — compiled-in "
                "weights */\n")
        h.write("#ifndef RADE_WEIGHTS_DATA_H\n#define RADE_WEIGHTS_DATA_H\n")
        h.write('#include "weights.h"\n')
        h.write("int rade_weights_builtin(rw_blob *b);\n")
        h.write("#endif\n")

    with open(path_prefix + ".c", "w") as c:
        c.write("/* generated by radae_tpu_torch.export */\n")
        c.write(f'#include "{path_prefix.split("/")[-1]}.h"\n')
        c.write("#include <string.h>\n\n")
        for name, arr in flat.items():
            c.write(f"static const float {cname(name)}[{arr.size}] = {{\n")
            vals = arr.flatten()
            for i in range(0, len(vals), 8):
                c.write("  " + ", ".join(f"{v:.8e}f" for v in vals[i:i + 8]) + ",\n")
            c.write("};\n")
        c.write("\nint rade_weights_builtin(rw_blob *b) {\n")
        c.write("  memset(b, 0, sizeof *b);\n")
        for i, (name, arr) in enumerate(flat.items()):
            c.write(f"  strcpy(b->tensors[{i}].name, \"{name}\");\n")
            c.write(f"  b->tensors[{i}].data = {cname(name)};\n")
            c.write(f"  b->tensors[{i}].ndim = {arr.ndim};\n")
            for d, dim in enumerate(arr.shape):
                c.write(f"  b->tensors[{i}].dims[{d}] = {dim};\n")
            c.write(f"  b->tensors[{i}].size = {arr.size};\n")
        c.write(f"  b->n = {len(flat)};\n  return 0;\n}}\n")


def main(argv=None):
    import argparse
    from .convert import load_checkpoint, load_torch_checkpoint

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("checkpoint", type=str, help=".npz or .pth (or 'random')")
    p.add_argument("out", type=str, help="output blob path (or prefix with --c-arrays)")
    p.add_argument("--c-arrays", action="store_true")
    p.add_argument("--latent-dim", type=int, default=80)
    p.add_argument("--auxdata", action="store_true")
    args = p.parse_args(argv)

    if args.checkpoint == "random":
        from .config import flagship_config
        from .models.radae import RADAE
        nf = 21 if args.auxdata else 20
        # radae_tpu's RADAE(cfg).init(0), draw for draw (numpy); the model
        # is made on the CPU, since nothing here runs on a card
        params = RADAE(flagship_config(feature_dim=nf,
                                       latent_dim=args.latent_dim),
                       device="cpu").init(0)
    elif args.checkpoint.endswith(".pth"):
        params = load_torch_checkpoint(args.checkpoint)
    else:
        params, _ = load_checkpoint(args.checkpoint)

    if args.c_arrays:
        write_c_arrays(args.out, params)
        print(f"wrote {args.out}.c/.h", file=sys.stderr)
    else:
        write_blob(args.out, params)
        print(f"wrote {args.out}", file=sys.stderr)


if __name__ == "__main__":
    main()
