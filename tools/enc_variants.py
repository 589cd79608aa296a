#!/usr/bin/env python3
"""Time forms of the encoder kernel (enc_kernel) against each other on one
CUDA card, in turns, in one run.

    python3 tools/enc_variants.py [--src NAME=PATH ...] [--out DIR] [--reps N]

Builds radae_tpu_torch/csrc/fused_core.cu as it is and, beside it, one copy
for each form in FORMS (the source with a few text changes) and for each
other copy of the source named by --src, for example an earlier commit's:

    git show <commit>:radae_tpu_torch/csrc/fused_core.cu > build/parent.cu
    python3 tools/enc_variants.py --src parent=build/parent.cu

Each form's encoder runs through fused_encoder_step on the flagship weights
at B=2048, one frame (nz=3) a call.  The checked forms are held against
encoder_step_plain (rtol 1e-4, atol 1e-4); the forms that take a cost out
on purpose give wrong results and are timed only.  For each form it prints
the ptxas line, the max abs err, whether two launches give the same bits,
the device time (CUDA graph replays; the forms in turns, the order reversed
every round) and the weight bytes a launch fetches into the SMs, and it
writes them to DIR/enc_variants.json (default build/enc_variants).

The text changes name lines of the source: when the kernel changes, a form
that no longer applies stops the run with its name.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (TOL, card_line, check_close, graph_ms,  # noqa: E402
                        max_err, weight_fetch_bytes)

B = 2048
PR2_ROWS = (2, 4)   # rows a weight load feeds in a source that does not say:
                    # the first encoder kernel (2 in the GRU products, 4 else)

# the weight loads staged by cp.async in a 2-stage ring of 16-byte slots, one
# a lane and weight row, behind the scratch (4 KB a warp)
_CP_ASYNC_HELPERS = r"""
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool v) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(v ? 16 : 0) : "memory");
}
__device__ __forceinline__ float* ring_slot(int stage, int m) {
  extern __shared__ float4 smem4[];
  return reinterpret_cast<float*>(smem4) + 3 * R * ENC_X + ENC_SCR +
         (threadIdx.x >> 5) * 1024 + ((stage * 4 + m) * 32 + (threadIdx.x & 31)) * 4;
}

"""
_ROWS8 = [("constexpr int ET = 16;", "constexpr int ET = 8;")]
_CPASYNC = [
    ("// acc[i] += sum over this lane's k",
     _CP_ASYNC_HELPERS + "// acc[i] += sum over this lane's k"),
    ("constexpr size_t ENC_SMEM = sizeof(float) * (3 * R * ENC_X + ENC_SCR);",
     "constexpr size_t ENC_SMEM = sizeof(float) * (3 * R * ENC_X + ENC_SCR"
     " + NWARP * 1024);"),
    (r"""  float4 wn[4];
  ldw(wn, wp, out, cv && k < k1);""", r"""  for (int m = 0; m < 4; ++m)
    cp_async16(ring_slot(0, m), cv && k < k1 ? wp + m * out : W, cv && k < k1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");"""),
    (r"""#pragma unroll
    for (int m = 0; m < 4; ++m) wt[m] = wn[m];
    ldw(wn, wp, out, cv && k < k1);""", r"""#pragma unroll
    for (int m = 0; m < 4; ++m)
      cp_async16(ring_slot((j + 1) & 1, m), cv && k < k1 ? wp + m * out : W,
                 cv && k < k1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
#pragma unroll
    for (int m = 0; m < 4; ++m) wt[m] = ld4(ring_slot(j & 1, m));"""),
    (r"""      fma4(acc[i], x.w, wt[3]);
    }
  }
}""", r"""      fma4(acc[i], x.w, wt[3]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}""")]
# name -> (held against the plain version, [(text of the source, replacement)])
FORMS = {
    "rows8": (True, _ROWS8),              # 8-row tiles, 2 row groups a block
    "cpasync": (True, _CPASYNC),          # weights through a cp.async ring
    "rows8_cpasync": (True, _ROWS8 + _CPASYNC),
    "quads8apart": (True, [               # a K lane's 4 column quads 8 lanes apart
        ("const int kl = lane >> 2, cq = 4 * (lane & 3);",
         "const int kl = lane & 7, cq = 4 * (lane >> 3);"),
        ("(acc, kl & 1, 4)", "(acc, kl & 1, 1)"),
        ("(acc, (kl >> 1) & 1, 8)", "(acc, (kl >> 1) & 1, 2)"),
        ("(acc, (kl >> 2) & 1, 16)", "(acc, (kl >> 2) & 1, 4)")]),
    "unroll2": (True, [("#pragma unroll 1 ", "#pragma unroll 2 ")]),
    "noxload": (False, [                  # x from registers: no shared x loads
        ("const float4 x = ld4(xr + i * ENC_X + kx);",
         "const float4 x = wt[i & 3];")]),
    "wfixed": (False, [                   # every K step reloads the first one's
        ("    wp += 32 * out;\n", "")]),  # weights (from L1)
    "noproducts": (False, [               # no product loops: barriers, sums,
        ("  const float* const xr = X + r0 * ENC_X;\n",  # gates, staging only
         "  return;\n  const float* const xr = X + r0 * ENC_X;\n")]),
}


def write_form(src_text, name, out_dir) -> str:
    text = src_text
    for old, new in FORMS[name][1]:
        if old not in text:
            raise ValueError(f"form {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    path = os.path.join(out_dir, f"enc_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[], metavar="NAME=PATH",
                    help="another copy of csrc/fused_core.cu to time")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "enc_variants"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("enc_variants: no CUDA card", file=sys.stderr)
        return 1
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint
    from radae_tpu_torch.ops import _kernels
    from radae_tpu_torch.ops import fused_core as fc

    card = card_line()
    print(f"card: {card}")
    os.makedirs(args.out, exist_ok=True)
    committed = str(_kernels.SRC_DIR / "fused_core.cu")
    with open(committed) as fh:
        text = fh.read()
    srcs = {"committed": committed}
    srcs.update({n: write_form(text, n, args.out) for n in FORMS})
    srcs.update(s.split("=", 1) for s in args.src)

    procs = {}
    for v, src in srcs.items():          # one nvcc a form, all at once
        with open(os.path.join(args.out, f"enc_{v}.log"), "w") as log:
            procs[v] = subprocess.Popen(
                [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o",
                 os.path.join(args.out, f"libenc_{v}.so"), src],
                stdout=log, stderr=subprocess.STDOUT)
    libs, info = {}, {}
    for v, proc in procs.items():
        status = proc.wait()
        with open(os.path.join(args.out, f"enc_{v}.log")) as fh:
            lines = fh.read().splitlines()
        if status != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n" + "\n".join(lines))
        at = [i for i, x in enumerate(lines)
              if "entry function" in x and "enc_kernel" in x]
        ptxas = [x.strip() for x in lines[at[0]:at[0] + 4]
                 if "registers" in x or "spill" in x] if at else []
        lib = ctypes.CDLL(os.path.join(args.out, f"libenc_{v}.so"))
        for fn, argtypes in _kernels._SIGNATURES["fused_core"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        libs[v] = lib
        rows = ((lib.radae_enc_tile_rows(),) * 2
                if hasattr(lib, "radae_enc_tile_rows") else PR2_ROWS)
        info[v] = {"ptxas": ptxas, "rows": rows,
                   "checked": FORMS[v][0] if v in FORMS else True}
        print(f"{v}: ptxas {ptxas}")

    cfg = flagship_config()
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           "model_fs_flagship.npz"))
    dev = torch.device("cuda")
    ew = fc.encoder_weights(tree["encoder"], dev)
    gen = np.random.default_rng(0)
    nz = cfg.Nzmf
    f = torch.as_tensor((0.3 * gen.standard_normal(
        (B, 4 * nz, cfg.feature_dim))).astype(np.float32), device=dev)
    es = tuple(torch.as_tensor((0.5 * gen.standard_normal(tuple(s.shape)))
                               .astype(np.float32), device=dev)
               for s in fc.encoder_state_zero(B, dev))
    block_rows = libs["committed"].radae_block_rows()
    blocks = -(-B // block_rows)

    def run(v):
        with mock.patch.object(_kernels, "library", lambda name: libs[v]):
            return fc.fused_encoder_step(ew, f, es, cfg.bottleneck)

    with torch.no_grad():
        zp, sp = fc.encoder_step_plain(ew, f, es, cfg.bottleneck)
        want = (zp,) + sp
        for v in libs:
            (z1, s1), (z2, s2) = run(v), run(v)
            torch.cuda.synchronize()
            got = (z1,) + s1
            if info[v]["checked"]:
                check_close(f"form {v}", got, want, TOL)
            info[v]["max_abs_err"] = max_err(got, want)
            info[v]["same_bits"] = all(
                torch.equal(x, y) for x, y in zip(got, (z2,) + s2))
        times = {v: [] for v in libs}
        order = list(libs)
        for r in range(args.reps):
            for v in (order if r % 2 == 0 else order[::-1]):
                times[v].append(graph_ms(lambda: run(v)))
    for v in libs:
        ms = sum(times[v]) / args.reps
        fetch = weight_fetch_bytes(ew, *info[v]["rows"], block_rows) \
            * blocks * nz
        info[v].update(ms=ms, runs=times[v], weight_bytes_per_launch=fetch,
                       weight_tb_s=fetch / (ms * 1e-3) / 1e12)
        print(f"{v}: {ms:.4f} ms (rounds {[round(t, 4) for t in times[v]]}), "
              f"err {info[v]['max_abs_err']:.3g}"
              f"{'' if info[v]['checked'] else ' (not checked)'}, same bits "
              f"{info[v]['same_bits']}, weights {fetch / 1e9:.4f} GB a launch "
              f"({info[v]['weight_tb_s']:.2f} TB/s)")
    with open(os.path.join(args.out, "enc_variants.json"), "w") as fh:
        json.dump({"card": card, "batch": B, "nz": nz, "forms": info}, fh,
                  indent=1)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
