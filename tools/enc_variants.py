#!/usr/bin/env python3
"""Time forms of one tile kernel (the encoder enc_kernel, the unmerged
decoder dec_kernel, the chain-merged decoder dec_merged_kernel or the
whole-frame rx_frame_kernel) against each other on one CUDA card, in turns,
in one run.

    python3 tools/enc_variants.py [--kernel enc|dec|decm|frame]
                                  [--quant int8] [--forms A,B]
                                  [--src NAME=PATH[@G,O] ...] [--out DIR]
                                  [--reps N]

Builds radae_tpu_torch/csrc/fused_core.cu as it is and, beside it, one copy
for each form in FORMS that applies to the kernel (the source with a few
text changes) and for each other copy of the source named by --src, for
example an earlier commit's:

    git show <commit>:radae_tpu_torch/csrc/fused_core.cu > build/parent.cu
    python3 tools/enc_variants.py --kernel dec --src parent=build/parent.cu

`@G,O` gives the rows each weight load feeds in that copy's GRU products
and in its others, where its library does not say (the chain-merged decoder
before its 16-row tiles: `@2,4`).

Each form's kernel runs through its wrapper (fused_encoder_step,
fused_decoder_step, the latter with the merged weights for decm, or
fused_rx_frame_step) on the flagship weights at B=2048, one frame (nz=3) a
call, with random inputs and state from a seed.
The checked forms are held against the plain version (rtol 1e-4, atol
1e-4); the forms that take a cost out on purpose give wrong results and are
timed only.  For each form it prints the ptxas line of the kernel, the max
abs err, whether two launches give the same bits, the device time (CUDA
graph replays; the forms in turns, the order reversed every round) and the
weight bytes a launch fetches into the SMs (the encoder's or the decoder's
weights), and it writes them to DIR/<kernel>_variants.json (default DIR
build/enc_variants).

The text changes name lines of the source: when the kernels change, a form
that no longer applies stops the run with its name.  The encoder and both
decoders have an int8 instance beside the f32 one; the tool times and
compares the f32 instance (a --src library whose entries predate the int8
arguments is called through `F32OnlyEntries`), or with --quant int8 the
int8 instance on the int8 weights (`quant="int8"`), whose own forms are
named int8_*.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
from unittest import mock

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from chip_smoke import (RX_NOISE, TOL, card_line, check_close,  # noqa: E402
                        graph_ms, max_err, weight_fetch_bytes)

B = 2048
FIRST_ROWS = (2, 4)  # rows a weight load feeds in a source that does not say:
                     # the first kernels (2 in the GRU products, 4 else)
# --kernel -> (name of the __global__ function, wrapper, library entry of its
# tile rows, the mangled-name part of the instance left out); the frame
# kernel has two instances (the flagship geometry as constants, and from the
# launch), whose ptxas lines and SASS go together; of the others, the int8
# instance (template argument true: "ILb1EE") is left out, or with --quant
# int8 the f32 one ("ILb0EE")
KERNELS = {"enc": ("enc_kernel", "fused_encoder_step", "radae_enc_tile_rows",
                   "ILb1EE"),
           "dec": ("dec_kernel", "fused_decoder_step", "radae_dec_tile_rows",
                   "ILb1EE"),
           "decm": ("dec_merged_kernel", "fused_decoder_step",
                    "radae_dec_tile_rows", "ILb1EE"),
           "frame": ("rx_frame_kernel", "fused_rx_frame_step",
                     "radae_dec_tile_rows", None)}
ALL = tuple(KERNELS)

# the weight loads staged by cp.async in a 2-stage ring of 16-byte slots, one
# a lane and weight row, behind the scratch (4 KB a warp)
_CP_ASYNC_HELPERS = r"""
__device__ __forceinline__ void cp_async16z(float* dst, const float* src,
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
    cp_async16z(ring_slot(0, m), cv && k < k1 ? wp + m * out : W, cv && k < k1);
  asm volatile("cp.async.commit_group;\n" ::: "memory");"""),
    (r"""#pragma unroll
    for (int m = 0; m < 4; ++m) wt[m] = wn[m];
    ldw(wn, wp, out, cv && k < k1);""", r"""#pragma unroll
    for (int m = 0; m < 4; ++m)
      cp_async16z(ring_slot((j + 1) & 1, m), cv && k < k1 ? wp + m * out : W,
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
# name -> (kernels it applies to, held against the plain version,
#          [(text of the source, replacement)]); tmac and kput are shared, so
# the forms that change them apply to all three kernels
FORMS = {
    "rows8": (ALL, True, _ROWS8),         # 8-row tiles, 2 row groups a block
    "cpasync": (("enc",), True, _CPASYNC),  # weights through a cp.async ring
    "rows8_cpasync": (("enc",), True, _ROWS8 + _CPASYNC),
    "quads8apart": (ALL, True, [          # a K lane's 4 column quads 8 lanes apart
        ("const int kl = lane >> 2, cq = 4 * (lane & 3);",
         "const int kl = lane & 7, cq = 4 * (lane >> 3);"),
        ("(acc, kl & 1, 4)", "(acc, kl & 1, 1)"),
        ("(acc, (kl >> 1) & 1, 8)", "(acc, (kl >> 1) & 1, 2)"),
        ("(acc, (kl >> 2) & 1, 16)", "(acc, (kl >> 2) & 1, 4)")]),
    # int8 instance: the scale float4 loaded after the K-lane sum, not
    # before the K loop with the bias (4 registers free in the loop)
    "int8_scalelate": (("enc", "dec", "decm"), True, [
        ("""                                      float* dst, int ld, float4 s,
                                      float4 bias, bool put) {""",
         """                                      float* dst, int ld, const float* sp,
                                      float4 bias, bool put) {"""),
        ("""  const int rk = ksum(acc, kl, r0);
  if (put) {
#pragma unroll
    for (int i = 0; i < ET / 8; ++i)
      st4(dst + (rk + i) * ld, add4(mul4(acc[i], s), bias));""",
         """  const int rk = ksum(acc, kl, r0);
  if (put) {
    const float4 s = ldg4(sp);
#pragma unroll
    for (int i = 0; i < ET / 8; ++i)
      st4(dst + (rk + i) * ld, add4(mul4(acc[i], s), bias));"""),
        ("scl<Q>(sc, c, out), b,", "Q ? sc + c : nullptr, b,"),
        ("const float4 gi = scl<Q>(si, c, DEC_G), gh = scl<Q>(sh, c, DEC_G);",
         "const float *gi = Q ? si + c : nullptr, *gh = Q ? sh + c : nullptr;"),
        ("const float4 gi = scl<Q>(si, c, ENC_G), gh = scl<Q>(sh, c, ENC_G);",
         "const float *gi = Q ? si + c : nullptr, *gh = Q ? sh + c : nullptr;"),
        ("scl<Q>(sc(4 + 5 * i + tap), c, DEC_CO)",
         "Q ? sc(4 + 5 * i + tap) + c : nullptr"),
        ("scl<Q>(sc(0), c, ENC_H)", "Q ? sc(0) + c : nullptr"),
        ("scl<Q>(sc(3 + 4 * i + tap), c, ENC_CO)",
         "Q ? sc(3 + 4 * i + tap) + c : nullptr"),
        ("scl<Q>(sc(ENC_NS - 1), c, od)", "Q ? sc(ENC_NS - 1) + c : nullptr")]),
    # int8 instance: QuantArgs without __grid_constant__, so each thread
    # copies it to local memory to index soff
    "int8_qalocal": (("enc", "dec", "decm"), True, [
        ("const __grid_constant__ QuantArgs<DEC_NS> qa)",
         "const QuantArgs<DEC_NS> qa)"),
        ("const __grid_constant__ QuantArgs<DECM_NS> qa)",
         "const QuantArgs<DECM_NS> qa)"),
        ("const __grid_constant__ QuantArgs<ENC_NS> qa)",
         "const QuantArgs<ENC_NS> qa)")]),
    "unroll2": (ALL, True, [("#pragma unroll 1 ", "#pragma unroll 2 ")]),
    "syncload": (("frame",), True, [      # the samples by plain loads and stores
        ("  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(d),\n"
         "               \"l\"(src)\n"
         "               : \"memory\");\n",
         "  (void)d;\n  st4(dst, ld4(src));\n")]),
    "noxload": (ALL, False, [             # x from registers: no shared x loads
        ("const float4 x = ld4(xr + i * ld + kx);",
         "const float4 x = wt[i & 3];")]),
    "wfixed": (ALL, False, [              # every K step reloads the first one's
        ("    wp += 32 * out;\n", "")]),  # weights (from L1)
    "stages1": (("frame",), True, [       # the DFT after the whole copy
        ("constexpr int FR_STAGES = 2;", "constexpr int FR_STAGES = 1;")]),
    "stages3": (("frame",), True, [
        ("constexpr int FR_STAGES = 2;", "constexpr int FR_STAGES = 3;")]),
    "stages6": (("frame",), True, [       # one stage a 16-row group
        ("constexpr int FR_STAGES = 2;", "constexpr int FR_STAGES = 6;")]),
    "nocopy": (("frame",), False, [       # no sample copy: stale operands
        ("  asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(d),\n",
         "  if (d == 0xffffffffu) asm volatile(\"cp.async.cg.shared.global [%0], [%1], 16;\\n\" ::\"r\"(d),\n")]),
    "nodft": (("frame",), False, [        # no DFT product loop
        ("      tmac(acc, S, row, r0, a.dft_w, yw, c, 0, row, kl);\n", "")]),
    "nols": (("frame",), False, [         # no LS products
        ("  rowprod(p0, a.ls_w,", "  if (a.d.B < 0) rowprod(p0, a.ls_w,"),
        ("  rowprod(p1, a.ls_w,", "  if (a.d.B < 0) rowprod(p1, a.ls_w,")]),
    "noprologue": (("frame",), False, [   # the decoder body alone
        ("  const float* const rx = a.rx + (size_t)b0 * nsym * row;\n",
         "  if (a.d.B < 0) {\n"
         "  const float* const rx = a.rx + (size_t)b0 * nsym * row;\n"),
        ("  dec_body<false>(a.d,", "  }\n  dec_body<false>(a.d,")]),
    "noz": (("dec",), False, [            # latents never staged: stale operands
        ("  stage<DEC_X>(xb + DEC_H, zs.p, zs.ld, a.in_dim, zs.rmax);\n", ""),
        ("      stage<DEC_X>(Xp + DEC_H, zs.p + (size_t)(k + 1) * zstep, zs.ld,\n"
         "                   a.in_dim, zs.rmax);\n", "      ;\n")]),
    "frsmem": (("dec",), True, [          # the frame kernel's shared memory size
        ("launch(dec_kernel<false>, DEC_SMEM, B, stream, a, q)",
         "launch(dec_kernel<false>, frame_smem(flagship_geo()), B, stream, a, q)")]),
    "frgeneric": (("frame",), True, [     # the flagship through the instance
        ("  const bool fix = ns == f.ns",   # that reads the geometry at launch
         "  const bool fix = f.ns < 0 && ns == f.ns")]),
    "conv6": (("decm",), True, [          # x @ [tap1|tap0] in 6 K chunks:
        ("constexpr int DECM_CONV_KS = 3;",  # 24 units, 2 rounds
         "constexpr int DECM_CONV_KS = 6;")]),
    "biasl2": (("decm",), True, [         # bhh and cb read from the L2 in
        ("        const float* const bhh = bb + fc;\n",  # the gate and conv
         "        const float* const bhh = w + o[3] + fc;\n"),  # passes
        ("        const float4 gr = add4(ld4(g), ld4(bhh));\n"
         "        const float4 gz = add4(ld4(g + DEC_H), ld4(bhh + DEC_H));\n"
         "        const float4 gn = add4(ld4(g + 2 * DEC_H), ld4(bhh + 2 * DEC_H));\n",
         "        const float4 gr = add4(ld4(g), ldg4(bhh));\n"
         "        const float4 gz = add4(ld4(g + DEC_H), ldg4(bhh + DEC_H));\n"
         "        const float4 gn = add4(ld4(g + 2 * DEC_H), ldg4(bhh + 2 * DEC_H));\n"),
        ("tanh4(add4(add4(ld4(hq), y), ld4(bb + DEC_G + c))));",
         "tanh4(add4(add4(ld4(hq), y), ldg4(w + o[5] + c))));")]),
    "ghhalf": (("decm",), False, [        # h @ [whh | glu]: one round of 12
        ("  for (int u = warp; u < RG * DECM_GGC; u += NWARP) {",  # units, not 2
         "  for (int u = warp; u < RG * DECM_GGC / 2; u += NWARP) {")]),
    "noproducts": (ALL, False, [          # no product loops: barriers, sums,
        ("  const float* const xr = X + r0 * ld;\n",  # gates, staging only
         "  return;\n  const float* const xr = X + r0 * ld;\n")]),
}


class FixedGeometryFrame:
    """A library built from a source whose frame kernel fixed the flagship
    modem's geometry at compile time (before radae_rx_frame_limit): takes
    the entry's arguments of today and drops the geometry."""

    def __init__(self, lib):
        self._lib = lib
        P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.radae_fused_rx_frame_step.argtypes = [P, P, I, P, P, I, I, F, I,
                                                  P, P, P]

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def radae_rx_frame_limit(self, *geometry):
        return 0

    def radae_fused_rx_frame_step(self, *args):
        return self._lib.radae_fused_rx_frame_step(*args[:9], *args[14:])


class F32OnlyEntries:
    """A library built from a source whose decoder and encoder entries
    predate the int8 instances: takes the entries' arguments of today and
    drops the kinds and scale offsets (an f32 launch has none)."""

    ENTRIES = ("radae_fused_decoder_step", "radae_fused_decoder_merged_step",
               "radae_fused_encoder_step")

    def __init__(self, lib, signatures):
        self._lib = lib
        for fn in self.ENTRIES:
            getattr(lib, fn).argtypes = signatures[fn][:3] + signatures[fn][6:]

    def __getattr__(self, name):
        if name in self.ENTRIES:
            fn = getattr(self._lib, name)
            return lambda *args: fn(*args[:3], *args[6:])
        return getattr(self._lib, name)


def sass(lib_path, kname, cuobjdump, skip=None):
    """The kernel's SASS, without addresses, encodings and the
    source-dependent mangled names, leaving out the instances whose name
    holds `skip` (None without cuobjdump)."""
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    body = [b for b in out.split("Function : ")[1:]
            if kname in b.splitlines()[0]
            and not (skip and skip in b.splitlines()[0])]
    if not body:
        return None
    lines = []
    for b in sorted(body, key=lambda b: b.splitlines()[0]):
        for x in b.splitlines()[1:]:
            x = re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", x).strip()
            if x and not x.startswith("...."):
                lines.append(re.sub(r"_ZN\w+", "<name>", x))
    return lines


def write_form(src_text, name, out_dir, kernel) -> str:
    text = src_text
    for old, new in FORMS[name][2]:
        if old not in text:
            raise ValueError(f"form {name}: {old!r} is not in the source")
        text = text.replace(old, new)
    path = os.path.join(out_dir, f"{kernel}_{name}.cu")
    with open(path, "w") as fh:
        fh.write(text)
    return path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=KERNELS, default="enc")
    ap.add_argument("--quant", choices=["int8"], default=None,
                    help="time the int8 instance on int8 weights (enc, dec, "
                    "decm)")
    ap.add_argument("--forms", default=None, metavar="NAME,...",
                    help="the forms to build (default: all that apply, the "
                    "int8_* ones with --quant int8 only)")
    ap.add_argument("--src", action="append", default=[],
                    metavar="NAME=PATH[@G,O]",
                    help="another copy of csrc/fused_core.cu to time (@G,O: "
                    "rows a weight load feeds in its GRU and other products)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "enc_variants"))
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    kernel = args.kernel
    kname, wrapper, rows_entry, skip = KERNELS[kernel]
    tag = kernel + ("_int8" if args.quant else "")   # output file names
    if args.quant:
        if kernel == "frame":
            ap.error("the frame kernel has no int8 instance")
        skip = "ILb0EE"
    forms = [n for n, (ks, _, _) in FORMS.items() if kernel in ks]
    if args.forms is not None:
        asked = [n for n in args.forms.split(",") if n]
        bad = [n for n in asked if n not in forms]
        if bad:
            ap.error(f"forms {bad} do not apply to --kernel {kernel}")
        forms = asked
    else:
        forms = [n for n in forms if n.startswith("int8_") == bool(args.quant)]
    import torch
    if not torch.cuda.is_available():
        print("enc_variants: no CUDA card", file=sys.stderr)
        return 1
    from radae_tpu_torch.config import flagship_config
    from radae_tpu_torch.convert import load_checkpoint, params_to_torch
    from radae_tpu_torch.models.core import CoreEncoder
    from radae_tpu_torch.ops import _kernels
    from radae_tpu_torch.ops import fused_core as fc
    from radae_tpu_torch.runtime import make_streaming_tx_step

    card = card_line()
    print(f"card: {card}; kernel {kname}")
    os.makedirs(args.out, exist_ok=True)
    committed = str(_kernels.SRC_DIR / "fused_core.cu")
    with open(committed) as fh:
        text = fh.read()
    srcs = {"committed": committed}
    srcs.update({n: write_form(text, n, args.out, tag) for n in forms})
    src_rows = {}
    for s in args.src:
        name, path = s.split("=", 1)
        if "@" in path:
            path, rows = path.rsplit("@", 1)
            src_rows[name] = tuple(int(r) for r in rows.split(","))
        srcs[name] = path

    procs = {}
    for v, src in srcs.items():          # one nvcc a form, all at once
        with open(os.path.join(args.out, f"{tag}_{v}.log"), "w") as log:
            procs[v] = subprocess.Popen(
                [_kernels.nvcc(), *_kernels.NVCC_FLAGS, "-o",
                 os.path.join(args.out, f"lib{tag}_{v}.so"), src],
                stdout=log, stderr=subprocess.STDOUT)
    libs, info = {}, {}
    for v, proc in procs.items():
        status = proc.wait()
        with open(os.path.join(args.out, f"{tag}_{v}.log")) as fh:
            lines = fh.read().splitlines()
        if status != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n" + "\n".join(lines))
        at = [i for i, x in enumerate(lines)
              if "entry function" in x and kname in x
              and not (skip and skip in x)]
        ptxas = [x.strip() for i in at for x in lines[i:i + 4]
                 if "registers" in x or "spill" in x]
        lib = ctypes.CDLL(os.path.join(args.out, f"lib{tag}_{v}.so"))
        for fn, argtypes in _kernels._SIGNATURES["fused_core"].items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if kernel == "frame" and not hasattr(lib, "radae_rx_frame_limit"):
            lib = FixedGeometryFrame(lib)
        with open(srcs[v]) as fh:
            if "n_soff" not in fh.read():
                lib = F32OnlyEntries(lib, _kernels._SIGNATURES["fused_core"])
        libs[v] = lib
        rows = src_rows.get(v) or ((getattr(lib, rows_entry)(),) * 2
                                   if hasattr(lib, rows_entry) else FIRST_ROWS)
        code = sass(os.path.join(args.out, f"lib{tag}_{v}.so"), kname,
                    os.path.join(os.path.dirname(_kernels.nvcc()), "cuobjdump"),
                    skip)
        if code:
            with open(os.path.join(args.out, f"{tag}_{v}.sass"), "w") as fh:
                fh.write("\n".join(code) + "\n")
        if v == "committed":
            ref_sass = code
        info[v] = {"ptxas": ptxas, "rows": rows,
                   "checked": FORMS[v][1] if v in FORMS else True,
                   "sass_lines": len(code) if code else None,
                   "same_sass": (code == ref_sass) if code and ref_sass else None}
        print(f"{v}: ptxas {ptxas}, {info[v]['sass_lines']} SASS "
              f"instructions, the same as committed's: {info[v]['same_sass']}")

    cfg = flagship_config()
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures",
                                           "model_fs_flagship.npz"))
    dev = torch.device("cuda")
    gen = np.random.default_rng(0)
    nz = cfg.Nzmf

    def rand(shape, scale):
        return torch.as_tensor((scale * gen.standard_normal(shape))
                               .astype(np.float32), device=dev)

    if kernel == "enc":
        w = fetch_w = fc.encoder_weights(tree["encoder"], dev,
                                         quant=args.quant)
        x = rand((B, 4 * nz, cfg.feature_dim), 0.3)
        state = fc.encoder_state_zero(B, dev)
        args_k = (cfg.bottleneck,)
        plain = fc.encoder_step_plain
    else:
        state = fc.decoder_state_zero(B, dev, merged=kernel == "decm")
        args_k = ()
        if kernel in ("dec", "decm"):
            w = fetch_w = fc.decoder_weights(tree["decoder"], dev,
                                             merged=kernel == "decm",
                                             quant=args.quant)
            x = torch.tanh(rand((B, nz, cfg.latent_dim), 1.0))
            plain = (fc.decoder_merged_step_plain if kernel == "decm"
                     else fc.decoder_step_plain)
        else:       # a received frame: the plain tx step's samples + noise
            w = fc.fused_rx_weights(tree["decoder"], cfg, dev)
            fetch_w = w.decoder
            tx = make_streaming_tx_step(cfg, CoreEncoder(
                cfg.feature_dim, cfg.latent_dim, cfg.bottleneck), B,
                device=dev)
            enc_p = params_to_torch(tree, dev)["encoder"]
            sig = torch.cat([tx(enc_p, rand((B, 4 * nz, cfg.feature_dim),
                                            0.3), None)[0]
                             for _ in range(2)], dim=1)
            n = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)
            x = (sig[:, :n] + rand((B, n, 2), RX_NOISE)).contiguous()
            plain = fc.rx_frame_step_plain
    state = tuple(rand(tuple(s.shape), 0.5) for s in state)
    block_rows = libs["committed"].radae_block_rows()
    blocks = -(-B // block_rows)

    def run(v):
        with mock.patch.object(_kernels, "library", lambda name: libs[v]):
            return getattr(fc, wrapper)(w, x, state, *args_k)

    with torch.no_grad():
        op, sp = plain(w, x, state, *args_k)
        want = (op,) + sp
        for v in libs:
            (o1, s1), (o2, s2) = run(v), run(v)
            torch.cuda.synchronize()
            got = (o1,) + s1
            if info[v]["checked"]:
                check_close(f"form {v}", got, want, TOL)
            info[v]["max_abs_err"] = max_err(got, want)
            info[v]["same_bits"] = all(
                torch.equal(a, b) for a, b in zip(got, (o2,) + s2))
            if v == "committed":
                ref_out = got
            info[v]["bits_as_committed"] = all(
                torch.equal(a, b) for a, b in zip(got, ref_out))
        times = {v: [] for v in libs}
        order = list(libs)
        for r in range(args.reps):
            for v in (order if r % 2 == 0 else order[::-1]):
                times[v].append(graph_ms(lambda: run(v)))
    for v in libs:
        ms = sum(times[v]) / args.reps
        fetch = weight_fetch_bytes(fetch_w, *info[v]["rows"], block_rows) \
            * blocks * nz
        info[v].update(ms=ms, runs=times[v], weight_bytes_per_launch=fetch,
                       weight_tb_s=fetch / (ms * 1e-3) / 1e12)
        print(f"{v}: {ms:.4f} ms (rounds {[round(t, 4) for t in times[v]]}), "
              f"err {info[v]['max_abs_err']:.3g}"
              f"{'' if info[v]['checked'] else ' (not checked)'}, same bits "
              f"{info[v]['same_bits']} (as committed's: "
              f"{info[v]['bits_as_committed']}), weights {fetch / 1e9:.4f} GB a launch "
              f"({info[v]['weight_tb_s']:.2f} TB/s)")
    with open(os.path.join(args.out, f"{tag}_variants.json"), "w") as fh:
        json.dump({"card": card, "kernel": kname, "quant": args.quant,
                   "batch": B, "nz": nz,
                   "forms": info}, fh, indent=1)
    print(card)
    return 0

if __name__ == "__main__":
    sys.exit(main())
