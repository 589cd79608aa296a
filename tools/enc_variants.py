#!/usr/bin/env python3
"""Time forms of one tile kernel (the encoder enc_kernel, the unmerged
decoder dec_kernel, the chain-merged decoder dec_merged_kernel or the
whole-frame rx_frame_kernel) against each other on one CUDA card, in turns,
in one run.

    python3 tools/enc_variants.py [--kernel enc|dec|decm|frame]
                                  [--quant int8 | --bf16 f32|bf16|int8 [--pad]]
                                  [--forms A,B]
                                  [--src NAME=PATH[@G,O] ...] [--out DIR]
                                  [--reps N] [--seeds N] [--latent 80|40]
                                  [--exact] [--mixed] [--chain N]

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
fused_rx_frame_step) on the flagship weights (--latent 40: the latent-40
fixture's) at B=2048, one frame (nz=3) a call, with random inputs and state
from a seed; --seeds N holds the forms against the plain version on the
inputs of N seeds (for the bf16 instances printing, per seed and form, the
elements past chip_smoke.py's BF16_TOL and the max and mean error of a
tensor over its scale) and times them on the first.
The checked forms are held against the plain version (rtol 1e-4, atol
1e-4: each seed's largest |err| / (atol + rtol |want|) is printed, and a
form past it is listed and fails the run after the timing); the forms that
take a cost out on purpose give wrong results and are timed only.  --exact
(f32 products, not the frame kernel) also holds each form and the plain
version against the plain version run in f64 (every product, bias and gate
in f64: the sums rounded once), so a form's own error shows apart from the
plain version's.  --mixed runs the int8 weights with chip_smoke.py's
MIXED matrices kept in f32; --chain N holds each seed's N calls chained
from the zero state (chip_smoke.py's phase 2) instead of one call from a
random state (the timing keeps the first seed's random state).  For each form it prints the ptxas line of the kernel, the max
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
named int8_*, or with --bf16 KIND the instance with bf16 products on
weights of that kind (f32, bf16 or int8; --pad: the merged decoder's padded
layout), held against the plain version under chip_smoke.py's BF16_*
limits.  Every one of them runs on the tensor cores, on the weights the
wrapper packs at its first launch (`mma_weights`): on f32 weights the
split instances of the encoder and both decoders (the kind-0 matrices as
hi, mid and lo copies).  A --src library whose entries predate the packed
weights (all four, or the encoder's and the unmerged decoder's) is called
through `NoMmaEntries` and runs those forms on its FMA loops, and one
without a kernel's split instance (`SPLIT_KERNELS` names the launch it
looks for) runs that kernel's f32-weight forms on its FMA loops, so
`--bf16 f32 --src parent=` of such a source times the split instance in
turns against the FMA instance it replaced.  `--kernel dec|enc|decm
--quant int8 [--pad]` times the int8 instance with f32 products, which runs
on the tensor cores on x's three bf16 parts (KindSplitXArgs); a --src
library without it (`XSPLIT_KERNELS`) runs those launches on its FMA int8
instance: the unmerged decoder's and the encoder's through its f32 entry
(`BeforeMmaEntries`, which also sends their bf16-product launches to the
bf16 entries such a source has in place of the mma entries), the merged
layout's through its merged entry (`FmaInt8Merged`) and the padded
layout's through its x entry, so `--src parent=` times the two in turns.
`--kernel decm --pad` (no --quant, no --bf16) times the padded f32 form,
which runs every matrix on x's parts as six bf16 products (the merged
decoder's instance <false, false, KindSplitXArgs>); a --src library
without it (`PAD_F32_XSPLIT`) runs that form on its FMA loops, so `--src
parent=` times the two in turns.
For each --src library it also prints, instance by instance of every
kernel, whether its SASS equals the committed build's.
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

from chip_smoke import (BF16_FLIPS, BF16_MAX, BF16_MEAN,  # noqa: E402
                        MIXED, RX_NOISE, TOL, bf16_errs, card_line,
                        graph_ms, max_err, packed_sizes, weight_fetch_bytes)

B = 2048
FIRST_ROWS = (2, 4)  # rows a weight load feeds in a source that does not say:
                     # the first kernels (2 in the GRU products, 4 else)
# --kernel -> (name of the __global__ function, wrapper, library entry of its
# tile rows).  Each is a template whose first bool is Q (int8) or, for the
# frame kernel, FIX (the flagship geometry as constants); the tool takes the
# instances whose further bools (bf16 products, the padded layout) are all
# false: the f32 one, or with --quant int8 the int8 one, and both FIX
# instances of the frame kernel, whose ptxas lines and SASS go together
KERNELS = {"enc": ("enc_kernel", "fused_encoder_step", "radae_enc_tile_rows"),
           "dec": ("dec_kernel", "fused_decoder_step", "radae_dec_tile_rows"),
           "decm": ("dec_merged_kernel", "fused_decoder_step",
                    "radae_dec_tile_rows"),
           "frame": ("rx_frame_kernel", "fused_rx_frame_step",
                     "radae_dec_tile_rows")}
ALL = tuple(KERNELS)
CHECKPOINTS = {80: "model_fs_flagship.npz", 40: "model_l40.npz"}
NO_MMA = set()       # the libraries that run the kernel's form on FMA loops
# those with a split instance (f32 weights): a pattern of its launch in a
# source that has it (the merged decoder's instances had a third bool, the
# padded layout, before its padded f32 form ran on the tensor cores)
SPLIT_KERNELS = {"enc": r"enc_kernel<true, true, KindSplitArgs",
                 "dec": r"dec_kernel<true, true, KindSplitArgs",
                 "decm": r"dec_merged_kernel<true, true, (true, )?KindSplitArgs"}
# the int8 instances with f32 products (on x's parts): a pattern of each
# one's launch in a source that has it
XSPLIT_KERNELS = {"enc": r"enc_kernel<true, false, KindSplitXArgs",
                  "dec": r"dec_kernel<true, false, KindSplitXArgs",
                  "decm": r"dec_merged_kernel<true, false, (true, )?KindSplitXArgs"}
# the padded f32 form on x's parts (--kernel decm --pad without --quant and
# --bf16): the pattern of its launch in a source that has it
PAD_F32_XSPLIT = r"dec_merged_kernel<false, false, KindSplitXArgs"
# --kernel -> its entry with bf16 products in a source whose entries may
# predate the packed weights (`NoMmaEntries`)
MMA_ENTRY = {"enc": "radae_fused_encoder_bf16_step",
             "dec": "radae_fused_decoder_bf16_step",
             "decm": "radae_fused_decoder_merged_x_step",
             "frame": "radae_fused_rx_frame_bf16_step"}
MMA_KERNELS = ("enc", "dec", "decm", "frame")   # those with an MM instance
# the mma entries, by where their bf16 flag sits
MMA_FLAG = {"radae_fused_decoder_mma_step": 12,
            "radae_fused_encoder_mma_step": 13}

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
# the forms that change them apply to all three kernels.  (8-row tiles are
# no form since the tensor-core route: an mma.sync A tile is 16 rows.)
FORMS = {
    "cpasync": (("enc",), True, _CPASYNC),  # weights through a cp.async ring
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
        ("""  const int rk = MM ? r0 + kl : ksum(acc, kl, r0);
  if (put) {
#pragma unroll
    for (int i = 0; i < ET / 8; ++i)
      st4(dst + (rk + rs * i) * ld, add4(mul4(acc[i], s), bias));""",
         """  const int rk = MM ? r0 + kl : ksum(acc, kl, r0);
  if (put) {
    const float4 s = ldg4(sp);
#pragma unroll
    for (int i = 0; i < ET / 8; ++i)
      st4(dst + (rk + rs * i) * ld, add4(mul4(acc[i], s), bias));"""),
        ("scl<Q, BF>(sc, c, out), b,", "Q ? sc + c : nullptr, b,"),
        ("const float4 gi = scl<Q, BF>(si, c, DEC_G), gh = scl<Q, BF>(sh, c, DEC_G);",
         "const float *gi = Q ? si + c : nullptr, *gh = Q ? sh + c : nullptr;"),
        ("const float4 gi = scl<Q, BF>(si, c, ENC_G), gh = scl<Q, BF>(sh, c, ENC_G);",
         "const float *gi = Q ? si + c : nullptr, *gh = Q ? sh + c : nullptr;"),
        ("scl<Q, BF>(sc(4 + 5 * i + tap), c, DEC_CO)",
         "Q ? sc(4 + 5 * i + tap) + c : nullptr"),
        ("scl<Q, BF>(sc(0), c, ENC_H)", "Q ? sc(0) + c : nullptr"),
        ("scl<Q, BF>(sc(3 + 4 * i + tap), c, ENC_CO)",
         "Q ? sc(3 + 4 * i + tap) + c : nullptr"),
        ("scl<Q, BF>(sc(ENC_NS - 1), c, od)", "Q ? sc(ENC_NS - 1) + c : nullptr")]),
    # int8 instance: QuantArgs without __grid_constant__, so each thread
    # copies it to local memory to index soff
    "int8_qalocal": (("enc", "dec", "decm"), True, [
        ("const __grid_constant__ KA qa)", "const KA qa)")]),
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
        ("        tmac(acc, S, row, r0, a.dft_w, yw, c, 0, row, kl);\n",
         "        ;\n")]),
    "nols": (("frame",), False, [         # no LS products
        ("  rowprod<BF>(p0, a.ls_w,", "  if (a.d.B < 0) rowprod<BF>(p0, a.ls_w,"),
        ("  rowprod<BF>(p1, a.ls_w,", "  if (a.d.B < 0) rowprod<BF>(p1, a.ls_w,")]),
    "noprologue": (("frame",), False, [   # the decoder body alone
        ("  const float* const rx = a.rx + (size_t)b0 * nsym * row;\n",
         "  if (a.d.B < 0) {\n"
         "  const float* const rx = a.rx + (size_t)b0 * nsym * row;\n"),
        ("  if constexpr (BF)\n    dec_body<", "  }\n  if constexpr (BF)\n    dec_body<")]),
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
    # the tensor-core route (tmma; the MM instances: --bf16 bf16 or int8
    # for enc, dec and decm, any --bf16 for frame): B 1 or 4 K-step pairs
    # ahead, not 2 (the split and the f32-product routes: splitpairs2)
    "mmapairs1": (MMA_KERNELS, True, [
        ("constexpr int MMA_PAIRS = 2;", "constexpr int MMA_PAIRS = 1;")]),
    "mmapairs4": (MMA_KERNELS, True, [
        ("constexpr int MMA_PAIRS = 2;", "constexpr int MMA_PAIRS = 4;")]),
    "mmanoswz": (MMA_KERNELS, True, [      # every lane the pair's first
        ("  const bool odd = kl & 1;\n", "  const bool odd = false;\n")]),  # step first
    # a K range's sums accumulated inside the tensor cores (the same
    # products, other bits)
    "mmanofadd": (MMA_KERNELS, True, [
        ("  float4 e0 = make_float4(0.f, 0.f, 0.f, 0.f), e1 = e0;\n",
         "  float4 &e0 = d0, &e1 = d1;\n"),
        ("  d0 = add4(d0, e0);\n  d1 = add4(d1, e1);\n", "")]),
    # the split route (--bf16 f32: enc, dec, decm): a step's hi products
    # summed from zero first, then mid's and lo's onto them in the tensor
    # cores (the committed order is lo, mid, hi)
    "splithifirst": (SPLIT_KERNELS, True, [
        ("""  float4 e0 = make_float4(0.f, 0.f, 0.f, 0.f), e1 = e0;
  if constexpr (SPLIT) {
    mma16816(e0, a0, a1, a2, a3, l.x, l.y);
    mma16816(e1, a0, a1, a2, a3, l.z, l.w);
    mma16816(e0, a0, a1, a2, a3, m.x, m.y);
    mma16816(e1, a0, a1, a2, a3, m.z, m.w);
  }
  mma16816(e0, a0, a1, a2, a3, b.x, b.y);
  mma16816(e1, a0, a1, a2, a3, b.z, b.w);""", """  float4 e0 = make_float4(0.f, 0.f, 0.f, 0.f), e1 = e0;
  mma16816(e0, a0, a1, a2, a3, b.x, b.y);
  mma16816(e1, a0, a1, a2, a3, b.z, b.w);
  if constexpr (SPLIT) {
    mma16816(e0, a0, a1, a2, a3, m.x, m.y);
    mma16816(e1, a0, a1, a2, a3, m.z, m.w);
    mma16816(e0, a0, a1, a2, a3, l.x, l.y);
    mma16816(e1, a0, a1, a2, a3, l.z, l.w);
  }""")]),
    # the split route (and the f32-product route on int8 weights, --quant
    # int8) with B two K-step pairs ahead, not one
    "splitpairs2": (SPLIT_KERNELS, True, [
        ("constexpr int MMA_SPLIT_PAIRS = 1;", "constexpr int MMA_SPLIT_PAIRS = 2;")]),
    "mmanoxload": (MMA_KERNELS, False, [   # A from registers
        ("""    const float4 pa = va ? ld4(x0 + ka) : z, pb = va ? ld4(x1 + ka) : z;
    const float4 qa = vb ? ld4(x0 + kb) : z, qb = vb ? ld4(x1 + kb) : z;""",
         """    const float4 pa = make_float4(ka, t, va, vb), pb = pa, qa = pa, qb = pa;""")]),
    "mmawfixed": (MMA_KERNELS, False, [    # every pair reloads the first
        ("    wp += 2 * WS;\n    const int ka", "    const int ka")]),   # pairs' B
    # the encoder's int8 instance with f32 products (--quant int8) with x
    # hi's products in the one sum of the step (XS_SPLIT, the decoders'
    # route)
    "xschain": (("enc",), True, [
        ("constexpr int XS = has_xsplit<KA> ? XS_SEP : 0;",
         "constexpr int XS = has_xsplit<KA> ? XS_SPLIT : 0;")]),
    # the int8 instances with f32 products (--quant int8): x in two bf16
    # parts, hi and mid, against an int8 matrix (lo's MMAs dropped)
    "xsplit2": (tuple(XSPLIT_KERNELS), True, [
        ("    mma2(e0, e1, xl, b);                // x lo: the third part\n", "")]),
    "mmanoproducts": (MMA_KERNELS, False, [  # no tmma loops
        ("  static_assert(ET == 16, \"an mma.sync A tile is the item's 16 rows\");\n",
         "  static_assert(ET == 16, \"an mma.sync A tile is the item's 16 rows\");\n"
         "  return;\n")]),
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


class FmaInt8Merged:
    """A library built from a source whose merged decoder has no int8
    instance on the tensor cores (before XSPLIT_KERNELS["decm"]): an int8 launch of
    the merged layout, which the wrapper sends to the x entry with the
    packed weights, goes to its radae_fused_decoder_merged_step (its FMA
    int8 instance) without the layout flags and the packed weights."""

    X = "radae_fused_decoder_merged_x_step"

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name == self.X:
            x, m = getattr(self._lib, name), self._lib.radae_fused_decoder_merged_step
            return lambda *a: (m(*a[:12], *a[16:]) if a[5] and not a[12]
                               and not a[13] else x(*a))
        return getattr(self._lib, name)


class BeforeMmaEntries:
    """A library built from a source whose unmerged decoder and encoder
    have bf16 entries in place of the mma entries (before their int8
    instances with f32 products ran on the tensor cores): an mma launch
    with bf16 products goes to the bf16 entry without the flag, one with
    f32 products (int8 weights) to the f32 entry (then its FMA int8
    instance) without the flag and the packed weights."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name in MMA_FLAG:
            lib, i = self._lib, MMA_FLAG[name]

            def call(*a):
                if a[i]:
                    return getattr(lib, name.replace("_mma_", "_bf16_"))(
                        *a[:i], *a[i + 1:])
                return getattr(lib, name.replace("_mma_", "_"))(
                    *a[:i], *a[i + 3:])
            return call
        return getattr(self._lib, name)


class NoMmaEntries:
    """A library built from a source some of whose entries with bf16
    products (`entries`) predate the packed weights of the tensor-core
    route: takes those entries' arguments of today and drops the packed
    buffer and its offsets (that source runs their forms on its FMA
    loops)."""

    AT = {"radae_fused_decoder_merged_x_step": 14,   # where the two sit
          "radae_fused_rx_frame_bf16_step": 17,
          "radae_fused_decoder_bf16_step": 12,
          "radae_fused_encoder_bf16_step": 13}

    def __init__(self, lib, signatures, entries):
        self._lib = lib
        self._at = {fn: self.AT[fn] for fn in entries}
        for fn, i in self._at.items():
            getattr(lib, fn).argtypes = signatures[fn][:i] + signatures[fn][i + 2:]

    def __getattr__(self, name):
        if name in self._at:
            fn, i = getattr(self._lib, name), self._at[name]
            return lambda *args: fn(*args[:i], *args[i + 2:])
        return getattr(self._lib, name)


def entries_without_mma(src_text):
    """The entries of `NoMmaEntries.AT` that the source defines without
    the packed weights (no `moff` among their parameters)."""
    out = []
    for fn in NoMmaEntries.AT:
        m = re.search(r"int " + fn + r"\(([^)]*)\)", src_text)
        if m and "moff" not in m.group(1):
            out.append(fn)
    return out


def instance(name, kname, quant=None, bf16=None, pad=False):
    """Whether the mangled `name` is an instance of kernel `kname` that the
    tool takes: its template bools after the first all false, and the first
    (Q) false, or true with quant; any for the frame kernel (FIX).  With
    bf16 (the weights' kind): the instance with bf16 products (its second
    bool, BF), for the encoder and both decoders the tensor-core one
    (KindMmaArgs) unless the weights are f32, and then the split one
    (KindSplitArgs), or in a source from before the merged decoder's split
    instance that decoder's FMA one (KindArgs).  pad (the merged decoder's
    padded f32 form): its instance on x's parts (KindSplitXArgs), or in a
    source from before it the FMA one (KindArgs)."""
    m = re.search(kname + r"I((?:Lb[01]E)+)", name)
    if not m:
        return False
    flags = re.findall(r"Lb([01])E", m.group(1))
    if quant and kname == "dec_merged_kernel":   # the int8 ones with f32
        return flags[:2] == ["1", "0"]           # products, either layout
    if kname == "dec_merged_kernel" and not (quant or bf16):   # f32 forms
        ka = r"(KindSplitXArgs|KindArgs)" if pad else r"QuantArgs"
        return flags[:2] == ["0", "0"] and re.search(ka + r"ILi", name) is not None
    if bf16:
        args = (("KindMmaArgs",) if bf16 != "f32" else
                ("KindSplitArgs", "KindArgs") if kname == "dec_merged_kernel"
                else ("KindSplitArgs",))
        ka = re.search(r"(KindSplitArgs|KindMmaArgs|KindArgs)ILi", name)
        return flags[1] == "1" and (kname == "rx_frame_kernel" or (
            ka is not None and ka.group(1) in args))
    return (not any(f == "1" for f in flags[1:])
            and (kname == "rx_frame_kernel" or (flags[0] == "1") == bool(quant)))


def instance_key(name):
    """A kernel instance by its kernel, template bools and argument class,
    whatever else its mangled name says (None for no kernel).  The merged
    decoder's third bool (the padded layout, in a source from before its
    padded f32 form ran on the tensor cores) is dropped: each of its
    instances but the FMA padded one took either layout alike."""
    m = re.search(r"([a-z][a-z_]*_kernel)I((?:Lb[01]E)+)", name)
    if not m:
        return None
    ka = re.search(r"(QuantArgs|KindSplitXArgs|KindSplitArgs|KindMmaArgs|"
                   r"KindArgs)ILi", name)
    flags = re.findall(r"Lb([01])E", m.group(2))
    if m.group(1) == "dec_merged_kernel":
        flags = flags[:2]
    return (m.group(1) + "<" + ",".join(flags)
            + (", " + ka.group(1) if ka else "") + ">")


def sass_by_instance(lib_path, cuobjdump):
    """instance_key -> SASS lines (as `sass` strips them) of every kernel
    instance in the library (None without cuobjdump)."""
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    res = {}
    for b in out.split("Function : ")[1:]:
        key = instance_key(b.splitlines()[0])
        if key:
            res[key] = [re.sub(r"_ZN\w+", "<name>",
                               re.sub(r"/\*\s*[0-9a-fx]+\s*\*/", "", x).strip())
                        for x in b.splitlines()[1:]
                        if x.strip() and not x.strip().startswith("....")]
    return res


def sass(lib_path, kname, cuobjdump, quant=None, bf16=None, pad=False):
    """The SASS of the kernel's instances that the tool takes (`instance`),
    without addresses, encodings and the source-dependent mangled names
    (None without cuobjdump)."""
    if not os.path.exists(cuobjdump):
        return None
    out = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True,
                         text=True, check=True).stdout
    body = [b for b in out.split("Function : ")[1:]
            if instance(b.splitlines()[0], kname, quant, bf16, pad)]
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
    ap.add_argument("--bf16", choices=["f32", "bf16", "int8"], default=None,
                    help="time the instance with bf16 products on weights of "
                    "this kind")
    ap.add_argument("--pad", action="store_true",
                    help="decm: the padded layout (merged=\"pad\")")
    ap.add_argument("--forms", default=None, metavar="NAME,...",
                    help="the forms to build (default: all that apply, the "
                    "int8_* ones with --quant int8 only)")
    ap.add_argument("--src", action="append", default=[],
                    metavar="NAME=PATH[@G,O]",
                    help="another copy of csrc/fused_core.cu to time (@G,O: "
                    "rows a weight load feeds in its GRU and other products)")
    ap.add_argument("--out", default=os.path.join(ROOT, "build", "enc_variants"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--seeds", type=int, default=1,
                    help="hold the forms against the plain version on the "
                    "inputs of this many seeds (the first is timed)")
    ap.add_argument("--exact", action="store_true",
                    help="f32 products: also the TOL ratio of each form and of "
                    "the plain version against the plain version in f64")
    ap.add_argument("--mixed", action="store_true",
                    help="int8 weights with chip_smoke.py's MIXED matrices "
                    "kept in f32")
    ap.add_argument("--chain", type=int, default=1, metavar="N",
                    help="hold N chained calls from the zero state a seed")
    ap.add_argument("--latent", type=int, choices=sorted(CHECKPOINTS),
                    default=80, help="the model: the flagship (80) or the "
                    "latent-40 fixture")
    args = ap.parse_args(argv)
    kernel = args.kernel
    kname, wrapper, rows_entry = KERNELS[kernel]
    tag = (kernel + ("_pad" if args.pad else "") + ("_int8" if args.quant else "")
           + ("_mixed" if args.mixed else "")
           + (f"_bf16_{args.bf16}" if args.bf16 else "")
           + ("_l40" if args.latent == 40 else ""))   # output file names
    if args.quant and args.bf16:
        ap.error("--quant int8 and --bf16 pick different instances")
    if (args.quant or args.bf16 == "int8") and kernel == "frame":
        ap.error("the frame kernel has no int8 instance")
    if args.pad and kernel != "decm":
        ap.error("--pad is the merged decoder's layout")
    if args.exact and (args.bf16 or kernel == "frame"):
        ap.error("--exact holds the f32-product forms of enc, dec and decm")
    if args.mixed and "int8" not in (args.quant, args.bf16):
        ap.error("--mixed is an int8 set: --quant int8 or --bf16 int8")
    # the padded f32 form: f32 weights, f32 products, on x's parts
    pad_f32 = args.pad and not (args.quant or args.bf16)
    forms = [n for n, (ks, _, _) in FORMS.items() if kernel in ks]
    if args.forms is not None:
        asked = [n for n in args.forms.split(",") if n]
        bad = [n for n in asked if n not in forms]
        if bad:
            ap.error(f"forms {bad} do not apply to --kernel {kernel}")
        forms = asked
    else:
        forms = [n for n in forms if n.startswith("int8_") == bool(args.quant)
                 and not args.bf16]
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
    # the C signatures of the library's entries and of the bf16 entries an
    # older source has in place of the mma entries (the same without the
    # flag)
    sigs = dict(_kernels._SIGNATURES["fused_core"])
    sigs.update({fn.replace("_mma_", "_bf16_"): sigs[fn][:i] + sigs[fn][i + 1:]
                 for fn, i in MMA_FLAG.items()})
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
    libs, info, sass_cmp = {}, {}, {}
    for v, proc in procs.items():
        status = proc.wait()
        with open(os.path.join(args.out, f"{tag}_{v}.log")) as fh:
            lines = fh.read().splitlines()
        if status != 0:
            raise RuntimeError(f"nvcc failed for {v}:\n" + "\n".join(lines))
        at = [i for i, x in enumerate(lines)
              if "entry function" in x and kname in x
              and instance(x, kname, args.quant, args.bf16, args.pad)]
        ptxas = [x.strip() for i in at for x in lines[i:i + 4]
                 if "registers" in x or "spill" in x]
        lib = ctypes.CDLL(os.path.join(args.out, f"lib{tag}_{v}.so"))
        for fn, argtypes in sigs.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        if kernel == "frame" and not hasattr(lib, "radae_rx_frame_limit"):
            lib = FixedGeometryFrame(lib)
        with open(srcs[v]) as fh:
            src_text = fh.read()
        no_mma = entries_without_mma(src_text)
        if "n_soff" not in src_text:
            lib = F32OnlyEntries(lib, sigs)
        elif no_mma:
            lib = NoMmaEntries(lib, sigs, no_mma)
            if MMA_ENTRY[kernel] in no_mma:
                NO_MMA.add(v)
        if (args.bf16 == "f32" and kernel in SPLIT_KERNELS
                and not re.search(SPLIT_KERNELS[kernel], src_text)):
            NO_MMA.add(v)      # its entry runs f32 weights on FMA loops
        if "radae_fused_decoder_mma_step" not in src_text:
            lib = BeforeMmaEntries(lib)
        if kernel == "decm" and not re.search(XSPLIT_KERNELS["decm"], src_text):
            lib = FmaInt8Merged(lib)
        if (args.quant and kernel in XSPLIT_KERNELS
                and not re.search(XSPLIT_KERNELS[kernel], src_text)):
            NO_MMA.add(v)      # its int8 instances run on FMA loops
        if pad_f32 and not re.search(PAD_F32_XSPLIT, src_text):
            NO_MMA.add(v)      # its padded f32 form runs on FMA loops
        libs[v] = lib
        rows = src_rows.get(v) or ((getattr(lib, rows_entry)(),) * 2
                                   if hasattr(lib, rows_entry) else FIRST_ROWS)
        cuobjdump = os.path.join(os.path.dirname(_kernels.nvcc()), "cuobjdump")
        code = sass(os.path.join(args.out, f"lib{tag}_{v}.so"), kname,
                    cuobjdump, args.quant, args.bf16, args.pad)
        every = sass_by_instance(os.path.join(args.out, f"lib{tag}_{v}.so"),
                                 cuobjdump)
        if code:
            with open(os.path.join(args.out, f"{tag}_{v}.sass"), "w") as fh:
                fh.write("\n".join(code) + "\n")
        if v == "committed":
            ref_sass, ref_every = code, every
        if v not in FORMS and v != "committed":
            if every and ref_every:      # a --src library, instance by instance
                same = sorted(k for k in every if every[k] == ref_every.get(k))
                diff = sorted(k for k in every if k in ref_every
                              and every[k] != ref_every[k])
                print(f"{v}: SASS as committed's in {len(same)} instances "
                      f"{same}; different in {diff}; only in {v}: "
                      f"{sorted(set(every) - set(ref_every))}; only in "
                      f"committed: {sorted(set(ref_every) - set(every))}")
                sass_cmp[v] = {"same": same, "different": diff}
        info[v] = {"ptxas": ptxas, "rows": rows,
                   "checked": FORMS[v][1] if v in FORMS else True,
                   "sass_lines": len(code) if code else None,
                   "same_sass": (code == ref_sass) if code and ref_sass else None}
        print(f"{v}: ptxas {ptxas}, {info[v]['sass_lines']} SASS "
              f"instructions, the same as committed's: {info[v]['same_sass']}")

    cfg = flagship_config(latent_dim=args.latent)
    tree, _ = load_checkpoint(os.path.join(ROOT, "fixtures", CHECKPOINTS[args.latent]))
    dev = torch.device("cuda")
    nz = cfg.Nzmf
    bf = torch.bfloat16
    # the weights' kind: f32 or int8 (--quant), or under bf16 products
    kind = dict(quant="int8" if "int8" in (args.quant, args.bf16) else None,
                dtype=bf if args.bf16 == "bf16" else torch.float32)
    if args.mixed:
        kind["quant_exclude"] = MIXED[{"enc": "fused_encoder_step_int8",
                                       "dec": "fused_decoder_step_int8",
                                       "decm": "fused_decoder_merged_step_int8"}[kernel]]
    if kernel == "enc":
        w = fetch_w = fc.encoder_weights(tree["encoder"], dev, **kind)
        zero = fc.encoder_state_zero(B, dev)
        args_k = (cfg.bottleneck,)
        plain = fc.encoder_step_plain
    else:
        zero = fc.decoder_state_zero(B, dev, merged=kernel == "decm")
        args_k = ()
        if kernel in ("dec", "decm"):
            w = fetch_w = fc.decoder_weights(
                tree["decoder"], dev,
                merged=("pad" if args.pad else kernel == "decm"), **kind)
            plain = (fc.decoder_merged_step_plain if kernel == "decm"
                     else fc.decoder_step_plain)
        else:
            w = fc.fused_rx_weights(tree["decoder"], cfg, dev,
                                    dtype=kind["dtype"])
            fetch_w = w.decoder
            tx = make_streaming_tx_step(cfg, CoreEncoder(
                cfg.feature_dim, cfg.latent_dim, cfg.bottleneck), B,
                device=dev)
            enc_p = params_to_torch(tree, dev)["encoder"]
            plain = fc.rx_frame_step_plain
    if args.bf16:              # bf16 products
        args_k += (bf,)

    def draw(seed, gen=None):
        """The kernel's input and state from a seed (seed 0: the timed
        ones), or the next input and a state from the generator gen."""
        gen = np.random.default_rng(seed) if gen is None else gen

        def rand(shape, scale):
            return torch.as_tensor((scale * gen.standard_normal(shape))
                                   .astype(np.float32), device=dev)

        if kernel == "enc":
            x = rand((B, 4 * nz, cfg.feature_dim), 0.3)
        elif kernel in ("dec", "decm"):
            x = torch.tanh(rand((B, nz, cfg.latent_dim), 1.0))
        else:       # a received frame: the plain tx step's samples + noise
            sig = torch.cat([tx(enc_p, rand((B, 4 * nz, cfg.feature_dim),
                                            0.3), None)[0]
                             for _ in range(2)], dim=1)
            n = (cfg.Ns + 2) * (cfg.M + cfg.Ncp)
            x = (sig[:, :n] + rand((B, n, 2), RX_NOISE)).contiguous()
        return x, tuple(rand(tuple(s.shape), 0.5) for s in zero)

    def calls(seed):
        """[(input, state)] of a seed's calls: one from a random state, or
        (--chain N) N inputs from one generator, the first state zero (each
        later call takes the state its own chain carries)."""
        if args.chain == 1:
            return [draw(seed)]
        gen = np.random.default_rng(seed)
        return [(draw(seed, gen)[0], zero) for _ in range(args.chain)]

    block_rows = libs["committed"].radae_block_rows()
    blocks = -(-B // block_rows)

    def run(v, x, state):
        with mock.patch.object(_kernels, "library", lambda name: libs[v]):
            return getattr(fc, wrapper)(w, x, state, *args_k)

    broke = []      # (seed, form) of a checked form past TOL or a BF16_* limit

    def tol_ratio(got, want):
        """The largest |got - want| / (atol + rtol |want|) of TOL over the
        tensors, in f64."""
        return max(float(((a.double() - b.double()).abs() / (
            TOL["atol"] + TOL["rtol"] * b.double().abs())).max())
            for a, b in zip(got, want))

    def plain_f64(x, state):
        """The plain version in f64: each product x @ w (times its int8
        scale row) and everything after it in f64."""
        ws = [a.double() for a in w.arrays]
        rows = iter(w.scales)
        sc = [next(rows).double() if w.scales and a.dim() == 2 else 1.0
              for a in w.arrays]
        mm = lambda v, j: (v.double() @ ws[j]) * sc[j]
        with mock.patch.object(fc, "_products", lambda *a, **k: mm):
            o, st = plain(w, x.double(), tuple(t.double() for t in state),
                          *args_k)
        return (o,) + tuple(st)

    def held(v, got, want, seed):
        """TOL, or under bf16 products chip_smoke.py's limits (a form past
        them is listed in `broke`, and the run goes on to time the forms and
        then fails); returns bf16_errs summed over the tensors (past the
        tolerance, of, max, mean), or with f32 products the largest |err| /
        (atol + rtol |want|) of TOL"""
        if not args.bf16:
            ratio = tol_ratio(got, want)
            print(f"seed {seed}, {v}: {ratio:.4f} of TOL"
                  + (f" (against f64: {tol_ratio(got, exact):.4f})"
                     if args.exact else ""), flush=True)
            if info[v]["checked"] and not ratio <= 1.0:
                broke.append((seed, v))
            return None
        errs = bf16_errs(got, want)
        lim = BF16_MAX["fused_rx_frame_step" if kernel == "frame" else ""]
        over, n = sum(e[0] for e in errs), sum(e[1] for e in errs)
        mx, mean = max(e[2] for e in errs), max(e[3] for e in errs)
        if info[v]["checked"] and (over > BF16_FLIPS * n or mx >= lim
                                   or mean >= BF16_MEAN):
            broke.append((seed, v))
        return over, n, mx, mean

    with torch.no_grad():
        for seed in range(args.seeds):
            seq = calls(seed)
            s_plain = s64 = seq[0][1]
            s_form = {v: seq[0][1] for v in libs}
            for call, (x, _) in enumerate(seq):
                op, s_plain = plain(w, x, s_plain, *args_k)
                want = (op,) + s_plain
                if args.exact:
                    exact = plain_f64(x, s64)
                    s64 = exact[1:]
                    print(f"seed {seed} call {call}, plain f32 against f64: "
                          f"{tol_ratio(want, exact):.4f} of TOL", flush=True)
                for v in libs:
                    state = s_form[v]
                    (o1, s1), (o2, s2) = run(v, x, state), run(v, x, state)
                    torch.cuda.synchronize()
                    s_form[v] = s1
                    got = (o1,) + s1
                    flips = held(v, got, want, seed)
                    if v == "committed":
                        ref_out = got
                    r = info[v].setdefault("seeds", [])
                    r.append({"max_abs_err": max_err(got, want),
                              "same_bits": all(torch.equal(a, b) for a, b in
                                               zip(got, (o2,) + s2)),
                              "bits_as_committed": all(
                                  torch.equal(a, b) for a, b in zip(got, ref_out)),
                              "bf16": flips})
                    if not args.bf16:
                        r[-1]["tol_ratio"] = tol_ratio(got, want)
                    if args.exact:
                        r[-1]["tol_ratio_f64"] = tol_ratio(got, exact)
                    if flips:
                        print(f"seed {seed}, {v}: {flips[0]} of {flips[1]} past "
                              f"the bf16 tolerance, max {flips[2]:.4f} and mean "
                              f"{flips[3]:.3g} of the scale"
                              + (" PAST A LIMIT" if (seed, v) in broke else ""),
                              flush=True)
        for v in libs:
            r = info[v]["seeds"]
            if not args.bf16:
                info[v]["tol_ratio"] = max(e["tol_ratio"] for e in r)
            info[v].update(max_abs_err=max(e["max_abs_err"] for e in r),
                           same_bits=all(e["same_bits"] for e in r),
                           bits_as_committed=all(e["bits_as_committed"]
                                                 for e in r))
        x, state = draw(0)
    # the packed bytes a launch reads on the tensor-core route (the copy the
    # launches keep in the weight set): every block reads each packed matrix
    # once a z-step (the frame's dft_w once)
    packed_read = None
    kept = list(((w.w if kernel == "frame" else w).mma or {}).values())
    if ((args.bf16 or args.quant or pad_f32) and kept
            and any(o >= 0 for o in kept[0].offsets)):
        dft = len(kept[0].offsets) - 2 if kernel == "frame" else -1
        packed_read = sum(b * blocks * (1 if j == dft else nz)
                          for j, b in packed_sizes(kept[0]).items())
    with torch.no_grad():
        times = {v: [] for v in libs}
        order = list(libs)
        for r in range(args.reps):
            for v in (order if r % 2 == 0 else order[::-1]):
                times[v].append(graph_ms(lambda: run(v, x, state)))
    for v in libs:
        ms = sum(times[v]) / args.reps
        fetch = weight_fetch_bytes(fetch_w, *info[v]["rows"], block_rows) \
            * blocks * nz
        if packed_read is not None and v not in NO_MMA:
            fetch = packed_read
        info[v].update(ms=ms, runs=times[v], weight_bytes_per_launch=fetch,
                       weight_tb_s=fetch / (ms * 1e-3) / 1e12)
        print(f"{v}: {ms:.4f} ms (rounds {[round(t, 4) for t in times[v]]}), "
              f"err {info[v]['max_abs_err']:.3g}"
              + (f" ({info[v]['tol_ratio']:.3f} of TOL)" if "tol_ratio" in info[v]
                 else "")
              + f"{'' if info[v]['checked'] else ' (not checked)'}, same bits "
              f"{info[v]['same_bits']} (as committed's: "
              f"{info[v]['bits_as_committed']}), weights {fetch / 1e9:.4f} GB a launch "
              f"({info[v]['weight_tb_s']:.2f} TB/s)")
    with open(os.path.join(args.out, f"{tag}_variants.json"), "w") as fh:
        json.dump({"card": card, "kernel": kname, "quant": args.quant,
                   "bf16": args.bf16, "pad": args.pad, "latent": args.latent,
                   "batch": B, "nz": nz,
                   "forms": info, "sass_by_instance": sass_cmp,
                   "past_limits": broke}, fh, indent=1)
    print(card)
    if broke:
        print(f"past TOL or the BF16_* limits (seed, form): {broke}",
              file=sys.stderr)
        return 1
    return 0

if __name__ == "__main__":
    sys.exit(main())
