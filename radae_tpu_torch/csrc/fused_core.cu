// Fused RADAE core codec steps for Hopper (sm_90a): the whole recurrent
// encoder or decoder stack, for nz latent steps, in one launch; and the whole
// rx frame (OFDM demod, LS pilot EQ, coarse magnitude, demap, decoder) in one.
//
// Replaces the Pallas TPU kernels in radae_tpu/ops/fused_core.py:
//   radae_fused_decoder_step         <- make_fused_decoder_step, body `kernel`
//                                       (unmerged, f32)
//   radae_fused_decoder_mma_step     <- the same with quant="int8" or
//                                       compute_dtype=bf16 (bf16 flag)
//   radae_fused_decoder_merged_step  <- make_fused_decoder_step, body
//                                       `kernel_merged` (merged=True, f32)
//   radae_fused_decoder_merged_x_step <- the same with quant="int8" (either
//                                       layout), merged="pad" (f32), and
//                                       compute_dtype=bf16 (either layout)
//   radae_fused_rx_frame_step        <- make_fused_rx_frame_step (f32; the
//                                       samples staged by cp.async, the
//                                       port's form of both its rx_dma
//                                       paths)
//   radae_fused_rx_frame_bf16_step   <- the same with compute_dtype=bf16
//   radae_fused_encoder_step         <- make_fused_encoder_step (f32)
//   radae_fused_encoder_mma_step     <- the same with quant="int8" or
//                                       compute_dtype=bf16 (bf16 flag)
// and computes the same functions as the plain PyTorch versions in
// radae_tpu_torch/ops/fused_core.py (decoder_step_plain,
// decoder_merged_step_plain, rx_frame_step_plain, encoder_step_plain).
//
// What bounds it on this card.  One z-step of one stream is ~0.91M (decoder)
// or ~0.94M (encoder) multiply-adds over ~3.6 MB of f32 weights.  At serving
// batch (B=2048, nz=3) the weights are read once per block per z-step and
// reused by the block's R rows, so the arithmetic (2*params*nz*B flop at the
// 67 TFLOP/s f32 rate outside the tensor cores) is the bound, not HBM: the
// 3.6 MB stay resident in the 50 MB L2.  The recurrence is serial in the
// layers (27 dependent products per z-step), so each block walks all nz steps
// and all 5 layers itself with a barrier between dependent products; the TPU
// kernel's sequential grid becomes the loop inside the block.
//
// What the design does about it:
//   * one block per R=16 batch rows (the ragged edge is masked: loads clamp
//     to the last valid row, stores skip rows past B), 384 threads;
//   * the growing concat vector x (736 / 864 floats a row) lives in dynamic
//     shared memory as a ring of per-step buffers, so a conv's delayed input
//     x[t-d] is the same prefix of an earlier step's buffer and never goes
//     back to device memory inside a launch; the carried state (GRU h, conv
//     history) and the inputs are staged into the rings' dead slots in
//     passes that already sit between two barriers, and the state is
//     written at the end, in the unmerged layout of the plain version;
//   * every product is x (shared) @ W (L2, pre-transposed (in, out)), with
//     f32 accumulation, expf/tanhf (no fast math), no atomics and every sum
//     in a fixed order, so two launches on the same input give the same bits.
//
// Every kernel tiles its products over all of the block's rows (tmac +
// kput).  With 2- and 4-row tiles each block fetched its weights 5.8
// (encoder), 6.9 (decoder) and 6.2 (chain-merged decoder) times a z-step.
// Here a thread owns a 16-row x 4-column tile (64 accumulators), so each
// weight float4 it loads feeds 64 multiply-adds and each weight is fetched
// once per block; the parallelism comes from K instead: a warp is 4 column
// quads x 8 K lanes (K interleaved by float4, so 8 lanes read 128 contiguous
// bytes of an x row), summed by a fixed shuffle butterfly, and products too
// narrow for 12 warps split K across warps (partials added in chunk order).
// The decoder's GRU (H=96: 12 r|z and 6 n column groups) splits K in halves
// of [x | h], 36 units in 3 even rounds of 12 warps.  The next K step's
// weights are loaded, without a branch, before this step's multiply-adds.
// Every operand of a product is in shared memory.  What is left of the
// encoder, timed on an H100 by tools/enc_variants.py with one cost taken out
// at a time: the 24 barrier-separated phases of a z-step (0.125 ms of the
// 0.43 ms launch with no product loop in them), then the loops' issue rate;
// the x loads (0.035 ms) and the weight stream from the L2 (0.009 ms)
// matter little.  The decoder has 34 such phases a z-step (0.091 ms of its
// 0.42 ms launch on an H100 with no product loop in them).
//
// The chain-merged decoder has the same products in fewer, wider operands:
// h @ [whh | glu] (96 x 384) and x @ [tap1 | tap0] (in x 64), 17 dependent
// products a z-step instead of 27.  Its state carries the projections (hh
// row 288, conv tap 32) instead of the raw conv history, so a block keeps
// one x buffer, not a ring, and updates h, the hh projection and the tap
// projection in place in shared memory (223,488 B: x 47 KB, h 30 KB, hh
// projections 92 KB, taps 10 KB, scratch 36 KB, the biases of the gate and
// conv passes 6 KB); each is read before it is overwritten within a layer.
// Its x @ wih splits K in halves (18 column groups x 2, 36 units in 3
// rounds); h @ [whh | glu] keeps K = 96 whole (24 units in 2 rounds: a K
// split would need 72 KB of partials) and stores its hh columns straight
// into the projection and its GLU columns, gated, into x, so it needs no
// scratch and no finish pass.  Its phases' slowest warps walk as many K
// steps as the unmerged decoder's, in 5 fewer phases a z-step but with 5
// more work items (3 + 2 + 1 a layer against 3 + 1 + 1).
//
// The frame kernel runs a demod prologue and then the unmerged decoder body
// (dec_body, shared with dec_kernel).  Its modem geometry (Ns data rows,
// Nc carriers, M+Ncp samples a row, latent, nz) comes with the launch, so it
// runs every config the reference's frame step takes within the limits that
// radae_fused_rx_frame_step checks (frame_limit).  The prologue copies the
// block's 16 streams x (Ns+2) symbol rows of interleaved IQ (147,456
// contiguous bytes for the flagship modem) by cp.async into the decoder's
// rings, idle until the first z-step, in FR_STAGES = 2 commit groups, so
// the DFT of the first half of the rows overlaps the copy of the rest.  On
// an H100 the copy (0.015 ms) is bound by the device memory's rate, since
// every block copies at the launch's start: one, three or six stages, or
// plain loads, were no faster (tools/enc_variants.py).  The DFT is a tile
// product of that (16(Ns+2), 2(M+Ncp)) operand and the real DFT block
// matrix (CP strip folded in as zero rows) to [Yr | Yi | 0], 2Nc columns
// padded to a multiple of 4 with zero columns; the two pilot rows go
// through the LS block matrix (a row product, zero rows and columns at the
// pad), the coarse magnitude is reduced over the Nc carriers in a fixed
// order (one thread a stream), and the equalised, scaled data symbols are
// written as [re | im] latents (16 x nz x latent) into shared memory, where
// the decoder body reads them as its z.  Y and the pilot estimates live in
// the decoder's scratch; the bound is the decoder's plus about 4% for the
// demod.
//
// int8 weights.  The encoder and both decoders have an instance (the
// template argument Q) for the weights of radae_tpu's `_fused_weights(
// quant="int8")`: every matrix int8, one byte a weight, with a per-output-
// column f32 scale row, but those its quant_exclude keeps in f32 (a unit
// scale row each), so the kind is a flag per matrix, the same for a whole
// work item (warp-uniform).  The product is f32 x by the int8 matrix as f32
// (the TPU kernel's dot after its astype); the scale multiplies the product
// on its output, the item's summed tile, before the bias (kputq, and the
// merged kernel's GLU epilogue).  A K chunk's partial is scaled on its own,
// and the chunks are added after the barrier: the same sum as scaling their
// total.  The GRU's r|z items, which add x @ wih and h @ whh in one tile in
// f32, put the h product into partials of its own, since the two have
// different scales (12 KB more shared memory for the decoder, 8 KB for the
// encoder).  Every int8 instance runs its products on the tensor cores (the
// x-split route, below): on FMA loops the conversion of each int8 weight
// made them 1.10-1.19 times slower than the f32 instances.  The frame
// kernel stays f32: radae_tpu's frame kernel has no quant.
//
// bf16 products (compute_dtype=bf16).  Each body has one more instance
// (BF) that rounds each product's x to bf16 (round to nearest even) where
// it loads it, so the f32 values that the gate math, the state and the
// stored x read are never rounded; the products of bf16 values are exact
// in f32 and the sums stay f32, as the TPU's dot with f32 accumulation.
// Its matrices come in four kinds, a flag per array (KindArgs): int8 (with
// its scale row, as in the int8 instance), bf16, f32 (kind 0: bf16 x f32,
// which promotes to f32), and f32 rounded to bf16 at the product (kind 3:
// the TPU kernel's _gru_step and its frame kernel round both inputs; its
// other dots round only x unless the weights are int8, so the runtime says
// which).  The BF instances of the decoders and the encoder take the int8
// instance's form (the GRU's h products in partials of their own, scales
// on the outputs; none without scale rows); the frame's takes the f32
// form.  Every BF instance runs its products on the tensor cores.
//
// The tensor cores (MM instances).  Where every product is bf16 x bf16 --
// the BF instances of dec_kernel, enc_kernel and the merged decoder on
// int8, bf16 or rounded matrices (kinds 1..3), and the frame kernel's BF
// instance, which rounds both inputs of every product -- the FMA loops
// spent their time on the roundings and the FMAs, 24-55 times the bound
// that the same work has on the tensor cores (the bytes: each stack is
// about 0.9M weights a z-step).  On f32 weights the unmerged decoder and the
// encoder (GRU matrices kind 3, the rest kind 0) and the chain-merged
// decoder (every matrix kind 0) have a split instance (KindSplitArgs): a
// kind-0 matrix w is packed three times, hi = bf16(w), mid = bf16(w - hi)
// and lo = bf16(w - hi - mid) (each difference exact in f32, and hi + mid +
// lo = w but where w is tiny), and x hi + x mid + x lo, three MMAs on the
// same A fragment, is the bf16 x f32 product (tmma<true>).  The int8
// instances with f32 products (KindSplitXArgs: dec_kernel, enc_kernel and
// the merged decoder in either layout; radae_tpu's jnp.dot of f32 x and the
// int8 matrix as f32) swap the two sides: every
// int8 weight is exact in bf16, so the matrix is packed once, widened, and
// x, f32, is split where it is loaded into hi, mid and lo (xparts: the
// remainder past lo is below 2^-27 |x|), three MMAs a step on one B copy
// (tmma<false, XS>); a matrix that quant_exclude keeps in f32 is packed
// split and multiplied as the six products of x's and w's parts at or above
// 2^-18 of the largest (tmma<true, XS>).  The padded layout's f32 form
// runs on the merged decoder's x-split instance too, every matrix so
// (Q false: no scale rows).  Their results are held to the
// f32 instances' tolerance, not to the bf16 products' one.  On an H100 the
// merged one takes 0.30 ms in either layout against 0.48 and 0.50 for the
// FMA instances it replaced and the unmerged decoder's 0.31 against 0.44
// (tools/enc_variants.py, in turns; the encoder's, which sums x hi's
// products apart, XS_SEP below, in PERF.md); two x parts
// would take 0.25-0.31 (the decoders within the tolerance, but at a third
// of it on the CPU estimate of tools/split_flips.py against a fiftieth with
// three; the encoder 15 times past it).
// Two parts are not enough: |w - hi - mid| reaches 2^-17 |w|, and on the
// fixture weights that took the encoder's bf16 input flips against the plain
// version to 12-14 times those of an exact product, past chip_smoke.py's
// BF16_FLIPS (and BF16_MAX at latent 40); three parts flip 0.9-1.2 times as
// often (tools/split_flips.py, on the CPU).  These
// instances run every product on mma.sync m16n8k16 (tmma): the block's 16
// rows are one A tile read from the f32 operands in shared memory and
// rounded as they are loaded (2 float4 and 4 cvt.rn.bf16x2 a lane and K
// step, where tmac rounded every float4 it read for each column quad), and
// the weights come as B fragments packed once per weight set on the host
// (ops/fused_core.py mma_weights: bf16, int8 widened to bf16, exact, the
// scale rows kept on the outputs; a padded matrix packs to its merged one),
// one 16-byte coalesced load a lane and
// K step.  The work items, K chunks, partials and epilogues stay as they
// are (an item's rows are then g and g + 8 instead of ksum's rk, rk + 1);
// sums stay f32 in a fixed order.  On an H100 they take 0.212 (merged) and
// 0.251 ms (frame) against 0.554 and 0.610 for the FMA loops (the unmerged
// decoder's and the encoder's times: PERF.md's kernel table); what bounds
// them now is the tmma loops' own issue (loads, conversions, selects and
// MMAs: 0.14 / 0.15 ms), then the barrier-separated phases with no product
// loop in them (0.056 / 0.093 ms); the 0.70 GB of packed weights the blocks
// stream from the L2 a launch cost 0.014 ms once two K-step pairs are in
// flight (tools/enc_variants.py forms).
//
// The padded layout (merged="pad").  The TPU's chain-merged kernel can
// store each x segment (x0, then each layer's GLU and conv outputs) in a
// 128-lane window, and its x operands (wih, [tap1 | tap0], out) then hold
// segment j's rows from row 128 j, zero rows between.  Here x stays
// contiguous in shared memory and every padded matrix is packed as its
// merged one (mma_weights drops the zero rows), so the merged decoder's
// tensor-core instances run both layouts alike and the padded operands
// fetch no extra bytes (radae_tpu promises about 1e-6 relative between the
// two layouts).  Each padded form runs on those instances: with bf16
// products, on int8 weights, and on f32 weights with f32 products (the
// x-split instance with Q false).
//
// Built by radae_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: plain C entries, pointers and the stream passed as
// void*, the launch status returned as cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int R = 16;     // batch rows per block
constexpr int NT = 384;   // threads per block
constexpr int NWARP = NT / 32;

// tile products (tmac): a thread's tile is ET rows x 4 columns
constexpr int ET = 16;
constexpr int RG = R / ET;                     // row groups a block
static_assert(ET % 8 == 0 && R % ET == 0, "a lane keeps ET/8 rows after the K sum");

// decoder widths (radae_tpu/models/core.py:41-43)
constexpr int DEC_H = 96, DEC_G = 3 * DEC_H, DEC_CO = 32, DEC_X = 736;
constexpr int DEC_NW = 2 + 5 * 8 + 2;
constexpr int DEC_NWM = 2 + 5 * 6 + 2;         // chain-merged layout
constexpr int DEC_NS = 1 + 5 * 5 + 1;          // int8 scale rows, unmerged
constexpr int DECM_NS = 1 + 5 * 3 + 1;         //   and merged
constexpr int DEC_GG = DEC_G + DEC_H;          // [whh | glu] columns
// encoder widths (radae_tpu/models/core.py:37-39)
constexpr int ENC_H = 64, ENC_G = 3 * ENC_H, ENC_CO = 96, ENC_X = 864;
constexpr int ENC_NW = 2 + 5 * 7 + 2;
constexpr int ENC_NS = 1 + 5 * 4 + 1;          // int8 scale rows

// The arrays of a layout that are matrices: d1_w, out_w and per layer the
// bits of `layer` from array 2 + per * i on (an int8 launch may mark only
// these as int8)
constexpr unsigned long long mat_mask(int nw, int per, unsigned long long layer) {
  unsigned long long m = 1ull | 1ull << (nw - 2);
  for (int i = 0; i < 5; ++i) m |= layer << (2 + per * i);
  return m;
}
constexpr int popcount(unsigned long long m) { return m ? (int)(m & 1) + popcount(m >> 1) : 0; }
constexpr unsigned long long DEC_MATS = mat_mask(DEC_NW, 8, 0x73);   // wih whh glu cw0 cw1
constexpr unsigned long long DECM_MATS = mat_mask(DEC_NWM, 6, 0x13); // wih wgg cw
constexpr unsigned long long ENC_MATS = mat_mask(ENC_NW, 7, 0x33);   // wih whh cw0 cw1
static_assert(popcount(DEC_MATS) == DEC_NS && popcount(DECM_MATS) == DECM_NS &&
                  popcount(ENC_MATS) == ENC_NS,
              "a scale row per matrix");

// unmerged decoder (dec_body): x ring + h ring, then the tile products'
// partial sums, the widest the GRU's two K halves of its gate sums
constexpr int DEC_RING = 2 * R * DEC_X + 2 * 5 * R * DEC_H;   // floats
constexpr int DEC_GS = DEC_G + DEC_H;          // gate sums: r|z, x@n, h@n
constexpr int DEC_RZ = 2 * DEC_H / 16, DEC_NG = DEC_H / 16;  // column groups
constexpr int DEC_GU = 2 * (DEC_RZ + DEC_NG);  // GRU units: groups x halves
constexpr int DEC_CONV_KS = 3;                 // K chunks of each conv tap
constexpr int DEC_TMAX_OUT = 96;               // 6 column groups >= 4 * 21
constexpr size_t DEC_SMEM = sizeof(float) * (DEC_RING + 2 * R * DEC_GS);
// the int8 instance adds the r|z groups' h @ whh partials [R][2 DEC_H]
constexpr size_t DEC_SMEM_Q = DEC_SMEM + sizeof(float) * R * 2 * DEC_H;
static_assert(DEC_H % 16 == 0 && DEC_CO % 16 == 0, "whole column groups");
static_assert(R * DEC_H / 4 == NT && R * DEC_CO / 4 <= NT &&
                  R * DEC_TMAX_OUT / 4 <= NT,
              "each finish pass is at most one float4 a thread");
static_assert(2 * DEC_CONV_KS * R * DEC_CO <= 2 * R * DEC_GS &&
                  2 * R * DEC_TMAX_OUT <= 2 * R * DEC_GS,
              "every partial buffer fits the scratch");
static_assert(DEC_SMEM_Q <= 232448, "opt-in shared memory of one block");

// encoder products (enc_kernel)
constexpr int ENC_GS = ENC_G + ENC_H;          // gate sums: r|z, x@n, h@n
constexpr int ENC_SCR = R * ENC_GS;
constexpr int ENC_D1_KS = 3, ENC_Z_KS = 2;     // K chunks of dense_1, z_dense
constexpr int ENC_MAX_OUT = 96;                // >= latent 80
constexpr int ENC_FOFF = ENC_X - ENC_CO;       // features staged at x[768..]
constexpr size_t ENC_SMEM = sizeof(float) * (3 * R * ENC_X + ENC_SCR);
// the int8 instance adds the r|z groups' h @ whh partials [R][2 ENC_H]
constexpr size_t ENC_SMEM_Q = ENC_SMEM + sizeof(float) * R * 2 * ENC_H;
static_assert(ENC_D1_KS * R * ENC_H <= ENC_SCR && 2 * R * ENC_CO <= ENC_SCR &&
                  ENC_Z_KS * R * ENC_MAX_OUT <= ENC_SCR,
              "every partial buffer fits the gate scratch");
static_assert(ENC_SMEM_Q <= 232448, "opt-in shared memory of one block");
static_assert(R * ENC_H / 4 <= NT && R * ENC_CO / 4 <= NT &&
                  R * ENC_MAX_OUT / 4 <= NT,
              "each finish pass is one float4 a thread");

// merged (dec_merged_kernel): one x buffer, then per layer h, hh
// projection, tap projection, then the products' partial sums (the widest:
// x @ wih's two K halves), then per layer bhh and the conv bias
constexpr int DEC_SCR = 2 * R * DEC_G;
constexpr int DECM_BIAS = DEC_G + DEC_CO;        // bhh | cb of a layer
constexpr int DEC_MAX_OUT = DEC_SCR / (2 * R);   // output's 2 K halves fit
constexpr int DECM_GGC = DEC_GG / 16;            // column groups of [whh | glu]
constexpr int DECM_CONV_KS = 3;                  // K chunks of x @ [tap1|tap0]
constexpr size_t DECM_SMEM =
    sizeof(float) * (R * DEC_X + 5 * R * (DEC_H + DEC_G + DEC_CO) + DEC_SCR +
                     5 * DECM_BIAS);
static_assert(DEC_G % 16 == 0, "hh and GLU columns are whole column groups");
static_assert(DECM_CONV_KS * R * 2 * DEC_CO <= DEC_SCR &&
                  2 * R * DEC_H <= DEC_SCR,
              "every partial buffer fits the scratch");
static_assert(DECM_SMEM <= 232448, "opt-in shared memory of one block");

// x: dense_1's output, then each layer's GLU and conv outputs
static_assert(DEC_H + 5 * (DEC_H + DEC_CO) == DEC_X, "x is its segments");

// frame kernel (rx_frame_kernel): the modem geometry of one frame
struct FrameGeo {
  int ns;      // data symbol rows between the two pilot rows
  int nc;      // carriers
  int samp;    // samples a symbol row (M + Ncp)
  int lat;     // latent width of a z-step
  int nz;      // z-steps a frame
  int yw;      // floats of a [Yr | Yi] row: 2 nc padded to a multiple of 4
  int stages;  // copy stages (commit groups)
};
constexpr int FR_STAGES = 2;                   // copy stages where they hold
                                               // whole row groups, else 1
// the flagship modem: Ns=4 data rows between two pilot rows, Nc=30
// carriers, M+Ncp=192 samples a symbol, 3 z-steps of latent 80
__host__ __device__ constexpr FrameGeo flagship_geo() {
  return FrameGeo{4, 30, 192, 80, 3, 60, FR_STAGES};
}
constexpr int FR_NW = 4 + DEC_NW + 2;          // Wr Wi Er Ei, decoder, dft_w ls_w

// shared memory of a frame launch: the decoder's, then the z rows
__host__ __device__ constexpr size_t frame_smem(const FrameGeo& g) {
  return DEC_SMEM + sizeof(float) * R * g.nz * g.lat;
}
static_assert(frame_smem(flagship_geo()) <= 232448, "the flagship modem fits");

// The geometry of Ns, Nc, M+Ncp, latent and nz, with the padded Y width and
// the copy stages (FR_STAGES where each holds whole row groups, else 1)
FrameGeo frame_geo(int ns, int nc, int samp, int lat, int nz) {
  const int rows = R * (ns + 2);
  const bool split = rows % FR_STAGES == 0 && rows / FR_STAGES % ET == 0;
  return FrameGeo{ns, nc, samp, lat, nz, (2 * nc + 3) & ~3,
                  split ? FR_STAGES : 1};
}

// 0 when the frame kernel takes geometry g, else the number of the first
// limit g breaks (radae_tpu_torch/ops/fused_core.py names each):
//   1 Ns, Nc, nz >= 1, M+Ncp even, latent a positive multiple of 4
//   2 the data symbols fill the z-steps: Ns Nc = nz latent / 2
//   3 the samples fit the decoder's rings
//   4 the demod intermediates fit the decoder's scratch
//   5 latent <= DEC_H: z is staged in layer 0's GLU window
//   6 the z rows after the decoder's shared memory fit the block's
int frame_limit(const FrameGeo& g) {
  const int nsym = g.ns + 2;
  if (g.ns < 1 || g.nc < 1 || g.nz < 1 || g.samp < 2 || g.samp % 2 ||
      g.lat < 4 || g.lat % 4)
    return 1;
  if (2 * g.ns * g.nc != g.nz * g.lat) return 2;
  if (R * nsym * 2 * g.samp > DEC_RING) return 3;
  if (R * nsym * g.yw + 2 * R * g.yw + R > 2 * R * DEC_GS) return 4;
  if (g.lat > DEC_H) return 5;
  if (frame_smem(g) > 232448) return 6;
  return 0;
}

// The int8 instances' second kernel argument (the f32 ones ignore it, and
// the frame kernel has none): bit j of i8 set when array j is int8, and the
// start in w of each of the NS scale rows.  The kernels take it as
// __grid_constant__, so that indexing soff reads the parameter in place
// (without, each thread copied it to local memory first).
template <int NS>
struct QuantArgs {
  unsigned long long i8;
  int soff[NS];
};

// The second kernel argument of the BF instances (bf16 products) and of the
// x-split ones (in the frame kernel's, a member of its arguments): array
// j's kind (bit j of i8: int8; of bf: bf16; of rw: f32 rounded to bf16 at
// its products; none: f32) and the ns scale rows' starts (ns 0: no int8
// matrix).  pad stays 0 and is read by no kernel (a padded matrix is
// packed as its merged one); without it soff and the packed matrices' MmaW
// would sit at other parameter offsets, and every instance that takes a
// KindArgs would compile to other SASS.
template <int NS>
struct KindArgs {
  unsigned long long i8, bf, rw;
  int ns;
  int pad;
  int soff[NS];
};

// The fragment-packed matrices of an MM instance (tmma): array j's packed
// copy starts off[j] 16-byte words into p (-1: not packed)
template <int NW>
struct MmaW {
  const uint4* p;
  int off[NW];
};
// An MM instance takes its kinds and its packed matrices
template <int NS, int NW>
struct KindMmaArgs : KindArgs<NS> {
  MmaW<NW> m;
};
// The same for a split instance (dec_kernel, enc_kernel on f32 weights): a
// matrix of kind 0 is packed as its hi, mid and lo copies (tmma<true>)
template <int NS, int NW>
struct KindSplitArgs : KindMmaArgs<NS, NW> {};
// The same for an instance with f32 products (the int8 ones, and the merged
// decoder's on f32 weights): x is split into hi, mid and lo against each
// int8 matrix widened to bf16 (kind 1), and against the hi, mid and lo
// copies of an f32 matrix (kind 0): tmma<false, XS> and tmma<true, XS>
template <int NS, int NW>
struct KindSplitXArgs : KindMmaArgs<NS, NW> {};
template <class KA>
constexpr bool has_mma = false;
template <int NS, int NW>
constexpr bool has_mma<KindMmaArgs<NS, NW>> = true;
template <int NS, int NW>
constexpr bool has_mma<KindSplitArgs<NS, NW>> = true;
template <int NS, int NW>
constexpr bool has_mma<KindSplitXArgs<NS, NW>> = true;
template <class KA>
constexpr bool has_split = false;
template <int NS, int NW>
constexpr bool has_split<KindSplitArgs<NS, NW>> = true;
template <class KA>
constexpr bool has_xsplit = false;
template <int NS, int NW>
constexpr bool has_xsplit<KindSplitXArgs<NS, NW>> = true;

struct DecArgs {
  const float* w;
  int off[DEC_NW];
  const float* z;
  float* feats;
  int B, nz, in_dim, out_dim;
  const float* h_in[5];
  const float* hist_in[5];
  float* h_out[5];
  float* hist_out[5];
};

struct DecMergedArgs {
  const float* w;
  int off[DEC_NWM];
  const float* z;
  float* feats;
  int B, nz, in_dim, out_dim;
  const float* h_in[5];
  const float* hgp_in[5];
  const float* hpp_in[5];
  float* h_out[5];
  float* hgp_out[5];
  float* hpp_out[5];
};

struct FrameArgs {
  DecArgs d;          // the decoder (d.z unused: z is made in shared memory)
  FrameGeo g;
  const float* rx;    // (B, (ns + 2) * samp, 2) interleaved IQ
  const float* dft_w; // (2 samp, yw)
  const float* ls_w;  // (yw, yw)
  float mag_k;
  int coarse_mag;
  KindArgs<DEC_NS> k; // bf16 products: the decoder's kinds (else unused)
};
// The argument of the frame kernel's BF instance (an MM one): the decoder's
// packed matrices and the packed dft_w besides
struct FrameMmaArgs : FrameArgs {
  MmaW<DEC_NW> m;
  const uint4* dft_m;
};
template <bool BF>
using FrameArgsOf = std::conditional_t<BF, FrameMmaArgs, FrameArgs>;

struct EncArgs {
  const float* w;
  int off[ENC_NW];
  const float* f;
  float* z;
  int B, nz, in_dim, out_dim, bottleneck;
  const float* h_in[5];
  const float* hist_in[5];
  float* h_out[5];
  float* hist_out[5];
};

// A row-major operand: row r is p + min(r, rmax) * ld (rmax clamps the
// ragged batch edge for operands read from device memory).
struct Src {
  const float* p;
  int ld;
  int rmax;
};

__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}
__device__ __forceinline__ float4 mul4(float4 a, float4 b) {
  return make_float4(a.x * b.x, a.y * b.y, a.z * b.z, a.w * b.w);
}
// v rounded to bf16 (nearest even) and back: a product input of the frame
// kernel's BF instance's LS products (rowprod)
__device__ __forceinline__ float4 bfr4(float4 v) {
  const float2 a = __bfloat1622float2(__floats2bfloat162_rn(v.x, v.y));
  const float2 b = __bfloat1622float2(__floats2bfloat162_rn(v.z, v.w));
  return make_float4(a.x, a.y, b.x, b.y);
}
template <bool RX>
__device__ __forceinline__ float4 bfx(float4 v) {
  if constexpr (RX) return bfr4(v);
  return v;
}
__device__ __forceinline__ float sigm(float x) { return 1.f / (1.f + expf(-x)); }
__device__ __forceinline__ float4 tanh4(float4 v) {
  return make_float4(tanhf(v.x), tanhf(v.y), tanhf(v.z), tanhf(v.w));
}
__device__ __forceinline__ void fma4(float4& a, float x, float4 w) {
  a.x = fmaf(x, w.x, a.x);
  a.y = fmaf(x, w.y, a.y);
  a.z = fmaf(x, w.z, a.z);
  a.w = fmaf(x, w.w, a.w);
}

// ---------------------------------------------------------------------------
// Y = A @ W (K x out, K a multiple of 4) over the block's R rows of A (the
// frame's LS product of its two pilot rows): a thread owns a row x 4-column
// tile and walks K in order, reading W as float4 along `out` and A as
// float4 along K; epi(r, c, Y[r][c..c+3]) consumes the result.  All threads
// call it; the caller syncs before the result is read.  BF: both inputs
// rounded to bf16.
template <bool BF, class Epi>
__device__ __forceinline__ void rowprod(const Src& a, const float* __restrict__ W,
                                        int K, int out, Epi epi) {
  const int nq = out >> 2;
  for (int it = threadIdx.x; it < R * nq; it += NT) {
    const int r = it / nq, c = it % nq * 4;
    const float* const x = a.p + (size_t)min(r, a.rmax) * a.ld;
    const float* wp = W + c;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k = 0; k < K; k += 4, wp += 4 * out) {
      const float4 w0 = bfx<BF>(ldg4(wp)), w1 = bfx<BF>(ldg4(wp + out));
      const float4 w2 = bfx<BF>(ldg4(wp + 2 * out)), w3 = bfx<BF>(ldg4(wp + 3 * out));
      const float4 xv = bfx<BF>(ld4(x + k));
      fma4(acc, xv.x, w0);
      fma4(acc, xv.y, w1);
      fma4(acc, xv.z, w2);
      fma4(acc, xv.w, w3);
    }
    epi(r, c, acc);
  }
}

// ---------------------------------------------------------------------------
// Tile products, register-tiled over the block's rows (every kernel).
//
// A work item is one warp's share of Y = X @ W: a group of 16 columns (quad
// q = lane & 3 owns columns 4q..4q+3) for ET rows over a K range.  K lane
// kl = lane >> 2 takes k = k0 + 4*kl + 32*j, so the 8 K lanes read 128
// contiguous bytes of an x row, and every weight float4 a lane loads feeds
// ET rows (4*ET multiply-adds).  The 4 quads of a K lane are neighbouring
// lanes, so a quarter-warp asks for 2 distinct float4 of x (which its 4
// quads share by broadcast) and 2 weight rows, not 8 of each as with the
// quads 8 lanes apart: the encoder ran 1.58 times faster so on an H100.
// kput adds the 8 K lanes' tiles by a fixed butterfly of shuffles; an
// output whose K is split over items gets its partials added in chunk
// order by the pass after the barrier.  No atomics, so two launches on the
// same input give the same bits.

// p ? a : b by selp: a select the compiler keeps in registers (a ternary
// between two elements of the tile becomes an indexed local-memory read)
__device__ __forceinline__ float selp(bool p, float a, float b) {
  float r;
  asm("{\n\t.reg .pred q;\n\tsetp.ne.b32 q, %1, 0;\n\t"
      "selp.f32 %0, %2, %3, q;\n\t}"
      : "=f"(r)
      : "r"((int)p), "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float4 sel4(bool p, float4 a, float4 b) {
  return make_float4(selp(p, a.x, b.x), selp(p, a.y, b.y), selp(p, a.z, b.z),
                     selp(p, a.w, b.w));
}

__device__ __forceinline__ float4 shfl_xor4(float4 v, int m) {
  v.x = __shfl_xor_sync(0xffffffffu, v.x, m);
  v.y = __shfl_xor_sync(0xffffffffu, v.y, m);
  v.z = __shfl_xor_sync(0xffffffffu, v.z, m);
  v.w = __shfl_xor_sync(0xffffffffu, v.w, m);
  return v;
}

// rows k..k+3 of W at columns c..c+3 (zeros where !v)
__device__ __forceinline__ void ldw(float4 (&wt)[4], const float* p, int out,
                                    bool v) {
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int m = 0; m < 4; ++m) wt[m] = v ? ldg4(p + m * out) : z;
}

// acc[i] += sum over this lane's k (k0 + 4*kl + 32*j < k1) of
//           X[r0 + i][k..k+3] . W[k..k+3][c..c+3],
// X in shared memory with row stride ld, a constant but for the frame
// kernel's sample rows (every operand of a tile product is there: the
// carried state and the inputs are staged first).  k0 and k1 are multiples
// of 4; an empty range adds nothing.  The next K step's weights are loaded
// into registers before this step's multiply-adds.  W is f32 (the int8
// instances run on the tensor cores).
__device__ __forceinline__ void tmac(float4 (&acc)[ET], const float* X, int ld,
                                     int r0, const float* __restrict__ W,
                                     int out, int c, int k0, int k1, int kl) {
  const float* const xr = X + r0 * ld;
  const bool cv = c < out;
  const int n = (k1 - k0 + 31) >> 5;
  int k = k0 + 4 * kl;
  const float* wp = W + (size_t)k * out + c;
  float4 wn[4];
  ldw(wn, wp, out, cv && k < k1);
#pragma unroll 1   // unrolled by 2: no faster on an H100, twice the code
  for (int j = 0; j < n; ++j) {
    const int kx = min(k, k1 - 4);   // lanes past k1 read a valid x, weight 0
    k += 32;
    wp += 32 * out;
    float4 wt[4];
    // k < k1 only if step j + 1 exists: no branch, so the next step's
    // loads are issued before this step's multiply-adds
#pragma unroll
    for (int m = 0; m < 4; ++m) wt[m] = wn[m];
    ldw(wn, wp, out, cv && k < k1);
#pragma unroll
    for (int i = 0; i < ET; ++i) {
      const float4 x = ld4(xr + i * ld + kx);
      fma4(acc[i], x.x, wt[0]);
      fma4(acc[i], x.y, wt[1]);
      fma4(acc[i], x.z, wt[2]);
      fma4(acc[i], x.w, wt[3]);
    }
  }
}

// ---------------------------------------------------------------------------
// Tile products on the tensor cores (tmma: the MM instances' route, for
// matrices of kinds 1, 2 and 3, whose products are bf16 x bf16, and in the
// split instances for kind 0, bf16 x f32, as three bf16 products:
// tmma<true>; and in the int8 instances with f32 products, f32 x int8 as
// three bf16 products on x's parts, tmma<false, XS>, and a kept-f32
// matrix's f32 x f32 as six, tmma<true, XS>).
//
// A work item is the same one warp's 16 rows x 16 columns over a K range,
// but the whole warp walks K in 16-wide steps with
// mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32, two n8 tiles a step, and
// its sums need no K-lane butterfly.  Lane (g, t) = (lane >> 2, lane & 3)
// loads x[g][k + 4t..+3] and x[g + 8][k + 4t..+3] as two float4 from shared
// memory and rounds them to bf16 (cvt.rn.bf16x2): physical k 4t, 4t+1 are
// the A fragment's k 2t, 2t+1, and 4t+2, 4t+3 its 2t+8, 2t+9.  n8 tile 0
// holds the group's columns {4q, 4q+1} (q < 4) and tile 1 {4q+2, 4q+3}, so
// the lane ends with columns 4t..4t+3 (its column quad cq, as on the FMA
// route) of rows g and g+8.  The weights come packed in that order
// (ops/fused_core.py mma_weights, once per weight set): bf16, K padded to a
// multiple of 16 with zero rows and out to a multiple of 16 with zero
// columns, 16-column group cg and K step s at 32 lanes x 16 bytes (both n8
// tiles' B of the lane: 4 k of one column each) from (cg * nks + s) * 32,
// nks = ceil(K / 16), so a step is one coalesced 512-byte load a warp.  A
// split (kind-0) matrix packs its hi, mid and lo copies of each step the same
// way one after another, 96 words a step from (cg * nks + s) * 96: three
// coalesced loads a step, in one 1.5 KB block.
// Each step's products are summed from zero in the tensor cores and added
// in f32, in a fixed order, no atomics.  Timed on an H100 by
// tools/enc_variants.py (graph replay, merged decoder on bf16 weights /
// frame kernel on f32 weights): one step a loop, B one step ahead, 0.274 /
// 0.373 ms, a third of it waiting on the B loads from the L2; K-step pairs
// with B 2 pairs ahead and the bank swizzle below 0.212 / 0.251 (1 pair
// ahead +8% / +5%, 4 pairs +6% / +3%, no swizzle +11% / +10%), and B from
// L1 instead of the L2 then saves only 0.014 / 0.013 ms.

// d += a b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col), d
// 16x8 f32 (the lane's c0..c3 in d.x..d.w)
__device__ __forceinline__ void mma16816(float4& d, unsigned a0, unsigned a1,
                                         unsigned a2, unsigned a3,
                                         unsigned b0, unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d.x), "+f"(d.y), "+f"(d.z), "+f"(d.w)
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}
// lo and hi rounded to bf16 (nearest even) in one register, lo in the low
// half
__device__ __forceinline__ unsigned bf2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// K-step pairs of B that tmma keeps in flight ahead of their products (the
// weight stream from the L2 is latency-bound: one 512-byte load a warp in
// flight left a third of the launch to it on an H100)
constexpr int MMA_PAIRS = 2;
// and on the split route (tmma<true>), whose K steps load hi, mid and lo:
// 1.5 times the bytes in flight that MMA_PAIRS gives the single route, in
// 1.5 times the registers; and on the f32-product route (XS), whose K
// steps run 3 MMAs a tile on one B copy: with B two pairs ahead it ran 6%
// slower on an H100 (the merged decoder on int8 weights, 0.3135 against
// 0.2959 ms, tools/enc_variants.py form mmapairs1)
constexpr int MMA_SPLIT_PAIRS = 1;

// One K step's products, summed by the tensor cores from zero and added to
// the item's sums d0, d1 in f32.  (Accumulating a whole K range inside the
// tensor cores, which truncate as they add into an accumulator, doubled the
// bf16 input flips against the plain version on an H100.)  SPLIT: b is the
// step's hi copy, m its mid and l its lo copy; the step's lo products are
// summed from zero, then the mid and the hi products onto them in the tensor
// cores (the small parts first, so the one truncation a step is at the step
// sum's scale, as on the single route), and the step sum added to d in f32.
template <bool SPLIT>
__device__ __forceinline__ void mstep(float4& d0, float4& d1, unsigned a0,
                                      unsigned a1, unsigned a2, unsigned a3,
                                      uint4 b, uint4 m, uint4 l) {
  float4 e0 = make_float4(0.f, 0.f, 0.f, 0.f), e1 = e0;
  if constexpr (SPLIT) {
    mma16816(e0, a0, a1, a2, a3, l.x, l.y);
    mma16816(e1, a0, a1, a2, a3, l.z, l.w);
    mma16816(e0, a0, a1, a2, a3, m.x, m.y);
    mma16816(e1, a0, a1, a2, a3, m.z, m.w);
  }
  mma16816(e0, a0, a1, a2, a3, b.x, b.y);
  mma16816(e1, a0, a1, a2, a3, b.z, b.w);
  d0 = add4(d0, e0);
  d1 = add4(d1, e1);
}

// x's values a, b as three bf16 pairs (a in the low halves), each rounded
// to nearest even: h = bf16(x), m = bf16(x - h), l = bf16(x - h - m).  Each
// remainder is exact in f32 (a bf16 value back in f32 is a 16-bit shift),
// and |x - h - m - l| <= 2^-27 |x|: with an exact bf16 w, x h + x m + x l is
// the f32 product.
__device__ __forceinline__ void xparts(float a, float b, unsigned& h,
                                       unsigned& m, unsigned& l) {
  h = bf2(a, b);
  a -= __uint_as_float(h << 16);
  b -= __uint_as_float(h & 0xffff0000u);
  m = bf2(a, b);
  a -= __uint_as_float(m << 16);
  b -= __uint_as_float(m & 0xffff0000u);
  l = bf2(a, b);
}

// both n8 tiles of a K step on one part of A: e0 += a b.xy, e1 += a b.zw
__device__ __forceinline__ void mma2(float4& e0, float4& e1,
                                     const unsigned (&a)[4], uint4 b) {
  mma16816(e0, a[0], a[1], a[2], a[3], b.x, b.y);
  mma16816(e1, a[0], a[1], a[2], a[3], b.z, b.w);
}

// The f32-product routes of the int8 instances (tmma's XS): x in three
// bf16 parts (xparts) against each int8 matrix widened to bf16, or against
// a kept-f32 matrix's three copies; a K step's products summed from zero in
// the tensor cores, the smallest first, and added to the f32 sums.
// XS_SPLIT (both decoders'): the step's products in one sum.  XS_SEP
// (enc_kernel's): x hi's products (x hi b) summed apart from the rest, the
// two added in f32.  The tensor cores truncate a sum's terms, the running
// sum included, below the largest one's 24 bits, so in one sum the small
// parts' partial sum loses its low bits where x hi's products join it.  The
// encoder's int8 step is so ill-conditioned (its z output cancels) that this
// shows: on an H100 its chained form read past chip_smoke.py's TOL, apart
// it stays within (PERF.md); the decoders read 0.01 of TOL either way.
constexpr int XS_SPLIT = 1, XS_SEP = 2;

// One K step of the f32-product route (tmma's XS): the lane's x of rows g
// (r0) and g + 8 (r1), f32, split into hi, mid and lo (xparts) in
// registers, against b, an int8 matrix widened to bf16 (exact): x lo b,
// x mid b and x hi b.  SPLIT: against an f32 matrix's hi b, mid m and lo l
// copies, the six of the nine products at or above 2^-18 of x hi b (x lo
// b, x mid m, x hi l, x mid b, x hi m, x hi b; the three left out are below
// 2^-26 of it).  The step's products are summed from zero in the tensor
// cores, the smallest first, and the step sum added to d0, d1 in f32, as in
// mstep<true>; SEP: x hi b summed from zero apart, and added to the rest's
// sum in f32 first.
template <bool SPLIT, bool SEP>
__device__ __forceinline__ void xstep(float4& d0, float4& d1, float4 r0,
                                      float4 r1, uint4 b, uint4 m, uint4 l) {
  unsigned xh[4], xm[4], xl[4];         // a0..a3 of each part
  xparts(r0.x, r0.y, xh[0], xm[0], xl[0]);
  xparts(r1.x, r1.y, xh[1], xm[1], xl[1]);
  xparts(r0.z, r0.w, xh[2], xm[2], xl[2]);
  xparts(r1.z, r1.w, xh[3], xm[3], xl[3]);
  float4 e0 = make_float4(0.f, 0.f, 0.f, 0.f), e1 = e0;
  if constexpr (SPLIT) {
    mma2(e0, e1, xl, b);
    mma2(e0, e1, xm, m);
    mma2(e0, e1, xh, l);
    mma2(e0, e1, xm, b);
    mma2(e0, e1, xh, m);
  } else {
    mma2(e0, e1, xl, b);                // x lo: the third part
    mma2(e0, e1, xm, b);
  }
  if constexpr (SEP) {
    float4 h0 = make_float4(0.f, 0.f, 0.f, 0.f), h1 = h0;
    mma2(h0, h1, xh, b);
    d0 = add4(d0, add4(h0, e0));
    d1 = add4(d1, add4(h1, e1));
  } else {
    mma2(e0, e1, xh, b);
    d0 = add4(d0, e0);
    d1 = add4(d1, e1);
  }
}

// acc[0] and acc[1] (rows r0 + g and r0 + g + 8 at columns c..c+3, c =
// 16 cg + 4t) += X[those rows][k0, k1) @ W[k0, k1)[those columns], X in
// shared memory with row stride ld, W the packed matrix of K rows.  k0 is a
// multiple of 16 and k1 of 4; the A elements at k >= k1 are zeros (a zero
// B row does not cancel an x past K that holds Inf or NaN bits).  K goes in
// pairs of steps: the row strides are 0 mod 32 banks, so the lanes of odd g
// load a pair's second step first and a quarter-warp's two rows fall on
// other banks; selects give each step its registers back.  B is loaded
// MMA_PAIRS pairs ahead of its products.  SPLIT: W is a split matrix (hi,
// mid and lo copies, 96 words a step, MMA_SPLIT_PAIRS pairs ahead), and each
// step runs the two n8 tiles on lo, mid and hi with the same A registers
// (mstep<true>).  XS (f32 products, XS_SPLIT or XS_SEP): x is not rounded
// but split into three bf16 parts at each step (xstep), against W (int8
// widened) or, SPLIT, against its three copies; B MMA_SPLIT_PAIRS pairs
// ahead.
template <bool SPLIT = false, int XS = 0>
__device__ __forceinline__ void tmma(float4 (&acc)[ET], const float* X, int ld,
                                     int r0, const uint4* __restrict__ W,
                                     int K, int c, int k0, int k1, int kl) {
  static_assert(ET == 16, "an mma.sync A tile is the item's 16 rows");
  constexpr int NB = 2 * (SPLIT || XS ? MMA_SPLIT_PAIRS : MMA_PAIRS);
  constexpr int WS = SPLIT ? 96 : 32;   // 16-byte words a K step
  const int t = (c >> 2) & 3;
  const bool odd = kl & 1;
  const float* const x0 = X + (r0 + kl) * ld + 4 * t;
  const float* const x1 = x0 + 8 * ld;
  const uint4* wp = W + ((size_t)(c >> 4) * ((K + 15) >> 4) + (k0 >> 4)) * WS +
                    4 * kl + t;
  const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
  const uint4 z4 = make_uint4(0u, 0u, 0u, 0u);
  float4 d0 = make_float4(acc[0].x, acc[0].y, acc[1].x, acc[1].y);
  float4 d1 = make_float4(acc[0].z, acc[0].w, acc[1].z, acc[1].w);
  uint4 bq[NB];                                 // hi (or the only) copy
  [[maybe_unused]] uint4 mq[SPLIT ? NB : 1], lq[SPLIT ? NB : 1];  // mid, lo
#pragma unroll
  for (int p = 0; p < NB; ++p) bq[p] = k0 + 16 * p < k1 ? __ldg(wp + WS * p) : z4;
  if constexpr (SPLIT) {
#pragma unroll
    for (int p = 0; p < NB; ++p) {
      mq[p] = k0 + 16 * p < k1 ? __ldg(wp + WS * p + 32) : z4;
      lq[p] = k0 + 16 * p < k1 ? __ldg(wp + WS * p + 64) : z4;
    }
  }
  wp += WS * NB;
#pragma unroll 1
  for (int k = k0; k < k1; k += 32) {
    const uint4 b0 = bq[0], b1 = bq[1];
#pragma unroll
    for (int p = 0; p + 2 < NB; ++p) bq[p] = bq[p + 2];
    bq[NB - 2] = k + 16 * NB < k1 ? __ldg(wp) : z4;
    bq[NB - 1] = k + 16 * NB + 16 < k1 ? __ldg(wp + WS) : z4;
    uint4 m0 = z4, m1 = z4, l0 = z4, l1 = z4;
    if constexpr (SPLIT) {
      m0 = mq[0], m1 = mq[1], l0 = lq[0], l1 = lq[1];
#pragma unroll
      for (int p = 0; p + 2 < NB; ++p) mq[p] = mq[p + 2], lq[p] = lq[p + 2];
      mq[NB - 2] = k + 16 * NB < k1 ? __ldg(wp + 32) : z4;
      mq[NB - 1] = k + 16 * NB + 16 < k1 ? __ldg(wp + WS + 32) : z4;
      lq[NB - 2] = k + 16 * NB < k1 ? __ldg(wp + 64) : z4;
      lq[NB - 1] = k + 16 * NB + 16 < k1 ? __ldg(wp + WS + 64) : z4;
    }
    wp += 2 * WS;
    const int ka = odd ? k + 16 : k, kb = odd ? k : k + 16;
    const bool va = ka + 4 * t < k1, vb = kb + 4 * t < k1;
    const float4 pa = va ? ld4(x0 + ka) : z, pb = va ? ld4(x1 + ka) : z;
    const float4 qa = vb ? ld4(x0 + kb) : z, qb = vb ? ld4(x1 + kb) : z;
    if constexpr (XS != 0) {   // each step's rows selected as f32, then split
      constexpr bool SEP = XS == XS_SEP;
      xstep<SPLIT, SEP>(d0, d1, sel4(odd, qa, pa), sel4(odd, qb, pb), b0, m0,
                        l0);
      if (k + 16 < k1)
        xstep<SPLIT, SEP>(d0, d1, sel4(odd, pa, qa), sel4(odd, pb, qb), b1, m1,
                          l1);
    } else {
      const unsigned u0 = bf2(pa.x, pa.y), u1 = bf2(pb.x, pb.y);
      const unsigned u2 = bf2(pa.z, pa.w), u3 = bf2(pb.z, pb.w);
      const unsigned w0 = bf2(qa.x, qa.y), w1 = bf2(qb.x, qb.y);
      const unsigned w2 = bf2(qa.z, qa.w), w3 = bf2(qb.z, qb.w);
      mstep<SPLIT>(d0, d1, odd ? w0 : u0, odd ? w1 : u1, odd ? w2 : u2,
                   odd ? w3 : u3, b0, m0, l0);
      if (k + 16 < k1)
        mstep<SPLIT>(d0, d1, odd ? u0 : w0, odd ? u1 : w1, odd ? u2 : w2,
                     odd ? u3 : w3, b1, m1, l1);
    }
  }
  acc[0] = make_float4(d0.x, d0.y, d1.x, d1.y);
  acc[1] = make_float4(d0.z, d0.w, d1.z, d1.w);
}

// One level of the K-lane butterfly: lanes keep H rows of the tile, the
// upper half when up, and add the partner's (lane ^ m) copy of them.
template <int H>
__device__ __forceinline__ void kfold(float4 (&acc)[ET], bool up, int m) {
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float4 send = sel4(up, acc[i], acc[i + H]);
    const float4 keep = sel4(up, acc[i + H], acc[i]);
    acc[i] = add4(keep, shfl_xor4(send, m));
  }
}

// The 8 K lanes' tiles of a work item summed (bit lv of kl picks the half
// kept at level lv): lane kl is left with rows rk..rk+ET/8-1 of the item in
// acc[0..ET/8), and rk is returned.  Every lane of the warp takes part.
__device__ __forceinline__ int ksum(float4 (&acc)[ET], int kl, int r0) {
  kfold<ET / 2>(acc, kl & 1, 4);          // K lane kl is lanes 4kl..4kl+3
  kfold<ET / 4>(acc, (kl >> 1) & 1, 8);
  kfold<ET / 8>(acc, (kl >> 2) & 1, 16);
  return r0 + (ET / 2) * (kl & 1) + (ET / 4) * ((kl >> 1) & 1) +
         (ET / 8) * ((kl >> 2) & 1);
}

// The end of a work item: ksum, then lane kl stores its ET/8 rows plus
// `bias` at dst + row * ld when `put`.  MM (the item ran on tmma): nothing
// to sum, and the lane's rows are r0 + kl and r0 + kl + 8.
template <bool MM = false>
__device__ __forceinline__ void kput(float4 (&acc)[ET], int kl, int r0,
                                     float* dst, int ld, float4 bias,
                                     bool put) {
  constexpr int rs = MM ? 8 : 1;
  const int rk = MM ? r0 + kl : ksum(acc, kl, r0);
  if (put) {
#pragma unroll
    for (int i = 0; i < ET / 8; ++i) st4(dst + (rk + rs * i) * ld, add4(acc[i], bias));
  }
}

// tmma on the packed matrix wm (K rows) of kind q: in a split instance (SP)
// a kind-0 matrix on its hi, mid and lo copies; in an int8 instance with
// f32 products (XS, its route) x in three parts against an int8 matrix (q
// 1) or a kept-f32 one's three copies (q 0) (q is warp-uniform: one a
// matrix)
template <bool SP, int XS = 0>
__device__ __forceinline__ void kmma(float4 (&acc)[ET], const float* X, int ld,
                                     int r0, const uint4* wm, int q, int K,
                                     int c, int k0, int k1, int kl) {
  if constexpr (XS != 0) {
    if (q == 0)
      tmma<true, XS>(acc, X, ld, r0, wm, K, c, k0, k1, kl);
    else
      tmma<false, XS>(acc, X, ld, r0, wm, K, c, k0, k1, kl);
    return;
  }
  if constexpr (SP) {
    if (q == 0) {
      tmma<true>(acc, X, ld, r0, wm, K, c, k0, k1, kl);
      return;
    }
  }
  tmma(acc, X, ld, r0, wm, K, c, k0, k1, kl);
}

// An item's product on its route: in an MM instance kmma on the packed
// matrix wm (K rows) of kind q, else tmac on the f32 matrix W (every int8
// instance is an MM one)
template <bool Q, bool MM, bool SP = false, int XS = 0>
__device__ __forceinline__ void umac(float4 (&acc)[ET], const float* X, int ld,
                                     int r0, const float* W, const uint4* wm,
                                     int q, int K, int out, int c, int k0,
                                     int k1, int kl) {
  static_assert(MM || !Q, "the int8 instances run on the tensor cores");
  if constexpr (MM)
    kmma<SP, XS>(acc, X, ld, r0, wm, q, K, c, k0, k1, kl);
  else
    tmac(acc, X, ld, r0, W, out, c, k0, k1, kl);
}

// The scale row sc at columns c..c+3 in an int8 instance (ones otherwise,
// and in a BF instance without scale rows, where sc is null)
template <bool Q, bool BF = false>
__device__ __forceinline__ float4 scl(const float* sc, int c, int out) {
  if constexpr (BF)
    return sc && c < out ? ldg4(sc + c) : make_float4(1.f, 1.f, 1.f, 1.f);
  return Q && c < out ? ldg4(sc + c) : make_float4(1.f, 1.f, 1.f, 1.f);
}

// kput, in an int8 instance with the summed tile times the column scale s
// before the bias
template <bool Q, bool MM = false>
__device__ __forceinline__ void kputq(float4 (&acc)[ET], int kl, int r0,
                                      float* dst, int ld, float4 s,
                                      float4 bias, bool put) {
  if (!Q) {
    kput<MM>(acc, kl, r0, dst, ld, bias, put);
    return;
  }
  constexpr int rs = MM ? 8 : 1;
  const int rk = MM ? r0 + kl : ksum(acc, kl, r0);
  if (put) {
#pragma unroll
    for (int i = 0; i < ET / 8; ++i)
      st4(dst + (rk + rs * i) * ld, add4(mul4(acc[i], s), bias));
  }
}

__device__ __forceinline__ void zero(float4 (&acc)[ET]) {
#pragma unroll
  for (int i = 0; i < ET; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst[r][0..cols) = src row min(r, rmax) (row stride ld) for the R rows of a
// block, into shared memory with rows LD apart; cols % 4 == 0
template <int LD>
__device__ __forceinline__ void stage(float* dst, const float* src, int ld,
                                      int cols, int rmax) {
  const int nq = cols / 4;
  for (int it = threadIdx.x; it < R * nq; it += NT) {
    const int r = it / nq, c = it % nq * 4;
    st4(dst + r * LD + c, ld4(src + (size_t)min(r, rmax) * ld + c));
  }
}

// Y = X @ W (K x out, X rows ld apart) for the block's rows, as items of one
// row group, one 16-column group and one K chunk (kc wide, a multiple of
// 32), taken by the warps in turn.  Chunk ch's partial goes to
// part[ch][R][out], with bias (when not null) added to chunk 0; the pass
// after the barrier adds the chunks in order.  W is f32 (tmac), and in an
// int8 instance each partial is scaled by the row sc.  MM: on the tensor
// cores (kmma), W's packed copy wm of kind q (a padded matrix packs as its
// merged one); SP: a split instance; XS: one with f32 products on x's parts.
template <bool Q, bool BF = false, bool MM = false, bool SP = false,
          int XS = 0>
__device__ __forceinline__ void tprod(const float* X, int ld, const float* W,
                                      int q, const float* sc, int K, int out,
                                      int ng, int ks,
                                      const float* __restrict__ bias,
                                      float* part, int warp, int kl, int cq,
                                      const uint4* wm = nullptr) {
  static_assert(MM || !Q, "the int8 instances run on the tensor cores");
  const int kc = ((K + ks - 1) / ks + 31) & ~31;
  for (int u = warp; u < RG * ng * ks; u += NWARP) {
    const int r0 = u / (ng * ks) * ET, v = u % (ng * ks);
    const int ch = v / ng, c = v % ng * 16 + cq;
    const int kb = ch * kc, ke = min(K, kb + kc);
    const float4 b = ch == 0 && bias && c < out
                         ? ldg4(bias + c)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 acc[ET];
    zero(acc);
    if constexpr (MM)
      kmma<SP, XS>(acc, X, ld, r0, wm, q, K, c, kb, ke, kl);
    else
      tmac(acc, X, ld, r0, W, out, c, kb, ke, kl);
    kputq<Q, MM>(acc, kl, r0, part + ch * R * out + c, out, scl<Q, BF>(sc, c, out), b,
                 c < out);
  }
}

// 16 bytes device -> shared memory, asynchronously (cp.async, L2 only)
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most n (0..5) of this thread's newest commit groups are
// pending
template <int N>
__device__ __forceinline__ void cp_async_wait_n() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: cp_async_wait_n<0>(); break;
    case 1: cp_async_wait_n<1>(); break;
    case 2: cp_async_wait_n<2>(); break;
    case 3: cp_async_wait_n<3>(); break;
    case 4: cp_async_wait_n<4>(); break;
    default: cp_async_wait_n<5>(); break;
  }
}

// The kinds of a BF instance's arrays and its number of scale rows, read
// from its KindArgs once (nothing in the other instances)
struct Kinds {
  unsigned long long i8, bf, rw;
  int ns;
  // array j's kind (kmma): 1 int8, 2 bf16, 3 f32 rounded at its products,
  // 0 f32
  __device__ __forceinline__ int operator()(int j) const {
    return i8 >> j & 1 ? 1 : bf >> j & 1 ? 2 : rw >> j & 1 ? 3 : 0;
  }
};
template <bool BF, class KA>
__device__ __forceinline__ Kinds kinds_of(const KA& k) {
  if constexpr (BF) return Kinds{k.i8, k.bf, k.rw, k.ns};
  else return Kinds{0, 0, 0, 0};
}

// h' of one GRU unit from its gate sums (biases included) and the old h
__device__ __forceinline__ float gru_h(float r, float z, float nx, float nh,
                                       float h) {
  const float nn = tanhf(nx + sigm(r) * nh);
  const float zz = sigm(z);
  return (1.f - zz) * nn + zz * h;
}

// The unmerged decoder stack over a.nz z-steps for the block's R rows
// (dec_kernel's and rx_frame_kernel's body), every product a tile product on
// operands in shared memory.  Step k's latents are the rows of zs shifted by
// k * zstep floats (device or shared memory); they are staged into columns
// DEC_H.. of x[k]'s ring slot, which layer 0's GLU overwrites later.  The
// carried h goes into the h ring's slot of step -1 before the first step,
// and layer i's conv history over the prefix of x[-1] just before its conv
// at the first step (the next layer overwrites it with its own).  Each
// staging pass sits between two barriers that are there anyway.  smem holds
// DEC_SMEM bytes (DEC_SMEM_Q in the int8 instances, Q).  BF: bf16
// products, the kinds in qa (KindArgs).  MM (the frame kernel's BF instance,
// Q false, and dec_kernel's MM, split and x-split instances, Q true): every
// product on the tensor cores (kmma), on the packed matrices m; in the split
// instance (qa a KindSplitArgs) the kind-0 ones on their hi, mid and lo
// copies; in the x-split one (int8 weights with f32 products, qa a
// KindSplitXArgs, XS_SPLIT) x in three bf16 parts against each int8 matrix
// and each kept-f32 one's three copies.
template <bool Q, bool BF = false, bool MM = false,
          class KA = QuantArgs<DEC_NS>>
__device__ __forceinline__ void dec_body(const DecArgs& a, const KA& qa,
                                         float* smem, const Src& zs,
                                         int zstep,
                                         const MmaW<DEC_NW>* m = nullptr) {
  constexpr bool SP = has_split<KA>;
  constexpr int XS = has_xsplit<KA> ? XS_SPLIT : 0;
  static_assert(BF || !MM || (Q && XS),
                "an MM instance with f32 products is the int8 one on x's parts");
  float* const xb = smem;                               // [2][R][DEC_X]
  float* const hb = xb + 2 * R * DEC_X;                 // [2][5][R][DEC_H]
  float* const scr = smem + DEC_RING;                   // partial sums
  float* const hz = scr + 2 * R * DEC_GS;               // Q: r|z h @ whh
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kl = lane >> 2, cq = 4 * (lane & 3);        // K lane, column quad
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.B - b0);
  const int rmax = nv - 1;
  const float* const w = a.w;
  const int* const off = a.off;
  const int od = a.out_dim;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  // the float4 of a DEC_H-wide finish pass that is this thread's
  const int fr = t / (DEC_H / 4), fc = t % (DEC_H / 4) * 4;
  // Q: array j's kind and scale row si (scale rows in the order of
  // radae_tpu's kernel: d1, per layer wih whh glu cw0 cw1, out; XS: kmma's
  // kind, 1 int8, 0 kept in f32); BF: kmma's kind
  const unsigned long long i8 = qa.i8;
  const int* const soff = qa.soff;
  const Kinds kd = kinds_of<BF>(qa);
  auto q8 = [=](int j) {
    if constexpr (BF) return kd(j);
    else return Q && (i8 >> j & 1);
  };
  auto sc = [=](int si) {
    if constexpr (BF) return Q && kd.ns ? w + soff[si] : nullptr;
    else return Q ? w + soff[si] : nullptr;
  };
  // MM: array j's packed copy
  auto mw = [=](int j) -> const uint4* {
    if constexpr (MM) return m->p + m->off[j];
    else return nullptr;
  };

  for (int i = 0; i < 5; ++i)
    stage<DEC_H>(hb + (5 + i) * R * DEC_H, a.h_in[i] + (size_t)b0 * DEC_H,
                 DEC_H, DEC_H, rmax);
  stage<DEC_X>(xb + DEC_H, zs.p, zs.ld, a.in_dim, zs.rmax);
  __syncthreads();

  for (int k = 0; k < a.nz; ++k) {
    const int cur = k & 1, prv = cur ^ 1;
    float* const X = xb + cur * R * DEC_X;
    float* const Xp = xb + prv * R * DEC_X;

    // dense_1: X[:, :96] = tanh(z_k @ d1_w + d1_b), K in 2 chunks
    tprod<Q, BF, MM, SP, XS>(X + DEC_H, DEC_X, w + off[0], q8(0), sc(0),
                             a.in_dim, DEC_H, DEC_NG, 2, w + off[1], scr, warp,
                             kl, cq, mw(0));
    __syncthreads();
    st4(X + fr * DEC_X + fc, tanh4(add4(ld4(scr + fr * DEC_H + fc),
                                        ld4(scr + (R + fr) * DEC_H + fc))));
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = DEC_H + 128 * i, cin = gin + DEC_H;
      const int* o = off + 2 + 8 * i;   // wih whh bih bhh glu cw0 cw1 cb
      const int j0 = 2 + 8 * i;       // o's first array (int8 kinds)
      const int qi = q8(j0), qh = q8(j0 + 1);
      const float *si = sc(1 + 5 * i), *sh = sc(2 + 5 * i);
      const float *wih = w + o[0], *whh = w + o[1];
      const float *bih = w + o[2], *bhh = w + o[3];
      float* const hc = hb + (cur * 5 + i) * R * DEC_H;
      const float* const hp = hb + (prv * 5 + i) * R * DEC_H;

      // GRU gate sums in two K halves of [X[:, :gin] | h_prev] (the half
      // boundary kh = cin/2 <= gin), partials [half][R][DEC_GS]: columns
      // 0..191 x@wih + h@whh of the r and z gates, 192..287 x@wih of n,
      // 288..383 h@whh of n (half 1 only).  bih (+ bhh for r, z) rides on
      // half 0, bhh of n on half 1.  A unit is one 16-column group over one
      // half: 12 r|z groups x 2, then 6 n groups x 2, 36 units in 3 rounds.
      // Q: the r|z groups' h@whh go to hz [R][192], scaled on their own.
      const int kh = cin / 2;
      for (int u = warp; u < RG * DEC_GU; u += NWARP) {
        const int r0 = u / DEC_GU * ET, v = u % DEC_GU;
        const bool rz = v < 2 * DEC_RZ;
        const int hf = rz ? v / DEC_RZ : (v - 2 * DEC_RZ) / DEC_NG;
        const int c = (rz ? v % DEC_RZ : DEC_RZ + (v - 2 * DEC_RZ) % DEC_NG) * 16 + cq;
        float4 bx = zero4;
        if (hf == 0) bx = rz ? add4(ldg4(bih + c), ldg4(bhh + c)) : ldg4(bih + c);
        const float4 bh = hf == 1 && !rz ? ldg4(bhh + c) : zero4;
        float* const p = scr + hf * R * DEC_GS + c;
        const float4 gi = scl<Q, BF>(si, c, DEC_G), gh = scl<Q, BF>(sh, c, DEC_G);
        // (bh is zero for the r|z groups)
        float4 acc[ET];
        zero(acc);
        if (Q) {
          umac<Q, MM, SP, XS>(acc, X, DEC_X, r0, wih, mw(j0), qi, gin, DEC_G,
                              c, hf ? kh : 0, hf ? gin : kh, kl);
          kputq<Q, MM>(acc, kl, r0, p, DEC_GS, gi, bx, true);
          if (hf) {
            zero(acc);
            umac<Q, MM, SP, XS>(acc, hp, DEC_H, r0, whh, mw(j0 + 1), qh,
                                DEC_H, DEC_G, c, 0, DEC_H, kl);
            kputq<Q, MM>(acc, kl, r0, rz ? hz + c : p + DEC_H,
                         rz ? 2 * DEC_H : DEC_GS, gh, bh, true);
          }
          continue;
        }
        umac<Q, MM, SP, XS>(acc, X, DEC_X, r0, wih, mw(j0), qi, gin, DEC_G, c,
                            hf ? kh : 0, hf ? gin : kh, kl);
        if (rz && hf)
          umac<Q, MM, SP, XS>(acc, hp, DEC_H, r0, whh, mw(j0 + 1), qh, DEC_H,
                              DEC_G, c, 0, DEC_H, kl);
        kput<MM>(acc, kl, r0, p, DEC_GS, bx, true);
        if (!rz && hf) {
          zero(acc);
          umac<Q, MM, SP, XS>(acc, hp, DEC_H, r0, whh, mw(j0 + 1), qh, DEC_H,
                              DEC_G, c, 0, DEC_H, kl);
          kput<MM>(acc, kl, r0, p + DEC_H, DEC_GS, bh, true);
        }
      }
      __syncthreads();

      // GRU: the new h into the h ring; at the first step this layer's conv
      // history goes over the prefix of x[-1]
      {
        const float* const p0 = scr + fr * DEC_GS + fc;
        const float* const p1 = p0 + R * DEC_GS;
        float4 gr = add4(ld4(p0), ld4(p1));
        float4 gz = add4(ld4(p0 + DEC_H), ld4(p1 + DEC_H));
        if (Q) {
          const float* const pz = hz + fr * 2 * DEC_H + fc;
          gr = add4(gr, ld4(pz));
          gz = add4(gz, ld4(pz + DEC_H));
        }
        const float4 gx = add4(ld4(p0 + 2 * DEC_H), ld4(p1 + 2 * DEC_H));
        const float4 gh = ld4(p1 + 3 * DEC_H);
        const float4 h = ld4(hp + fr * DEC_H + fc);
        st4(hc + fr * DEC_H + fc,
            make_float4(gru_h(gr.x, gz.x, gx.x, gh.x, h.x),
                        gru_h(gr.y, gz.y, gx.y, gh.y, h.y),
                        gru_h(gr.z, gz.z, gx.z, gh.z, h.z),
                        gru_h(gr.w, gz.w, gx.w, gh.w, h.w)));
      }
      if (k == 0)
        stage<DEC_X>(Xp, a.hist_in[i] + (size_t)b0 * cin, cin, cin, rmax);
      __syncthreads();

      // GLU: X[:, gin:cin] = h * sigmoid(h @ glu_w), K in 2 chunks
      tprod<Q, BF, MM, SP, XS>(hc, DEC_H, w + o[4], q8(j0 + 4),
                               sc(3 + 5 * i), DEC_H, DEC_H, DEC_NG, 2, nullptr,
                               scr, warp, kl, cq, mw(j0 + 4));
      __syncthreads();
      {
        const float4 v = add4(ld4(scr + fr * DEC_H + fc),
                              ld4(scr + (R + fr) * DEC_H + fc));
        const float4 h = ld4(hc + fr * DEC_H + fc);
        st4(X + fr * DEC_X + gin + fc,
            make_float4(h.x * sigm(v.x), h.y * sigm(v.y), h.z * sigm(v.z),
                        h.w * sigm(v.w)));
      }
      __syncthreads();

      // conv k2: X[:, cin:cin+32] = tanh(x[k-1][:, :cin] @ cw0 +
      // X[:, :cin] @ cw1 + cb); an item is one 16-column group of one tap
      // over one of its DEC_CONV_KS K chunks, partials [tap][chunk][R][32],
      // cb on the first
      const int kc = ((cin + DEC_CONV_KS - 1) / DEC_CONV_KS + 31) & ~31;
      constexpr int CG = DEC_CO / 16, CU = 2 * DEC_CONV_KS * CG;
      for (int u = warp; u < RG * CU; u += NWARP) {
        const int r0 = u / CU * ET, v = u % CU;
        const int ch = v / CG, tap = ch / DEC_CONV_KS, c = v % CG * 16 + cq;
        const int kb = ch % DEC_CONV_KS * kc, ke = min(cin, kb + kc);
        const float4 b = ch == 0 ? ldg4(w + o[7] + c) : zero4;
        float4 acc[ET];
        zero(acc);
        umac<Q, MM, SP, XS>(acc, tap ? X : Xp, DEC_X, r0, w + o[5 + tap],
                            mw(j0 + 5 + tap), q8(j0 + 5 + tap), cin, DEC_CO, c,
                            kb, ke, kl);
        kputq<Q, MM>(acc, kl, r0, scr + ch * R * DEC_CO + c, DEC_CO,
                     scl<Q, BF>(sc(4 + 5 * i + tap), c, DEC_CO), b, true);
      }
      __syncthreads();
      if (t < R * DEC_CO / 4) {
        const int r = t / (DEC_CO / 4), c = t % (DEC_CO / 4) * 4;
        float4 v = ld4(scr + r * DEC_CO + c);
#pragma unroll
        for (int ch = 1; ch < 2 * DEC_CONV_KS; ++ch)
          v = add4(v, ld4(scr + (ch * R + r) * DEC_CO + c));
        st4(X + r * DEC_X + cin + c, tanh4(v));
      }
      __syncthreads();
    }

    // output: feats[:, k] = X @ out_w + out_b, K in 2 chunks
    tprod<Q, BF, MM, SP, XS>(X, DEC_X, w + off[DEC_NW - 2], q8(DEC_NW - 2),
                             sc(DEC_NS - 1), DEC_X, od, (od + 15) / 16, 2,
                             w + off[DEC_NW - 1], scr, warp, kl, cq,
                             mw(DEC_NW - 2));
    __syncthreads();
    if (t < nv * (od / 4)) {
      const int r = t / (od / 4), c = t % (od / 4) * 4;
      st4(a.feats + (((size_t)b0 + r) * a.nz + k) * od + c,
          add4(ld4(scr + r * od + c), ld4(scr + (R + r) * od + c)));
    }
    if (k + 1 < a.nz)   // the next step's latents, over x[k-1]
      stage<DEC_X>(Xp + DEC_H, zs.p + (size_t)(k + 1) * zstep, zs.ld,
                   a.in_dim, zs.rmax);
    __syncthreads();
  }

  const int last = (a.nz - 1) & 1;
  for (int i = 0; i < 5; ++i) {
    const int cin = 2 * DEC_H + 128 * i;
    const float* hs = hb + (last * 5 + i) * R * DEC_H;
    for (int it = threadIdx.x; it < nv * DEC_H; it += NT)
      a.h_out[i][(size_t)b0 * DEC_H + it] = hs[it];
    const float* xl = xb + last * R * DEC_X;
    for (int it = threadIdx.x; it < nv * cin; it += NT) {
      const int r = it / cin, j = it % cin;
      a.hist_out[i][((size_t)b0 + r) * cin + j] = xl[r * DEC_X + j];
    }
  }
}

// The instances: <false> f32 on FMA loops; every other one on the tensor
// cores, on the packed matrices qa.m: with bf16 products the MM instance
// <true, true, KindMmaArgs> on weights of kinds 1, 2 and 3 (tmma), the split
// instance <true, true, KindSplitArgs> on f32 weights (the GRU's matrices of
// kind 3 through tmma, the others, kind 0, through tmma<true> on their hi,
// mid and lo copies); with f32 products the int8 instance <true, false,
// KindSplitXArgs>, x in three bf16 parts against each int8 matrix widened to
// bf16 and each matrix that quant_exclude keeps in f32 as its three copies
// (tmma<false, XS> and tmma<true, XS>).
template <bool Q, bool BF = false, class KA = QuantArgs<DEC_NS>>
__global__ void __launch_bounds__(NT)
    dec_kernel(const DecArgs a, const __grid_constant__ KA qa) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * R;
  const Src z0{a.z + (size_t)b0 * a.nz * a.in_dim, a.nz * a.in_dim,
               min(R, a.B - b0) - 1};
  if constexpr (has_mma<KA>)
    dec_body<Q, BF, true>(a, qa, reinterpret_cast<float*>(smem4), z0,
                          a.in_dim, &qa.m);
  else
    dec_body<Q, BF>(a, qa, reinterpret_cast<float*>(smem4), z0, a.in_dim);
}

// The chain-merged decoder stack (radae_tpu's `kernel_merged`) over a.nz
// z-steps for the block's R rows, every product a tile product on operands
// in shared memory.  One x buffer: step k's latents are staged into layer
// 0's GLU window X[:, DEC_H..] (before the first step, then in the output
// pass of step k-1, after the output product has read X), where dense_1
// reads them.  h, the hh projection and the tap projection are carried in
// shared memory and updated in place.  smem holds DECM_SMEM bytes.  In the
// int8 instances (Q) the carried projections are the scaled ones, as in the
// TPU kernel: bhh is added where they are used.  BF: bf16 products, the
// kinds in qa (KindArgs).  The instances: <false> f32 on the merged layout
// on FMA loops; every other one on the tensor cores, either layout, on the
// packed matrices qa.m (a padded matrix packed as its merged one, so x
// stays contiguous): with bf16 products the MM instance <true, true,
// KindMmaArgs> on weights of kinds 1, 2 and 3 (int8, bf16, f32 rounded at
// the product; tmma), and the split instance <true, true, KindSplitArgs>
// on f32 weights, every matrix of kind 0 (the GRU's too: radae_tpu's merged
// kernel rounds none of its f32 matrices) on its hi, mid and lo copies
// (tmma<true>); with f32 products the instances on x's parts
// (KindSplitXArgs): <true, false, KindSplitXArgs> on int8 weights, x in
// three bf16 parts against each int8 matrix widened to bf16 and each matrix
// that quant_exclude keeps in f32 as its three copies (tmma<false, XS> and
// tmma<true, XS>), and <false, false, KindSplitXArgs> on f32 weights (the
// padded layout's f32 form), every matrix kind 0 and no scale row read.
template <bool Q, bool BF = false, class KA = QuantArgs<DECM_NS>>
__global__ void __launch_bounds__(NT)
    dec_merged_kernel(const DecMergedArgs a, const __grid_constant__ KA qa) {
  constexpr bool MM = has_mma<KA>, SP = has_split<KA>;
  constexpr int XS = has_xsplit<KA> ? XS_SPLIT : 0;
  static_assert(MM || !BF, "bf16 products run on the tensor cores");
  static_assert(BF || !MM || XS,
                "an MM instance with f32 products runs on x's parts");
  extern __shared__ float4 smem4[];
  float* const X = reinterpret_cast<float*>(smem4);     // [R][DEC_X]
  float* const hs = X + R * DEC_X;                      // [5][R][DEC_H]
  float* const gp = hs + 5 * R * DEC_H;                 // [5][R][DEC_G]
  float* const pp = gp + 5 * R * DEC_G;                 // [5][R][DEC_CO]
  float* const scr = pp + 5 * R * DEC_CO;               // partial sums
  float* const bs = scr + DEC_SCR;                      // [5][DECM_BIAS]
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int kl = lane >> 2, cq = 4 * (lane & 3);        // K lane, column quad
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.B - b0);
  const int rmax = nv - 1;
  const float* const w = a.w;
  const int* const off = a.off;
  const int od = a.out_dim;
  const int zld = a.nz * a.in_dim;                      // latent row stride
  const float* const z0 = a.z + (size_t)b0 * zld;
  // the float4 of a DEC_H-wide finish pass that is this thread's
  const int fr = t / (DEC_H / 4), fc = t % (DEC_H / 4) * 4;
  // Q: array j's kind and scale row si (d1, per layer wih wgg cw, out;
  // XS: kmma's kind, 1 int8, 0 kept in f32).  BF: kmma's kind 0 (the MM
  // instance's route reads none; the split instance runs only on f32
  // weights, every matrix of kind 0).  Neither Q nor BF (f32 weights on
  // x's parts): kind 0, no scale row
  const unsigned long long i8 = qa.i8;
  const int* const soff = qa.soff;
  const Kinds kd = kinds_of<BF>(qa);
  auto q8 = [=](int j) {
    if constexpr (BF) return 0;
    else return Q && (i8 >> j & 1);
  };
  auto sc = [=](int si) {
    if constexpr (BF) return Q && kd.ns ? w + soff[si] : nullptr;
    else return Q ? w + soff[si] : nullptr;
  };
  // MM: array j's packed copy
  auto mw = [&](int j) -> const uint4* {
    if constexpr (MM) return qa.m.p + qa.m.off[j];
    else return nullptr;
  };

  for (int i = 0; i < 5; ++i) {
    stage<DEC_H>(hs + i * R * DEC_H, a.h_in[i] + (size_t)b0 * DEC_H, DEC_H,
                 DEC_H, rmax);
    stage<DEC_G>(gp + i * R * DEC_G, a.hgp_in[i] + (size_t)b0 * DEC_G, DEC_G,
                 DEC_G, rmax);
    stage<DEC_CO>(pp + i * R * DEC_CO, a.hpp_in[i] + (size_t)b0 * DEC_CO,
                  DEC_CO, DEC_CO, rmax);
    // bhh and cb, which the gate and conv passes add (read from the L2
    // there, they cost 4% of the launch on an H100; the products' biases
    // ride on their first K chunk)
    for (int it = t; it < DECM_BIAS / 4; it += NT)
      st4(bs + i * DECM_BIAS + 4 * it,
          it < DEC_G / 4 ? ldg4(w + off[5 + 6 * i] + 4 * it)
                         : ldg4(w + off[7 + 6 * i] + 4 * it - DEC_G));
  }
  stage<DEC_X>(X + DEC_H, z0, zld, a.in_dim, rmax);
  __syncthreads();

  for (int k = 0; k < a.nz; ++k) {
    // dense_1: X[:, :96] = tanh(z_k @ d1_w + d1_b), K in 2 chunks
    tprod<Q, BF, MM, SP, XS>(X + DEC_H, DEC_X, w + off[0], q8(0), sc(0),
                             a.in_dim, DEC_H, DEC_NG, 2, w + off[1], scr, warp,
                             kl, cq, mw(0));
    __syncthreads();
    st4(X + fr * DEC_X + fc, tanh4(add4(ld4(scr + fr * DEC_H + fc),
                                        ld4(scr + (R + fr) * DEC_H + fc))));
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = DEC_H + 128 * i, cin = gin + DEC_H;
      const int* o = off + 2 + 6 * i;   // wih wgg bih bhh cw cb
      const int j0 = 2 + 6 * i;       // o's first array (int8 kinds)
      float* const h = hs + i * R * DEC_H;
      float* const hg = gp + i * R * DEC_G;
      float* const hp = pp + i * R * DEC_CO;
      const float* const bb = bs + i * DECM_BIAS;      // bhh | cb

      // xg = X[:, :gin] @ wih + bih: 18 column groups x 2 K halves, 36
      // units in 3 rounds, partials [half][R][DEC_G], bih on half 0
      tprod<Q, BF, MM, SP, XS>(X, DEC_X, w + o[0], q8(j0), sc(1 + 3 * i), gin,
                               DEC_G, DEC_G / 16, 2, w + o[2], scr, warp, kl, cq,
                               mw(j0));
      __syncthreads();

      // GRU gates from xg and the carried hh projection + bhh; h in place
      {
        const float* const p0 = scr + fr * DEC_G + fc;
        const float* const p1 = p0 + R * DEC_G;
        const float* const g = hg + fr * DEC_G + fc;
        const float* const bhh = bb + fc;
        const float4 xr = add4(ld4(p0), ld4(p1));
        const float4 xz = add4(ld4(p0 + DEC_H), ld4(p1 + DEC_H));
        const float4 xn = add4(ld4(p0 + 2 * DEC_H), ld4(p1 + 2 * DEC_H));
        const float4 gr = add4(ld4(g), ld4(bhh));
        const float4 gz = add4(ld4(g + DEC_H), ld4(bhh + DEC_H));
        const float4 gn = add4(ld4(g + 2 * DEC_H), ld4(bhh + 2 * DEC_H));
        float* const hr = h + fr * DEC_H + fc;
        const float4 hv = ld4(hr);
        st4(hr, make_float4(gru_h(xr.x + gr.x, xz.x + gz.x, xn.x, gn.x, hv.x),
                            gru_h(xr.y + gr.y, xz.y + gz.y, xn.y, gn.y, hv.y),
                            gru_h(xr.z + gr.z, xz.z + gz.z, xn.z, gn.z, hv.z),
                            gru_h(xr.w + gr.w, xz.w + gz.w, xn.w, gn.w, hv.w)));
      }
      __syncthreads();

      // h @ [whh | glu], K = 96 whole: 24 units in 2 rounds.  The 18 hh
      // groups are the next step's projection (read above); the 6 GLU
      // groups give X[:, gin:cin] = h * sigmoid(h @ glu); Q: both scaled
      const int qg = q8(j0 + 1);
      const float* const sgg = sc(2 + 3 * i);
      for (int u = warp; u < RG * DECM_GGC; u += NWARP) {
        const int r0 = u / DECM_GGC * ET, c = u % DECM_GGC * 16 + cq;
        float4 acc[ET];
        zero(acc);
        umac<Q, MM, SP, XS>(acc, h, DEC_H, r0, w + o[1], mw(j0 + 1), qg,
                            DEC_H, DEC_GG, c, 0, DEC_H, kl);
        constexpr int rs = MM ? 8 : 1;   // the lane's rows rk, rk + rs (kput)
        const int rk = MM ? r0 + kl : ksum(acc, kl, r0);
        if (Q && (!BF || sgg)) {
          const float4 s4 = ldg4(sgg + c);
#pragma unroll
          for (int j = 0; j < ET / 8; ++j) acc[j] = mul4(acc[j], s4);
        }
        if (c < DEC_G) {
#pragma unroll
          for (int j = 0; j < ET / 8; ++j) st4(hg + (rk + rs * j) * DEC_G + c, acc[j]);
        } else {
#pragma unroll
          for (int j = 0; j < ET / 8; ++j) {
            const float4 v = acc[j], hv = ld4(h + (rk + rs * j) * DEC_H + c - DEC_G);
            st4(X + (rk + rs * j) * DEC_X + gin + c - DEC_G,
                make_float4(hv.x * sigm(v.x), hv.y * sigm(v.y),
                            hv.z * sigm(v.z), hv.w * sigm(v.w)));
          }
        }
      }
      __syncthreads();

      // cc = X[:, :cin] @ [tap1 | tap0]: 4 column groups x DECM_CONV_KS K
      // chunks, partials [chunk][R][64]
      tprod<Q, BF, MM, SP, XS>(X, DEC_X, w + o[4], q8(j0 + 4), sc(3 + 3 * i),
                               cin, 2 * DEC_CO, 2 * DEC_CO / 16, DECM_CONV_KS,
                               nullptr, scr, warp, kl, cq, mw(j0 + 4));
      __syncthreads();
      // X[:, cin:cin+32] = tanh(tap-0 projection + tap 1 + cb); the tap-0
      // half of cc is the next step's projection (each float4 of it read
      // and written by one thread)
      if (t < R * DEC_CO / 4) {
        const int r = t / (DEC_CO / 4), c = t % (DEC_CO / 4) * 4;
        const float* const p = scr + r * 2 * DEC_CO + c;
        float4 y = ld4(p), q = ld4(p + DEC_CO);
#pragma unroll
        for (int ch = 1; ch < DECM_CONV_KS; ++ch) {
          y = add4(y, ld4(p + ch * R * 2 * DEC_CO));
          q = add4(q, ld4(p + ch * R * 2 * DEC_CO + DEC_CO));
        }
        float* const hq = hp + r * DEC_CO + c;
        st4(X + r * DEC_X + cin + c,
            tanh4(add4(add4(ld4(hq), y), ld4(bb + DEC_G + c))));
        st4(hq, q);
      }
      __syncthreads();
    }

    // output: feats[:, k] = X @ out_w + out_b, K in 2 chunks
    tprod<Q, BF, MM, SP, XS>(X, DEC_X, w + off[DEC_NWM - 2], q8(DEC_NWM - 2),
                             sc(DECM_NS - 1), DEC_X, od, (od + 15) / 16, 2,
                             w + off[DEC_NWM - 1], scr, warp, kl, cq,
                             mw(DEC_NWM - 2));
    __syncthreads();
    for (int it = t; it < nv * (od / 4); it += NT) {
      const int r = it / (od / 4), c = it % (od / 4) * 4;
      st4(a.feats + (((size_t)b0 + r) * a.nz + k) * od + c,
          add4(ld4(scr + r * od + c), ld4(scr + (R + r) * od + c)));
    }
    if (k + 1 < a.nz)   // the next step's latents, into layer 0's GLU window
      stage<DEC_X>(X + DEC_H, z0 + (size_t)(k + 1) * a.in_dim, zld, a.in_dim,
                   rmax);
    __syncthreads();
  }

  for (int i = 0; i < 5; ++i) {
    const size_t o = (size_t)b0;
    for (int it = t; it < nv * DEC_H / 4; it += NT)
      st4(a.h_out[i] + o * DEC_H + 4 * it, ld4(hs + i * R * DEC_H + 4 * it));
    for (int it = t; it < nv * DEC_G / 4; it += NT)
      st4(a.hgp_out[i] + o * DEC_G + 4 * it, ld4(gp + i * R * DEC_G + 4 * it));
    for (int it = t; it < nv * DEC_CO / 4; it += NT)
      st4(a.hpp_out[i] + o * DEC_CO + 4 * it, ld4(pp + i * R * DEC_CO + 4 * it));
  }
}

// The whole rx frame for the block's R streams: demod prologue, then
// dec_body on the latents it leaves in shared memory.  FIX: the flagship
// modem's geometry as constants (flagship_geo), else the launch's (a.g);
// the flagship through the FIX=false instance ran 3.5% slower on an H100
// (tools/enc_variants.py --kernel frame, form frgeneric).  BF: bf16
// products, every product rounding both its inputs (radae_tpu's frame
// kernel's dot), the decoder's kinds in a.k (the instance <false, true>):
// an MM instance, the DFT and every decoder product on the tensor cores
// (tmma) on the packed matrices of a (FrameMmaArgs).
template <bool FIX, bool BF = false>
__global__ void __launch_bounds__(NT) rx_frame_kernel(const FrameArgsOf<BF> a) {
  extern __shared__ float4 smem4[];
  const FrameGeo g = FIX ? flagship_geo() : a.g;
  const int nsym = g.ns + 2, row = 2 * g.samp, yw = g.yw;
  const int srows = R * nsym / g.stages;          // symbol rows a stage
  const int cg = (yw + 15) / 16;                  // column groups of the DFT
  const int pz = g.lat / 2;                       // symbols a z-step
  float* const smem = reinterpret_cast<float*>(smem4);
  // the decoder's rings hold the samples and its scratch the demod
  // intermediates until z is made
  float* const S = smem;                                      // [R*nsym][row]
  float* const Y = smem + DEC_RING;                           // [R][nsym][yw]
  float* const hp0 = Y + R * nsym * yw;                       // [R][yw]
  float* const hp1 = hp0 + R * yw;                            // [R][yw]
  float* const inv_mag = hp1 + R * yw;                        // [R]
  float* const zsh = smem + DEC_SMEM / sizeof(float);         // [R][nz*lat]
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane >> 2, cq = 4 * (lane & 3);
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.d.B - b0);

  // the block's samples (R streams x nsym symbol rows, contiguous in device
  // memory; streams past B repeat the last one) into the rings by cp.async,
  // in g.stages commit groups of srows rows
  const float* const rx = a.rx + (size_t)b0 * nsym * row;
  for (int s = 0; s < g.stages; ++s) {
    for (int it = threadIdx.x; it < srows * (row / 4); it += NT) {
      const int q = s * srows + it / (row / 4), c = it % (row / 4) * 4;
      const int r = min(q / nsym, nv - 1);
      cp_async16(S + q * row + c, rx + ((size_t)r * nsym + q % nsym) * row + c);
    }
    cp_async_commit();
  }

  // strip_cp + DFT of every symbol row: (R*nsym, row) @ dft_w -> [Yr | Yi],
  // a stage's products as soon as its rows have landed, so they overlap
  // the later stages' copies
  for (int s = 0; s < g.stages; ++s) {
    cp_async_wait(g.stages - 1 - s);
    __syncthreads();
    for (int u = warp; u < srows / ET * cg; u += NWARP) {
      const int r0 = s * srows + u / cg * ET, c = u % cg * 16 + cq;
      float4 acc[ET];
      zero(acc);
      if constexpr (BF)
        tmma(acc, S, row, r0, a.dft_m, row, c, 0, row, kl);
      else
        tmac(acc, S, row, r0, a.dft_w, yw, c, 0, row, kl);
      kput<BF>(acc, kl, r0, Y + c, yw, make_float4(0.f, 0.f, 0.f, 0.f), c < yw);
    }
  }
  __syncthreads();

  // LS channel estimates of the two pilot rows: [Yr | Yi] @ ls_w
  const Src p0{Y, nsym * yw, R - 1};
  const Src p1{Y + (nsym - 1) * yw, nsym * yw, R - 1};
  rowprod<BF>(p0, a.ls_w, yw, yw,
          [&](int r, int c, float4 v) { st4(hp0 + r * yw + c, v); });
  rowprod<BF>(p1, a.ls_w, yw, yw,
          [&](int r, int c, float4 v) { st4(hp1 + r * yw + c, v); });
  __syncthreads();

  // coarse magnitude: the mean over the carriers, summed in carrier order
  if (threadIdx.x < R) {
    const int r = threadIdx.x, nc = g.nc;
    float im = 1.f;
    if (a.coarse_mag) {
      const float* q0 = hp0 + r * yw;
      const float* q1 = hp1 + r * yw;
      float s = 0.f;
      for (int c = 0; c < nc; ++c)
        s += q0[c] * q0[c] + q0[nc + c] * q0[nc + c] +
             q1[c] * q1[c] + q1[nc + c] * q1[nc + c];
      im = 1.f / ((sqrtf(0.5f * (s / nc)) + 1e-6f) * a.mag_k);
    }
    inv_mag[r] = im;
  }
  __syncthreads();

  // linear pilot interpolation + phase EQ + magnitude, demapped into the
  // z-steps' [re(pz) | im(pz)] latents (data symbol m = (s-1)*Nc + c)
  for (int it = threadIdx.x; it < R * g.ns * g.nc; it += NT) {
    const int r = it / (g.ns * g.nc), m = it % (g.ns * g.nc);
    const int s = m / g.nc + 1, c = m % g.nc;
    const float t = (float)s / (g.ns + 1), u = 1.f - t;
    const float* q0 = hp0 + r * yw;
    const float* q1 = hp1 + r * yw;
    const float hr = q0[c] * u + q1[c] * t;
    const float hi = q0[g.nc + c] * u + q1[g.nc + c] * t;
    const float scale = rsqrtf(hr * hr + hi * hi + 1e-12f) * inv_mag[r];
    const float* y = Y + (r * nsym + s) * yw;
    const float yr = y[c], yi = y[g.nc + c];
    float* const zk = zsh + r * g.nz * g.lat + (m / pz) * g.lat + m % pz;
    zk[0] = (yr * hr + yi * hi) * scale;
    zk[pz] = (yi * hr - yr * hi) * scale;
  }
  __syncthreads();

  if constexpr (BF)
    dec_body<false, true, true>(a.d, a.k, smem, Src{zsh, g.nz * g.lat, R - 1},
                                g.lat, &a.m);
  else
    dec_body<false>(a.d, QuantArgs<DEC_NS>{}, smem,
                    Src{zsh, g.nz * g.lat, R - 1}, g.lat);
}

// The encoder stack over a.nz z-steps for the block's R rows.  x[t] of
// step t lives in ring slot t % 3; the carried state is staged into the
// slots of x[-1] and x[-2] (h at its GRU window, each conv's history tap
// as the prefix), and the features of step k at columns ENC_FOFF.. of its
// own slot, each in a pass that already sits between two barriers.  Q: the
// int8 and bf16-product instances' form (ENC_SMEM_Q bytes of shared memory).
// The instances: <false> f32 on FMA loops; every other one on the tensor
// cores, on the packed matrices qa.m: with bf16 products (BF, the kinds in
// qa) the MM instance <true, true, KindMmaArgs> on weights of kinds 1, 2 and
// 3 (tmma), the split instance <true, true, KindSplitArgs> on f32 weights
// (kind 3 through tmma, kind 0 through tmma<true> on hi, mid, lo); with f32
// products the int8 instance <true, false, KindSplitXArgs> (XS_SEP: x hi's
// products summed apart), x in three bf16 parts against each int8
// matrix widened to bf16 and each matrix that quant_exclude keeps in f32 as
// its three copies (tmma<false, XS> and tmma<true, XS>).
template <bool Q, bool BF = false, class KA = QuantArgs<ENC_NS>>
__global__ void __launch_bounds__(NT)
    enc_kernel(const EncArgs a, const __grid_constant__ KA qa) {
  constexpr bool MM = has_mma<KA>, SP = has_split<KA>;
  constexpr int XS = has_xsplit<KA> ? XS_SEP : 0;
  static_assert(MM || !Q, "the int8 instances run on the tensor cores");
  static_assert(BF || !MM || (Q && XS),
                "an MM instance with f32 products is the int8 one on x's parts");
  extern __shared__ float4 smem4[];
  float* const xb = reinterpret_cast<float*>(smem4);   // [3][R][ENC_X]
  float* const scr = xb + 3 * R * ENC_X;                // gates / partials
  float* const ez = scr + ENC_SCR;                      // Q: r|z h @ whh
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int kl = lane >> 2, cq = 4 * (lane & 3);        // K lane, column quad
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.B - b0);
  const int rmax = nv - 1;
  const float* const w = a.w;
  const int* const off = a.off;
  const int fld = a.nz * a.in_dim;                      // feature row stride
  const float* const f0 = a.f + (size_t)b0 * fld;

  // each finish pass is one float4 a thread: its biases are loaded ahead
  const int t = threadIdx.x, od = a.out_dim;
  const float4 zero4 = make_float4(0.f, 0.f, 0.f, 0.f);
  const float4 d1v = ldg4(w + off[1] + t % (ENC_H / 4) * 4);
  const float4 obv = ldg4(w + off[ENC_NW - 1] + t % (od / 4) * 4);
  // Q: array j's kind and scale row si (d1, per layer wih whh cw0 cw1,
  // out; XS: kmma's kind, 1 int8, 0 kept in f32); BF: kmma's kind
  const unsigned long long i8 = qa.i8;
  const int* const soff = qa.soff;
  const Kinds kd = kinds_of<BF>(qa);
  auto q8 = [=](int j) {
    if constexpr (BF) return kd(j);
    else return Q && (i8 >> j & 1);
  };
  auto sc = [=](int si) {
    if constexpr (BF) return Q && kd.ns ? w + soff[si] : nullptr;
    else return Q ? w + soff[si] : nullptr;
  };
  // MM: array j's packed copy
  auto mw = [&](int j) -> const uint4* {
    if constexpr (MM) return qa.m.p + qa.m.off[j];
    else return nullptr;
  };
  stage<ENC_X>(xb + ENC_FOFF, f0, fld, a.in_dim, rmax);
  __syncthreads();
  for (int k = 0; k < a.nz; ++k) {
    float* const X = xb + (k % 3) * R * ENC_X;
    float* const Xp = xb + ((k + 2) % 3) * R * ENC_X;   // x[k-1]

    // dense_1: X[:, :64] = tanh(f_k @ d1_w + d1_b), K in ENC_D1_KS chunks
    const int kd = ((a.in_dim + ENC_D1_KS - 1) / ENC_D1_KS + 31) & ~31;
    for (int u = warp; u < RG * 4 * ENC_D1_KS; u += NWARP) {
      const int r0 = u / (4 * ENC_D1_KS) * ET, ch = u / 4 % ENC_D1_KS;
      const int c = u % 4 * 16 + cq;
      const int kb = ch * kd, ke = min(a.in_dim, kb + kd);
      float4 acc[ET];
      zero(acc);
      if (kb < ke)
        umac<Q, MM, SP, XS>(acc, X + ENC_FOFF, ENC_X, r0, w + off[0], mw(0),
                            q8(0), a.in_dim, ENC_H, c, kb, ke, kl);
      kputq<Q, MM>(acc, kl, r0, scr + ch * R * ENC_H + c, ENC_H,
                   scl<Q, BF>(sc(0), c, ENC_H), zero4, true);
    }
    __syncthreads();
    if (t < R * ENC_H / 4) {
      const int r = t / (ENC_H / 4), c = t % (ENC_H / 4) * 4;
      float4 v = ld4(scr + r * ENC_H + c);
#pragma unroll
      for (int ch = 1; ch < ENC_D1_KS; ++ch)
        v = add4(v, ld4(scr + (ch * R + r) * ENC_H + c));
      st4(X + r * ENC_X + c, tanh4(add4(v, d1v)));
    }
    if (k == 0) stage<ENC_X>(Xp + ENC_H, a.h_in[0] + (size_t)b0 * ENC_H, ENC_H, ENC_H, rmax);
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = ENC_H + 160 * i, cin = gin + ENC_H;
      const int d = i == 0 ? 1 : 2;     // conv dilations 1,2,2,2,2
      const int* o = off + 2 + 7 * i;   // wih whh bih bhh cw0 cw1 cb
      const int j0 = 2 + 7 * i;       // o's first array (int8 kinds)
      const int qi = q8(j0), qh = q8(j0 + 1);
      const float *si = sc(1 + 4 * i), *sh = sc(2 + 4 * i);
      const float *wih = w + o[0], *whh = w + o[1];
      const float *bih = w + o[2], *bhh = w + o[3];
      float* const Xd = xb + ((k + 3 - d) % 3) * R * ENC_X;  // x[k-d]
      const float4 cbv = ldg4(w + o[6] + t % (ENC_CO / 4) * 4);

      // GRU gate sums into scr [R][ENC_GS]: columns 0..127 x@wih + h@whh
      // + bih + bhh of the r and z gates; 128..191 x@wih + bih of the n
      // gate; 192..255 h@whh + bhh of the n gate.  A unit is one 16-column
      // group: an r|z item over both products, or the two n items.  The
      // previous h is x[k-1]'s GRU window.  Q: an r|z item puts its h@whh
      // into ez [R][128], scaled on its own.
      for (int u = warp; u < RG * 12; u += NWARP) {
        const int r0 = u / 12 * ET, qg = u % 12, c = qg * 16 + cq;
        const float4 bi = ldg4(bih + c), bh = ldg4(bhh + c);
        const float4 gi = scl<Q, BF>(si, c, ENC_G), gh = scl<Q, BF>(sh, c, ENC_G);
        float4 acc[ET];
        zero(acc);
        if (Q) {
          const bool rz = qg < 8;
          umac<Q, MM, SP, XS>(acc, X, ENC_X, r0, wih, mw(j0), qi, gin, ENC_G, c,
                              0, gin, kl);
          kputq<Q, MM>(acc, kl, r0, scr + c, ENC_GS, gi,
                       rz ? add4(bi, bh) : bi, true);
          zero(acc);
          umac<Q, MM, SP, XS>(acc, Xp + gin, ENC_X, r0, whh, mw(j0 + 1), qh,
                              ENC_H, ENC_G, c, 0, ENC_H, kl);
          kputq<Q, MM>(acc, kl, r0, rz ? ez + c : scr + ENC_H + c,
                       rz ? 2 * ENC_H : ENC_GS, gh, rz ? zero4 : bh, true);
          continue;
        }
        tmac(acc, X, ENC_X, r0, wih, ENC_G, c, 0, gin, kl);
        if (qg < 8) {
          tmac(acc, Xp + gin, ENC_X, r0, whh, ENC_G, c, 0, ENC_H, kl);
          kput(acc, kl, r0, scr + c, ENC_GS, add4(bi, bh), true);
        } else {
          kput(acc, kl, r0, scr + c, ENC_GS, bi, true);
          zero(acc);
          tmac(acc, Xp + gin, ENC_X, r0, whh, ENC_G, c, 0, ENC_H, kl);
          kput(acc, kl, r0, scr + ENC_H + c, ENC_GS, bh, true);
        }
      }
      __syncthreads();

      // GRU: X[:, gin:cin] = h' (the encoder appends h itself); at k == 0
      // the previous h is read from the state, since this pass stages the
      // conv history over x[-1] (layer 0)
      const float* hp = k > 0 ? Xp + gin : a.h_in[i] + (size_t)b0 * ENC_H;
      const int hld = k > 0 ? ENC_X : ENC_H, hmax = k > 0 ? R - 1 : rmax;
      for (int it = threadIdx.x; it < R * ENC_H; it += NT) {
        const int r = it / ENC_H, j = it % ENC_H;
        const float* s = scr + r * ENC_GS;
        float gr = s[j], gz = s[ENC_H + j];
        if (Q) {
          gr += ez[r * 2 * ENC_H + j];
          gz += ez[r * 2 * ENC_H + ENC_H + j];
        }
        const float rr = sigm(gr);
        const float zz = sigm(gz);
        const float nn = tanhf(s[2 * ENC_H + j] + rr * s[3 * ENC_H + j]);
        const float h = hp[(size_t)min(r, hmax) * hld + j];
        X[r * ENC_X + gin + j] = (1.f - zz) * nn + zz * h;
      }
      if (k < d)   // conv history tap k of the state = x[k-d]
        stage<ENC_X>(Xd, a.hist_in[i] + ((size_t)b0 * d + k) * cin, d * cin, cin, rmax);
      __syncthreads();

      // conv k2, dilation d: X[:, cin:cin+96] =
      //   tanh(x[k-d][:, :cin] @ cw0 + X[:, :cin] @ cw1 + cb);
      // a unit is one 16-column group of one tap, partials [tap][R][96]
      for (int u = warp; u < RG * 12; u += NWARP) {
        const int r0 = u / 12 * ET, tap = u % 12 / 6;
        const int c = u % 6 * 16 + cq;
        float4 acc[ET];
        zero(acc);
        umac<Q, MM, SP, XS>(acc, tap ? X : Xd, ENC_X, r0, w + o[4 + tap],
                            mw(j0 + 4 + tap), q8(j0 + 4 + tap), cin, ENC_CO, c,
                            0, cin, kl);
        kputq<Q, MM>(acc, kl, r0, scr + tap * R * ENC_CO + c, ENC_CO,
                     scl<Q, BF>(sc(3 + 4 * i + tap), c, ENC_CO), zero4, true);
      }
      __syncthreads();
      if (t < R * ENC_CO / 4) {
        const int r = t / (ENC_CO / 4), c = t % (ENC_CO / 4) * 4;
        const float4 v = add4(ld4(scr + r * ENC_CO + c),
                              ld4(scr + (R + r) * ENC_CO + c));
        st4(X + r * ENC_X + cin + c, tanh4(add4(v, cbv)));
      }
      if (k == 0 && i < 4)   // the next layer's h state at its GRU window
        stage<ENC_X>(Xp + gin + 160, a.h_in[i + 1] + (size_t)b0 * ENC_H, ENC_H, ENC_H,
              rmax);
      __syncthreads();
    }

    // z_dense: z[:, k] = X @ out_w + out_b (tanh for bottleneck 1), K in
    // ENC_Z_KS chunks, partials [chunk][R][out_dim]
    const int nqg = (od + 15) / 16;
    const int kz = ((ENC_X + ENC_Z_KS - 1) / ENC_Z_KS + 31) & ~31;
    for (int u = warp; u < RG * nqg * ENC_Z_KS; u += NWARP) {
      const int r0 = u / (nqg * ENC_Z_KS) * ET, ch = u / nqg % ENC_Z_KS;
      const int c = u % nqg * 16 + cq;
      const int kb = ch * kz, ke = min(ENC_X, kb + kz);
      float4 acc[ET];
      zero(acc);
      umac<Q, MM, SP, XS>(acc, X, ENC_X, r0, w + off[ENC_NW - 2],
                          mw(ENC_NW - 2), q8(ENC_NW - 2), ENC_X, od, c, kb, ke,
                          kl);
      kputq<Q, MM>(acc, kl, r0, scr + ch * R * od + c, od,
                   scl<Q, BF>(sc(ENC_NS - 1), c, od), zero4, c < od);
    }
    __syncthreads();
    float* const zo = a.z + ((size_t)b0 * a.nz + k) * od;
    if (t < nv * (od / 4)) {
      const int r = t / (od / 4), c = t % (od / 4) * 4;
      float4 v = ld4(scr + r * od + c);
#pragma unroll
      for (int ch = 1; ch < ENC_Z_KS; ++ch)
        v = add4(v, ld4(scr + (ch * R + r) * od + c));
      v = add4(v, obv);
      st4(zo + (size_t)r * a.nz * od + c, a.bottleneck == 1 ? tanh4(v) : v);
    }
    if (k + 1 < a.nz)   // the next step's features, over x[k-2]
      stage<ENC_X>(xb + ((k + 1) % 3) * R * ENC_X + ENC_FOFF, f0 + (k + 1) * a.in_dim,
            fld, a.in_dim, rmax);
    __syncthreads();
  }

  // state: h = last step's GRU window; history ring tap t = x[nz-d+t]
  const float* xl = xb + ((a.nz - 1) % 3) * R * ENC_X;
  for (int i = 0; i < 5; ++i) {
    const int gin = ENC_H + 160 * i, cin = gin + ENC_H;
    const int d = i == 0 ? 1 : 2;
    for (int it = threadIdx.x; it < nv * ENC_H; it += NT) {
      const int r = it / ENC_H, j = it % ENC_H;
      a.h_out[i][((size_t)b0 + r) * ENC_H + j] = xl[r * ENC_X + gin + j];
    }
    for (int it = threadIdx.x; it < nv * d * cin; it += NT) {
      const int r = it / (d * cin), t = (it / cin) % d, j = it % cin;
      const int s = a.nz - d + t;
      const size_t row = ((size_t)b0 + r) * d * cin;
      a.hist_out[i][row + (size_t)t * cin + j] =
          s >= 0 ? xb[(s % 3) * R * ENC_X + r * ENC_X + j]
                 : a.hist_in[i][row + (size_t)(s + d) * cin + j];
    }
  }
}

// The int8 mask of a launch (bit j: array j is int8) from its kinds[n]
// (1: int8), and its scale offsets into soff_out; false unless the launch is
// one that an instance takes: no scale rows and no int8 array (f32), or ns
// scale rows and int8 at matrices only (int8)
template <int NS>
bool quant_args(const int* kinds, int n, const int* soff, int n_soff,
                unsigned long long mats, QuantArgs<NS>& q) {
  if (n_soff != 0 && n_soff != NS) return false;
  q.i8 = 0;
  for (int j = 0; j < n; ++j) {
    if (kinds[j] < 0 || kinds[j] > 1) return false;
    if (kinds[j]) q.i8 |= 1ull << j;
  }
  for (int j = 0; j < NS; ++j) q.soff[j] = n_soff ? soff[j] : 0;
  return (q.i8 & ~mats) == 0 && (n_soff > 0 || q.i8 == 0);
}

// The same for an MM instance (k): kinds[j] 0 f32, 1 int8,
// 2 bf16, 3 f32 rounded to bf16 at its products; bf16 and rounded kinds
// only with bf16 products (bf), all at matrices (mats), int8 only with the
// ns scale rows
template <int NS>
bool kind_args(const int* kinds, int n, const int* soff, int n_soff,
               unsigned long long mats, bool bf, KindArgs<NS>& k) {
  if (n_soff != 0 && n_soff != NS) return false;
  k.i8 = k.bf = k.rw = 0;
  for (int j = 0; j < n; ++j) {
    unsigned long long* m[4] = {nullptr, &k.i8, &k.bf, &k.rw};
    if (kinds[j] < 0 || kinds[j] > 3) return false;
    if (kinds[j]) *m[kinds[j]] |= 1ull << j;
  }
  for (int j = 0; j < NS; ++j) k.soff[j] = n_soff ? soff[j] : 0;
  k.ns = n_soff;
  k.pad = 0;
  return ((k.i8 | k.bf | k.rw) & ~mats) == 0 && (n_soff > 0 || k.i8 == 0) &&
         (bf || (k.bf | k.rw) == 0);
}

// The packed matrices of an MM launch (m) from the buffer wm and each
// array's start in it (moff[n], -1 for none); false unless every array in
// mats is packed
template <int NW>
bool mma_args(const void* wm, const int* moff, int n, unsigned long long mats,
              MmaW<NW>& m) {
  if (!wm || n != NW) return false;
  m.p = static_cast<const uint4*>(wm);
  for (int j = 0; j < NW; ++j) {
    m.off[j] = moff[j];
    if ((mats >> j & 1) && moff[j] < 0) return false;
  }
  return true;
}

// Set the kernel's shared memory and launch it on the stream
template <class K, class A, class Q>
int launch(K kernel, size_t smem, int B, void* stream, const A& a,
           const Q& q) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(B + R - 1) / R, NT, smem, static_cast<cudaStream_t>(stream)>>>(a, q);
  return (int)cudaGetLastError();
}

// The DecArgs of an unmerged decoder launch; false unless the entries take
// its sizes
bool dec_args(const void* w, const int* off, int n_off, const void* z,
              void* feats, int B, int nz, int in_dim, int out_dim,
              void* const* state_in, void* const* state_out, DecArgs& a) {
  if (n_off != DEC_NW || B < 1 || nz < 1 || in_dim < 4 || in_dim % 4 ||
      in_dim > DEC_H || out_dim < 4 || out_dim % 4 || out_dim > DEC_TMAX_OUT)
    return false;
  a.w = static_cast<const float*>(w);
  for (int i = 0; i < DEC_NW; ++i) a.off[i] = off[i];
  a.z = static_cast<const float*>(z);
  a.feats = static_cast<float*>(feats);
  a.B = B; a.nz = nz; a.in_dim = in_dim; a.out_dim = out_dim;
  for (int i = 0; i < 5; ++i) {
    a.h_in[i] = static_cast<const float*>(state_in[i]);
    a.hist_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.h_out[i] = static_cast<float*>(state_out[i]);
    a.hist_out[i] = static_cast<float*>(state_out[5 + i]);
  }
  return true;
}

// The EncArgs of an encoder launch; false unless the entries take its sizes
bool enc_args(const void* w, const int* off, int n_off, const void* f, void* z,
              int B, int nz, int in_dim, int out_dim, int bottleneck,
              void* const* state_in, void* const* state_out, EncArgs& a) {
  if (n_off != ENC_NW || B < 1 || nz < 1 || in_dim < 4 || in_dim % 4 ||
      out_dim < 4 || out_dim % 4 || in_dim > ENC_X - ENC_FOFF ||
      out_dim > ENC_MAX_OUT)
    return false;
  a.w = static_cast<const float*>(w);
  for (int i = 0; i < ENC_NW; ++i) a.off[i] = off[i];
  a.f = static_cast<const float*>(f);
  a.z = static_cast<float*>(z);
  a.B = B; a.nz = nz; a.in_dim = in_dim; a.out_dim = out_dim;
  a.bottleneck = bottleneck;
  for (int i = 0; i < 5; ++i) {
    a.h_in[i] = static_cast<const float*>(state_in[i]);
    a.hist_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.h_out[i] = static_cast<float*>(state_out[i]);
    a.hist_out[i] = static_cast<float*>(state_out[5 + i]);
  }
  return true;
}

// The KindSplitArgs of a launch on the tensor cores of the unmerged decoder
// (NS, NW, MATS: DEC_*) or the encoder (ENC_*): the kinds (kind_args; kinds
// 2 and 3 only with bf16 products, and with f32 products n_soff > 0: the
// int8 sets) and the packed matrices (mma_args); false unless both hold
template <int NS, int NW>
bool mma_launch_args(const int* kinds, int n_off, const int* soff, int n_soff,
                     unsigned long long mats, bool bf16, const void* wm,
                     const int* moff, KindSplitArgs<NS, NW>& km) {
  return (bf16 || n_soff != 0) &&
         kind_args(kinds, n_off, soff, n_soff, mats, bf16, km) &&
         mma_args(wm, moff, n_off, mats, km.m);
}

}  // namespace

extern "C" {

// Every entry takes (weights, offsets[n_off], n_off, input, output, sizes...,
// state_in[], state_out[], stream) and returns the launch's cudaError_t.  The
// decoders and the encoder take, after n_off, each array's kind (kinds[n_off],
// 1 for an int8 matrix) and the offsets of the scale rows (soff[n_soff]:
// n_soff 0 for f32 weights, the layout's number of matrices for int8 ones).
// Every launch on int8 weights runs on the tensor cores and takes the
// matrices packed into wm at moff[n_off] (16-byte words, fc.mma_weights):
// the unmerged decoder's and the encoder's mma entries and the merged
// decoder's x entry, each with a bf16 flag (bf16 products, else f32
// products on x's bf16 parts).  Those entries refuse a launch without
// them, and the f32 entries refuse int8 weights (n_soff > 0): there is no
// FMA int8 instance to fall back on.

int radae_fused_decoder_step(const void* w, const int* off, int n_off,
                             const int* kinds, const int* soff, int n_soff,
                             const void* z, void* feats, int B, int nz,
                             int in_dim, int out_dim, void* const* state_in,
                             void* const* state_out, void* stream) {
  DecArgs a;
  QuantArgs<DEC_NS> q;
  if (n_soff != 0 || !quant_args(kinds, n_off, soff, n_soff, DEC_MATS, q) ||
      !dec_args(w, off, n_off, z, feats, B, nz, in_dim, out_dim, state_in,
                state_out, a))
    return (int)cudaErrorInvalidValue;
  return launch(dec_kernel<false>, DEC_SMEM, B, stream, a, q);
}

// radae_fused_decoder_step on the tensor cores, on the matrices packed into
// wm at moff[n_off] (16-byte words), refused without them (there is no FMA
// instance to fall back on).  With bf16 products (bf16): kinds 0..3
// (kind_args); with no matrix of kind 0 (int8, bf16 or rounded matrices:
// every product bf16 x bf16) the MM instance, else (f32 weights) the split
// instance, each kind-0 matrix packed as hi, mid, lo.  With f32 products
// (int8 weights only, n_soff > 0): the x-split instance (KindSplitXArgs),
// each int8 matrix (kind 1) widened to bf16, each that quant_exclude keeps
// in f32 (kind 0) as hi, mid, lo.
int radae_fused_decoder_mma_step(const void* w, const int* off, int n_off,
                                 const int* kinds, const int* soff, int n_soff,
                                 const void* z, void* feats, int B, int nz,
                                 int in_dim, int out_dim, int bf16,
                                 const void* wm, const int* moff,
                                 void* const* state_in, void* const* state_out,
                                 void* stream) {
  DecArgs a;
  KindSplitArgs<DEC_NS, DEC_NW> km;
  if (!mma_launch_args(kinds, n_off, soff, n_soff, DEC_MATS, bf16 != 0, wm,
                       moff, km) ||
      !dec_args(w, off, n_off, z, feats, B, nz, in_dim, out_dim, state_in,
                state_out, a))
    return (int)cudaErrorInvalidValue;
  if (!bf16) {
    KindSplitXArgs<DEC_NS, DEC_NW> kx;
    static_cast<KindMmaArgs<DEC_NS, DEC_NW>&>(kx) = km;
    return launch(dec_kernel<true, false, KindSplitXArgs<DEC_NS, DEC_NW>>,
                  DEC_SMEM_Q, B, stream, a, kx);
  }
  if ((km.i8 | km.bf | km.rw) == DEC_MATS)
    return launch(dec_kernel<true, true, KindMmaArgs<DEC_NS, DEC_NW>>,
                  DEC_SMEM_Q, B, stream, a,
                  static_cast<const KindMmaArgs<DEC_NS, DEC_NW>&>(km));
  return launch(dec_kernel<true, true, KindSplitArgs<DEC_NS, DEC_NW>>,
                DEC_SMEM_Q, B, stream, a, km);
}

// The chain-merged decoder on f32 weights (n_soff 0); its int8 launches
// take radae_fused_decoder_merged_x_step, which runs them on the tensor
// cores, and are refused here.
int radae_fused_decoder_merged_step(const void* w, const int* off, int n_off,
                                    const int* kinds, const int* soff,
                                    int n_soff, const void* z, void* feats,
                                    int B, int nz, int in_dim, int out_dim,
                                    void* const* state_in,
                                    void* const* state_out, void* stream) {
  DecMergedArgs a;
  QuantArgs<DECM_NS> q;
  if (n_off != DEC_NWM || B < 1 || nz < 1 || in_dim < 4 || in_dim % 4 ||
      in_dim > DEC_H || out_dim < 4 || out_dim % 4 || out_dim > DEC_MAX_OUT ||
      n_soff != 0 || !quant_args(kinds, n_off, soff, n_soff, DECM_MATS, q))
    return (int)cudaErrorInvalidValue;
  a.w = static_cast<const float*>(w);
  for (int i = 0; i < DEC_NWM; ++i) a.off[i] = off[i];
  a.z = static_cast<const float*>(z);
  a.feats = static_cast<float*>(feats);
  a.B = B; a.nz = nz; a.in_dim = in_dim; a.out_dim = out_dim;
  for (int i = 0; i < 5; ++i) {
    a.h_in[i] = static_cast<const float*>(state_in[i]);
    a.hgp_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.hpp_in[i] = static_cast<const float*>(state_in[10 + i]);
    a.h_out[i] = static_cast<float*>(state_out[i]);
    a.hgp_out[i] = static_cast<float*>(state_out[5 + i]);
    a.hpp_out[i] = static_cast<float*>(state_out[10 + i]);
  }
  return launch(dec_merged_kernel<false>, DECM_SMEM, B, stream, a, q);
}

// radae_fused_decoder_merged_step on the padded layout (pad; f32 or int8
// matrices), with int8 matrices (n_soff > 0; either layout), or with bf16
// products (bf16; either layout).  Every product runs on the tensor cores,
// on the matrices packed into wm at moff[n_off] (16-byte words: their
// merged rows in either layout), and the launch is refused without them
// (there is no FMA instance).  With bf16
// products: with every matrix of kinds 1..3 (int8, bf16 or rounded) the MM
// instance, with every one of kind 0 (f32 weights) the split instance, each
// packed as hi, mid, lo; a mix is refused.  With f32 products the
// instances on x's parts (KindSplitXArgs): on int8 weights (kinds 0 and 1)
// each int8 matrix packed once (widened to bf16), each kept in f32 as hi,
// mid, lo; on the padded layout's f32 weights (n_soff 0, every matrix kind
// 0) each as hi, mid, lo, with no scale rows.
int radae_fused_decoder_merged_x_step(const void* w, const int* off, int n_off,
                                      const int* kinds, const int* soff,
                                      int n_soff, const void* z, void* feats,
                                      int B, int nz, int in_dim, int out_dim,
                                      int pad, int bf16, const void* wm,
                                      const int* moff,
                                      void* const* state_in,
                                      void* const* state_out, void* stream) {
  DecMergedArgs a;
  KindArgs<DECM_NS> k;
  if (n_off != DEC_NWM || B < 1 || nz < 1 || in_dim < 4 || in_dim % 4 ||
      in_dim > DEC_H || out_dim < 4 || out_dim % 4 || out_dim > DEC_MAX_OUT ||
      (!pad && !bf16 && !n_soff) ||
      !kind_args(kinds, n_off, soff, n_soff, DECM_MATS, bf16, k))
    return (int)cudaErrorInvalidValue;
  a.w = static_cast<const float*>(w);
  for (int i = 0; i < DEC_NWM; ++i) a.off[i] = off[i];
  a.z = static_cast<const float*>(z);
  a.feats = static_cast<float*>(feats);
  a.B = B; a.nz = nz; a.in_dim = in_dim; a.out_dim = out_dim;
  for (int i = 0; i < 5; ++i) {
    a.h_in[i] = static_cast<const float*>(state_in[i]);
    a.hgp_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.hpp_in[i] = static_cast<const float*>(state_in[10 + i]);
    a.h_out[i] = static_cast<float*>(state_out[i]);
    a.hgp_out[i] = static_cast<float*>(state_out[5 + i]);
    a.hpp_out[i] = static_cast<float*>(state_out[10 + i]);
  }
  KindSplitArgs<DECM_NS, DEC_NWM> km;
  static_cast<KindArgs<DECM_NS>&>(km) = k;
  const unsigned long long kq = k.i8 | k.bf | k.rw;
  if ((bf16 && kq != 0 && kq != DECM_MATS) ||
      !mma_args(wm, moff, n_off, DECM_MATS, km.m))
    return (int)cudaErrorInvalidValue;
  if (!bf16) {
    KindSplitXArgs<DECM_NS, DEC_NWM> kx;
    static_cast<KindMmaArgs<DECM_NS, DEC_NWM>&>(kx) = km;
    if (!n_soff)
      return launch(dec_merged_kernel<false, false, KindSplitXArgs<DECM_NS, DEC_NWM>>,
                    DECM_SMEM, B, stream, a, kx);
    return launch(dec_merged_kernel<true, false, KindSplitXArgs<DECM_NS, DEC_NWM>>,
                  DECM_SMEM, B, stream, a, kx);
  }
  if (kq)
    return launch(dec_merged_kernel<true, true, KindMmaArgs<DECM_NS, DEC_NWM>>,
                  DECM_SMEM, B, stream, a,
                  static_cast<const KindMmaArgs<DECM_NS, DEC_NWM>&>(km));
  return launch(dec_merged_kernel<true, true, KindSplitArgs<DECM_NS, DEC_NWM>>,
                DECM_SMEM, B, stream, a, km);
}

int radae_rx_frame_limit(int ns, int nc, int samp, int latent, int nz) {
  return frame_limit(frame_geo(ns, nc, samp, latent, nz));
}

}  // extern "C"

namespace {

// The FrameArgs of a frame launch; false unless the entry takes it
bool frame_args(const void* w, const int* off, int n_off, const void* rx,
                void* feats, int B, int out_dim, float mag_k, int coarse_mag,
                const FrameGeo& g, void* const* state_in,
                void* const* state_out, FrameArgs& a) {
  if (n_off != FR_NW || B < 1 || out_dim < 4 || out_dim % 4 ||
      out_dim > DEC_TMAX_OUT || frame_limit(g))
    return false;
  const float* wf = static_cast<const float*>(w);
  a.d.w = wf;
  for (int i = 0; i < DEC_NW; ++i) a.d.off[i] = off[4 + i];
  a.d.z = nullptr;
  a.d.feats = static_cast<float*>(feats);
  a.d.B = B; a.d.nz = g.nz; a.d.in_dim = g.lat; a.d.out_dim = out_dim;
  for (int i = 0; i < 5; ++i) {
    a.d.h_in[i] = static_cast<const float*>(state_in[i]);
    a.d.hist_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.d.h_out[i] = static_cast<float*>(state_out[i]);
    a.d.hist_out[i] = static_cast<float*>(state_out[5 + i]);
  }
  a.rx = static_cast<const float*>(rx);
  a.dft_w = wf + off[4 + DEC_NW];
  a.ls_w = wf + off[4 + DEC_NW + 1];
  a.g = g;
  a.mag_k = mag_k;
  a.coarse_mag = coarse_mag;
  return true;
}

}  // namespace

extern "C" {

int radae_fused_rx_frame_step(const void* w, const int* off, int n_off,
                              const void* rx, void* feats, int B, int out_dim,
                              float mag_k, int coarse_mag, int ns, int nc,
                              int samp, int latent, int nz,
                              void* const* state_in, void* const* state_out,
                              void* stream) {
  const FrameGeo g = frame_geo(ns, nc, samp, latent, nz);
  FrameArgs a;
  if (!frame_args(w, off, n_off, rx, feats, B, out_dim, mag_k, coarse_mag, g,
                  state_in, state_out, a))
    return (int)cudaErrorInvalidValue;
  const FrameGeo f = flagship_geo();
  const bool fix = ns == f.ns && nc == f.nc && samp == f.samp &&
                   latent == f.lat && nz == f.nz;
  const size_t smem = frame_smem(g);
  cudaError_t e = cudaFuncSetAttribute(
      fix ? rx_frame_kernel<true> : rx_frame_kernel<false>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (fix)
    rx_frame_kernel<true><<<(B + R - 1) / R, NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  else
    rx_frame_kernel<false><<<(B + R - 1) / R, NT, smem,
                             static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// radae_fused_rx_frame_step with bf16 products (the geometry from the
// launch): the kinds (kind_args) of all FR_NW arrays, every decoder matrix
// bf16 (2) or f32 rounded at its products (3), no scale rows; the decoder's
// matrices and dft_w packed into wm at moff[n_off] (16-byte words)
int radae_fused_rx_frame_bf16_step(const void* w, const int* off, int n_off,
                                   const int* kinds, const int* soff,
                                   int n_soff, const void* rx, void* feats,
                                   int B, int out_dim, float mag_k,
                                   int coarse_mag, int ns, int nc, int samp,
                                   int latent, int nz, const void* wm,
                                   const int* moff, void* const* state_in,
                                   void* const* state_out, void* stream) {
  const FrameGeo g = frame_geo(ns, nc, samp, latent, nz);
  FrameMmaArgs a;
  if (!frame_args(w, off, n_off, rx, feats, B, out_dim, mag_k, coarse_mag, g,
                  state_in, state_out, a) ||
      n_soff != 0 || !kind_args(kinds + 4, DEC_NW, soff, 0, DEC_MATS, true, a.k) ||
      a.k.i8 != 0 || (a.k.bf | a.k.rw) != DEC_MATS ||
      !mma_args(wm, moff + 4, DEC_NW, DEC_MATS, a.m) || moff[FR_NW - 2] < 0)
    return (int)cudaErrorInvalidValue;
  a.dft_m = a.m.p + moff[FR_NW - 2];
  const size_t smem = frame_smem(g);
  cudaError_t e = cudaFuncSetAttribute(
      rx_frame_kernel<false, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  rx_frame_kernel<false, true><<<(B + R - 1) / R, NT, smem,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int radae_fused_encoder_step(const void* w, const int* off, int n_off,
                             const int* kinds, const int* soff, int n_soff,
                             const void* f, void* z, int B, int nz,
                             int in_dim, int out_dim, int bottleneck,
                             void* const* state_in, void* const* state_out,
                             void* stream) {
  EncArgs a;
  QuantArgs<ENC_NS> q;
  if (n_soff != 0 || !quant_args(kinds, n_off, soff, n_soff, ENC_MATS, q) ||
      !enc_args(w, off, n_off, f, z, B, nz, in_dim, out_dim, bottleneck,
                state_in, state_out, a))
    return (int)cudaErrorInvalidValue;
  return launch(enc_kernel<false>, ENC_SMEM, B, stream, a, q);
}

// radae_fused_encoder_step on the tensor cores: the MM, split or x-split
// instance as in radae_fused_decoder_mma_step
int radae_fused_encoder_mma_step(const void* w, const int* off, int n_off,
                                 const int* kinds, const int* soff, int n_soff,
                                 const void* f, void* z, int B, int nz,
                                 int in_dim, int out_dim, int bottleneck,
                                 int bf16, const void* wm, const int* moff,
                                 void* const* state_in, void* const* state_out,
                                 void* stream) {
  EncArgs a;
  KindSplitArgs<ENC_NS, ENC_NW> km;
  if (!mma_launch_args(kinds, n_off, soff, n_soff, ENC_MATS, bf16 != 0, wm,
                       moff, km) ||
      !enc_args(w, off, n_off, f, z, B, nz, in_dim, out_dim, bottleneck,
                state_in, state_out, a))
    return (int)cudaErrorInvalidValue;
  if (!bf16) {
    KindSplitXArgs<ENC_NS, ENC_NW> kx;
    static_cast<KindMmaArgs<ENC_NS, ENC_NW>&>(kx) = km;
    return launch(enc_kernel<true, false, KindSplitXArgs<ENC_NS, ENC_NW>>,
                  ENC_SMEM_Q, B, stream, a, kx);
  }
  if ((km.i8 | km.bf | km.rw) == ENC_MATS)
    return launch(enc_kernel<true, true, KindMmaArgs<ENC_NS, ENC_NW>>,
                  ENC_SMEM_Q, B, stream, a,
                  static_cast<const KindMmaArgs<ENC_NS, ENC_NW>&>(km));
  return launch(enc_kernel<true, true, KindSplitArgs<ENC_NS, ENC_NW>>,
                ENC_SMEM_Q, B, stream, a, km);
}

// The tiling, for counting the weight bytes a launch fetches: batch rows a
// block owns, and rows each weight load feeds in enc_kernel's and in the
// decoders' (dec_kernel, dec_merged_kernel, rx_frame_kernel's decoder)
// products.
int radae_block_rows(void) { return R; }
int radae_enc_tile_rows(void) { return ET; }
int radae_dec_tile_rows(void) { return ET; }

}  // extern "C"
