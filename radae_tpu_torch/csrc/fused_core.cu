// Fused RADAE core codec steps for Hopper (sm_90a): the whole recurrent
// encoder or decoder stack, for nz latent steps, in one launch; and the whole
// rx frame (OFDM demod, LS pilot EQ, coarse magnitude, demap, decoder) in one.
//
// Replaces the Pallas TPU kernels in radae_tpu/ops/fused_core.py:
//   radae_fused_decoder_step         <- make_fused_decoder_step, body `kernel`
//                                       (unmerged f32 form)
//   radae_fused_decoder_merged_step  <- make_fused_decoder_step, body
//                                       `kernel_merged` (merged=True, f32)
//   radae_fused_rx_frame_step        <- make_fused_rx_frame_step (f32, the
//                                       samples read straight from HBM)
//   radae_fused_encoder_step         <- make_fused_encoder_step (f32 form)
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
//     history) is read from device memory at the first step and written at
//     the end, in the unmerged layout of the plain version;
//   * every product is x (shared) @ W (L2, pre-transposed (in, out)): in the
//     decoder kernels a thread owns a 4-row x 4-column tile (2 rows in the
//     GRU), reads W as float4 along `out` (coalesced), x as float4 along
//     `in` (shared broadcast), and narrow products split `in` into KS chunks
//     whose partial sums are added in a fixed order, so every launch gives
//     the same bits;
//   * f32 accumulation with expf/tanhf (no fast math).
//
// The encoder kernel tiles its products over all of the block's rows.  With
// 2- and 4-row tiles each block fetched its weights 5.8 times a z-step
// (21.8 MB instead of 3.7 MB).  Here a thread owns a
// 16-row x 4-column tile (64 accumulators), so each weight float4 it loads
// feeds 64 multiply-adds and each weight is fetched once per block; the
// parallelism comes from K instead: a warp is 4 column quads x 8 K lanes
// (K interleaved by float4, so 8 lanes read 128 contiguous bytes of an x
// row), summed by a fixed shuffle butterfly, and products too narrow for
// 12 warps split K across warps (partials added in chunk order).  The next
// K step's weights are loaded, without a branch, before this step's
// multiply-adds.  Every operand of a product is in shared memory: the
// carried state and the features are staged into the x ring in passes that
// already sit between two barriers.  What is left, timed on an H100 by
// tools/enc_variants.py with one cost taken out at a time: the 24
// barrier-separated phases of a z-step (0.125 ms of the 0.43 ms launch
// with no product loop in them), then the loops' issue rate; the x loads
// (0.035 ms) and the weight stream from the L2 (0.009 ms) matter little.
//
// The chain-merged decoder has the same products in fewer, wider operands:
// h @ [whh | glu] (96 x 384) and x @ [tap1 | tap0] (in x 64).  Its state
// carries the projections (hh row 288, conv tap 32) instead of the raw
// conv history, so a block keeps one x buffer, not a ring, and updates h,
// the hh projection and the tap projection in place in shared memory
// (217,088 B: x 47 KB, h 30 KB, hh projections 92 KB, taps 10 KB, scratch
// 36 KB); each is read before it is overwritten within a layer.
//
// The frame kernel runs a demod prologue and then the unmerged decoder body
// (dec_body, shared with dec_kernel).  The prologue reads the block's 16
// streams x 6 symbol rows of interleaved IQ straight from HBM as one
// (96, 384) operand, multiplies by the real (384, 60) DFT block matrix
// (CP strip folded in as zero rows) to [Yr | Yi], takes the two pilot rows
// through the (60, 60) LS block matrix, reduces the coarse magnitude over
// the 30 carriers in a fixed order (one thread a stream), and writes the
// equalised, scaled data symbols as [re | im] latents (16 x 3 x 80) into
// shared memory, where the decoder body reads them as its z.  Y and the
// pilot estimates live in the decoder's gate scratch, idle until the first
// z-step; the bound is the decoder's plus about 4% for the demod.
//
// Built by radae_tpu_torch/ops/_kernels.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
// and bound with ctypes: plain C entries, pointers and the stream passed as
// void*, the launch status returned as cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int R = 16;     // batch rows per block
constexpr int NT = 384;   // threads per block

// decoder widths (radae_tpu/models/core.py:41-43)
constexpr int DEC_H = 96, DEC_G = 3 * DEC_H, DEC_CO = 32, DEC_X = 736;
constexpr int DEC_NW = 2 + 5 * 8 + 2;
constexpr int DEC_NWM = 2 + 5 * 6 + 2;         // chain-merged layout
constexpr int DEC_GG = DEC_G + DEC_H;          // [whh | glu] columns
// encoder widths (radae_tpu/models/core.py:37-39)
constexpr int ENC_H = 64, ENC_G = 3 * ENC_H, ENC_CO = 96, ENC_X = 864;
constexpr int ENC_NW = 2 + 5 * 7 + 2;

// shared memory: x ring + (decoder) h ring + scratch for gates / partials
constexpr int DEC_SCR = 2 * R * DEC_G;   // >= every partial buffer below
constexpr size_t DEC_SMEM =
    sizeof(float) * (2 * R * DEC_X + 2 * 5 * R * DEC_H + DEC_SCR);
// widest output of the last product (its 4 partial buffers fit the scratch)
constexpr int DEC_MAX_OUT = DEC_SCR / (4 * R);   // 144 >= 4 * 21

// encoder products (enc_kernel): a thread's tile is ET rows x 4 columns
constexpr int ET = 16;
constexpr int ENC_NG = R / ET;                 // row groups a block
constexpr int NWARP = NT / 32;
static_assert(ET % 8 == 0 && R % ET == 0, "a lane keeps ET/8 rows after the K sum");
constexpr int ENC_GS = ENC_G + ENC_H;          // gate sums: r|z, x@n, h@n
constexpr int ENC_SCR = R * ENC_GS;
constexpr int ENC_D1_KS = 3, ENC_Z_KS = 2;     // K chunks of dense_1, z_dense
constexpr int ENC_MAX_OUT = 96;                // >= latent 80
constexpr int ENC_FOFF = ENC_X - ENC_CO;       // features staged at x[768..]
constexpr size_t ENC_SMEM = sizeof(float) * (3 * R * ENC_X + ENC_SCR);
static_assert(ENC_D1_KS * R * ENC_H <= ENC_SCR && 2 * R * ENC_CO <= ENC_SCR &&
                  ENC_Z_KS * R * ENC_MAX_OUT <= ENC_SCR,
              "every partial buffer fits the gate scratch");
static_assert(ENC_SMEM <= 232448, "opt-in shared memory of one block");
static_assert(R * ENC_H / 4 <= NT && R * ENC_CO / 4 <= NT &&
                  R * ENC_MAX_OUT / 4 <= NT,
              "each finish pass is one float4 a thread");

// merged: one x buffer, then per layer h, hh projection, tap projection
constexpr int DECM_CONV_KS = 6;                  // K chunks of x @ [tap1|tap0]
constexpr size_t DECM_SMEM =
    sizeof(float) * (R * DEC_X + 5 * R * (DEC_H + DEC_G + DEC_CO) + DEC_SCR);
static_assert(DECM_CONV_KS * R * 2 * DEC_CO + R * 2 * DEC_CO <= DEC_SCR,
              "conv partials + staging fit the scratch");
static_assert(DECM_SMEM <= 232448, "opt-in shared memory of one block");

// frame kernel geometry (flagship modem: Ns=4 data rows between two pilot
// rows, Nc=30 carriers, M+Ncp=192 samples a symbol, 3 z-steps of latent 80)
constexpr int FR_NS = 4, FR_NSYM = FR_NS + 2, FR_NC = 30, FR_SAMP = 192;
constexpr int FR_ROW = 2 * FR_SAMP;            // floats of one symbol row
constexpr int FR_Y = 2 * FR_NC;                // [Yr | Yi]
constexpr int FR_NZ = 3, FR_LAT = 80, FR_PZ = FR_LAT / 2;
constexpr int FR_NW = 4 + DEC_NW + 2;          // Wr Wi Er Ei, decoder, dft_w ls_w
constexpr size_t FR_SMEM = DEC_SMEM + sizeof(float) * R * FR_NZ * FR_LAT;
static_assert(FR_NS * FR_NC == FR_NZ * FR_PZ, "data symbols fill the z-steps");
static_assert(R * FR_NSYM * FR_Y + 2 * R * FR_Y + R <= DEC_SCR,
              "demod intermediates fit the decoder's scratch");
static_assert(FR_SMEM <= 232448, "opt-in shared memory of one block");

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
  const float* rx;    // (B, FR_NSYM * FR_SAMP, 2) interleaved IQ
  const float* dft_w; // (FR_ROW, FR_Y)
  const float* ls_w;  // (FR_Y, FR_Y)
  float mag_k;
  int coarse_mag;
};

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

// acc[i] += sum_{k0 <= k < k1} X[r0 + i][k] * W[k][c .. c+3]
template <int RPT>
__device__ __forceinline__ void mac(float4 (&acc)[RPT], const Src& s, int r0,
                                    const float* __restrict__ W, int out,
                                    int c, int k0, int k1) {
  const float* xr[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) xr[i] = s.p + (size_t)min(r0 + i, s.rmax) * s.ld;
  const float* wp = W + (size_t)k0 * out + c;
  for (int k = k0; k < k1; k += 4, wp += 4 * out) {
    const float4 w0 = ldg4(wp), w1 = ldg4(wp + out);
    const float4 w2 = ldg4(wp + 2 * out), w3 = ldg4(wp + 3 * out);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float4 x = ld4(xr[i] + k);
      fma4(acc[i], x.x, w0);
      fma4(acc[i], x.y, w1);
      fma4(acc[i], x.z, w2);
      fma4(acc[i], x.w, w3);
    }
  }
}

// Y = A @ Wa (+ Bm @ Wb when wb != nullptr) over ROWS rows; A and Bm have K
// columns, Y has `out` columns; epi(r, c, Y[r][c..c+3]) consumes the result.
// Work items: KS chunks of the (virtually concatenated) K axis x ROWS/RPT row
// groups x out/4 column quads.  With KS > 1 the partial sums go to `part`
// (KS*ROWS*out floats) and are added in chunk order.  All threads must call
// it; the caller syncs before the result is read.
template <int RPT, int KS, int ROWS = R, class Epi>
__device__ __forceinline__ void dot(const Src& a, const float* __restrict__ wa,
                                    const Src& bm, const float* __restrict__ wb,
                                    int K, int out, float* part, Epi epi) {
  const int nq = out >> 2, ng = ROWS / RPT;
  const int ktot = wb ? 2 * K : K;
  const int kc = ((ktot + KS - 1) / KS + 3) & ~3;
  const int n = KS * ng * nq;
  for (int it = threadIdx.x; it < n; it += NT) {
    const int cq = it % nq, g = (it / nq) % ng, ks = it / (nq * ng);
    const int c = cq * 4, r0 = g * RPT;
    const int kb = ks * kc, ke = min(ktot, kb + kc);
    float4 acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (kb < K) mac<RPT>(acc, a, r0, wa, out, c, kb, min(ke, K));
    if (wb && ke > K) mac<RPT>(acc, bm, r0, wb, out, c, max(kb, K) - K, ke - K);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (KS == 1)
        epi(r0 + i, c, acc[i]);
      else
        st4(part + ((size_t)ks * ROWS + r0 + i) * out + c, acc[i]);
    }
  }
  if (KS > 1) {
    __syncthreads();
    for (int it = threadIdx.x; it < ROWS * nq; it += NT) {
      const int r = it / nq, c = (it % nq) * 4;
      float4 s = ld4(part + (size_t)r * out + c);
#pragma unroll
      for (int ks = 1; ks < KS; ++ks)
        s = add4(s, ld4(part + ((size_t)ks * ROWS + r) * out + c));
      epi(r, c, s);
    }
  }
}

// One GRU step over R rows (gate blocks r, z, n): xg = x @ wih + bih and
// hg = h @ whh + bhh into shared scratch, then the gate math; dst(r, j, h')
// stores the new state.  hold must not alias what dst writes.
template <class Dst>
__device__ __forceinline__ void gru(const Src& x, int K, const Src& hold,
                                    const float* __restrict__ wih,
                                    const float* __restrict__ whh,
                                    const float* __restrict__ bih,
                                    const float* __restrict__ bhh, int H,
                                    float* xg, float* hg, Dst dst) {
  const int G = 3 * H, nq = G / 4, n1 = (R / 2) * nq;
  for (int it = threadIdx.x; it < 2 * n1; it += NT) {
    const bool hh = it >= n1;          // uniform per warp: n1 % 32 == 0
    const int j = hh ? it - n1 : it;
    const int c = (j % nq) * 4, r0 = (j / nq) * 2;
    float4 acc[2] = {make_float4(0.f, 0.f, 0.f, 0.f),
                     make_float4(0.f, 0.f, 0.f, 0.f)};
    if (hh)
      mac<2>(acc, hold, r0, whh, G, c, 0, H);
    else
      mac<2>(acc, x, r0, wih, G, c, 0, K);
    const float4 b = ldg4((hh ? bhh : bih) + c);
    float* o = hh ? hg : xg;
    st4(o + (size_t)r0 * G + c, add4(acc[0], b));
    st4(o + (size_t)(r0 + 1) * G + c, add4(acc[1], b));
  }
  __syncthreads();
  for (int it = threadIdx.x; it < R * H; it += NT) {
    const int r = it / H, j = it % H;
    const float* a = xg + (size_t)r * G;
    const float* b = hg + (size_t)r * G;
    const float rr = sigm(a[j] + b[j]);
    const float zz = sigm(a[H + j] + b[H + j]);
    const float nn = tanhf(a[2 * H + j] + rr * b[2 * H + j]);
    const float hp = hold.p[(size_t)min(r, hold.rmax) * hold.ld + j];
    dst(r, j, (1.f - zz) * nn + zz * hp);
  }
}

// The unmerged decoder stack over a.nz z-steps for the block's R rows
// (dec_kernel's and rx_frame_kernel's body).  Step k reads its latents from
// the rows of z0 shifted by k * zstep floats; smem holds DEC_SMEM bytes.
__device__ __forceinline__ void dec_body(const DecArgs& a, float* smem,
                                         const Src& z0, int zstep) {
  float* const xb = smem;                               // [2][R][DEC_X]
  float* const hb = xb + 2 * R * DEC_X;                 // [2][5][R][DEC_H]
  float* const scr = hb + 2 * 5 * R * DEC_H;            // gates / partials
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.B - b0);
  const int rmax = nv - 1;
  const float* const w = a.w;
  const int* const off = a.off;

  for (int k = 0; k < a.nz; ++k) {
    const int cur = k & 1, prv = cur ^ 1;
    float* const X = xb + cur * R * DEC_X;
    const float* const Xp = xb + prv * R * DEC_X;
    const Src xs{X, DEC_X, R - 1};

    // dense_1: X[:, :96] = tanh(z_k @ d1_w + d1_b)
    const Src zs{z0.p + (size_t)k * zstep, z0.ld, z0.rmax};
    const float* d1b = w + off[1];
    dot<4, 4>(zs, w + off[0], zs, nullptr, a.in_dim, DEC_H, scr,
              [&](int r, int c, float4 v) {
                st4(X + r * DEC_X + c, tanh4(add4(v, ldg4(d1b + c))));
              });
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = DEC_H + 128 * i, cin = gin + DEC_H;
      const int* o = off + 2 + 8 * i;   // wih whh bih bhh glu cw0 cw1 cb
      float* const hc = hb + (cur * 5 + i) * R * DEC_H;
      const Src hold = k == 0 ? Src{a.h_in[i] + (size_t)b0 * DEC_H, DEC_H, rmax}
                              : Src{hb + (prv * 5 + i) * R * DEC_H, DEC_H, R - 1};
      gru(xs, gin, hold, w + o[0], w + o[1], w + o[2], w + o[3], DEC_H, scr,
          scr + R * DEC_G, [&](int r, int j, float v) { hc[r * DEC_H + j] = v; });
      __syncthreads();

      // GLU: X[:, gin:cin] = h * sigmoid(h @ glu_w)
      const Src hs{hc, DEC_H, R - 1};
      dot<4, 4>(hs, w + o[4], hs, nullptr, DEC_H, DEC_H, scr,
                [&](int r, int c, float4 v) {
                  const float4 h = ld4(hc + r * DEC_H + c);
                  st4(X + r * DEC_X + gin + c,
                      make_float4(h.x * sigm(v.x), h.y * sigm(v.y),
                                  h.z * sigm(v.z), h.w * sigm(v.w)));
                });
      __syncthreads();

      // conv k2: X[:, cin:cin+32] = tanh(hist @ cw0 + X[:, :cin] @ cw1 + cb);
      // the history is the previous step's prefix (the state at k == 0)
      const Src hist = k == 0 ? Src{a.hist_in[i] + (size_t)b0 * cin, cin, rmax}
                              : Src{Xp, DEC_X, R - 1};
      const float* cb = w + o[7];
      dot<4, 12>(hist, w + o[5], xs, w + o[6], cin, DEC_CO, scr,
                 [&](int r, int c, float4 v) {
                   st4(X + r * DEC_X + cin + c, tanh4(add4(v, ldg4(cb + c))));
                 });
      __syncthreads();
    }

    // output: feats[:, k] = X @ out_w + out_b
    const float* ob = w + off[DEC_NW - 1];
    float* const fo = a.feats + ((size_t)b0 * a.nz + k) * a.out_dim;
    dot<4, 4>(xs, w + off[DEC_NW - 2], xs, nullptr, DEC_X, a.out_dim, scr,
              [&](int r, int c, float4 v) {
                if (r < nv) st4(fo + (size_t)r * a.nz * a.out_dim + c, add4(v, ldg4(ob + c)));
              });
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

__global__ void __launch_bounds__(NT) dec_kernel(const DecArgs a) {
  extern __shared__ float4 smem4[];
  const int b0 = blockIdx.x * R;
  const Src z0{a.z + (size_t)b0 * a.nz * a.in_dim, a.nz * a.in_dim,
               min(R, a.B - b0) - 1};
  dec_body(a, reinterpret_cast<float*>(smem4), z0, a.in_dim);
}

__global__ void __launch_bounds__(NT) dec_merged_kernel(const DecMergedArgs a) {
  extern __shared__ float4 smem4[];
  float* const X = reinterpret_cast<float*>(smem4);     // [R][DEC_X]
  float* const hs = X + R * DEC_X;                      // [5][R][DEC_H]
  float* const gp = hs + 5 * R * DEC_H;                 // [5][R][DEC_G]
  float* const pp = gp + 5 * R * DEC_G;                 // [5][R][DEC_CO]
  float* const scr = pp + 5 * R * DEC_CO;               // gates / partials
  float* const cc = scr + DECM_CONV_KS * R * 2 * DEC_CO;  // [R][2*DEC_CO]
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.B - b0);
  const int rmax = nv - 1;
  const float* const w = a.w;
  const int* const off = a.off;
  const Src xs{X, DEC_X, R - 1};

  // carried state -> shared memory (rows past B repeat the last one)
  for (int i = 0; i < 5; ++i) {
    for (int it = threadIdx.x; it < R * DEC_H; it += NT)
      hs[i * R * DEC_H + it] =
          a.h_in[i][((size_t)b0 + min(it / DEC_H, rmax)) * DEC_H + it % DEC_H];
    for (int it = threadIdx.x; it < R * DEC_G; it += NT)
      gp[i * R * DEC_G + it] =
          a.hgp_in[i][((size_t)b0 + min(it / DEC_G, rmax)) * DEC_G + it % DEC_G];
    for (int it = threadIdx.x; it < R * DEC_CO; it += NT)
      pp[i * R * DEC_CO + it] =
          a.hpp_in[i][((size_t)b0 + min(it / DEC_CO, rmax)) * DEC_CO + it % DEC_CO];
  }
  __syncthreads();

  for (int k = 0; k < a.nz; ++k) {
    // dense_1: X[:, :96] = tanh(z_k @ d1_w + d1_b)
    const Src zs{a.z + ((size_t)b0 * a.nz + k) * a.in_dim, a.nz * a.in_dim, rmax};
    const float* d1b = w + off[1];
    dot<4, 4>(zs, w + off[0], zs, nullptr, a.in_dim, DEC_H, scr,
              [&](int r, int c, float4 v) {
                st4(X + r * DEC_X + c, tanh4(add4(v, ldg4(d1b + c))));
              });
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = DEC_H + 128 * i, cin = gin + DEC_H;
      const int* o = off + 2 + 6 * i;   // wih wgg bih bhh cw cb
      float* const h = hs + i * R * DEC_H;
      float* const hg = gp + i * R * DEC_G;
      float* const hp = pp + i * R * DEC_CO;

      // xg = X[:, :gin] @ wih + bih, summed in place over partial 0
      const float* bih = w + o[2];
      dot<2, 2>(xs, w + o[0], xs, nullptr, gin, DEC_G, scr,
                [&](int r, int c, float4 v) {
                  st4(scr + r * DEC_G + c, add4(v, ldg4(bih + c)));
                });
      __syncthreads();

      // GRU gates from xg and the carried hh projection + bhh; h in place
      const float* bhh = w + o[3];
      for (int it = threadIdx.x; it < R * DEC_H; it += NT) {
        const int r = it / DEC_H, j = it % DEC_H;
        const float* xg = scr + r * DEC_G;
        const float* g = hg + r * DEC_G;
        const float rr = sigm(xg[j] + (g[j] + __ldg(bhh + j)));
        const float zz = sigm(xg[DEC_H + j] + (g[DEC_H + j] + __ldg(bhh + DEC_H + j)));
        const float nn = tanhf(xg[2 * DEC_H + j] +
                               rr * (g[2 * DEC_H + j] + __ldg(bhh + 2 * DEC_H + j)));
        float* const hr = h + r * DEC_H + j;
        *hr = (1.f - zz) * nn + zz * *hr;
      }
      __syncthreads();

      // h @ [whh | glu]: the next step's hh projection, and the GLU output
      // X[:, gin:cin] = h * sigmoid(h @ glu)
      const Src hsrc{h, DEC_H, R - 1};
      dot<4, 1>(hsrc, w + o[1], hsrc, nullptr, DEC_H, DEC_GG, nullptr,
                [&](int r, int c, float4 v) {
                  if (c < DEC_G) {
                    st4(hg + r * DEC_G + c, v);
                  } else {
                    const float4 hv = ld4(h + r * DEC_H + c - DEC_G);
                    st4(X + r * DEC_X + gin + c - DEC_G,
                        make_float4(hv.x * sigm(v.x), hv.y * sigm(v.y),
                                    hv.z * sigm(v.z), hv.w * sigm(v.w)));
                  }
                });
      __syncthreads();

      // X[:, :cin] @ [tap1 | tap0] -> staging cc, then
      // X[:, cin:cin+32] = tanh(tap-0 projection + tap 1 + cb); the tap-0
      // half of cc is the next step's projection
      dot<4, DECM_CONV_KS>(xs, w + o[4], xs, nullptr, cin, 2 * DEC_CO, scr,
                           [&](int r, int c, float4 v) {
                             st4(cc + r * 2 * DEC_CO + c, v);
                           });
      __syncthreads();
      const float* cb = w + o[5];
      for (int it = threadIdx.x; it < R * (DEC_CO / 4); it += NT) {
        const int r = it / (DEC_CO / 4), c = (it % (DEC_CO / 4)) * 4;
        float* const p = hp + r * DEC_CO + c;
        const float* t = cc + r * 2 * DEC_CO;
        st4(X + r * DEC_X + cin + c,
            tanh4(add4(add4(ld4(p), ld4(t + c)), ldg4(cb + c))));
        st4(p, ld4(t + DEC_CO + c));
      }
      __syncthreads();
    }

    // output: feats[:, k] = X @ out_w + out_b
    const float* ob = w + off[DEC_NWM - 1];
    float* const fo = a.feats + ((size_t)b0 * a.nz + k) * a.out_dim;
    dot<4, 4>(xs, w + off[DEC_NWM - 2], xs, nullptr, DEC_X, a.out_dim, scr,
              [&](int r, int c, float4 v) {
                if (r < nv) st4(fo + (size_t)r * a.nz * a.out_dim + c, add4(v, ldg4(ob + c)));
              });
    __syncthreads();
  }

  for (int i = 0; i < 5; ++i) {
    for (int it = threadIdx.x; it < nv * DEC_H; it += NT)
      a.h_out[i][(size_t)b0 * DEC_H + it] = hs[i * R * DEC_H + it];
    for (int it = threadIdx.x; it < nv * DEC_G; it += NT)
      a.hgp_out[i][(size_t)b0 * DEC_G + it] = gp[i * R * DEC_G + it];
    for (int it = threadIdx.x; it < nv * DEC_CO; it += NT)
      a.hpp_out[i][(size_t)b0 * DEC_CO + it] = pp[i * R * DEC_CO + it];
  }
}

__global__ void __launch_bounds__(NT) rx_frame_kernel(const FrameArgs a) {
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  // the decoder's gate scratch holds the demod intermediates until z is made
  float* const Y = smem + 2 * R * DEC_X + 2 * 5 * R * DEC_H;  // [R][NSYM][Y]
  float* const hp0 = Y + R * FR_NSYM * FR_Y;                  // [R][Y]
  float* const hp1 = hp0 + R * FR_Y;                          // [R][Y]
  float* const inv_mag = hp1 + R * FR_Y;                      // [R]
  float* const zsh = smem + DEC_SMEM / sizeof(float);         // [R][NZ*LAT]
  const int b0 = blockIdx.x * R;
  const int nv = min(R, a.d.B - b0);

  // strip_cp + DFT of every symbol row: (R*NSYM, 384) @ dft_w -> [Yr | Yi]
  const Src rows{a.rx + (size_t)b0 * FR_NSYM * FR_ROW, FR_ROW, nv * FR_NSYM - 1};
  dot<4, 1, R * FR_NSYM>(rows, a.dft_w, rows, nullptr, FR_ROW, FR_Y, nullptr,
                         [&](int r, int c, float4 v) { st4(Y + r * FR_Y + c, v); });
  __syncthreads();

  // LS channel estimates of the two pilot rows: [Yr | Yi] @ ls_w
  const Src p0{Y, FR_NSYM * FR_Y, R - 1};
  const Src p1{Y + (FR_NSYM - 1) * FR_Y, FR_NSYM * FR_Y, R - 1};
  dot<1, 1>(p0, a.ls_w, p0, nullptr, FR_Y, FR_Y, nullptr,
            [&](int r, int c, float4 v) { st4(hp0 + r * FR_Y + c, v); });
  dot<1, 1>(p1, a.ls_w, p1, nullptr, FR_Y, FR_Y, nullptr,
            [&](int r, int c, float4 v) { st4(hp1 + r * FR_Y + c, v); });
  __syncthreads();

  // coarse magnitude: the mean over the carriers, summed in carrier order
  if (threadIdx.x < R) {
    const int r = threadIdx.x;
    float im = 1.f;
    if (a.coarse_mag) {
      const float* q0 = hp0 + r * FR_Y;
      const float* q1 = hp1 + r * FR_Y;
      float s = 0.f;
      for (int c = 0; c < FR_NC; ++c)
        s += q0[c] * q0[c] + q0[FR_NC + c] * q0[FR_NC + c] +
             q1[c] * q1[c] + q1[FR_NC + c] * q1[FR_NC + c];
      im = 1.f / ((sqrtf(0.5f * (s / FR_NC)) + 1e-6f) * a.mag_k);
    }
    inv_mag[r] = im;
  }
  __syncthreads();

  // linear pilot interpolation + phase EQ + magnitude, demapped into the
  // z-steps' [re(40) | im(40)] latents (data symbol m = (s-1)*Nc + c)
  for (int it = threadIdx.x; it < R * FR_NS * FR_NC; it += NT) {
    const int r = it / (FR_NS * FR_NC), m = it % (FR_NS * FR_NC);
    const int s = m / FR_NC + 1, c = m % FR_NC;
    const float t = (float)s / (FR_NS + 1), u = 1.f - t;
    const float* q0 = hp0 + r * FR_Y;
    const float* q1 = hp1 + r * FR_Y;
    const float hr = q0[c] * u + q1[c] * t;
    const float hi = q0[FR_NC + c] * u + q1[FR_NC + c] * t;
    const float scale = rsqrtf(hr * hr + hi * hi + 1e-12f) * inv_mag[r];
    const float* y = Y + (r * FR_NSYM + s) * FR_Y;
    const float yr = y[c], yi = y[FR_NC + c];
    float* const zk = zsh + r * FR_NZ * FR_LAT + (m / FR_PZ) * FR_LAT + m % FR_PZ;
    zk[0] = (yr * hr + yi * hi) * scale;
    zk[FR_PZ] = (yi * hr - yr * hi) * scale;
  }
  __syncthreads();

  dec_body(a.d, smem, Src{zsh, FR_NZ * FR_LAT, R - 1}, FR_LAT);
}

// ---------------------------------------------------------------------------
// Encoder products, register-tiled over the block's rows (enc_kernel only).
//
// A work item is one warp's share of Y = X @ W: a group of 16 columns (quad
// q = lane & 3 owns columns 4q..4q+3) for ET rows over a K range.  K lane
// kl = lane >> 2 takes k = k0 + 4*kl + 32*j, so the 8 K lanes read 128
// contiguous bytes of an x row, and every weight float4 a lane loads feeds
// ET rows (4*ET multiply-adds).  The 4 quads of a K lane are neighbouring
// lanes, so a quarter-warp asks for 2 distinct float4 of x (which its 4
// quads share by broadcast) and 2 weight rows, not 8 of each as with the
// quads 8 lanes apart: the kernel ran 1.58 times faster so on an H100.
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
// X in shared memory with row stride ENC_X (every operand of the encoder's
// products is there: the carried state is staged in the x ring first).
// k0 and k1 are multiples of 4.  The next K step's weights are loaded into
// registers before this step's multiply-adds.
__device__ __forceinline__ void tmac(float4 (&acc)[ET], const float* X, int r0,
                                     const float* __restrict__ W, int out,
                                     int c, int k0, int k1, int kl) {
  const float* const xr = X + r0 * ENC_X;
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
      const float4 x = ld4(xr + i * ENC_X + kx);
      fma4(acc[i], x.x, wt[0]);
      fma4(acc[i], x.y, wt[1]);
      fma4(acc[i], x.z, wt[2]);
      fma4(acc[i], x.w, wt[3]);
    }
  }
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

// The end of a work item: the 8 K lanes' tiles are summed (bit lv of kl
// picks the half kept at level lv), then lane kl stores its ET/8 rows plus
// `bias` at dst + row * ld when `put`.  Every lane of the warp takes part.
__device__ __forceinline__ void kput(float4 (&acc)[ET], int kl, int r0,
                                     float* dst, int ld, float4 bias,
                                     bool put) {
  kfold<ET / 2>(acc, kl & 1, 4);          // K lane kl is lanes 4kl..4kl+3
  kfold<ET / 4>(acc, (kl >> 1) & 1, 8);
  kfold<ET / 8>(acc, (kl >> 2) & 1, 16);
  const int rk = r0 + (ET / 2) * (kl & 1) + (ET / 4) * ((kl >> 1) & 1) +
                 (ET / 8) * ((kl >> 2) & 1);
  if (put) {
#pragma unroll
    for (int i = 0; i < ET / 8; ++i) st4(dst + (rk + i) * ld, add4(acc[i], bias));
  }
}

__device__ __forceinline__ void zero(float4 (&acc)[ET]) {
#pragma unroll
  for (int i = 0; i < ET; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// dst[r][0..cols) = src row min(r, rmax) (row stride ld) for the R rows of a
// block: device memory into the x ring (rows ENC_X apart); cols % 4 == 0
__device__ __forceinline__ void stage(float* dst, const float* src, int ld,
                                      int cols, int rmax) {
  const int nq = cols / 4;
  for (int it = threadIdx.x; it < R * nq; it += NT) {
    const int r = it / nq, c = it % nq * 4;
    st4(dst + r * ENC_X + c, ld4(src + (size_t)min(r, rmax) * ld + c));
  }
}

// The encoder stack over a.nz z-steps for the block's R rows.  x[t] of
// step t lives in ring slot t % 3; the carried state is staged into the
// slots of x[-1] and x[-2] (h at its GRU window, each conv's history tap
// as the prefix), and the features of step k at columns ENC_FOFF.. of its
// own slot, each in a pass that already sits between two barriers.
__global__ void __launch_bounds__(NT) enc_kernel(const EncArgs a) {
  extern __shared__ float4 smem4[];
  float* const xb = reinterpret_cast<float*>(smem4);   // [3][R][ENC_X]
  float* const scr = xb + 3 * R * ENC_X;                // gates / partials
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
  stage(xb + ENC_FOFF, f0, fld, a.in_dim, rmax);
  __syncthreads();
  for (int k = 0; k < a.nz; ++k) {
    float* const X = xb + (k % 3) * R * ENC_X;
    float* const Xp = xb + ((k + 2) % 3) * R * ENC_X;   // x[k-1]

    // dense_1: X[:, :64] = tanh(f_k @ d1_w + d1_b), K in ENC_D1_KS chunks
    const int kd = ((a.in_dim + ENC_D1_KS - 1) / ENC_D1_KS + 31) & ~31;
    for (int u = warp; u < ENC_NG * 4 * ENC_D1_KS; u += NWARP) {
      const int r0 = u / (4 * ENC_D1_KS) * ET, ch = u / 4 % ENC_D1_KS;
      const int c = u % 4 * 16 + cq;
      const int kb = ch * kd, ke = min(a.in_dim, kb + kd);
      float4 acc[ET];
      zero(acc);
      if (kb < ke)
        tmac(acc, X + ENC_FOFF, r0, w + off[0], ENC_H, c, kb, ke, kl);
      kput(acc, kl, r0, scr + ch * R * ENC_H + c, ENC_H, zero4, true);
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
    if (k == 0) stage(Xp + ENC_H, a.h_in[0] + (size_t)b0 * ENC_H, ENC_H, ENC_H, rmax);
    __syncthreads();

    for (int i = 0; i < 5; ++i) {
      const int gin = ENC_H + 160 * i, cin = gin + ENC_H;
      const int d = i == 0 ? 1 : 2;     // conv dilations 1,2,2,2,2
      const int* o = off + 2 + 7 * i;   // wih whh bih bhh cw0 cw1 cb
      const float *wih = w + o[0], *whh = w + o[1];
      const float *bih = w + o[2], *bhh = w + o[3];
      float* const Xd = xb + ((k + 3 - d) % 3) * R * ENC_X;  // x[k-d]
      const float4 cbv = ldg4(w + o[6] + t % (ENC_CO / 4) * 4);

      // GRU gate sums into scr [R][ENC_GS]: columns 0..127 x@wih + h@whh
      // + bih + bhh of the r and z gates; 128..191 x@wih + bih of the n
      // gate; 192..255 h@whh + bhh of the n gate.  A unit is one 16-column
      // group: an r|z item over both products, or the two n items.  The
      // previous h is x[k-1]'s GRU window.
      for (int u = warp; u < ENC_NG * 12; u += NWARP) {
        const int r0 = u / 12 * ET, qg = u % 12, c = qg * 16 + cq;
        const float4 bi = ldg4(bih + c), bh = ldg4(bhh + c);
        float4 acc[ET];
        zero(acc);
        tmac(acc, X, r0, wih, ENC_G, c, 0, gin, kl);
        if (qg < 8) {
          tmac(acc, Xp + gin, r0, whh, ENC_G, c, 0, ENC_H, kl);
          kput(acc, kl, r0, scr + c, ENC_GS, add4(bi, bh), true);
        } else {
          kput(acc, kl, r0, scr + c, ENC_GS, bi, true);
          zero(acc);
          tmac(acc, Xp + gin, r0, whh, ENC_G, c, 0, ENC_H, kl);
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
        const float rr = sigm(s[j]);
        const float zz = sigm(s[ENC_H + j]);
        const float nn = tanhf(s[2 * ENC_H + j] + rr * s[3 * ENC_H + j]);
        const float h = hp[(size_t)min(r, hmax) * hld + j];
        X[r * ENC_X + gin + j] = (1.f - zz) * nn + zz * h;
      }
      if (k < d)   // conv history tap k of the state = x[k-d]
        stage(Xd, a.hist_in[i] + ((size_t)b0 * d + k) * cin, d * cin, cin, rmax);
      __syncthreads();

      // conv k2, dilation d: X[:, cin:cin+96] =
      //   tanh(x[k-d][:, :cin] @ cw0 + X[:, :cin] @ cw1 + cb);
      // a unit is one 16-column group of one tap, partials [tap][R][96]
      for (int u = warp; u < ENC_NG * 12; u += NWARP) {
        const int r0 = u / 12 * ET, tap = u % 12 / 6;
        const int c = u % 6 * 16 + cq;
        float4 acc[ET];
        zero(acc);
        tmac(acc, tap ? X : Xd, r0, w + o[4 + tap], ENC_CO, c, 0, cin, kl);
        kput(acc, kl, r0, scr + tap * R * ENC_CO + c, ENC_CO, zero4, true);
      }
      __syncthreads();
      if (t < R * ENC_CO / 4) {
        const int r = t / (ENC_CO / 4), c = t % (ENC_CO / 4) * 4;
        const float4 v = add4(ld4(scr + r * ENC_CO + c),
                              ld4(scr + (R + r) * ENC_CO + c));
        st4(X + r * ENC_X + cin + c, tanh4(add4(v, cbv)));
      }
      if (k == 0 && i < 4)   // the next layer's h state at its GRU window
        stage(Xp + gin + 160, a.h_in[i + 1] + (size_t)b0 * ENC_H, ENC_H, ENC_H,
              rmax);
      __syncthreads();
    }

    // z_dense: z[:, k] = X @ out_w + out_b (tanh for bottleneck 1), K in
    // ENC_Z_KS chunks, partials [chunk][R][out_dim]
    const int nqg = (od + 15) / 16;
    const int kz = ((ENC_X + ENC_Z_KS - 1) / ENC_Z_KS + 31) & ~31;
    for (int u = warp; u < ENC_NG * nqg * ENC_Z_KS; u += NWARP) {
      const int r0 = u / (nqg * ENC_Z_KS) * ET, ch = u / nqg % ENC_Z_KS;
      const int c = u % nqg * 16 + cq;
      const int kb = ch * kz, ke = min(ENC_X, kb + kz);
      float4 acc[ET];
      zero(acc);
      tmac(acc, X, r0, w + off[ENC_NW - 2], od, c, kb, ke, kl);
      kput(acc, kl, r0, scr + ch * R * od + c, od, zero4, c < od);
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
      stage(xb + ((k + 1) % 3) * R * ENC_X + ENC_FOFF, f0 + (k + 1) * a.in_dim,
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

}  // namespace

extern "C" {

// Every entry takes (weights, offsets[n_off], n_off, input, output, sizes...,
// state_in[], state_out[], stream) and returns the launch's cudaError_t.

int radae_fused_decoder_step(const void* w, const int* off, int n_off,
                             const void* z, void* feats, int B, int nz,
                             int in_dim, int out_dim, void* const* state_in,
                             void* const* state_out, void* stream) {
  if (n_off != DEC_NW || B < 1 || nz < 1 || in_dim % 4 || out_dim % 4 ||
      out_dim > DEC_MAX_OUT)
    return (int)cudaErrorInvalidValue;
  DecArgs a;
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
  cudaError_t e = cudaFuncSetAttribute(
      dec_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DEC_SMEM);
  if (e != cudaSuccess) return (int)e;
  dec_kernel<<<(B + R - 1) / R, NT, DEC_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int radae_fused_decoder_merged_step(const void* w, const int* off, int n_off,
                                    const void* z, void* feats, int B, int nz,
                                    int in_dim, int out_dim,
                                    void* const* state_in,
                                    void* const* state_out, void* stream) {
  if (n_off != DEC_NWM || B < 1 || nz < 1 || in_dim % 4 || out_dim % 4 ||
      out_dim > DEC_MAX_OUT)
    return (int)cudaErrorInvalidValue;
  DecMergedArgs a;
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
  cudaError_t e = cudaFuncSetAttribute(
      dec_merged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)DECM_SMEM);
  if (e != cudaSuccess) return (int)e;
  dec_merged_kernel<<<(B + R - 1) / R, NT, DECM_SMEM,
                      static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int radae_fused_rx_frame_step(const void* w, const int* off, int n_off,
                              const void* rx, void* feats, int B, int out_dim,
                              float mag_k, int coarse_mag,
                              void* const* state_in, void* const* state_out,
                              void* stream) {
  if (n_off != FR_NW || B < 1 || out_dim % 4 || out_dim > DEC_MAX_OUT)
    return (int)cudaErrorInvalidValue;
  FrameArgs a;
  const float* wf = static_cast<const float*>(w);
  a.d.w = wf;
  for (int i = 0; i < DEC_NW; ++i) a.d.off[i] = off[4 + i];
  a.d.z = nullptr;
  a.d.feats = static_cast<float*>(feats);
  a.d.B = B; a.d.nz = FR_NZ; a.d.in_dim = FR_LAT; a.d.out_dim = out_dim;
  for (int i = 0; i < 5; ++i) {
    a.d.h_in[i] = static_cast<const float*>(state_in[i]);
    a.d.hist_in[i] = static_cast<const float*>(state_in[5 + i]);
    a.d.h_out[i] = static_cast<float*>(state_out[i]);
    a.d.hist_out[i] = static_cast<float*>(state_out[5 + i]);
  }
  a.rx = static_cast<const float*>(rx);
  a.dft_w = wf + off[4 + DEC_NW];
  a.ls_w = wf + off[4 + DEC_NW + 1];
  a.mag_k = mag_k;
  a.coarse_mag = coarse_mag;
  cudaError_t e = cudaFuncSetAttribute(
      rx_frame_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)FR_SMEM);
  if (e != cudaSuccess) return (int)e;
  rx_frame_kernel<<<(B + R - 1) / R, NT, FR_SMEM,
                    static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

int radae_fused_encoder_step(const void* w, const int* off, int n_off,
                             const void* f, void* z, int B, int nz,
                             int in_dim, int out_dim, int bottleneck,
                             void* const* state_in, void* const* state_out,
                             void* stream) {
  if (n_off != ENC_NW || B < 1 || nz < 1 || in_dim < 4 || in_dim % 4 ||
      out_dim < 4 || out_dim % 4 || in_dim > ENC_X - ENC_FOFF ||
      out_dim > ENC_MAX_OUT)
    return (int)cudaErrorInvalidValue;
  EncArgs a;
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
  cudaError_t e = cudaFuncSetAttribute(
      enc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ENC_SMEM);
  if (e != cudaSuccess) return (int)e;
  enc_kernel<<<(B + R - 1) / R, NT, ENC_SMEM, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The tiling, for counting the weight bytes a launch fetches: batch rows a
// block owns, and rows each weight load feeds in enc_kernel's products.
int radae_block_rows(void) { return R; }
int radae_enc_tile_rows(void) { return ET; }

}  // extern "C"
