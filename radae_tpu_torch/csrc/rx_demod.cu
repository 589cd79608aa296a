// The streaming rx front end for Hopper (sm_90a) in one launch: for every
// stream and every frame of a call, the CP strip, the DFT of each symbol
// row, the 3-pilot least-squares channel estimate of the frame's two
// bracketing pilot rows, their linear interpolation, the phase EQ, the
// coarse magnitude and the QPSK demap.
//
// Replaces no TPU kernel: radae_tpu's streaming rx step runs its front end
// in plain JAX (its nearest relative is the prologue of the frame kernel,
// fused_core.cu's rx_frame_kernel).  It computes what the plain PyTorch
// version computes, radae_tpu_torch/ops/ofdm.py rx_front_end_plain (the
// composition that runtime.make_streaming_rx_step ran as some 15 torch
// operations), all in f32: no TF32, no bf16.
//
// What bounds it on this card.  A stream's frame is n_rs = fps(Ns+1)+1
// symbol rows of M+Ncp complex samples (flagship: 6 x 192, 9,216 bytes)
// and becomes fps*Ns*Nc complex latents (960 bytes).  The DFT is
// n_rs*M*Nc complex multiply-adds a stream (4 f32 FMA each): at B=65536,
// 15.1 GFLOP a call, 0.23 ms at the 67 TFLOP/s f32 rate outside the tensor
// cores, against 0.20 ms for the bytes at 3.35 TB/s (latent 40, Nc=15:
// 7.5 GFLOP, 0.11 ms, and 0.19 ms of bytes).  So it sits between the two
// bounds: the loads have to overlap the FMA loops, and the FMA loops must
// run near the issue rate.
//
// What the design does about it (each choice timed on an H100 against
// the one it replaced; PERF.md, Findings):
//   * one block of up to 16 warps a SM, the DFT matrix (in the order the
//     lanes read it, 40 KB at the flagship) and the LS constants copied
//     into shared memory once a block, then every warp a pipeline of its
//     own over streams b = its index + k * (the grid's warps): no block
//     barrier, so at any time some warps run the FMA-bound DFT while
//     others run the latency-bound epilogue or wait on their copies.  16
//     warps with one stream buffer each beat 8 with two (0.49 against
//     0.58 ms at the flagship): the DFT loop is bound by latency at two
//     warps a scheduler, not by the loads;
//   * a stream's M stripped samples a row arrive by bulk asynchronous
//     copies (cp.async.bulk, the TMA's, one a row, issued by the warp's
//     lanes, completing on the warp's mbarrier), issued as soon as the
//     warp's DFT has read the previous stream, so they land during its
//     epilogue.  A staged row is 2M+4 floats, so rows read at once fall
//     on different banks;
//   * the DFT is a register-tiled product: a lane owns TR=6 rows x TC=4
//     carriers (48 accumulators) and every ks-th pair of samples, the
//     warp's 32 lanes cg lanes across the carriers (the power of two that
//     covers Nc/4, chosen here alone: radae_rx_demod_lanes gives it to the
//     wrapper, which packs the DFT matrix in its order) times ks = 32/cg
//     across the samples; each step reads
//     two samples of each row and of each carrier (float4s) for 192 FMAs,
//     and the ks partial sums are added by a shuffle butterfly.  Smaller
//     tiles (3 rows x 2 carriers, every lane all samples) read twice the
//     shared-memory bytes an FMA;
//   * the epilogue is the warp's, a lane a carrier: the LS fit of the
//     pilot rows (taps clamped inward at the band edges), the coarse
//     magnitude (a shuffle butterfly in a fixed order), then
//     interpolation, derotation by conj(h)/sqrt(|h|^2 + 1e-12), the scale
//     and the demap, written as (re, im) float2s (coalesced);
//   * the host's part of a launch is the launch itself: the SM count and
//     the shared-memory opt-in are read and set once a device.
// Every sum runs in a fixed order: two launches on the same input give the
// same bits.

#include <cuda_runtime.h>

#include <atomic>

namespace {

constexpr int NWARP = 16;            // warps a block at most
constexpr int TR = 6;                // symbol rows of a lane's DFT tile
constexpr int TC = 4;                // carriers of a lane's DFT tile
constexpr int SMEM_MAX = 231424;     // dynamic shared memory a block may use
                                     // (the H100's 232,448 less 1 KB)
constexpr int LS_W = 16;             // floats of LS constants a carrier
constexpr int MAX_DEV = 64;          // devices a process may launch on

// The launch's geometry: the modem's, and the tiling chosen from it
struct Geo {
  int B, ns, nc, m, ncp, st, fps, nrs;  // st: the strip point Ncp+time_offset
  int cg, ks;                           // DFT lanes across carriers, and
                                        // across samples (32 / cg)
  int nw;                               // warps a block
  int xs, yw, es, wr;                   // floats: a staged row, a row of Y,
                                        // a stream's estimates and scales,
                                        // a warp's region
  int coarse_mag;
  float mag_mul, mag_div, inv_ns1;
};

// floats of the DFT matrix: ceil(M/2 / ks) steps of TC carriers x 32
// lanes x 2 samples x (re, im)
__host__ __device__ inline int w_floats(const Geo& g) {
  return (g.m / 2 + g.ks - 1) / g.ks * 128 * TC;
}

__host__ __device__ inline size_t smem_floats(const Geo& g) {
  return (size_t)w_floats(g) + LS_W * g.nc + (size_t)g.nw * g.wr;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// a warp's mbarrier: one arrival (with the bytes to expect) a phase, a
// stream's rows, completed by the bulk copies' bytes
__device__ __forceinline__ unsigned sh(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(sh(bar))
               : "memory");
}
__device__ __forceinline__ void bar_expect(unsigned long long* bar,
                                           unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          sh(bar)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ bool bar_done(unsigned long long* bar,
                                         unsigned parity) {
  unsigned ok;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(sh(bar)), "r"(parity)
      : "memory");
  return ok != 0;
}
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(sh(dst)),
      "l"(src), "r"(bytes), "r"(sh(bar))
      : "memory");
}

// Copy the M stripped samples of each of stream b's n_rs rows into X, a
// row every xs floats: a bulk copy a row, issued by the warp's lanes, on
// the buffer's mbarrier
__device__ __forceinline__ void load_stream(const Geo& g, const float* rx,
                                            int b, float* X,
                                            unsigned long long* bar) {
  const int lane = threadIdx.x & 31;
  const unsigned bytes = 8u * g.m;
  const size_t rowlen = 2 * (size_t)(g.m + g.ncp);
  if (lane == 0) bar_expect(bar, bytes * g.nrs);
  __syncwarp();
  for (int q = lane; q < g.nrs; q += 32)
    bulk_load(X + q * g.xs, rx + ((size_t)b * g.nrs + q) * rowlen + 2 * g.st,
              bytes, bar);
}

// The DFT of a stream's rows: Y[q][2c..2c+1] = sum_m x[q][m] Wfwd[m][c],
// TR rows at a time.  A lane takes TC carriers (cg) of them and every
// ks-th pair of samples from its kg-th (in sample order), two samples a
// step; the ks lanes' sums are then added by a butterfly over the lane bits
// above cg
__device__ __forceinline__ void dft(const Geo& g, const float* X,
                                    const float* W, float* Y) {
  const int lane = threadIdx.x & 31;
  const int cg = lane & (g.cg - 1), kg = lane / g.cg;
  const int q_n = g.nrs, np = g.m / 2;
  const int wstep = 128 * TC;                     // floats of W a step
  for (int u = 0; u * TR < q_n; ++u) {
    const int q0 = u * TR;
    const float* xp[TR];
#pragma unroll
    for (int r = 0; r < TR; ++r)
      xp[r] = X + min(q0 + r, q_n - 1) * g.xs + 4 * kg;
    const float* wp = W + 4 * lane;
    float acc[TR][TC][2];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int j = 0; j < TC; ++j) acc[r][j][0] = acc[r][j][1] = 0.f;
#pragma unroll 2
    for (int mp = kg, t = 0; mp < np; mp += g.ks, t += 4 * g.ks,
             wp += wstep) {
      float4 xv[TR], wv[TC];
#pragma unroll
      for (int r = 0; r < TR; ++r) xv[r] = ld4(xp[r] + t);
#pragma unroll
      for (int j = 0; j < TC; ++j) wv[j] = ld4(wp + 128 * j);
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          float re = acc[r][j][0], im = acc[r][j][1];
          re = fmaf(xv[r].x, wv[j].x, re);
          re = fmaf(-xv[r].y, wv[j].y, re);
          im = fmaf(xv[r].x, wv[j].y, im);
          im = fmaf(xv[r].y, wv[j].x, im);
          re = fmaf(xv[r].z, wv[j].z, re);
          re = fmaf(-xv[r].w, wv[j].w, re);
          im = fmaf(xv[r].z, wv[j].w, im);
          im = fmaf(xv[r].w, wv[j].z, im);
          acc[r][j][0] = re;
          acc[r][j][1] = im;
        }
    }
    for (int o = g.cg; o < 32; o <<= 1)
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int j = 0; j < TC; ++j) {
          acc[r][j][0] += __shfl_xor_sync(0xffffffffu, acc[r][j][0], o);
          acc[r][j][1] += __shfl_xor_sync(0xffffffffu, acc[r][j][1], o);
        }
    // every lane holds the sums: lane kg writes the rows r = kg (mod ks)
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      if (r % g.ks != kg || q0 + r >= q_n) continue;
      float* y = Y + (q0 + r) * g.yw + 2 * TC * cg;
#pragma unroll
      for (int j = 0; j < TC; j += 2)
        *reinterpret_cast<float4*>(y + 2 * j) = make_float4(
            acc[r][j][0], acc[r][j][1], acc[r][j + 1][0], acc[r][j + 1][1]);
    }
  }
}

// A stream's LS estimates, coarse magnitude, EQ and demap (a warp's work,
// a lane the carriers c = lane (mod 32)): Ys its rows of Y, Es its
// (fps+1)*Nc estimates and fps scales, z its fps*Ns*Nc latents as (re, im)
__device__ __forceinline__ void epilogue(const Geo& g, const float* Ys,
                                         const float* L, float* Es,
                                         float2* z) {
  const int c0 = threadIdx.x & 31;
  const int nc = g.nc, ns1 = g.ns + 1;
  // est = g0 + g1 phase, g = Pmat (Y[taps] / P[taps]) (est_pilots_ls)
  for (int c = c0; c < nc; c += 32) {
    const int t0 = min(max(c, 1), nc - 2) - 1;
    const float* lc = L + LS_W * c;
    for (int f = 0; f <= g.fps; ++f) {
      const float* y = Ys + f * ns1 * g.yw;
      float g0rr = 0.f, g0ii = 0.f, g0ri = 0.f, g0ir = 0.f;
      float g1rr = 0.f, g1ii = 0.f, g1ri = 0.f, g1ir = 0.f;
#pragma unroll
      for (int j = 0; j < 3; ++j) {
        const int t = t0 + j;
        const float2 yv = ld2(y + 2 * t), ip = ld2(L + LS_W * t);
        const float hr = yv.x * ip.x - yv.y * ip.y;
        const float hi = yv.x * ip.y + yv.y * ip.x;
        const float2 p0 = ld2(lc + 2 + 2 * j), p1 = ld2(lc + 8 + 2 * j);
        g0rr += p0.x * hr; g0ii += p0.y * hi; g0ri += p0.x * hi; g0ir += p0.y * hr;
        g1rr += p1.x * hr; g1ii += p1.y * hi; g1ri += p1.x * hi; g1ir += p1.y * hr;
      }
      const float g0r = g0rr - g0ii, g0i = g0ri + g0ir;
      const float g1r = g1rr - g1ii, g1i = g1ri + g1ir;
      const float2 ph = ld2(lc + 14);
      Es[2 * (f * nc + c)] = g0r + (g1r * ph.x - g1i * ph.y);
      Es[2 * (f * nc + c) + 1] = g0i + (g1r * ph.y + g1i * ph.x);
    }
  }
  __syncwarp();
  // each frame's scale: 1 / ((sqrt(mean |p0|^2 + mean |p1|^2) / 2) + 1e-6)
  // * P0_abs / pilot_gain), or 1; the carriers' sum a lane's, then a
  // butterfly over the warp
  float* const inv_mag = Es + 2 * (g.fps + 1) * nc;
  for (int f = 0; f < g.fps; ++f) {
    float im = 1.f;
    if (g.coarse_mag) {
      float a = 0.f, b = 0.f;
      for (int c = c0; c < nc; c += 32) {
        const float2 e0 = ld2(Es + 2 * (f * nc + c));
        const float2 e1 = ld2(Es + 2 * ((f + 1) * nc + c));
        a += e0.x * e0.x + e0.y * e0.y;
        b += e1.x * e1.x + e1.y * e1.y;
      }
      for (int o = 16; o > 0; o >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, o);
        b += __shfl_xor_sync(0xffffffffu, b, o);
      }
      const float mg = (sqrtf(0.5f * (a / nc + b / nc)) + 1e-6f) * g.mag_mul /
                       g.mag_div;
      im = 1.f / mg;
    }
    if (c0 == 0) inv_mag[f] = im;
  }
  __syncwarp();
  // data symbol (f, i, c): y conj(h) / |h| * scale, h interpolated from
  // the frame's two pilot rows
  for (int f = 0; f < g.fps; ++f) {
    const float s = inv_mag[f];
    for (int c = c0; c < nc; c += 32) {
      const float2 p0 = ld2(Es + 2 * (f * nc + c));
      const float2 p1 = ld2(Es + 2 * ((f + 1) * nc + c));
      const float sr = (p1.x - p0.x) * g.inv_ns1;
      const float si = (p1.y - p0.y) * g.inv_ns1;
      const float* y = Ys + (f * ns1 + 1) * g.yw + 2 * c;
      float2* zf = z + f * g.ns * nc + c;
#pragma unroll 4
      for (int i = 0; i < g.ns; ++i, y += g.yw, zf += nc) {
        const float t = (float)(i + 1);
        const float hr = p0.x + sr * t, hi = p0.y + si * t;
        const float r = sqrtf(hr * hr + hi * hi + 1e-12f);
        const float ur = hr / r, ui = hi / r;
        const float2 yv = ld2(y);
        *zf = make_float2((yv.x * ur + yv.y * ui) * s,
                            (yv.y * ur - yv.x * ui) * s);
      }
    }
  }
  __syncwarp();
}

__global__ void __launch_bounds__(NWARP * 32, 1)
    rx_demod_kernel(const float* __restrict__ rx,
                    const float* __restrict__ cst, float* __restrict__ out,
                    const __grid_constant__ Geo g) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long ring_bar[NWARP];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* const W = reinterpret_cast<float*>(smem4);
  float* const L = W + w_floats(g);
  float* const X = L + LS_W * g.nc + warp * g.wr;   // the warp's stream
  float* const Y = X + g.nrs * g.xs;
  float* const Es = Y + g.nrs * g.yw;
  unsigned long long* const bar = &ring_bar[warp];
  const int lz = g.fps * g.ns * g.nc;             // complex latents a stream

  if (lane == 0) {
    bar_init(bar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the constants, by every thread
  for (int i = threadIdx.x; i < (w_floats(g) + LS_W * g.nc) / 4;
       i += blockDim.x)
    cp_async16(W + 4 * i, cst + 4 * i);
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  // stream b = the warp's index + i * (the grid's warps), the i-th phase
  // of the warp's mbarrier; each warp runs its own pipeline, the next
  // stream's copies issued once its DFT has read this one, so they land
  // while the warp runs its epilogue and the other warps their DFTs
  const int step = gridDim.x * g.nw;
  int b = blockIdx.x * g.nw + warp;
  if (b < g.B) load_stream(g, rx, b, X, bar);
  for (int i = 0; b < g.B; ++i, b += step) {
    while (!bar_done(bar, i & 1)) {
    }
    dft(g, X, W, Y);
    __syncwarp();
    if (b + step < g.B) {
      // the DFT's reads of X come before the copies' writes
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      load_stream(g, rx, b + step, X, bar);
    }
    epilogue(g, Y, L, Es, reinterpret_cast<float2*>(out) + (size_t)b * lz);
  }
}

// The DFT's lanes across nc carriers, TC a lane: the fewest, a power of
// two, that cover them (0 past a warp's 32 lanes)
int lanes(int nc) {
  int cg = 1;
  while (cg <= 32 && cg * TC < nc) cg <<= 1;
  return cg <= 32 ? cg : 0;
}

// The geometry of a launch; its limit code (0: the kernel holds it)
int make_geo(int B, int ns, int nc, int m, int ncp, int time_offset, int fps,
             int coarse_mag, float mag_mul, float mag_div, Geo& g) {
  g.B = B; g.ns = ns; g.nc = nc; g.m = m; g.ncp = ncp;
  g.st = ncp + time_offset; g.fps = fps; g.nrs = fps * (ns + 1) + 1;
  g.coarse_mag = coarse_mag; g.mag_mul = mag_mul; g.mag_div = mag_div;
  g.inv_ns1 = 1.f / (float)(ns + 1);
  if (ns < 1 || fps < 1 || nc < 3 || m < 2 || m % 2 || ncp < 0) return 1;
  if (g.st < 0 || g.st > ncp || g.st % 2 || (m + ncp) % 2) return 2;
  g.cg = lanes(nc);
  if (!g.cg) return 3;
  g.ks = 32 / g.cg;
  g.xs = 2 * m + 4;
  g.yw = 2 * TC * g.cg;
  g.es = 2 * (fps + 1) * nc + fps;
  g.wr = (g.nrs * g.xs + g.nrs * g.yw + g.es + 3) / 4 * 4;
  // as many warps as fit, each with its stream's rows, Y and estimates
  g.nw = NWARP;
  while (g.nw > 0 && smem_floats(g) * sizeof(float) > (size_t)SMEM_MAX)
    --g.nw;
  return g.nw ? 0 : 4;
}

// each device's SM count, stored once the kernel's shared-memory opt-in is
// set there (0: not yet)
std::atomic<int> sm_count[MAX_DEV];

// The current device's SM count, reading it and setting the opt-in to
// SMEM_MAX on the device's first launch; a cudaError_t
int device_sms(int& n_sm) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev < 0 || dev >= MAX_DEV) return (int)cudaErrorInvalidDevice;
  n_sm = sm_count[dev].load(std::memory_order_acquire);
  if (n_sm) return 0;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(rx_demod_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_MAX);
  if (e != cudaSuccess) return (int)e;
  sm_count[dev].store(n_sm, std::memory_order_release);
  return 0;
}

}  // namespace

extern "C" {

// 0 where the kernel holds the geometry, else why not: 1 a size out of
// range (Ns, fps >= 1, Nc >= 3, M even), 2 the strip point Ncp+time_offset
// odd or outside [0, Ncp], or M+Ncp odd (a row's copy starts 16-byte
// aligned), 3 Nc past the DFT's 32 lanes of TC carriers, 4 one warp's
// stream (its rows, Y and estimates) does not fit in shared memory
int radae_rx_demod_limit(int ns, int nc, int m, int ncp, int time_offset,
                         int fps) {
  Geo g;
  return make_geo(1, ns, nc, m, ncp, time_offset, fps, 0, 1.f, 1.f, g);
}

// The DFT's lanes across Nc carriers, the order the constants' DFT matrix
// is packed in (ofdm.rx_front_end_consts); 0 past the kernel's limit
int radae_rx_demod_lanes(int nc) { return lanes(nc); }

// rx (B, n_rs (M+Ncp), 2) f32 samples, 16-byte aligned; cst the packed
// constants (ofdm.rx_front_end_consts); out (B, fps Ns Nc, 2) f32 latents.
// Returns the launch's cudaError_t (cudaErrorInvalidValue, and no launch,
// for a geometry past radae_rx_demod_limit or B < 1).
int radae_rx_demod(const void* rx, const void* cst, void* out, int B, int ns,
                   int nc, int m, int ncp, int time_offset, int fps,
                   int coarse_mag, float mag_mul, float mag_div,
                   void* stream) {
  Geo g;
  if (B < 1 || make_geo(B, ns, nc, m, ncp, time_offset, fps, coarse_mag,
                        mag_mul, mag_div, g))
    return (int)cudaErrorInvalidValue;
  int n_sm = 0;
  const int e = device_sms(n_sm);
  if (e) return e;
  const int blocks = (B + g.nw - 1) / g.nw;
  const int grid = blocks < n_sm ? blocks : n_sm;
  const size_t smem = smem_floats(g) * sizeof(float);
  rx_demod_kernel<<<grid, 32 * g.nw, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rx), static_cast<const float*>(cst),
      static_cast<float*>(out), g);
  return (int)cudaGetLastError();
}

}  // extern "C"
