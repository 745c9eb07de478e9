// Variants of K10-K13 (the 2D per-substep kernels), for
// profile_epdiff2d.py only (not part of the kernel library; built by that
// script, with epdiff2d.cu included).  The kernels before K12's redesign
// need no variant here: they are the per-thread route of the library's
// entry points (`tile` -1), K12's two passes and K13's one, unchanged.
//
//   parts12_kernel<MASK, MINB>: K12's tile kernel with a part left out by
//     the mask: 1 the stage (g, d_mw and the packed weights of phiinv), 2
//     the per-pixel part (d_phi and d_m0) from the stage; 3 computes K12.
//     MINB: the blocks an SM its registers are bounded for
//     (`__launch_bounds__`; the library's 3; 2 and 4 bound a thread to 128
//     and 64 registers).  With a batch-1 m0 (mask 3) it writes its rows'
//     d_mw to a field in place of d_m0, which the library's per-thread sum
//     over the subjects then reads: the tile route for a batch-1 m0, which
//     the library does not take (it measured slower than the per-thread
//     route's two passes).
//   parts13_kernel<MASK, MINB>: K13 on K12's tiles, which the library does
//     not take (it measured slower than one thread a pixel): K9's phase 1
//     run once, the packed weights of s v staged for the tile's rows and a
//     halo row on each side (1 the stage), then d_phi and d_v of each pixel
//     of the tile from them (2), d_v to its field; 3 computes K13.
//   pixel12_kernel<PIX>: K12's tile kernel (batch-N m0, the library's
//     register bound) with the terms of its per-pixel part chosen by PIX: 1
//     the weight gradient on m0, 2 the divergence terms, 4 the gather
//     transpose to d_m0 (7: K12); d_phi is the sum of the terms computed.
//     It times each term by its absence.
//   cheap_ad_star2d_kernel, cheap_compose2d_kernel: K10 and K11 as one
//     thread a pixel, as the per-thread kernels, but with int indices and
//     the warp on its 4 live taps (`s2d::adstar<true>`, `compose<true>`,
//     as K8 runs them): the first form of the redesign, without strips,
//     rings or bands.  prof_ad_star2d_fwd / prof_compose2d_fwd also run
//     the library's march kernels at any strip width PX and band height
//     RJ, with and without the prefetch.
// Without the per-pixel part a thread reads one staged value back after
// the barrier (and stores nothing unless it equals a value no stage
// holds), so the stage is not dropped; without the stage the per-pixel
// part reads whatever shared memory holds.  Those outputs are not K12's
// or K13's: they time the parts.
#include "../epdiff2d.cu"

namespace lagomorph {
namespace {

constexpr float kSink = -1234.5f;  // a value no stage holds

template <int MASK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
parts12_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
               const float* __restrict__ g, const float* __restrict__ mw,
               float* __restrict__ dmw_out, float* __restrict__ d_phi, float* __restrict__ d_m0,
               int N, int Nm, int H, int W, int TJ) {
  extern __shared__ __align__(16) float2 p12_smem[];
  const Geo gm = make_geo(N, H, W);
  const int staged = (TJ + 2) * W;
  float4* w = reinterpret_cast<float4*>(p12_smem);
  float2* dm = p12_smem + 2 * staged;
  float2* dmw = dm + staged;
  for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
    const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
    if (MASK & 1)
      stage_dmw_from(phiinv, [&](int, int p) { return make_float2(g[p], g[p + gm.HW]); }, dm,
                     dmw, w, dmw_out, W, 1, l0, nl, gm);
    __syncthreads();
    if (MASK & 2) {
      adstar_bwd_tile<false>(m0, Nm, mw, dm, dmw, w, W, 1, d_phi, dmw_out ? nullptr : d_m0, true,
                             l0, nl, gm);
    } else {
      const int e = threadIdx.x % ((nl + 2) * W);
      const float2 x = dmw[e];
      if (x.x == kSink && w[e].x == kSink) d_phi[l0 * W] = x.y + dm[e].x;
    }
    __syncthreads();
  }
}

template <int MASK, int MINB>
__global__ void __launch_bounds__(kThreads, MINB)
parts13_kernel(const float* __restrict__ phiinv, const float* __restrict__ v, float s,
               const float* __restrict__ g, float* __restrict__ d_phi, float* __restrict__ d_v,
               int N, int H, int W, int TJ) {
  extern __shared__ __align__(16) float2 p13_smem[];
  const Geo gm = make_geo(N, H, W);
  float4* w = reinterpret_cast<float4*>(p13_smem);
  for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
    const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
    if (MASK & 1) stage_weights(w, v, s, l0, nl, gm);
    __syncthreads();
    if (MASK & 2) {
      compose_bwd_rows(phiinv, g, s, w, d_phi,
                       [&](int, int, int q, float2 dv) {
                         d_v[q] = dv.x;
                         d_v[q + gm.HW] = dv.y;
                       },
                       l0, nl, nl, gm);
    } else {
      const float4 x = w[threadIdx.x % ((nl + 2) * W)];
      if (x.x == kSink) d_phi[l0 * W] = x.y;
    }
    __syncthreads();
  }
}

__global__ void cheap_ad_star2d_kernel(const float* __restrict__ phiinv,
                                       const float* __restrict__ m0, float* __restrict__ out,
                                       float* __restrict__ mw_out, int* flag, int N, int Nm, int H,
                                       int W) {
  const int HW = H * W, F = 2 * HW;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < N * HW) {
    const int n = idx / HW, p = idx - n * HW;
    const int i = p / W, j = p - i * W;
    float o[2], mw[2];
    bad = !s2d::adstar<true>(phiinv + n * F, m0 + (Nm == 1 ? 0 : n * F), H, W, i, j, o, mw);
    out[n * F + p] = o[0];
    out[n * F + p + HW] = o[1];
    if (mw_out != nullptr) {
      mw_out[n * F + p] = mw[0];
      mw_out[n * F + p + HW] = mw[1];
    }
  }
  clear_flag_if(bad, flag);
}

__global__ void cheap_compose2d_kernel(const float* __restrict__ phiinv,
                                       const float* __restrict__ v, float s,
                                       float* __restrict__ out, int* flag, int N, int H, int W) {
  const int HW = H * W, F = 2 * HW;
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < N * HW) {
    const int n = idx / HW, p = idx - n * HW;
    const int i = p / W, j = p - i * W;
    float o[2];
    bad = !s2d::compose<true>(phiinv + n * F, v[n * F + p], v[n * F + p + HW], s, H, W, i, j, o);
    out[n * F + p] = o[0];
    out[n * F + p + HW] = o[1];
  }
  clear_flag_if(bad, flag);
}

template <int PIX>
__global__ void __launch_bounds__(kThreads, 3)
pixel12_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
               const float* __restrict__ g, const float* __restrict__ MW,
               float* __restrict__ d_phi, float* __restrict__ d_m0, int N, int H, int W,
               int TJ) {
  extern __shared__ __align__(16) float2 x12_smem[];
  const Geo gm = make_geo(N, H, W);
  const int staged = (TJ + 2) * W, rs = W, cs = 1;
  float4* w = reinterpret_cast<float4*>(x12_smem);
  float2* dm = x12_smem + 2 * staged;
  float2* dmw = dm + staged;
  for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
    const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
    stage_dmw_from(phiinv, [&](int, int p) { return make_float2(g[p], g[p + gm.HW]); }, dm, dmw,
                   w, nullptr, W, 1, l0, nl, gm);
    __syncthreads();
    for (int e = threadIdx.x; e < nl * W; e += blockDim.x) {  // adstar_bwd_tile's body
      const int j = e / W, c = e - j * W;
      const int l = l0 + j;
      const int n = l / H;
      const int i = l - n * H;
      const int f = n * gm.F;
      const int p = i * W + c;
      const int sp = (j + 1) * rs + c * cs;
      float d0 = 0.0f, d1 = 0.0f;
      if constexpr ((PIX & 1) != 0) {
        const float2 cw = dmw[sp];
        float wg[2];
        staged_weight_grad(m0 + f, w[(j + 1) * W + c], cw.x, cw.y, H, W, i, c, wg);
        d0 = wg[0];
        d1 = wg[1];
      }
      if constexpr ((PIX & 2) != 0) {
        const float2 dp = dm[sp];
        const float* mw = MW + f;
        float t0[2], t1[2];
        div_axis(mw, i > 0 ? p - W : p, p, i < H - 1 ? p + W : p, dm[i > 0 ? sp - rs : sp], dp,
                 dm[i < H - 1 ? sp + rs : sp], i, H, t0);
        div_axis(mw + gm.HW, c > 0 ? p - 1 : p, p, c < W - 1 ? p + 1 : p,
                 dm[c > 0 ? sp - cs : sp], dp, dm[c < W - 1 ? sp + cs : sp], c, W, t1);
        d0 = s2d::add(d0, s2d::add(t0[0], t1[0]));
        d1 = s2d::add(d1, s2d::add(t0[1], t1[1]));
      }
      d_phi[f + p] = d0;
      d_phi[f + p + gm.HW] = d1;
      if constexpr ((PIX & 4) != 0) {
        const int r0 = n * H - (l0 - 1);
        float acc[2];
        gather_transpose(w, r0, H, W, i, c,
                         [&](int u, int v) { return dmw[(r0 + u) * rs + v * cs]; }, acc);
        d_m0[f + p] = acc[0];
        d_m0[f + p + gm.HW] = acc[1];
      }
    }
    __syncthreads();
  }
}

template <int PIX>
int launch_pixel12(const float* phiinv, const float* m0, const float* g, const float* mw,
                   float* d_phi, float* d_m0, int N, int H, int W, const TileConfig& c,
                   cudaStream_t st) {
  const auto kernel = pixel12_kernel<PIX>;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)kMaxSmem);
  if (err != 0) return err;
  kernel<<<c.blocks, kThreads, c.smem, st>>>(phiinv, m0, g, mw, d_phi, d_m0, N, H, W, c.tj);
  return (int)cudaGetLastError();
}

template <int MASK, int MINB>
int launch12(const float* phiinv, const float* m0, const float* g, const float* mw, float* dmw,
             float* d_phi, float* d_m0, int N, int Nm, int H, int W, const TileConfig& c,
             cudaStream_t st) {
  const auto kernel = parts12_kernel<MASK, MINB>;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)kMaxSmem);
  if (err != 0) return err;
  kernel<<<c.blocks, kThreads, c.smem, st>>>(phiinv, m0, g, mw, dmw, d_phi, d_m0, N, Nm, H, W,
                                             c.tj);
  return (int)cudaGetLastError();
}

template <int MASK, int MINB>
int launch13(const float* phiinv, const float* v, float s, const float* g, float* d_phi,
             float* d_v, int N, int H, int W, const TileConfig& c, cudaStream_t st) {
  const auto kernel = parts13_kernel<MASK, MINB>;
  const int err = (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                            (int)kMaxSmem);
  if (err != 0) return err;
  const size_t smem = (size_t)16 * (c.tj + 2) * W;  // the packed weights
  kernel<<<c.blocks, kThreads, smem, st>>>(phiinv, v, s, g, d_phi, d_v, N, H, W, c.tj);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace lagomorph

// K12's variants at the tile height of lagomorph_ad_star2d_bwd's `tile` (>
// 0, or 0 for its choice): mask 1 the stage, 2 the per-pixel part, 3 both;
// minb 3 (mask 1-3), 2 or 4 (mask 3).  m0: (Nm, 2, H, W); a batch-1 m0 of
// N > 1 subjects (mask 3) takes dmw, an (N, 2, H, W) scratch, and the
// library's sum over the subjects after the tiles.
extern "C" int prof_epdiff2d_parts12(int mask, int minb, const float* phiinv, const float* m0,
                                     const float* g, const float* mw, float* dmw, float* d_phi,
                                     float* d_m0, int N, int Nm, int H, int W, int tile,
                                     void* stream) {
  using namespace lagomorph;
  const bool sum_m0 = Nm != N;
  if ((Nm != N && Nm != 1) || (sum_m0 && (dmw == nullptr || mask != 3)))
    return (int)cudaErrorInvalidValue;
  TileConfig c;
  int err = tile2d_config(N, H, W, tile, &c);
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  float* out = sum_m0 ? dmw : nullptr;
  switch (mask * 10 + minb) {
    case 13: err = launch12<1, 3>(phiinv, m0, g, mw, out, d_phi, d_m0, N, Nm, H, W, c, st); break;
    case 23: err = launch12<2, 3>(phiinv, m0, g, mw, out, d_phi, d_m0, N, Nm, H, W, c, st); break;
    case 32: err = launch12<3, 2>(phiinv, m0, g, mw, out, d_phi, d_m0, N, Nm, H, W, c, st); break;
    case 33: err = launch12<3, 3>(phiinv, m0, g, mw, out, d_phi, d_m0, N, Nm, H, W, c, st); break;
    case 34: err = launch12<3, 4>(phiinv, m0, g, mw, out, d_phi, d_m0, N, Nm, H, W, c, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (err != 0 || !sum_m0) return err;
  ad_star2d_bwd_m0_kernel<<<grid_for((long)Nm * H * W), kThreads, 0, st>>>(phiinv, dmw, d_m0, N,
                                                                           Nm, H, W);
  return (int)cudaGetLastError();
}

// K13's variants on K12's tiles, as prof_epdiff2d_parts12's
extern "C" int prof_epdiff2d_parts13(int mask, int minb, const float* phiinv, const float* v,
                                     float s, const float* g, float* d_phi, float* d_v, int N,
                                     int H, int W, int tile, void* stream) {
  using namespace lagomorph;
  TileConfig c;
  const int err = tile2d_config(N, H, W, tile, &c);
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (mask * 10 + minb) {
    case 13: return launch13<1, 3>(phiinv, v, s, g, d_phi, d_v, N, H, W, c, st);
    case 23: return launch13<2, 3>(phiinv, v, s, g, d_phi, d_v, N, H, W, c, st);
    case 32: return launch13<3, 2>(phiinv, v, s, g, d_phi, d_v, N, H, W, c, st);
    case 33: return launch13<3, 3>(phiinv, v, s, g, d_phi, d_v, N, H, W, c, st);
    case 34: return launch13<3, 4>(phiinv, v, s, g, d_phi, d_v, N, H, W, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K12's per-pixel terms (batch-N m0) chosen by pix (pixel12_kernel) at the
// tile height of lagomorph_ad_star2d_bwd's `tile`
extern "C" int prof_epdiff2d_pixel12(int pix, const float* phiinv, const float* m0,
                                     const float* g, const float* mw, float* d_phi, float* d_m0,
                                     int N, int H, int W, int tile, void* stream) {
  using namespace lagomorph;
  TileConfig c;
  const int err = tile2d_config(N, H, W, tile, &c);
  if (err != (int)cudaSuccess) return err;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (pix) {
    case 3: return launch_pixel12<3>(phiinv, m0, g, mw, d_phi, d_m0, N, H, W, c, st);
    case 5: return launch_pixel12<5>(phiinv, m0, g, mw, d_phi, d_m0, N, H, W, c, st);
    case 6: return launch_pixel12<6>(phiinv, m0, g, mw, d_phi, d_m0, N, H, W, c, st);
    case 7: return launch_pixel12<7>(phiinv, m0, g, mw, d_phi, d_m0, N, H, W, c, st);
  }
  return (int)cudaErrorInvalidValue;
}

// K10's forms: form 0 the cheap kernel (px, rj unused), 1 the march at
// strips of px columns (1, 2, 4) and bands of rj rows, 2 the same without
// its prefetch.  Arguments as lagomorph_ad_star2d_fwd's.
extern "C" int prof_ad_star2d_fwd(int form, int px, int rj, const float* phiinv, const float* m0,
                                  float* out, float* mw, int* flag, int N, int Nm, int H, int W,
                                  void* stream) {
  using namespace lagomorph;
  const cudaStream_t st = (cudaStream_t)stream;
  if (2L * N * H * W >= (1L << 31) || rj < 1) return (int)cudaErrorInvalidValue;
  if (form == 0) {
    cheap_ad_star2d_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(phiinv, m0, out, mw,
                                                                           flag, N, Nm, H, W);
    return (int)cudaGetLastError();
  }
  const Strips sp = strips_for(px, rj, H, W);
  if (form == 1)
    return launch_ad_star2d_march<true>(sp, phiinv, m0, out, mw, flag, N, Nm, H, W, st);
  if (form == 2)
    return launch_ad_star2d_march<false>(sp, phiinv, m0, out, mw, flag, N, Nm, H, W, st);
  return (int)cudaErrorInvalidValue;
}

// K11's forms, as prof_ad_star2d_fwd's; arguments as lagomorph_compose2d_fwd's
extern "C" int prof_compose2d_fwd(int form, int px, int rj, const float* phiinv, const float* v,
                                  float s, float* out, int* flag, int N, int H, int W,
                                  void* stream) {
  using namespace lagomorph;
  const cudaStream_t st = (cudaStream_t)stream;
  if (2L * N * H * W >= (1L << 31) || rj < 1) return (int)cudaErrorInvalidValue;
  if (form == 0) {
    cheap_compose2d_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(phiinv, v, s, out,
                                                                           flag, N, H, W);
    return (int)cudaGetLastError();
  }
  const Strips sp = strips_for(px, rj, H, W);
  if (form == 1) return launch_compose2d_march<true>(sp, phiinv, v, s, out, flag, N, H, W, st);
  if (form == 2) return launch_compose2d_march<false>(sp, phiinv, v, s, out, flag, N, H, W, st);
  return (int)cudaErrorInvalidValue;
}
