// K10-K13: the two stencil steps of one 2D EPDiff substep, each with the
// unit-regime flag of its warp displacement, and their backwards.  They run
// where the whole-shoot kernels K8/K9 do not: a shooting with a momentum
// mask or a fluid metric with beta != 0, and the unit-regime substeps of
// the exact general integration.  Fields are (N, 2, H, W) float32; a field
// of one subject is two planes of H * W floats.
//
// K10, Ad* (the momentum transport):
//   mw_a(p)  = sum_o w_o(phiinv(p)) * m0_a(clamp(p + o))        (9-tap warp)
//   out_c(p) = sum_a (D_a phiinv_c(p) + delta_ca) * mw_a(p)      (Jacobian)
//   flag     = all components of phiinv in [-1, 1)
// Replaces lagomorph_tpu/ops/pallas/epdiff2d.py `_adstar2d_fwd_kernel`
// (`_adstar2d_fwd_dispatch`, pallas_call at :281).  Under autograd it also
// writes mw, which K12 reads.
//
// K11, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff2d.py `_compose2d_fwd_kernel` (`compose2d_pallas`,
// pallas_call at :456).
//
// K12, Ad* backward (cotangent g of out):
//   d_mw  = (J + I)^T g                                (pointwise)
//   d_m0  = warp transpose of d_mw at weights(phiinv)  (gather form)
//   d_phi = weight-gradient path (image m0, cotangent d_mw)
//           + sum_a D_a^T (g * mw_a)                   (divergence path)
// Replaces epdiff2d.py `_adstar2d_bwd_kernel` (`_adstar2d_bwd`, pallas_call
// at :324).  Two passes, as K6: the first computes d_mw into a scratch
// field and finishes d_phi (it needs d_mw only at its own pixel); the second
// is the gather transpose, which needs d_mw at 9 neighbours.  The TPU kernel
// recomputes d_mw over its slab's halo rows instead; recomputing it per
// neighbour here would cost 9x the Jacobian work to save the scratch round
// trip (2 fields).  A batch-1 m0 gets d_m0 summed over the subjects inside
// the thread, in subject order: no atomics, a deterministic sum.
//
// K13, compose backward (cotangent g of out = s v + phiinv(x + s v)):
//   d_phi = warp transpose of g at weights(s v)
//   d_v   = s g + s * (weight-gradient path, image phiinv, cotangent g)
// Replaces epdiff2d.py `_compose2d_bwd_kernel` (`_compose2d_bwd`,
// pallas_call at :490).  One pass; s v is formed with the forward's
// rounding wherever it is needed, never stored.
//
// The per-pixel math is csrc/stencil2d.cuh's (`s2d::adstar`, `compose`,
// `adstar_bwd_dmw`, `adstar_bwd_dphi`, `warp_transpose`, `compose_bwd`),
// shared with K8/K9: every product and sum rounded on its own, in the plain
// versions' order, so the forwards reproduce them bit for bit.  Not carried
// over: the TPU kernels' x-slabs with 8-row halos, lane rolls and edge
// padding (epdiff2d.py:117-125, 268-272) and their gate's H % 8, W % 128 and
// VMEM budget (epdiff2d.py:52-72) are TPU geometry; here each thread clamps
// its own taps, so any H, W >= 2 is taken.  The TPU's flag is the caller's
// reduction over the field; here, as in K1/K2, an int32 in device memory
// that the wrapper sets to 1 and any warp that sees an out-of-range
// component clears with one atomicAnd.
//
// Design: one thread per pixel over (N, H, W), W fastest across the warp,
// no shared memory and no barriers, so the sources also compile for the
// host in tests.  Bound on the H100 (256^2 b8, 4.19 MB per field): K10 must
// move 3 fields (read phiinv, m0; write out; 4 with mw), K11 3, K12 6 (read
// phiinv, m0, g, mw; write d_phi, d_m0; its passes also move the scratch
// and a second read of phiinv), K13 5: 4-10 us at 3.35 TB/s, near the
// latency of a launch.
#include "stencil2d.cuh"

namespace lagomorph {
namespace {

constexpr int kThreads = 256;

unsigned grid_for(long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

// the pixel of thread idx: subject n, offset p = i * W + j in its plane
struct Pixel {
  int n, i, j;
  long p;
};

__device__ __forceinline__ Pixel pixel_of(long idx, long HW, int W) {
  Pixel px;
  px.n = (int)(idx / HW);
  px.p = idx - (long)px.n * HW;
  px.i = (int)(px.p / W);
  px.j = (int)(px.p - (long)px.i * W);
  return px;
}

__global__ void ad_star2d_fwd_kernel(const float* __restrict__ phiinv,
                                     const float* __restrict__ m0, float* __restrict__ out,
                                     float* __restrict__ mw_out, int* flag, int N, int Nm,
                                     int H, int W) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * HW) {
    const Pixel px = pixel_of(idx, HW, W);
    const long F = 2 * HW, q = px.n * F + px.p;
    float o[2], mw[2];
    bad = !s2d::adstar(phiinv + px.n * F, m0 + (Nm == 1 ? 0 : px.n * F), H, W, px.i, px.j, o,
                       mw);
    out[q] = o[0];
    out[q + HW] = o[1];
    if (mw_out != nullptr) {
      mw_out[q] = mw[0];
      mw_out[q + HW] = mw[1];
    }
  }
  clear_flag_if(bad, flag);
}

__global__ void compose2d_fwd_kernel(const float* __restrict__ phiinv,
                                     const float* __restrict__ v, float s,
                                     float* __restrict__ out, int* flag, int N, int H, int W) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * HW) {
    const Pixel px = pixel_of(idx, HW, W);
    const long F = 2 * HW, q = px.n * F + px.p;
    float o[2];
    bad = !s2d::compose(phiinv + px.n * F, v[q], v[q + HW], s, H, W, px.i, px.j, o);
    out[q] = o[0];
    out[q + HW] = o[1];
  }
  clear_flag_if(bad, flag);
}

// K12, first pass: d_mw (to scratch) and d_phi, one thread per (n, pixel)
__global__ void ad_star2d_bwd_kernel(const float* __restrict__ phiinv,
                                     const float* __restrict__ m0,
                                     const float* __restrict__ g,
                                     const float* __restrict__ mw, float* __restrict__ d_mw,
                                     float* __restrict__ d_phi, int N, int Nm, int H, int W) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * HW) return;
  const Pixel px = pixel_of(idx, HW, W);
  const long F = 2 * HW, q = px.n * F + px.p;
  const float* ph = phiinv + px.n * F;
  float dmw[2], d[2];
  s2d::adstar_bwd_dmw(ph, g[q], g[q + HW], H, W, px.i, px.j, dmw);
  d_mw[q] = dmw[0];
  d_mw[q + HW] = dmw[1];
  s2d::adstar_bwd_dphi(ph, m0 + (Nm == 1 ? 0 : px.n * F), g + px.n * F, mw + px.n * F, dmw[0],
                       dmw[1], H, W, px.i, px.j, d);
  d_phi[q] = d[0];
  d_phi[q + HW] = d[1];
}

// K12, second pass: d_m0 = the gather transpose of d_mw at weights(phiinv),
// one thread per (m0's subject, pixel); a batch-1 m0 sums the N subjects
__global__ void ad_star2d_bwd_m0_kernel(const float* __restrict__ phiinv,
                                        const float* __restrict__ d_mw,
                                        float* __restrict__ d_m0, int N, int Nm, int H, int W) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)Nm * HW) return;
  const Pixel px = pixel_of(idx, HW, W);
  const long F = 2 * HW;
  const int n0 = Nm == 1 ? 0 : px.n, n1 = Nm == 1 ? N : px.n + 1;
  float acc[2] = {0.0f, 0.0f};
  for (int n = n0; n < n1; ++n) {
    float d[2];
    s2d::warp_transpose(phiinv + n * F, 1.0f, d_mw + n * F, H, W, px.i, px.j, d);
    acc[0] = s2d::add(acc[0], d[0]);
    acc[1] = s2d::add(acc[1], d[1]);
  }
  d_m0[px.n * F + px.p] = acc[0];
  d_m0[px.n * F + px.p + HW] = acc[1];
}

__global__ void compose2d_bwd_kernel(const float* __restrict__ phiinv,
                                     const float* __restrict__ v, float s,
                                     const float* __restrict__ g, float* __restrict__ d_phi,
                                     float* __restrict__ d_v, int N, int H, int W) {
  const long HW = (long)H * W;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * HW) return;
  const Pixel px = pixel_of(idx, HW, W);
  const long F = 2 * HW, q = px.n * F + px.p;
  float dp[2], dv[2];
  s2d::compose_bwd(phiinv + px.n * F, v + px.n * F, s, g + px.n * F, H, W, px.i, px.j, dp, dv);
  d_phi[q] = dp[0];
  d_phi[q + HW] = dp[1];
  d_v[q] = dv[0];
  d_v[q + HW] = dv[1];
}

}  // namespace
}  // namespace lagomorph

using lagomorph::grid_for;
using lagomorph::kThreads;

// phiinv, out, mw: (N, 2, H, W); m0: (Nm, 2, H, W), Nm in {1, N}; mw may be
// NULL; flag: one int32 set to 1 by the caller
extern "C" int lagomorph_ad_star2d_fwd(const float* phiinv, const float* m0, float* out,
                                       float* mw, int* flag, int N, int Nm, int H, int W,
                                       void* stream) {
  lagomorph::ad_star2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, m0, out, mw, flag, N, Nm,
                                                            H, W);
  return (int)cudaGetLastError();
}

// d_mw: (N, 2, H, W) scratch; d_m0: m0's shape
extern "C" int lagomorph_ad_star2d_bwd(const float* phiinv, const float* m0, const float* g,
                                       const float* mw, float* d_mw, float* d_phiinv,
                                       float* d_m0, int N, int Nm, int H, int W, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  lagomorph::ad_star2d_bwd_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(
      phiinv, m0, g, mw, d_mw, d_phiinv, N, Nm, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  lagomorph::ad_star2d_bwd_m0_kernel<<<grid_for((long)Nm * H * W), kThreads, 0, st>>>(
      phiinv, d_mw, d_m0, N, Nm, H, W);
  return (int)cudaGetLastError();
}

extern "C" int lagomorph_compose2d_fwd(const float* phiinv, const float* v, float s, float* out,
                                       int* flag, int N, int H, int W, void* stream) {
  lagomorph::compose2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, v, s, out, flag, N, H, W);
  return (int)cudaGetLastError();
}

extern "C" int lagomorph_compose2d_bwd(const float* phiinv, const float* v, float s,
                                       const float* g, float* d_phiinv, float* d_v, int N,
                                       int H, int W, void* stream) {
  lagomorph::compose2d_bwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, v, s, g, d_phiinv, d_v, N,
                                                            H, W);
  return (int)cudaGetLastError();
}
