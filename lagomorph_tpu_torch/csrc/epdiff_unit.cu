// K1 and K2: the two stencil steps of one EPDiff substep, forward, each
// with the unit-regime flag of its warp displacement.
//
// K1, Ad* (the momentum transport):
//   mw_a(p)  = sum_o w_o(phiinv(p)) * m0_a(clamp(p + o))        (unit warp)
//   out_c(p) = sum_a (D_a phiinv_c(p) + delta_ca) * mw_a(p)      (Jacobian)
//   flag     = all components of phiinv in [-1, 1)
// i.e. jacobian_times_vectorfield(phiinv, sample_displacement_unit(m0,
// phiinv), displacement=True), without transpose.  Replaces
// lagomorph_tpu/ops/pallas/epdiff_unit.py `_adstar_fwd_kernel[_mw]`
// (whole-Y, `_adstar_fwd_wholey`), `_adstar_fwd_kernel_yb[_mw]` /
// `_adstar_yb_fwd_body` (y-blocked, `_adstar_fwd_yb`), and the padded-
// resident lagomorph_tpu/ops/pallas/padres.py `_adstar_fwd_kernel_pr[_mw]`
// (`_adstar_fwd_pr`), whose in-kernel flag (padres.py:211-227) is K1's flag.
//
// K2, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)                                           (float32)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff_unit.py `_compose_fwd_kernel[_yb]` / `_compose_yb_fwd_body`
// (`_compose_fwd_dispatch`) and padres.py `_compose_fwd_kernel_pr`
// (`_compose_fwd_pr`, `_store_padded`).
//
// Not carried over: padres.py keeps phiinv in a padded (N,3,X+16,(Y+4)*Z)
// layout through the whole shooting loop.  That layout exists only for the
// TPU's (8,128) DMA alignment (padres.py:1-12, 58-59); here taps clamp in the
// kernel and the carry stays (N,3,X,Y,Z).  The TPU carries the flag as a
// running min from one sequential grid step to the next; Hopper's blocks run
// in no order, so the flag is an int32 in device memory that the wrapper
// sets to 1 and any warp that sees an out-of-range component clears with
// atomicAnd.
//
// Bound on the H100: memory.  K1 reads phiinv and m0 and writes out (three
// 100.7 MB fields at 128^3 b4, m0 read with batch stride 0 when its batch is
// 1); K2 reads phiinv and v and writes out (three fields).  The 27 taps and
// the 6 difference neighbours come from L1/L2.  Design: one thread per voxel,
// z fastest across the warp; weights and tap offsets computed once per voxel
// and reused for all three channels; the flag costs one ballot per warp and
// at most one atomic per warp.
#include "stencil.cuh"

namespace lagomorph {

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

__global__ void ad_star_fwd_kernel(const float* __restrict__ phiinv,
                                   const float* __restrict__ m0,
                                   float* __restrict__ out, int* flag, int N,
                                   int Nm, int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));
    const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);

    const float* ph = phiinv + (long)n * 3 * V;
    const float d0 = ph[p], d1 = ph[V + p], d2 = ph[2 * V + p];
    bad = !(in_unit(d0) && in_unit(d1) && in_unit(d2));

    AxisWeights W[3] = {axis_weights(d0), axis_weights(d1), axis_weights(d2)};
    Taps T;
    make_taps(T, W, ix, iy, iz, Y, Z);
    const float* mb = m0 + (Nm == 1 ? 0L : (long)n * 3 * V);
    float mw[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) mw[a] = warp_sum(T, mb + (long)a * V);

    // out_c = sum_a (g_ca [+1 if a == c]) * mw_a, accumulated over a in order
    const AxisIdx* ax[3] = {&ix, &iy, &iz};
    const int stride[3] = {Y * Z, Z, 1};
    float* o = out + (long)n * 3 * V + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float g = diff_central(ph + (long)c * V, p, *ax[a], stride[a]);
        if (a == c) g = __fadd_rn(g, 1.0f);
        const float term = __fmul_rn(g, mw[a]);
        acc = a == 0 ? term : __fadd_rn(acc, term);
      }
      o[(long)c * V] = acc;
    }
  }
  clear_flag_if(bad, flag);
}

__global__ void compose_fwd_kernel(const float* __restrict__ phiinv,
                                   const float* __restrict__ v, float s,
                                   float* __restrict__ out, int* flag, int N,
                                   int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));

    const float* vb = v + (long)n * 3 * V + p;
    const float d0 = __fmul_rn(s, vb[0]);
    const float d1 = __fmul_rn(s, vb[V]);
    const float d2 = __fmul_rn(s, vb[2 * V]);
    bad = !(in_unit(d0) && in_unit(d1) && in_unit(d2));

    AxisWeights W[3] = {axis_weights(d0), axis_weights(d1), axis_weights(d2)};
    Taps T;
    make_taps(T, W, axis_idx(x, X), axis_idx(y, Y), axis_idx(z, Z), Y, Z);
    const float* ph = phiinv + (long)n * 3 * V;
    float* o = out + (long)n * 3 * V + p;
    o[0] = __fadd_rn(d0, warp_sum(T, ph));
    o[V] = __fadd_rn(d1, warp_sum(T, ph + V));
    o[2 * V] = __fadd_rn(d2, warp_sum(T, ph + 2 * V));
  }
  clear_flag_if(bad, flag);
}

}  // namespace lagomorph

static inline unsigned grid_for(long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

extern "C" int lagomorph_ad_star_fwd(const float* phiinv, const float* m0,
                                     float* out, int* flag, int N, int Nm,
                                     int X, int Y, int Z, void* stream) {
  const int threads = 256;
  lagomorph::ad_star_fwd_kernel<<<grid_for((long)N * X * Y * Z, threads),
                                  threads, 0, (cudaStream_t)stream>>>(
      phiinv, m0, out, flag, N, Nm, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" int lagomorph_compose_fwd(const float* phiinv, const float* v,
                                     float s, float* out, int* flag, int N,
                                     int X, int Y, int Z, void* stream) {
  const int threads = 256;
  lagomorph::compose_fwd_kernel<<<grid_for((long)N * X * Y * Z, threads),
                                  threads, 0, (cudaStream_t)stream>>>(
      phiinv, v, s, out, flag, N, X, Y, Z);
  return (int)cudaGetLastError();
}
