// Per-voxel math shared by the unit-regime stencil kernels (warp_unit.cu,
// epdiff_unit.cu), forward and backward.
//
// The discretization is that of the JAX package's
// ops/sampling.py::sample_displacement_unit and ops/boundary.py::diff_central:
//   * per-axis weights from floor/frac of the displacement, for f == -1 and
//     f == 0 only (sampling.py:196-205); any other floor gives weight 0;
//   * 27 taps at clamp(p + o), o in {-1,0,1}^3 (CLAMP boundary, floor then
//     clamp);
//   * the clamped central difference 0.5 * (a[clamp(i+1)] - a[clamp(i-1)]),
//     which at an edge is the one-sided half-difference of boundary.py:61-64.
// Every product and sum is rounded on its own (__fmul_rn / __fadd_rn: no
// fused multiply-add), in the order of the plain PyTorch versions, so the
// kernels reproduce those versions' float32 arithmetic term by term.
#pragma once

#include <cuda_runtime.h>

namespace lagomorph {

// weights of the taps at offsets -1, 0, +1 along one axis
struct AxisWeights {
  float m, z, p;
};

__device__ __forceinline__ AxisWeights axis_weights(float d) {
  const float f = floorf(d);
  const float t = __fsub_rn(d, f);
  const float is_m1 = (f == -1.0f) ? 1.0f : 0.0f;
  const float is_0 = (f == 0.0f) ? 1.0f : 0.0f;
  const float omt = __fsub_rn(1.0f, t);
  AxisWeights w;
  w.m = __fmul_rn(is_m1, omt);
  w.z = __fadd_rn(__fmul_rn(is_m1, t), __fmul_rn(is_0, omt));
  w.p = __fmul_rn(is_0, t);
  return w;
}

// The two live taps of one axis: offsets lo and lo + 1 with lo = -1 when
// floor(d) == -1 and 0 otherwise, and their weights from axis_weights (so
// (1 - t, t) in the unit regime; (0, 0) for a finite d outside it, where
// all three weights vanish; NaN for a NaN d, as the 27-tap sum gives).  The
// third offset's weight is structurally zero (or NaN with the other two).
struct LivePair {
  int lo;
  float wl, wh;
};

__device__ __forceinline__ LivePair live_pair(float d) {
  const AxisWeights w = axis_weights(d);
  LivePair p;
  const bool m1 = floorf(d) == -1.0f;
  p.lo = m1 ? -1 : 0;
  p.wl = m1 ? w.m : w.z;
  p.wh = m1 ? w.z : w.p;
  return p;
}

__device__ __forceinline__ int clampi(int i, int n) { return i < 0 ? 0 : (i >= n ? n - 1 : i); }

// the unit regime of one displacement value: [-1, 1) (NaN is outside)
__device__ __forceinline__ bool in_unit(float d) { return d >= -1.0f && d < 1.0f; }

// ---------------------------------------------------------------------------
// Backward math.
// ---------------------------------------------------------------------------

// derivatives of the per-axis weights with respect to the displacement
// (warp_unit.py:422-429, `dw_s`): t = d - floor(d) has slope 1 and the floor
// masks are constant, so dw_-1 = -[f == -1], dw_0 = [f == -1] - [f == 0],
// dw_+1 = [f == 0]
__device__ __forceinline__ AxisWeights axis_dweights(float d) {
  const float f = floorf(d);
  const float is_m1 = (f == -1.0f) ? 1.0f : 0.0f;
  const float is_0 = (f == 0.0f) ? 1.0f : 0.0f;
  AxisWeights w;
  w.m = -is_m1;
  w.z = __fsub_rn(is_m1, is_0);
  w.p = is_0;
  return w;
}

// D^T, the exact transpose of the clamped central difference along one
// axis (ops/boundary.py::diff_central_adjoint), at index i of n, from the
// values q at i - 1, i, i + 1 (those outside [0, n) are not read):
//   i == 0:     -0.5 * (q[0] + q[1])
//   interior:    0.5 * (q[i-1] - q[i+1])
//   i == n - 1:  0.5 * (q[n-1] + q[n-2])
__device__ __forceinline__ float diff_central_adjoint(float qm, float q0, float qp,
                                                      int i, int n) {
  if (i == 0) return __fmul_rn(-0.5f, __fadd_rn(q0, qp));
  if (i == n - 1) return __fmul_rn(0.5f, __fadd_rn(q0, qm));
  return __fmul_rn(0.5f, __fsub_rn(qm, qp));
}

}  // namespace lagomorph

// ---------------------------------------------------------------------------
// Host launchers of the two warp-backward passes, defined in warp_unit.cu and
// shared by the backward entry points of warp_unit.cu and epdiff_unit.cu.
// Each launches on `stream` and returns cudaGetLastError().
// ---------------------------------------------------------------------------
namespace lagomorph {

// out[nI, c](v) = sum_{n of nI} sum_{(u, o): clamp(u + o) == v}
//                 w_o(s * disp[n](u)) * cot[n, c](u)
// (the gather-form transpose of the warp; NI == 1 < N sums the N subjects)
cudaError_t launch_warp_transpose(const float* disp, float s, const float* cot,
                                  float* out, int N, int NI, int C, int X, int Y,
                                  int Z, cudaStream_t stream);

// dd_a(p) = sum_o dw_a(o_a) prod_{b != a} w_b(o_b) sum_c cot_c(p) I_c[clamp(p + o)]
// at displacement s * disp; out_a = dd_a, or s * cot_a + s * dd_a when
// `compose` (the d_v of the compose step, C == 3)
cudaError_t launch_warp_dd(const float* I, const float* disp, float s,
                           const float* cot, float* out, int N, int NI, int C,
                           int X, int Y, int Z, bool compose, cudaStream_t stream);

}  // namespace lagomorph
