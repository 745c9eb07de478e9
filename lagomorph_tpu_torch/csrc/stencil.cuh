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

#include <atomic>

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

// The unit regime's three weights of one axis, for the warp backward's pass
// (warp_unit.cu), which forms them from the staged displacement at each use:
// max(-d, 0), 1 - |d| and max(d, 0) for d in [-1, 1), zeros outside it (a
// NaN d gives a NaN middle weight).  In the unit regime they equal
// axis_weights' but for the offset -1, which is -d here and 1 - (d + 1)
// there (an ulp of 1 apart at most).
__device__ __forceinline__ AxisWeights unit_weights(float d) {
  const bool out = d < -1.0f || d >= 1.0f;
  AxisWeights w;
  w.m = out ? 0.0f : fmaxf(-d, 0.0f);
  w.z = out ? 0.0f : __fsub_rn(1.0f, fabsf(d));
  w.p = out ? 0.0f : fmaxf(d, 0.0f);
  return w;
}

// The two live taps of one axis from unit_weights: offsets lo and lo + 1
// (lo = -1 for d < 0) with weights w[0], w[1], zeros outside the unit
// regime (`in` false there; the slopes of both weights are -1 and +1
// inside it)
struct UnitPair {
  int lo;
  float w[2];
  bool in;
};

__device__ __forceinline__ UnitPair unit_pair(float d) {
  UnitPair p;
  p.in = !(d < -1.0f || d >= 1.0f);
  const bool neg = d < 0.0f;
  p.lo = neg ? -1 : 0;
  const float mid = __fsub_rn(1.0f, fabsf(d));
  p.w[0] = p.in ? (neg ? -d : mid) : 0.0f;
  p.w[1] = p.in ? (neg ? mid : d) : 0.0f;
  return p;
}

}  // namespace lagomorph

// ---------------------------------------------------------------------------
// Host helpers of the launchers (warp_unit.cu, epdiff_unit.cu).
// ---------------------------------------------------------------------------
namespace lagomorph {

// The value `ask(device, &value)` gives for the current device, asked once
// per device and kept in `cache` (0: not asked yet); `fallback` when there
// is no device to ask or asking fails
constexpr int kDevices = 64;

template <class Ask>
static int per_device(std::atomic<int>* cache, int fallback, Ask ask) {
  int dev = 0, v = fallback;
  if (cudaGetDevice(&dev) == cudaSuccess && dev >= 0 && dev < kDevices) {
    v = cache[dev].load(std::memory_order_relaxed);
    if (v == 0) {
      if (ask(dev, &v) != cudaSuccess || v <= 0)
        v = fallback;
      else
        cache[dev].store(v, std::memory_order_relaxed);
    }
  }
  return v;
}

// The warp backward's pass (warp_unit.cu), which K5, K6 and K7 launch: the
// gather-form transpose of the warp at displacement s * disp,
//   out_t[nI, c](v) = sum_{n of nI} sum_{(u, o): clamp(u + o) == v}
//                     w_o(s * disp[n](u)) * cot[n, c](u)
// (NI == 1 < N sums the N subjects), and, when I is not null, the weight
// gradient
//   dd_a(p) = sum_o dw_a(o_a) prod_{b != a} w_b(o_b) sum_c cot_c(p) I_c[clamp(p + o)]
// into out_dd: dd_a, or s * cot_a + s * dd_a when `compose` (the d_v of the
// compose step, C == 3).  Launches on `stream`, returns cudaGetLastError().
cudaError_t launch_warp_bwd(const float* I, const float* disp, float s, const float* cot,
                            float* out_t, float* out_dd, int N, int NI, int C, int X, int Y,
                            int Z, bool compose, cudaStream_t stream);

}  // namespace lagomorph
