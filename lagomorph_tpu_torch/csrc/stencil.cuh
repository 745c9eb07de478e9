// Per-voxel math shared by the unit-regime stencil kernels (warp_unit.cu,
// epdiff_unit.cu).
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

__device__ __forceinline__ float weight_at(const AxisWeights& w, int o) {
  return o < 0 ? w.m : (o == 0 ? w.z : w.p);
}

// clamped neighbour indices along one axis: idx[0..2] = clamp(i-1), i, clamp(i+1)
struct AxisIdx {
  int i[3];
};

__device__ __forceinline__ AxisIdx axis_idx(int i, int n) {
  AxisIdx a;
  a.i[0] = i > 0 ? i - 1 : 0;
  a.i[1] = i;
  a.i[2] = i < n - 1 ? i + 1 : n - 1;
  return a;
}

// The precomputed 27 tap weights ((wx * wy) * wz) and linear offsets of one
// output voxel, in the order ox, oy, oz = -1, 0, 1 (z fastest).
struct Taps {
  float w[27];
  int off[27];
};

__device__ __forceinline__ void make_taps(Taps& T, const AxisWeights* W,
                                          const AxisIdx& ix, const AxisIdx& iy,
                                          const AxisIdx& iz, int Y, int Z) {
  int q = 0;
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const float wx = weight_at(W[0], ox - 1);
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const float wxy = __fmul_rn(wx, weight_at(W[1], oy - 1));
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        T.w[q] = __fmul_rn(wxy, weight_at(W[2], oz - 1));
        T.off[q] = (ix.i[ox] * Y + iy.i[oy]) * Z + iz.i[oz];
        ++q;
      }
    }
  }
}

// sum over the 27 taps of w * f[off], accumulated in tap order
__device__ __forceinline__ float warp_sum(const Taps& T, const float* __restrict__ f) {
  float acc = __fmul_rn(T.w[0], __ldg(f + T.off[0]));
#pragma unroll
  for (int q = 1; q < 27; ++q) acc = __fadd_rn(acc, __fmul_rn(T.w[q], __ldg(f + T.off[q])));
  return acc;
}

// clamped central difference of f along one axis at voxel `center`;
// `stride` is the axis stride, ix its clamped neighbour indices relative
// to index i
__device__ __forceinline__ float diff_central(const float* __restrict__ f, long center,
                                              const AxisIdx& a, int stride) {
  const float hi = __ldg(f + center + (long)(a.i[2] - a.i[1]) * stride);
  const float lo = __ldg(f + center + (long)(a.i[0] - a.i[1]) * stride);
  return __fmul_rn(0.5f, __fsub_rn(hi, lo));
}

// the unit regime of one displacement value: [-1, 1) (NaN is outside)
__device__ __forceinline__ bool in_unit(float d) { return d >= -1.0f && d < 1.0f; }

}  // namespace lagomorph
