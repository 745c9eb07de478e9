// Per-pixel math of the 2D unit-regime stencils, forward and backward, for
// the 2D whole-shoot kernels (shoot2d.cu) and any per-op 2D kernel.
//
// Port of the tap math of lagomorph_tpu/ops/pallas/epdiff2d.py (`_w2`,
// `_dw2` at :75-96, the CLAMP taps `_ztap` at :103-109) and of the
// whole-plane bodies of lagomorph_tpu/ops/pallas/shoot2d.py (`_adstar_body`
// :149-169, `_compose_body` :172-186, `_adstar_bwd_body` :206-289,
// `_compose_bwd_body` :292-344).  The TPU bodies roll whole (H, W) planes
// with edge fixes; here each function computes one pixel (i, j) of one
// subject from the planes around it, clamping its taps.
//
// A field of one subject is two planes of H * W floats (channel c at
// f + c * H * W, pixel (i, j) at i * W + j).  The discretization is that of
// the plain PyTorch versions (ops/sampling.py sample_displacement_unit,
// ops/boundary.py diff_central): per-axis weights from floor/frac of the
// displacement for floor -1 and 0 only, 9 taps at clamp(p + o), the clamped
// central difference.  Every product and sum is rounded on its own (no
// fused multiply-add), in the order of the plain versions, so the forward
// functions reproduce their float32 arithmetic term by term.  Functions are
// __host__ __device__ so that the same code runs on the host in tests.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace lagomorph {
namespace s2d {

// float operations rounded on their own (no contraction into an FMA)
__host__ __device__ __forceinline__ float mul(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fmul_rn(a, b);
#else
  return a * b;
#endif
}
__host__ __device__ __forceinline__ float add(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fadd_rn(a, b);
#else
  return a + b;
#endif
}
__host__ __device__ __forceinline__ float sub(float a, float b) {
#ifdef __CUDA_ARCH__
  return __fsub_rn(a, b);
#else
  return a - b;
#endif
}

// weights (or their slopes) of the taps at offsets -1, 0, +1 along one axis
struct W3 {
  float m, z, p;
};

__host__ __device__ __forceinline__ float at(const W3& w, int o) {
  return o < 0 ? w.m : (o == 0 ? w.z : w.p);
}

// `_w2`: w_-1 = [f == -1](1 - t), w_0 = [f == -1] t + [f == 0](1 - t),
// w_+1 = [f == 0] t, with f = floor(d), t = d - f
__host__ __device__ __forceinline__ W3 weights(float d) {
  const float f = floorf(d);
  const float t = sub(d, f);
  const float is_m1 = (f == -1.0f) ? 1.0f : 0.0f;
  const float is_0 = (f == 0.0f) ? 1.0f : 0.0f;
  const float omt = sub(1.0f, t);
  W3 w;
  w.m = mul(is_m1, omt);
  w.z = add(mul(is_m1, t), mul(is_0, omt));
  w.p = mul(is_0, t);
  return w;
}

// `_dw2`: the weights' slopes in d (t has slope 1, the masks none)
__host__ __device__ __forceinline__ W3 slopes(float d) {
  const float f = floorf(d);
  const float is_m1 = (f == -1.0f) ? 1.0f : 0.0f;
  const float is_0 = (f == 0.0f) ? 1.0f : 0.0f;
  W3 w;
  w.m = -is_m1;
  w.z = sub(is_m1, is_0);
  w.p = is_0;
  return w;
}

// the unit regime of one displacement value: [-1, 1) (NaN is outside)
__host__ __device__ __forceinline__ bool in_unit(float d) { return d >= -1.0f && d < 1.0f; }

__host__ __device__ __forceinline__ int clampi(int i, int n) {
  return i < 0 ? 0 : (i > n - 1 ? n - 1 : i);
}

// sum over the 9 taps of (wx * wy) * f[clamp(i + ox), clamp(j + oy)], in
// tap order (ox, then oy), as the plain warp accumulates
__host__ __device__ __forceinline__ float warp(const float* f, const W3& wx, const W3& wy,
                                               int H, int W, int i, int j) {
  float acc = 0.0f;
  for (int ox = -1; ox <= 1; ++ox) {
    const float* row = f + (long)clampi(i + ox, H) * W;
    const float w0 = at(wx, ox);
    for (int oy = -1; oy <= 1; ++oy) {
      const float term = mul(mul(w0, at(wy, oy)), row[clampi(j + oy, W)]);
      acc = (ox == -1 && oy == -1) ? term : add(acc, term);
    }
  }
  return acc;
}

// the central difference from the values at the two neighbours
__host__ __device__ __forceinline__ float central(float hi, float lo) {
  return mul(0.5f, sub(hi, lo));
}

// `warp` on the live taps alone: where floor(d) is -1 or 0 only the offsets
// lo and lo + 1 of an axis can weigh anything (lo = floor(d); elsewhere all
// three weights are zero, and lo = 0 sums two of them), so the 4 taps
// (lx, ly) .. (lx + 1, ly + 1) are summed in the 9-tap order, each term
// rounded as there.  The skipped terms are exact zeros (a zero weight
// times a finite value), which leave a sum unchanged: the result is the
// 9-tap sum's, but for the sign of a zero result.
__host__ __device__ __forceinline__ int live_lo(float d) { return floorf(d) == -1.0f ? -1 : 0; }

// The sum of the 4 live taps, tap(a, b) giving the value f[clamp(i + lx +
// a), clamp(j + ly + b)] (a, b in {0, 1}): `warp_live`'s arithmetic, for
// callers that hold the taps elsewhere too (K10 and K11 select them from
// register rings)
template <class Tap>
__host__ __device__ __forceinline__ float live_sum(const W3& wx, const W3& wy, int lx, int ly,
                                                   Tap tap) {
  float acc = 0.0f;
  for (int a = 0; a < 2; ++a) {
    const float w0 = at(wx, lx + a);
    for (int b = 0; b < 2; ++b) {
      const float term = mul(mul(w0, at(wy, ly + b)), tap(a, b));
      acc = (a == 0 && b == 0) ? term : add(acc, term);
    }
  }
  return acc;
}

__host__ __device__ __forceinline__ float warp_live(const float* f, const W3& wx, const W3& wy,
                                                    int lx, int ly, int H, int W, int i, int j) {
  return live_sum(wx, wy, lx, ly, [&](int a, int b) {
    const float* row = f + (long)clampi(i + lx + a, H) * W;
    return row[clampi(j + ly + b, W)];
  });
}

// `warp` (LIVE false) or `warp_live` at the displacement (d0, d1)
template <bool LIVE>
__host__ __device__ __forceinline__ float warp_at(const float* f, const W3& wx, const W3& wy,
                                                  float d0, float d1, int H, int W, int i, int j) {
  if constexpr (LIVE) {
    return warp_live(f, wx, wy, live_lo(d0), live_lo(d1), H, W, i, j);
  } else {
    return warp(f, wx, wy, H, W, i, j);
  }
}

// clamped central difference of plane f along axis a (0: H, 1: W) at (i, j)
__host__ __device__ __forceinline__ float diff(const float* f, int a, int H, int W, int i, int j) {
  float hi, lo;
  if (a == 0) {
    hi = f[(long)clampi(i + 1, H) * W + j];
    lo = f[(long)clampi(i - 1, H) * W + j];
  } else {
    hi = f[(long)i * W + clampi(j + 1, W)];
    lo = f[(long)i * W + clampi(j - 1, W)];
  }
  return central(hi, lo);
}

// D^T, the exact transpose of the clamped central difference along one
// axis, at index i of n, from the values q at i - 1, i, i + 1 (those
// outside [0, n) are not read): -0.5 (q0 + qp) at i == 0, 0.5 (q0 + qm) at
// i == n - 1, 0.5 (qm - qp) inside
__host__ __device__ __forceinline__ float diff_adjoint(float qm, float q0, float qp, int i, int n) {
  if (i == 0) return mul(-0.5f, add(q0, qp));
  if (i == n - 1) return mul(0.5f, add(q0, qm));
  return mul(0.5f, sub(qm, qp));
}

// The transposed taps along one axis: the pairs (u, o) with clamp(u + o)
// == v.  Slot k (0..2) has offset o = k - 1 and source u = v - o when u
// lies in [0, n); otherwise the slot holds the clamp fold u = v, o = -(k -
// 1).  Every axis has exactly three pairs, edges included.
__host__ __device__ __forceinline__ void transposed_tap(int v, int n, int k, int& u, int& o) {
  o = k - 1;
  u = v - o;
  if (u < 0 || u >= n) {
    u = v;
    o = -o;
  }
}

// ---------------------------------------------------------------------------
// Forward.
// ---------------------------------------------------------------------------

// out_c = sum_a (jac[c][a] + delta_ca) mw_a, summed over a in order: Ad*'s
// Jacobian step from the differences jac[c][a] = D_a phiinv_c
__host__ __device__ __forceinline__ void jac_apply(const float jac[2][2], const float mw[2],
                                                   float out[2]) {
  for (int c = 0; c < 2; ++c) {
    float acc = 0.0f;
    for (int a = 0; a < 2; ++a) {
      float g = jac[c][a];
      if (a == c) g = add(g, 1.0f);
      const float term = mul(g, mw[a]);
      acc = a == 0 ? term : add(acc, term);
    }
    out[c] = acc;
  }
}

// Ad* at (i, j) (`_adstar_body`): mw_a = warp of m0_a at phiinv(i, j);
// out_c = sum_a (D_a phiinv_c + delta_ca) mw_a, summed over a in order.
// `phi` and `m0` are one subject's fields.  Returns whether phiinv(i, j)
// lies in the unit regime.  LIVE: the warp on the live taps alone.
// The same from phiinv's value (d0, d1) at (i, j) and its differences
// jac[c][a] = D_a phiinv_c there, for a caller that holds phiinv elsewhere;
// LIVE: the warp on the live taps alone (`warp_live`).
template <bool LIVE = false>
__host__ __device__ __forceinline__ void adstar_jac(const float* m0, float d0, float d1,
                                                    const float jac[2][2], int H, int W, int i,
                                                    int j, float out[2], float mw[2]) {
  const long HW = (long)H * W;
  const W3 wx = weights(d0), wy = weights(d1);
  mw[0] = warp_at<LIVE>(m0, wx, wy, d0, d1, H, W, i, j);
  mw[1] = warp_at<LIVE>(m0 + HW, wx, wy, d0, d1, H, W, i, j);
  jac_apply(jac, mw, out);
}

template <bool LIVE = false>
__host__ __device__ __forceinline__ bool adstar(const float* phi, const float* m0, int H, int W,
                                                int i, int j, float out[2], float mw[2]) {
  const long HW = (long)H * W;
  const long p = (long)i * W + j;
  const float d0 = phi[p], d1 = phi[HW + p];
  float jac[2][2];
  for (int c = 0; c < 2; ++c)
    for (int a = 0; a < 2; ++a) jac[c][a] = diff(phi + c * HW, a, H, W, i, j);
  adstar_jac<LIVE>(m0, d0, d1, jac, H, W, i, j, out, mw);
  return in_unit(d0) && in_unit(d1);
}

// compose at (i, j) (`_compose_body`), from the velocity v(i, j) = (v0,
// v1): d = s v; out_c = d_c + warp of phiinv_c at d.  Returns whether d
// lies in the unit regime.  LIVE: the warp on the live taps alone.
template <bool LIVE = false>
__host__ __device__ __forceinline__ bool compose(const float* phi, float v0, float v1, float s,
                                                 int H, int W, int i, int j, float out[2]) {
  const long HW = (long)H * W;
  const float d0 = mul(s, v0), d1 = mul(s, v1);
  const W3 wx = weights(d0), wy = weights(d1);
  out[0] = add(d0, warp_at<LIVE>(phi, wx, wy, d0, d1, H, W, i, j));
  out[1] = add(d1, warp_at<LIVE>(phi + HW, wx, wy, d0, d1, H, W, i, j));
  return in_unit(d0) && in_unit(d1);
}

// ---------------------------------------------------------------------------
// Backward.
// ---------------------------------------------------------------------------

// The gather form of the warp's transpose at (i, j): out_c = sum over the
// taps (u, o) landing on (i, j) of w_o(s * disp(u)) cot_c(u).  One
// subject's fields; a caller summing over subjects adds the results.
__host__ __device__ __forceinline__ void warp_transpose(const float* disp, float s, const float* cot,
                                                        int H, int W, int i, int j, float out[2]) {
  const long HW = (long)H * W;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int kx = 0; kx < 3; ++kx) {
    int ux, ox;
    transposed_tap(i, H, kx, ux, ox);
    for (int ky = 0; ky < 3; ++ky) {
      int uy, oy;
      transposed_tap(j, W, ky, uy, oy);
      const long u = (long)ux * W + uy;
      const float wx = at(weights(mul(s, disp[u])), ox);
      const float wy = at(weights(mul(s, disp[HW + u])), oy);
      const float w = mul(wx, wy);
      acc0 = add(acc0, mul(w, cot[u]));
      acc1 = add(acc1, mul(w, cot[HW + u]));
    }
  }
  out[0] = acc0;
  out[1] = acc1;
}

// The weight-gradient path at (i, j): dd_a = sum_o dw_a(o_a) w_b(o_b)
// <cot(i, j), I(clamp((i, j) + o))>, b != a, for the displacement at (i, j)
// whose weights are (wx, wy) and slopes (sx, sy), and the two-channel image
// I of one subject.
__host__ __device__ __forceinline__ void weight_grad_w(const float* I, const W3& wx, const W3& wy,
                                                       const W3& sx, const W3& sy, float c0,
                                                       float c1, int H, int W, int i, int j,
                                                       float dd[2]) {
  const long HW = (long)H * W;
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int ox = -1; ox <= 1; ++ox) {
    const long row = (long)clampi(i + ox, H) * W;
    for (int oy = -1; oy <= 1; ++oy) {
      const long q = row + clampi(j + oy, W);
      const float gI = add(mul(c0, I[q]), mul(c1, I[HW + q]));
      acc0 = add(acc0, mul(mul(at(sx, ox), at(wy, oy)), gI));
      acc1 = add(acc1, mul(mul(at(wx, ox), at(sy, oy)), gI));
    }
  }
  dd[0] = acc0;
  dd[1] = acc1;
}

// the same for the displacement (d0, d1)
__host__ __device__ __forceinline__ void weight_grad(const float* I, float d0, float d1, float c0,
                                                     float c1, int H, int W, int i, int j,
                                                     float dd[2]) {
  weight_grad_w(I, weights(d0), weights(d1), slopes(d0), slopes(d1), c0, c1, H, W, i, j, dd);
}

// compose backward at (i, j) (`_compose_bwd_body`), cotangent g of the
// composed field: d_phi = warp transpose of g at weights(s v); d_v = s g +
// s * (weight-gradient path, image phiinv, cotangent g(i, j)).
__host__ __device__ __forceinline__ void compose_bwd(const float* phi, const float* v, float s,
                                                     const float* g, int H, int W, int i, int j,
                                                     float d_phi[2], float d_v[2]) {
  const long HW = (long)H * W;
  const long p = (long)i * W + j;
  warp_transpose(v, s, g, H, W, i, j, d_phi);
  const float g0 = g[p], g1 = g[HW + p];
  float dd[2];
  weight_grad(phi, mul(s, v[p]), mul(s, v[HW + p]), g0, g1, H, W, i, j, dd);
  d_v[0] = add(mul(s, g0), mul(s, dd[0]));
  d_v[1] = add(mul(s, g1), mul(s, dd[1]));
}

// Ad* backward, first part at (i, j): d_mw_a = sum_c (D_a phiinv_c +
// delta_ca) g_c, summed over c in order ((J + I)^T g), from the cotangent
// (g0, g1) at (i, j).
__host__ __device__ __forceinline__ void adstar_bwd_dmw(const float* phi, float g0, float g1,
                                                        int H, int W, int i, int j,
                                                        float d_mw[2]) {
  const long HW = (long)H * W;
  const float gc[2] = {g0, g1};
  for (int a = 0; a < 2; ++a) {
    float acc = 0.0f;
    for (int c = 0; c < 2; ++c) {
      float jac = diff(phi + c * HW, a, H, W, i, j);
      if (a == c) jac = add(jac, 1.0f);
      const float term = mul(jac, gc[c]);
      acc = c == 0 ? term : add(acc, term);
    }
    d_mw[a] = acc;
  }
}

// Ad* backward, d_phiinv at (i, j): the weight-gradient path (image m0,
// cotangent d_mw(i, j)) plus the divergence path sum_a D_a^T (g * mw_a),
// from the cotangent g and the warped momentum mw of one subject.
__host__ __device__ __forceinline__ void adstar_bwd_dphi(const float* phi, const float* m0,
                                                         const float* g, const float* mw,
                                                         float dmw0, float dmw1, int H, int W,
                                                         int i, int j, float d_phi[2]) {
  const long HW = (long)H * W;
  const long p = (long)i * W + j;
  float wg[2];
  weight_grad(m0, phi[p], phi[HW + p], dmw0, dmw1, H, W, i, j, wg);
  const int pos[2] = {i, j};
  const int len[2] = {H, W};
  const long stride[2] = {W, 1};
  for (int c = 0; c < 2; ++c) {
    const float* q = g + c * HW;
    float div = 0.0f;
    for (int a = 0; a < 2; ++a) {
      const float* w = mw + a * HW;
      const long lo = p - (pos[a] > 0 ? stride[a] : 0);
      const long hi = p + (pos[a] < len[a] - 1 ? stride[a] : 0);
      const float term = diff_adjoint(mul(w[lo], q[lo]), mul(w[p], q[p]), mul(w[hi], q[hi]),
                                      pos[a], len[a]);
      div = a == 0 ? term : add(div, term);
    }
    d_phi[c] = add(wg[c], div);
  }
}

}  // namespace s2d
}  // namespace lagomorph
