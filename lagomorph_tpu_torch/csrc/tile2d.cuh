// The 2D stencils on row tiles staged in shared memory, shared by the
// whole-shoot backward K9 (shoot2d.cu, its phases 1 and 3) and the
// per-substep backwards K12 and K13 (epdiff2d.cu, which run one such phase
// each as a kernel of its own).
//
// A tile is rows l0 .. l0 + nl - 1 of the N * H rows of all subjects, one
// subject after another, so a tile may straddle two subjects.  Its staged
// rows are those and one halo row on each side, staged row r being row
// l0 - 1 + r (a row outside [0, N H) is not staged): every tap of a pixel
// of the tile, clamped or folded within its subject, lies in a staged row.
// A staged pixel's packed weights sit at w[r * W + c]; a staged two-channel
// value (K9's dm and d_mw, K12's g and d_mw) at r * rs + c * cs (row-major
// where rs = W, cs = 1; K9's tile transforms' layout on its tile path).
//
// The per-pixel arithmetic is csrc/stencil2d.cuh's, every product and sum
// rounded on its own in the same order, and the packed weights hold exactly
// the values `s2d::weights` gives, so a tile function returns what the
// per-pixel functions return at each of its pixels, bit for bit.
#pragma once

#include "stencil2d.cuh"

namespace lagomorph {

// The subjects' geometry: a plane, a field (two planes), the rows of all
// subjects one after another.  Indices within the fields of all subjects
// are ints (the entry points refuse N * 2 * H * W >= 2^31): K9 holds 128
// registers a thread, and a long index takes two.
struct Geo {
  int H, W, HW, F, NH;
};

__host__ __device__ __forceinline__ Geo make_geo(int N, int H, int W) {
  return Geo{H, W, H * W, 2 * H * W, N * H};
}

// One axis's weights of the unit warp at d (`s2d::weights`) packed in two
// floats: (-w_-1, w_0) where floor(d) == -1, else (w_0, w_+1).  Where
// floor(d) == -1, w_-1 = 1 - t is +0 or more, so the sign bit of the first
// value says which (-0 included); elsewhere that value is w_0: 1 - t > 0 at
// floor 0, +0 where every weight is zero.  They are the values
// `s2d::weights` gives, so unpack_axis returns its W3 exactly.
__device__ __forceinline__ float2 pack_axis(float d) {
  const s2d::W3 w = s2d::weights(d);
  return floorf(d) == -1.0f ? make_float2(-w.m, w.z) : make_float2(w.z, w.p);
}

__device__ __forceinline__ float4 pack_weights(float d0, float d1) {
  const float2 a = pack_axis(d0), b = pack_axis(d1);
  return make_float4(a.x, a.y, b.x, b.y);
}

// the weights back from an axis's pair (a zero weight as `s2d::weights`
// computes it: 0 times the other)
__device__ __forceinline__ s2d::W3 unpack_axis(float a, float b) {
  const bool m1 = signbit(a);
  s2d::W3 w;
  w.m = m1 ? -a : s2d::mul(0.0f, a);
  w.z = m1 ? b : a;
  w.p = m1 ? s2d::mul(0.0f, b) : b;
  return w;
}

// `s2d::slopes` at the same d, from the pair's first value: floor -1 where
// its sign bit is set, floor 0 where it is positive
__device__ __forceinline__ s2d::W3 unpack_slopes(float a) {
  const float is_m1 = signbit(a) ? 1.0f : 0.0f;
  const float is_0 = a > 0.0f ? 1.0f : 0.0f;
  s2d::W3 w;
  w.m = -is_m1;
  w.z = s2d::sub(is_m1, is_0);
  w.p = is_0;
  return w;
}

// the packed weights of s * D (D: a field of every subject, s * D(p) the
// displacement the warp takes at p) at the staged pixels of the tile at l0
__device__ __forceinline__ void stage_weights(float4* __restrict__ w, const float* __restrict__ D,
                                              float s, int l0, int nl, const Geo& g) {
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    if (l < 0 || l >= g.NH) continue;
    const int n = l / g.H;
    const int p = n * g.F + (l - n * g.H) * g.W + c;
    w[e] = pack_weights(s2d::mul(s, D[p]), s2d::mul(s, D[p + g.HW]));
  }
}

// The gather form of the warp's transpose at pixel (i, j) of a subject
// whose row 0 is staged row r0 (`s2d::warp_transpose`): the weights of its
// 9 sources (rows i - 1 .. i + 1, all staged) from w, their cotangent from
// cot(row, column).
template <class Cot>
__device__ __forceinline__ void gather_transpose(const float4* w, int r0, int H, int W, int i,
                                                 int j, const Cot& cot, float out[2]) {
  float acc0 = 0.0f, acc1 = 0.0f;
  for (int kx = 0; kx < 3; ++kx) {
    int ux, ox;
    s2d::transposed_tap(i, H, kx, ux, ox);
    for (int ky = 0; ky < 3; ++ky) {
      int uy, oy;
      s2d::transposed_tap(j, W, ky, uy, oy);
      const float4 pw = w[(r0 + ux) * W + uy];
      const float wt = s2d::mul(s2d::at(unpack_axis(pw.x, pw.y), ox),
                                s2d::at(unpack_axis(pw.z, pw.w), oy));
      const float2 c = cot(ux, uy);
      acc0 = s2d::add(acc0, s2d::mul(wt, c.x));
      acc1 = s2d::add(acc1, s2d::mul(wt, c.y));
    }
  }
  out[0] = acc0;
  out[1] = acc1;
}

// the weight gradient at pixel (i, j) (`s2d::weight_grad`) with the
// displacement's weights and slopes from its staged pair
__device__ __forceinline__ void staged_weight_grad(const float* I, const float4& pw, float c0,
                                                   float c1, int H, int W, int i, int j,
                                                   float dd[2]) {
  s2d::weight_grad_w(I, unpack_axis(pw.x, pw.y), unpack_axis(pw.z, pw.w), unpack_slopes(pw.x),
                     unpack_slopes(pw.z), c0, c1, H, W, i, j, dd);
}

// Compose backward (`s2d::compose_bwd`) at each pixel of the tile at l0 (nl
// rows), the weights of s v staged in w: Gn <- d_phi, and d_v to
// put(j, c, q, d_v) for row j of the tile, column c, q its pixel's index in
// the fields; rows nl .. rows - 1 put zeros (q = -1).  K9's phase 1 puts
// d_v into its row transform's buffer, K13 into its output field.
template <class Put>
__device__ __forceinline__ void compose_bwd_rows(const float* __restrict__ P,
                                                 const float* __restrict__ G, float s,
                                                 const float4* __restrict__ w,
                                                 float* __restrict__ Gn, const Put& put, int l0,
                                                 int nl, int rows, const Geo& g) {
  const int total = rows * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / g.W, c = e - j * g.W;
    float2 val = make_float2(0.0f, 0.0f);
    int q = -1;
    if (j < nl) {
      const int l = l0 + j;
      const int n = l / g.H;
      const int i = l - n * g.H;
      const float* Gs = G + n * g.F;
      q = n * g.F + i * g.W + c;
      float d_phi[2];
      gather_transpose(w, n * g.H - (l0 - 1), g.H, g.W, i, c,
                       [&](int u, int v) {
                         const int a = u * g.W + v;
                         return make_float2(Gs[a], Gs[a + g.HW]);
                       },
                       d_phi);
      const float g0 = G[q], g1 = G[q + g.HW];
      float dd[2];
      staged_weight_grad(P + n * g.F, w[(j + 1) * g.W + c], g0, g1, g.H, g.W, i, c, dd);
      val = make_float2(s2d::add(s2d::mul(s, g0), s2d::mul(s, dd[0])),
                        s2d::add(s2d::mul(s, g1), s2d::mul(s, dd[1])));
      Gn[q] = d_phi[0];
      Gn[q + g.HW] = d_phi[1];
    }
    put(j, c, q, val);
  }
}

// K9's phase 1 on the tile at l0: compose_bwd_rows with d_v to
// out[j * rs + c * cs]
__device__ __forceinline__ void compose_bwd_tile(const float* __restrict__ P,
                                                 const float* __restrict__ G, float s,
                                                 const float4* __restrict__ w,
                                                 float* __restrict__ Gn, float2* __restrict__ out,
                                                 int rs, int cs, int l0, int nl, int rows,
                                                 const Geo& g) {
  compose_bwd_rows(P, G, s, w, Gn,
                   [&](int j, int c, int, float2 val) { out[j * rs + c * cs] = val; }, l0, nl,
                   rows, g);
}

// Stage Ad*'s backward on the tile at l0 (`s2d::adstar_bwd_dmw`): at each
// staged pixel the cotangent dm = cot(a, p) (a its staged slot, p its index
// in the fields) to dm, d_mw = (J + I)^T dm to dmw, the packed weights of
// phiinv to w; with dmw_out (a batch-1 m0) the tile's own rows' d_mw also
// to that field.
template <class Cot>
__device__ __forceinline__ void stage_dmw_from(const float* __restrict__ P, const Cot& cot,
                                               float2* __restrict__ dm, float2* __restrict__ dmw,
                                               float4* __restrict__ w, float* __restrict__ dmw_out,
                                               int rs, int cs, int l0, int nl, const Geo& g) {
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    if (l < 0 || l >= g.NH) continue;
    const int n = l / g.H;
    const int i = l - n * g.H;
    const int p = n * g.F + i * g.W + c;
    const int a = r * rs + c * cs;
    const float2 v = cot(a, p);
    dm[a] = v;
    float d[2];
    s2d::adstar_bwd_dmw(P + n * g.F, v.x, v.y, g.H, g.W, i, c, d);
    dmw[a] = make_float2(d[0], d[1]);
    w[e] = pack_weights(P[p], P[p + g.HW]);
    if (dmw_out && r >= 1 && r <= nl) {
      dmw_out[p] = d[0];
      dmw_out[p + g.HW] = d[1];
    }
  }
}

// K9's phase 3, once the inverse row DFT has put the staged rows' dm /
// scale at dm: stage_dmw_from with dm scaled in place
__device__ __forceinline__ void stage_dmw(const float* __restrict__ P, float2* __restrict__ dm,
                                          float2* __restrict__ dmw, float4* __restrict__ w,
                                          float* __restrict__ dmw_out, int rs, int cs, float scale,
                                          int l0, int nl, const Geo& g) {
  stage_dmw_from(P,
                 [&](int a, int) {
                   const float2 v = dm[a];
                   return make_float2(s2d::mul(v.x, scale), s2d::mul(v.y, scale));
                 },
                 dm, dmw, w, dmw_out, rs, cs, l0, nl, g);
}

// D_a^T (dm_c mw_a) along one axis at a pixel, for both channels c
// (`s2d::adstar_bwd_dphi`'s divergence term): mw_a at p and at its
// neighbours lo and hi along the axis (clamped to the subject: p where
// there is none), dm at the same three pixels, the pixel at pos of len
__device__ __forceinline__ void div_axis(const float* __restrict__ mw, int lo, int p, int hi,
                                         float2 dlo, float2 dp, float2 dhi, int pos, int len,
                                         float t[2]) {
  const float wl = mw[lo], wp = mw[p], wh = mw[hi];
  t[0] = s2d::diff_adjoint(s2d::mul(wl, dlo.x), s2d::mul(wp, dp.x), s2d::mul(wh, dhi.x), pos, len);
  t[1] = s2d::diff_adjoint(s2d::mul(wl, dlo.y), s2d::mul(wp, dp.y), s2d::mul(wh, dhi.y), pos, len);
}

// Ad*'s backward on the tile at l0 (nl rows), after stage_dmw(_from):
// its d_phiinv (`s2d::adstar_bwd_dphi`: the weight gradient on m0 at the
// weights of phiinv with the cotangent d_mw, and the divergence terms
// D_a^T (dm_c mw_a), dm at the neighbours from the stage) and, with d_m0
// (batch-N m0), the transposed warp of d_mw at the weights of phiinv, its
// taps from the stage.  ACC (K9's phase 3): Gn += d_phiinv, and d_m0 +=
// the transpose (= it where `first`); else (K12) both stored.
template <bool ACC = true>
__device__ __forceinline__ void adstar_bwd_tile(const float* __restrict__ m0, int Nm,
                                                const float* __restrict__ MW,
                                                const float2* __restrict__ dm,
                                                const float2* __restrict__ dmw,
                                                const float4* __restrict__ w, int rs, int cs,
                                                float* __restrict__ Gn, float* __restrict__ d_m0,
                                                bool first, int l0, int nl, const Geo& g) {
  const int total = nl * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / g.W, c = e - j * g.W;
    const int l = l0 + j;
    const int n = l / g.H;
    const int i = l - n * g.H;
    const int f = n * g.F;
    const int p = i * g.W + c;  // within the subject
    const int r = j + 1;        // its staged row
    const int sp = r * rs + c * cs;
    const float2 cw = dmw[sp];
    float wg[2];
    staged_weight_grad(m0 + (Nm == 1 ? 0 : f), w[r * g.W + c], cw.x, cw.y, g.H, g.W, i, c, wg);
    const float2 dp = dm[sp];
    const float* mw = MW + f;
    float t0[2], t1[2];
    div_axis(mw, i > 0 ? p - g.W : p, p, i < g.H - 1 ? p + g.W : p, dm[i > 0 ? sp - rs : sp], dp,
             dm[i < g.H - 1 ? sp + rs : sp], i, g.H, t0);
    div_axis(mw + g.HW, c > 0 ? p - 1 : p, p, c < g.W - 1 ? p + 1 : p,
             dm[c > 0 ? sp - cs : sp], dp, dm[c < g.W - 1 ? sp + cs : sp], c, g.W, t1);
    const int q = f + p;
    const float d0 = s2d::add(wg[0], s2d::add(t0[0], t1[0]));
    const float d1 = s2d::add(wg[1], s2d::add(t0[1], t1[1]));
    if constexpr (ACC) {
      Gn[q] = s2d::add(Gn[q], d0);
      Gn[q + g.HW] = s2d::add(Gn[q + g.HW], d1);
    } else {
      Gn[q] = d0;
      Gn[q + g.HW] = d1;
    }
    if (d_m0) {
      const int r0 = n * g.H - (l0 - 1);
      float acc[2];
      gather_transpose(w, r0, g.H, g.W, i, c,
                       [&](int u, int v) { return dmw[(r0 + u) * rs + v * cs]; }, acc);
      const bool store = !ACC || first;
      d_m0[q] = store ? acc[0] : s2d::add(d_m0[q], acc[0]);
      d_m0[q + g.HW] = store ? acc[1] : s2d::add(d_m0[q + g.HW], acc[1]);
    }
  }
}

}  // namespace lagomorph
