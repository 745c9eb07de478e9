// K8 and K9: the whole 2D EPDiff shooting in one launch, forward and
// backward.
//
// K8 (forward), T Euler substeps of step s (= -dt) from phiinv_0 and m0:
//   m   = Ad*(phiinv_t, m0)                 (9-tap unit warp + Jacobian)
//   v   = K(m)                              (fluid solve, beta == 0)
//   phiinv_{t+1} = s v + phiinv_t(x + s v)  (9-tap unit warp)
// with the unit-regime flag of phiinv_t (every t, phiinv_0 included) and of
// s v, and, under autograd, the trajectory (phiinv_t, v_t, mw_t) stashed
// for K9.  The fluid solve packs the two channels as one complex plane
// (m_0 + i m_1; the multiplier Mn is real and even in k):
//   v_0 + i v_1 = ifft2(Mn * fft2(m_0 + i m_1)),
// the forward DFT unnormalised and the inverse scaled by 1/N per axis, as
// K3.  Replaces lagomorph_tpu/ops/pallas/shoot2d.py `_shoot_fwd_kernel`
// (`_shoot_fwd_dispatch`, pallas_call at :540).
//
// K9 (backward), the reverse sweep over the stash (t = T-1 .. 0), with g
// the cotangent of phiinv_{t+1}:
//   (d_phi_c, d_v) = compose backward at (phiinv_t, v_t)
//   dm             = K(d_v)                  (self-adjoint)
//   (d_phi_a, d_m0_t) = Ad* backward at (phiinv_t, m0, mw_t), cotangent dm
//   g <- d_phi_c + d_phi_a;  d_m0 += d_m0_t
// giving d_m0 (summed over the subjects for a batch-1 m0) and d_phiinv_0.
// Replaces shoot2d.py `_shoot_bwd_kernel` (`_shoot_bwd_dispatch`,
// pallas_call at :569).
//
// The TPU kernel runs one subject per grid step with its whole (2, H, W)
// plane in VMEM and the DFTs as matmuls on the MXU.  A 256^2 two-channel
// float32 plane (512 KB) does not fit one SM's 227 KB, so here each kernel
// is one cooperative persistent launch: every block is resident at once,
// each phase walks its tiles in a grid-stride loop, and phases are
// separated by grid-wide barriers (cooperative_groups::this_grid().sync()).
// A substep's working set (4 MB per field at 256^2 b8) stays in the 50 MB L2
// between phases.
//
// K8, per forward substep, three phases:
//   A. rows: Ad* of TJ rows computed into a shared-memory tile (mw_t to
//      the stash), forward DFT along W, to a complex scratch plane;
//   B. columns: forward DFT along H, times Mn, inverse DFT along H;
//   C. rows: inverse DFT along W gives v_t (to the stash), and the compose
//      of each pixel of the tile writes phiinv_{t+1}.
// Its line transforms are K3's tiles (fft_lines.cuh): radix-2 for
// power-of-two lengths, direct sums otherwise.  phiinv_t lives in the
// trajectory buffer itself; without the stash (no autograd) two scratch
// planes ping-pong.  The flag is accumulated per thread and cleared with one
// atomicAnd per warp at the end.
//
// K9, per reverse step, three phases (a fourth for a batch-1 m0):
//   1. rows: the packed weights of s v_t for the tile's rows and one halo
//      row on each side are staged in shared memory once; compose backward
//      of each pixel (the transposed warp of g gathers its 9 taps' weights
//      from there) writes d_phi_c as the first term of the new g, and d_v
//      goes through a forward DFT along W to the complex scratch;
//   2. columns: forward DFT along H, times Mn, inverse DFT along H;
//   3. rows: the tile's rows and a halo row on each side are inverse-DFT'd
//      along W (the row DFT is row-local, and the halo rows' spectra are in
//      the scratch), giving dm; d_mw = (J + I)^T dm and the packed weights
//      of phiinv_t are staged beside it for those rows, and each pixel of
//      the tile adds Ad*'s weight-gradient and divergence terms to the new
//      g and (batch-N m0) the transposed warp of d_mw to d_m0, reading dm,
//      d_mw and the weights at its neighbours in shared memory;
//   4. (batch-1 m0 only) d_m0 += the transposed warp of d_mw summed over
//      the subjects in the thread (no atomics), from a d_mw scratch that
//      phase 3 writes.
// So a reverse step takes 3 grid barriers (4 for a batch-1 m0) and the dm
// and d_mw fields never leave the SM.  Where H and W are powers of two from
// 32 to 256 (the register path; 256^2 b8 is the 2D step's shape) the line
// transforms are K3's register transforms (fft_reg.cuh: G threads a line,
// one exchange through shared memory a transform, the column pass's
// forward, product and inverse all in registers, distribution 2 in and
// out); their shared memory is the exchange slots and the stencil tile,
// and the tile height is chosen so that every phase has about as many
// tiles as the grid has blocks (shoot2d_bwd_config).  Other shapes (512^2,
// odd sizes) keep K8's tile transforms (the tile path), with phase 3's
// halo rows in the tile.  The per-pixel arithmetic is stencil2d.cuh's,
// every product and sum in its order; the packed weights (pack_axis) hold
// exactly the values `s2d::weights` gives.
//
// Bound on the H100 (256^2 b8, 4 MB per field, T = 4): K8 must read phiinv_0
// and m0 and write phiinv_T and the stash (3T fields), ~60 MB, ~18 us at
// 3.35 TB/s; its arithmetic (4 complex 2D FFTs per substep, ~40 flops per
// pixel per stencil) is ~0.3 GFLOP, ~5 us at 67 TFLOP/s.  K9 reads the
// stash and writes d_phiinv_0 and d_m0, ~0.020 ms.  So both kernels are
// bound by bytes, and their phases by the latency of the grid barriers and
// of the scratch round trips through L2; K9's design cuts both.
#include <cooperative_groups.h>

#include "cooperative.cuh"
#include "fft_lines.cuh"
#include "fft_plane.cuh"
#include "stencil2d.cuh"

namespace cg = cooperative_groups;

namespace lagomorph {

constexpr int kShootThreads = 256;

// shared memory: twiddle tables for H and W, two tiles of L = max(H, W)
// rows of TJ + 1 complex values
static size_t shoot_smem(int H, int W, int tj) {
  const int L = H > W ? H : W;
  return ((size_t)H + W + 2 * (size_t)L * (tj + 1)) * sizeof(float2);
}

// lines per tile: the widest TJ (a power of two dividing the block) whose
// tiles fit 96 KB, so two blocks share an SM
static int shoot_tj(int H, int W) {
  for (int tj = 32; tj > 1; tj /= 2)
    if (shoot_smem(H, W, tj) <= 96 * 1024) return tj;
  return 1;
}

struct Tiles {
  float2 *twH, *twW, *S, *O;
};

__device__ __forceinline__ Tiles carve(float2* smem, int H, int W, int TJ) {
  const int L = H > W ? H : W;
  Tiles t;
  t.twH = smem;
  t.twW = t.twH + H;
  t.S = t.twW + W;
  t.O = t.S + (long)L * (TJ + 1);
  return t;
}

// Phase B / 2: every column line (N * W of them, length H, stride W) of the
// complex scratch: forward DFT, times Mn, inverse DFT scaled by 1/H
__device__ void column_pass(float2* cbuf, const float* __restrict__ Mn, const Tiles& sm,
                            int N, int H, int W, int TJ) {
  const int TP = TJ + 1;
  const long nlines = (long)N * W;
  const long ntiles = (nlines + TJ - 1) / TJ;
  const int total = H * TJ;
  const float scale = 1.0f / H;
  for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const long l0 = tile * TJ;
    const int nl = nlines - l0 < TJ ? (int)(nlines - l0) : TJ;
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int n = e / TJ, j = e - n * TJ;
      sm.S[n * TP + j] = j < nl ? cbuf[line_addr(l0 + j, n, H, W)] : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
    float2* F = transform_tile(sm.S, sm.O, sm.twH, H, TJ, -1.0f);
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int k = e / TJ, j = e - k * TJ;
      if (j < nl) {
        const float m = Mn[(long)k * W + (l0 + j) % W];
        const float2 v = F[k * TP + j];
        F[k * TP + j] = make_float2(v.x * m, v.y * m);
      }
    }
    __syncthreads();
    float2* res = transform_tile(F, F == sm.S ? sm.O : sm.S, sm.twH, H, TJ, 1.0f);
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int k = e / TJ, j = e - k * TJ;
      if (j < nl) {
        const float2 v = res[k * TP + j];
        cbuf[line_addr(l0 + j, k, H, W)] = make_float2(v.x * scale, v.y * scale);
      }
    }
    __syncthreads();
  }
}

// store the tile's forward row DFT (rows l0 .. l0 + nl of length W) to cbuf
__device__ __forceinline__ void store_rows(float2* cbuf, const float2* res, long l0, int nl,
                                           int W, int TJ) {
  const int TP = TJ + 1;
  for (int e = threadIdx.x; e < W * TJ; e += blockDim.x) {
    const int j = e / W, k = e - j * W;
    if (j < nl) cbuf[(l0 + j) * W + k] = res[k * TP + j];
  }
}

// load rows l0 .. l0 + nl of cbuf into the tile and inverse-DFT them along W
__device__ __forceinline__ float2* load_rows_inverse(const float2* cbuf, const Tiles& sm,
                                                     long l0, int nl, int W, int TJ) {
  const int TP = TJ + 1;
  for (int e = threadIdx.x; e < W * TJ; e += blockDim.x) {
    const int j = e / W, k = e - j * W;
    sm.S[k * TP + j] = j < nl ? cbuf[(l0 + j) * W + k] : make_float2(0.0f, 0.0f);
  }
  __syncthreads();
  return transform_tile(sm.S, sm.O, sm.twW, W, TJ, 1.0f);
}

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

__global__ void __launch_bounds__(kShootThreads, 2)
shoot2d_fwd_kernel(const float* __restrict__ phi0, const float* __restrict__ m0,
                   const float* __restrict__ Mn, float* __restrict__ out, int* flag,
                   float* traj_p, float* traj_v, float* traj_mw, float* pp, float2* cbuf,
                   int N, int Nm, int H, int W, int T, float s, int TJ) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  const Tiles sm = carve(smem, H, W, TJ);
  fill_twiddles(sm.twH, H);
  fill_twiddles(sm.twW, W);
  __syncthreads();

  const int TP = TJ + 1;
  const long HW = (long)H * W;
  const long F = 2 * HW;  // one subject's field
  const long NF = (long)N * F;
  const long nrows = (long)N * H;
  const long ntiles = (nrows + TJ - 1) / TJ;
  const int total = W * TJ;
  const float inv_w = 1.0f / W;
  bool bad = false;

  for (int t = 0; t < T; ++t) {
    const float* P = t == 0 ? phi0 : (traj_p ? traj_p + t * NF : pp + (t % 2) * NF);
    float* Pn = t == T - 1 ? out : (traj_p ? traj_p + (t + 1) * NF : pp + ((t + 1) % 2) * NF);
    float* mwt = traj_mw ? traj_mw + t * NF : nullptr;
    float* vt = traj_v ? traj_v + t * NF : nullptr;
    float* p0 = (traj_p && t == 0) ? traj_p : nullptr;  // phiinv_0 into the stash

    // A. Ad* of the tile's rows, forward DFT along W
    for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long l0 = tile * TJ;
      const int nl = nrows - l0 < TJ ? (int)(nrows - l0) : TJ;
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int j = e / W, col = e - j * W;
        float2 val = make_float2(0.0f, 0.0f);
        if (j < nl) {
          const long l = l0 + j;
          const int n = (int)(l / H), i = (int)(l - (long)n * H);
          const long q = (long)n * F + (long)i * W + col;
          float m[2], mw[2];
          bad |= !s2d::adstar(P + n * F, m0 + (Nm == 1 ? 0 : n * F), H, W, i, col, m, mw);
          if (mwt) {
            mwt[q] = mw[0];
            mwt[q + HW] = mw[1];
          }
          if (p0) {
            p0[q] = P[q];
            p0[q + HW] = P[q + HW];
          }
          val = make_float2(m[0], m[1]);
        }
        sm.S[col * TP + j] = val;
      }
      __syncthreads();
      store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, W, TJ, -1.0f), l0, nl, W, TJ);
      __syncthreads();
    }
    grid.sync();

    // B. columns: forward DFT, times Mn, inverse DFT
    column_pass(cbuf, Mn, sm, N, H, W, TJ);
    grid.sync();

    // C. inverse DFT along W gives v_t; compose into phiinv_{t+1}
    for (long tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
      const long l0 = tile * TJ;
      const int nl = nrows - l0 < TJ ? (int)(nrows - l0) : TJ;
      const float2* res = load_rows_inverse(cbuf, sm, l0, nl, W, TJ);
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int j = e / W, col = e - j * W;
        if (j < nl) {
          const long l = l0 + j;
          const int n = (int)(l / H), i = (int)(l - (long)n * H);
          const long q = (long)n * F + (long)i * W + col;
          const float2 r = res[col * TP + j];
          const float v0 = r.x * inv_w, v1 = r.y * inv_w;
          if (vt) {
            vt[q] = v0;
            vt[q + HW] = v1;
          }
          float o[2];
          bad |= !s2d::compose(P + n * F, v0, v1, s, H, W, i, col, o);
          Pn[q] = o[0];
          Pn[q + HW] = o[1];
        }
      }
      __syncthreads();
    }
    grid.sync();
  }
  clear_flag_if(bad, flag);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

constexpr int kBwdThreads = 256;
constexpr size_t kBwdMaxSmem = 227 * 1024;  // a block's opt-in limit on the H100

// the register path's line lengths: powers of two from 32 to 256
static inline bool bwd_reg_axis(int n) { return n >= 32 && n <= 256 && (n & (n - 1)) == 0; }

// The subjects' geometry: a plane, a field (two planes), the rows of all
// subjects one after another.  Indices within the fields of all subjects
// are ints (the entry point refuses N * 2 * H * W >= 2^31): K9 holds 128
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

// A tile of K9 is rows l0 .. l0 + nl - 1 of the N * H rows (subjects one
// after another); its staged rows are those and one halo row on each side,
// staged row r being row l0 - 1 + r (a row outside [0, N H) is not
// staged).  The packed weights of a staged pixel sit at w[r * W + c]; dm
// and d_mw, in phase 3, at r * rs + c * cs (row-major on the register path,
// K8's tile layout on the tile path).

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

// Phase 1 on the tile at l0 (nl rows), the weights of s v staged in w:
// compose backward at each pixel (`s2d::compose_bwd`): Gn <- d_phi, and d_v
// to out[j * rs + c * cs] for row j of the tile; rows nl .. rows - 1 zero.
__device__ __forceinline__ void compose_bwd_tile(const float* __restrict__ P,
                                                 const float* __restrict__ G, float s,
                                                 const float4* __restrict__ w,
                                                 float* __restrict__ Gn, float2* __restrict__ out,
                                                 int rs, int cs, int l0, int nl, int rows,
                                                 const Geo& g) {
  const int total = rows * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / g.W, c = e - j * g.W;
    float2 val = make_float2(0.0f, 0.0f);
    if (j < nl) {
      const int l = l0 + j;
      const int n = l / g.H;
      const int i = l - n * g.H;
      const float* Gs = G + n * g.F;
      const int q = n * g.F + i * g.W + c;
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
    out[j * rs + c * cs] = val;
  }
}

// Phase 3, once the inverse row DFT has put the staged rows' dm / scale at
// dm: dm scaled in place, d_mw = (J + I)^T dm (`s2d::adstar_bwd_dmw`) to
// dmw, the packed weights of phiinv to w; with dmw_out (a batch-1 m0) the
// tile's own rows' d_mw also to that field.
__device__ __forceinline__ void stage_dmw(const float* __restrict__ P, float2* __restrict__ dm,
                                          float2* __restrict__ dmw, float4* __restrict__ w,
                                          float* __restrict__ dmw_out, int rs, int cs, float scale,
                                          int l0, int nl, const Geo& g) {
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    if (l < 0 || l >= g.NH) continue;
    const int n = l / g.H;
    const int i = l - n * g.H;
    const int p = n * g.F + i * g.W + c;
    const int a = r * rs + c * cs;
    const float2 v = dm[a];
    const float g0 = s2d::mul(v.x, scale), g1 = s2d::mul(v.y, scale);
    dm[a] = make_float2(g0, g1);
    float d[2];
    s2d::adstar_bwd_dmw(P + n * g.F, g0, g1, g.H, g.W, i, c, d);
    dmw[a] = make_float2(d[0], d[1]);
    w[e] = pack_weights(P[p], P[p + g.HW]);
    if (dmw_out && r >= 1 && r <= nl) {
      dmw_out[p] = d[0];
      dmw_out[p + g.HW] = d[1];
    }
  }
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

// Phase 3 on the tile at l0 (nl rows), after stage_dmw: Gn += Ad*'s
// d_phiinv (`s2d::adstar_bwd_dphi`: the weight gradient on m0 at the
// weights of phiinv with the cotangent d_mw, and the divergence terms
// D_a^T (dm_c mw_a), dm at the neighbours from the stage); with d_m0
// (batch-N m0) also d_m0 (+)= the transposed warp of d_mw at the weights
// of phiinv, its taps from the stage.
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
    Gn[q] = s2d::add(Gn[q], s2d::add(wg[0], s2d::add(t0[0], t1[0])));
    Gn[q + g.HW] = s2d::add(Gn[q + g.HW], s2d::add(wg[1], s2d::add(t0[1], t1[1])));
    if (d_m0) {
      const int r0 = n * g.H - (l0 - 1);
      float acc[2];
      gather_transpose(w, r0, g.H, g.W, i, c,
                       [&](int u, int v) { return dmw[(r0 + u) * rs + v * cs]; }, acc);
      d_m0[q] = first ? acc[0] : s2d::add(d_m0[q], acc[0]);
      d_m0[q + g.HW] = first ? acc[1] : s2d::add(d_m0[q + g.HW], acc[1]);
    }
  }
}

// ---- the register path's transforms (H, W powers of two from 32 to 256) ----

// Phase 1's transform: the tile's nl rows of d_v (row-major in dv) forward
// along W, natural order out, to rows l0 .. of cbuf.  Line j of the block's
// 256 / G is G neighbouring lanes (RowSlots in X); the lines past nl
// transform zeros and store nothing.
template <int W>
__device__ __forceinline__ void rows_forward(const float2* dv, float2* cbuf, float2* X,
                                             const float2* tw, int l0, int nl) {
  constexpr int G = RegPlan<W>::G, R = RegPlan<W>::R;
  const int t = thread_index(), j = t / G, g = t % G;
  const bool live = j < nl;
  float2 v[R];
#pragma unroll
  for (int e = 0; e < R; ++e)
    v[e] = live ? dv[j * W + dist1_index<W>(g, e)] : make_float2(0.0f, 0.0f);
  fft_fwd_reg<W>(v, g, RowSlots{X, row_pitch(W), j}, tw);
  if (!live) return;
  float2* row = cbuf + (l0 + j) * W;
#pragma unroll
  for (int e = 0; e < R; ++e) row[dist2_index<W>(g, e)] = v[e];
}

// Phase 2 on the columns c0 .. c0 + nc - 1 of the N * W columns (column
// (n, col) of cbuf at stride W): forward along H, times Mn, inverse along
// H (unscaled), all in registers, distribution 2 between.  Line j of the
// block's 256 / G is one lane of a warp (LineSlots in X), so a warp's loads
// are neighbouring columns; the lines past nc transform zeros.
template <int H>
__device__ __forceinline__ void columns(float2* cbuf, const float* __restrict__ Mn, float2* X,
                                        const float2* tw, int c0, int nc, int W) {
  constexpr int G = RegPlan<H>::G, R = RegPlan<H>::R, L = kBwdThreads / G;
  const int t = thread_index(), j = t % L, g = t / L;
  const bool live = j < nc;
  const int l = c0 + j;
  const int n = l / W;
  const int col = l - n * W;
  float2* base = cbuf + n * H * W + col;
  float2 v[R];
#pragma unroll
  for (int e = 0; e < R; ++e)
    v[e] = live ? base[dist1_index<H>(g, e) * W] : make_float2(0.0f, 0.0f);
  const LineSlots sl{X, L, j};
  fft_fwd_reg<H>(v, g, sl, tw);
#pragma unroll
  for (int e = 0; e < R; ++e)
    v[e] = cscale(v[e], live ? Mn[dist2_index<H>(g, e) * W + col] : 0.0f);
  fft_inv_reg<H>(v, g, sl, tw);
  if (!live) return;
#pragma unroll
  for (int e = 0; e < R; ++e) base[dist1_index<H>(g, e) * W] = v[e];
}

// Phase 3's transform: the tile's staged rows (those that exist) inverse
// along W from cbuf (distribution 2 in), unscaled, to dm row-major.
template <int W>
__device__ __forceinline__ void rows_inverse(const float2* cbuf, float2* dm, float2* X,
                                             const float2* tw, int l0, int nl, int NH) {
  constexpr int G = RegPlan<W>::G, R = RegPlan<W>::R;
  const int t = thread_index(), j = t / G, g = t % G;
  const int l = l0 - 1 + j;
  const bool live = j < nl + 2 && l >= 0 && l < NH;
  const float2* row = cbuf + l * W;
  float2 v[R];
#pragma unroll
  for (int e = 0; e < R; ++e)
    v[e] = live ? row[dist2_index<W>(g, e)] : make_float2(0.0f, 0.0f);
  fft_inv_reg<W>(v, g, RowSlots{X, row_pitch(W), j}, tw);
  if (!live) return;
#pragma unroll
  for (int e = 0; e < R; ++e) dm[j * W + dist1_index<W>(g, e)] = v[e];
}

// the tile path's phase 3 load: staged row r (< nl + 2) of the tile at l0
// into line r of K8's tile S ([k][line], pitch TJ + 1); zeros elsewhere
__device__ __forceinline__ void load_staged_rows(const float2* cbuf, float2* S, int l0, int nl,
                                                 int NH, int W, int TJ) {
  const int TP = TJ + 1;
  for (int e = threadIdx.x; e < W * TJ; e += blockDim.x) {
    const int r = e / W, k = e - r * W;
    const int l = l0 - 1 + r;
    S[k * TP + r] = r < nl + 2 && l >= 0 && l < NH ? cbuf[l * W + k] : make_float2(0.0f, 0.0f);
  }
}

// K9's shared memory in float2s: the packed weights w ((TJ + 2) x W
// float4s; on the register path the line exchanges alias them) at 0, then
// a and b (register path: (TJ + 2) x W each, phase 1's d_v in a, phase 3's
// dm in a and d_mw in b; tile path: K8's tiles S and O of L x (TJ + 1)),
// then the twiddle tables of H and W.
struct BwdCarve {
  long a, b, tw, total;
};

__host__ __device__ inline BwdCarve bwd_carve(bool reg, int H, int W, int tj) {
  const long staged = (long)(tj + 2) * W;
  long wsz = 2 * staged;
  long ab = staged;
  if (reg) {
    const long xr = (long)(kBwdThreads / reg_group(W)) * row_pitch(W);
    const long xc = (long)H * (kBwdThreads / reg_group(H));
    const long x = xr > xc ? xr : xc;
    if (x > wsz) wsz = (x + 1) / 2 * 2;  // a and b start on 16 bytes
  } else {
    ab = (long)(H > W ? H : W) * (tj + 1);
  }
  BwdCarve c;
  c.a = wsz;
  c.b = c.a + ab;
  c.tw = c.b + ab;
  c.total = c.tw + H + W;
  return c;
}

// K9.  RH, RW: H and W on the register path; 0, 0 the tile path.  One
// cooperative launch of kBwdThreads-thread blocks; the grid may hold fewer
// blocks than the card does (shoot2d_bwd_config).  Phase 1 and 3 tiles are
// TJ rows (phase 3 on the tile path TJ - 2, its halo rows in K8's tile of
// TJ lines), phase 2's TJ columns.
template <int RH, int RW>
__global__ void __launch_bounds__(kBwdThreads, 2)
shoot2d_bwd_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
                   const float* __restrict__ Mn, const float* __restrict__ traj_p,
                   const float* __restrict__ traj_v, const float* __restrict__ traj_mw,
                   float* d_m0, float* d_phi0, float2* cbuf, float* dmw_out, float* gbuf, int N,
                   int Nm, int H, int W, int T, float s, int TJ) {
  constexpr bool REG = RH > 0;
  if constexpr (REG) {  // constants: the stencils' divisions by W and H become shifts
    H = RH;
    W = RW;
  }
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 bwd_smem[];
  float2* smem = bwd_smem;
  const BwdCarve cv = bwd_carve(REG, H, W, TJ);
  float4* w = reinterpret_cast<float4*>(smem);
  float2* a = smem + cv.a;
  float2* b = smem + cv.b;
  Tiles sm;
  sm.twH = smem + cv.tw;
  sm.twW = sm.twH + H;
  sm.S = a;
  sm.O = b;
  fill_twiddles(sm.twH, H);
  fill_twiddles(sm.twW, W);
  __syncthreads();

  const Geo gm = make_geo(N, H, W);
  const int TP = TJ + 1;
  const int R3 = REG ? TJ : TJ - 2;  // phase 3's rows a tile
  const int NW = N * W;
  const bool sum_m0 = Nm != N;  // a batch-1 m0 of several subjects: phase 4
  // the inverse transforms' 1 / (H W): the register path's column pass
  // leaves its 1 / H to phase 3 (both powers of two, so exact); K8's tile
  // column pass scales by 1 / H itself
  const float scale = REG ? 1.0f / (float)gm.HW : 1.0f / W;

  for (int t = T - 1; t >= 0; --t) {
    const long step = (long)t * N * gm.F;
    const float* P = traj_p + step;
    const float* V = traj_v + step;
    const float* MW = traj_mw + step;
    const float* G = t == T - 1 ? g_in : gbuf + ((t + 1) % 2) * N * gm.F;
    float* Gn = t == 0 ? d_phi0 : gbuf + (t % 2) * N * gm.F;

    // 1. compose backward (d_phi_c to Gn); d_v forward along W to cbuf
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      stage_weights(w, V, s, l0, nl, gm);
      __syncthreads();
      if constexpr (REG) {
        compose_bwd_tile(P, G, s, w, Gn, a, W, 1, l0, nl, nl, gm);
        __syncthreads();  // d_v staged, w read: the exchange may overwrite it
        rows_forward<RW>(a, cbuf, smem, sm.twW, l0, nl);
      } else {
        compose_bwd_tile(P, G, s, w, Gn, sm.S, 1, TP, l0, nl, TJ, gm);
        __syncthreads();
        store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, W, TJ, -1.0f), l0, nl, W, TJ);
      }
      __syncthreads();  // before the next tile's stage
    }
    grid.sync();

    // 2. columns: forward along H, times Mn, inverse
    if constexpr (REG) {
      for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
        columns<RH>(cbuf, Mn, smem, sm.twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
    } else {
      column_pass(cbuf, Mn, sm, N, H, W, TJ);
    }
    grid.sync();

    // 3. the tile's rows and halo inverse along W give dm; d_mw and the
    // weights of phiinv staged; Gn += Ad*'s terms, d_m0 (+)= its transpose
    for (int l0 = blockIdx.x * R3; l0 < gm.NH; l0 += gridDim.x * R3) {
      const int nl = gm.NH - l0 < R3 ? gm.NH - l0 : R3;
      float2 *dm, *dmw;
      int rs, cs;
      if constexpr (REG) {
        rows_inverse<RW>(cbuf, a, smem, sm.twW, l0, nl, gm.NH);
        dm = a;
        dmw = b;
        rs = W;
        cs = 1;
      } else {
        load_staged_rows(cbuf, sm.S, l0, nl, gm.NH, W, TJ);
        __syncthreads();
        dm = transform_tile(sm.S, sm.O, sm.twW, W, TJ, 1.0f);
        dmw = dm == sm.S ? sm.O : sm.S;
        rs = 1;
        cs = TP;
      }
      __syncthreads();  // dm staged, the exchange read: w may be overwritten
      stage_dmw(P, dm, dmw, w, sum_m0 ? dmw_out : nullptr, rs, cs, scale, l0, nl, gm);
      __syncthreads();
      adstar_bwd_tile(m0, Nm, MW, dm, dmw, w, rs, cs, Gn, sum_m0 ? nullptr : d_m0, t == T - 1, l0,
                      nl, gm);
      __syncthreads();  // before the next tile's transform
    }
    // the next step's phase 1 reads Gn at the neighbours; phase 4 reads
    // d_mw there.  Phase 4 runs beside the next step's phase 1, which
    // touches neither d_mw nor d_m0.
    if (t > 0 || sum_m0) grid.sync();

    // 4. a batch-1 m0: d_m0 += the transposed warp of d_mw, summed over
    // the subjects in the thread
    if (sum_m0) {
      for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < gm.HW; e += gridDim.x * blockDim.x) {
        const int i = e / W, col = e - i * W;
        float acc[2] = {0.0f, 0.0f};
        for (int n = 0; n < N; ++n) {
          float d[2];
          s2d::warp_transpose(P + n * gm.F, 1.0f, dmw_out + n * gm.F, H, W, i, col, d);
          acc[0] = s2d::add(acc[0], d[0]);
          acc[1] = s2d::add(acc[1], d[1]);
        }
        d_m0[e] = t == T - 1 ? acc[0] : s2d::add(d_m0[e], acc[0]);
        d_m0[e + gm.HW] = t == T - 1 ? acc[1] : s2d::add(d_m0[e + gm.HW], acc[1]);
      }
    }
  }
}

typedef void (*BwdKernel)(const float*, const float*, const float*, const float*, const float*,
                          const float*, float*, float*, float2*, float*, float*, int, int, int,
                          int, int, float, int);

template <int RH>
static BwdKernel bwd_kernel_w(int W) {
  switch (W) {
    case 32: return shoot2d_bwd_kernel<RH, 32>;
    case 64: return shoot2d_bwd_kernel<RH, 64>;
    case 128: return shoot2d_bwd_kernel<RH, 128>;
    case 256: return shoot2d_bwd_kernel<RH, 256>;
  }
  return nullptr;
}

static BwdKernel bwd_kernel(bool reg, int H, int W) {
  if (!reg) return shoot2d_bwd_kernel<0, 0>;
  switch (H) {
    case 32: return bwd_kernel_w<32>(W);
    case 64: return bwd_kernel_w<64>(W);
    case 128: return bwd_kernel_w<128>(W);
    case 256: return bwd_kernel_w<256>(W);
  }
  return nullptr;
}

struct BwdConfig {
  BwdKernel kernel;
  int reg, tj, blocks;
  size_t smem;
  long tiles[3];  // of phases 1, 2 and 3
};

static bool bwd_tj_valid(bool reg, int H, int W, int tj) {
  if (reg)
    return tj >= 1 && tj + 2 <= kBwdThreads / reg_group(W) && tj <= kBwdThreads / reg_group(H);
  return tj >= 4 && tj <= 32 && (tj & (tj - 1)) == 0;  // K8's tiles: a power of two
}

static void bwd_tiles(bool reg, int N, int H, int W, int tj, long tiles[3]) {
  const long NH = (long)N * H, NW = (long)N * W;
  const int r3 = reg ? tj : tj - 2;
  tiles[0] = (NH + tj - 1) / tj;
  tiles[1] = (NW + tj - 1) / tj;
  tiles[2] = (NH + r3 - 1) / r3;
}

// The launch of K9 at (N, H, W).  The path: the register path where H and
// W are powers of two from 32 to 256, else the tile path (reg < 0), or as
// `reg` says.  The tile height TJ: `tile` (> 0) if given, else the one whose
// phases take the fewest line-rounds: a phase takes ceil(tiles / blocks)
// rounds of its tile's lines (TJ; TJ + 2 in the register path's phase 3,
// whose halo rows are transformed), the grid being as many blocks as the
// card holds at that shared memory, but no more than the most tiles a phase
// has (a block past those would only wait at the barriers); ties keep the
// taller tile.  A chosen configuration is kept per (device, shape, reg,
// tile).
static int shoot2d_bwd_config(int N, int H, int W, int reg, int tile, BwdConfig* out) {
  if (N < 1 || H < 2 || W < 2 || 2L * N * H * W >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const bool can_reg = bwd_reg_axis(H) && bwd_reg_axis(W);
  if (reg < 0) reg = can_reg;
  if (reg && !can_reg) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  struct Entry {
    int dev, N, H, W, reg, tile;
    BwdConfig cfg;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.dev == dev && e.N == N && e.H == H && e.W == W && e.reg == reg && e.tile == tile) {
        *out = e.cfg;
        return (int)cudaSuccess;
      }
    }
  }
  const BwdKernel kernel = bwd_kernel(reg, H, W);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kBwdMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int lo = tile > 0 ? tile : 1, hi = tile > 0 ? tile : 254;
  bool found = false;
  long best = 0;
  for (int tj = hi; tj >= lo; --tj) {
    if (!bwd_tj_valid(reg, H, W, tj)) continue;
    const size_t smem = (size_t)bwd_carve(reg, H, W, tj).total * sizeof(float2);
    if (smem > kBwdMaxSmem) continue;
    int per_sm;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kBwdThreads, smem)) !=
        cudaSuccess)
      return (int)err;
    if (per_sm < 1) continue;
    long tiles[3];
    bwd_tiles(reg, N, H, W, tj, tiles);
    long most = tiles[0] > tiles[1] ? tiles[0] : tiles[1];
    if (tiles[2] > most) most = tiles[2];
    const long blocks = (long)per_sm * sms < most ? (long)per_sm * sms : most;
    const int lines[3] = {tj, tj, reg ? tj + 2 : tj};
    long cost = 0;
    for (int p = 0; p < 3; ++p) cost += (tiles[p] + blocks - 1) / blocks * lines[p];
    if (!found || cost < best) {
      found = true;
      best = cost;
      *out = BwdConfig{kernel, reg, tj, (int)blocks, smem, {tiles[0], tiles[1], tiles[2]}};
    }
  }
  if (!found) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = Entry{dev, N, H, W, reg, tile, *out};
  return (int)cudaSuccess;
}

// the launch c makes, in the 8 ints of lagomorph_shoot2d_bwd_grid's out
static int bwd_report(const BwdConfig& c, int* out) {
  int cap;
  const int err = cooperative_blocks((const void*)c.kernel, kBwdThreads, c.smem, &cap);
  if (err != (int)cudaSuccess) return err;
  out[0] = c.reg;
  out[1] = c.tj;
  out[2] = cap < c.blocks ? cap : c.blocks;
  out[3] = kBwdThreads;
  out[4] = (int)c.smem;
  for (int p = 0; p < 3; ++p) out[5 + p] = (int)c.tiles[p];
  return (int)cudaSuccess;
}

static int shoot2d_bwd_launch(const BwdConfig& c, const float* m0, const float* g, const float* Mn,
                              const float* traj_p, const float* traj_v, const float* traj_mw,
                              float* d_m0, float* d_phi0, float* cbuf, float* dmw, float* gbuf,
                              int N, int Nm, int H, int W, int T, float s, cudaStream_t stream) {
  if (Nm != N && Nm != 1) return (int)cudaErrorInvalidValue;
  if (Nm != N && dmw == nullptr) return (int)cudaErrorInvalidValue;
  const BwdKernel kernel = c.kernel;
  float2* cb = reinterpret_cast<float2*>(cbuf);
  int tj = c.tj;
  void* args[] = {&m0,   &g, &Mn, &traj_p, &traj_v, &traj_mw, &d_m0, &d_phi0, &cb, &dmw,
                  &gbuf, &N, &Nm, &H,      &W,      &T,       &s,    &tj};
  return launch_cooperative((const void*)kernel, kBwdThreads, c.smem, args, stream, c.blocks);
}

}  // namespace lagomorph

// phi0, out: (N, 2, H, W); m0: (Nm, 2, H, W), Nm in {1, N}; Mn: (H, W);
// flag: one int32 set to 1 by the caller.  With the stash, traj_p / traj_v
// / traj_mw are (T, N, 2, H, W) and pp is unused; without it the three are
// NULL and pp is (2, N, 2, H, W) scratch.  cbuf: (N, H, W) complex scratch.
extern "C" int lagomorph_shoot2d_fwd(const float* phi0, const float* m0, const float* Mn,
                                     float* out, int* flag, float* traj_p, float* traj_v,
                                     float* traj_mw, float* pp, float* cbuf, int N, int Nm,
                                     int H, int W, int T, float s, void* stream) {
  using namespace lagomorph;
  int tj = shoot_tj(H, W);
  float2* c = reinterpret_cast<float2*>(cbuf);
  void* args[] = {&phi0, &m0, &Mn, &out, &flag, &traj_p, &traj_v, &traj_mw, &pp, &c,
                  &N, &Nm, &H, &W, &T, &s, &tj};
  return launch_cooperative((const void*)shoot2d_fwd_kernel, kShootThreads,
                            shoot_smem(H, W, tj), args, (cudaStream_t)stream);
}

// m0, d_m0: (Nm, 2, H, W), Nm in {1, N}; g, d_phi0: (N, 2, H, W); traj_*:
// (T, N, 2, H, W) from K8; cbuf: (N, H, W) complex scratch; dmw: (N, 2, H,
// W) scratch for a batch-1 m0 of N > 1 subjects, else unused (may be NULL);
// gbuf: (2, N, 2, H, W) scratch.  tile: the tile height TJ (0: the one
// shoot2d_bwd_config chooses; the register path takes 1 .. 256 / G - 2 of
// the rows' G, the tile path 4, 8, 16 or 32).
extern "C" int lagomorph_shoot2d_bwd(const float* m0, const float* g, const float* Mn,
                                     const float* traj_p, const float* traj_v,
                                     const float* traj_mw, float* d_m0, float* d_phi0,
                                     float* cbuf, float* dmw, float* gbuf, int N, int Nm, int H,
                                     int W, int T, float s, int tile, void* stream) {
  using namespace lagomorph;
  BwdConfig c;
  const int err = shoot2d_bwd_config(N, H, W, -1, tile, &c);
  if (err != (int)cudaSuccess) return err;
  return shoot2d_bwd_launch(c, m0, g, Mn, traj_p, traj_v, traj_mw, d_m0, d_phi0, cbuf, dmw, gbuf,
                            N, Nm, H, W, T, s, (cudaStream_t)stream);
}

// The launch lagomorph_shoot2d_bwd makes at (N, H, W, tile): out[0] the
// path (1 register, 0 tile), out[1] the tile height TJ, out[2] the
// cooperative grid's blocks, out[3] the threads of a block, out[4] its
// dynamic shared memory in bytes, out[5..7] the tiles of phases 1, 2 and 3.
extern "C" int lagomorph_shoot2d_bwd_grid(int N, int H, int W, int tile, int* out) {
  using namespace lagomorph;
  BwdConfig c;
  const int err = shoot2d_bwd_config(N, H, W, -1, tile, &c);
  return err != (int)cudaSuccess ? err : bwd_report(c, out);
}
