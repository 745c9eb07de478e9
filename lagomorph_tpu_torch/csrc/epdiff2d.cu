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
// writes mw, which K12 reads.  On column strips (see Design).
//
// K11, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff2d.py `_compose2d_fwd_kernel` (`compose2d_pallas`,
// pallas_call at :456).  On column strips, as K10.
//
// K12, Ad* backward (cotangent g of out):
//   d_mw  = (J + I)^T g                                (pointwise)
//   d_m0  = warp transpose of d_mw at weights(phiinv)  (gather form)
//   d_phi = weight-gradient path (image m0, cotangent d_mw)
//           + sum_a D_a^T (g * mw_a)                   (divergence path)
// Replaces epdiff2d.py `_adstar2d_bwd_kernel` (`_adstar2d_bwd`, pallas_call
// at :324), which recomputes d_mw over its slab's 8-row halo.  For batch-N
// m0 (the atlas step's case) it is K9's phase 3 run once, with the
// cotangent read from memory where K9 gets it from an inverse DFT: each
// block stages g, d_mw and the packed weights of phiinv for its tile's
// rows and one halo row on each side (d_mw computed 1 + 2 / TJ times a
// pixel, never kept in a field), then gives each pixel of the tile d_phi
// and d_m0, its 9 sources' weights and d_mw from the stage: one launch.
// A batch-1 m0 gets d_m0 summed over the subjects, in subject order, with
// no atomics, by the per-thread route's two passes: the first writes d_mw
// to a scratch field and finishes d_phi, the second sums the gather
// transposes of that field (the tile kernel writing its rows' d_mw for
// that sum measured slower: profile_epdiff2d.py).
//
// K13, compose backward (cotangent g of out = s v + phiinv(x + s v)):
//   d_phi = warp transpose of g at weights(s v)
//   d_v   = s g + s * (weight-gradient path, image phiinv, cotangent g)
// Replaces epdiff2d.py `_compose2d_bwd_kernel` (`_compose2d_bwd`,
// pallas_call at :490).  One thread a pixel; s v is formed with the
// forward's rounding wherever it is needed, never stored.  K9's phase 1 on
// the same tiles (the packed weights of s v staged once a pixel, in place
// of 9 evaluations) measured slower on the H100, at every tile height and
// register bound tried (profile_epdiff2d.py): its per-pixel part alone
// takes most of the per-thread kernel's time, so the 9 evaluations were
// not what that kernel waits on, and the stage adds to it
// (csrc/profile/epdiff2d_variants.cu keeps that form).
//
// Design.  K10 and K11: column strips that march down rows.  A warp's
// lanes own consecutive strips of PX columns (1, 2 or 4) of one row of one
// subject and march together down a band of RJ rows, so the block index is
// decoded once a march, with int indices.  Each thread holds rows i - 1, i
// and i + 1 of phiinv's two channels (K10: and of m0's) at columns j0 - 1
// .. j0 + PX in register rings; a row's own PX values are one vector load
// where W % PX == 0 and the fields are aligned, and its two halo columns
// come from the neighbouring lanes by shuffles (loaded only at a warp's
// edge; a row's edges fold to clampi's clamp, the ring rows above row 0
// and below H - 1 hold those rows).  Row i + 2 is loaded while row i is
// computed.  The warp sums only its 4 live taps (`s2d::live_sum`, the
// arithmetic of `warp_live`, which K8 runs), each tap a select between two
// ring registers, so K10 and K11 give the 9-tap sums' values, the plain
// versions' bits; the central differences come from the same rings.  The
// flag is one __syncthreads_or a block and one atomicAnd.  fwd_config
// picks PX (the widest that divides W, fills a warp's strips and spills
// nothing) and RJ (the longest band whose grid fills half the blocks the
// SMs hold) per (device, shape).  Fields of 2^31 elements or more take the
// per-thread kernels (`march` -1: the wrapper's fwd_route), one thread a
// pixel over (N, H, W) on the 9 taps with 64-bit indices (the kernels
// before the strips), with the same bits.
// K13, and K12 for a batch-1 m0: one thread per pixel over (N, H, W), W
// fastest across the warp, no shared memory.  K12
// for batch-N m0: row tiles of TJ rows of the N * H rows (a tile may
// straddle two subjects), one block of 256 threads a tile, staged with
// tile2d.cuh's functions, which K9 shares; TJ from tile2d_config (8 at
// 256^2 b8: 256 tiles, two blocks an SM at 81,920 B of shared memory; 4 at
// 512^2 b8), int indices.  Where a stage of one row and its halo does not
// fit a block's shared memory (W > 2,421) or a field has 2^31 elements or
// more, the wrapper takes the per-thread route for batch-N m0 too; both
// routes give the same bits.  Bound on the H100 (256^2 b8, 4.19 MB per
// field): K10 must move 3 fields (read phiinv, m0; write out; 4 with mw),
// K11 3, K12 6 (read phiinv, m0, g, mw; write d_phi, d_m0), K13 5: 4-10 us
// at 3.35 TB/s, near the latency of a launch.
#include <cstdint>
#include <initializer_list>
#include <mutex>

#include "tile2d.cuh"

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

// ---------------------------------------------------------------------------
// K10 and K11 on column strips that march down rows
// ---------------------------------------------------------------------------

// A warp is the unit of work: its lanes own consecutive strips of PX
// columns of one row of one subject, lane l columns j0 = (32 wc + l) PX ..
// j0 + PX - 1, and march together down the rows i0 .. i1 - 1 of a band of
// RJ rows.  Unit u of the launch (warp u of the 1D grid, kWarps a block)
// is (n, band rb, warp column wc) = (u / (WS RB), u / WS % RB, u % WS): WS
// warps across a row, RB = ceil(H / RJ) bands down a subject.
constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;

struct Strips {
  int px, rj, ws, rb;
};

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

// A thread's loads of one row of one plane: its PX columns (clamped), and
// on lane 0 the column left of its strip, on lane 31 the one right of it
// (the halo its neighbours in the warp cannot give it; where it lies
// inside the row)
template <int PX>
struct RowLoad {
  float x[PX];
  float edge;
};

// the PX columns j0 .. at `row` (a row's start), clamped into [0, W); VEC
// (W % PX == 0, the plane aligned to 4 PX bytes): one vector load, a strip
// past the row's end reading the row's last strip in its place
template <int PX, bool VEC>
__device__ __forceinline__ void load_own(float (&x)[PX], const float* __restrict__ row, int j0,
                                         int W) {
  if constexpr (VEC && PX == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + (j0 < W ? j0 : W - 4)));
    x[0] = q.x;
    x[1] = q.y;
    x[2] = q.z;
    x[3] = q.w;
  } else if constexpr (VEC && PX == 2) {
    const float2 q = __ldg(reinterpret_cast<const float2*>(row + (j0 < W ? j0 : W - 2)));
    x[0] = q.x;
    x[1] = q.y;
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k) x[k] = __ldg(row + s2d::clampi(j0 + k, W));
  }
}

template <int PX, bool VEC>
__device__ __forceinline__ void load_row(RowLoad<PX>& r, const float* __restrict__ plane, int i,
                                         int j0, int W, int lane) {
  const float* row = plane + i * W;
  load_own<PX, VEC>(r.x, row, j0, W);
  r.edge = 0.0f;
  if (lane == 0 && j0 > 0) r.edge = __ldg(row + j0 - 1);
  if (lane == 31 && j0 + PX < W) r.edge = __ldg(row + j0 + PX);
}

// A ring row: columns j0 - 1 .. j0 + PX, clamped, from a row's loads.  The
// halo columns come from the neighbouring lanes (every lane of the warp
// shuffles), from `edge` at the warp's edges, and from the strip itself at
// the row's edges (clampi's fold).
template <int PX>
__device__ __forceinline__ void to_ring(float (&R)[PX + 2], const RowLoad<PX>& r, int j0, int W,
                                        int lane) {
  const float up = __shfl_up_sync(kFull, r.x[PX - 1], 1);
  const float dn = __shfl_down_sync(kFull, r.x[0], 1);
  R[0] = j0 == 0 ? r.x[0] : (lane == 0 ? r.edge : up);
#pragma unroll
  for (int k = 0; k < PX; ++k) R[k + 1] = r.x[k];
  R[PX + 1] = j0 + PX >= W ? r.x[PX - 1] : (lane == 31 ? r.edge : dn);
}

// the warp of pixel k of the strip on its 4 live taps (`s2d::live_sum`),
// each tap a select between ring registers: rows above (A), at (B) and
// below (C) the pixel's row, mx: floor(d0) == -1 (rows A, B, else B, C);
// my: floor(d1) == -1 (columns k - 1, k, else k, k + 1).  k, a and b fold
// to constants, so no register array is indexed by a computed value.
template <int PX>
__device__ __forceinline__ float ring_live(const float (&A)[PX + 2], const float (&B)[PX + 2],
                                           const float (&C)[PX + 2], int k, const s2d::W3& wx,
                                           const s2d::W3& wy, bool mx, bool my) {
  const float a0 = my ? A[k] : A[k + 1], a1 = my ? A[k + 1] : A[k + 2];
  const float b0 = my ? B[k] : B[k + 1], b1 = my ? B[k + 1] : B[k + 2];
  const float c0 = my ? C[k] : C[k + 1], c1 = my ? C[k + 1] : C[k + 2];
  return s2d::live_sum(wx, wy, mx ? -1 : 0, my ? -1 : 0, [&](int a, int b) {
    return a == 0 ? (mx ? (b ? a1 : a0) : (b ? b1 : b0)) : (mx ? (b ? b1 : b0) : (b ? c1 : c0));
  });
}

// the strip's PX values to a row (VEC: one vector store), columns past W
// not stored
template <int PX, bool VEC>
__device__ __forceinline__ void store_own(float* __restrict__ row, const float (&x)[PX], int j0,
                                          int W) {
  if constexpr (VEC && PX == 4) {
    if (j0 < W) *reinterpret_cast<float4*>(row + j0) = make_float4(x[0], x[1], x[2], x[3]);
  } else if constexpr (VEC && PX == 2) {
    if (j0 < W) *reinterpret_cast<float2*>(row + j0) = make_float2(x[0], x[1]);
  } else {
#pragma unroll
    for (int k = 0; k < PX; ++k)
      if (j0 + k < W) row[j0 + k] = x[k];
  }
}

// the ring moves down a row: rows i, i + 1 up, the new row below
template <int PX, int C>
__device__ __forceinline__ void ring_down(float (&R)[3][C][PX + 2], const RowLoad<PX> (&r)[C],
                                          int j0, int W, int lane) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
#pragma unroll
    for (int k = 0; k < PX + 2; ++k) {
      R[0][c][k] = R[1][c][k];
      R[1][c][k] = R[2][c][k];
    }
    to_ring<PX>(R[2][c], r[c], j0, W, lane);
  }
}

// The march's unit, decoded once: subject n, rows i0 .. i1 - 1, first
// column j0 of the lane's strip; false for a warp past the grid's units
struct March {
  int n, i0, i1, j0;
};

__device__ __forceinline__ bool march_of(const Strips& st, int N, int H, int lane, March& m) {
  const int u = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (u >= N * st.rb * st.ws) return false;
  const int wc = u % st.ws, t = u / st.ws;
  const int rb = t % st.rb;
  m.n = t / st.rb;
  m.i0 = rb * st.rj;
  m.i1 = imin(m.i0 + st.rj, H);
  m.j0 = (wc * 32 + lane) * st.px;
  return true;
}

// K10 on column strips: rings of phiinv's and m0's two channels, rows i - 1
// .. i + 1 (clamped) at columns j0 - 1 .. j0 + PX; row i + 2's loads issued
// before row i's arithmetic (PREFETCH).  Bounded for two blocks an SM.
template <int PX, bool VEC, bool PREFETCH>
__global__ void __launch_bounds__(kThreads, 2)
ad_star2d_march_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
                       float* __restrict__ out, float* __restrict__ mw_out, int* flag, int N,
                       int Nm, int H, int W, Strips st) {
  const int lane = threadIdx.x & 31;
  bool bad = false;
  March m;
  if (march_of(st, N, H, lane, m)) {
    const int HW = H * W, F = 2 * HW;
    const float* ph = phiinv + m.n * F;
    const float* mb = m0 + (Nm == 1 ? 0 : m.n * F);
    float P[3][2][PX + 2], M[3][2][PX + 2];
    RowLoad<PX> rp[2], rm[2];
    const auto load = [&](int i) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        load_row<PX, VEC>(rp[c], ph + c * HW, i, m.j0, W, lane);
        load_row<PX, VEC>(rm[c], mb + c * HW, i, m.j0, W, lane);
      }
    };
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      load(s2d::clampi(m.i0 - 1 + r, H));
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        to_ring<PX>(P[r][c], rp[c], m.j0, W, lane);
        to_ring<PX>(M[r][c], rm[c], m.j0, W, lane);
      }
    }
    for (int i = m.i0; i < m.i1; ++i) {
      const bool more = i + 1 < m.i1;
      if (PREFETCH && more) load(s2d::clampi(i + 2, H));
      float o[2][PX], w[2][PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const float d0 = P[1][0][k + 1], d1 = P[1][1][k + 1];
        float jac[2][2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          jac[c][0] = s2d::central(P[2][c][k + 1], P[0][c][k + 1]);
          jac[c][1] = s2d::central(P[1][c][k + 2], P[1][c][k]);
        }
        const s2d::W3 wx = s2d::weights(d0), wy = s2d::weights(d1);
        const bool mx = s2d::live_lo(d0) < 0, my = s2d::live_lo(d1) < 0;
        float mw[2], res[2];
#pragma unroll
        for (int a = 0; a < 2; ++a) mw[a] = ring_live<PX>(M[0][a], M[1][a], M[2][a], k, wx, wy, mx, my);
        s2d::jac_apply(jac, mw, res);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          o[c][k] = res[c];
          w[c][k] = mw[c];
        }
        bad |= m.j0 + k < W && !(s2d::in_unit(d0) && s2d::in_unit(d1));
      }
      const int q = m.n * F + i * W;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        store_own<PX, VEC>(out + q + c * HW, o[c], m.j0, W);
        if (mw_out != nullptr) store_own<PX, VEC>(mw_out + q + c * HW, w[c], m.j0, W);
      }
      if (!PREFETCH && more) load(s2d::clampi(i + 2, H));
      if (more) {
        ring_down<PX, 2>(P, rp, m.j0, W, lane);
        ring_down<PX, 2>(M, rm, m.j0, W, lane);
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicAnd(flag, 0);
}

// K11 on column strips: a ring of phiinv's two channels as K10's, and the
// strip's own v of row i (no halo); row i + 2's phiinv and row i + 1's v
// loaded before row i's arithmetic (PREFETCH)
template <int PX, bool VEC, bool PREFETCH>
__global__ void __launch_bounds__(kThreads, 2)
compose2d_march_kernel(const float* __restrict__ phiinv, const float* __restrict__ v, float s,
                       float* __restrict__ out, int* flag, int N, int H, int W, Strips st) {
  const int lane = threadIdx.x & 31;
  bool bad = false;
  March m;
  if (march_of(st, N, H, lane, m)) {
    const int HW = H * W, F = 2 * HW;
    const float* ph = phiinv + m.n * F;
    const float* vn = v + m.n * F;
    float P[3][2][PX + 2], V[2][PX], nv[2][PX];
    RowLoad<PX> rp[2];
    const auto load = [&](int i, int iv) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        load_row<PX, VEC>(rp[c], ph + c * HW, i, m.j0, W, lane);
        load_own<PX, VEC>(nv[c], vn + c * HW + iv * W, m.j0, W);
      }
    };
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      load(s2d::clampi(m.i0 - 1 + r, H), m.i0);
#pragma unroll
      for (int c = 0; c < 2; ++c) to_ring<PX>(P[r][c], rp[c], m.j0, W, lane);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int k = 0; k < PX; ++k) V[c][k] = nv[c][k];
    for (int i = m.i0; i < m.i1; ++i) {
      const bool more = i + 1 < m.i1;
      if (PREFETCH && more) load(s2d::clampi(i + 2, H), i + 1);
      float o[2][PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) {
        const float d0 = s2d::mul(s, V[0][k]), d1 = s2d::mul(s, V[1][k]);
        const s2d::W3 wx = s2d::weights(d0), wy = s2d::weights(d1);
        const bool mx = s2d::live_lo(d0) < 0, my = s2d::live_lo(d1) < 0;
        o[0][k] = s2d::add(d0, ring_live<PX>(P[0][0], P[1][0], P[2][0], k, wx, wy, mx, my));
        o[1][k] = s2d::add(d1, ring_live<PX>(P[0][1], P[1][1], P[2][1], k, wx, wy, mx, my));
        bad |= m.j0 + k < W && !(s2d::in_unit(d0) && s2d::in_unit(d1));
      }
      const int q = m.n * F + i * W;
#pragma unroll
      for (int c = 0; c < 2; ++c) store_own<PX, VEC>(out + q + c * HW, o[c], m.j0, W);
      if (!PREFETCH && more) load(s2d::clampi(i + 2, H), i + 1);
      if (more) {
        ring_down<PX, 2>(P, rp, m.j0, W, lane);
#pragma unroll
        for (int c = 0; c < 2; ++c)
#pragma unroll
          for (int k = 0; k < PX; ++k) V[c][k] = nv[c][k];
      }
    }
  }
  if (__syncthreads_or(bad) && threadIdx.x == 0) atomicAnd(flag, 0);
}

// The strips of PX columns and bands of RJ rows at (H, W), and the blocks
// of kWarps units that cover N subjects
Strips strips_for(int px, int rj, int H, int W) {
  const int per_row = (W + px - 1) / px;
  return Strips{px, rj, (per_row + 31) / 32, (H + rj - 1) / rj};
}

int strip_blocks(const Strips& st, int N) {
  return (int)(((long)N * st.rb * st.ws + kWarps - 1) / kWarps);
}

// VEC: every field's rows start on a 4 PX-byte boundary (W % PX == 0 and
// the pointers aligned); a null pointer (no mw) does not count
bool vec_ok(int px, int W, std::initializer_list<const void*> ptrs) {
  if (W % px != 0) return false;
  for (const void* p : ptrs)
    if (p != nullptr && (uintptr_t)p % (4 * px) != 0) return false;
  return true;
}

template <int PX, bool VEC, bool PF>
int ad_star2d_march(const Strips& st, const float* phiinv, const float* m0, float* out, float* mw,
                    int* flag, int N, int Nm, int H, int W, cudaStream_t stream) {
  const auto kernel = ad_star2d_march_kernel<PX, VEC, PF>;
  kernel<<<strip_blocks(st, N), kThreads, 0, stream>>>(phiinv, m0, out, mw, flag, N, Nm, H, W, st);
  return (int)cudaGetLastError();
}

// K10 on the strips `st`, vector loads where vec_ok; PF: the prefetch
template <bool PF>
int launch_ad_star2d_march(const Strips& st, const float* phiinv, const float* m0, float* out,
                           float* mw, int* flag, int N, int Nm, int H, int W, cudaStream_t stream) {
  const bool vec = vec_ok(st.px, W, {phiinv, m0, out, mw});
  switch (st.px * 2 + vec) {
    case 2:
    case 3: return ad_star2d_march<1, false, PF>(st, phiinv, m0, out, mw, flag, N, Nm, H, W, stream);
    case 4: return ad_star2d_march<2, false, PF>(st, phiinv, m0, out, mw, flag, N, Nm, H, W, stream);
    case 5: return ad_star2d_march<2, true, PF>(st, phiinv, m0, out, mw, flag, N, Nm, H, W, stream);
    case 8: return ad_star2d_march<4, false, PF>(st, phiinv, m0, out, mw, flag, N, Nm, H, W, stream);
    case 9: return ad_star2d_march<4, true, PF>(st, phiinv, m0, out, mw, flag, N, Nm, H, W, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <int PX, bool VEC, bool PF>
int compose2d_march(const Strips& st, const float* phiinv, const float* v, float s, float* out,
                    int* flag, int N, int H, int W, cudaStream_t stream) {
  const auto kernel = compose2d_march_kernel<PX, VEC, PF>;
  kernel<<<strip_blocks(st, N), kThreads, 0, stream>>>(phiinv, v, s, out, flag, N, H, W, st);
  return (int)cudaGetLastError();
}

// K11 on the strips `st`, as launch_ad_star2d_march
template <bool PF>
int launch_compose2d_march(const Strips& st, const float* phiinv, const float* v, float s,
                           float* out, int* flag, int N, int H, int W, cudaStream_t stream) {
  const bool vec = vec_ok(st.px, W, {phiinv, v, out});
  switch (st.px * 2 + vec) {
    case 2:
    case 3: return compose2d_march<1, false, PF>(st, phiinv, v, s, out, flag, N, H, W, stream);
    case 4: return compose2d_march<2, false, PF>(st, phiinv, v, s, out, flag, N, H, W, stream);
    case 5: return compose2d_march<2, true, PF>(st, phiinv, v, s, out, flag, N, H, W, stream);
    case 8: return compose2d_march<4, false, PF>(st, phiinv, v, s, out, flag, N, H, W, stream);
    case 9: return compose2d_march<4, true, PF>(st, phiinv, v, s, out, flag, N, H, W, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// the march kernel (K10: which 0, K11: 1) of PX columns a strip, vector
// loads, whose resources the chooser reads
const void* march_kernel(int which, int px) {
  if (which == 0)
    return px == 4 ? (const void*)ad_star2d_march_kernel<4, true, true>
         : px == 2 ? (const void*)ad_star2d_march_kernel<2, true, true>
                   : (const void*)ad_star2d_march_kernel<1, false, true>;
  return px == 4 ? (const void*)compose2d_march_kernel<4, true, true>
       : px == 2 ? (const void*)compose2d_march_kernel<2, true, true>
                 : (const void*)compose2d_march_kernel<1, false, true>;
}

// The launch of K10 (which 0) or K11 (1) on its strips at (N, H, W)
struct FwdConfig {
  Strips st;
  int blocks, per_sm;
};

// PX: the widest of 4 and 2 that divides W, gives a warp a row's strips of
// its own (W >= 32 PX) and whose kernel spills nothing; else 1.  RJ:
// `march` (> 0), else the longest of 16, 8, 4, 2 rows whose grid still
// fills half of the blocks the SMs hold of that kernel (at least one an
// SM), else 1: a longer band loads fewer rows twice (2 a band), a smaller
// grid leaves the SMs short of loads in flight (march_length's rule,
// epdiff_unit.cu).  Kept per (device, kernel, shape, march).  Refuses
// fields of 2^31 elements or more (int indices: the per-thread route's).
int fwd_config(int which, int N, int H, int W, int march, FwdConfig* out) {
  if (N < 1 || H < 1 || W < 2 || march < 0 || 2L * N * H * W >= (1L << 31))
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  struct Entry {
    int dev, which, N, H, W, march;
    FwdConfig cfg;
  };
  constexpr int kEntries = 64;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.dev == dev && e.which == which && e.N == N && e.H == H && e.W == W &&
          e.march == march) {
        *out = e.cfg;
        return (int)cudaSuccess;
      }
    }
  }
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  int px = 1;
  for (int p = 4; p >= 2; p /= 2) {
    if (W % p != 0 || W < 32 * p) continue;
    cudaFuncAttributes a;
    if ((err = cudaFuncGetAttributes(&a, march_kernel(which, p))) != cudaSuccess) return (int)err;
    if (a.localSizeBytes == 0) {
      px = p;
      break;
    }
  }
  int per_sm;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, march_kernel(which, px),
                                                           kThreads, 0)) != cudaSuccess)
    return (int)err;
  const long want = (long)sms * (per_sm > 1 ? per_sm / 2 : 1);
  int rj = march;
  if (rj == 0) {
    rj = 16;
    while (rj > 1 && strip_blocks(strips_for(px, rj, H, W), N) < want) rj /= 2;
  }
  const Strips st = strips_for(px, rj, H, W);
  *out = FwdConfig{st, strip_blocks(st, N), per_sm};
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = Entry{dev, which, N, H, W, march, *out};
  return (int)cudaSuccess;
}

// K12 on the per-thread route, first pass: d_mw (to scratch) and d_phi,
// one thread per (n, pixel)
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

// K12's d_m0 from a d_mw field (the per-thread route's second pass, and a
// batch-1 m0's on either route): the gather transpose of d_mw at
// weights(phiinv), one thread per (m0's subject, pixel); a batch-1 m0 sums
// the N subjects in order
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

// K13 on the per-thread route: `s2d::compose_bwd` at each pixel
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

// ---------------------------------------------------------------------------
// K12 on row tiles (tile2d.cuh)
// ---------------------------------------------------------------------------

// shared memory a staged pixel takes: its packed weights, g and d_mw
constexpr int kStagePixel = 32;
constexpr size_t kMaxSmem = 227 * 1024;  // a block's opt-in limit on the H100

size_t stage_bytes(int W, int tj) { return (size_t)kStagePixel * (tj + 2) * W; }

// K12 (batch-N m0) on the tiles of TJ rows, one block a tile (any grid: the
// blocks stride over the tiles); registers bounded for three blocks an SM
__global__ void __launch_bounds__(kThreads, 3)
ad_star2d_bwd_tile_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
                          const float* __restrict__ g, const float* __restrict__ mw,
                          float* __restrict__ d_phi, float* __restrict__ d_m0, int N, int H,
                          int W, int TJ) {
  extern __shared__ __align__(16) float2 k12_smem[];
  const Geo gm = make_geo(N, H, W);
  const int staged = (TJ + 2) * W;
  float4* w = reinterpret_cast<float4*>(k12_smem);
  float2* dm = k12_smem + 2 * staged;  // g at the staged pixels
  float2* dmw = dm + staged;
  for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
    const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
    stage_dmw_from(phiinv, [&](int, int p) { return make_float2(g[p], g[p + gm.HW]); }, dm, dmw,
                   w, nullptr, W, 1, l0, nl, gm);
    __syncthreads();
    adstar_bwd_tile<false>(m0, N, mw, dm, dmw, w, W, 1, d_phi, d_m0, true, l0, nl, gm);
    __syncthreads();  // before the next tile's stage
  }
}

// The launch of K12 on its tiles at (N, H, W): the tile height TJ, the
// tiles (one block each) and the dynamic shared memory
struct TileConfig {
  int tj, blocks;
  size_t smem;
};

// The tile height: `tile` (> 0) if its stage fits, else the one that stages
// the fewest rows an SM, ceil(tiles / SMs) * (TJ + 2), among the heights at
// which two blocks fit an SM (one, where none does); ties keep the taller.
// Kept per (device, shape, tile).  Refuses a shape whose fields have 2^31
// elements or more, or whose stage of one row does not fit (W > 2,421: the
// per-thread route's shapes).
int tile2d_config(int N, int H, int W, int tile, TileConfig* out) {
  if (N < 1 || H < 2 || W < 2 || tile < 0 || 2L * N * H * W >= (1L << 31) ||
      stage_bytes(W, 1) > kMaxSmem)
    return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  struct Entry {
    int dev, N, H, W, tile;
    TileConfig cfg;
  };
  constexpr int kEntries = 32;
  static std::mutex mu;
  static Entry cache[kEntries];
  static int used = 0;
  {
    std::lock_guard<std::mutex> lock(mu);
    for (int i = 0; i < used; ++i) {
      const Entry& e = cache[i];
      if (e.dev == dev && e.N == N && e.H == H && e.W == W && e.tile == tile) {
        *out = e.cfg;
        return (int)cudaSuccess;
      }
    }
  }
  if ((err = cudaFuncSetAttribute(ad_star2d_bwd_tile_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kMaxSmem)) != cudaSuccess)
    return (int)err;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const long NH = (long)N * H;
  int best = 0, best_occ = 0;
  long best_cost = 0;
  for (int tj = tile > 0 ? tile : 32; tj >= (tile > 0 ? tile : 1); --tj) {
    const size_t smem = stage_bytes(W, tj);
    if (smem > kMaxSmem) continue;
    int per_sm;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, ad_star2d_bwd_tile_kernel, kThreads, smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) continue;
    const int occ = per_sm >= 2 ? 2 : 1;
    const long tiles = (NH + tj - 1) / tj;
    const long cost = (tiles + sms - 1) / sms * (tj + 2);
    if (best == 0 || occ > best_occ || (occ == best_occ && cost < best_cost)) {
      best = tj;
      best_occ = occ;
      best_cost = cost;
    }
  }
  if (best == 0) return (int)cudaErrorInvalidValue;
  *out = TileConfig{best, (int)((NH + best - 1) / best), stage_bytes(W, best)};
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = Entry{dev, N, H, W, tile, *out};
  return (int)cudaSuccess;
}

}  // namespace
}  // namespace lagomorph

using lagomorph::grid_for;
using lagomorph::kThreads;

// phiinv, out, mw: (N, 2, H, W); m0: (Nm, 2, H, W), Nm in {1, N}; mw may be
// NULL; flag: one int32 set to 1 by the caller.  march: 0 the strips'
// chooser (fwd_config), > 0 a band of that many rows (PX the chooser's),
// -1 the per-thread kernel (the route of fields of 2^31 elements or more,
// which the strips refuse).
extern "C" int lagomorph_ad_star2d_fwd(const float* phiinv, const float* m0, float* out,
                                       float* mw, int* flag, int N, int Nm, int H, int W,
                                       int march, void* stream) {
  using namespace lagomorph;
  const cudaStream_t st = (cudaStream_t)stream;
  if (march < 0) {
    ad_star2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(phiinv, m0, out, mw,
                                                                         flag, N, Nm, H, W);
    return (int)cudaGetLastError();
  }
  FwdConfig c;
  const int err = fwd_config(0, N, H, W, march, &c);
  if (err != (int)cudaSuccess) return err;
  return launch_ad_star2d_march<true>(c.st, phiinv, m0, out, mw, flag, N, Nm, H, W, st);
}

// phiinv, g, mw, d_phiinv: (N, 2, H, W); m0, d_m0: (Nm, 2, H, W), Nm in
// {1, N}; d_mw: (N, 2, H, W) scratch of the per-thread route (may be NULL
// on the tiles).  tile: the tile height TJ (0: tile2d_config's choice;
// batch-N m0 only), or -1 for the per-thread route.
extern "C" int lagomorph_ad_star2d_bwd(const float* phiinv, const float* m0, const float* g,
                                       const float* mw, float* d_mw, float* d_phiinv,
                                       float* d_m0, int N, int Nm, int H, int W, int tile,
                                       void* stream) {
  using namespace lagomorph;
  if (Nm != N && Nm != 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tile >= 0) {
    if (Nm != N) return (int)cudaErrorInvalidValue;
    TileConfig c;
    const int err = tile2d_config(N, H, W, tile, &c);
    if (err != (int)cudaSuccess) return err;
    ad_star2d_bwd_tile_kernel<<<c.blocks, kThreads, c.smem, st>>>(phiinv, m0, g, mw, d_phiinv,
                                                                  d_m0, N, H, W, c.tj);
    return (int)cudaGetLastError();
  }
  if (d_mw == nullptr) return (int)cudaErrorInvalidValue;
  ad_star2d_bwd_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(phiinv, m0, g, mw, d_mw,
                                                                       d_phiinv, N, Nm, H, W);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ad_star2d_bwd_m0_kernel<<<grid_for((long)Nm * H * W), kThreads, 0, st>>>(phiinv, d_mw, d_m0, N,
                                                                           Nm, H, W);
  return (int)cudaGetLastError();
}

// phiinv, v, out: (N, 2, H, W); flag as K10's; march as K10's
extern "C" int lagomorph_compose2d_fwd(const float* phiinv, const float* v, float s, float* out,
                                       int* flag, int N, int H, int W, int march, void* stream) {
  using namespace lagomorph;
  const cudaStream_t st = (cudaStream_t)stream;
  if (march < 0) {
    compose2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0, st>>>(phiinv, v, s, out, flag,
                                                                         N, H, W);
    return (int)cudaGetLastError();
  }
  FwdConfig c;
  const int err = fwd_config(1, N, H, W, march, &c);
  if (err != (int)cudaSuccess) return err;
  return launch_compose2d_march<true>(c.st, phiinv, v, s, out, flag, N, H, W, st);
}

extern "C" int lagomorph_compose2d_bwd(const float* phiinv, const float* v, float s,
                                       const float* g, float* d_phiinv, float* d_v, int N,
                                       int H, int W, void* stream) {
  lagomorph::compose2d_bwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, v, s, g, d_phiinv, d_v, N,
                                                            H, W);
  return (int)cudaGetLastError();
}

// The launch K12 makes on its tiles at (N, H, W, tile >= 0): out[0] the
// tile height TJ, out[1] the blocks (one a tile), out[2] the dynamic shared
// memory in bytes
extern "C" int lagomorph_ad_star2d_bwd_grid(int N, int H, int W, int tile, int* out) {
  using namespace lagomorph;
  TileConfig c;
  const int err = tile2d_config(N, H, W, tile, &c);
  if (err != (int)cudaSuccess) return err;
  out[0] = c.tj;
  out[1] = c.blocks;
  out[2] = (int)c.smem;
  return (int)cudaSuccess;
}

// The launch of K10 (which 0) or K11 (1) at (N, H, W, march >= 0): out[0]
// the strip's columns PX, out[1] the band's rows RJ, out[2] the blocks (of
// 256 threads, 8 warps), out[3] the blocks an SM holds of that kernel
extern "C" int lagomorph_epdiff2d_fwd_grid(int which, int N, int H, int W, int march, int* out) {
  using namespace lagomorph;
  if (which != 0 && which != 1) return (int)cudaErrorInvalidValue;
  FwdConfig c;
  const int err = fwd_config(which, N, H, W, march, &c);
  if (err != (int)cudaSuccess) return err;
  out[0] = c.st.px;
  out[1] = c.st.rj;
  out[2] = c.blocks;
  out[3] = c.per_sm;
  return (int)cudaSuccess;
}
