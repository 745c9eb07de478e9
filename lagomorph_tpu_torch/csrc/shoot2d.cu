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
// K8, three phases a substep:
//   A. rows: Ad* of each pixel of the tile (phiinv_t and m0 from device
//      memory, through L1; mw_t to the stash, and at t = 0 phiinv_0), and
//      a forward DFT along W to the complex scratch;
//   B. columns: forward DFT along H, times Mn, inverse DFT along H;
//   C. rows: inverse DFT along W gives v_t (to the stash), and compose at
//      each pixel of the tile writes phiinv_{t+1} (to the stash, or to two
//      ping-pong planes without it; to out after the last substep).
// So a call takes 3 T grid barriers.  Merging C into the next substep's A
// (a halo row on each side of the tile inverse-transformed and composed,
// phiinv_{t+1} staged in shared memory for Ad*, two scratch planes in turn:
// 2 T barriers) was measured and lost on the H100 (80GB HBM3, 700 W), 0.0957
// against 0.0937 ms at 256^2 b8 and 1.030 against 0.874 at 512^2 b8 (T = 4):
// the halo rows' compose
// (a quarter more pixels at 8-row tiles) costs more than the barriers it
// saves, and on the tile path the halo takes two of a tile's lines.  The
// stencils' warps sum only
// their 4 live taps (s2d::warp_live), which gives the 9-tap sums' values.
// The flag is accumulated per thread and cleared with one atomicAnd per
// warp at the end.
//
// K9, per reverse step, three phases (a fourth for a batch-1 m0):
//   1. rows: the packed weights of s v_t for the tile's rows and one halo
//      row on each side are staged in shared memory once; compose backward
//      of each pixel (the transposed warp of g gathers its 9 taps' weights
//      from there) writes d_phi_c as the first term of the new g, and d_v
//      goes through a forward DFT along W to the complex scratch;
//   2. columns: forward DFT along H, times Mn, inverse DFT along H;
//   3. rows: the tile's rows and a halo row on each side are inverse-DFT'd
//      along W, giving dm; d_mw = (J + I)^T dm and the packed weights
//      of phiinv_t are staged beside it for those rows, and each pixel of
//      the tile adds Ad*'s weight-gradient and divergence terms to the new
//      g and (batch-N m0) the transposed warp of d_mw to d_m0, reading dm,
//      d_mw and the weights at its neighbours in shared memory;
//   4. (batch-1 m0 only) d_m0 += the transposed warp of d_mw summed over
//      the subjects in the thread (no atomics), from a d_mw scratch that
//      phase 3 writes.
// So a reverse step takes 3 grid barriers (4 for a batch-1 m0) and the dm
// and d_mw fields never leave the SM.
//
// Both kernels: where H and W are powers of two from 32 to 256 (the
// register path; 256^2 b8 is the 2D step's shape) the line transforms are
// K3's register transforms (fft_reg.cuh: G threads a line, one exchange
// through shared memory a transform, the column pass's forward, product
// and inverse all in registers, distribution 2 in and out), H and W are
// template constants and indices ints; their shared memory is the
// exchange slots (and K9's stencil stages), and the tile height is chosen
// so that every phase has about as many tiles as the grid has blocks
// (shoot2d_config, one chooser for both).  Other shapes (512^2, odd sizes)
// take radix-2 or direct-sum tile transforms (fft_lines.cuh; the tile
// path), K9's phase 3 with its halo rows in the tile.  The per-pixel
// arithmetic is stencil2d.cuh's, every product and sum in its order; the
// packed weights (pack_axis) hold exactly the values `s2d::weights` gives.
//
// Bound on the H100 (256^2 b8, 4 MB per field, T = 4): K8 must read phiinv_0
// and m0 and write phiinv_T and the stash (3T fields), ~60 MB, ~18 us at
// 3.35 TB/s; its arithmetic (4 complex 2D FFTs per substep, ~40 flops per
// pixel per stencil) is ~0.3 GFLOP, ~5 us at 67 TFLOP/s.  K9 reads the
// stash and writes d_phiinv_0 and d_m0, ~0.020 ms.  So both kernels are
// bound by bytes, and their phases by the latency of the grid barriers and
// of the scratch round trips through L2; both designs fill the grid and
// keep their line transforms in registers, and K9's keeps its row phases'
// fields in shared memory.
#include <cooperative_groups.h>

#include "cooperative.cuh"
#include "fft_lines.cuh"
#include "fft_plane.cuh"
#include "tile2d.cuh"

namespace cg = cooperative_groups;

namespace lagomorph {

constexpr int kShootThreads = 256;

struct Tiles {
  float2 *twH, *twW, *S, *O;
};

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

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

// ---------------------------------------------------------------------------
// Both kernels' transforms and carve (the geometry and K9's stencil tiles:
// tile2d.cuh)
// ---------------------------------------------------------------------------

constexpr size_t kShootMaxSmem = 227 * 1024;  // a block's opt-in limit on the H100

// the register path's line lengths: powers of two from 32 to 256
static inline bool shoot_reg_axis(int n) { return n >= 32 && n <= 256 && (n & (n - 1)) == 0; }

// ---- the register path's transforms (H, W powers of two from 32 to 256) ----

// The forward row transform (K9's phase 1, K8's A and C): the tile's nl
// rows (row-major in dv) forward along W, natural order out, to rows l0 ..
// of cbuf.  Line j of the block's
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

// The column phase (K9's 2, K8's B) on the columns c0 .. c0 + nc - 1 of the N * W columns (column
// (n, col) of cbuf at stride W): forward along H, times Mn, inverse along
// H (unscaled), all in registers, distribution 2 between.  Line j of the
// block's 256 / G is one lane of a warp (LineSlots in X), so a warp's loads
// are neighbouring columns; the lines past nc transform zeros.
template <int H>
__device__ __forceinline__ void columns(float2* cbuf, const float* __restrict__ Mn, float2* X,
                                        const float2* tw, int c0, int nc, int W) {
  constexpr int G = RegPlan<H>::G, R = RegPlan<H>::R, L = kShootThreads / G;
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

// The inverse row transform (K9's phase 3, K8's C): the tile's staged rows
// (those that exist) inverse along W from cbuf (distribution 2 in),
// unscaled, to dm row-major.
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

// the tile path's inverse row load (K9's phase 3, K8's C): staged row r
// (< nl + 2) of the tile at l0 into line r of the tile S ([k][line], pitch
// TJ + 1); zeros elsewhere
__device__ __forceinline__ void load_staged_rows(const float2* cbuf, float2* S, int l0, int nl,
                                                 int NH, int W, int TJ) {
  const int TP = TJ + 1;
  for (int e = threadIdx.x; e < W * TJ; e += blockDim.x) {
    const int r = e / W, k = e - r * W;
    const int l = l0 - 1 + r;
    S[k * TP + r] = r < nl + 2 && l >= 0 && l < NH ? cbuf[l * W + k] : make_float2(0.0f, 0.0f);
  }
}

// The shared memory of K8 and K9 in float2s.  At 0: K9's packed weights
// w ((TJ + 2) x W float4s); on the register path the line exchanges alias
// them (K8: the exchanges alone).  Then a and b: on the register path K9's
// (TJ + 2) x W each (phase 1's d_v in a, phase 3's dm in a and d_mw in b)
// and K8's a of TJ x W (m, then v_t), on the tile path the tiles S and O
// of L x (TJ + 1).  Then the twiddle tables of H and W.
struct ShootCarve {
  long a, b, tw, total;
};

__host__ __device__ inline ShootCarve shoot_carve(bool fwd, bool reg, int H, int W, int tj) {
  const long staged = (long)(tj + 2) * W;
  long wsz = fwd ? 0 : 2 * staged;
  long a = fwd ? (long)tj * W : staged, b = fwd ? 0 : staged;
  if (reg) {
    const long xr = (long)(kShootThreads / reg_group(W)) * row_pitch(W);
    const long xc = (long)H * (kShootThreads / reg_group(H));
    const long x = xr > xc ? xr : xc;
    if (x > wsz) wsz = (x + 1) / 2 * 2;  // a and b start on 16 bytes
  } else {
    a = b = (long)(H > W ? H : W) * (tj + 1);
  }
  ShootCarve c;
  c.a = wsz;
  c.b = c.a + a;
  c.tw = c.b + b;
  c.total = c.tw + H + W;
  return c;
}

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

// A row tile of K8 is rows l0 .. l0 + nl - 1 of the N * H rows (subjects one
// after another), row j of the tile at out[j * rs + c * cs] (row-major on
// the register path, the tile transforms' layout on the tile path).

// Ad* (`s2d::adstar`, its warp on the 4 live taps) at each pixel
// of the tile at l0 (nl rows), phiinv at P and its taps from device memory:
// mw to mwt (the stash) and phiinv to p0 (phiinv_0 into the stash), each if
// not null; m to out, rows nl .. rows - 1 zero.  Returns whether the
// phiinv of a pixel left the unit regime.
__device__ __forceinline__ bool adstar_tile(const float* __restrict__ P, float* __restrict__ p0,
                                            const float* __restrict__ m0, int Nm,
                                            float* __restrict__ mwt, float2* __restrict__ out,
                                            int rs, int cs, int l0, int nl, int rows,
                                            const Geo& g) {
  bool bad = false;
  const int total = rows * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / g.W, c = e - j * g.W;
    float2 val = make_float2(0.0f, 0.0f);
    if (j < nl) {
      const int l = l0 + j;
      const int n = l / g.H;
      const int i = l - n * g.H;
      const int q = n * g.F + i * g.W + c;
      float m[2], mw[2];
      bad |= !s2d::adstar<true>(P + n * g.F, m0 + (Nm == 1 ? 0 : n * g.F), g.H, g.W, i, c, m, mw);
      if (p0) {
        p0[q] = P[q];
        p0[q + g.HW] = P[q + g.HW];
      }
      if (mwt) {
        mwt[q] = mw[0];
        mwt[q + g.HW] = mw[1];
      }
      val = make_float2(m[0], m[1]);
    }
    out[j * rs + c * cs] = val;
  }
  return bad;
}

// Phase C, once the inverse row DFT has put the tile's rows' v_t / scale at
// v: compose (`s2d::compose`, phiinv_t = P, its warp on the 4 live taps)
// at each pixel gives phiinv_{t+1}, to Pn; v_t also to vt (the
// stash), if not null.  Returns whether s v at a pixel left the unit
// regime.
__device__ __forceinline__ bool compose_tile(const float* __restrict__ P,
                                             const float2* __restrict__ v, int rs, int cs,
                                             float scale, float s, float* __restrict__ vt,
                                             float* __restrict__ Pn, int l0, int nl,
                                             const Geo& g) {
  bool bad = false;
  const int total = nl * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int j = e / g.W, c = e - j * g.W;
    const int l = l0 + j;
    const int n = l / g.H;
    const int i = l - n * g.H;
    const int q = n * g.F + i * g.W + c;
    const float2 x = v[j * rs + c * cs];
    const float v0 = s2d::mul(x.x, scale), v1 = s2d::mul(x.y, scale);
    float o[2];
    bad |= !s2d::compose<true>(P + n * g.F, v0, v1, s, g.H, g.W, i, c, o);
    if (vt) {
      vt[q] = v0;
      vt[q + g.HW] = v1;
    }
    Pn[q] = o[0];
    Pn[q + g.HW] = o[1];
  }
  return bad;
}

// Phase A on the tile at l0: Ad* (adstar_tile) and the forward DFT along W
// of its rows to rows l0 .. of cbuf; the block synchronised on return
template <int RW>
__device__ __forceinline__ bool adstar_rows(const float* P, float* p0,
                                            const float* __restrict__ m0, int Nm, float* mwt,
                                            float2* cbuf, float2* smem, const Tiles& sm, int l0,
                                            int nl, int TJ, const Geo& g) {
  bool bad;
  if constexpr (RW > 0) {
    bad = adstar_tile(P, p0, m0, Nm, mwt, sm.S, RW, 1, l0, nl, nl, g);
    __syncthreads();
    rows_forward<RW>(sm.S, cbuf, smem, sm.twW, l0, nl);
  } else {
    bad = adstar_tile(P, p0, m0, Nm, mwt, sm.S, 1, TJ + 1, l0, nl, TJ, g);
    __syncthreads();
    store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, g.W, TJ, -1.0f), l0, nl, g.W, TJ);
  }
  __syncthreads();  // before the next tile
  return bad;
}

// Phase C on the tile at l0: its rows inverse along W (the transforms stage
// rows l0' - 1 .. l0' + nl' of l0' = l0 + 1, nl' = nl - 2: the tile's own
// rows, row l0 + j in line j), then compose (compose_tile); the block
// synchronised on return
template <int RW>
__device__ __forceinline__ bool compose_rows(const float2* cbuf, const float* P, float s,
                                             float scale, float* vt, float* Pn, float2* smem,
                                             const Tiles& sm, int l0, int nl, int TJ,
                                             const Geo& g) {
  const float2* v;
  int rs, cs;
  if constexpr (RW > 0) {
    rows_inverse<RW>(cbuf, sm.S, smem, sm.twW, l0 + 1, nl - 2, g.NH);
    v = sm.S;
    rs = RW;
    cs = 1;
  } else {
    load_staged_rows(cbuf, sm.S, l0 + 1, nl - 2, g.NH, g.W, TJ);
    __syncthreads();
    v = transform_tile(sm.S, sm.O, sm.twW, g.W, TJ, 1.0f);
    rs = 1;
    cs = TJ + 1;
  }
  __syncthreads();
  const bool bad = compose_tile(P, v, rs, cs, scale, s, vt, Pn, l0, nl, g);
  __syncthreads();  // before the next tile
  return bad;
}

// K8.  RH, RW: H and W on the register path; 0, 0 the tile path.  The
// stencils' warps sum their 4 live taps (`s2d::warp_live`, which gives the
// 9-tap sums' values).  One cooperative launch of
// kShootThreads-thread blocks; the grid may hold fewer blocks than the card
// does (shoot2d_config).  Row tiles of TJ rows, column tiles of TJ columns;
// cbuf: one complex plane of (N, H, W).
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
shoot2d_fwd_kernel(const float* __restrict__ phi0, const float* __restrict__ m0,
                   const float* __restrict__ Mn, float* __restrict__ out, int* flag,
                   float* traj_p, float* traj_v, float* traj_mw, float* pp, float2* cbuf, int N,
                   int Nm, int H, int W, int T, float s, int TJ) {
  constexpr bool REG = RH > 0;
  if constexpr (REG) {  // constants: the stencils' divisions by W and H become shifts
    H = RH;
    W = RW;
  }
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 fwd_smem[];
  float2* smem = fwd_smem;
  const ShootCarve cv = shoot_carve(true, REG, H, W, TJ);
  Tiles sm;
  sm.twH = smem + cv.tw;
  sm.twW = sm.twH + H;
  sm.S = smem + cv.a;
  sm.O = smem + cv.b;
  fill_twiddles(sm.twH, H);
  fill_twiddles(sm.twW, W);
  __syncthreads();

  const Geo gm = make_geo(N, H, W);
  const int NW = N * W;
  const long NF = (long)N * gm.F;
  // the inverse transforms' 1 / (H W): the register path's column pass
  // leaves its 1 / H to the rows (both powers of two, so exact); the tile
  // column pass scales by 1 / H itself
  const float scale = REG ? 1.0f / (float)gm.HW : 1.0f / W;
  bool bad = false;

  // A. Ad* at phiinv_0 (copied to the stash), forward along W
  for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ)
    bad |= adstar_rows<RW>(phi0, traj_p, m0, Nm, traj_mw, cbuf, smem, sm, l0,
                           gm.NH - l0 < TJ ? gm.NH - l0 : TJ, TJ, gm);
  grid.sync();

  for (int t = 0; t < T; ++t) {
    const bool last = t == T - 1;
    const float* P = t == 0 ? phi0 : (traj_p ? traj_p + t * NF : pp + (t & 1) * NF);
    float* Pn = last ? out : (traj_p ? traj_p + (t + 1) * NF : pp + ((t + 1) & 1) * NF);

    // B. columns: forward along H, times Mn, inverse
    if constexpr (REG) {
      for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
        columns<RH>(cbuf, Mn, smem, sm.twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
    } else {
      column_pass(cbuf, Mn, sm, N, H, W, TJ);
    }
    grid.sync();

    // C. inverse along W gives v_t; compose gives phiinv_{t+1}
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ)
      bad |= compose_rows<RW>(cbuf, P, s, scale, traj_v ? traj_v + t * NF : nullptr, Pn,
                              smem, sm, l0, gm.NH - l0 < TJ ? gm.NH - l0 : TJ, TJ, gm);
    if (last) break;
    grid.sync();

    // A of substep t + 1: Ad* at phiinv_{t+1}, forward along W
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ)
      bad |= adstar_rows<RW>(Pn, nullptr, m0, Nm, traj_mw ? traj_mw + (t + 1) * NF : nullptr,
                             cbuf, smem, sm, l0, gm.NH - l0 < TJ ? gm.NH - l0 : TJ, TJ, gm);
    grid.sync();
  }
  clear_flag_if(bad, flag);
}

typedef void (*FwdKernel)(const float*, const float*, const float*, float*, int*, float*, float*,
                          float*, float*, float2*, int, int, int, int, int, float, int);

template <int RH>
static FwdKernel fwd_kernel_w(int W) {
  switch (W) {
    case 32: return shoot2d_fwd_kernel<RH, 32>;
    case 64: return shoot2d_fwd_kernel<RH, 64>;
    case 128: return shoot2d_fwd_kernel<RH, 128>;
    case 256: return shoot2d_fwd_kernel<RH, 256>;
  }
  return nullptr;
}

// K8 on a path
static FwdKernel fwd_kernel(bool reg, int H, int W) {
  if (!reg) return shoot2d_fwd_kernel<0, 0>;
  switch (H) {
    case 32: return fwd_kernel_w<32>(W);
    case 64: return fwd_kernel_w<64>(W);
    case 128: return fwd_kernel_w<128>(W);
    case 256: return fwd_kernel_w<256>(W);
  }
  return nullptr;
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

// K9.  RH, RW: H and W on the register path; 0, 0 the tile path.  One
// cooperative launch of kShootThreads-thread blocks; the grid may hold fewer
// blocks than the card does (shoot2d_config).  Phase 1 and 3 tiles are
// TJ rows (phase 3 on the tile path TJ - 2, its halo rows in the tile of
// TJ lines), phase 2's TJ columns.
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
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
  const ShootCarve cv = shoot_carve(false, REG, H, W, TJ);
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
  // leaves its 1 / H to phase 3 (both powers of two, so exact); the tile
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
// ---------------------------------------------------------------------------
// The launch of K8 and K9
// ---------------------------------------------------------------------------

template <class K>
struct ShootConfig {
  K kernel;
  int reg, tj, blocks;
  size_t smem;
  long tiles[3];  // of the three phases: K9's 1, 2 and 3; K8's A, B and C
};
using FwdConfig = ShootConfig<FwdKernel>;
using BwdConfig = ShootConfig<BwdKernel>;

// a tile height the path takes: on the register path the row transforms'
// lines a block holds (K9 transforms a halo row on each side too) and the
// column transforms', on the tile path a power of two
static bool shoot_tj_valid(bool fwd, bool reg, int H, int W, int tj) {
  if (reg)
    return tj >= 1 && tj + (fwd ? 0 : 2) <= kShootThreads / reg_group(W) &&
           tj <= kShootThreads / reg_group(H);
  return tj >= 4 && tj <= 32 && (tj & (tj - 1)) == 0;
}

// The tiles of each phase: K9's 1 and 3 and K8's A and C are row tiles of
// TJ rows (TJ - 2 in K9's phase 3 on the tile path, whose halo rows take
// lines of the tile), K9's 2 and K8's B column tiles of TJ columns.
static void shoot_tiles(bool fwd, bool reg, int N, int H, int W, int tj, long tiles[3]) {
  const long NH = (long)N * H, NW = (long)N * W;
  const int r3 = reg || fwd ? tj : tj - 2;
  tiles[0] = (NH + tj - 1) / tj;
  tiles[1] = (NW + tj - 1) / tj;
  tiles[2] = (NH + r3 - 1) / r3;
}

// The launch of K8 (fwd) or K9 at (N, H, W), the kernel from kernel_of.
// The path: the register path where H and W are powers of two from 32 to
// 256, else the tile path (reg < 0), or as `reg` says.  The tile height
// TJ: `tile` (> 0) if given, else the one whose phases take the fewest
// line-rounds: a phase takes ceil(tiles / blocks) rounds of its tile's
// lines (TJ; TJ + 2 in K9's phase 3 on the register path, whose halo rows
// are transformed), the grid being as many blocks as the card holds at that
// shared memory, but no more than the most tiles a phase has (a block past
// those would only wait at the barriers); ties keep the taller tile.  A
// chosen configuration is kept per (device, shape, reg, tile), for each
// kernel.
template <class K>
static int shoot2d_config(bool fwd, K (*kernel_of)(bool, int, int), int N, int H, int W, int reg,
                          int tile, ShootConfig<K>* out) {
  if (N < 1 || H < 2 || W < 2 || 2L * N * H * W >= (1L << 31)) return (int)cudaErrorInvalidValue;
  const bool can_reg = shoot_reg_axis(H) && shoot_reg_axis(W);
  if (reg < 0) reg = can_reg;
  if (reg && !can_reg) return (int)cudaErrorInvalidValue;
  int dev;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  struct Entry {
    int dev, N, H, W, reg, tile;
    ShootConfig<K> cfg;
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
  const K kernel = kernel_of(reg, H, W);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kShootMaxSmem);
  if (err != cudaSuccess) return (int)err;
  int sms;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int lo = tile > 0 ? tile : 1, hi = tile > 0 ? tile : 254;
  bool found = false;
  long best = 0;
  for (int tj = hi; tj >= lo; --tj) {
    if (!shoot_tj_valid(fwd, reg, H, W, tj)) continue;
    const size_t smem = (size_t)shoot_carve(fwd, reg, H, W, tj).total * sizeof(float2);
    if (smem > kShootMaxSmem) continue;
    int per_sm;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kShootThreads,
                                                             smem)) != cudaSuccess)
      return (int)err;
    if (per_sm < 1) continue;
    long tiles[3];
    shoot_tiles(fwd, reg, N, H, W, tj, tiles);
    long most = tiles[0] > tiles[1] ? tiles[0] : tiles[1];
    if (tiles[2] > most) most = tiles[2];
    const long blocks = (long)per_sm * sms < most ? (long)per_sm * sms : most;
    const int lines[3] = {tj, tj, reg && !fwd ? tj + 2 : tj};
    long cost = 0;
    for (int p = 0; p < 3; ++p) cost += (tiles[p] + blocks - 1) / blocks * lines[p];
    if (!found || cost < best) {
      found = true;
      best = cost;
      *out = ShootConfig<K>{kernel, reg, tj, (int)blocks, smem, {tiles[0], tiles[1], tiles[2]}};
    }
  }
  if (!found) return (int)cudaErrorInvalidValue;
  std::lock_guard<std::mutex> lock(mu);
  if (used < kEntries) cache[used++] = Entry{dev, N, H, W, reg, tile, *out};
  return (int)cudaSuccess;
}

static int shoot2d_fwd_config(int N, int H, int W, int reg, int tile, FwdConfig* out) {
  return shoot2d_config(true, fwd_kernel, N, H, W, reg, tile, out);
}

static int shoot2d_bwd_config(int N, int H, int W, int reg, int tile, BwdConfig* out) {
  return shoot2d_config(false, bwd_kernel, N, H, W, reg, tile, out);
}

// the launch c makes, in the 8 ints of lagomorph_shoot2d_*_grid's out
template <class K>
static int shoot_report(const ShootConfig<K>& c, int* out) {
  int cap;
  const int err = cooperative_blocks((const void*)c.kernel, kShootThreads, c.smem, &cap);
  if (err != (int)cudaSuccess) return err;
  out[0] = c.reg;
  out[1] = c.tj;
  out[2] = cap < c.blocks ? cap : c.blocks;
  out[3] = kShootThreads;
  out[4] = (int)c.smem;
  for (int p = 0; p < 3; ++p) out[5 + p] = (int)c.tiles[p];
  return (int)cudaSuccess;
}

static int shoot2d_fwd_launch(const FwdConfig& c, const float* phi0, const float* m0,
                              const float* Mn, float* out, int* flag, float* traj_p,
                              float* traj_v, float* traj_mw, float* pp, float* cbuf, int N,
                              int Nm, int H, int W, int T, float s, cudaStream_t stream) {
  if ((Nm != N && Nm != 1) || T < 1) return (int)cudaErrorInvalidValue;
  const bool stash = traj_p != nullptr;
  if (stash ? (traj_v == nullptr || traj_mw == nullptr) : (pp == nullptr && T > 1))
    return (int)cudaErrorInvalidValue;
  const FwdKernel kernel = c.kernel;
  float2* cb = reinterpret_cast<float2*>(cbuf);
  int tj = c.tj;
  void* args[] = {&phi0, &m0, &Mn, &out, &flag, &traj_p, &traj_v, &traj_mw, &pp, &cb,
                  &N,    &Nm, &H,  &W,   &T,    &s,      &tj};
  return launch_cooperative((const void*)kernel, kShootThreads, c.smem, args, stream, c.blocks);
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
  return launch_cooperative((const void*)kernel, kShootThreads, c.smem, args, stream, c.blocks);
}

}  // namespace lagomorph

// phi0, out: (N, 2, H, W); m0: (Nm, 2, H, W), Nm in {1, N}; Mn: (H, W);
// flag: one int32 set to 1 by the caller.  With the stash, traj_p / traj_v
// / traj_mw are (T, N, 2, H, W) and pp is unused; without it the three are
// NULL and pp is (2, N, 2, H, W) scratch.  cbuf: (N, H, W) complex
// scratch.  tile: the tile height TJ (0: the one shoot2d_config chooses;
// the register path takes 1 .. 256 / G of the rows' G, the tile path 4, 8,
// 16 or 32).
extern "C" int lagomorph_shoot2d_fwd(const float* phi0, const float* m0, const float* Mn,
                                     float* out, int* flag, float* traj_p, float* traj_v,
                                     float* traj_mw, float* pp, float* cbuf, int N, int Nm,
                                     int H, int W, int T, float s, int tile, void* stream) {
  using namespace lagomorph;
  FwdConfig c;
  const int err = shoot2d_fwd_config(N, H, W, -1, tile, &c);
  if (err != (int)cudaSuccess) return err;
  return shoot2d_fwd_launch(c, phi0, m0, Mn, out, flag, traj_p, traj_v, traj_mw, pp, cbuf, N, Nm,
                            H, W, T, s, (cudaStream_t)stream);
}

// The launch lagomorph_shoot2d_fwd makes at (N, H, W, tile): out[0] the
// path (1 register, 0 tile), out[1] the tile height TJ, out[2] the
// cooperative grid's blocks, out[3] the threads of a block, out[4] its
// dynamic shared memory in bytes, out[5..7] the tiles of phases A, B and C.
extern "C" int lagomorph_shoot2d_fwd_grid(int N, int H, int W, int tile, int* out) {
  using namespace lagomorph;
  FwdConfig c;
  const int err = shoot2d_fwd_config(N, H, W, -1, tile, &c);
  return err != (int)cudaSuccess ? err : shoot_report(c, out);
}

// m0, d_m0: (Nm, 2, H, W), Nm in {1, N}; g, d_phi0: (N, 2, H, W); traj_*:
// (T, N, 2, H, W) from K8; cbuf: (N, H, W) complex scratch; dmw: (N, 2, H,
// W) scratch for a batch-1 m0 of N > 1 subjects, else unused (may be NULL);
// gbuf: (2, N, 2, H, W) scratch.  tile: the tile height TJ (0: the one
// shoot2d_config chooses; the register path takes 1 .. 256 / G - 2 of
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
  return err != (int)cudaSuccess ? err : shoot_report(c, out);
}