// Variants of K8 and K9 (the 2D whole-shoot forward and backward), for
// profile_shoot2d.py only (not part of the kernel library; built by that
// script, with shoot2d.cu included).  They split the cost of the previous
// kernels and of the current ones' parts.
//
// K8:
//   prev_fwd_kernel: K8 before its redesign, as it was: three phases a
//     substep (Ad* and the forward row DFT; the columns; the inverse rows
//     and compose), 16-line tiles, radix-2 tile transforms (stages between
//     barriers), long indices and runtime H, W, the stencils' taps from
//     device memory, launched on the card's whole cooperative grid or on
//     fewer blocks (`max_blocks`);
//   prev_fwd_barriers_kernel: its launch with the phase bodies emptied, the
//     3 T grid barriers alone;
//   merged_fwd_kernel: the current kernel with phase C merged into the
//     next substep's A: the tile's rows and a halo row on each side
//     inverse along W and composed, phiinv_{t+1} staged in shared memory
//     and Ad* of the tile from that stage, then the forward row DFT to the
//     other of two scratch planes (2 T barriers; on the tile path the halo
//     rows take two lines of each tile);
//   the current kernel on all 9 taps (fwd_kernel<false>: its stencils'
//     warps as `s2d::warp`, zero weights included);
//   parts_fwd_kernel: the current kernel on the register path (256^2) with
//     parts of its phases left out by a mask: 1 Ad*, 2 the forward row
//     transforms, 4 phase B, 8 phase C's inverse row transform, 16 its
//     compose; the barriers stay.  Its output is not K8's: it times the
//     parts.
// K9:
//   prev_bwd_kernel: K9 before its redesign, as it was: four phases a
//     reverse step (compose backward and the forward row DFT; the columns;
//     the inverse rows to dm and d_mw fields; one thread a pixel for the new
//     g and d_m0, recomputing a source's weights for each of its 9 taps),
//     K8's tile transforms (radix-2 stages between barriers), launched on
//     the card's whole cooperative grid or on fewer blocks (`max_blocks`);
//   prev_barriers_kernel: its launch with the phase bodies emptied, the
//     4 T grid barriers alone;
//   unmerged_kernel: the current kernel with phase 3 split as the
//     previous kernel's was: the tile's own rows inverse along W (no halo)
//     to dm and d_mw fields, a grid barrier, then each tile stages dm, d_mw
//     and the weights of phiinv with its halo from those fields and runs
//     the current phase 3's per-pixel part (batch-N m0 only);
//   parts_kernel: the current kernel on the register path (256^2) with
//     parts of its phases left out by a mask: 1 phase 1's stencil (the
//     weights staged, compose backward), 2 its row transform, 4 phase 2, 8
//     phase 3's row transform, 16 its stencils (d_mw staged, Ad*'s terms);
//     the barriers stay.  Its output is not K9's: it times the parts.
// The current kernels on the tile path at register shapes are
// shoot2d_config's `reg` = 0 (prof_shoot2d_fwd / prof_shoot2d_bwd with
// path 0).
#include "../shoot2d.cu"

namespace lagomorph {

// ---------------------------------------------------------------------------
// The previous kernels' tiles (both took them)
// ---------------------------------------------------------------------------

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

__device__ __forceinline__ Tiles carve(float2* smem, int H, int W, int TJ) {
  const int L = H > W ? H : W;
  Tiles t;
  t.twH = smem;
  t.twW = t.twH + H;
  t.S = t.twW + W;
  t.O = t.S + (long)L * (TJ + 1);
  return t;
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

// ---------------------------------------------------------------------------
// K8
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kShootThreads, 2)
prev_fwd_kernel(const float* __restrict__ phi0, const float* __restrict__ m0,
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

__global__ void __launch_bounds__(kShootThreads, 2) prev_fwd_barriers_kernel(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = 0; t < T; ++t)
    for (int p = 0; p < 3; ++p) grid.sync();
}

// ---- the merged form: phase C with the next substep's Ad* ----

// Its shared memory in float2s: the stage ph of phiinv at 0 ((TJ + 2) x W
// on the register path, where the line exchanges alias it; TJ x W on the
// tile path, whose tiles of TJ lines hold the halo rows), then a ((TJ + 2)
// x W; the tile path's S and O of L x (TJ + 1)), then the twiddles.
__host__ __device__ inline ShootCarve merged_carve(bool reg, int H, int W, int tj) {
  const long staged = (long)(tj + 2) * W;
  long wsz = reg ? staged : (long)tj * W;
  long a = staged, b = 0;
  if (reg) {
    const long xr = (long)(kShootThreads / reg_group(W)) * row_pitch(W);
    const long xc = (long)H * (kShootThreads / reg_group(H));
    const long x = xr > xc ? xr : xc;
    if (x > wsz) wsz = (x + 1) / 2 * 2;
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

// A row tile's stage ph holds phiinv at its rows and one halo row on each
// side, both channels of a pixel as one float2: staged row r is row l0 -
// 1 + r, at ph[r * W + c] (a row outside [0, N H) is not staged).

// phiinv (P) at the staged pixels of the tile at l0; the tile's own rows
// also to p0 (the stash), if not null
__device__ __forceinline__ void stage_phi(float2* __restrict__ ph, const float* __restrict__ P,
                                          float* __restrict__ p0, int l0, int nl, const Geo& g) {
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    if (l < 0 || l >= g.NH) continue;
    const int n = l / g.H;
    const int q = n * g.F + (l - n * g.H) * g.W + c;
    const float x = P[q], y = P[q + g.HW];
    ph[e] = make_float2(x, y);
    if (p0 && r >= 1 && r <= nl) {
      p0[q] = x;
      p0[q + g.HW] = y;
    }
  }
}

// adstar_tile with phiinv and the Jacobian's neighbours from the stage
__device__ __forceinline__ bool adstar_staged(const float2* __restrict__ ph,
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
      const float2* row = ph + (j + 1) * g.W;
      const float2 p = row[c];
      const float2 lo = (i > 0 ? row - g.W : row)[c], hi = (i < g.H - 1 ? row + g.W : row)[c];
      const float2 le = row[c > 0 ? c - 1 : c], ri = row[c < g.W - 1 ? c + 1 : c];
      const float jac[2][2] = {{s2d::central(hi.x, lo.x), s2d::central(ri.x, le.x)},
                               {s2d::central(hi.y, lo.y), s2d::central(ri.y, le.y)}};
      float m[2], mw[2];
      s2d::adstar_jac<true>(m0 + (Nm == 1 ? 0 : n * g.F), p.x, p.y, jac, g.H, g.W, i, c, m, mw);
      bad |= !(s2d::in_unit(p.x) && s2d::in_unit(p.y));
      if (mwt) {
        const int q = n * g.F + i * g.W + c;
        mwt[q] = mw[0];
        mwt[q + g.HW] = mw[1];
      }
      val = make_float2(m[0], m[1]);
    }
    out[j * rs + c * cs] = val;
  }
  return bad;
}

// compose at each staged pixel of the tile at l0 (v_t / scale at v[r * rs
// + c * cs] for staged row r): phiinv_{t+1} to ph (halo rows too) unless
// ph is null; the tile's own rows also v_t to vt, if not null, and
// phiinv_{t+1} to Pn
__device__ __forceinline__ bool compose_halo(const float* __restrict__ P,
                                             const float2* __restrict__ v, int rs, int cs,
                                             float scale, float s, float* __restrict__ vt,
                                             float* __restrict__ Pn, float2* __restrict__ ph,
                                             int l0, int nl, const Geo& g) {
  bool bad = false;
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    const bool own = r >= 1 && r <= nl;
    if (l < 0 || l >= g.NH || !(own || ph)) continue;
    const int n = l / g.H;
    const int i = l - n * g.H;
    const int q = n * g.F + i * g.W + c;
    const float2 x = v[r * rs + c * cs];
    const float v0 = s2d::mul(x.x, scale), v1 = s2d::mul(x.y, scale);
    float o[2];
    const bool ok = s2d::compose<true>(P + n * g.F, v0, v1, s, g.H, g.W, i, c, o);
    if (ph) ph[e] = make_float2(o[0], o[1]);
    if (own) {
      bad |= !ok;
      if (vt) {
        vt[q] = v0;
        vt[q + g.HW] = v1;
      }
      Pn[q] = o[0];
      Pn[q + g.HW] = o[1];
    }
  }
  return bad;
}

// Ad* of the tile at l0 at the staged phiinv and the forward DFT along W
template <int RW>
__device__ __forceinline__ bool staged_rows(const float2* ph, const float* __restrict__ m0,
                                            int Nm, float* mwt, float2* cbuf, float2* smem,
                                            const Tiles& sm, int l0, int nl, int TJ,
                                            const Geo& g) {
  bool bad;
  if constexpr (RW > 0) {
    bad = adstar_staged(ph, m0, Nm, mwt, sm.S, RW, 1, l0, nl, nl, g);
    __syncthreads();  // m staged, ph read: the exchange may overwrite it
    rows_forward<RW>(sm.S, cbuf, smem, sm.twW, l0, nl);
  } else {
    bad = adstar_staged(ph, m0, Nm, mwt, sm.S, 1, TJ + 1, l0, nl, TJ, g);
    __syncthreads();
    store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, g.W, TJ, -1.0f), l0, nl, g.W, TJ);
  }
  __syncthreads();
  return bad;
}

// K8 merged (see the head): phase C inverse-transforms and composes its
// tile's rows and a halo row on each side, phiinv_{t+1} staged, then the
// next substep's Ad* from the stage (2 T barriers); two scratch planes in
// turn (cbuf (2, N, H, W)); row tiles of TJ rows (TJ - 2 on the tile path)
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
merged_fwd_kernel(const float* __restrict__ phi0, const float* __restrict__ m0,
                  const float* __restrict__ Mn, float* __restrict__ out, int* flag,
                  float* traj_p, float* traj_v, float* traj_mw, float* pp, float2* cbuf, int N,
                  int Nm, int H, int W, int T, float s, int TJ) {
  constexpr bool REG = RH > 0;
  if constexpr (REG) {
    H = RH;
    W = RW;
  }
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 fwd_smem[];
  float2* smem = fwd_smem;
  const ShootCarve cv = merged_carve(REG, H, W, TJ);
  float2* ph = smem;
  Tiles sm;
  sm.twH = smem + cv.tw;
  sm.twW = sm.twH + H;
  sm.S = smem + cv.a;
  sm.O = smem + cv.b;
  fill_twiddles(sm.twH, H);
  fill_twiddles(sm.twW, W);
  __syncthreads();

  const Geo gm = make_geo(N, H, W);
  const int R = REG ? TJ : TJ - 2;
  const int NW = N * W;
  const int plane = N * gm.HW;
  const long NF = (long)N * gm.F;
  const float scale = REG ? 1.0f / (float)gm.HW : 1.0f / W;
  bool bad = false;

  for (int l0 = blockIdx.x * R; l0 < gm.NH; l0 += gridDim.x * R) {
    const int nl = gm.NH - l0 < R ? gm.NH - l0 : R;
    stage_phi(ph, phi0, traj_p, l0, nl, gm);
    __syncthreads();
    bad |= staged_rows<RW>(ph, m0, Nm, traj_mw, cbuf, smem, sm, l0, nl, TJ, gm);
  }
  grid.sync();

  for (int t = 0; t < T; ++t) {
    const bool last = t == T - 1;
    float2* cb = cbuf + (t & 1) * plane;
    float2* cn = cbuf + ((t + 1) & 1) * plane;
    const float* P = t == 0 ? phi0 : (traj_p ? traj_p + t * NF : pp + (t & 1) * NF);
    float* Pn = last ? out : (traj_p ? traj_p + (t + 1) * NF : pp + ((t + 1) & 1) * NF);
    float* vt = traj_v ? traj_v + t * NF : nullptr;
    float* mwn = traj_mw && !last ? traj_mw + (t + 1) * NF : nullptr;
    if constexpr (REG) {
      for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
        columns<RH>(cb, Mn, smem, sm.twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
    } else {
      column_pass(cb, Mn, sm, N, H, W, TJ);
    }
    grid.sync();
    for (int l0 = blockIdx.x * R; l0 < gm.NH; l0 += gridDim.x * R) {
      const int nl = gm.NH - l0 < R ? gm.NH - l0 : R;
      const float2* v;
      int rs, cs;
      if constexpr (REG) {
        rows_inverse<RW>(cb, sm.S, smem, sm.twW, l0, nl, gm.NH);
        v = sm.S;
        rs = W;
        cs = 1;
      } else {
        load_staged_rows(cb, sm.S, l0, nl, gm.NH, W, TJ);
        __syncthreads();
        v = transform_tile(sm.S, sm.O, sm.twW, W, TJ, 1.0f);
        rs = 1;
        cs = TJ + 1;
      }
      __syncthreads();  // v staged, the exchange read: ph may be overwritten
      bad |= compose_halo(P, v, rs, cs, scale, s, vt, Pn, last ? nullptr : ph, l0, nl, gm);
      __syncthreads();  // phiinv_{t+1} staged, v read
      if (!last) bad |= staged_rows<RW>(ph, m0, Nm, mwn, cn, smem, sm, l0, nl, TJ, gm);
    }
    if (!last) grid.sync();
  }
  clear_flag_if(bad, flag);
}

template <int RH>
static FwdKernel merged_kernel_w(int W) {
  switch (W) {
    case 32: return merged_fwd_kernel<RH, 32>;
    case 64: return merged_fwd_kernel<RH, 64>;
    case 128: return merged_fwd_kernel<RH, 128>;
  }
  return merged_fwd_kernel<RH, 256>;
}

// the merged form on a path, as fwd_kernel picks the library's
static FwdKernel merged_kernel(bool reg, int H, int W) {
  if (!reg) return merged_fwd_kernel<0, 0>;
  switch (H) {
    case 32: return merged_kernel_w<32>(W);
    case 64: return merged_kernel_w<64>(W);
    case 128: return merged_kernel_w<128>(W);
  }
  return merged_kernel_w<256>(W);
}

// the current kernel with the parts of its phases that `mask` leaves out
// skipped (see the head); register path, batch-N m0, with the stash
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
parts_fwd_kernel(const float* __restrict__ phi0, const float* __restrict__ m0,
                 const float* __restrict__ Mn, float* __restrict__ out, int* flag, float* traj_p,
                 float* traj_v, float* traj_mw, float2* cbuf, int N, int T, float s, int TJ,
                 int mask) {
  constexpr int H = RH, W = RW;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 fwd_smem[];
  float2* smem = fwd_smem;
  const ShootCarve cv = shoot_carve(true, true, H, W, TJ);
  float2* a = smem + cv.a;
  float2* twH = smem + cv.tw;
  float2* twW = twH + H;
  fill_twiddles(twH, H);
  fill_twiddles(twW, W);
  __syncthreads();
  const Geo gm = make_geo(N, H, W);
  const int NW = N * W;
  const long NF = (long)N * gm.F;
  bool bad = false;
  for (int t = -1; t < T; ++t) {  // t = -1: phase A at phiinv_0
    const float* P = t < 0 ? phi0 : (t == 0 ? phi0 : traj_p + t * NF);
    float* Pn = t == T - 1 ? out : traj_p + (t + 1) * NF;
    if (t >= 0) {
      if (mask & 4)
        for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
          columns<RH>(cbuf, Mn, smem, twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
      grid.sync();
      for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
        const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
        if (mask & 8) rows_inverse<RW>(cbuf, a, smem, twW, l0 + 1, nl - 2, gm.NH);
        __syncthreads();
        if (mask & 16)
          bad |= compose_tile<true>(P, a, W, 1, 1.0f / gm.HW, s, traj_v + t * NF, Pn, l0, nl, gm);
        __syncthreads();
      }
      if (t == T - 1) break;
      grid.sync();
    }
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      if (mask & 1)
        bad |= adstar_tile<true>(t < 0 ? phi0 : Pn, t < 0 ? traj_p : nullptr, m0, N,
                                 traj_mw + (t + 1) * NF, a, W, 1, l0, nl, nl, gm);
      __syncthreads();
      if (mask & 2) rows_forward<RW>(a, cbuf, smem, twW, l0, nl);
      __syncthreads();
    }
    grid.sync();
  }
  clear_flag_if(bad, flag);
}

// ---------------------------------------------------------------------------
// K9
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kShootThreads, 2)
prev_bwd_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
                   const float* __restrict__ Mn, const float* __restrict__ traj_p,
                   const float* __restrict__ traj_v, const float* __restrict__ traj_mw,
                   float* d_m0, float* d_phi0, float2* cbuf, float* dm, float* dmw,
                   float* gbuf, int N, int Nm, int H, int W, int T, float s, int TJ) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  const Tiles sm = carve(smem, H, W, TJ);
  fill_twiddles(sm.twH, H);
  fill_twiddles(sm.twW, W);
  __syncthreads();

  const int TP = TJ + 1;
  const long HW = (long)H * W;
  const long F = 2 * HW;
  const long NF = (long)N * F;
  const long nrows = (long)N * H;
  const long ntiles = (nrows + TJ - 1) / TJ;
  const int total = W * TJ;
  const float inv_w = 1.0f / W;
  const long gstride = (long)gridDim.x * blockDim.x;
  const long tid = (long)blockIdx.x * blockDim.x + threadIdx.x;

  for (int t = T - 1; t >= 0; --t) {
    const float* P = traj_p + t * NF;
    const float* V = traj_v + t * NF;
    const float* MW = traj_mw + t * NF;
    const float* G = t == T - 1 ? g_in : gbuf + ((t + 1) % 2) * NF;
    float* Gn = t == 0 ? d_phi0 : gbuf + (t % 2) * NF;

    // 1. compose backward; d_v into the tile, forward DFT along W
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
          float d_phi[2], d_v[2];
          s2d::compose_bwd(P + n * F, V + n * F, s, G + n * F, H, W, i, col, d_phi, d_v);
          Gn[q] = d_phi[0];
          Gn[q + HW] = d_phi[1];
          val = make_float2(d_v[0], d_v[1]);
        }
        sm.S[col * TP + j] = val;
      }
      __syncthreads();
      store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, W, TJ, -1.0f), l0, nl, W, TJ);
      __syncthreads();
    }
    grid.sync();

    // 2. columns
    column_pass(cbuf, Mn, sm, N, H, W, TJ);
    grid.sync();

    // 3. inverse DFT along W gives dm; d_mw = (J + I)^T dm
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
          const float g0 = r.x * inv_w, g1 = r.y * inv_w;
          dm[q] = g0;
          dm[q + HW] = g1;
          float d[2];
          s2d::adstar_bwd_dmw(P + n * F, g0, g1, H, W, i, col, d);
          dmw[q] = d[0];
          dmw[q + HW] = d[1];
        }
      }
      __syncthreads();
    }
    grid.sync();

    // 4. the new g: compose's term + Ad*'s weight-gradient and divergence
    // terms; d_m0 += the transposed warp of d_mw
    for (long e = tid; e < (long)N * HW; e += gstride) {
      const int n = (int)(e / HW);
      const long p = e - (long)n * HW;
      const int i = (int)(p / W), col = (int)(p - (long)i * W);
      const long q = (long)n * F + p;
      float d[2];
      s2d::adstar_bwd_dphi(P + n * F, m0 + (Nm == 1 ? 0 : n * F), dm + n * F, MW + n * F,
                           dmw[q], dmw[q + HW], H, W, i, col, d);
      Gn[q] = s2d::add(Gn[q], d[0]);
      Gn[q + HW] = s2d::add(Gn[q + HW], d[1]);
    }
    for (long e = tid; e < (long)Nm * HW; e += gstride) {
      const int nm = (int)(e / HW);
      const long p = e - (long)nm * HW;
      const int i = (int)(p / W), col = (int)(p - (long)i * W);
      const int n0 = Nm == 1 ? 0 : nm, n1 = Nm == 1 ? N : nm + 1;
      float acc[2] = {0.0f, 0.0f};
      for (int n = n0; n < n1; ++n) {
        float d[2];
        s2d::warp_transpose(P + n * F, 1.0f, dmw + n * F, H, W, i, col, d);
        acc[0] = s2d::add(acc[0], d[0]);
        acc[1] = s2d::add(acc[1], d[1]);
      }
      const long q = (long)nm * F + p;
      d_m0[q] = t == T - 1 ? acc[0] : s2d::add(d_m0[q], acc[0]);
      d_m0[q + HW] = t == T - 1 ? acc[1] : s2d::add(d_m0[q + HW], acc[1]);
    }
    grid.sync();
  }
}


__global__ void __launch_bounds__(kShootThreads, 2) prev_barriers_kernel(int T) {
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t)
    for (int p = 0; p < 4; ++p) grid.sync();
}

// the staged dm and d_mw of the tile at l0 (with its halo) from the fields,
// and the packed weights of phiinv, row-major
__device__ __forceinline__ void stage_from_fields(const float* P, const float* dm_f,
                                                  const float* dmw_f, float2* dm, float2* dmw,
                                                  float4* w, int l0, int nl, const Geo& g) {
  const int total = (nl + 2) * g.W;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    const int r = e / g.W, c = e - r * g.W;
    const int l = l0 - 1 + r;
    if (l < 0 || l >= g.NH) continue;
    const int n = l / g.H;
    const int p = n * g.F + (l - n * g.H) * g.W + c;
    dm[e] = make_float2(dm_f[p], dm_f[p + g.HW]);
    dmw[e] = make_float2(dmw_f[p], dmw_f[p + g.HW]);
    w[e] = pack_weights(P[p], P[p + g.HW]);
  }
}

// the current kernel with phases 3 and 4 apart (see the head); batch-N m0
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
unmerged_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
                const float* __restrict__ Mn, const float* __restrict__ traj_p,
                const float* __restrict__ traj_v, const float* __restrict__ traj_mw, float* d_m0,
                float* d_phi0, float2* cbuf, float* dm_f, float* dmw_f, float* gbuf, int N, int H,
                int W, int T, float s, int TJ) {
  constexpr bool REG = RH > 0;
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
  const int NW = N * W;
  const float scale = REG ? 1.0f / (float)gm.HW : 1.0f / W;
  const int R4 = REG ? TJ : TJ - 2;  // phase 4's rows a tile: its stage holds the halo
  for (int t = T - 1; t >= 0; --t) {
    const long step = (long)t * N * gm.F;
    const float* P = traj_p + step;
    const float* V = traj_v + step;
    const float* MW = traj_mw + step;
    const float* G = t == T - 1 ? g_in : gbuf + ((t + 1) % 2) * N * gm.F;
    float* Gn = t == 0 ? d_phi0 : gbuf + (t % 2) * N * gm.F;

    // 1 and 2: the current kernel's
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      stage_weights(w, V, s, l0, nl, gm);
      __syncthreads();
      if constexpr (REG) {
        compose_bwd_tile(P, G, s, w, Gn, a, W, 1, l0, nl, nl, gm);
        __syncthreads();
        rows_forward<RW>(a, cbuf, smem, sm.twW, l0, nl);
      } else {
        compose_bwd_tile(P, G, s, w, Gn, sm.S, 1, TP, l0, nl, TJ, gm);
        __syncthreads();
        store_rows(cbuf, transform_tile(sm.S, sm.O, sm.twW, W, TJ, -1.0f), l0, nl, W, TJ);
      }
      __syncthreads();
    }
    grid.sync();
    if constexpr (REG) {
      for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
        columns<RH>(cbuf, Mn, smem, sm.twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
    } else {
      column_pass(cbuf, Mn, sm, N, H, W, TJ);
    }
    grid.sync();

    // 3. the tile's own rows inverse along W (no halo): dm, d_mw to the fields
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      const float2* res;
      int rs, cs;
      if constexpr (REG) {
        // rows_inverse stages rows l0' - 1 .. l0' + nl': with l0' = l0 + 1
        // and nl' = nl - 2 those are the tile's own nl rows
        rows_inverse<RW>(cbuf, a, smem, sm.twW, l0 + 1, nl - 2, gm.NH);
        res = a;
        rs = W;
        cs = 1;
      } else {
        res = load_rows_inverse(cbuf, sm, l0, nl, W, TJ);
        rs = 1;
        cs = TP;
      }
      __syncthreads();
      for (int e = threadIdx.x; e < nl * W; e += blockDim.x) {
        const int j = e / W, c = e - j * W;
        const int l = l0 + j;
        const int n = l / H;
        const int i = l - n * H;
        const int p = n * gm.F + i * W + c;
        const float2 v = res[j * rs + c * cs];
        const float g0 = s2d::mul(v.x, scale), g1 = s2d::mul(v.y, scale);
        float d[2];
        s2d::adstar_bwd_dmw(P + n * gm.F, g0, g1, H, W, i, c, d);
        dm_f[p] = g0;
        dm_f[p + gm.HW] = g1;
        dmw_f[p] = d[0];
        dmw_f[p + gm.HW] = d[1];
      }
      __syncthreads();
    }
    grid.sync();

    // 4. per tile: dm, d_mw and the weights staged with the halo from the
    // fields; the current phase 3's per-pixel part
    for (int l0 = blockIdx.x * R4; l0 < gm.NH; l0 += gridDim.x * R4) {
      const int nl = gm.NH - l0 < R4 ? gm.NH - l0 : R4;
      stage_from_fields(P, dm_f, dmw_f, a, b, w, l0, nl, gm);
      __syncthreads();
      adstar_bwd_tile(m0, N, MW, a, b, w, W, 1, Gn, d_m0, t == T - 1, l0, nl, gm);
      __syncthreads();
    }
    if (t > 0) grid.sync();
  }
}

// the current kernel with the parts of its phases that `mask` leaves out
// skipped (see the head); register path, batch-N m0
template <int RH, int RW>
__global__ void __launch_bounds__(kShootThreads, 2)
parts_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
             const float* __restrict__ Mn, const float* __restrict__ traj_p,
             const float* __restrict__ traj_v, const float* __restrict__ traj_mw, float* d_m0,
             float* d_phi0, float2* cbuf, float* gbuf, int N, int T, float s, int TJ, int mask) {
  constexpr int H = RH, W = RW;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 bwd_smem[];
  float2* smem = bwd_smem;
  const ShootCarve cv = shoot_carve(false, true, H, W, TJ);
  float4* w = reinterpret_cast<float4*>(smem);
  float2* a = smem + cv.a;
  float2* b = smem + cv.b;
  float2* twH = smem + cv.tw;
  float2* twW = twH + H;
  fill_twiddles(twH, H);
  fill_twiddles(twW, W);
  __syncthreads();
  const Geo gm = make_geo(N, H, W);
  const int NW = N * W;
  for (int t = T - 1; t >= 0; --t) {
    const long step = (long)t * N * gm.F;
    const float* P = traj_p + step;
    const float* V = traj_v + step;
    const float* MW = traj_mw + step;
    const float* G = t == T - 1 ? g_in : gbuf + ((t + 1) % 2) * N * gm.F;
    float* Gn = t == 0 ? d_phi0 : gbuf + (t % 2) * N * gm.F;
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      if (mask & 1) {
        stage_weights(w, V, s, l0, nl, gm);
        __syncthreads();
        compose_bwd_tile(P, G, s, w, Gn, a, W, 1, l0, nl, nl, gm);
        __syncthreads();
      }
      if (mask & 2) rows_forward<RW>(a, cbuf, smem, twW, l0, nl);
      __syncthreads();
    }
    grid.sync();
    if (mask & 4)
      for (int c0 = blockIdx.x * TJ; c0 < NW; c0 += gridDim.x * TJ)
        columns<RH>(cbuf, Mn, smem, twH, c0, NW - c0 < TJ ? NW - c0 : TJ, W);
    grid.sync();
    for (int l0 = blockIdx.x * TJ; l0 < gm.NH; l0 += gridDim.x * TJ) {
      const int nl = gm.NH - l0 < TJ ? gm.NH - l0 : TJ;
      if (mask & 8) rows_inverse<RW>(cbuf, a, smem, twW, l0, nl, gm.NH);
      __syncthreads();
      if (mask & 16) {
        stage_dmw(P, a, b, w, nullptr, W, 1, 1.0f / gm.HW, l0, nl, gm);
        __syncthreads();
        adstar_bwd_tile(m0, N, MW, a, b, w, W, 1, Gn, d_m0, t == T - 1, l0, nl, gm);
        __syncthreads();
      }
    }
    if (t > 0) grid.sync();
  }
}

typedef void (*Unmerged)(const float*, const float*, const float*, const float*, const float*,
                         const float*, float*, float*, float2*, float*, float*, float*, int, int,
                         int, int, float, int);

template <int RH>
static Unmerged unmerged_kernel_w(int W) {
  switch (W) {
    case 32: return unmerged_kernel<RH, 32>;
    case 64: return unmerged_kernel<RH, 64>;
    case 128: return unmerged_kernel<RH, 128>;
  }
  return unmerged_kernel<RH, 256>;
}

// shoot2d_bwd_config's choice of path, as bwd_kernel makes it
static Unmerged unmerged_kernel_of(bool reg, int H, int W) {
  if (!reg) return unmerged_kernel<0, 0>;
  switch (H) {
    case 32: return unmerged_kernel_w<32>(W);
    case 64: return unmerged_kernel_w<64>(W);
    case 128: return unmerged_kernel_w<128>(W);
  }
  return unmerged_kernel_w<256>(W);
}

}  // namespace lagomorph

using namespace lagomorph;

// The previous K8 (`prev_fwd_kernel`, its arguments as the previous entry
// point's: cbuf one (N, H, W) complex plane), or with `barriers` its
// barriers alone, on the card's grid or on max_blocks (> 0) if fewer
extern "C" int prof_shoot2d_fwd_prev(int barriers, const float* phi0, const float* m0,
                                     const float* Mn, float* out, int* flag, float* traj_p,
                                     float* traj_v, float* traj_mw, float* pp, float* cbuf, int N,
                                     int Nm, int H, int W, int T, float s, int max_blocks,
                                     void* stream) {
  int tj = shoot_tj(H, W);
  float2* c = reinterpret_cast<float2*>(cbuf);
  const size_t smem = shoot_smem(H, W, tj);
  if (barriers) {
    void* args[] = {&T};
    return launch_cooperative((const void*)prev_fwd_barriers_kernel, kShootThreads, smem, args,
                              (cudaStream_t)stream, max_blocks);
  }
  void* args[] = {&phi0, &m0, &Mn, &out, &flag, &traj_p, &traj_v, &traj_mw, &pp, &c,
                  &N, &Nm, &H, &W, &T, &s, &tj};
  return launch_cooperative((const void*)prev_fwd_kernel, kShootThreads, smem, args,
                            (cudaStream_t)stream, max_blocks);
}

// The previous K8's (fwd) or K9's grid at (N, H, W): out[0] its blocks,
// out[1] its tile height, out[2] the tiles of its row and column phases
extern "C" int prof_shoot2d_prev_grid(int fwd, int N, int H, int W, int* out) {
  const int tj = shoot_tj(H, W);
  out[1] = tj;
  out[2] = (int)(((long)N * (H > W ? H : W) + tj - 1) / tj);
  const void* k = fwd ? (const void*)prev_fwd_kernel : (const void*)prev_bwd_kernel;
  return cooperative_blocks(k, kShootThreads, shoot_smem(H, W, tj), &out[0]);
}

// The current K8 on a path (`reg`: 1 register, 0 tile, -1 its own) at tile
// height `tile` (0: its own), or with `variant` 1 the merged form, 2 the
// stencils on all 9 taps (each at the library's tile height and grid; the
// merged form needs TJ + 2 rows' lines on the register path, so where the
// library's tile leaves none it takes TJ = 256 / G - 2, and cbuf (2, N, H,
// W)).  cfg (8 ints, may be NULL): the launch, as
// lagomorph_shoot2d_fwd_grid gives it (the library kernel's).
extern "C" int prof_shoot2d_fwd(int reg, int variant, int tile, const float* phi0,
                                const float* m0, const float* Mn, float* out, int* flag,
                                float* traj_p, float* traj_v, float* traj_mw, float* pp,
                                float* cbuf, int N, int Nm, int H, int W, int T, float s,
                                int* cfg, void* stream) {
  FwdConfig c;
  int err = shoot2d_fwd_config(N, H, W, reg, tile, &c);
  if (err != (int)cudaSuccess) return err;
  if (cfg && (err = shoot_report(c, cfg)) != (int)cudaSuccess) return err;
  if (variant == 1) {
    const int lines = kShootThreads / reg_group(W);
    if (c.reg && c.tj + 2 > lines &&
        (err = shoot2d_fwd_config(N, H, W, reg, lines - 2, &c)) != (int)cudaSuccess)
      return err;
    c.kernel = merged_kernel(c.reg, H, W);
    c.smem = (size_t)merged_carve(c.reg, H, W, c.tj).total * sizeof(float2);
  } else if (variant == 2) {
    c.kernel = fwd_kernel<false>(c.reg, H, W);
  }
  return shoot2d_fwd_launch(c, phi0, m0, Mn, out, flag, traj_p, traj_v, traj_mw, pp, cbuf, N, Nm,
                            H, W, T, s, (cudaStream_t)stream);
}

// parts_fwd_kernel at 256^2, with the stash and batch-N m0 (its grid and
// tile height the current kernel's; cbuf (N, H, W))
extern "C" int prof_shoot2d_fwd_parts(int mask, const float* phi0, const float* m0,
                                      const float* Mn, float* out, int* flag, float* traj_p,
                                      float* traj_v, float* traj_mw, float* cbuf, int N, int T,
                                      float s, void* stream) {
  FwdConfig c;
  int err = shoot2d_fwd_config(N, 256, 256, 1, 0, &c);
  if (err != (int)cudaSuccess) return err;
  auto kernel = parts_fwd_kernel<256, 256>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  float2* cb = reinterpret_cast<float2*>(cbuf);
  int tj = c.tj;
  void* args[] = {&phi0, &m0, &Mn, &out, &flag, &traj_p, &traj_v, &traj_mw, &cb,
                  &N,    &T,  &s,  &tj,  &mask};
  return launch_cooperative((const void*)kernel, kShootThreads, c.smem, args, (cudaStream_t)stream,
                            c.blocks);
}

// The previous K9 (`prev_bwd_kernel`, its arguments as the previous entry
// point's: dm and dmw (N, 2, H, W) scratch), or with `barriers` its
// barriers alone, on the card's grid or on max_blocks (> 0) if fewer
extern "C" int prof_shoot2d_bwd_prev(int barriers, const float* m0, const float* g,
                                     const float* Mn, const float* traj_p, const float* traj_v,
                                     const float* traj_mw, float* d_m0, float* d_phi0,
                                     float* cbuf, float* dm, float* dmw, float* gbuf, int N,
                                     int Nm, int H, int W, int T, float s, int max_blocks,
                                     void* stream) {
  int tj = shoot_tj(H, W);
  float2* c = reinterpret_cast<float2*>(cbuf);
  const size_t smem = shoot_smem(H, W, tj);
  if (barriers) {
    void* args[] = {&T};
    return launch_cooperative((const void*)prev_barriers_kernel, kShootThreads, smem, args,
                              (cudaStream_t)stream, max_blocks);
  }
  void* args[] = {&m0, &g, &Mn, &traj_p, &traj_v, &traj_mw, &d_m0, &d_phi0, &c, &dm, &dmw,
                  &gbuf, &N, &Nm, &H, &W, &T, &s, &tj};
  return launch_cooperative((const void*)prev_bwd_kernel, kShootThreads, smem, args,
                            (cudaStream_t)stream, max_blocks);
}

// The current K9 on a path (`reg`: 1 register, 0 tile, -1 its own) or,
// with `unmerged`, its variant with phases 3 and 4 apart (dm and dmw: (N,
// 2, H, W) fields; batch-N m0), at its own tile height.  out (8 ints, may
// be NULL): the launch, as lagomorph_shoot2d_bwd_grid gives it.
extern "C" int prof_shoot2d_bwd(int reg, int unmerged, const float* m0, const float* g,
                                const float* Mn, const float* traj_p, const float* traj_v,
                                const float* traj_mw, float* d_m0, float* d_phi0, float* cbuf,
                                float* dm, float* dmw, float* gbuf, int N, int Nm, int H, int W,
                                int T, float s, int* out, void* stream) {
  BwdConfig c;
  int err = shoot2d_bwd_config(N, H, W, reg, 0, &c);
  if (err != (int)cudaSuccess) return err;
  if (out && (err = shoot_report(c, out)) != (int)cudaSuccess) return err;
  if (!unmerged)
    return shoot2d_bwd_launch(c, m0, g, Mn, traj_p, traj_v, traj_mw, d_m0, d_phi0, cbuf,
                              Nm != N ? dmw : nullptr, gbuf, N, Nm, H, W, T, s,
                              (cudaStream_t)stream);
  if (Nm != N) return (int)cudaErrorInvalidValue;
  const Unmerged kernel = unmerged_kernel_of(c.reg, H, W);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  float2* cb = reinterpret_cast<float2*>(cbuf);
  int tj = c.tj;
  void* args[] = {&m0, &g, &Mn, &traj_p, &traj_v, &traj_mw, &d_m0, &d_phi0, &cb, &dm, &dmw,
                  &gbuf, &N, &H, &W, &T, &s, &tj};
  return launch_cooperative((const void*)kernel, kShootThreads, c.smem, args, (cudaStream_t)stream,
                            c.blocks);
}

// parts_kernel at 256^2 (its grid and tile height the current kernel's)
extern "C" int prof_shoot2d_bwd_parts(int mask, const float* m0, const float* g, const float* Mn,
                                      const float* traj_p, const float* traj_v,
                                      const float* traj_mw, float* d_m0, float* d_phi0,
                                      float* cbuf, float* gbuf, int N, int T, float s,
                                      void* stream) {
  BwdConfig c;
  int err = shoot2d_bwd_config(N, 256, 256, 1, 0, &c);
  if (err != (int)cudaSuccess) return err;
  auto kernel = parts_kernel<256, 256>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)c.smem);
  if (err != cudaSuccess) return (int)err;
  float2* cb = reinterpret_cast<float2*>(cbuf);
  int tj = c.tj;
  void* args[] = {&m0, &g, &Mn, &traj_p, &traj_v, &traj_mw, &d_m0, &d_phi0, &cb, &gbuf,
                  &N, &T, &s, &tj, &mask};
  return launch_cooperative((const void*)kernel, kShootThreads, c.smem, args, (cudaStream_t)stream,
                            c.blocks);
}
