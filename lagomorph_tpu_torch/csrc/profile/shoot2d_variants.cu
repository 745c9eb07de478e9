// Variants of K9 (the 2D whole-shoot backward), for profile_shoot2d.py only
// (not part of the kernel library; built by that script, with shoot2d.cu
// included).  They split the cost of the previous kernel and of the
// current one's parts:
//
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
// The current kernel on the tile path at register shapes is
// shoot2d_bwd_config's `reg` = 0 (prof_shoot2d_bwd with path 0).
#include "../shoot2d.cu"

namespace lagomorph {

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
__global__ void __launch_bounds__(kBwdThreads, 2)
unmerged_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
                const float* __restrict__ Mn, const float* __restrict__ traj_p,
                const float* __restrict__ traj_v, const float* __restrict__ traj_mw, float* d_m0,
                float* d_phi0, float2* cbuf, float* dm_f, float* dmw_f, float* gbuf, int N, int H,
                int W, int T, float s, int TJ) {
  constexpr bool REG = RH > 0;
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
__global__ void __launch_bounds__(kBwdThreads, 2)
parts_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
             const float* __restrict__ Mn, const float* __restrict__ traj_p,
             const float* __restrict__ traj_v, const float* __restrict__ traj_mw, float* d_m0,
             float* d_phi0, float2* cbuf, float* gbuf, int N, int T, float s, int TJ, int mask) {
  constexpr int H = RH, W = RW;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) float2 bwd_smem[];
  float2* smem = bwd_smem;
  const BwdCarve cv = bwd_carve(true, H, W, TJ);
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

// The previous K9's grid at (N, H, W): out[0] its blocks, out[1] its tile
// height, out[2] the tiles of its row and column phases
extern "C" int prof_shoot2d_bwd_prev_grid(int N, int H, int W, int* out) {
  const int tj = shoot_tj(H, W);
  out[1] = tj;
  out[2] = (int)(((long)N * (H > W ? H : W) + tj - 1) / tj);
  return cooperative_blocks((const void*)prev_bwd_kernel, kShootThreads, shoot_smem(H, W, tj),
                            &out[0]);
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
  if (out && (err = bwd_report(c, out)) != (int)cudaSuccess) return err;
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
  return launch_cooperative((const void*)kernel, kBwdThreads, c.smem, args, (cudaStream_t)stream,
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
  return launch_cooperative((const void*)kernel, kBwdThreads, c.smem, args, (cudaStream_t)stream,
                            c.blocks);
}
