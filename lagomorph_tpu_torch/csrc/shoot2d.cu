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
// is one cooperative persistent launch: the grid is as many blocks as the
// card holds at once (occupancy x SMs), each phase walks its work in a
// grid-stride loop, and phases are separated by grid-wide barriers
// (cooperative_groups::this_grid().sync()).  A substep's working set (4 MB
// per field at 256^2 b8) stays in the 50 MB L2 between phases.  Per
// forward substep, three phases:
//   A. rows: Ad* of TJ rows computed into a shared-memory tile (mw_t to
//      the stash), forward DFT along W, to a complex scratch plane;
//   B. columns: forward DFT along H, times Mn, inverse DFT along H;
//   C. rows: inverse DFT along W gives v_t (to the stash), and the compose
//      of each pixel of the tile writes phiinv_{t+1}.
// Per reverse step, four phases:
//   1. rows: compose backward; d_v into the tile, forward DFT along W; the
//      transposed warp of g written as the first term of the new g;
//   2. columns, as B;
//   3. rows: inverse DFT along W gives dm (to scratch) and d_mw = (J + I)^T
//      dm (to scratch);
//   4. pixels: the new g += weight-gradient and divergence terms (they need
//      dm and d_mw at neighbours, hence the barrier); d_m0 += the
//      transposed warp of d_mw (a batch-1 m0 sums the subjects in the
//      thread: no atomics).
// The line transforms are K3's (fft_lines.cuh): radix-2 for power-of-two
// lengths, direct sums otherwise.  phiinv_t lives in the trajectory buffer
// itself; without the stash (no autograd) two scratch planes ping-pong.  The
// flag is accumulated per thread and cleared with one atomicAnd per warp at
// the end.
//
// Bound on the H100 (256^2 b8, 4 MB per field, T = 4): K8 must read phiinv_0
// and m0 and write phiinv_T and the stash (3T fields), ~60 MB, ~18 us at
// 3.35 TB/s; its arithmetic (4 complex 2D FFTs per substep, ~40 flops per
// pixel per stencil) is ~0.3 GFLOP, ~5 us at 67 TFLOP/s.  So both kernels
// are bound by bytes, and their phases by the latency of the grid barriers
// and of the scratch round trips through L2: the design keeps every
// intermediate plane in L2 and runs 3 (K8) or 4 (K9) barriers per substep.
#include <cooperative_groups.h>

#include "cooperative.cuh"
#include "fft_lines.cuh"
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

__global__ void __launch_bounds__(kShootThreads, 2)
shoot2d_bwd_kernel(const float* __restrict__ m0, const float* __restrict__ g_in,
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

// m0, d_m0: (Nm, 2, H, W); g, d_phi0: (N, 2, H, W); traj_*: (T, N, 2, H, W)
// from K8; cbuf: (N, H, W) complex, dm and dmw: (N, 2, H, W), gbuf: (2, N,
// 2, H, W) scratch.
extern "C" int lagomorph_shoot2d_bwd(const float* m0, const float* g, const float* Mn,
                                     const float* traj_p, const float* traj_v,
                                     const float* traj_mw, float* d_m0, float* d_phi0,
                                     float* cbuf, float* dm, float* dmw, float* gbuf, int N,
                                     int Nm, int H, int W, int T, float s, void* stream) {
  using namespace lagomorph;
  int tj = shoot_tj(H, W);
  float2* c = reinterpret_cast<float2*>(cbuf);
  void* args[] = {&m0, &g, &Mn, &traj_p, &traj_v, &traj_mw, &d_m0, &d_phi0, &c, &dm, &dmw,
                  &gbuf, &N, &Nm, &H, &W, &T, &s, &tj};
  return launch_cooperative((const void*)shoot2d_bwd_kernel, kShootThreads,
                            shoot_smem(H, W, tj), args, (cudaStream_t)stream);
}
