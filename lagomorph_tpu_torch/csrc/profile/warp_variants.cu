// Variants of the unit-regime warp's kernels, for profile_warp.py only (not
// part of the kernel library; built by that script).  They isolate the
// three costs the previous kernels paid:
//
//   old_fwd_kernel, old_transpose_kernel, old_dd_kernel: the kernels of
//     csrc/warp_unit.cu before their redesign (27 taps per voxel; the
//     transpose recomputing a source's weights for each of its 27 slots;
//     one thread per voxel, nothing staged);
//   weights_kernel + preweighted_transpose_kernel: the old transpose with
//     each source's 9 per-axis weights computed once into a global buffer
//     and read per slot (the recomputation gone, nothing staged);
//   live_dd_kernel: the old weight-gradient pass on the 8 live taps, read
//     through L1 (the 19 dead taps gone, nothing staged);
//   transpose_variant_kernel: the current transpose (csrc/warp_unit.cu,
//     its march along x included) staging alone (MODE 1), or accumulating
//     alone on its first staging (2);
//   old_ad_star_bwd_kernel<false>: K6's first pass before its redesign
//     (one thread per voxel, the 27 taps of m0 and every neighbour read
//     through L1, nothing staged); old_ad_star_bwd_kernel<true>: the same
//     on the 8 live taps; and the current first pass (csrc/epdiff_unit.cu) with its
//     prefetch off (the next plane loaded after the current one's
//     arithmetic, not before it);
//   old_compose_fwd_kernel<false>: K2 before its redesign (one thread per
//     voxel, the 27 taps of phiinv read through L1, nothing staged);
//     old_compose_fwd_kernel<true>: the same on the 8 live taps; and the
//     current K2 (csrc/epdiff_unit.cu) with its prefetch off;
//   old_ad_star_fwd_kernel<false>: K1 before its redesign (one thread per
//     voxel, the 27 taps of m0 and the 6 difference neighbours of phiinv
//     read through L1, nothing staged); old_ad_star_fwd_kernel<true>: the
//     same on the 8 live taps; and the current K1 (csrc/epdiff_unit.cu)
//     with its prefetch off.
#include "../warp_unit.cu"
#include "../epdiff_unit.cu"

namespace lagomorph_profile {
using namespace lagomorph;

// The previous kernels' per-voxel helpers (27 taps, neighbours through
// L1), which the library's kernels no longer use.
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

// The transposed taps of the warp along one axis: the three pairs (u, o)
// with clamp(u + o) == v, which the gather form of the transpose reads at
// output index v.  Slot k (0..2) has offset o = k - 1 and source u = v - o
// when u lies in [0, n); otherwise u + o would be clamped, and the slot
// holds the clamp fold instead: u = v, o = -(k - 1) (at v == 0 the tap
// (0, -1), at v == n - 1 the tap (n - 1, +1); warp_unit.py:477-502
// `where(edge, ...)`).  So every axis has exactly three pairs, edges
// included.  Computed from k, not stored, so a loop over k need not be
// unrolled to stay in registers.  (The
// current transpose folds these edges into its staged weights instead.)
__device__ __forceinline__ void transposed_tap(int v, int n, int k, int& u, int& o) {
  o = k - 1;
  u = v - o;
  if (u < 0 || u >= n) {
    u = v;
    o = -o;
  }
}

__global__ void old_fwd_kernel(const float* __restrict__ I,
                                     const float* __restrict__ disp,
                                     float* __restrict__ out, int N, int NI,
                                     int C, int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));

  const float* d = disp + (long)n * 3 * V + p;
  AxisWeights W[3];
  W[0] = axis_weights(d[0]);
  W[1] = axis_weights(d[V]);
  W[2] = axis_weights(d[2 * V]);
  Taps T;
  make_taps(T, W, axis_idx(x, X), axis_idx(y, Y), axis_idx(z, Z), Y, Z);

  const float* Ib = I + (NI == 1 ? 0L : (long)n * C * V);
  float* o = out + (long)n * C * V + p;
  for (int c = 0; c < C; ++c) o[(long)c * V] = warp_sum(T, Ib + (long)c * V);
}

// the gather-form transpose (see stencil.cuh launch_warp_transpose); one
// thread per (nI, v), channels in chunks of 4 accumulators.  Offsets within
// one field are 32-bit (a field of up to 2^31 voxels); the x-slot loop is
// not unrolled, which keeps the kernel's registers well below the 255 a
// fully unrolled 27-tap loop took.
__global__ void old_transpose_kernel(const float* __restrict__ disp, float s,
                                      const float* __restrict__ cot,
                                      float* __restrict__ out, int N, int NI,
                                      int C, int X, int Y, int Z) {
  const int V = X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)NI * V) return;
  const int nI = (int)(idx / V);
  const int v = (int)(idx - (long)nI * V);
  const int z = v % Z;
  const int y = (v / Z) % Y;
  const int x = v / (Y * Z);
  const int n0 = NI == 1 ? 0 : nI;
  const int n1 = NI == 1 ? N : nI + 1;

  for (int c0 = 0; c0 < C; c0 += 4) {
    const int nc = C - c0 < 4 ? C - c0 : 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = n0; n < n1; ++n) {
      const float* dx = disp + (long)n * 3 * V;
      const float* dy = dx + V;
      const float* dz = dy + V;
      const float* gn = cot + ((long)n * C + c0) * V;
#pragma unroll 1
      for (int kx = 0; kx < 3; ++kx) {
        int ux, ox;
        transposed_tap(x, X, kx, ux, ox);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          int uy, oy;
          transposed_tap(y, Y, ky, uy, oy);
          const int row = (ux * Y + uy) * Z;
#pragma unroll
          for (int kz = 0; kz < 3; ++kz) {
            int uz, oz;
            transposed_tap(z, Z, kz, uz, oz);
            const int u = row + uz;
            const float wx = weight_at(axis_weights(__fmul_rn(s, __ldg(dx + u))), ox);
            const float wy = weight_at(axis_weights(__fmul_rn(s, __ldg(dy + u))), oy);
            const float wz = weight_at(axis_weights(__fmul_rn(s, __ldg(dz + u))), oz);
            const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < nc) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(gn + (long)c * V + u)));
          }
        }
      }
    }
    float* o = out + ((long)nI * C + c0) * V + v;
    for (int c = 0; c < nc; ++c) o[(long)c * V] = acc[c];
  }
}

// the weight-gradient pass (see stencil.cuh launch_warp_dd); one thread per
// (n, p)
__global__ void old_dd_kernel(const float* __restrict__ I,
                               const float* __restrict__ disp, float s,
                               const float* __restrict__ cot,
                               float* __restrict__ out, int N, int NI, int C,
                               int X, int Y, int Z, bool compose) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));

  const float* d = disp + (long)n * 3 * V + p;
  const float dv[3] = {__fmul_rn(s, d[0]), __fmul_rn(s, d[V]), __fmul_rn(s, d[2 * V])};
  AxisWeights W[3], dW[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    W[a] = axis_weights(dv[a]);
    dW[a] = axis_dweights(dv[a]);
  }
  const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);
  const float* Ib = I + (NI == 1 ? 0L : (long)n * C * V);
  const float* g = cot + (long)n * C * V + p;

  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const float wx = weight_at(W[0], ox - 1), dwx = weight_at(dW[0], ox - 1);
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const float wy = weight_at(W[1], oy - 1), dwy = weight_at(dW[1], oy - 1);
      const float a_xy = __fmul_rn(dwx, wy);
      const float b_xy = __fmul_rn(wx, dwy);
      const float c_xy = __fmul_rn(wx, wy);
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const float wz = weight_at(W[2], oz - 1), dwz = weight_at(dW[2], oz - 1);
        const long off = ((long)ix.i[ox] * Y + iy.i[oy]) * Z + iz.i[oz];
        float gI = __fmul_rn(__ldg(g), __ldg(Ib + off));
        for (int c = 1; c < C; ++c)
          gI = __fadd_rn(gI, __fmul_rn(__ldg(g + (long)c * V), __ldg(Ib + (long)c * V + off)));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(a_xy, wz), gI));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(b_xy, wz), gI));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(c_xy, dwz), gI));
      }
    }
  }
  float* o = out + (long)n * 3 * V + p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o[(long)a * V] = compose ? __fadd_rn(__fmul_rn(s, __ldg(g + (long)a * V)), __fmul_rn(s, acc[a]))
                             : acc[a];
}


// the 9 per-axis weights (a-major, o = -1, 0, +1) of every voxel of s * disp
__global__ void weights_kernel(const float* __restrict__ disp, float s, float* __restrict__ w9,
                               int N, int V) {
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const int u = (int)(idx - (long)n * V);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const AxisWeights w = axis_weights(__fmul_rn(s, __ldg(disp + ((long)n * 3 + a) * V + u)));
    float* o = w9 + ((long)n * 9 + 3 * a) * V + u;
    o[0] = w.m;
    o[V] = w.z;
    o[2 * (long)V] = w.p;
  }
}

// the old gather-form transpose reading precomputed weights
__global__ void preweighted_transpose_kernel(const float* __restrict__ w9,
                                             const float* __restrict__ cot,
                                             float* __restrict__ out, int N, int NI, int C,
                                             int X, int Y, int Z) {
  const int V = X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)NI * V) return;
  const int nI = (int)(idx / V);
  const int v = (int)(idx - (long)nI * V);
  const int z = v % Z, y = (v / Z) % Y, x = v / (Y * Z);
  const int n0 = NI == 1 ? 0 : nI, n1 = NI == 1 ? N : nI + 1;
  for (int c0 = 0; c0 < C; c0 += 4) {
    const int nc = C - c0 < 4 ? C - c0 : 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = n0; n < n1; ++n) {
      const float* wn = w9 + (long)n * 9 * V;
      const float* gn = cot + ((long)n * C + c0) * V;
#pragma unroll 1
      for (int kx = 0; kx < 3; ++kx) {
        int ux, ox;
        transposed_tap(x, X, kx, ux, ox);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          int uy, oy;
          transposed_tap(y, Y, ky, uy, oy);
          const int row = (ux * Y + uy) * Z;
#pragma unroll
          for (int kz = 0; kz < 3; ++kz) {
            int uz, oz;
            transposed_tap(z, Z, kz, uz, oz);
            const int u = row + uz;
            const float wx = __ldg(wn + (long)(ox + 1) * V + u);
            const float wy = __ldg(wn + (long)(4 + oy) * V + u);
            const float wz = __ldg(wn + (long)(7 + oz) * V + u);
            const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < nc) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(gn + (long)c * V + u)));
          }
        }
      }
    }
    float* o = out + ((long)nI * C + c0) * V + v;
    for (int c = 0; c < nc; ++c) o[(long)c * V] = acc[c];
  }
}

// the old weight-gradient pass on the 8 live taps, I read through L1
__global__ void live_dd_kernel(const float* __restrict__ I, const float* __restrict__ disp,
                               float s, const float* __restrict__ cot, float* __restrict__ out,
                               int N, int NI, int C, int X, int Y, int Z, bool compose) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int pos[3] = {(int)(p / ((long)Y * Z)), (int)((p / Z) % Y), (int)(p % Z)};
  const int len[3] = {X, Y, Z};
  const float* d = disp + (long)n * 3 * V + p;
  int ix[3][2];
  float w[3][2], dw[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float da = __fmul_rn(s, d[a * V]);
    const LivePair lp = live_pair(da);
    const AxisWeights sl = axis_dweights(da);
    w[a][0] = lp.wl;
    w[a][1] = lp.wh;
    dw[a][0] = lp.lo < 0 ? sl.m : sl.z;
    dw[a][1] = lp.lo < 0 ? sl.z : sl.p;
    const int i0 = pos[a] + lp.lo, i1 = i0 + 1;
    ix[a][0] = i0 < 0 ? 0 : (i0 >= len[a] ? len[a] - 1 : i0);
    ix[a][1] = i1 < 0 ? 0 : (i1 >= len[a] ? len[a] - 1 : i1);
  }
  const float* Ib = I + (NI == 1 ? 0L : (long)n * C * V);
  const float* g = cot + (long)n * C * V + p;
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const long off = ((long)ix[0][i] * Y + ix[1][j]) * Z + ix[2][k];
        float gI = __fmul_rn(__ldg(g), __ldg(Ib + off));
        for (int c = 1; c < C; ++c) gI = fmaf(__ldg(g + (long)c * V), __ldg(Ib + (long)c * V + off), gI);
        acc[0] = fmaf(__fmul_rn(__fmul_rn(dw[0][i], w[1][j]), w[2][k]), gI, acc[0]);
        acc[1] = fmaf(__fmul_rn(__fmul_rn(w[0][i], dw[1][j]), w[2][k]), gI, acc[1]);
        acc[2] = fmaf(__fmul_rn(__fmul_rn(w[0][i], w[1][j]), dw[2][k]), gI, acc[2]);
      }
  float* o = out + (long)n * 3 * V + p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o[(long)a * V] = compose ? __fadd_rn(__fmul_rn(s, __ldg(g + (long)a * V)), __fmul_rn(s, acc[a]))
                             : acc[a];
}

template <int CC, int MODE>
__global__ void __launch_bounds__(T_THREADS, T_THREADS >= 512 ? 1 : 2)
    transpose_variant_kernel(const float* __restrict__ disp, float s,
                             const float* __restrict__ cot, float* __restrict__ out, int N,
                             int NI, int X, int Y, int Z, int columns, int march) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z;
  const int nI = blockIdx.x / columns;
  int xb, y0, z0;
  brick_origin(blockIdx.x % columns, Y, Z, xb, y0, z0);
  xb = xb / BX * march;
  int tx, ty, tz;
  transpose_thread(tx, ty, tz);
  const int n0 = NI == 1 ? 0 : nI, n1 = NI == 1 ? N : nI + 1;
  float acc[TL][CC];
#pragma unroll
  for (int i = 0; i < TL; ++i)
#pragma unroll
    for (int c = 0; c < CC; ++c) acc[i][c] = 0.0f;
  for (int n = n0; n < n1; ++n) {
    for (int m = 0; m < march && (xb + m) * BX < X; ++m) {
      const int x0 = (xb + m) * BX, ring = (m * BX) % HX;
      if (MODE == 1 || (n == n0 && m == 0)) {  // staging alone, or one staging
        if (n > n0 || m > 0) __syncthreads();
        stage_transpose<CC>(smem, disp + (size_t)n * 3 * V, s, cot + (size_t)n * CC * V, V, X,
                            Y, Z, x0, y0, z0, m > 0 ? HX - BX : 0, ring);
        __syncthreads();
      }
      if (MODE == 2) transpose_accumulate<CC>(smem, tx, ty, tz, acc, ring);
      if (MODE == 1) acc[0][0] = smem[threadIdx.x];
      if (n == n1 - 1) store_transpose<CC>(acc, out, nI, CC, 0, X, Y, Z, x0, y0, z0, tx, ty, tz);
    }
  }
}

template <int CC, int MODE>
static int variant(const float* disp, float s, const float* cot, float* out, int N, int NI,
                   int X, int Y, int Z, cudaStream_t st) {
  const int smem = (9 + CC) * T_PLANE * (int)sizeof(float);
  cudaFuncSetAttribute(transpose_variant_kernel<CC, MODE>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int march = NI == 1 && N > 1 ? 1 : T_MARCH;
  const int columns = bricks_of(X, Y, Z, march);
  transpose_variant_kernel<CC, MODE><<<(unsigned)columns * NI, T_THREADS, smem, st>>>(
      disp, s, cot, out, N, NI, X, Y, Z, columns, march);
  return (int)cudaGetLastError();
}

// K6's first pass before its redesign: d_mw (to scratch) and d_phi; one
// thread per (n, p).  LIVE: the weight-gradient path on the 8 live taps of
// m0 (read through L1, nothing staged) in place of all 27
template <bool LIVE>
__global__ void old_ad_star_bwd_kernel(const float* __restrict__ phiinv,
                                       const float* __restrict__ m0, const float* __restrict__ g,
                                       const float* __restrict__ mw, float* __restrict__ d_mw,
                                       float* __restrict__ d_phi, int N, int Nm, int X, int Y,
                                       int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));
  const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);
  const AxisIdx* ax[3] = {&ix, &iy, &iz};
  const int pos[3] = {x, y, z};
  const int len[3] = {X, Y, Z};
  const int stride[3] = {Y * Z, Z, 1};

  const float* ph = phiinv + (long)n * 3 * V;
  const float* gn = g + (long)n * 3 * V;
  const float* mwn = mw + (long)n * 3 * V;
  float gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gc[c] = __ldg(gn + (long)c * V + p);

  // d_mw_a = sum_c (D_a phi_c + delta_ca) g_c, accumulated over c in order
  float dmw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float j = diff_central(ph + (long)c * V, p, *ax[a], stride[a]);
      if (a == c) j = __fadd_rn(j, 1.0f);
      const float term = __fmul_rn(j, gc[c]);
      acc = c == 0 ? term : __fadd_rn(acc, term);
    }
    dmw[a] = acc;
    d_mw[(long)n * 3 * V + (long)a * V + p] = acc;
  }

  const float* mb = m0 + (Nm == 1 ? 0L : (long)n * 3 * V);
  float acc[3] = {0.0f, 0.0f, 0.0f};
  if (LIVE) {
    // weight-gradient path on the 8 live taps: image m0, cotangent d_mw
    int li[3][2];
    float w[3][2], dw[3][2];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = __ldg(ph + (long)a * V + p);
      const LivePair lp = live_pair(d);
      const AxisWeights sl = axis_dweights(d);
      w[a][0] = lp.wl;
      w[a][1] = lp.wh;
      dw[a][0] = lp.lo < 0 ? sl.m : sl.z;
      dw[a][1] = lp.lo < 0 ? sl.z : sl.p;
      li[a][0] = clampi(pos[a] + lp.lo, len[a]);
      li[a][1] = clampi(pos[a] + lp.lo + 1, len[a]);
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const long off = ((long)li[0][i] * Y + li[1][j]) * Z + li[2][k];
          float t = __fmul_rn(dmw[0], __ldg(mb + off));
          t = fmaf(dmw[1], __ldg(mb + V + off), t);
          t = fmaf(dmw[2], __ldg(mb + 2 * V + off), t);
          acc[0] = fmaf(__fmul_rn(__fmul_rn(dw[0][i], w[1][j]), w[2][k]), t, acc[0]);
          acc[1] = fmaf(__fmul_rn(__fmul_rn(w[0][i], dw[1][j]), w[2][k]), t, acc[1]);
          acc[2] = fmaf(__fmul_rn(__fmul_rn(w[0][i], w[1][j]), dw[2][k]), t, acc[2]);
        }
  } else {
    // weight-gradient path: image m0, cotangent d_mw, displacement phi
    AxisWeights W[3], dW[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = __ldg(ph + (long)a * V + p);
      W[a] = axis_weights(d);
      dW[a] = axis_dweights(d);
    }
#pragma unroll
    for (int ox = 0; ox < 3; ++ox) {
      const float wx = weight_at(W[0], ox - 1), dwx = weight_at(dW[0], ox - 1);
#pragma unroll
      for (int oy = 0; oy < 3; ++oy) {
        const float wy = weight_at(W[1], oy - 1), dwy = weight_at(dW[1], oy - 1);
        const float a_xy = __fmul_rn(dwx, wy);
        const float b_xy = __fmul_rn(wx, dwy);
        const float c_xy = __fmul_rn(wx, wy);
#pragma unroll
        for (int oz = 0; oz < 3; ++oz) {
          const float wz = weight_at(W[2], oz - 1), dwz = weight_at(dW[2], oz - 1);
          const long off = ((long)ix.i[ox] * Y + iy.i[oy]) * Z + iz.i[oz];
          float t = __fmul_rn(dmw[0], __ldg(mb + off));
          t = __fadd_rn(t, __fmul_rn(dmw[1], __ldg(mb + V + off)));
          t = __fadd_rn(t, __fmul_rn(dmw[2], __ldg(mb + 2 * V + off)));
          acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(a_xy, wz), t));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(b_xy, wz), t));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(c_xy, dwz), t));
        }
      }
    }
  }

  // divergence path: d_phi_c += sum_a D_a^T (mw_a * g_c), over a in order
  float* o = d_phi + (long)n * 3 * V + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float div = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long lo = p + (long)(ax[a]->i[0] - pos[a]) * stride[a];
      const long hi = p + (long)(ax[a]->i[2] - pos[a]) * stride[a];
      const float* w = mwn + (long)a * V;
      const float* q = gn + (long)c * V;
      const float qm = __fmul_rn(__ldg(w + lo), __ldg(q + lo));
      const float q0 = __fmul_rn(__ldg(w + p), gc[c]);
      const float qp = __fmul_rn(__ldg(w + hi), __ldg(q + hi));
      const float term = diff_central_adjoint(qm, q0, qp, pos[a], len[a]);
      div = a == 0 ? term : __fadd_rn(div, term);
    }
    o[(long)c * V] = __fadd_rn(acc[c], div);
  }
}

// K2 before its redesign: out and the flag; one thread per (n, p).  LIVE:
// the 8 live taps of phiinv (read through L1, nothing staged, in the 27-tap
// order and rounding) in place of all 27
template <bool LIVE>
__global__ void old_compose_fwd_kernel(const float* __restrict__ phiinv,
                                       const float* __restrict__ v, float s,
                                       float* __restrict__ out, int* flag, int N, int X, int Y,
                                       int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));

    const float* vb = v + (long)n * 3 * V + p;
    const float d[3] = {__fmul_rn(s, vb[0]), __fmul_rn(s, vb[V]), __fmul_rn(s, vb[2 * V])};
    bad = !(in_unit(d[0]) && in_unit(d[1]) && in_unit(d[2]));
    const float* ph = phiinv + (long)n * 3 * V;
    float* o = out + (long)n * 3 * V + p;
    if (LIVE) {
      const int pos[3] = {x, y, z}, len[3] = {X, Y, Z};
      float w[3][2];
      int li[3][2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const LivePair lp = live_pair(d[a]);
        w[a][0] = lp.wl;
        w[a][1] = lp.wh;
        li[a][0] = clampi(pos[a] + lp.lo, len[a]);
        li[a][1] = clampi(pos[a] + lp.lo + 1, len[a]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* f = ph + (long)c * V;
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = q >> 2, j = (q >> 1) & 1, k = q & 1;
          const float wt = __fmul_rn(__fmul_rn(w[0][i], w[1][j]), w[2][k]);
          const float t =
              __fmul_rn(wt, __ldg(f + ((long)li[0][i] * Y + li[1][j]) * Z + li[2][k]));
          acc = q == 0 ? t : __fadd_rn(acc, t);
        }
        o[(long)c * V] = __fadd_rn(d[c], acc);
      }
    } else {
      AxisWeights W[3] = {axis_weights(d[0]), axis_weights(d[1]), axis_weights(d[2])};
      Taps T;
      make_taps(T, W, axis_idx(x, X), axis_idx(y, Y), axis_idx(z, Z), Y, Z);
#pragma unroll
      for (int c = 0; c < 3; ++c) o[(long)c * V] = __fadd_rn(d[c], warp_sum(T, ph + (long)c * V));
    }
  }
  clear_flag_if(bad, flag);
}

// K1 before its redesign: out, mw (when mw_out is not null) and the flag;
// one thread per (n, p).  LIVE: the 8 live taps of m0 (read through L1,
// nothing staged, in the 27-tap order and rounding) in place of all 27
template <bool LIVE>
__global__ void old_ad_star_fwd_kernel(const float* __restrict__ phiinv,
                                       const float* __restrict__ m0, float* __restrict__ out,
                                       float* __restrict__ mw_out, int* flag, int N, int Nm,
                                       int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));
    const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);

    const float* ph = phiinv + (long)n * 3 * V;
    const float d[3] = {ph[p], ph[V + p], ph[2 * V + p]};
    bad = !(in_unit(d[0]) && in_unit(d[1]) && in_unit(d[2]));
    const float* mb = m0 + (Nm == 1 ? 0L : (long)n * 3 * V);
    float mw[3];
    if (LIVE) {
      const int pos[3] = {x, y, z}, len[3] = {X, Y, Z};
      float w[3][2];
      int li[3][2];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const LivePair lp = live_pair(d[a]);
        w[a][0] = lp.wl;
        w[a][1] = lp.wh;
        li[a][0] = clampi(pos[a] + lp.lo, len[a]);
        li[a][1] = clampi(pos[a] + lp.lo + 1, len[a]);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float* f = mb + (long)c * V;
        float acc = 0.0f;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int i = q >> 2, j = (q >> 1) & 1, k = q & 1;
          const float wt = __fmul_rn(__fmul_rn(w[0][i], w[1][j]), w[2][k]);
          const float t =
              __fmul_rn(wt, __ldg(f + ((long)li[0][i] * Y + li[1][j]) * Z + li[2][k]));
          acc = q == 0 ? t : __fadd_rn(acc, t);
        }
        mw[c] = acc;
      }
    } else {
      AxisWeights W[3] = {axis_weights(d[0]), axis_weights(d[1]), axis_weights(d[2])};
      Taps T;
      make_taps(T, W, ix, iy, iz, Y, Z);
#pragma unroll
      for (int a = 0; a < 3; ++a) mw[a] = warp_sum(T, mb + (long)a * V);
    }
    if (mw_out != nullptr) {
      float* w = mw_out + (long)n * 3 * V + p;
#pragma unroll
      for (int a = 0; a < 3; ++a) w[(long)a * V] = mw[a];
    }

    // out_c = sum_a (g_ca [+1 if a == c]) * mw_a, accumulated over a in order
    const AxisIdx* ax[3] = {&ix, &iy, &iz};
    const int stride[3] = {Y * Z, Z, 1};
    float* o = out + (long)n * 3 * V + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float g = diff_central(ph + (long)c * V, p, *ax[a], stride[a]);
        if (a == c) g = __fadd_rn(g, 1.0f);
        const float term = __fmul_rn(g, mw[a]);
        acc = a == 0 ? term : __fadd_rn(acc, term);
      }
      o[(long)c * V] = acc;
    }
  }
  clear_flag_if(bad, flag);
}

static inline unsigned blocks_for(long total) { return (unsigned)((total + 255) / 256); }

}  // namespace lagomorph_profile

using namespace lagomorph_profile;

extern "C" int prof_old_fwd(const float* I, const float* disp, float* out, int N, int NI, int C,
                            int X, int Y, int Z, void* st) {
  old_fwd_kernel<<<blocks_for((long)N * X * Y * Z), 256, 0, (cudaStream_t)st>>>(
      I, disp, out, N, NI, C, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" int prof_old_transpose(const float* disp, float s, const float* cot, float* out,
                                  int N, int NI, int C, int X, int Y, int Z, void* st) {
  old_transpose_kernel<<<blocks_for((long)NI * X * Y * Z), 256, 0, (cudaStream_t)st>>>(
      disp, s, cot, out, N, NI, C, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" int prof_weights(const float* disp, float s, float* w9, int N, int V, void* st) {
  weights_kernel<<<blocks_for((long)N * V), 256, 0, (cudaStream_t)st>>>(disp, s, w9, N, V);
  return (int)cudaGetLastError();
}

extern "C" int prof_preweighted_transpose(const float* w9, const float* cot, float* out, int N,
                                          int NI, int C, int X, int Y, int Z, void* st) {
  preweighted_transpose_kernel<<<blocks_for((long)NI * X * Y * Z), 256, 0, (cudaStream_t)st>>>(
      w9, cot, out, N, NI, C, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" int prof_old_dd(const float* I, const float* disp, float s, const float* cot,
                           float* out, int N, int NI, int C, int X, int Y, int Z, int compose,
                           void* st) {
  old_dd_kernel<<<blocks_for((long)N * X * Y * Z), 256, 0, (cudaStream_t)st>>>(
      I, disp, s, cot, out, N, NI, C, X, Y, Z, compose != 0);
  return (int)cudaGetLastError();
}

extern "C" int prof_live_dd(const float* I, const float* disp, float s, const float* cot,
                            float* out, int N, int NI, int C, int X, int Y, int Z, int compose,
                            void* st) {
  live_dd_kernel<<<blocks_for((long)N * X * Y * Z), 256, 0, (cudaStream_t)st>>>(
      I, disp, s, cot, out, N, NI, C, X, Y, Z, compose != 0);
  return (int)cudaGetLastError();
}

// mode 1: staging alone; 2: accumulation alone (C = 1 or 3)
extern "C" int prof_transpose_variant(int mode, const float* disp, float s, const float* cot,
                                      float* out, int N, int NI, int C, int X, int Y, int Z,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (C == 1)
    return mode == 1 ? variant<1, 1>(disp, s, cot, out, N, NI, X, Y, Z, st)
                     : variant<1, 2>(disp, s, cot, out, N, NI, X, Y, Z, st);
  return mode == 1 ? variant<3, 1>(disp, s, cot, out, N, NI, X, Y, Z, st)
                   : variant<3, 2>(disp, s, cot, out, N, NI, X, Y, Z, st);
}

// K6's first pass: 0 before its redesign, 1 the same on the 8 live taps,
// 2 the current one without its prefetch (at K6's march length)
extern "C" int prof_adstar_first(int mode, const float* phiinv, const float* m0, const float* g,
                                 const float* mw, float* d_mw, float* d_phi, int N, int Nm,
                                 int X, int Y, int Z, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == 2)
    return (int)launch_ad_star_bwd_first<false>(phiinv, m0, g, mw, d_mw, d_phi, N, Nm, X, Y,
                                                Z, 0, st);
  const unsigned blocks = blocks_for((long)N * X * Y * Z);
  if (mode == 0)
    old_ad_star_bwd_kernel<false><<<blocks, 256, 0, st>>>(phiinv, m0, g, mw, d_mw, d_phi, N,
                                                           Nm, X, Y, Z);
  else
    old_ad_star_bwd_kernel<true><<<blocks, 256, 0, st>>>(phiinv, m0, g, mw, d_mw, d_phi, N, Nm,
                                                          X, Y, Z);
  return (int)cudaGetLastError();
}

// K2: 0 before its redesign, 1 the same on the 8 live taps, 2 the current
// one without its prefetch (at K2's march length)
extern "C" int prof_compose_fwd(int mode, const float* phiinv, const float* v, float s,
                                float* out, int* flag, int N, int X, int Y, int Z,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == 2)
    return (int)launch_compose_fwd<false>(phiinv, v, s, out, flag, N, X, Y, Z, 0, st);
  const unsigned blocks = blocks_for((long)N * X * Y * Z);
  if (mode == 0)
    old_compose_fwd_kernel<false><<<blocks, 256, 0, st>>>(phiinv, v, s, out, flag, N, X, Y, Z);
  else
    old_compose_fwd_kernel<true><<<blocks, 256, 0, st>>>(phiinv, v, s, out, flag, N, X, Y, Z);
  return (int)cudaGetLastError();
}

// K1: 0 before its redesign, 1 the same on the 8 live taps, 2 the current
// one without its prefetch (at K1's march length)
extern "C" int prof_ad_star_fwd(int mode, const float* phiinv, const float* m0, float* out,
                                float* mw, int* flag, int N, int Nm, int X, int Y, int Z,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == 2)
    return (int)launch_ad_star_fwd<false>(phiinv, m0, out, mw, flag, N, Nm, X, Y, Z, 0, st);
  const unsigned blocks = blocks_for((long)N * X * Y * Z);
  if (mode == 0)
    old_ad_star_fwd_kernel<false><<<blocks, 256, 0, st>>>(phiinv, m0, out, mw, flag, N, Nm, X,
                                                           Y, Z);
  else
    old_ad_star_fwd_kernel<true><<<blocks, 256, 0, st>>>(phiinv, m0, out, mw, flag, N, Nm, X, Y,
                                                          Z);
  return (int)cudaGetLastError();
}
