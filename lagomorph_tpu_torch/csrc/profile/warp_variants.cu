// Variants of the unit-regime warp's kernels, for profile_warp.py only (not
// part of the kernel library; built by that script).  They isolate the
// costs the previous kernels paid:
//
//   old_fwd_kernel: K4 before its redesign (27 taps per voxel, nothing
//     staged);
//   prev_transpose_kernel, prev_dd_kernel: the two passes of K5 (K6's and
//     K7's too) before their merge into csrc/warp_unit.cu's
//     warp_bwd_kernel: bricks of 4 x 8 x 32 outputs staged with their halo
//     after blocking loads, the transpose staging 9 folded weights, each
//     pass reading d and g from device memory;
//   prof_pass: the current pass with its load path forced (TMA, or the
//     cp.async path the launcher takes only where TMA cannot);
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

// The two passes of K5 (also K6's and K7's) before their merge into
// warp_bwd_kernel: the gather-form transpose staging, per brick of 4 x 8 x 32
// output voxels and its halo, the 9 folded per-axis weights and the
// cotangent (T_MARCH bricks along x a block, through a ring of staged
// x-planes), and the weight gradient staging the brick of I; each reads d
// and g from device memory.  As in csrc/warp_unit.cu at the parent of the
// merge.
constexpr int BX = 4, BY = 8, BZ = 32;
constexpr int HX = BX + 2, HY = BY + 2, HZ = BZ + 2;
// the transpose: TL z outputs per thread; staged rows padded to RZ floats
// so each thread's TL + 2 sources are one float4 and one float2 load
constexpr int TL = 4;
constexpr int RZ = 36;
constexpr int T_THREADS = BX * BY * BZ / TL;
constexpr int T_PLANE = HX * HY * RZ;  // floats of one staged array
constexpr int T_MAX_C = 3;             // channels per transpose launch
constexpr int T_MARCH = 4;             // bricks along x per block, one subject per block
// the weight-gradient pass: one thread per (y, z) of the brick, its BX
// voxels along x; staged channels of I at a time
constexpr int D_THREADS = BY * BZ;
constexpr int D_PLANE = HX * HY * HZ;
constexpr int D_MAX_C = 4;
constexpr int D_VOX = BX;

static_assert(RZ % 4 == 0 && RZ >= HZ + 2, "float4 rows");

// brick `b` of the volume's bricks (z fastest) -> its first voxel
__device__ __forceinline__ void brick_origin(int b, int Y, int Z, int& x0, int& y0, int& z0) {
  const int nbz = (Z + BZ - 1) / BZ, nby = (Y + BY - 1) / BY;
  z0 = (b % nbz) * BZ;
  b /= nbz;
  y0 = (b % nby) * BY;
  x0 = (b / nby) * BX;
}

// bricks of an X x Y x Z volume, with `march` bricks along x counted as one
static inline int bricks_of(int X, int Y, int Z, int march = 1) {
  return ((X + BX * march - 1) / (BX * march)) * ((Y + BY - 1) / BY) * ((Z + BZ - 1) / BZ);
}

// six consecutive staged floats from a 16-byte aligned address
__device__ __forceinline__ void load6_aligned(const float* p, float* v) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y;
}

// Staging of one subject's sources for the transpose: the brick at (x0, y0,
// z0) and its halo, HX * HY * HZ sources, T_SRC per thread; or, when the
// block marches along x to the next brick, only the HX - 2 x-planes that
// brick does not share with the last (first_plane = 2).  The x-planes lie
// in a ring of HX slots: plane lx of the brick goes to slot (ring + lx) %
// HX.  The global loads of a thread's sources are all issued first
// (load_sources, into registers), so that they are in flight together;
// store_sources then writes, per source, the folded per-axis weights of s *
// d (arrays 3a + k, k = 0, 1, 2 for o = -1, 0, +1) and the CC cotangent
// channels (arrays 9 + c), zeros outside the volume.  (A loop that loaded
// and stored one source at a time spent most of the pass waiting on its
// loads: PERF.md, PR 6.)
constexpr int T_SRC = (HX * HY * HZ + T_THREADS - 1) / T_THREADS;

template <int CC>
struct Sources {
  float d[T_SRC][3], g[T_SRC][CC];
};

// source k of this thread among the planes first_plane .. HX - 1: its index
// in the staged arrays and, when it lies in the volume, its voxel u and
// position
__device__ __forceinline__ bool source_of(int k, int first_plane, int ring, int X, int Y, int Z,
                                          int x0, int y0, int z0, int& si, int& u,
                                          int (&pos)[3]) {
  const int i = threadIdx.x + k * T_THREADS;
  const int lz = i % HZ, r = i / HZ, ly = r % HY, lx = first_plane + r / HY;
  pos[0] = x0 - 1 + lx;
  pos[1] = y0 - 1 + ly;
  pos[2] = z0 - 1 + lz;
  si = (((ring + lx) % HX) * HY + ly) * RZ + lz;
  const bool in = lx < HX && pos[0] >= 0 && pos[0] < X && pos[1] >= 0 && pos[1] < Y &&
                  pos[2] >= 0 && pos[2] < Z;
  u = in ? (pos[0] * Y + pos[1]) * Z + pos[2] : 0;
  return in;
}

template <int CC>
__device__ __forceinline__ void load_sources(Sources<CC>& r, const float* __restrict__ dn,
                                             const float* __restrict__ gn, int V, int X, int Y,
                                             int Z, int x0, int y0, int z0, int first_plane,
                                             int ring) {
#pragma unroll
  for (int k = 0; k < T_SRC; ++k) {
    int si, u, pos[3];
    const bool in = source_of(k, first_plane, ring, X, Y, Z, x0, y0, z0, si, u, pos);
#pragma unroll
    for (int a = 0; a < 3; ++a) r.d[k][a] = in ? __ldg(dn + (size_t)a * V + u) : 0.0f;
#pragma unroll
    for (int c = 0; c < CC; ++c) r.g[k][c] = in ? __ldg(gn + (size_t)c * V + u) : 0.0f;
  }
}

template <int CC>
__device__ __forceinline__ void store_sources(const Sources<CC>& r, float* sm, float s, int X,
                                              int Y, int Z, int x0, int y0, int z0,
                                              int first_plane, int ring) {
  const int len[3] = {X, Y, Z};
#pragma unroll
  for (int k = 0; k < T_SRC; ++k) {
    if (threadIdx.x + k * T_THREADS >= (HX - first_plane) * HY * HZ) break;
    int si, u, pos[3];
    const bool in = source_of(k, first_plane, ring, X, Y, Z, x0, y0, z0, si, u, pos);
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float m = 0.0f, z = 0.0f, p = 0.0f;
      if (in) {
        const AxisWeights w = axis_weights(__fmul_rn(s, r.d[k][a]));
        m = w.m;
        z = w.z;
        p = w.p;
        if (pos[a] == 0) {  // the tap (0, -1) lands on 0
          z = __fadd_rn(z, m);
          m = 0.0f;
        }
        if (pos[a] == len[a] - 1) {  // the tap (n - 1, +1) lands on n - 1
          z = __fadd_rn(z, p);
          p = 0.0f;
        }
      }
      sm[(3 * a + 0) * T_PLANE + si] = m;
      sm[(3 * a + 1) * T_PLANE + si] = z;
      sm[(3 * a + 2) * T_PLANE + si] = p;
    }
#pragma unroll
    for (int c = 0; c < CC; ++c) sm[(9 + c) * T_PLANE + si] = r.g[k][c];
  }
}

template <int CC>
__device__ __forceinline__ void stage_transpose(float* sm, const float* __restrict__ dn, float s,
                                                const float* __restrict__ gn, int V, int X,
                                                int Y, int Z, int x0, int y0, int z0,
                                                int first_plane = 0, int ring = 0) {
  Sources<CC> r;
  load_sources<CC>(r, dn, gn, V, X, Y, Z, x0, y0, z0, first_plane, ring);
  store_sources<CC>(r, sm, s, X, Y, Z, x0, y0, z0, first_plane, ring);
}

// The contributions of one staged row of sources (x slot kx, y slot ky) to
// the TL x CC outputs of a thread: its TL + 2 sources, each landing on up to
// three of the thread's z outputs.
template <int CC>
__device__ __forceinline__ void transpose_row(const float* sm, int kx, int ky, int row,
                                              float (&acc)[TL][CC]) {
  float wx[6], wy[6], zm[6], zz[6], zp[6], g[CC][6];
  load6_aligned(sm + kx * T_PLANE + row, wx);
  load6_aligned(sm + (3 + ky) * T_PLANE + row, wy);
  load6_aligned(sm + 6 * T_PLANE + row, zm);
  load6_aligned(sm + 7 * T_PLANE + row, zz);
  load6_aligned(sm + 8 * T_PLANE + row, zp);
#pragma unroll
  for (int c = 0; c < CC; ++c) load6_aligned(sm + (9 + c) * T_PLANE + row, g[c]);
#pragma unroll
  for (int j = 0; j < TL + 2; ++j) {  // source j lands on j - 2 (o = -1), j - 1, j
    const float h = __fmul_rn(wx[j], wy[j]);
#pragma unroll
    for (int c = 0; c < CC; ++c) {
      const float hc = __fmul_rn(h, g[c][j]);
      if (j < TL) acc[j][c] = fmaf(zp[j], hc, acc[j][c]);
      if (j >= 1 && j - 1 < TL) acc[j - 1][c] = fmaf(zz[j], hc, acc[j - 1][c]);
      if (j >= 2) acc[j - 2][c] = fmaf(zm[j], hc, acc[j - 2][c]);
    }
  }
}

// One staged subject's contributions to the outputs of thread (tx, ty, tz):
// the 9 (x, y) slots' rows, in a fixed order, each slot a loop iteration (the
// rows' loads stay few registers; unrolling the y slots measured no faster).
template <int CC>
__device__ __forceinline__ void transpose_accumulate(const float* sm, int tx, int ty, int tz,
                                                     float (&acc)[TL][CC], int ring = 0) {
#pragma unroll 1
  for (int kx = 0; kx < 3; ++kx) {
    const int lx = tx + 2 - kx;  // source ux = vx + 1 - kx, offset o = kx - 1
    const int slot = (ring + lx) % HX;
#pragma unroll 1
    for (int ky = 0; ky < 3; ++ky)  // sources z = vz - 1 .. vz + TL of row uy = vy + 1 - ky
      transpose_row<CC>(sm, kx, ky, (slot * HY + ty + 2 - ky) * RZ + tz * TL, acc);
  }
}

// thread (tx, ty, tz) of a transpose block: TL z outputs of row (tx, ty)
__device__ __forceinline__ void transpose_thread(int& tx, int& ty, int& tz) {
  tz = threadIdx.x % (BZ / TL);
  ty = (threadIdx.x / (BZ / TL)) % BY;
  tx = threadIdx.x / ((BZ / TL) * BY);
}

template <int CC>
__device__ __forceinline__ void store_transpose(const float (&acc)[TL][CC], float* out, int nI,
                                                int C, int c0, int X, int Y, int Z, int x0,
                                                int y0, int z0, int tx, int ty, int tz) {
  const int V = X * Y * Z;
  const int vx = x0 + tx, vy = y0 + ty;
  if (vx >= X || vy >= Y) return;
  float* o = out + ((size_t)nI * C + c0) * V + (vx * Y + vy) * Z;
#pragma unroll
  for (int i = 0; i < TL; ++i) {
    const int vz = z0 + tz * TL + i;
    if (vz < Z)
#pragma unroll
      for (int c = 0; c < CC; ++c) o[(size_t)c * V + vz] = acc[i][c];
  }
}

// the gather-form transpose (prof_prev_transpose) of channels
// c0 .. c0 + CC - 1.  A block owns `march` consecutive bricks along x of one
// (y, z) column and one nI, and walks them in order, staging for each brick
// only the x-planes it does not share with the last; a batch-1 image (NI ==
// 1 < N, march == 1) sums the N subjects in the block instead.
template <int CC>
__global__ void __launch_bounds__(T_THREADS, T_THREADS >= 512 ? 1 : 2)
    prev_transpose_kernel(const float* __restrict__ disp, float s,
                          const float* __restrict__ cot, float* __restrict__ out, int N, int NI,
                          int C, int c0, int X, int Y, int Z, int columns, int march) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z;
  const int nI = blockIdx.x / columns;
  int xb, y0, z0;  // the first brick along x, and the column's (y, z)
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
      if (n > n0 || m > 0) __syncthreads();  // the last staging's reads are done
      const int x0 = (xb + m) * BX, ring = (m * BX) % HX;
      stage_transpose<CC>(smem, disp + (size_t)n * 3 * V, s, cot + ((size_t)n * C + c0) * V,
                          V, X, Y, Z, x0, y0, z0, m > 0 ? HX - BX : 0, ring);
      __syncthreads();
      transpose_accumulate<CC>(smem, tx, ty, tz, acc, ring);
      if (n == n1 - 1) {
        store_transpose<CC>(acc, out, nI, C, c0, X, Y, Z, x0, y0, z0, tx, ty, tz);
#pragma unroll
        for (int i = 0; i < TL; ++i)
#pragma unroll
          for (int c = 0; c < CC; ++c) acc[i][c] = 0.0f;
      }
    }
  }
}

// the weight-gradient pass (prof_prev_dd); one block per
// brick and subject, or per brick for a batch-1 image, whose staged I
// serves all N subjects
__global__ void __launch_bounds__(D_THREADS)
    prev_dd_kernel(const float* __restrict__ I, const float* __restrict__ disp, float s,
                   const float* __restrict__ cot, float* __restrict__ out, int N, int NI, int C,
                   int X, int Y, int Z, bool compose, int bricks) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z;
  int x0, y0, z0;
  brick_origin(blockIdx.x % bricks, Y, Z, x0, y0, z0);
  const int nb = blockIdx.x / bricks;
  const int n0 = NI == 1 ? 0 : nb, n1 = NI == 1 ? N : nb + 1;
  const int tz = threadIdx.x % BZ, ty = threadIdx.x / BZ;  // and x = 0 .. D_VOX - 1
  const int vy = y0 + ty, vz = z0 + tz;
  const bool once = NI == 1 && C <= D_MAX_C;  // one staging for every subject

  for (int n = n0; n < n1; ++n) {
    const float* dn = disp + (size_t)n * 3 * V;
    const float* gn = cot + (size_t)n * C * V;
    const float* In = I + (NI == 1 ? (size_t)0 : (size_t)n * C * V);
    float acc[D_VOX][3];
#pragma unroll
    for (int v = 0; v < D_VOX; ++v) acc[v][0] = acc[v][1] = acc[v][2] = 0.0f;
    for (int c0 = 0; c0 < C; c0 += D_MAX_C) {
      const int cc = C - c0 < D_MAX_C ? C - c0 : D_MAX_C;
      if (!once || n == n0) {
        if (n > n0 || c0 > 0) __syncthreads();
        for (int i = threadIdx.x; i < D_PLANE; i += D_THREADS) {
          const int lz = i % HZ, r = i / HZ, ly = r % HY, lx = r / HY;
          const int gx = x0 - 1 + lx, gy = y0 - 1 + ly, gz = z0 - 1 + lz;
          const bool in = gx >= 0 && gx < X && gy >= 0 && gy < Y && gz >= 0 && gz < Z;
          const int u = in ? (gx * Y + gy) * Z + gz : 0;
          for (int c = 0; c < cc; ++c)
            smem[c * D_PLANE + i] = in ? __ldg(In + (size_t)(c0 + c) * V + u) : 0.0f;
        }
        __syncthreads();
      }
      if (vy >= Y || vz >= Z) continue;
#pragma unroll
      for (int v = 0; v < D_VOX; ++v) {
        const int vx = x0 + v;
        if (vx >= X) break;
        const int p = (vx * Y + vy) * Z + vz;
        int li[3][2];
        float w[3][2], dw[3][2];
        const int pos[3] = {vx, vy, vz}, len[3] = {X, Y, Z}, org[3] = {x0, y0, z0};
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float d = __fmul_rn(s, __ldg(dn + (size_t)a * V + p));
          const LivePair lp = live_pair(d);
          const AxisWeights sl = axis_dweights(d);
          w[a][0] = lp.wl;
          w[a][1] = lp.wh;
          dw[a][0] = lp.lo < 0 ? sl.m : sl.z;
          dw[a][1] = lp.lo < 0 ? sl.z : sl.p;
          li[a][0] = clampi(pos[a] + lp.lo, len[a]) - org[a] + 1;
          li[a][1] = clampi(pos[a] + lp.lo + 1, len[a]) - org[a] + 1;
        }
        float gc[D_MAX_C];
#pragma unroll
        for (int c = 0; c < D_MAX_C; ++c)
          gc[c] = c < cc ? __ldg(gn + (size_t)(c0 + c) * V + p) : 0.0f;
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int k = 0; k < 2; ++k) {
              const float* q = smem + (li[0][i] * HY + li[1][j]) * HZ + li[2][k];
              float gI = __fmul_rn(gc[0], q[0]);
#pragma unroll
              for (int c = 1; c < D_MAX_C; ++c)
                if (c < cc) gI = fmaf(gc[c], q[c * D_PLANE], gI);
              acc[v][0] = fmaf(__fmul_rn(__fmul_rn(dw[0][i], w[1][j]), w[2][k]), gI, acc[v][0]);
              acc[v][1] = fmaf(__fmul_rn(__fmul_rn(w[0][i], dw[1][j]), w[2][k]), gI, acc[v][1]);
              acc[v][2] = fmaf(__fmul_rn(__fmul_rn(w[0][i], w[1][j]), dw[2][k]), gI, acc[v][2]);
            }
      }
    }
    if (vy >= Y || vz >= Z) continue;
#pragma unroll
    for (int v = 0; v < D_VOX; ++v) {
      const int vx = x0 + v;
      if (vx >= X) break;
      const int p = (vx * Y + vy) * Z + vz;
      float* o = out + (size_t)n * 3 * V + p;
#pragma unroll
      for (int a = 0; a < 3; ++a)
        o[(size_t)a * V] =
            compose ? __fadd_rn(__fmul_rn(s, __ldg(gn + (size_t)a * V + p)), __fmul_rn(s, acc[v][a]))
                    : acc[v][a];
    }
  }
}


template <int CC>
static cudaError_t prev_transpose_chunk(const float* disp, float s, const float* cot, float* out,
                                   int N, int NI, int C, int c0, int X, int Y, int Z,
                                   cudaStream_t stream) {
  const int smem = (9 + CC) * T_PLANE * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(prev_transpose_kernel<CC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // one subject per block: march along x over T_MARCH bricks
  const int march = NI == 1 && N > 1 ? 1 : T_MARCH;
  const int columns = bricks_of(X, Y, Z, march);
  prev_transpose_kernel<CC><<<(unsigned)columns * NI, T_THREADS, smem, stream>>>(
      disp, s, cot, out, N, NI, C, c0, X, Y, Z, columns, march);
  return cudaGetLastError();
}

cudaError_t prev_launch_transpose(const float* disp, float s, const float* cot,
                                  float* out, int N, int NI, int C, int X, int Y,
                                  int Z, cudaStream_t stream) {
  for (int c0 = 0; c0 < C; c0 += T_MAX_C) {
    const int cc = C - c0 < T_MAX_C ? C - c0 : T_MAX_C;
    const cudaError_t err =
        cc == 3 ? prev_transpose_chunk<3>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream)
        : cc == 2 ? prev_transpose_chunk<2>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream)
                  : prev_transpose_chunk<1>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t prev_launch_dd(const float* I, const float* disp, float s,
                           const float* cot, float* out, int N, int NI, int C,
                           int X, int Y, int Z, bool compose, cudaStream_t stream) {
  const int smem = (C < D_MAX_C ? C : D_MAX_C) * D_PLANE * (int)sizeof(float);
  const int bricks = bricks_of(X, Y, Z);
  prev_dd_kernel<<<(unsigned)bricks * (NI == 1 ? 1 : N), D_THREADS, smem, stream>>>(
      I, disp, s, cot, out, N, NI, C, X, Y, Z, compose, bricks);
  return cudaGetLastError();
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

// the previous passes: the transpose, and the weight gradient
extern "C" int prof_prev_transpose(const float* disp, float s, const float* cot, float* out,
                                   int N, int NI, int C, int X, int Y, int Z, void* st) {
  return (int)prev_launch_transpose(disp, s, cot, out, N, NI, C, X, Y, Z, (cudaStream_t)st);
}

extern "C" int prof_prev_dd(const float* I, const float* disp, float s, const float* cot,
                            float* out, int N, int NI, int C, int X, int Y, int Z, int compose,
                            void* st) {
  return (int)prev_launch_dd(I, disp, s, cot, out, N, NI, C, X, Y, Z, compose != 0,
                             (cudaStream_t)st);
}

// the warp backward's pass with its load path forced: 1 TMA, 0 cp.async
// (csrc/warp_unit.cu); I null: the transpose alone
extern "C" int prof_pass(int path, const float* I, const float* disp, float s, const float* cot,
                         float* out_t, float* out_dd, int N, int NI, int C, int X, int Y, int Z,
                         int compose, void* st) {
  return (int)launch_warp_bwd_path(I, disp, s, cot, out_t, out_dd, N, NI, C, X, Y, Z,
                                   compose != 0, (cudaStream_t)st, path);
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
