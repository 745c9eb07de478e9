// K4: unit-regime warp, forward.
//
//   out[n,c](p) = sum_{o in {-1,0,1}^3} w_o(d[n](p)) * I[n or 0, c](clamp(p + o))
//
// Replaces the Pallas kernels lagomorph_tpu/ops/pallas/warp_unit.py
// `_fwd_kernel` (whole-Y, via `_warp_unit_fwd_pallas`) and `_fwd_kernel_yb`
// (y-blocked, via `_warp_unit_fwd_yb`), forward of
// `sample_displacement_unit_pallas`.  The TPU kernels pad x by 8 rows and
// end-pad odd shapes for DMA alignment (warp_unit.py:1070-1137); here the
// clamp happens in the kernel, so one kernel covers every shape.
//
// Bound on the H100: memory.  Per voxel it reads the 3 displacement
// components once and writes C outputs (at 128^3 b4 with the atlas, 142.6
// MB: 43 us at 3.35 TB/s); the taps of I hit L1/L2 (the batch-1 atlas, 8.4
// MB, stays in L2 and is read with batch stride 0, never broadcast in
// memory).  Design: one thread per output voxel, a block a tile of 8
// y-rows by 32 z (z fastest across the warp, so the displacement loads and
// the stores coalesce).  Of the 27 taps only 8 can have a weight that is
// not zero: per axis the two offsets floor(d) selects (stencil.cuh
// live_pair), so the kernel sums those 8, in the 27-tap order (ox, oy, oz
// ascending), each product rounded as (wx * wy) * wz and each sum on its
// own (__fmul_rn / __fadd_rn).  The terms it skips are exact zeros (0 * I
// for a finite I), so the result is bit-equal to the plain version on
// finite inputs.  For an image holding inf or NaN the plain version gives
// NaN (0 * inf) at voxels whose skipped taps read it, where this kernel may
// not; no check is made for that.
//
// K5: unit-regime warp, backward (cotangent g of out):
//   dI[v]     = sum_{(u,o): clamp(u+o) = v} w_o(d(u)) * g(u)          (transpose)
//   d_disp[a] = sum_o dw_a(o_a) prod_{b!=a} w_b(o_b) sum_c g_c I_c[tap_o]
// Replaces warp_unit.py `_warp_unit_bwd_pallas` (kernels `_bwd_dI_kernel`,
// `_bwd_dD_kernel`) and `_warp_unit_bwd_yb` (`_bwd_dI_kernel_yb`,
// `_bwd_dD_kernel_yb`), dispatched by `_sdu_bwd`.  Two passes, whose
// launchers K6 and K7 (epdiff_unit.cu) share:
//
// * the transpose, in gather form (a scatter would need float atomics,
//   whose sums are not deterministic).  A block owns a brick of BX x BY x
//   BZ output voxels and stages in shared memory, for the brick and a
//   one-voxel halo, each source voxel's per-axis weights (computed once per
//   source, not once per (output, slot)) and its cotangent channels.  The
//   clamp folds of the volume's edges (a tap (0, -1) lands on 0, a tap
//   (n - 1, +1) on n - 1; warp_unit.py:477-502 `where(edge, ...)`) are
//   folded into the staged weights: at u == 0 the weight of o = -1 joins
//   that of o = 0, at u == n - 1 the weight of o = +1 does; sources outside
//   the volume are staged as zeros.  A thread issues the global loads of
//   all its sources before it computes and stores their weights, so that
//   they are in flight together.  With one subject per block, the block
//   walks T_MARCH bricks along x, keeping the staged x-planes in a ring:
//   each brick after the first stages only the BX planes it does not share
//   with the last.  A thread owns TL consecutive z outputs: for each of
//   the 9 (x, y) source rows it reads TL + 2 staged sources (vector loads
//   along z) and adds each one's three z-landings into its register
//   accumulators.  A batch-1 image (the atlas) sums its N subjects inside
//   the block, re-staging per subject.  Each output sums in one fixed order
//   (subject, x slot, y slot, source z), so two launches agree bit for bit.  The staging (global loads of a
//   brick and its halo, and the weights' arithmetic) takes most of the
//   pass, the accumulation (shared-memory reads) the rest; larger bricks
//   (one block per SM) measured slower (PERF.md, PR 6; profile_warp.py).
// * the weight-gradient pass on the 8 live taps only (per axis the pair
//   floor(d) selects, weights (1 - t, t), slopes (-1, +1); a floor outside
//   {-1, 0} gives zeros), with the brick of I and its halo staged in
//   shared memory (the taps' C loads per tap come from there) and, for a
//   batch-1 image, staged once for all N subjects.  d_disp_a sums
//   coef_a(tap) * <g, I(tap)> over the 8 taps, coef_a = dw_a * prod_{b!=a} w_b.
//
// Numerics of the backward passes: fused multiply-adds (fmaf) in the sums,
// which stay within 1e-5 * (1 + max|ref|) of the plain versions (another
// summation order than autograd's in any case); the displacement is scaled
// as the forward scales it (__fmul_rn(s, d)) and the compose epilogue
// rounds s * g + s * dd term by term.  No atomics: deterministic.
//
// Bound on the H100 (each input read once, each output written once): at
// 128^3 b4 the transpose moves 142.6 MB with the atlas (C = 1, read d, g;
// write dI: 43 us) and 302 MB at C = 3, NI = N (90 us); the
// weight-gradient pass 243 MB at C = 1 (73 us) and 403 MB at C = 3 with
// the compose epilogue (120 us).
#include "stencil.cuh"

namespace lagomorph {

// the forward's tile: 8 y-rows of 32 z, one thread per voxel
constexpr int FWD_TY = 8, FWD_TZ = 32;
// the backward passes' brick of output voxels (x and y overridable at
// build time, for profile_warp.py's comparison of brick shapes), and with
// its halo
#ifndef LAGOMORPH_WARP_BRICK_X
#define LAGOMORPH_WARP_BRICK_X 4
#endif
#ifndef LAGOMORPH_WARP_BRICK_Y
#define LAGOMORPH_WARP_BRICK_Y 8
#endif
constexpr int BX = LAGOMORPH_WARP_BRICK_X, BY = LAGOMORPH_WARP_BRICK_Y, BZ = 32;
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

__global__ void __launch_bounds__(FWD_TY * FWD_TZ)
    warp_unit_fwd_kernel(const float* __restrict__ I, const float* __restrict__ disp,
                         float* __restrict__ out, int N, int NI, int C, int X, int Y, int Z) {
  const int V = X * Y * Z;
  const int nbz = (Z + FWD_TZ - 1) / FWD_TZ, nby = (Y + FWD_TY - 1) / FWD_TY;
  int b = blockIdx.x;
  const int z = (b % nbz) * FWD_TZ + (int)(threadIdx.x % FWD_TZ);
  b /= nbz;
  const int y = (b % nby) * FWD_TY + (int)(threadIdx.x / FWD_TZ);
  b /= nby;
  const int x = b % X;
  const int n = b / X;
  if (z >= Z || y >= Y || n >= N) return;
  const int p = (x * Y + y) * Z + z;

  const float* d = disp + (size_t)n * 3 * V + p;
  const LivePair px = live_pair(d[0]), py = live_pair(d[V]), pz = live_pair(d[2 * (size_t)V]);
  const float wx[2] = {px.wl, px.wh}, wy[2] = {py.wl, py.wh}, wz[2] = {pz.wl, pz.wh};
  const int ix[2] = {clampi(x + px.lo, X), clampi(x + px.lo + 1, X)};
  const int iy[2] = {clampi(y + py.lo, Y), clampi(y + py.lo + 1, Y)};
  const int iz[2] = {clampi(z + pz.lo, Z), clampi(z + pz.lo + 1, Z)};
  float w[8];
  int off[8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        w[(i * 2 + j) * 2 + k] = __fmul_rn(__fmul_rn(wx[i], wy[j]), wz[k]);
        off[(i * 2 + j) * 2 + k] = (ix[i] * Y + iy[j]) * Z + iz[k];
      }

  const float* Ib = I + (NI == 1 ? (size_t)0 : (size_t)n * C * V);
  float* o = out + (size_t)n * C * V + p;
  for (int c = 0; c < C; ++c) {
    const float* f = Ib + (size_t)c * V;
    float acc = __fmul_rn(w[0], __ldg(f + off[0]));
#pragma unroll
    for (int q = 1; q < 8; ++q) acc = __fadd_rn(acc, __fmul_rn(w[q], __ldg(f + off[q])));
    o[(size_t)c * V] = acc;
  }
}

// six consecutive staged floats from a 16-byte aligned address
__device__ __forceinline__ void load6(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float2 b = *reinterpret_cast<const float2*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w; v[4] = b.x; v[5] = b.y;
#else
  for (int i = 0; i < 6; ++i) v[i] = p[i];
#endif
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
  load6(sm + kx * T_PLANE + row, wx);
  load6(sm + (3 + ky) * T_PLANE + row, wy);
  load6(sm + 6 * T_PLANE + row, zm);
  load6(sm + 7 * T_PLANE + row, zz);
  load6(sm + 8 * T_PLANE + row, zp);
#pragma unroll
  for (int c = 0; c < CC; ++c) load6(sm + (9 + c) * T_PLANE + row, g[c]);
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

// the gather-form transpose (stencil.cuh launch_warp_transpose) of channels
// c0 .. c0 + CC - 1.  A block owns `march` consecutive bricks along x of one
// (y, z) column and one nI, and walks them in order, staging for each brick
// only the x-planes it does not share with the last; a batch-1 image (NI ==
// 1 < N, march == 1) sums the N subjects in the block instead.
template <int CC>
__global__ void __launch_bounds__(T_THREADS, T_THREADS >= 512 ? 1 : 2)
    warp_transpose_kernel(const float* __restrict__ disp, float s,
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

// the weight-gradient pass (stencil.cuh launch_warp_dd); one block per
// brick and subject, or per brick for a batch-1 image, whose staged I
// serves all N subjects
__global__ void __launch_bounds__(D_THREADS)
    warp_dd_kernel(const float* __restrict__ I, const float* __restrict__ disp, float s,
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
static cudaError_t transpose_chunk(const float* disp, float s, const float* cot, float* out,
                                   int N, int NI, int C, int c0, int X, int Y, int Z,
                                   cudaStream_t stream) {
  const int smem = (9 + CC) * T_PLANE * (int)sizeof(float);
  const cudaError_t err = cudaFuncSetAttribute(warp_transpose_kernel<CC>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  // one subject per block: march along x over T_MARCH bricks
  const int march = NI == 1 && N > 1 ? 1 : T_MARCH;
  const int columns = bricks_of(X, Y, Z, march);
  warp_transpose_kernel<CC><<<(unsigned)columns * NI, T_THREADS, smem, stream>>>(
      disp, s, cot, out, N, NI, C, c0, X, Y, Z, columns, march);
  return cudaGetLastError();
}

cudaError_t launch_warp_transpose(const float* disp, float s, const float* cot,
                                  float* out, int N, int NI, int C, int X, int Y,
                                  int Z, cudaStream_t stream) {
  for (int c0 = 0; c0 < C; c0 += T_MAX_C) {
    const int cc = C - c0 < T_MAX_C ? C - c0 : T_MAX_C;
    const cudaError_t err =
        cc == 3 ? transpose_chunk<3>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream)
        : cc == 2 ? transpose_chunk<2>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream)
                  : transpose_chunk<1>(disp, s, cot, out, N, NI, C, c0, X, Y, Z, stream);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

cudaError_t launch_warp_dd(const float* I, const float* disp, float s,
                           const float* cot, float* out, int N, int NI, int C,
                           int X, int Y, int Z, bool compose, cudaStream_t stream) {
  const int smem = (C < D_MAX_C ? C : D_MAX_C) * D_PLANE * (int)sizeof(float);
  const int bricks = bricks_of(X, Y, Z);
  warp_dd_kernel<<<(unsigned)bricks * (NI == 1 ? 1 : N), D_THREADS, smem, stream>>>(
      I, disp, s, cot, out, N, NI, C, X, Y, Z, compose, bricks);
  return cudaGetLastError();
}

}  // namespace lagomorph

extern "C" int lagomorph_warp_unit_bwd(const float* I, const float* disp,
                                       const float* g, float* dI, float* d_disp,
                                       int N, int NI, int C, int X, int Y, int Z,
                                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = lagomorph::launch_warp_transpose(disp, 1.0f, g, dI, N, NI, C,
                                                     X, Y, Z, st);
  if (err != cudaSuccess) return (int)err;
  return (int)lagomorph::launch_warp_dd(I, disp, 1.0f, g, d_disp, N, NI, C, X, Y,
                                        Z, false, st);
}

// each pass alone, for timing them at the operand shapes of K5, K6 and K7
extern "C" int lagomorph_warp_transpose(const float* disp, float s, const float* cot, float* out,
                                        int N, int NI, int C, int X, int Y, int Z,
                                        void* stream) {
  return (int)lagomorph::launch_warp_transpose(disp, s, cot, out, N, NI, C, X, Y, Z,
                                               (cudaStream_t)stream);
}

extern "C" int lagomorph_warp_dd(const float* I, const float* disp, float s, const float* cot,
                                 float* out, int N, int NI, int C, int X, int Y, int Z,
                                 int compose, void* stream) {
  return (int)lagomorph::launch_warp_dd(I, disp, s, cot, out, N, NI, C, X, Y, Z, compose != 0,
                                        (cudaStream_t)stream);
}

extern "C" int lagomorph_warp_unit_fwd(const float* I, const float* disp,
                                       float* out, int N, int NI, int C, int X,
                                       int Y, int Z, void* stream) {
  using namespace lagomorph;
  const long blocks = (long)N * X * ((Y + FWD_TY - 1) / FWD_TY) * ((Z + FWD_TZ - 1) / FWD_TZ);
  warp_unit_fwd_kernel<<<(unsigned)blocks, FWD_TY * FWD_TZ, 0, (cudaStream_t)stream>>>(
      I, disp, out, N, NI, C, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" const char* lagomorph_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
