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
// `_bwd_dD_kernel_yb`), dispatched by `_sdu_bwd`, in one pass,
// `warp_bwd_kernel`, which K6 (the transpose alone) and K7 (the transpose
// and the weight gradient with the compose epilogue, epdiff_unit.cu) launch
// too.
//
// Bound on the H100 (each input read once, each output written once, 3.35
// TB/s): at 128^3 b4 K5 moves 251.7 MB (read d, g and the batch-1 atlas,
// write dI and d_disp: 75 us), the transpose alone at C = 3, NI = N (K6)
// 302 MB (90 us), K7's pass 503 MB (150 us); at b50 12.5 times that less
// the atlas's share: 0.88, 1.13 and 1.88 ms.
//
// Design.  A block owns a column: one output batch index nI, a tile of
// WB_TY x WB_TZ (y, z) outputs and a segment of x, and marches along x
// through the source planes the segment's outputs gather from, one x-plane a
// step (for a batch-1 image, NI == 1 < N, every subject's plane in turn at
// each x).  It stages the plane's raw displacement and cotangent, and for
// the weight gradient the image, over the tile and its one-voxel y/z halo:
// 3 + C (+ C) boxes of WB_RY x WB_RZ floats a step, zeros outside the
// volume; a box's rows start 4 floats before the tile (z0 - 4: the card
// faults on a TMA box whose first z is off a 16-byte boundary).  The boxes
// go into a ring of WB_SLOTS steps (the image's planes into a ring of their
// own, WB_ISLOTS), filled asynchronously one step ahead of the arithmetic:
// by the Tensor Memory Accelerator (one thread issues a box, out-of-volume
// reads come back as zeros, completion on an mbarrier of the step's slot)
// when rows are 16-byte multiples (Z % 4 == 0, every pointer 16-byte
// aligned), and by `cp.async` (4 bytes a thread, zero-filled outside)
// otherwise; the launcher picks by the shape.  Each thread owns WB_TL
// consecutive z outputs of one row and keeps the three output x-planes a
// source plane lands on (x - 1, x, x + 1) in registers: per step it reads
// the 3 source rows around its outputs, WB_TL + 2 sources each (a float4
// and two floats along z), forms each source's weights from the staged
// displacement at the point of use (stencil.cuh unit_weights: max(-d, 0),
// 1 - |d|, max(d, 0)) and adds its <= 27 landings; an output plane is
// stored as soon as its last source plane is done, so every input is read
// from device memory once, the x-halo of a segment excepted.  The clamp
// folds of the volume's faces (a tap (0, -1) lands on 0, a tap (n - 1, +1)
// on n - 1; warp_unit.py:477-502 `where(edge, ...)`) join the weight of o
// = -1 (at 0) or o = +1 (at n - 1) to that of o = 0 at the face's sources.
// The weight gradient of the step's plane reads the same staged
// displacement and cotangent at its voxel and the 8 live taps of the staged
// image (planes x - 1 .. x + 1 of the image ring; a batch-1 image is staged
// once for all subjects), one thread a z-line of 4 rows (so a warp's taps
// fall in one staged row).  Blocks walk their columns grid-stride (as many
// blocks as the SMs hold at once); the segment length is the one of X,
// 128, 64, 32, 16, 8 whose waves of columns take the fewest steps.  Each
// output sums in one fixed order (source plane, subject, source row, source
// z), so two launches agree bit for bit; no atomics.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), ms
// a call at 128^3 b4 / b50, against the two passes it
// replaced: K5 0.186 / 2.18 (0.389 / 4.37; bound 0.075 / 0.88), K6's
// transpose 0.150 / 1.67 (0.338 / 4.28; 0.090 / 1.13), K7 0.306 / 3.06
// (0.689 / 8.52; 0.150 / 1.88).  What chose the shapes, at b50: a ring of
// 2 steps against 3 (3 blocks an SM hold K7's 70 KB where 2 held its 97 KB:
// K7 3.06 against 3.66 ms, K6 1.67 against 1.93), tiles of 16 rows against
// 8 (K7 3.06 against 3.72 at 2 steps), the row loops rolled (unrolled, K7
// took 3.95-4.50 ms and K6 2.38).  Why two load paths: with the cp.async
// path forced at 128^3, the pass takes K5 0.320 / 3.82
// ms, K6 0.369 / 3.69 and K7 0.600 / 6.10 at b4 / b50, against TMA's 0.186
// / 2.20, 0.150 / 1.69 and 0.309 / 3.08; cp.async with 16-byte copies (a
// trial, not kept: it needs the shapes TMA takes) 0.245 / 2.95, 0.206 /
// 2.45 and 0.446 / 4.48.  TMA issues a box from one thread, where cp.async
// spends every thread's issue slots on addresses and bounds.
//
#include <stdint.h>

#include "stencil.cuh"
#ifdef __CUDACC__
#include <cuda.h>  // CUtensorMap
#else
#define __grid_constant__
#endif

namespace lagomorph {

// the forward's tile: 8 y-rows of 32 z, one thread per voxel
constexpr int FWD_TY = 8, FWD_TZ = 32;

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

// ---------------------------------------------------------------------------
// K5's pass (also K6's and K7's).
// ---------------------------------------------------------------------------

// a column's (y, z) tile of outputs; z outputs a thread in the transpose
constexpr int WB_TY = 16, WB_TZ = 32, WB_TL = 4;
constexpr int WB_THREADS = WB_TY * WB_TZ / WB_TL;
// the weight gradient: one thread a z-line, WB_DD_ROWS rows of the tile
constexpr int WB_DD_ROWS = WB_TY * WB_TZ / WB_THREADS;
// a staged box: rows y0 - 1 .. y0 + WB_TY, each z0 - WB_ZS .. z0 + WB_TZ +
// WB_ZS - 1 (a TMA box starts and spans 16-byte multiples along z), in a
// slot of WB_PLANE floats (a 128-byte multiple, as TMA destinations are
// aligned)
constexpr int WB_ZS = 4;
constexpr int WB_RY = WB_TY + 2, WB_RZ = WB_TZ + 2 * WB_ZS;
constexpr int WB_BOX = WB_RY * WB_RZ;
constexpr int WB_PLANE = (WB_BOX + 31) / 32 * 32;
// steps staged at once (the current one and the next), and x-planes of the
// image: the current step's three and the next
constexpr int WB_SLOTS = 2;
constexpr int WB_ISLOTS = WB_SLOTS + 2;
constexpr int WB_MAX_C = 3;  // channels a launch
static_assert(WB_RZ % 4 == 0 && WB_ZS % 4 == 0 && WB_TZ == 32 && WB_THREADS % 32 == 0,
              "row loads, z-lines");

// a launch's shape: the columns are (nI, x segment, y tile, z tile), z
// tile fastest
struct WarpGeo {
  int N, NI, C, c0, X, Y, Z;
  int L, nxs, nty, ntz;
  long columns;
};

struct Column {
  int nI, x0, x1, y0, z0;
  int ua, ub;  // its source planes: x0 - 1 .. x1, inside the volume
  int n0, n1;  // the subjects summed into nI
};

__device__ __forceinline__ Column column_of(long col, const WarpGeo& g) {
  Column c;
  c.z0 = (int)(col % g.ntz) * WB_TZ;
  col /= g.ntz;
  c.y0 = (int)(col % g.nty) * WB_TY;
  col /= g.nty;
  c.x0 = (int)(col % g.nxs) * g.L;
  c.nI = (int)(col / g.nxs);
  c.x1 = c.x0 + g.L < g.X ? c.x0 + g.L : g.X;
  c.ua = c.x0 > 0 ? c.x0 - 1 : 0;
  c.ub = c.x1 < g.X ? c.x1 : g.X - 1;
  c.n0 = g.NI == 1 ? 0 : c.nI;
  c.n1 = g.NI == 1 ? g.N : c.nI + 1;
  return c;
}

#ifdef __CUDACC__
struct WarpMaps {
  CUtensorMap d, g, I;
};
#else
struct WarpMaps {};  // the host form stages from the pointers
#endif

// --- Hopper's asynchronous copies, each with its host form (a synchronous
// copy; the step's wait is then the block's barrier) ---

#ifdef __CUDA_ARCH__
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

// the ring's mbarriers, one a slot, each completed by one arrival and its
// boxes' bytes (by the calling thread, before the block's barrier)
__device__ __forceinline__ void init_ring_barriers(uint64_t* bars) {
#ifdef __CUDA_ARCH__
  for (int b = 0; b < WB_SLOTS; ++b)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bars + b)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
#endif
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
#ifdef __CUDA_ARCH__
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
#endif
}

// element i of a staged box of channel-volume `ch` at x-plane `p`: its
// source, or null outside the volume
__device__ __forceinline__ const float* box_source(const float* base, int ch, int p, int i,
                                                   int y0, int z0, const WarpGeo& g) {
  const int r = i / WB_RZ, y = y0 - 1 + r, z = z0 - WB_ZS + (i - r * WB_RZ);
  if (p < 0 || p >= g.X || y < 0 || y >= g.Y || z < 0 || z >= g.Z) return nullptr;
  return base + (((size_t)ch * g.X + p) * g.Y + y) * g.Z + z;
}

// One box into a slot: by TMA (the calling thread, completion on `bar`) or
// by cp.async (every thread its share)
template <bool TMA>
__device__ __forceinline__ void stage_box(float* dst, const void* map, const float* base, int ch,
                                          int p, int y0, int z0, const WarpGeo& g,
                                          uint64_t* bar) {
#ifdef __CUDA_ARCH__
  if (TMA) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(z0 - WB_ZS), "r"(y0 - 1),
        "r"(p), "r"(ch)
        : "memory");
    return;
  }
  for (int i = threadIdx.x; i < WB_BOX; i += WB_THREADS) {
    const float* src = box_source(base, ch, p, i, y0, z0, g);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst + i)),
                 "l"(src ? src : base), "r"(src ? 4 : 0)
                 : "memory");
  }
#else
  for (int i = TMA ? 0 : (int)threadIdx.x; i < WB_BOX; i += TMA ? 1 : WB_THREADS) {
    const float* src = box_source(base, ch, p, i, y0, z0, g);
    dst[i] = src ? *src : 0.0f;
  }
#endif
}

__device__ __forceinline__ void cp_async_commit() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}

// the wait for step k's boxes: its slot's mbarrier phase (TMA), or all but
// the newest WB_SLOTS - 1 groups of copies and the block's barrier
template <bool TMA>
__device__ __forceinline__ void wait_step(uint64_t* bars, long k) {
#ifdef __CUDA_ARCH__
  if (TMA) {
    asm volatile(
        "{\n.reg .pred P1;\nLAB_WAIT:\n"
        "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
        "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bars + k % WB_SLOTS)),
        "r"((uint32_t)((k / WB_SLOTS) & 1))
        : "memory");
    return;
  }
  asm volatile("cp.async.wait_group %0;\n" ::"n"(WB_SLOTS - 1) : "memory");
#endif
  __syncthreads();
}

// the slot of x-plane p of the image in a column's ring (p >= ua - 1)
__device__ __forceinline__ int image_slot(int p, const Column& c) {
  return (p - c.ua + 1) % WB_ISLOTS;
}

// Stage step t of column c (its k-th step of the block) into slot k: the
// displacement and cotangent of subject n at source plane ux and, for the
// weight gradient at a step of the first subject, the image's new planes
// (ua - 1 .. ua + 1 at the column's first plane, ux + 1 after).  Nothing
// beyond the column's last step; cp.async commits a group either way.
template <int CC, bool DD, bool TMA>
__device__ __forceinline__ void stage_step(const WarpMaps& maps, const float* d, const float* g,
                                           const float* I, float* smem, uint64_t* bars, long k,
                                           const Column& c, int t, const WarpGeo& geo) {
  const int nsub = c.n1 - c.n0;
  if (t < (c.ub - c.ua + 1) * nsub && (!TMA || threadIdx.x == 0)) {
    const int ux = c.ua + t / nsub, n = c.n0 + t % nsub;
    const int slot = (int)(k % WB_SLOTS);
    float* dg = smem + slot * (3 + CC) * WB_PLANE;
    const int planes = DD && n == c.n0 ? (ux == c.ua ? 3 : 1) : 0;
    const int p0 = ux == c.ua ? ux - 1 : ux + 1;
    if (TMA) mbar_expect(bars + slot, (uint32_t)((3 + CC + planes * CC) * WB_BOX * sizeof(float)));
#ifdef __CUDACC__
    const void *dm = &maps.d, *gm = &maps.g, *im = &maps.I;
#else
    const void *dm = nullptr, *gm = nullptr, *im = nullptr;
#endif
#pragma unroll
    for (int a = 0; a < 3; ++a)
      stage_box<TMA>(dg + a * WB_PLANE, dm, d, n * 3 + a, ux, c.y0, c.z0, geo, bars + slot);
#pragma unroll
    for (int cc = 0; cc < CC; ++cc)
      stage_box<TMA>(dg + (3 + cc) * WB_PLANE, gm, g, n * geo.C + geo.c0 + cc, ux, c.y0, c.z0,
                     geo, bars + slot);
    float* img = smem + WB_SLOTS * (3 + CC) * WB_PLANE;
    const int nimg = geo.NI == 1 ? 0 : n;
    for (int q = 0; q < planes; ++q)
#pragma unroll
      for (int cc = 0; cc < CC; ++cc)
        stage_box<TMA>(img + (image_slot(p0 + q, c) * CC + cc) * WB_PLANE, im, I,
                       nimg * geo.C + geo.c0 + cc, p0 + q, c.y0, c.z0, geo, bars + slot);
  }
  if (!TMA) cp_async_commit();
}

// six consecutive staged floats from 4 bytes before a 16-byte boundary
__device__ __forceinline__ void load6(const float* p, float* v) {
#ifdef __CUDA_ARCH__
  const float4 a = *reinterpret_cast<const float4*>(p + 1);
  v[0] = p[0]; v[1] = a.x; v[2] = a.y; v[3] = a.z; v[4] = a.w; v[5] = p[5];
#else
  for (int i = 0; i < 6; ++i) v[i] = p[i];
#endif
}

// The transpose's share of one step: the staged source plane ux's
// landings on the WB_TL z outputs (vz0 ..) of row vy of this thread, in
// its three output planes acc[0] (x = ux - 1), acc[1] (ux), acc[2] (ux +
// 1).  Row r of sources (uy = vy - 1 + r) lands with the y weight of o = 1
// - r; source j of a row (z = vz0 - 1 + j) on outputs j - 2 (o = -1), j - 1
// and j; out-of-range landings are skipped at compile time.  A fold joins
// the weight of o = -1 at a low face (o = +1 at a high face) to that of o
// = 0; the landings the fold moves would fall outside the volume, in
// accumulators never stored.
template <int CC>
__device__ __forceinline__ void transpose_step(const float* dg, float s, int ux, int vy, int vz0,
                                               int row0, const WarpGeo& g,
                                               float (&acc)[3][WB_TL][CC]) {
  const bool xlo = ux == 0, xhi = ux == g.X - 1;
  const bool ylo = vy == 0, yhi = vy == g.Y - 1, zlo = vz0 == 0;
  const int jh = g.Z - vz0;  // the source at z = Z - 1, when 1 <= jh <= WB_TL
#pragma unroll 1
  for (int r = 0; r < 3; ++r) {
    const int row = row0 + r * WB_RZ;
    float sd[3][WB_TL + 2], sg[CC][WB_TL + 2];
#pragma unroll
    for (int a = 0; a < 3; ++a) load6(dg + a * WB_PLANE + row, sd[a]);
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) load6(dg + (3 + cc) * WB_PLANE + row, sg[cc]);
#pragma unroll
    for (int j = 0; j < WB_TL + 2; ++j) {
      AxisWeights wx = unit_weights(__fmul_rn(s, sd[0][j]));
      if (xlo) wx.z = __fadd_rn(wx.z, wx.m);
      if (xhi) wx.z = __fadd_rn(wx.z, wx.p);
      const AxisWeights wyy = unit_weights(__fmul_rn(s, sd[1][j]));
      float wy = wyy.z;
      if (r == 1 && ylo) wy = __fadd_rn(wy, wyy.m);
      if (r == 1 && yhi) wy = __fadd_rn(wy, wyy.p);
      wy = r == 0 ? wyy.p : (r == 2 ? wyy.m : wy);
      AxisWeights wz = unit_weights(__fmul_rn(s, sd[2][j]));
      if (j == 1 && zlo) wz.z = __fadd_rn(wz.z, wz.m);
      if (j >= 1 && j <= WB_TL && j == jh) wz.z = __fadd_rn(wz.z, wz.p);
      const float w3[3] = {wx.m, wx.z, wx.p};
#pragma unroll
      for (int o = 0; o < 3; ++o) {
        const float h = __fmul_rn(w3[o], wy);
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) {
          const float hc = __fmul_rn(h, sg[cc][j]);
          if (j >= 2) acc[o][j - 2][cc] = fmaf(wz.m, hc, acc[o][j - 2][cc]);
          if (j >= 1 && j <= WB_TL) acc[o][j - 1][cc] = fmaf(wz.z, hc, acc[o][j - 1][cc]);
          if (j < WB_TL) acc[o][j][cc] = fmaf(wz.p, hc, acc[o][j][cc]);
        }
      }
    }
  }
}

// one output x-plane of the transpose: this thread's WB_TL z outputs of
// row vy, channels c0 .. c0 + CC - 1 of batch index nI
template <int CC, bool VEC>
__device__ __forceinline__ void store_outputs(const float (&a)[WB_TL][CC], float* out, int nI,
                                              int plane, int vy, int vz0, const WarpGeo& g) {
  if (vy >= g.Y || vz0 >= g.Z) return;
  const size_t V = (size_t)g.X * g.Y * g.Z;
  float* o = out + ((size_t)nI * g.C + g.c0) * V + ((size_t)plane * g.Y + vy) * g.Z + vz0;
#pragma unroll
  for (int cc = 0; cc < CC; ++cc) {
    if (VEC) {
      *reinterpret_cast<float4*>(o + cc * V) = make_float4(a[0][cc], a[1][cc], a[2][cc], a[3][cc]);
    } else {
#pragma unroll
      for (int i = 0; i < WB_TL; ++i)
        if (vz0 + i < g.Z) o[cc * V + i] = a[i][cc];
    }
  }
}

// The weight gradient of subject n at plane ux, one z-line of WB_DD_ROWS
// rows a thread: the staged displacement and cotangent at the voxel and
// the 8 live taps (stencil.cuh unit_pair, indices clamped to the volume) of
// the staged image, d_a = sum over the other axes' tap pairs of their
// weights' product times <g, I> at the pair's high tap less its low tap
// (the slopes of the live pair are -1, +1; 0 outside the unit regime).
// out_dd: d_a, s * g_a + s * d_a (`compose`), or its old value + d_a
// (`accumulate`: a later chunk of channels).
template <int CC>
__device__ __forceinline__ void weight_grad_step(const float* dg, const float* img, float s,
                                                 int ux, int n, const Column& c,
                                                 const WarpGeo& g, float* __restrict__ out,
                                                 bool compose, bool accumulate) {
  const int lane = (int)threadIdx.x & 31, vz = c.z0 + lane;
  if (vz >= g.Z) return;
  const size_t V = (size_t)g.X * g.Y * g.Z;
#pragma unroll 1
  for (int i = 0; i < WB_DD_ROWS; ++i) {
    const int ry = ((int)threadIdx.x >> 5) * WB_DD_ROWS + i, vy = c.y0 + ry;
    if (vy >= g.Y) break;
    const int own = (ry + 1) * WB_RZ + lane + WB_ZS;
    const UnitPair px = unit_pair(__fmul_rn(s, dg[own]));
    const UnitPair py = unit_pair(__fmul_rn(s, dg[WB_PLANE + own]));
    const UnitPair pz = unit_pair(__fmul_rn(s, dg[2 * WB_PLANE + own]));
    float gc[CC];
#pragma unroll
    for (int cc = 0; cc < CC; ++cc) gc[cc] = dg[(3 + cc) * WB_PLANE + own];
    const float* tx[2];
    int ty[2], tz[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      tx[e] = img + image_slot(clampi(ux + px.lo + e, g.X), c) * CC * WB_PLANE;
      ty[e] = (clampi(vy + py.lo + e, g.Y) - c.y0 + 1) * WB_RZ;
      tz[e] = clampi(vz + pz.lo + e, g.Z) - c.z0 + WB_ZS;
    }
    float gI[2][2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* q = tx[a] + ty[b] + tz[e];
          float v = __fmul_rn(gc[0], q[0]);
#pragma unroll
          for (int cc = 1; cc < CC; ++cc) v = fmaf(gc[cc], q[cc * WB_PLANE], v);
          gI[a][b][e] = v;
        }
    float dd[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        dd[0] = fmaf(__fmul_rn(py.w[a], pz.w[b]), __fsub_rn(gI[1][a][b], gI[0][a][b]), dd[0]);
        dd[1] = fmaf(__fmul_rn(px.w[a], pz.w[b]), __fsub_rn(gI[a][1][b], gI[a][0][b]), dd[1]);
        dd[2] = fmaf(__fmul_rn(px.w[a], py.w[b]), __fsub_rn(gI[a][b][1], gI[a][b][0]), dd[2]);
      }
    const bool in[3] = {px.in, py.in, pz.in};
    float* o = out + (size_t)n * 3 * V + ((size_t)ux * g.Y + vy) * g.Z + vz;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float v = in[a] ? dd[a] : 0.0f;
      o[a * V] = compose      ? __fadd_rn(__fmul_rn(s, gc[a < CC ? a : 0]), __fmul_rn(s, v))
                 : accumulate ? __fadd_rn(o[a * V], v)
                              : v;
    }
  }
}

// The pass (see the note at the top): channels c0 .. c0 + CC - 1 of the
// transpose into out_t and, when DD, the weight gradient into out_dd.  TMA:
// the boxes come by the Tensor Memory Accelerator (and the transpose's
// rows are stored as float4), else by cp.async.
template <int CC, bool DD, bool TMA>
__global__ void __launch_bounds__(WB_THREADS)
    warp_bwd_kernel(const __grid_constant__ WarpMaps maps, const float* __restrict__ disp,
                    const float* __restrict__ cot, const float* __restrict__ I, float s,
                    float* __restrict__ out_t, float* __restrict__ out_dd, const WarpGeo geo,
                    bool compose, bool accumulate) {
  extern __shared__ __align__(128) float smem[];
  float* img = smem + WB_SLOTS * (3 + CC) * WB_PLANE;
  uint64_t* bars = reinterpret_cast<uint64_t*>(img + (DD ? WB_ISLOTS * CC * WB_PLANE : 0));
  if (TMA && threadIdx.x == 0) init_ring_barriers(bars);
  __syncthreads();
  const int tz = (int)threadIdx.x % (WB_TZ / WB_TL), ty = (int)threadIdx.x / (WB_TZ / WB_TL);
  long k = 0;  // the block's steps so far: step k uses slot k % WB_SLOTS
  for (long col = blockIdx.x; col < geo.columns; col += gridDim.x) {
    const Column c = column_of(col, geo);
    const int nsub = c.n1 - c.n0, steps = (c.ub - c.ua + 1) * nsub;
    for (int t = 0; t < WB_SLOTS; ++t)
      stage_step<CC, DD, TMA>(maps, disp, cot, I, smem, bars, k + t, c, t, geo);
    const int vy = c.y0 + ty, vz0 = c.z0 + tz * WB_TL;
    float acc[3][WB_TL][CC];
#pragma unroll
    for (int o = 0; o < 3; ++o)
#pragma unroll
      for (int i = 0; i < WB_TL; ++i)
#pragma unroll
        for (int cc = 0; cc < CC; ++cc) acc[o][i][cc] = 0.0f;
    for (int t = 0; t < steps; ++t, ++k) {
      const int ux = c.ua + t / nsub, n = c.n0 + t % nsub;
      wait_step<TMA>(bars, k);
      const float* dg = smem + (int)(k % WB_SLOTS) * (3 + CC) * WB_PLANE;
      transpose_step<CC>(dg, s, ux, vy, vz0, ty * WB_RZ + tz * WB_TL + WB_ZS - 1, geo, acc);
      if (DD && ux >= c.x0 && ux < c.x1)
        weight_grad_step<CC>(dg, img, s, ux, n, c, geo, out_dd, compose, accumulate);
      if (n == c.n1 - 1) {  // the source plane is done for every subject
        if (ux - 1 >= c.x0) store_outputs<CC, TMA>(acc[0], out_t, c.nI, ux - 1, vy, vz0, geo);
        if (ux == geo.X - 1 && ux >= c.x0)
          store_outputs<CC, TMA>(acc[1], out_t, c.nI, ux, vy, vz0, geo);
#pragma unroll
        for (int i = 0; i < WB_TL; ++i)
#pragma unroll
          for (int cc = 0; cc < CC; ++cc) {
            acc[0][i][cc] = acc[1][i][cc];
            acc[1][i][cc] = acc[2][i][cc];
            acc[2][i][cc] = 0.0f;
          }
      }
      __syncthreads();  // every thread is done with slot k (and image plane ux - 1)
      stage_step<CC, DD, TMA>(maps, disp, cot, I, smem, bars, k + WB_SLOTS, c, t + WB_SLOTS,
                              geo);
    }
  }
}

static size_t pass_smem(int CC, bool DD) {
  return (size_t)(WB_SLOTS * (3 + CC) + (DD ? WB_ISLOTS * CC : 0)) * WB_PLANE * sizeof(float) +
         WB_SLOTS * sizeof(uint64_t);
}

#ifdef __CUDACC__
// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                                    cudaEnableDefault, &q);
#endif
    return err == cudaSuccess && q == cudaDriverEntryPointSuccess ? (EncodeTiled)p : nullptr;
  }();
  return fn;
}

// the map of B channel-volumes of X x Y x Z floats at `base`, read in
// boxes of WB_RZ x WB_RY x 1 x 1 (a box's first z must be a multiple of 4:
// the card faults on a TMA load whose row starts off a 16-byte boundary)
static cudaError_t encode_map(CUtensorMap* m, const float* base, int B, int X, int Y, int Z) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {(cuuint64_t)Z, (cuuint64_t)Y, (cuuint64_t)X, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Z * 4, (cuuint64_t)Y * Z * 4,
                                 (cuuint64_t)X * Y * Z * 4};
  const cuuint32_t box[4] = {WB_RZ, WB_RY, 1, 1}, unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(m, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, (void*)base, dims, strides, box,
                            unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
#endif

// The segment length along x: of X, 128, 64, 32, 16 and 8, the one whose
// waves of columns over `slots` resident blocks take the fewest steps (a
// column of L planes steps through L + 2 source planes, each for `nsub`
// subjects; longer first on a tie).
static int segment_length(int X, long tiles, int nsub, long slots) {
  int best = X;
  long best_cost = -1;
  for (const int L : {X, 128, 64, 32, 16, 8}) {
    if (L > X) continue;
    const long columns = tiles * ((X + L - 1) / L);
    const long cost = (columns + slots - 1) / slots * (L + 2 < X ? L + 2 : X) * nsub;
    if (best_cost < 0 || cost < best_cost) {
      best = L;
      best_cost = cost;
    }
  }
  return best;
}

template <int CC, bool DD, bool TMA>
static cudaError_t launch_pass(const float* I, const float* disp, float s, const float* cot,
                               float* out_t, float* out_dd, int N, int NI, int C, int c0, int X,
                               int Y, int Z, bool compose, cudaStream_t stream) {
  const auto kernel = warp_bwd_kernel<CC, DD, TMA>;
  const size_t smem = pass_smem(CC, DD);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  static std::atomic<int> resident_of[kDevices], sms_of[kDevices];
  const int resident = per_device(resident_of, 1, [&](int, int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, kernel, WB_THREADS, smem);
  });
  const int sms = per_device(sms_of, 132, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
  WarpGeo geo;
  geo.N = N;
  geo.NI = NI;
  geo.C = C;
  geo.c0 = c0;
  geo.X = X;
  geo.Y = Y;
  geo.Z = Z;
  geo.nty = (Y + WB_TY - 1) / WB_TY;
  geo.ntz = (Z + WB_TZ - 1) / WB_TZ;
  const long tiles = (long)NI * geo.nty * geo.ntz, slots = (long)sms * resident;
  geo.L = segment_length(X, tiles, NI == 1 ? N : 1, slots);
  geo.nxs = (X + geo.L - 1) / geo.L;
  geo.columns = tiles * geo.nxs;
  WarpMaps maps{};
#ifdef __CUDACC__
  if (TMA) {
    if ((err = encode_map(&maps.d, disp, N * 3, X, Y, Z)) != cudaSuccess ||
        (err = encode_map(&maps.g, cot, N * C, X, Y, Z)) != cudaSuccess ||
        (DD && (err = encode_map(&maps.I, I, NI * C, X, Y, Z)) != cudaSuccess))
      return err;
  }
#endif
  const long grid = geo.columns < slots ? geo.columns : slots;
  kernel<<<(unsigned)grid, WB_THREADS, smem, stream>>>(maps, disp, cot, I, s, out_t, out_dd, geo,
                                                       compose, c0 > 0);
  return cudaGetLastError();
}

template <int CC, bool DD>
static cudaError_t launch_chunk(bool tma, const float* I, const float* disp, float s,
                                const float* cot, float* out_t, float* out_dd, int N, int NI,
                                int C, int c0, int X, int Y, int Z, bool compose,
                                cudaStream_t stream) {
  return tma ? launch_pass<CC, DD, true>(I, disp, s, cot, out_t, out_dd, N, NI, C, c0, X, Y, Z,
                                         compose, stream)
             : launch_pass<CC, DD, false>(I, disp, s, cot, out_t, out_dd, N, NI, C, c0, X, Y, Z,
                                          compose, stream);
}

static bool aligned16(const void* p) { return p == nullptr || (uintptr_t)p % 16 == 0; }

// The pass, one launch a chunk of up to WB_MAX_C channels, on TMA where the
// shape allows it, else on cp.async
cudaError_t launch_warp_bwd(const float* I, const float* disp, float s, const float* cot,
                            float* out_t, float* out_dd, int N, int NI, int C, int X, int Y,
                            int Z, bool compose, cudaStream_t stream) {
  // TMA reads rows of 16-byte multiples from 16-byte aligned bases; the
  // transpose's float4 stores need the same of its output
  const bool tma = Z % 4 == 0 && aligned16(I) && aligned16(disp) && aligned16(cot) &&
                   aligned16(out_t) && aligned16(out_dd);
  const bool dd = I != nullptr;
  for (int c0 = 0; c0 < C; c0 += WB_MAX_C) {
    const int cc = C - c0 < WB_MAX_C ? C - c0 : WB_MAX_C;
    const cudaError_t err =
        dd ? (cc == 3   ? launch_chunk<3, true>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C, c0,
                                                X, Y, Z, compose, stream)
              : cc == 2 ? launch_chunk<2, true>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C, c0,
                                                X, Y, Z, compose, stream)
                        : launch_chunk<1, true>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C, c0,
                                                X, Y, Z, compose, stream))
           : (cc == 3   ? launch_chunk<3, false>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C,
                                                 c0, X, Y, Z, compose, stream)
              : cc == 2 ? launch_chunk<2, false>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C,
                                                 c0, X, Y, Z, compose, stream)
                        : launch_chunk<1, false>(tma, I, disp, s, cot, out_t, out_dd, N, NI, C,
                                                 c0, X, Y, Z, compose, stream));
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace lagomorph

extern "C" int lagomorph_warp_unit_bwd(const float* I, const float* disp,
                                       const float* g, float* dI, float* d_disp,
                                       int N, int NI, int C, int X, int Y, int Z,
                                       void* stream) {
  return (int)lagomorph::launch_warp_bwd(I, disp, 1.0f, g, dI, d_disp, N, NI, C, X, Y, Z, false,
                                         (cudaStream_t)stream);
}

// the pass in each mode alone, for timing and testing it at the operand
// shapes of K5, K6 and K7: the transpose, and the transpose with the
// weight gradient (compose: K7's epilogue)
extern "C" int lagomorph_warp_transpose(const float* disp, float s, const float* cot, float* out,
                                        int N, int NI, int C, int X, int Y, int Z,
                                        void* stream) {
  return (int)lagomorph::launch_warp_bwd(nullptr, disp, s, cot, out, nullptr, N, NI, C, X, Y, Z,
                                         false, (cudaStream_t)stream);
}

extern "C" int lagomorph_warp_dd(const float* I, const float* disp, float s, const float* cot,
                                 float* out_t, float* out_dd, int N, int NI, int C, int X, int Y,
                                 int Z, int compose, void* stream) {
  return (int)lagomorph::launch_warp_bwd(I, disp, s, cot, out_t, out_dd, N, NI, C, X, Y, Z,
                                         compose != 0, (cudaStream_t)stream);
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
