// K1 and K2: the two stencil steps of one EPDiff substep, forward, each
// with the unit-regime flag of its warp displacement.
//
// K1, Ad* (the momentum transport):
//   mw_a(p)  = sum_o w_o(phiinv(p)) * m0_a(clamp(p + o))        (unit warp)
//   out_c(p) = sum_a (D_a phiinv_c(p) + delta_ca) * mw_a(p)      (Jacobian)
//   flag     = all components of phiinv in [-1, 1)
// i.e. jacobian_times_vectorfield(phiinv, sample_displacement_unit(m0,
// phiinv), displacement=True), without transpose.  Replaces
// lagomorph_tpu/ops/pallas/epdiff_unit.py `_adstar_fwd_kernel[_mw]`
// (whole-Y, `_adstar_fwd_wholey`), `_adstar_fwd_kernel_yb[_mw]` /
// `_adstar_yb_fwd_body` (y-blocked, `_adstar_fwd_yb`), and the padded-
// resident lagomorph_tpu/ops/pallas/padres.py `_adstar_fwd_kernel_pr[_mw]`
// (`_adstar_fwd_pr`), whose in-kernel flag (padres.py:211-227) is K1's flag.
//
// K2, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)                                           (float32)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff_unit.py `_compose_fwd_kernel[_yb]` / `_compose_yb_fwd_body`
// (`_compose_fwd_dispatch`) and padres.py `_compose_fwd_kernel_pr`
// (`_compose_fwd_pr`, `_store_padded`).
//
// Not carried over: padres.py keeps phiinv in a padded (N,3,X+16,(Y+4)*Z)
// layout through the whole shooting loop.  That layout exists only for the
// TPU's (8,128) DMA alignment (padres.py:1-12, 58-59); here taps clamp in the
// kernel and the carry stays (N,3,X,Y,Z).  The TPU carries the flag as a
// running min from one sequential grid step to the next; Hopper's blocks run
// in no order, so the flag is an int32 in device memory that the wrapper
// sets to 1 and any warp that sees an out-of-range component clears with
// atomicAnd.
//
// Bound on the H100: memory.  K1 reads phiinv and m0 and writes out (three
// 100.7 MB fields at 128^3 b4, m0 read with batch stride 0 when its batch is
// 1); K2 reads phiinv and v and writes out (three fields, 0.090 ms at
// 3.35 TB/s).  Both march along x through planes staged in shared memory
// and sum the 8 live taps there (see compose_fwd_kernel, ad_star_fwd_kernel):
// K2 stages phiinv, K1 m0 and phiinv (the Jacobian's y and z neighbours;
// its x neighbours are in registers).  The staging adds the y/z halo,
// (AB_TY + 2)(AB_TZ + 2) / (AB_TY AB_TZ) - 1 = 33% more loads of the staged
// fields, mostly from L2, and 2 planes a march.  In both the flag costs
// one ballot per warp and at most one atomic per warp.  When autograd
// needs it, K1 also writes the warped momentum mw (the `_mw` variants'
// residual, epdiff_unit.py:214, padres.py:249), which K6 reads instead of
// re-enumerating the warp (a fourth field, 0.120 ms); the forward-only
// path passes no mw buffer and moves no extra bytes.
//
// K6, Ad* backward (cotangent g of out; math at epdiff_unit.py:459-497):
//   d_mw  = (J + I)^T g                               (pointwise)
//   d_m0  = warp transpose of d_mw at weights(phiinv)  (gather form)
//   d_phi = weight-gradient path (image m0, cotangent d_mw)
//           + sum_a D_a^T (g * mw_a)                   (divergence path)
// Replaces epdiff_unit.py `_adstar_bwd_fused_dispatch` (kernels
// `_adstar_bwd_kernel`, `_adstar_bwd_kernel_yb`, body `_adstar_yb_bwd_body`)
// and padres.py `_adstar_bwd_pr` (`_adstar_bwd_kernel_pr`).  Two passes: the
// first computes d_mw, writes it to a scratch field, and finishes d_phi (it
// needs d_mw only at its own voxel); the second is the gather transpose of
// d_mw (warp_unit.cu), which needs d_mw at 27 neighbours.  Recomputing d_mw
// at every neighbour instead would save the scratch round trip (2 x 100.7 MB
// at 128^3 b4) at 27x the Jacobian work; the two-pass form is the simple
// one.  A batch-1 m0 gets d_m0 summed over N in the gather, no atomics.
// The first pass marches along x through staged planes (see
// ad_star_bwd_first_kernel): each input is read from device memory about
// once, the weight-gradient path sums the 8 live taps (stencil.cuh
// live_pair) of m0 from shared memory, and the next plane's loads are in
// flight while the current one is computed.  The 19 taps it skips add
// exact zeros for a finite m0 (as K4's, warp_unit.cu).
//
// K7, compose backward (cotangent g of out = s v + phi(x + s v); math at
// epdiff_unit.py:711-725, padres.py:518-551):
//   d_phi = warp transpose of g at weights(s v)
//   d_v   = s g + s * (weight-gradient path, image phi, cotangent g)
// Replaces epdiff_unit.py `_compose_bwd_fused_dispatch` (`_compose_bwd_kernel`,
// `_compose_bwd_kernel_yb`, body `_compose_yb_bwd_body`) and padres.py
// `_compose_bwd_pr` (`_compose_bwd_kernel_pr`).  s v is formed in each pass
// with the forward's rounding (__fmul_rn), never stored.
//
// Bound on the H100 (128^3 b4, 100.7 MB per 3-channel field): K6 must move
// 6 fields (read phi, m0, g, mw; write d_phi, d_m0), ~180 us at 3.35 TB/s;
// its two passes move 11 (the scratch d_mw and a second read of phi).  K7
// must move 5 (read phi, v, g; write d_phi, d_v), ~150 us, and its one
// pass moves those 5.  The transpose, and K7's weight gradient, are K5's
// pass (warp_unit.cu: x-planes of a tile staged asynchronously with a
// halo, the transpose and the 8 live taps from one staging).  K6's first
// pass must move 6 fields (read phi, m0, g, mw; write d_mw, d_phi), ~180 us;
// its staging adds the y/z halo, (AB_TY + 2)(AB_TZ + 2) / (AB_TY AB_TZ) - 1
// = 33% more loads of its inputs, mostly from L2, and 2 planes a march.  It
// is held at 2 blocks of 256 threads an SM (128 registers): built for 3
// (80 registers) it spills, and ran slower on an H100 (PERF.md).
#include <atomic>

#include "stencil.cuh"

namespace lagomorph {

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

// K6, first pass: d_mw (to the scratch) and d_phi.  A block owns one
// subject and a (y, z) tile of AB_TY x AB_TZ voxels, one thread per (y, z),
// and marches along x over `march` planes (march_length).  Each step of the
// march stages one new x-plane of the tile and its one-voxel y/z halo in
// shared memory, in rings: m0 in 4 slots (the taps read planes x - 1 ..
// x + 1 while plane x + 2 is written), and phi, g, mw_1 and mw_2 in 3 (the
// Jacobian's and the divergence's y and z face neighbours come from plane
// x; plane x + 1 waits, plane x + 2 is written), so one barrier a step
// suffices.  A thread's own phi, g and mw_0 at x - 1, x and x + 1 (the x
// neighbours) are a 3-slot register ring.  The loads of plane x + 2 are
// issued before plane x's arithmetic.  Staging loads nothing outside the
// volume: every read of a staged plane is at a clamped index, inside it.
constexpr int AB_TY = 8, AB_TZ = 32;
constexpr int AB_THREADS = AB_TY * AB_TZ;
constexpr int AB_HY = AB_TY + 2, AB_HZ = AB_TZ + 2;
constexpr int AB_PLANE = AB_HY * AB_HZ;           // floats of one staged channel
constexpr int AB_BORDER = AB_PLANE - AB_THREADS;  // its halo positions
// staged channels: m0 0-2, then the face channels phi 0-2, g 3-5, mw_1 6,
// mw_2 7; shared memory holds 3 slots of the face channels, then 4 of m0
constexpr int AB_FACE = 8;
constexpr int AB_STAGED = 3 + AB_FACE;
constexpr int AB_SMEM = (3 * AB_FACE + 4 * 3) * AB_PLANE;
// the halo's (channel, position) loads, spread over the block's threads
constexpr int AB_HALO = (AB_STAGED * AB_BORDER + AB_THREADS - 1) / AB_THREADS;
static_assert(AB_SMEM * sizeof(float) <= 48 * 1024, "more needs the opt-in attribute");

// halo position h (0 .. AB_BORDER - 1) -> its index ly * AB_HZ + lz in a
// staged plane: the rows ly = 0 and AB_HY - 1, then the columns lz = 0 and
// AB_HZ - 1 between them
__device__ __forceinline__ int border_index(int h) {
  if (h < 2 * AB_HZ) return h < AB_HZ ? h : (AB_HY - 1) * AB_HZ + h - AB_HZ;
  h -= 2 * AB_HZ;
  return h < AB_TY ? (1 + h) * AB_HZ : (1 + h - AB_TY) * AB_HZ + AB_HZ - 1;
}

// channel c of the staged list (m0 0-2, phi 3-5, g 6-8, mw_1 9, mw_2 10)
__device__ __forceinline__ const float* staged_field(int c, const float* ph, const float* gn,
                                                     const float* mwn, const float* mb, int V) {
  return c < 3 ? mb + (size_t)c * V
       : c < 6 ? ph + (size_t)(c - 3) * V
       : c < 9 ? gn + (size_t)(c - 6) * V
               : mwn + (size_t)(c - 8) * V;
}

// A thread's share of the halo of a marching kernel (K6's first pass, K2,
// K1) that stages `channels` channels, found once for its march: items
// threadIdx.x + j * AB_THREADS of the list channel-major over the channels
// and AB_BORDER positions, each with its source in plane 0 (null outside
// the volume: staged as 0) and its index lane(c) * AB_PLANE + b in a staged
// slot of its channel's ring (-1: no item); field(c) is channel c's field.
template <int ITEMS>
struct Halo {
  const float* src[ITEMS];
  int dst[ITEMS];
};

template <int ITEMS, class Field, class Lane>
__device__ __forceinline__ void find_halo(Halo<ITEMS>& h, int channels, Field field, Lane lane,
                                          int Y, int Z, int y0, int z0) {
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = threadIdx.x + j * AB_THREADS;
    h.src[j] = nullptr;
    h.dst[j] = -1;
    if (i < channels * AB_BORDER) {
      const int c = i / AB_BORDER, b = border_index(i % AB_BORDER);
      const int gy = y0 - 1 + b / AB_HZ, gz = z0 - 1 + b % AB_HZ;
      h.dst[j] = lane(c) * AB_PLANE + b;
      if (gy >= 0 && gy < Y && gz >= 0 && gz < Z) h.src[j] = field(c) + gy * Z + gz;
    }
  }
}

// K6's halo items (item i is of m0 when i < 3 * AB_BORDER)
using AdHalo = Halo<AB_HALO>;

// One x-plane's loads of one thread: its own voxel's phi 0-2, g 3-5, mw
// 6-8 and m0 9-11, and its halo items; zeros outside the volume.
struct AdPlane {
  float own[12];
  float halo[AB_HALO];
};

__device__ __forceinline__ void adstar_load(AdPlane& r, const AdHalo& h,
                                            const float* __restrict__ ph,
                                            const float* __restrict__ gn,
                                            const float* __restrict__ mwn,
                                            const float* __restrict__ mb, int V, int xp, int Y,
                                            int Z, int y0, int z0) {
  const int y = y0 + (int)threadIdx.x / AB_TZ, z = z0 + (int)threadIdx.x % AB_TZ;
  const bool in = y < Y && z < Z;
  const int plane = xp * Y * Z, u = plane + y * Z + z;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.own[c] = in ? __ldg(ph + (size_t)c * V + u) : 0.0f;
    r.own[3 + c] = in ? __ldg(gn + (size_t)c * V + u) : 0.0f;
    r.own[6 + c] = in ? __ldg(mwn + (size_t)c * V + u) : 0.0f;
    r.own[9 + c] = in ? __ldg(mb + (size_t)c * V + u) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < AB_HALO; ++j) r.halo[j] = h.src[j] ? __ldg(h.src[j] + plane) : 0.0f;
}

// the staged planes of ring index k: the offsets of its face slot and its
// m0 slot in shared memory
__device__ __forceinline__ int face_slot(int k) { return (k % 3) * AB_FACE * AB_PLANE; }
__device__ __forceinline__ int m0_slot(int k) { return (3 * AB_FACE + (k & 3) * 3) * AB_PLANE; }

__device__ __forceinline__ void adstar_store(const AdPlane& r, const AdHalo& h, float* sm,
                                             int k) {
  float* face = sm + face_slot(k);
  float* m0s = sm + m0_slot(k);
  const int own = ((int)threadIdx.x / AB_TZ + 1) * AB_HZ + (int)threadIdx.x % AB_TZ + 1;
#pragma unroll
  for (int c = 0; c < 6; ++c) face[c * AB_PLANE + own] = r.own[c];  // phi, g
  face[6 * AB_PLANE + own] = r.own[7];                              // mw_1
  face[7 * AB_PLANE + own] = r.own[8];                              // mw_2
#pragma unroll
  for (int c = 0; c < 3; ++c) m0s[c * AB_PLANE + own] = r.own[9 + c];
#pragma unroll
  for (int j = 0; j < AB_HALO; ++j)
    if (h.dst[j] >= 0)
      (threadIdx.x + j * AB_THREADS < 3 * AB_BORDER ? m0s : face)[h.dst[j]] = r.halo[j];
}

// the register ring of a thread's own phi, g and mw_0: slot 0 at x - 1,
// 1 at x, 2 at x + 1 (clamped to the volume)
struct AdRing {
  float phi[3][3], g[3][3], mw0[3];
};

__device__ __forceinline__ void ring_push(AdRing& q, const AdPlane& r) {
#pragma unroll
  for (int s = 0; s < 2; ++s) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q.phi[s][c] = q.phi[s + 1][c];
      q.g[s][c] = q.g[s + 1][c];
    }
    q.mw0[s] = q.mw0[s + 1];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    q.phi[2][c] = r.own[c];
    q.g[2][c] = r.own[3 + c];
  }
  q.mw0[2] = r.own[6];
}

// One voxel (x, y, z) of the march at ring index k: d_mw to the scratch and
// d_phi.  d_mw rounds as the previous kernel and the plain version did
// (diff_central, then __fadd_rn / __fmul_rn in c order), so it is
// bit-equal to them; d_phi's weight-gradient sums use fmaf (within 1e-5 *
// (1 + max|ref|) of the plain version) and its divergence path rounds each
// product and sum on its own.
__device__ __forceinline__ void adstar_voxel(const AdRing& q, const float* sm, int k, int x,
                                             int y, int z, int X, int Y, int Z, int y0, int z0,
                                             float* __restrict__ dmw_out,
                                             float* __restrict__ dphi_out, int V) {
  const int p = (x * Y + y) * Z + z;
  const float* F = sm + face_slot(k);
  const int own = (y - y0 + 1) * AB_HZ + z - z0 + 1;
  // the clamped face neighbours' offsets in a staged plane, along y and z
  const int lo[3] = {0, y > 0 ? -AB_HZ : 0, z > 0 ? -1 : 0};
  const int hi[3] = {0, y < Y - 1 ? AB_HZ : 0, z < Z - 1 ? 1 : 0};

  // d_mw_a = sum_c (D_a phi_c + delta_ca) g_c, accumulated over c in order
  float dmw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float h = a == 0 ? q.phi[2][c] : F[c * AB_PLANE + own + hi[a]];
      const float l = a == 0 ? q.phi[0][c] : F[c * AB_PLANE + own + lo[a]];
      float j = __fmul_rn(0.5f, __fsub_rn(h, l));
      if (a == c) j = __fadd_rn(j, 1.0f);
      const float term = __fmul_rn(j, q.g[1][c]);
      acc = c == 0 ? term : __fadd_rn(acc, term);
    }
    dmw[a] = acc;
    dmw_out[(size_t)a * V + p] = acc;
  }

  // weight-gradient path on the 8 live taps (image m0, cotangent d_mw)
  const int pos[3] = {x, y, z}, len[3] = {X, Y, Z};
  float w[3][2], dw[3][2];
  int off[3][2];  // per axis and live offset: the tap's m0 slot, row or column
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = q.phi[1][a];
    const LivePair lp = live_pair(d);
    const AxisWeights sl = axis_dweights(d);
    w[a][0] = lp.wl;
    w[a][1] = lp.wh;
    dw[a][0] = lp.lo < 0 ? sl.m : sl.z;
    dw[a][1] = lp.lo < 0 ? sl.z : sl.p;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = clampi(pos[a] + lp.lo + i, len[a]);
      off[a][i] = a == 0 ? (t < x ? m0_slot(k - 1) : t == x ? m0_slot(k) : m0_slot(k + 1))
                : a == 1 ? (t - y0 + 1) * AB_HZ
                         : t - z0 + 1;
    }
  }
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        const float* m = sm + off[0][i] + off[1][j] + off[2][l];
        float t = __fmul_rn(dmw[0], m[0]);
        t = fmaf(dmw[1], m[AB_PLANE], t);
        t = fmaf(dmw[2], m[2 * AB_PLANE], t);
        acc[0] = fmaf(__fmul_rn(__fmul_rn(dw[0][i], w[1][j]), w[2][l]), t, acc[0]);
        acc[1] = fmaf(__fmul_rn(__fmul_rn(w[0][i], dw[1][j]), w[2][l]), t, acc[1]);
        acc[2] = fmaf(__fmul_rn(__fmul_rn(w[0][i], w[1][j]), dw[2][l]), t, acc[2]);
      }

  // divergence path: d_phi_c += sum_a D_a^T (mw_a * g_c), over a in order
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float div = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      float qm, q0, qp;
      if (a == 0) {
        qm = __fmul_rn(q.mw0[0], q.g[0][c]);
        q0 = __fmul_rn(q.mw0[1], q.g[1][c]);
        qp = __fmul_rn(q.mw0[2], q.g[2][c]);
      } else {
        const float* m = F + (5 + a) * AB_PLANE + own;  // mw_1 or mw_2
        const float* gc = F + (3 + c) * AB_PLANE + own;
        qm = __fmul_rn(m[lo[a]], gc[lo[a]]);
        q0 = __fmul_rn(m[0], q.g[1][c]);
        qp = __fmul_rn(m[hi[a]], gc[hi[a]]);
      }
      const float term = diff_central_adjoint(qm, q0, qp, pos[a], len[a]);
      div = a == 0 ? term : __fadd_rn(div, term);
    }
    dphi_out[(size_t)c * V + p] = __fadd_rn(acc[c], div);
  }
}

// The loads of plane x + 2 are issued before the arithmetic of plane x, so
// they are in flight while it runs (issued after it, the pass took 0.072
// ms more at 128^3 b4 on an H100)
__global__ void __launch_bounds__(AB_THREADS, 2)
    ad_star_bwd_first_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
                             const float* __restrict__ g, const float* __restrict__ mw,
                             float* __restrict__ d_mw, float* __restrict__ d_phi, int N,
                             int Nm, int X, int Y, int Z, int march) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z;
  const int nty = (Y + AB_TY - 1) / AB_TY, ntz = (Z + AB_TZ - 1) / AB_TZ;
  const int nxm = (X + march - 1) / march;
  int b = blockIdx.x;
  const int z0 = (b % ntz) * AB_TZ;
  b /= ntz;
  const int y0 = (b % nty) * AB_TY;
  b /= nty;
  const int x0 = (b % nxm) * march, n = b / nxm;
  const int x1 = x0 + march < X ? x0 + march : X;
  const int y = y0 + (int)threadIdx.x / AB_TZ, z = z0 + (int)threadIdx.x % AB_TZ;
  const float* ph = phiinv + (size_t)n * 3 * V;
  const float* gn = g + (size_t)n * 3 * V;
  const float* mwn = mw + (size_t)n * 3 * V;
  const float* mb = m0 + (Nm == 1 ? (size_t)0 : (size_t)n * 3 * V);
  float* dmw_out = d_mw + (size_t)n * 3 * V;
  float* dphi_out = d_phi + (size_t)n * 3 * V;

  // ring index k holds plane clamp(x0 - 1 + k): first x0 - 1, x0, x0 + 1
  AdHalo h;
  find_halo(h, AB_STAGED, [&](int c) { return staged_field(c, ph, gn, mwn, mb, V); },
            [](int c) { return c < 3 ? c : c - 3; }, Y, Z, y0, z0);
  AdPlane r;
  AdRing q;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    adstar_load(r, h, ph, gn, mwn, mb, V, clampi(x0 - 1 + k, X), Y, Z, y0, z0);
    adstar_store(r, h, smem, k);
    ring_push(q, r);
  }
  __syncthreads();
#pragma unroll 1
  for (int x = x0; x < x1; ++x) {
    const int k = x - x0 + 1;
    const bool more = x + 1 < x1;  // a next step, which needs plane x + 2
    const int next = x + 2 < X ? x + 2 : X - 1;
    if (more) adstar_load(r, h, ph, gn, mwn, mb, V, next, Y, Z, y0, z0);
    if (y < Y && z < Z) adstar_voxel(q, smem, k, x, y, z, X, Y, Z, y0, z0, dmw_out, dphi_out, V);
    if (more) {
      // plane x + 2 goes to slots that no thread reads in this step (m0's
      // of plane x - 2, the face channels' of plane x - 1)
      adstar_store(r, h, smem, k + 2);
      ring_push(q, r);
      __syncthreads();
    }
  }
}

// blocks of a marching kernel (K6's first pass, K2) at march length
// `march`: per subject, the march segments along x times the (y, z) tiles
static inline long march_blocks(int N, int X, int Y, int Z, int march) {
  return (long)N * ((X + march - 1) / march) * ((Y + AB_TY - 1) / AB_TY) *
         ((Z + AB_TZ - 1) / AB_TZ);
}

// the blocks of AB_THREADS threads and `smem` bytes of `kernel` that one SM
// holds at once, on the current device
template <class Kernel>
static int resident_blocks(std::atomic<int>* cache, Kernel kernel, size_t smem) {
  return per_device(cache, 1, [&](int, int* v) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(v, kernel, AB_THREADS, smem);
  });
}

// The march length of a kernel of which an SM holds `resident` blocks at
// once: the longest of 128, 64, 32, 16 and 8 planes whose grid still fills
// half of those places on every SM (at least one block an SM), or 8.  A
// longer march stages fewer planes twice (2 a march) and starts fewer
// prologues; a smaller grid leaves SMs short of warps to hide the loads'
// latency.  So chosen, K6's first pass (2 blocks an SM) and K2 (4) each
// take their fastest length of those timed at 128^3 and 64^3 b4 on an
// H100.
static int march_length(int N, int X, int Y, int Z, int resident) {
  static std::atomic<int> sms_of[kDevices];
  const int sms = per_device(sms_of, 132, [](int dev, int* v) {
    return cudaDeviceGetAttribute(v, cudaDevAttrMultiProcessorCount, dev);
  });
  const long want = (long)sms * (resident > 1 ? resident / 2 : 1);
  int march = 128;
  while (march > 8 && march_blocks(N, X, Y, Z, march) < want) march /= 2;
  return march;
}

// march <= 0: march_length's choice
cudaError_t launch_ad_star_bwd_first(const float* phiinv, const float* m0, const float* g,
                                     const float* mw, float* d_mw, float* d_phi, int N, int Nm,
                                     int X, int Y, int Z, int march, cudaStream_t stream) {
  static std::atomic<int> resident[kDevices];
  if (march <= 0)
    march = march_length(N, X, Y, Z, resident_blocks(resident, ad_star_bwd_first_kernel,
                                                     AB_SMEM * sizeof(float)));
  ad_star_bwd_first_kernel<<<(unsigned)march_blocks(N, X, Y, Z, march), AB_THREADS,
                             AB_SMEM * sizeof(float), stream>>>(
      phiinv, m0, g, mw, d_mw, d_phi, N, Nm, X, Y, Z, march);
  return cudaGetLastError();
}

// K2: a block owns one subject and a (y, z) tile of AB_TY x AB_TZ voxels
// (K6's first-pass tile), one thread per (y, z), and marches along x over
// `march` planes (march_length).  Each step of the march stages one new
// x-plane of phiinv's three channels and its one-voxel y/z halo in a ring
// of 4 shared-memory slots: the taps of plane x read planes x - 1 .. x + 1
// while plane x + 2 is written to the fourth slot, so one barrier a step
// suffices.  A thread reads its own v from device memory once (coalesced
// along z), one plane ahead, and forms s v with __fmul_rn.  It sums only
// the 8 live taps (stencil.cuh live_pair) from shared memory, in the
// 27-tap order, each weight rounded as (wx * wy) * wz and each product and
// sum on its own, so the skipped taps add exact zeros and the result is
// bit-equal to the 27-tap sum on finite inputs (as K4's is).  The flag is
// ANDed over the thread's march and voted once per warp at its end.
// Staging loads nothing outside the volume: every tap reads a clamped
// index, inside it.
constexpr int CP_SLOTS = 4;
constexpr int CP_SMEM = CP_SLOTS * 3 * AB_PLANE;  // floats
static_assert(3 * AB_BORDER <= AB_THREADS, "one halo item a thread");
static_assert(CP_SMEM * sizeof(float) <= 48 * 1024, "more needs the opt-in attribute");

// K2's halo item: one a thread, of phiinv's 3 channels
using CpHalo = Halo<1>;

// One x-plane's loads of one thread: its own voxel's phiinv 0-2 at plane
// xp and v 0-2 at plane xv (none when xv < 0), and its halo item; zeros
// outside the volume
struct CpPlane {
  float phi[3], v[3], halo;
};

__device__ __forceinline__ void compose_load(CpPlane& r, const CpHalo& h,
                                             const float* __restrict__ ph,
                                             const float* __restrict__ vn, int V, int xp, int xv,
                                             int YZ, int yz, bool in) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.phi[c] = in ? __ldg(ph + (size_t)c * V + xp * YZ + yz) : 0.0f;
    r.v[c] = in && xv >= 0 ? __ldg(vn + (size_t)c * V + xv * YZ + yz) : 0.0f;
  }
  r.halo = h.src[0] ? __ldg(h.src[0] + xp * YZ) : 0.0f;
}

// the staged plane of ring index k: its slot in shared memory
__device__ __forceinline__ int cp_slot(int k) { return (k & (CP_SLOTS - 1)) * 3 * AB_PLANE; }

__device__ __forceinline__ void compose_store(const CpPlane& r, const CpHalo& h, float* sm,
                                              int k) {
  float* slot = sm + cp_slot(k);
  const int own = ((int)threadIdx.x / AB_TZ + 1) * AB_HZ + (int)threadIdx.x % AB_TZ + 1;
#pragma unroll
  for (int c = 0; c < 3; ++c) slot[c * AB_PLANE + own] = r.phi[c];
  if (h.dst[0] >= 0) slot[h.dst[0]] = r.halo;
}

// One voxel (x, y, z) of the march at ring index k, from its v: out and
// its unit-regime test
__device__ __forceinline__ bool compose_voxel(const float* sm, int k, const float* vv, float s,
                                              int x, int y, int z, int X, int Y, int Z, int y0,
                                              int z0, float* __restrict__ o, int V) {
  float d[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) d[a] = __fmul_rn(s, vv[a]);
  const int pos[3] = {x, y, z}, len[3] = {X, Y, Z};
  float w[3][2];
  int off[3][2];  // per axis and live offset: the tap's slot, row or column
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const LivePair lp = live_pair(d[a]);
    w[a][0] = lp.wl;
    w[a][1] = lp.wh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = clampi(pos[a] + lp.lo + i, len[a]);
      off[a][i] = a == 0 ? cp_slot(k + t - x)  // t - x in {-1, 0, 1}
                : a == 1 ? (t - y0 + 1) * AB_HZ
                         : t - z0 + 1;
    }
  }
  float wt[8];
  int at[8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        wt[(i * 2 + j) * 2 + l] = __fmul_rn(__fmul_rn(w[0][i], w[1][j]), w[2][l]);
        at[(i * 2 + j) * 2 + l] = off[0][i] + off[1][j] + off[2][l];
      }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* f = sm + c * AB_PLANE;
    float acc = __fmul_rn(wt[0], f[at[0]]);
#pragma unroll
    for (int q = 1; q < 8; ++q) acc = __fadd_rn(acc, __fmul_rn(wt[q], f[at[q]]));
    o[(size_t)c * V] = __fadd_rn(d[c], acc);
  }
  return in_unit(d[0]) && in_unit(d[1]) && in_unit(d[2]);
}

// The loads of plane x + 2 (and of v at x + 1) are issued before the
// arithmetic of plane x (issued after it: 0.142 against 0.126 ms at 128^3
// b4 on an H100)
__global__ void __launch_bounds__(AB_THREADS)
    compose_fwd_kernel(const float* __restrict__ phiinv, const float* __restrict__ v, float s,
                       float* __restrict__ out, int* flag, int N, int X, int Y, int Z,
                       int march) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z, YZ = Y * Z;
  const int nty = (Y + AB_TY - 1) / AB_TY, ntz = (Z + AB_TZ - 1) / AB_TZ;
  const int nxm = (X + march - 1) / march;
  int b = blockIdx.x;
  const int z0 = (b % ntz) * AB_TZ;
  b /= ntz;
  const int y0 = (b % nty) * AB_TY;
  b /= nty;
  const int x0 = (b % nxm) * march, n = b / nxm;
  const int x1 = x0 + march < X ? x0 + march : X;
  const int y = y0 + (int)threadIdx.x / AB_TZ, z = z0 + (int)threadIdx.x % AB_TZ;
  const bool in = y < Y && z < Z;
  const int yz = y * Z + z;
  const float* ph = phiinv + (size_t)n * 3 * V;
  const float* vn = v + (size_t)n * 3 * V;
  float* on = out + (size_t)n * 3 * V;

  // ring index k holds plane clamp(x0 - 1 + k): first x0 - 1, x0, x0 + 1;
  // the thread's v at x0 comes with the last of them
  CpHalo h;
  find_halo(h, 3, [&](int c) { return ph + (size_t)c * V; }, [](int c) { return c; }, Y, Z, y0,
            z0);
  CpPlane r;
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    compose_load(r, h, ph, vn, V, clampi(x0 - 1 + k, X), k == 2 ? x0 : -1, YZ, yz, in);
    compose_store(r, h, smem, k);
  }
  float vv[3] = {r.v[0], r.v[1], r.v[2]};
  __syncthreads();
  bool ok = true;
#pragma unroll 1
  for (int x = x0; x < x1; ++x) {
    const int k = x - x0 + 1;
    const bool more = x + 1 < x1;  // a next step, which needs plane x + 2 and v at x + 1
    const int next = x + 2 < X ? x + 2 : X - 1;
    if (more) compose_load(r, h, ph, vn, V, next, x + 1, YZ, yz, in);
    if (in) ok &= compose_voxel(smem, k, vv, s, x, y, z, X, Y, Z, y0, z0, on + x * YZ + yz, V);
    if (more) {
      // plane x + 2 goes to the slot of plane x - 2, which no thread reads
      // in this step
      compose_store(r, h, smem, k + 2);
#pragma unroll
      for (int c = 0; c < 3; ++c) vv[c] = r.v[c];
      __syncthreads();
    }
  }
  clear_flag_if(!ok, flag);
}

// march <= 0: march_length's choice
cudaError_t launch_compose_fwd(const float* phiinv, const float* v, float s, float* out,
                               int* flag, int N, int X, int Y, int Z, int march,
                               cudaStream_t stream) {
  static std::atomic<int> resident[kDevices];
  if (march <= 0)
    march = march_length(N, X, Y, Z, resident_blocks(resident, compose_fwd_kernel,
                                                     CP_SMEM * sizeof(float)));
  compose_fwd_kernel<<<(unsigned)march_blocks(N, X, Y, Z, march), AB_THREADS,
                       CP_SMEM * sizeof(float), stream>>>(phiinv, v, s, out, flag, N, X, Y, Z,
                                                          march);
  return cudaGetLastError();
}

// K1: a block owns one subject and a (y, z) tile of AB_TY x AB_TZ voxels
// (K6's first-pass tile), one thread per (y, z), and marches along x over
// `march` planes (march_length).  Each step of the march stages one new
// x-plane and its one-voxel y/z halo in shared memory, in rings: m0's three
// channels in 4 slots (the taps of plane x read planes x - 1 .. x + 1 while
// plane x + 2 is written), phiinv's three in 3 (the Jacobian's y and z face
// neighbours come from plane x; plane x + 1 waits, plane x + 2 is
// written), so one barrier a step suffices.  A thread's own phiinv at
// x - 1, x and x + 1 is a register ring: it gives the weights, the
// Jacobian's x neighbours and the flag.  The loads of plane x + 2 are
// issued before plane x's arithmetic.  mw sums the 8 live taps (stencil.cuh
// live_pair) from shared memory in the 27-tap order, each weight rounded as
// (wx * wy) * wz and each product and sum on its own, so the skipped taps
// add exact zeros and mw is bit-equal to the 27-tap sum on finite inputs;
// the Jacobian rounds as the clamped central difference of the plain
// version (0.5 * (hi - lo), + 1 on the diagonal, products and sums in a
// order), so out is bit-equal too.  out (and mw, when its pointer is not
// null) is stored coalesced along z.  The flag is ANDed over the thread's
// march and voted once per warp at its end.  Staging loads nothing outside
// the volume: every read of a staged plane is at a clamped index, inside it.
// It is held at 4 blocks of 256 threads an SM (64 registers, no spill):
// left to take 78 registers, an SM holds 3 of its blocks, and it ran slower
// on an H100 (PERF.md).
constexpr int AS_SMEM = (4 + 3) * 3 * AB_PLANE;  // floats: m0's 4 slots, then phiinv's 3
// the halo's (channel, position) loads, spread over the block's threads
constexpr int AS_HALO = (6 * AB_BORDER + AB_THREADS - 1) / AB_THREADS;
static_assert(AS_SMEM * sizeof(float) <= 48 * 1024, "more needs the opt-in attribute");

// the staged planes of ring index k: the offsets of its m0 slot and its
// phiinv slot in shared memory
__device__ __forceinline__ int as_m0_slot(int k) { return (k & 3) * 3 * AB_PLANE; }
__device__ __forceinline__ int as_phi_slot(int k) { return (12 + (k % 3) * 3) * AB_PLANE; }

// K1's halo items, of m0 0-2 and phiinv 3-5 (item i is of m0 when
// i < 3 * AB_BORDER)
using AsHalo = Halo<AS_HALO>;

// One x-plane's loads of one thread: its own voxel's phiinv and m0, and its
// halo items; zeros outside the volume
struct AsPlane {
  float phi[3], m0[3], halo[AS_HALO];
};

__device__ __forceinline__ void ad_star_load(AsPlane& r, const AsHalo& h,
                                             const float* __restrict__ ph,
                                             const float* __restrict__ mb, int V, int xp, int YZ,
                                             int yz, bool in) {
  const int u = xp * YZ + yz;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r.phi[c] = in ? __ldg(ph + (size_t)c * V + u) : 0.0f;
    r.m0[c] = in ? __ldg(mb + (size_t)c * V + u) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < AS_HALO; ++j) r.halo[j] = h.src[j] ? __ldg(h.src[j] + xp * YZ) : 0.0f;
}

// plane r to the slots of ring index k, and its own phiinv into the
// register ring q (slot 0 at x - 1, 1 at x, 2 at x + 1)
__device__ __forceinline__ void ad_star_store(const AsPlane& r, const AsHalo& h, float* sm, int k,
                                              float (&q)[3][3]) {
  float* m0s = sm + as_m0_slot(k);
  float* phs = sm + as_phi_slot(k);
  const int own = ((int)threadIdx.x / AB_TZ + 1) * AB_HZ + (int)threadIdx.x % AB_TZ + 1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    m0s[c * AB_PLANE + own] = r.m0[c];
    phs[c * AB_PLANE + own] = r.phi[c];
    q[0][c] = q[1][c];
    q[1][c] = q[2][c];
    q[2][c] = r.phi[c];
  }
#pragma unroll
  for (int j = 0; j < AS_HALO; ++j)
    if (h.dst[j] >= 0)
      (threadIdx.x + j * AB_THREADS < 3 * AB_BORDER ? m0s : phs)[h.dst[j]] = r.halo[j];
}

// One voxel (x, y, z) of the march at ring index k: out (and mw when `w`
// is not null) at `o` (`w`), and its unit-regime test
__device__ __forceinline__ bool ad_star_voxel(const float (&q)[3][3], const float* sm, int k,
                                              int x, int y, int z, int X, int Y, int Z, int y0,
                                              int z0, float* __restrict__ o,
                                              float* __restrict__ w, int V) {
  const int pos[3] = {x, y, z}, len[3] = {X, Y, Z};
  float wl[3][2];
  int off[3][2];  // per axis and live offset: the tap's m0 slot, row or column
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const LivePair lp = live_pair(q[1][a]);
    wl[a][0] = lp.wl;
    wl[a][1] = lp.wh;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int t = clampi(pos[a] + lp.lo + i, len[a]);
      off[a][i] = a == 0 ? as_m0_slot(k + t - x)  // t - x in {-1, 0, 1}
                : a == 1 ? (t - y0 + 1) * AB_HZ
                         : t - z0 + 1;
    }
  }
  float wt[8];
  int at[8];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int l = 0; l < 2; ++l) {
        wt[(i * 2 + j) * 2 + l] = __fmul_rn(__fmul_rn(wl[0][i], wl[1][j]), wl[2][l]);
        at[(i * 2 + j) * 2 + l] = off[0][i] + off[1][j] + off[2][l];
      }
  float mw[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float* f = sm + c * AB_PLANE;
    float acc = __fmul_rn(wt[0], f[at[0]]);
#pragma unroll
    for (int t = 1; t < 8; ++t) acc = __fadd_rn(acc, __fmul_rn(wt[t], f[at[t]]));
    mw[c] = acc;
    if (w != nullptr) w[(size_t)c * V] = acc;
  }

  // out_c = sum_a (D_a phiinv_c [+1 if a == c]) * mw_a, accumulated over a in
  // order; the y and z neighbours (clamped) from the staged plane x
  const float* F = sm + as_phi_slot(k);
  const int own = (y - y0 + 1) * AB_HZ + z - z0 + 1;
  const int lo[3] = {0, y > 0 ? -AB_HZ : 0, z > 0 ? -1 : 0};
  const int hi[3] = {0, y < Y - 1 ? AB_HZ : 0, z < Z - 1 ? 1 : 0};
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float acc = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float h = a == 0 ? q[2][c] : F[c * AB_PLANE + own + hi[a]];
      const float l = a == 0 ? q[0][c] : F[c * AB_PLANE + own + lo[a]];
      float g = __fmul_rn(0.5f, __fsub_rn(h, l));
      if (a == c) g = __fadd_rn(g, 1.0f);
      const float term = __fmul_rn(g, mw[a]);
      acc = a == 0 ? term : __fadd_rn(acc, term);
    }
    o[(size_t)c * V] = acc;
  }
  return in_unit(q[1][0]) && in_unit(q[1][1]) && in_unit(q[1][2]);
}

// The loads of plane x + 2 are issued before the arithmetic of plane x
// (issued after it: 0.199 against 0.171 ms at 128^3 b4 on an H100)
__global__ void __launch_bounds__(AB_THREADS, 4)
    ad_star_fwd_kernel(const float* __restrict__ phiinv, const float* __restrict__ m0,
                       float* __restrict__ out, float* __restrict__ mw_out, int* flag, int N,
                       int Nm, int X, int Y, int Z, int march) {
  extern __shared__ __align__(16) float smem[];
  const int V = X * Y * Z, YZ = Y * Z;
  const int nty = (Y + AB_TY - 1) / AB_TY, ntz = (Z + AB_TZ - 1) / AB_TZ;
  const int nxm = (X + march - 1) / march;
  int b = blockIdx.x;
  const int z0 = (b % ntz) * AB_TZ;
  b /= ntz;
  const int y0 = (b % nty) * AB_TY;
  b /= nty;
  const int x0 = (b % nxm) * march, n = b / nxm;
  const int x1 = x0 + march < X ? x0 + march : X;
  const int y = y0 + (int)threadIdx.x / AB_TZ, z = z0 + (int)threadIdx.x % AB_TZ;
  const bool in = y < Y && z < Z;
  const int yz = y * Z + z;
  const float* ph = phiinv + (size_t)n * 3 * V;
  const float* mb = m0 + (Nm == 1 ? (size_t)0 : (size_t)n * 3 * V);
  float* on = out + (size_t)n * 3 * V;
  float* wn = mw_out == nullptr ? nullptr : mw_out + (size_t)n * 3 * V;

  // ring index k holds plane clamp(x0 - 1 + k): first x0 - 1, x0, x0 + 1
  AsHalo h;
  find_halo(h, 6, [&](int c) { return c < 3 ? mb + (size_t)c * V : ph + (size_t)(c - 3) * V; },
            [](int c) { return c % 3; }, Y, Z, y0, z0);
  AsPlane r;
  float q[3][3] = {};
#pragma unroll 1
  for (int k = 0; k < 3; ++k) {
    ad_star_load(r, h, ph, mb, V, clampi(x0 - 1 + k, X), YZ, yz, in);
    ad_star_store(r, h, smem, k, q);
  }
  __syncthreads();
  bool ok = true;
#pragma unroll 1
  for (int x = x0; x < x1; ++x) {
    const int k = x - x0 + 1;
    const bool more = x + 1 < x1;  // a next step, which needs plane x + 2
    const int next = x + 2 < X ? x + 2 : X - 1;
    if (more) ad_star_load(r, h, ph, mb, V, next, YZ, yz, in);
    if (in)
      ok &= ad_star_voxel(q, smem, k, x, y, z, X, Y, Z, y0, z0, on + x * YZ + yz,
                          wn == nullptr ? nullptr : wn + x * YZ + yz, V);
    if (more) {
      // plane x + 2 goes to slots that no thread reads in this step (m0's
      // of plane x - 2, phiinv's of plane x - 1)
      ad_star_store(r, h, smem, k + 2, q);
      __syncthreads();
    }
  }
  clear_flag_if(!ok, flag);
}

// march <= 0: march_length's choice
cudaError_t launch_ad_star_fwd(const float* phiinv, const float* m0, float* out, float* mw,
                               int* flag, int N, int Nm, int X, int Y, int Z, int march,
                               cudaStream_t stream) {
  static std::atomic<int> resident[kDevices];
  if (march <= 0)
    march = march_length(N, X, Y, Z, resident_blocks(resident, ad_star_fwd_kernel,
                                                     AS_SMEM * sizeof(float)));
  ad_star_fwd_kernel<<<(unsigned)march_blocks(N, X, Y, Z, march), AB_THREADS,
                       AS_SMEM * sizeof(float), stream>>>(phiinv, m0, out, mw, flag, N, Nm, X,
                                                          Y, Z, march);
  return cudaGetLastError();
}

}  // namespace lagomorph

// K1, marching over `march` planes (<= 0: the length K1 takes); mw may be
// null (the forward-only call writes none)
extern "C" int lagomorph_ad_star_fwd(const float* phiinv, const float* m0, float* out, float* mw,
                                     int* flag, int N, int Nm, int X, int Y, int Z, int march,
                                     void* stream) {
  return (int)lagomorph::launch_ad_star_fwd(phiinv, m0, out, mw, flag, N, Nm, X, Y, Z, march,
                                            (cudaStream_t)stream);
}

extern "C" int lagomorph_ad_star_bwd(const float* phiinv, const float* m0,
                                     const float* g, const float* mw,
                                     float* d_mw, float* d_phiinv, float* d_m0,
                                     int N, int Nm, int X, int Y, int Z,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = lagomorph::launch_ad_star_bwd_first(phiinv, m0, g, mw, d_mw,
                                                               d_phiinv, N, Nm, X, Y, Z, 0, st);
  if (err != cudaSuccess) return (int)err;
  return (int)lagomorph::launch_warp_bwd(nullptr, phiinv, 1.0f, d_mw, d_m0, nullptr, N, Nm, 3,
                                         X, Y, Z, false, st);
}

// K6's first pass alone (d_mw and d_phiinv), for timing it and testing it,
// marching over `march` planes (<= 0: the length K6 takes)
extern "C" int lagomorph_ad_star_bwd_first(const float* phiinv, const float* m0,
                                           const float* g, const float* mw, float* d_mw,
                                           float* d_phiinv, int N, int Nm, int X, int Y,
                                           int Z, int march, void* stream) {
  return (int)lagomorph::launch_ad_star_bwd_first(phiinv, m0, g, mw, d_mw, d_phiinv, N, Nm, X,
                                                  Y, Z, march, (cudaStream_t)stream);
}

extern "C" int lagomorph_compose_bwd(const float* phiinv, const float* v,
                                     float s, const float* g, float* d_phiinv,
                                     float* d_v, int N, int X, int Y, int Z,
                                     void* stream) {
  return (int)lagomorph::launch_warp_bwd(phiinv, v, s, g, d_phiinv, d_v, N, N, 3, X, Y, Z, true,
                                         (cudaStream_t)stream);
}

// K2, marching over `march` planes (<= 0: the length K2 takes)
extern "C" int lagomorph_compose_fwd(const float* phiinv, const float* v, float s, float* out,
                                     int* flag, int N, int X, int Y, int Z, int march,
                                     void* stream) {
  return (int)lagomorph::launch_compose_fwd(phiinv, v, s, out, flag, N, X, Y, Z, march,
                                            (cudaStream_t)stream);
}
