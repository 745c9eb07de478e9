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
// writes mw, which K12 reads.
//
// K11, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff2d.py `_compose2d_fwd_kernel` (`compose2d_pallas`,
// pallas_call at :456).
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
// Design.  K10, K11 and K13, and K12 for a batch-1 m0: one thread per
// pixel over (N, H, W), W fastest across the warp, no shared memory.  K12
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
// NULL; flag: one int32 set to 1 by the caller
extern "C" int lagomorph_ad_star2d_fwd(const float* phiinv, const float* m0, float* out,
                                       float* mw, int* flag, int N, int Nm, int H, int W,
                                       void* stream) {
  lagomorph::ad_star2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, m0, out, mw, flag, N, Nm,
                                                            H, W);
  return (int)cudaGetLastError();
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

extern "C" int lagomorph_compose2d_fwd(const float* phiinv, const float* v, float s, float* out,
                                       int* flag, int N, int H, int W, void* stream) {
  lagomorph::compose2d_fwd_kernel<<<grid_for((long)N * H * W), kThreads, 0,
                                    (cudaStream_t)stream>>>(phiinv, v, s, out, flag, N, H, W);
  return (int)cudaGetLastError();
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
