// K17 and K18: the 2D unit-regime warp, forward and backward.  The atlas
// loss warps the batch-1 atlas by every subject's inverse deformation; the
// 2D vector-field warps of the general tiers (`adjrep.Ad_star`,
// `deform.compose_disp_vel` in their unit regime) take the same path.
//
// K17, the forward:
//   out[n,c](p) = sum_{o in {-1,0,1}^2} (wx_o0 * wy_o1)(d[n](p)) * I[n or 0, c](clamp(p + o))
// with the per-axis weights of ops/sampling.py sample_displacement_unit
// (floor/frac of d, floor -1 and 0 only).  One thread a pixel, a block a
// tile of 8 rows by 32 columns of one subject (columns across the warp, so
// the displacement's loads and the stores coalesce); the taps of I hit
// L1/L2 (the 512^2 atlas is 1 MB, read with batch stride 0).  Only the 4
// taps floor(d) selects can weigh anything (stencil2d.cuh live_lo); the
// thread sums those (`s2d::warp_live`, the arithmetic K8, K10 and K11 run:
// each product and sum rounded on its own, in the 9-tap order), and the
// terms it skips are exact zeros, so the result is bit-equal to the plain
// version on finite inputs.
//
// K18, the backward (cotangent g of out), in one pass:
//   dI[v]     = sum_{(u,o): clamp(u+o) = v} w_o(d(u)) * g(u)        (transpose)
//   d_disp[a] = sum_o dw_a(o_a) w_b(o_b) sum_c g_c I_c[clamp(p + o)]  (weight gradient)
// The transpose is taken in gather form: the 3 sources (u, o) per axis
// whose clamped tap lands on v (stencil2d.cuh transposed_tap, the faces'
// clamp folds included).  For a batch-1 I it is summed over the subjects,
// each subject's sum added in subject order inside the thread: no atomics,
// two launches agree bit for bit, and the result is the float32 sum in
// subject order of what a batch-N I gives each subject.
//
// Design of K18.  A block owns the same tile of 8 x 32 pixels, one thread a
// pixel, and one output batch index of dI: for a batch-1 I it marches over
// every subject, for a batch-N I it takes one.  Per subject it stages the
// tile and its one-pixel halo (10 x 34 pixels): each staged pixel's 6 axis
// weights (computed once, `s2d::weights`) and its cotangent, up to 2
// channels a launch, in shared memory; a thread stages its own pixel and
// threads 0-83 the halo, so every input is read from device memory once
// (the halo from L2).  The next subject's displacement and cotangent are
// loaded into registers before the current subject's arithmetic.  Each
// thread then takes its pixel's transpose from the 9 staged sources (two
// weights and a product a source, in stencil2d.cuh warp_transpose's order)
// and its weight gradient from its own displacement and cotangent and the
// 4 live taps of I (slopes `s2d::slopes`, in weight_grad_w's order).  An I
// of more than 2 channels takes a launch a pair of channels, the later ones
// adding their weight gradient to d_disp.
//
// Bound on the H100 at 512^2 b50 (3.35 TB/s; portbench/work/warp2d_*.py):
// K17 reads d and the atlas and writes out, 158 MB, 47 us; K18 reads d, g
// and the atlas and writes d_disp and dI, 264 MB, 79 us.
#include <cuda_runtime.h>

#include "stencil2d.cuh"

namespace lagomorph {
namespace {

constexpr int kTX = 32, kTY = 8, kThreads = kTX * kTY;  // a tile: 8 rows of 32 columns
constexpr int kSX = kTX + 2, kSY = kTY + 2;              // staged with a one-pixel halo
constexpr int kStaged = kSX * kSY;                       // 340
constexpr int kHalo = kStaged - kThreads;                // 84: threads 0-83 stage it
constexpr int kPair = 2;                                 // K18's channels a launch
constexpr int kFwdSubjects = 4;                          // K17's subjects a thread

// a block's tile: its first row and column and its group (K17: its
// kFwdSubjects subjects; K18: dI's batch index)
struct Tile {
  int i0, j0, group;
};

__device__ __forceinline__ Tile tile_of(int H, int W) {
  const int tiles_x = (W + kTX - 1) / kTX, tiles_y = (H + kTY - 1) / kTY;
  int b = blockIdx.x;
  const int bx = b % tiles_x;
  b /= tiles_x;
  return Tile{(b % tiles_y) * kTY, bx * kTX, b / tiles_y};
}

__global__ void __launch_bounds__(kThreads)
warp2d_fwd_kernel(const float* __restrict__ I, const float* __restrict__ disp,
                  float* __restrict__ out, int N, int NI, int C, int H, int W) {
  const Tile t = tile_of(H, W);
  const int i = t.i0 + threadIdx.x / kTX, j = t.j0 + threadIdx.x % kTX;
  if (i >= H || j >= W) return;
  const long HW = (long)H * W, p = (long)i * W + j;
  const int n0 = t.group * kFwdSubjects;
  const int k1 = N - n0 < kFwdSubjects ? N - n0 : kFwdSubjects;
  float d0[kFwdSubjects], d1[kFwdSubjects];
#pragma unroll
  for (int k = 0; k < kFwdSubjects; ++k) {  // every subject's loads in flight at once
    if (k >= k1) break;
    const float* d = disp + (long)(n0 + k) * 2 * HW;
    d0[k] = d[p];
    d1[k] = d[HW + p];
  }
#pragma unroll
  for (int k = 0; k < kFwdSubjects; ++k) {
    if (k >= k1) break;
    const int n = n0 + k;
    const s2d::W3 wx = s2d::weights(d0[k]), wy = s2d::weights(d1[k]);
    const int lx = s2d::live_lo(d0[k]), ly = s2d::live_lo(d1[k]);
    const float* src = I + (NI == 1 ? 0 : (long)n * C * HW);
    float* o = out + (long)n * C * HW;
    for (int c = 0; c < C; ++c)
      o[c * HW + p] = s2d::warp_live(src + c * HW, wx, wy, lx, ly, H, W, i, j);
  }
}

// the staged slot (row, column) of halo pixel e (0 <= e < kHalo): the rows
// above and below the tile, then the columns left and right of it
__device__ __forceinline__ int halo_slot(int e) {
  if (e < kSX) return e;
  if (e < 2 * kSX) return (kSY - 1) * kSX + e - kSX;
  if (e < 2 * kSX + kTY) return (e - 2 * kSX + 1) * kSX;
  return (e - 2 * kSX - kTY + 1) * kSX + kSX - 1;
}

// One staged pixel's displacement and up to kPair cotangent channels, read
// from device memory (valid false: outside the image)
template <int CC>
struct Pixel {
  float d0, d1, g[CC];
  bool valid;
};

template <int CC>
__device__ __forceinline__ void load(Pixel<CC>& x, const float* __restrict__ disp,
                                     const float* __restrict__ g, int n, int C, int c0, long HW,
                                     long q) {
  if (!x.valid) return;
  const float* d = disp + (long)n * 2 * HW;
  x.d0 = d[q];
  x.d1 = d[HW + q];
  const float* gs = g + ((long)n * C + c0) * HW;
  for (int c = 0; c < CC; ++c) x.g[c] = gs[c * HW + q];
}

// its 6 axis weights (planes wx_-1, wx_0, wx_+1, wy_-1, wy_0, wy_+1 of sw)
// and its cotangent (the CC planes of sg) into staged slot s
template <int CC>
__device__ __forceinline__ void stage(const Pixel<CC>& x, float* sw, float* sg, int s) {
  if (!x.valid) return;
  const s2d::W3 wx = s2d::weights(x.d0), wy = s2d::weights(x.d1);
  sw[s] = wx.m;
  sw[kStaged + s] = wx.z;
  sw[2 * kStaged + s] = wx.p;
  sw[3 * kStaged + s] = wy.m;
  sw[4 * kStaged + s] = wy.z;
  sw[5 * kStaged + s] = wy.p;
  for (int c = 0; c < CC; ++c) sg[c * kStaged + s] = x.g[c];
}

// One axis of a displacement d on its live taps, the offsets lo and lo + 1
// (`s2d::live_lo`): their weights, which `s2d::weights` gives as (1 - t, t)
// with t = d - floor(d) wherever floor(d) is -1 or 0 and as zeros
// elsewhere, and the magnitude of their slopes (`s2d::slopes`: -1 at lo and
// +1 at lo + 1 in the regime, zeros elsewhere)
struct LiveAxis {
  float w0, w1, slope;
  int lo;
};

__device__ __forceinline__ LiveAxis live_axis(float d) {
  const float f = floorf(d);
  const float t = s2d::sub(d, f);
  const bool live = f == -1.0f || f == 0.0f;
  return LiveAxis{live ? s2d::sub(1.0f, t) : 0.0f, live ? t : 0.0f, live ? 1.0f : 0.0f,
                  f == -1.0f ? -1 : 0};
}

// The gather form of the transpose at pixel (i, j), staged at slot s0,
// over its 9 sources (`s2d::warp_transpose`'s order and rounding): source u
// = v - o for tap offset o = k - 1 on each axis, folded on the image's
// edges (EDGE) by `s2d::transposed_tap`; elsewhere every source lies at a
// fixed offset from s0
template <int CC, bool EDGE>
__device__ __forceinline__ void transpose_at(const float* sw, const float* sg, int s0, int i,
                                             int j, int H, int W, float tr[CC]) {
  for (int c = 0; c < CC; ++c) tr[c] = 0.0f;
#pragma unroll
  for (int kx = 0; kx < 3; ++kx) {
    int ux = i + 1 - kx, ox = kx - 1;
    if (EDGE) s2d::transposed_tap(i, H, kx, ux, ox);
#pragma unroll
    for (int ky = 0; ky < 3; ++ky) {
      int uy = j + 1 - ky, oy = ky - 1;
      if (EDGE) s2d::transposed_tap(j, W, ky, uy, oy);
      const int s = s0 + (ux - i) * kSX + uy - j;
      const float w = s2d::mul(sw[(ox + 1) * kStaged + s], sw[(oy + 4) * kStaged + s]);
      for (int c = 0; c < CC; ++c) tr[c] = s2d::add(tr[c], s2d::mul(w, sg[c * kStaged + s]));
    }
  }
}

// K18 on channels c0 .. c0 + CC - 1 of C; accumulate: add the weight
// gradient to d_disp (the launches after a pair's first)
template <int CC>
__global__ void __launch_bounds__(kThreads)
warp2d_bwd_kernel(const float* __restrict__ I, const float* __restrict__ disp,
                  const float* __restrict__ g, float* __restrict__ dI,
                  float* __restrict__ dd, int N, int NI, int C, int c0, int H, int W,
                  int accumulate) {
  // two stages of (6 + CC) planes (weights, cotangent), then I's CC planes
  extern __shared__ __align__(16) float k18_smem[];
  float* const sI = k18_smem + 2 * (6 + CC) * kStaged;
  const Tile t = tile_of(H, W);
  const long HW = (long)H * W;
  const int ty = threadIdx.x / kTX, tx = threadIdx.x % kTX;
  const int i = t.i0 + ty, j = t.j0 + tx;
  const int own_s = (ty + 1) * kSX + tx + 1;
  const long p = (long)i * W + j;
  // the halo pixel this thread stages, if any
  const int halo_s = threadIdx.x < kHalo ? halo_slot(threadIdx.x) : 0;
  const int hi = t.i0 - 1 + halo_s / kSX, hj = t.j0 - 1 + halo_s % kSX;
  const long hq = (long)hi * W + hj;
  Pixel<CC> own{}, halo{};
  own.valid = i < H && j < W;
  halo.valid = threadIdx.x < kHalo && hi >= 0 && hi < H && hj >= 0 && hj < W;
  // a batch-1 I: every subject into dI[0]; a batch-N I: subject `group`
  const int n0 = NI == 1 ? 0 : t.group, n1 = NI == 1 ? N : t.group + 1;
  // I of the block's image (the same for all its subjects) at every staged
  // slot, clamped to the image, so that a tap clamp(p + o) of a pixel of the
  // tile is its slot's neighbour
  const float* Ig = I + ((long)t.group * C + c0) * HW;
  for (int e = threadIdx.x; e < kStaged; e += kThreads) {
    const long q = (long)s2d::clampi(t.i0 - 1 + e / kSX, H) * W + s2d::clampi(t.j0 - 1 + e % kSX, W);
    for (int c = 0; c < CC; ++c) sI[c * kStaged + e] = Ig[c * HW + q];
  }
  load(own, disp, g, n0, C, c0, HW, p);
  load(halo, disp, g, n0, C, c0, HW, hq);
  float acc[CC];
  for (int c = 0; c < CC; ++c) acc[c] = 0.0f;
  for (int n = n0; n < n1; ++n) {
    // subjects alternate between two stages: the one written here was last
    // read in the arithmetic before the previous barrier
    float* sw = k18_smem + (n - n0) % 2 * (6 + CC) * kStaged;
    float* sg = sw + 6 * kStaged;
    stage(own, sw, sg, own_s);
    stage(halo, sw, sg, halo_s);
    const Pixel<CC> cur = own;
    if (n + 1 < n1) {  // the next subject's inputs, in flight during the arithmetic
      load(own, disp, g, n + 1, C, c0, HW, p);
      load(halo, disp, g, n + 1, C, c0, HW, hq);
    }
    __syncthreads();
    if (!cur.valid) continue;
    // the transpose at (i, j) from the 9 staged sources (the image's edges
    // fold taps, the inner pixels take fixed offsets)
    float tr[CC];
    if (i > 0 && i < H - 1 && j > 0 && j < W - 1)
      transpose_at<CC, false>(sw, sg, own_s, i, j, H, W, tr);
    else
      transpose_at<CC, true>(sw, sg, own_s, i, j, H, W, tr);
    for (int c = 0; c < CC; ++c) acc[c] = n == n0 ? tr[c] : s2d::add(acc[c], tr[c]);
    // the weight gradient at (i, j) over the 4 live taps of I, in
    // `s2d::weight_grad_w`'s order and rounding (a slope of +-1 or 0 times
    // a weight is exact)
    const LiveAxis x = live_axis(cur.d0), y = live_axis(cur.d1);
    const float* tap = sI + own_s + x.lo * kSX + y.lo;
    float a0 = 0.0f, a1 = 0.0f;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        float gI = s2d::mul(cur.g[0], tap[a * kSX + b]);
        for (int c = 1; c < CC; ++c)
          gI = s2d::add(gI, s2d::mul(cur.g[c], tap[c * kStaged + a * kSX + b]));
        const float sx = a == 0 ? -x.slope : x.slope, wy = b == 0 ? y.w0 : y.w1;
        const float wx = a == 0 ? x.w0 : x.w1, sy = b == 0 ? -y.slope : y.slope;
        a0 = s2d::add(a0, s2d::mul(s2d::mul(sx, wy), gI));
        a1 = s2d::add(a1, s2d::mul(s2d::mul(wx, sy), gI));
      }
    }
    float* o = dd + (long)n * 2 * HW + p;
    o[0] = accumulate ? s2d::add(o[0], a0) : a0;
    o[HW] = accumulate ? s2d::add(o[HW], a1) : a1;
  }
  if (own.valid) {
    float* o = dI + ((long)t.group * C + c0) * HW + p;
    for (int c = 0; c < CC; ++c) o[c * HW] = acc[c];
  }
}

// the blocks of a launch over `groups` of the (H, W) tiles
long blocks_for(long groups, int H, int W) {
  return groups * ((H + kTY - 1) / kTY) * ((W + kTX - 1) / kTX);
}

// K18's shared memory at CC channels: two stages of weights and cotangent,
// and the image
size_t bwd_smem(int CC) { return (2 * (6 + CC) + CC) * kStaged * sizeof(float); }

bool bad_shape(int N, int NI, int C, int H, int W) {
  return N < 1 || (NI != 1 && NI != N) || C < 1 || H < 1 || W < 1 ||
         blocks_for(N, H, W) >= (1L << 31);
}

}  // namespace
}  // namespace lagomorph

// I: (NI, C, H, W), NI in {1, N}; disp: (N, 2, H, W); out: (N, C, H, W)
extern "C" int lagomorph_warp2d_fwd(const float* I, const float* disp, float* out, int N, int NI,
                                    int C, int H, int W, void* stream) {
  using namespace lagomorph;
  if (bad_shape(N, NI, C, H, W)) return (int)cudaErrorInvalidValue;
  const long groups = (N + kFwdSubjects - 1) / kFwdSubjects;
  warp2d_fwd_kernel<<<(unsigned)blocks_for(groups, H, W), kThreads, 0, (cudaStream_t)stream>>>(
      I, disp, out, N, NI, C, H, W);
  return (int)cudaGetLastError();
}

// I, dI: (NI, C, H, W), NI in {1, N} (a batch-1 dI summed over the
// subjects); disp, d_disp: (N, 2, H, W); g: (N, C, H, W).  One launch a
// pair of channels.
extern "C" int lagomorph_warp2d_bwd(const float* I, const float* disp, const float* g, float* dI,
                                    float* d_disp, int N, int NI, int C, int H, int W,
                                    void* stream) {
  using namespace lagomorph;
  if (bad_shape(N, NI, C, H, W)) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const unsigned blocks = (unsigned)blocks_for(NI, H, W);
  for (int c0 = 0; c0 < C; c0 += kPair) {
    if (C - c0 >= 2)
      warp2d_bwd_kernel<2><<<blocks, kThreads, bwd_smem(2), st>>>(I, disp, g, dI, d_disp, N,
                                                                 NI, C, c0, H, W, c0 > 0);
    else
      warp2d_bwd_kernel<1><<<blocks, kThreads, bwd_smem(1), st>>>(I, disp, g, dI, d_disp, N,
                                                                 NI, C, c0, H, W, c0 > 0);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}
