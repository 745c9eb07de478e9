// K16 `fluid_whole`: the fluid solve for beta == 0 on packed pairs of real
// fields in one launch,
//
//   y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))      over the axes (X, Y, Z),
//
// Mn the natural-order multiplier (real and even in k).  Replaces the
// Pallas kernel lagomorph_tpu/ops/pallas/fft_unit.py `_whole_dft_kernel`
// (`fluid_flat_mxu_whole`, pallas_call at :602), which keeps one pair's
// whole volume, its spectrum and two scratch volumes in VMEM and does every
// axis as DFT matmuls on the matrix unit (in a 3-pass bf16 split), looping
// over y planes with a (Y, X, Z)-transposed multiplier.  Those matrices,
// the plane loop and the transpose are TPU geometry and are not carried
// over.
//
// On the H100 one 64^3 complex pair (2 MB) is larger than an SM's shared
// memory, so the kernel is one cooperative persistent launch (as K8/K9,
// cooperative.cuh): as many blocks as the card holds at once, phases
// separated by grid-wide barriers, each a grid-stride loop over the passes
// of K3 (fft_unit.cu), whose bodies it shares (fft_plane.cuh).  Three paths,
// chosen by shape (lagomorph_fluid_whole at the end):
//
// * Y == Z == P in {64, 128} and X a power of two up to 256 (64^3, 128^3):
//   the plane path, three phases, blocks of P * G threads (512 at P = 64,
//   1024 at P = 128), one kernel per (P, X):
//     A. per (f, x) plane, z forward then y forward, the whole P x P plane
//        in registers (plane_pass), reading (x1, x2), writing (y1, y2);
//     B. per group of x-lines, x forward, times Mn, x inverse (reg_pass,
//        REG_MUL), in place;
//     C. per plane, y inverse then z inverse, times 1 / (X Y Z), in place.
// * Every axis a power of two up to 256, but not the above: the line path,
//   five register line phases (z, y forward; x forward, times Mn, x
//   inverse; y, z inverse) of 256-thread blocks, the first writing (y1,
//   y2), the others in place.
// * Any other shape (an axis not a power of two, or longer than 256): the
//   tile path, five phases of line_tile (fft_lines.cuh: radix-2 Stockham
//   for power-of-two lengths, direct sums otherwise) through an (F, X, Y,
//   Z) complex scratch, the only path that needs one.
// The register paths run K3's arithmetic in K3's order, every rounding
// spelled out (fft_reg.cuh), so there they are bit-identical to K3.
//
// Bound on the H100 (64^3 b4, F = 6 pairs): read the pairs (12.6 MB) and
// Mn (1.0 MB), write the result (12.6 MB): 0.0078 ms at 3.35 TB/s; two 3D
// complex FFTs per pair are ~0.28 GFLOP, 0.0043 ms at 67 TFLOP/s.  Bound by
// bytes.  With no scratch the field crosses memory three times each way on
// the plane path (five on the line path), and at 64^3 b4 the pairs, the
// result and Mn (26 MB) stay in the 50 MB L2 from phase to phase; what
// remains is one launch and two grid barriers, against K3's three launches.
// What K3's separate launches got from the block scheduler, the persistent
// grid must get from its size: at 64^3 b4 three blocks an SM hold every
// plane at once (plane_min_blocks), and at P = 128 every register counts.
#include <cooperative_groups.h>

#include "cooperative.cuh"
#include "fft_lines.cuh"
#include "fft_plane.cuh"

namespace cg = cooperative_groups;

namespace lagomorph {

// ---- the plane path (Y == Z == P) ----

// Blocks an SM the launch bounds ask for: at P = 128 one block of 1024
// threads (64 registers a thread); at P = 64 three of 512 (40 registers),
// so that the 384 planes of 64^3 b4 take one round of 396 blocks, not 1.45
// rounds of 264; two where a thread of phase B holds 16 points of its line
// (X = 16, 128, 256), which do not fit 40 registers.
__host__ __device__ constexpr int plane_min_blocks(int P, int X) {
  return P == 128 ? 1 : X / reg_group(X) <= 8 ? 3 : 2;
}

// A block of P * G threads.  `mode` is phase B's, REG_MUL; at P = 64 it is
// read at run time: with the mode a constant the compiler schedules the
// multiplier's loads ahead of the forward transform and holds more
// registers than the 40 a thread allow, which spilled.  At P = 128, with
// 64 registers, it is the constant.
template <int P, int X>
__global__ void __launch_bounds__(P * RegPlan<P>::G, plane_min_blocks(P, X))
    whole_plane_kernel(const float* x1, const float* x2, const float* __restrict__ Mn, float* y1,
                       float* y2, int F, int mode) {
  constexpr int T = P * RegPlan<P>::G, L = T / RegPlan<X>::G;
  constexpr long PP = (long)P * P;
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  float2* twP = smem;      // P
  float2* twX = twP + P;   // X
  float2* S = twX + X;     // the plane's exchanges and transpose, or B's
  fill_twiddles(twP, P);   // published by the first exchange's first barrier
  fill_twiddles(twX, X);
  // The loops keep one int counter and read their bounds from the
  // parameters: at P = 128 every register counts (64 a thread).
  // A. z then y forward per plane, x -> y
  for (int p = blockIdx.x; p < F * X; p += gridDim.x)
    plane_pass<P, false>(x1, x2, y1, y2, 1.0f, p * PP, S, twP);
  grid.sync();
  // B. x forward, times Mn, x inverse: F * P^2 lines at stride P^2, L a group
  for (int q = blockIdx.x; (long)q * L < F * PP; q += gridDim.x)
    reg_lines<X, false, T>(y1, y2, y1, y2, Mn, F * PP, PP, P == 64 ? mode : REG_MUL, 1.0f, S,
                           twX, 0, q);
  grid.sync();
  // C. y then z inverse per plane with the scale 1 / (X Y Z), a power of two
  const float scale = 1.0f / (float)((long)X * PP);
  for (int p = blockIdx.x; p < F * X; p += gridDim.x)
    plane_pass<P, true>(y1, y2, y1, y2, scale, p * PP, S, twP);
}

// every plane-path kernel has this type, and so may share the launch below
typedef void (*PlaneKernel)(const float*, const float*, const float*, float*, float*, int, int);

struct PlaneLaunch {
  PlaneKernel kernel;
  int threads;
  size_t smem;
};

template <int P, int X>
static PlaneLaunch plane_launch() {
  constexpr int T = P * RegPlan<P>::G;
  constexpr int B = reg_slots(X, false, T);
  constexpr int slots = plane_slots(P) > B ? plane_slots(P) : B;
  return PlaneLaunch{whole_plane_kernel<P, X>, T, (size_t)(P + X + slots) * sizeof(float2)};
}

template <int P>
static PlaneLaunch plane_launch_x(int X) {
  switch (X) {
    case 1: return plane_launch<P, 1>();
    case 2: return plane_launch<P, 2>();
    case 4: return plane_launch<P, 4>();
    case 8: return plane_launch<P, 8>();
    case 16: return plane_launch<P, 16>();
    case 32: return plane_launch<P, 32>();
    case 64: return plane_launch<P, 64>();
    case 128: return plane_launch<P, 128>();
    case 256: return plane_launch<P, 256>();
  }
  return PlaneLaunch{nullptr, 0, 0};
}

static PlaneLaunch plane_launch_of(int X, int P) {
  return P == 64 ? plane_launch_x<64>(X) : plane_launch_x<128>(X);
}

// ---- the line path (every axis a power of two up to 256) ----

// one phase: every line of length N, a group of L = kRegThreads / G a time
template <int N, bool ROWS>
__device__ __forceinline__ void line_phase(const float* in_re, const float* in_im, float* out_re,
                                           float* out_im, const float* __restrict__ mult,
                                           long nlines, long inner, int mode, float scale,
                                           float2* S, const float2* tw) {
  constexpr int L = kRegThreads / RegPlan<N>::G;
  for (int q = blockIdx.x; (long)q * L < nlines; q += gridDim.x)
    reg_lines<N, ROWS, kRegThreads>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode,
                                    scale, S, tw, row_pitch(N), q);
}

template <bool ROWS>
__device__ __forceinline__ void line_phase_of(int N, const float* in_re, const float* in_im,
                                              float* out_re, float* out_im,
                                              const float* __restrict__ mult, long nlines,
                                              long inner, int mode, float scale, float2* S,
                                              const float2* tw) {
#define LAGOMORPH_LINE_CASE(n)                                                              \
  case n:                                                                                  \
    line_phase<n, ROWS>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale, S, \
                        tw);                                                               \
    return;
  switch (N) {
    LAGOMORPH_LINE_CASE(1)
    LAGOMORPH_LINE_CASE(2)
    LAGOMORPH_LINE_CASE(4)
    LAGOMORPH_LINE_CASE(8)
    LAGOMORPH_LINE_CASE(16)
    LAGOMORPH_LINE_CASE(32)
    LAGOMORPH_LINE_CASE(64)
    LAGOMORPH_LINE_CASE(128)
    LAGOMORPH_LINE_CASE(256)
  }
#undef LAGOMORPH_LINE_CASE
}

// Five phases: 0. z forward, x -> y; 1. y forward; 2. x forward, times Mn,
// x inverse; 3. y inverse; 4. z inverse with the scale 1 / (X Y Z); 1-4 in
// place on (y1, y2).  One loop over the phases, so that each length's pass
// is compiled once for rows and once for strided lines.  The kernel holds
// more registers than any one phase needs (ptxas: ~205 a thread), so one
// block of 256 threads runs an SM: this path is not the 3D step's, and was
// left so.
__global__ void __launch_bounds__(kRegThreads)
    whole_line_kernel(const float* x1, const float* x2, const float* __restrict__ Mn, float* y1,
                      float* y2, int F, int X, int Y, int Z) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  float2* twX = smem;
  float2* twY = twX + X;
  float2* twZ = twY + Y;
  float2* S = twZ + Z;  // the largest phase's exchange
  fill_twiddles(twX, X);  // published by the first exchange's first barrier
  fill_twiddles(twY, Y);
  fill_twiddles(twZ, Z);
  const long FX = (long)F * X, YZ = (long)Y * Z;
  const float scale = 1.0f / (float)((long)X * YZ);
#pragma unroll 1
  for (int ph = 0; ph < 5; ++ph) {
    const bool rows = ph == 0 || ph == 4, xs = ph == 2;
    const int N = xs ? X : rows ? Z : Y;
    const long nlines = xs ? F * YZ : rows ? FX * Y : FX * Z;
    const long inner = xs ? YZ : rows ? 1 : Z;
    const int mode = xs ? REG_MUL : ph < 2 ? REG_FWD : REG_INV;
    const float* in_re = ph == 0 ? x1 : y1;
    const float* in_im = ph == 0 ? x2 : y2;
    const float s = ph == 4 ? scale : 1.0f;
    const float2* tw = xs ? twX : rows ? twZ : twY;
    if (rows)
      line_phase_of<true>(N, in_re, in_im, y1, y2, nullptr, nlines, inner, mode, s, S, tw);
    else
      line_phase_of<false>(N, in_re, in_im, y1, y2, Mn, nlines, inner, mode, s, S, tw);
    if (ph < 4) grid.sync();
  }
}

static size_t line_smem(int X, int Y, int Z) {
  int slots = reg_slots(Z, true, kRegThreads);
  if (reg_slots(Y, false, kRegThreads) > slots) slots = reg_slots(Y, false, kRegThreads);
  if (reg_slots(X, false, kRegThreads) > slots) slots = reg_slots(X, false, kRegThreads);
  return ((size_t)X + Y + Z + slots) * sizeof(float2);
}

// ---- the tile path (any other shape), through the complex scratch ----

constexpr int kTileThreads = 256;

// one phase: every line of one axis, a tile of TJ lines at a time
__device__ __forceinline__ void tile_phase(const float* __restrict__ in_re,
                                           const float* __restrict__ in_im, float2* cbuf,
                                           float* out_re, float* out_im,
                                           const float* __restrict__ mult, int in_mode,
                                           int out_mode, long nlines, int N, long inner, int TJ,
                                           float sign, float scale,
                                           const float2* __restrict__ tw, float2* S, float2* O) {
  const long ntiles = (nlines + TJ - 1) / TJ;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    line_tile(in_re, in_im, cbuf, out_re, out_im, mult, in_mode, out_mode, nlines, N, inner,
              TJ, sign, scale, t * TJ, tw, S, O);
    __syncthreads();  // before the next tile reuses S and O
  }
}

__global__ void __launch_bounds__(kTileThreads)
    whole_tile_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                      const float* __restrict__ Mn, float* y1, float* y2, float2* cbuf, int F,
                      int X, int Y, int Z, int TJ) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  const int L = X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z);
  float2* twX = smem;
  float2* twY = twX + X;
  float2* twZ = twY + Y;
  float2* S = twZ + Z;                 // L * (TJ + 1)
  float2* O = S + (long)L * (TJ + 1);  // L * (TJ + 1)
  fill_twiddles(twX, X);
  fill_twiddles(twY, Y);
  fill_twiddles(twZ, Z);
  __syncthreads();

  const long FX = (long)F * X;
  const long YZ = (long)Y * Z;
  // 1. z forward: lines F*X*Y of length Z, contiguous
  tile_phase(x1, x2, cbuf, nullptr, nullptr, nullptr, IN_SPLIT, OUT_COMPLEX, FX * Y, Z, 1, TJ,
             -1.0f, 1.0f, twZ, S, O);
  grid.sync();
  // 2. y forward: lines (F*X) x Z of length Y, stride Z
  tile_phase(nullptr, nullptr, cbuf, nullptr, nullptr, nullptr, IN_COMPLEX, OUT_COMPLEX, FX * Z,
             Y, Z, TJ, -1.0f, 1.0f, twY, S, O);
  grid.sync();
  // 3. x forward, times Mn, x inverse: lines F x (Y*Z) of length X
  tile_phase(nullptr, nullptr, cbuf, nullptr, nullptr, Mn, IN_COMPLEX, OUT_COMPLEX, (long)F * YZ,
             X, YZ, TJ, 0.0f, 1.0f / X, twX, S, O);
  grid.sync();
  // 4. y inverse
  tile_phase(nullptr, nullptr, cbuf, nullptr, nullptr, nullptr, IN_COMPLEX, OUT_COMPLEX, FX * Z,
             Y, Z, TJ, 1.0f, 1.0f / Y, twY, S, O);
  grid.sync();
  // 5. z inverse, to the real pair
  tile_phase(nullptr, nullptr, cbuf, y1, y2, nullptr, IN_COMPLEX, OUT_SPLIT, FX * Y, Z, 1, TJ,
             1.0f, 1.0f / Z, twZ, S, O);
}

// shared memory: the three twiddle tables and two tiles of the longest axis
static size_t tile_smem(int X, int Y, int Z, int tj) {
  const int L = X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z);
  return ((size_t)X + Y + Z + 2 * (size_t)L * (tj + 1)) * sizeof(float2);
}

// lines per tile: the widest whose tiles fit 96 KB
static int tile_lines(int X, int Y, int Z) {
  int tj = 32;
  while (tj > 1 && tile_smem(X, Y, Z, tj) > 96 * 1024) tj /= 2;
  return tj;
}

enum WholePath { WHOLE_PLANE = 0, WHOLE_LINE = 1, WHOLE_TILE = 2 };

static int whole_path(int X, int Y, int Z) {
  if (reg_axis(X) && reg_axis(Y) && reg_axis(Z)) return plane_axes(Y, Z) ? WHOLE_PLANE : WHOLE_LINE;
  return WHOLE_TILE;
}

}  // namespace lagomorph

// x1, x2, y1, y2: (F, X, Y, Z) float32; Mn: (X, Y, Z) float32; scratch:
// (F, X, Y, Z) complex (float2), used only by the tile path (some axis not a
// power of two up to 256; may be NULL otherwise).  y1/y2 may not alias
// x1/x2.
extern "C" int lagomorph_fluid_whole(const float* x1, const float* x2, const float* Mn,
                                     float* y1, float* y2, float* scratch, int F, int X, int Y,
                                     int Z, void* stream_) {
  using namespace lagomorph;
  cudaStream_t stream = (cudaStream_t)stream_;
  switch (whole_path(X, Y, Z)) {
    case WHOLE_PLANE: {
      const PlaneLaunch pl = plane_launch_of(X, Y);
      PlaneKernel kernel = pl.kernel;
      int mode = REG_MUL;
      void* args[] = {&x1, &x2, &Mn, &y1, &y2, &F, &mode};
      return launch_cooperative((const void*)kernel, pl.threads, pl.smem, args, stream);
    }
    case WHOLE_LINE: {
      void* args[] = {&x1, &x2, &Mn, &y1, &y2, &F, &X, &Y, &Z};
      return launch_cooperative((const void*)whole_line_kernel, kRegThreads, line_smem(X, Y, Z),
                                args, stream);
    }
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  int tj = tile_lines(X, Y, Z);
  float2* c = reinterpret_cast<float2*>(scratch);
  void* args[] = {&x1, &x2, &Mn, &y1, &y2, &c, &F, &X, &Y, &Z, &tj};
  return launch_cooperative((const void*)whole_tile_kernel, kTileThreads, tile_smem(X, Y, Z, tj),
                            args, stream);
}

// The launch lagomorph_fluid_whole makes at (X, Y, Z): out[0] the path (0
// plane, 1 line, 2 tile), out[1] the cooperative grid's blocks, out[2] the
// threads of a block, out[3] its dynamic shared memory in bytes.
extern "C" int lagomorph_fluid_whole_grid(int X, int Y, int Z, int* out) {
  using namespace lagomorph;
  const int path = whole_path(X, Y, Z);
  const void* kernel;
  int threads;
  size_t smem;
  if (path == WHOLE_PLANE) {
    const PlaneLaunch pl = plane_launch_of(X, Y);
    kernel = (const void*)pl.kernel;
    threads = pl.threads;
    smem = pl.smem;
  } else if (path == WHOLE_LINE) {
    kernel = (const void*)whole_line_kernel;
    threads = kRegThreads;
    smem = line_smem(X, Y, Z);
  } else {
    kernel = (const void*)whole_tile_kernel;
    threads = kTileThreads;
    smem = tile_smem(X, Y, Z, tile_lines(X, Y, Z));
  }
  out[0] = path;
  out[2] = threads;
  out[3] = (int)smem;
  return cooperative_blocks(kernel, threads, smem, &out[1]);
}
