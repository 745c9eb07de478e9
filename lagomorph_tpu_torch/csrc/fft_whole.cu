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
// cooperative.cuh): as many blocks as the card holds at once, five phases
// separated by grid-wide barriers, each a grid-stride loop over tiles of TJ
// neighbouring lines transformed in shared memory (line_tile of
// fft_lines.cuh, K3's line transforms: radix-2 Stockham for power-of-two
// lengths, direct sums for any other N):
//   1. z forward, reading the real pair (x1, x2) into the complex scratch;
//   2. y forward;
//   3. x forward, times Mn, x inverse scaled by 1/X;
//   4. y inverse, 1/Y;
//   5. z inverse, 1/Z, writing the real pair (y1, y2).
// Phases 2-4 work in place on the scratch (each tile owns its lines).  At
// 64^3 b4 (F = 6 pairs) the scratch is 12.6 MB and, with the input and the
// output, stays in the 50 MB L2 from phase to phase; larger volumes run
// the same way from device memory.
//
// Bound on the H100 (64^3 b4): read the pairs (12.6 MB) and Mn (1.0 MB),
// write the result (12.6 MB): 0.0078 ms at 3.35 TB/s; two 3D complex FFTs
// per pair are ~0.2 GFLOP, 0.003 ms at 67 TFLOP/s.  Bound by bytes; the
// scratch round trips of the five phases go to L2.
#include <cooperative_groups.h>

#include "cooperative.cuh"
#include "fft_lines.cuh"

namespace cg = cooperative_groups;

namespace lagomorph {

constexpr int kWholeThreads = 256;

// one phase: every line of one axis, a tile of TJ lines at a time
__device__ __forceinline__ void whole_phase(const float* __restrict__ in_re,
                                            const float* __restrict__ in_im, float2* cbuf,
                                            float* out_re, float* out_im,
                                            const float* __restrict__ mult, int in_mode,
                                            int out_mode, long nlines, int N, long inner,
                                            int TJ, float sign, float scale,
                                            const float2* __restrict__ tw, float2* S,
                                            float2* O) {
  const long ntiles = (nlines + TJ - 1) / TJ;
  for (long t = blockIdx.x; t < ntiles; t += gridDim.x) {
    line_tile(in_re, in_im, cbuf, out_re, out_im, mult, in_mode, out_mode, nlines, N, inner,
              TJ, sign, scale, t * TJ, tw, S, O);
    __syncthreads();  // before the next tile reuses S and O
  }
}

__global__ void __launch_bounds__(kWholeThreads)
fluid_whole_kernel(const float* __restrict__ x1, const float* __restrict__ x2,
                   const float* __restrict__ Mn, float* y1, float* y2, float2* cbuf, int F,
                   int X, int Y, int Z, int TJ) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ float2 smem[];
  const int L = X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z);
  float2* twX = smem;
  float2* twY = twX + X;
  float2* twZ = twY + Y;
  float2* S = twZ + Z;             // L * (TJ + 1)
  float2* O = S + (long)L * (TJ + 1);  // L * (TJ + 1)
  fill_twiddles(twX, X);
  fill_twiddles(twY, Y);
  fill_twiddles(twZ, Z);
  __syncthreads();

  const long FX = (long)F * X;
  const long YZ = (long)Y * Z;
  // 1. z forward: lines F*X*Y of length Z, contiguous
  whole_phase(x1, x2, cbuf, nullptr, nullptr, nullptr, IN_SPLIT, OUT_COMPLEX, FX * Y, Z, 1, TJ,
              -1.0f, 1.0f, twZ, S, O);
  grid.sync();
  // 2. y forward: lines (F*X) x Z of length Y, stride Z
  whole_phase(nullptr, nullptr, cbuf, nullptr, nullptr, nullptr, IN_COMPLEX, OUT_COMPLEX,
              FX * Z, Y, Z, TJ, -1.0f, 1.0f, twY, S, O);
  grid.sync();
  // 3. x forward, times Mn, x inverse: lines F x (Y*Z) of length X
  whole_phase(nullptr, nullptr, cbuf, nullptr, nullptr, Mn, IN_COMPLEX, OUT_COMPLEX,
              (long)F * YZ, X, YZ, TJ, 0.0f, 1.0f / X, twX, S, O);
  grid.sync();
  // 4. y inverse
  whole_phase(nullptr, nullptr, cbuf, nullptr, nullptr, nullptr, IN_COMPLEX, OUT_COMPLEX,
              FX * Z, Y, Z, TJ, 1.0f, 1.0f / Y, twY, S, O);
  grid.sync();
  // 5. z inverse, to the real pair
  whole_phase(nullptr, nullptr, cbuf, y1, y2, nullptr, IN_COMPLEX, OUT_SPLIT, FX * Y, Z, 1, TJ,
              1.0f, 1.0f / Z, twZ, S, O);
}

// shared memory: the three twiddle tables and two tiles of the longest axis
static size_t whole_smem(int X, int Y, int Z, int tj) {
  const int L = X > Y ? (X > Z ? X : Z) : (Y > Z ? Y : Z);
  return ((size_t)X + Y + Z + 2 * (size_t)L * (tj + 1)) * sizeof(float2);
}

}  // namespace lagomorph

// x1, x2, y1, y2: (F, X, Y, Z) float32; Mn: (X, Y, Z) float32; scratch:
// (F, X, Y, Z) complex (float2).  y1/y2 may not alias x1/x2.
extern "C" int lagomorph_fluid_whole(const float* x1, const float* x2, const float* Mn,
                                     float* y1, float* y2, float* scratch, int F, int X, int Y,
                                     int Z, void* stream) {
  using namespace lagomorph;
  int tj = 32;  // lines per tile: the widest whose tiles fit 96 KB
  while (tj > 1 && whole_smem(X, Y, Z, tj) > 96 * 1024) tj /= 2;
  float2* c = reinterpret_cast<float2*>(scratch);
  void* args[] = {&x1, &x2, &Mn, &y1, &y2, &c, &F, &X, &Y, &Z, &tj};
  return launch_cooperative((const void*)fluid_whole_kernel, kWholeThreads,
                            whole_smem(X, Y, Z, tj), args, (cudaStream_t)stream);
}
