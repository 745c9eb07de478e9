// K3: the fluid solve for beta == 0, on packed pairs of real fields.
//
//   y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2))      over the axes (X, Y, Z)
//
// Mn is the full-spectrum scalar multiplier, even in k, so the real and
// imaginary parts of the result are the operator applied to x1 and x2
// (lagomorph_tpu/ops/fluid.py:420-426, 555-590).  Replaces the Pallas kernels
// lagomorph_tpu/ops/pallas/fft_unit.py `_zy_dft_kernel` (via `_zy_dft_call`:
// z- then y-axis DFT, and its inverse) and `_x_mul_dft_kernel` (via
// `_x_mul_dft_call`: x-axis DFT, multiply by Mn, inverse x-axis DFT), called
// by `fluid_flat_mxu`.  The TPU kernel does each axis as a matmul on its
// matrix unit in a 3-pass bf16 split (`_dot3`) to reach float32 accuracy;
// Hopper's float32 FMA needs no split.
//
// Each pass is a line transform in shared memory (fft_lines.cuh, shared
// with the 2D whole-shoot kernels of shoot2d.cu).  A block takes TJ lines
// along one axis (neighbouring lines, so the loads coalesce) and keeps them
// in shared memory as [n][line].  An axis whose length is a power of two is
// transformed by a radix-2 Stockham FFT (log2 N stages, ping-pong between
// two tiles, results in natural order); any other length by the direct sum
// over n of x[n] * exp(-+2 pi i k n / N).  The twiddles come from a length-N
// table in shared memory, indexed by (k * n) mod N (direct) or p * s
// (radix-2), which fits any N.  Five passes over the (F, X, Y, Z) complex
// scratch:
//   1. z forward, reading the real pair (x1, x2);
//   2. y forward;
//   3. x forward, times Mn, x inverse (one pass: the whole x line is in
//      shared memory);
//   4. y inverse;
//   5. z inverse, writing the real pair (y1, y2).
// Each inverse pass scales by 1/N of its axis.
//
// Bound on the H100.  Direct sums are 8*N float32 flops per output per axis
// (~77 GFLOP at 128^3 b4, F = 6 pairs, six axis transforms): arithmetic-
// bound.  Radix-2 needs 5 log2(N) flops per output per axis (~29x fewer at
// N = 128), which leaves each pass bound by its device-memory traffic: the
// complex scratch (F = 6 pairs at 128^3 b4: 100.7 MB) read and written once
// per pass, five passes, ~1 GB per solve.  Design: the warp's 32 lanes take 32 lines at one frequency (or
// one butterfly), so the twiddle read is a broadcast and the tile accesses
// are free of bank conflicts; a direct-sum thread sums R frequencies at once
// to reuse each x[n] it reads from shared memory.
#include <math.h>

#include "fft_lines.cuh"

namespace lagomorph {

constexpr int kThreads = 256;

// One pass over all lines of one axis, one tile of TJ lines per block
// (line_tile in fft_lines.cuh).  `mult` (pass 3 only) is the multiplier
// laid out like one (N, inner) slab: forward DFT, times mult, inverse DFT.
// Otherwise one DFT of direction `sign`, scaled by `scale`.
__global__ void dft_pass_kernel(const float* __restrict__ in_re,
                                const float* __restrict__ in_im,
                                float2* cbuf, float* __restrict__ out_re,
                                float* __restrict__ out_im,
                                const float* __restrict__ mult, int in_mode,
                                int out_mode, long nlines, int N, long inner,
                                int TJ, float sign, float scale) {
  extern __shared__ float2 smem[];
  float2* tw = smem;              // N
  float2* S = smem + N;           // N * (TJ + 1)
  float2* O = S + N * (TJ + 1);   // N * (TJ + 1)
  fill_twiddles(tw, N);
  line_tile(in_re, in_im, cbuf, out_re, out_im, mult, in_mode, out_mode, nlines, N,
            inner, TJ, sign, scale, (long)blockIdx.x * TJ, tw, S, O);
}

static int launch_pass(const float* in_re, const float* in_im, float2* cbuf,
                       float* out_re, float* out_im, const float* mult,
                       int in_mode, int out_mode, long nlines, int N,
                       long inner, float sign, float scale,
                       cudaStream_t stream) {
  const int tj = line_pick_tj(N);
  const size_t smem = line_smem_bytes(N, tj);
  cudaError_t err = cudaFuncSetAttribute(
      dft_pass_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (nlines + tj - 1) / tj;
  dft_pass_kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      in_re, in_im, cbuf, out_re, out_im, mult, in_mode, out_mode, nlines, N,
      inner, tj, sign, scale);
  return (int)cudaGetLastError();
}

}  // namespace lagomorph

// x1, x2, y1, y2: (F, X, Y, Z) float32; Mn: (X, Y, Z) float32; scratch:
// (F, X, Y, Z) complex (float2).  y1/y2 may not alias x1/x2.
extern "C" int lagomorph_fluid_flat(const float* x1, const float* x2,
                                    const float* Mn, float* y1, float* y2,
                                    float* scratch, int F, int X, int Y, int Z,
                                    void* stream_) {
  using namespace lagomorph;
  cudaStream_t stream = (cudaStream_t)stream_;
  float2* c = reinterpret_cast<float2*>(scratch);
  const long YZ = (long)Y * Z;
  int err;
  // 1. z forward: lines (F*X*Y) of length Z, contiguous
  err = launch_pass(x1, x2, c, nullptr, nullptr, nullptr, IN_SPLIT, OUT_COMPLEX,
                    (long)F * X * Y, Z, 1, -1.0f, 1.0f, stream);
  if (err) return err;
  // 2. y forward: lines (F*X) x Z of length Y, stride Z
  err = launch_pass(nullptr, nullptr, c, nullptr, nullptr, nullptr, IN_COMPLEX,
                    OUT_COMPLEX, (long)F * X * Z, Y, Z, -1.0f, 1.0f, stream);
  if (err) return err;
  // 3. x forward, times Mn, x inverse: lines F x (Y*Z) of length X
  err = launch_pass(nullptr, nullptr, c, nullptr, nullptr, Mn, IN_COMPLEX,
                    OUT_COMPLEX, (long)F * YZ, X, YZ, 0.0f, 1.0f / X, stream);
  if (err) return err;
  // 4. y inverse
  err = launch_pass(nullptr, nullptr, c, nullptr, nullptr, nullptr, IN_COMPLEX,
                    OUT_COMPLEX, (long)F * X * Z, Y, Z, 1.0f, 1.0f / Y, stream);
  if (err) return err;
  // 5. z inverse, to the real pair
  return launch_pass(nullptr, nullptr, c, y1, y2, nullptr, IN_COMPLEX,
                     OUT_SPLIT, (long)F * X * Y, Z, 1, 1.0f, 1.0f / Z, stream);
}
