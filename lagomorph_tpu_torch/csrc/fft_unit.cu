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
// Three paths, chosen by shape (lagomorph_fluid_flat at the end):
//
// * Y == Z in {64, 128} and X a power of two up to 256 (128^3, 64^3:
//   the 3D step's shapes): the plane path, three passes.
//     A. per (f, x) plane, z forward then y forward (plane_pass_kernel);
//     B. per x-line, x forward, times Mn, x inverse (reg_pass_kernel);
//     C. per plane, y inverse then z inverse, times 1 / (X Y Z).
//   A block of P * G threads (1024 at P = 128) holds a whole P x P plane in
//   registers, R = 16 elements a thread at P = 128: first as z-rows (G
//   neighbouring lanes a row), then, after one transpose through shared
//   memory, as y-columns (one lane a column).  Each line transform is done
//   in registers with one exchange through shared memory (fft_reg.cuh:
//   16-point DFTs in registers, twiddles, exchange, two 8-point DFTs), so a
//   plane costs six barriers, against log2(Y) + log2(Z) stages between
//   barriers when the plane sits in shared memory (K14, fft_radix.cu).
//   The passes' bodies (plane_pass, reg_pass) are in fft_plane.cuh, shared
//   with K16 (fft_whole.cu), which runs them as the phases of one launch.
//   A reads (x1, x2) and writes the split pair (y1, y2); B and C run in
//   place on it (a block reads all of its plane or lines into registers
//   before its first barrier), so there is no complex scratch, and the
//   field crosses device memory 3 times each way (~0.60 GB at 128^3 b4)
//   where five passes take 5 (~1.0 GB).
// * Every axis a power of two up to 256, but not the above (a 256^2 plane,
//   512 KB, is more than a block's shared memory; Y != Z; smaller planes):
//   the line path,
//   five register passes (z, y forward; x forward, times Mn, x inverse; y,
//   z inverse), each with L = 256 / G lines a block.  Strided lines (y, x)
//   put one line on each lane of a warp, so each load and store of the
//   warp is 32 neighbouring floats; contiguous z-lines put the G threads of
//   a line on neighbouring lanes, which read neighbouring elements.  Both
//   load straight into registers and store straight from them; the only
//   shared memory is the exchange and the twiddle table.  Pass 1 writes
//   (y1, y2), 2-5 run in place, the scaling is done once, in pass 5.
// * Any other shape (an axis not a power of two, or longer than 256): the
//   tile path (fft_lines.cuh, shared with K8/K9 and K16), five passes
//   through an (F, X, Y, Z) complex scratch.  A block takes TJ lines in a
//   tile [n][line]; a power-of-two axis is a radix-2 Stockham FFT (log2 N
//   stages between barriers, ping-pong between two tiles), any other
//   length the direct sum over n of x[n] * exp(-+2 pi i k n / N); each
//   inverse pass scales by 1/N of its axis.
//
// Bound on the H100.  Radix-2 needs 5 log2(N) flops per output per axis,
// which leaves each pass bound by its device-memory traffic: the field
// (F = 6 pairs at 128^3 b4: 100.7 MB as a float pair) read and written
// once per pass (the byte bound counts x, Mn and y once: 0.063 ms).  The
// plane and line paths spend per element and pass one load, one store and
// one or two shared-memory round trips; the plane pass runs one block of
// 1024 threads an SM, so its load, compute and store follow each other.
// Direct sums are 8*N float32 flops per output per axis: arithmetic-bound;
// a direct-sum thread sums R frequencies at once to reuse each x[n] it
// reads from shared memory.
#include <math.h>

#include "fft_lines.cuh"
#include "fft_plane.cuh"

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

// ---- the register path (every axis a power of two up to 256) ----

template <int N, bool ROWS>
__global__ void __launch_bounds__(kRegThreads)
    reg_pass_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                    const float* __restrict__ mult, long nlines, long inner, int mode,
                    float scale, int row_pl) {
  extern __shared__ float2 smem[];
  float2* tw = smem;      // N (G > 1 only)
  float2* S = smem + N;   // the exchange: L lines of N slots
  if (RegPlan<N>::G > 1) fill_twiddles(tw, N);  // published by the transform's first barrier
  reg_lines<N, ROWS, kRegThreads>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale,
                                  S, tw, row_pl, blockIdx.x);
}

template <int N>
static int launch_reg(const float* in_re, const float* in_im, float* out_re, float* out_im,
                      const float* mult, long nlines, long inner, int mode, float scale,
                      cudaStream_t stream) {
  constexpr int G = RegPlan<N>::G, L = kRegThreads / G;
  const bool rows = inner == 1;
  const int pl = row_pitch(N);
  const size_t smem = G == 1 ? 0 : (N + (size_t)L * (rows ? pl : N)) * sizeof(float2);
  const unsigned blocks = (unsigned)((nlines + L - 1) / L);
  auto kernel = rows ? reg_pass_kernel<N, true> : reg_pass_kernel<N, false>;
  kernel<<<blocks, kRegThreads, smem, stream>>>(in_re, in_im, out_re, out_im, mult, nlines,
                                                inner, mode, scale, pl);
  return (int)cudaGetLastError();
}

// ---- the plane passes (Y == Z == P, P in 64, 128) ----

// Pass A (INV false) or C (INV) over the planes, one (f, x) plane per block
// (plane_pass, fft_plane.cuh)
template <int P, bool INV>
__global__ void __launch_bounds__(P * RegPlan<P>::G)
    plane_pass_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                      float scale) {
  extern __shared__ float2 smem[];
  fill_twiddles(smem, P);  // published by the first exchange's first barrier
  plane_pass<P, INV>(in_re, in_im, out_re, out_im, scale, (long)blockIdx.x * P * P, smem + P,
                     smem);
}

template <int P>
static int launch_plane(const float* in_re, const float* in_im, float* out_re, float* out_im,
                        long planes, bool inverse, float scale, cudaStream_t stream) {
  constexpr int threads = P * RegPlan<P>::G;
  const size_t smem = (size_t)(P + plane_slots(P)) * sizeof(float2);
  auto kernel = inverse ? plane_pass_kernel<P, true> : plane_pass_kernel<P, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)planes, threads, smem, stream>>>(in_re, in_im, out_re, out_im, scale);
  return (int)cudaGetLastError();
}

static int plane_pass_launch(int P, const float* in_re, const float* in_im, float* out_re,
                             float* out_im, long planes, bool inverse, float scale,
                             cudaStream_t stream) {
  switch (P) {
    case 64: return launch_plane<64>(in_re, in_im, out_re, out_im, planes, inverse, scale, stream);
    case 128:
      return launch_plane<128>(in_re, in_im, out_re, out_im, planes, inverse, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

static int reg_pass_launch(int N, const float* in_re, const float* in_im, float* out_re,
                           float* out_im, const float* mult, long nlines, long inner,
                           int mode, float scale, cudaStream_t stream) {
#define LAGOMORPH_REG_CASE(n)                                                               \
  case n:                                                                                  \
    return launch_reg<n>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale, \
                         stream);
  switch (N) {
    LAGOMORPH_REG_CASE(1)
    LAGOMORPH_REG_CASE(2)
    LAGOMORPH_REG_CASE(4)
    LAGOMORPH_REG_CASE(8)
    LAGOMORPH_REG_CASE(16)
    LAGOMORPH_REG_CASE(32)
    LAGOMORPH_REG_CASE(64)
    LAGOMORPH_REG_CASE(128)
    LAGOMORPH_REG_CASE(256)
  }
#undef LAGOMORPH_REG_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace lagomorph

// x1, x2, y1, y2: (F, X, Y, Z) float32; Mn: (X, Y, Z) float32; scratch:
// (F, X, Y, Z) complex (float2), used only by the tile path (some axis not a
// power of two up to 256; may be NULL otherwise).  y1/y2 may not alias
// x1/x2.
extern "C" int lagomorph_fluid_flat(const float* x1, const float* x2,
                                    const float* Mn, float* y1, float* y2,
                                    float* scratch, int F, int X, int Y, int Z,
                                    void* stream_) {
  using namespace lagomorph;
  cudaStream_t stream = (cudaStream_t)stream_;
  const long YZ = (long)Y * Z;
  int err;
  if (reg_axis(X) && reg_axis(Y) && reg_axis(Z) && plane_axes(Y, Z)) {
    // A. z then y forward per plane, x -> y; B. x forward, times Mn, x
    // inverse; C. y then z inverse per plane with the scale 1 / (X Y Z), a
    // power of two; B and C in place on (y1, y2)
    const float scale = 1.0f / (float)((long)X * YZ);
    err = plane_pass_launch(Y, x1, x2, y1, y2, (long)F * X, false, 1.0f, stream);
    if (err) return err;
    err = reg_pass_launch(X, y1, y2, y1, y2, Mn, (long)F * YZ, YZ, REG_MUL, 1.0f, stream);
    if (err) return err;
    return plane_pass_launch(Y, y1, y2, y1, y2, (long)F * X, true, scale, stream);
  }
  if (reg_axis(X) && reg_axis(Y) && reg_axis(Z)) {
    // 1. z forward, x -> y; 2. y forward; 3. x forward, times Mn, x
    // inverse; 4. y inverse; 5. z inverse with the scale 1 / (X Y Z), a
    // power of two; 2-5 in place on (y1, y2)
    const float scale = 1.0f / (float)((long)X * YZ);
    err = reg_pass_launch(Z, x1, x2, y1, y2, nullptr, (long)F * X * Y, 1, REG_FWD, 1.0f, stream);
    if (err) return err;
    err = reg_pass_launch(Y, y1, y2, y1, y2, nullptr, (long)F * X * Z, Z, REG_FWD, 1.0f, stream);
    if (err) return err;
    err = reg_pass_launch(X, y1, y2, y1, y2, Mn, (long)F * YZ, YZ, REG_MUL, 1.0f, stream);
    if (err) return err;
    err = reg_pass_launch(Y, y1, y2, y1, y2, nullptr, (long)F * X * Z, Z, REG_INV, 1.0f, stream);
    if (err) return err;
    return reg_pass_launch(Z, y1, y2, y1, y2, nullptr, (long)F * X * Y, 1, REG_INV, scale,
                           stream);
  }
  if (scratch == nullptr) return (int)cudaErrorInvalidValue;
  float2* c = reinterpret_cast<float2*>(scratch);
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
