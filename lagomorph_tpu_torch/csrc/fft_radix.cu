// K14 and K15: the radix-2 fluid solve for beta == 0 on packed pairs of
// real fields, spectra kept in bit-reversed order between the launches (no
// reordering pass):
//
//   K14 forward  `fluid_radix_zy`: the DFT along z, then along y, of every
//                (pair, x) plane; frequency k of each axis written at
//                position bitrev(k);
//   K15          `fluid_radix_x`:  along x, the forward DFT, times the
//                bit-reversed multiplier Mbr at the bit-reversed
//                frequency, the inverse DFT times 1/X;
//   K14 inverse: the inverse DFT along y, then along z, of a bit-reversed
//                spectrum, times 1/(Y Z), natural order out.
//
// K14, K15, K14 give y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2)) with Mbr the
// natural-order multiplier Mn with every axis permuted into bit-reversed
// order (Mbr[i, j, l] == Mn[br(i), br(j), br(l)]).  Replaces the Pallas
// kernels of lagomorph_tpu/ops/pallas/fft_unit.py `_zy_fwd_kernel` /
// `_zy_inv_kernel` (via `_zy_call`, pallas_call at :232; K14) and
// `_x_mul_kernel` (via `_x_mul_call`, pallas_call at :256; K15), called by
// `fluid_flat_pallas`.  Those run radix-2 DIF and DIT stages
// (fft_unit.py:38-43), which leave and take the spectrum in bit-reversed
// order; their slabs and rolls are TPU geometry and are not carried over.
//
// Design: K3's passes (fft_unit.cu, fft_plane.cuh, fft_reg.cuh) with the
// bit-reversed contract between launches.  In fft_reg.cuh's four-step
// split thread g's register e = s G + k2 holds the natural frequency
// k = g + G s + R k2, whose bit-reversed position is
// R bitrev(g) + G bitrev(s) + bitrev(k2): each thread owns a run of R
// neighbouring positions, so the permutation is address arithmetic and
// register renaming, not a pass (dist2_bitrev).  Three paths per axis
// pair, chosen by shape:
//
// * plane (Y == Z in {64, 128}: 128^3, 64^3): one launch per direction, a
//   block of P * G threads holding a whole (y, z) plane in registers (K3's
//   plane_pass with BR).  y is the strided axis: a column thread's
//   frequencies go to bit-reversed rows, lanes still run over z.  z is the
//   contiguous axis: its permutation is made at the transpose through
//   shared memory, with a swizzled slot (plane_slot) that keeps the
//   transpose free of bank conflicts, so the global stores stay
//   z-contiguous across the warp.
// * line (every axis a power of two up to 256, not the above: 256^2 planes,
//   Y != Z, smaller planes): two register line passes per direction (z then
//   y forward, y then z inverse, the second in place), K3's reg_pass with
//   BR at the store (forward) or the load (inverse).  On the strided y
//   lines that is a row address; on the contiguous z lines a thread's
//   bit-reversed positions are neighbours, so the spectrum moves through
//   the line's exchange slots and the lanes load and store neighbouring
//   words (element by element the forward took 2.6x as long at 256^3 b1 on
//   an H100).
// * tile (an axis longer than 256, up to 8192): that axis's pass holds TJ
//   lines in a shared-memory tile [n][TJ + 1] and runs log2 N radix-2
//   stages between barriers (radix_stages; DIF leaves bit-reversed order,
//   DIT takes it).
// K15 is one register x pass (REG_MUL, as K3's pass B, reading Mbr at the
// bit-reversed frequency), or a tile pass for X > 256.  The inverse scales
// once, by 1/(Y Z) at the store of its last pass (K15 by 1/X): powers of
// two, which commute with every rounding away from subnormals, so on the
// plane and line paths K14, K15, K14 are bit-equal to K3.
//
// Bound on the H100 (128^3 b4: F = 6 pairs, 100.7 MB of packed complex
// field).  Each launch reads the field once and writes it once (K15 also
// reads the 8.4 MB multiplier): 0.060 ms (K14) and 0.063 ms (K15) at
// 3.35 TB/s; the three launches move the same bytes as K3's three passes.
// The radix-2 count is 5 flops per element per stage: 14 stages (K14) or
// 14 plus the product (K15) over 12.6 M elements, ~0.9 GFLOP, 0.013 ms at
// 67 TFLOP/s.  So all three are bound by bytes.
#include <math.h>

#include "fft_lines.cuh"
#include "fft_plane.cuh"

namespace lagomorph {

constexpr int kRadixLineThreads = 256;

// the largest shared memory a block may opt into on the H100 (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

// log2 of a power of two
__device__ __forceinline__ int log2_of(int n) { return 31 - __clz(n); }

// tw[t] = exp(2 pi i t / N) for t < N / 2
__device__ __forceinline__ void fill_half_twiddles(float2* tw, int N) {
  for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
    double sn, cs;
    sincospi(2.0 * (double)t / (double)N, &sn, &cs);
    tw[t] = make_float2((float)cs, (float)sn);
  }
}

// ---- the tile path (an axis longer than 256) ----

// All radix-2 stages of the tile's `nlines` lines (nlines and N powers of
// two), element n of line l at buf[n * TP + l]: DIF (natural in,
// bit-reversed out) or, with kDIT, DIT (bit-reversed in, natural out, the
// last stage scaled by `scale`).  sign = -1 forward, +1 inverse.  One
// butterfly per thread at a time, consecutive threads on consecutive
// lines; every stage ends at a block barrier.
template <bool kDIT>
__device__ void radix_stages(float2* buf, int N, int nlines, int TP,
                             const float2* __restrict__ tw, float sign, float scale) {
  const int lgN = log2_of(N);
  const int lgl = log2_of(nlines);
  const int total = (N >> 1) * nlines;
  for (int st = 0; st < lgN; ++st) {
    const int lgs = kDIT ? st : lgN - 1 - st;
    const int s = 1 << lgs;
    const bool last = st == lgN - 1;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      const int line = b & (nlines - 1), q = b >> lgl;
      const int e = q & (s - 1);
      const int n = ((q >> lgs) << (lgs + 1)) + e;
      float2* p0 = buf + line + (long)n * TP;
      float2* p1 = p0 + (long)s * TP;
      const float2 w = tw[e << (lgN - 1 - lgs)];
      const float wr = w.x, wi = sign * w.y;
      const float2 a = *p0, c = *p1;
      if (kDIT) {
        const float tr = wr * c.x - wi * c.y, ti = wr * c.y + wi * c.x;
        float2 u = make_float2(a.x + tr, a.y + ti);
        float2 v = make_float2(a.x - tr, a.y - ti);
        if (last) {
          u = make_float2(u.x * scale, u.y * scale);
          v = make_float2(v.x * scale, v.y * scale);
        }
        *p0 = u;
        *p1 = v;
      } else {
        const float dr = a.x - c.x, di = a.y - c.y;
        *p0 = make_float2(a.x + c.x, a.y + c.y);
        *p1 = make_float2(wr * dr - wi * di, wr * di + wi * dr);
      }
    }
    __syncthreads();
  }
}

// The tile path's pass: TJ lines per block (a power of two) of length N at
// stride `inner` in a volume viewed as (outer, N, inner), read from the
// real pair (in_re, in_im) and written to (out_re, out_im), which may be the
// same arrays (each block owns its lines).  Mode: REG_FWD, DIF; REG_INV,
// DIT scaled by `scale`; REG_MUL, DIF, times `mult` (one (N, inner) slab,
// indexed like the bit-reversed lines), DIT scaled by `scale`.
__global__ void __launch_bounds__(kRadixLineThreads)
radix_lines_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                   const float* __restrict__ mult, long nlines, int N, long inner, int TJ,
                   int mode, float scale) {
  extern __shared__ float2 smem[];
  float2* tw = smem;       // N / 2
  float2* S = smem + N / 2;  // N * (TJ + 1), [n][line]
  const int TP = TJ + 1;
  fill_half_twiddles(tw, N);
  const long l0 = (long)blockIdx.x * TJ;
  const int nl = nlines - l0 < TJ ? (int)(nlines - l0) : TJ;
  const bool contig = inner == 1;
  const int total = N * TJ;
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int j, n;
    if (contig) { j = e / N; n = e - j * N; } else { n = e / TJ; j = e - n * TJ; }
    float2 val = make_float2(0.0f, 0.0f);
    if (j < nl) {
      const long a = line_addr(l0 + j, n, N, inner);
      val = make_float2(in_re[a], in_im[a]);
    }
    S[n * TP + j] = val;
  }
  __syncthreads();
  if (mode == REG_INV) {
    radix_stages<true>(S, N, TJ, TP, tw, 1.0f, scale);
  } else {
    radix_stages<false>(S, N, TJ, TP, tw, -1.0f, 1.0f);
    if (mode == REG_MUL) {
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int k = e / TJ, j = e - k * TJ;
        if (j < nl) {
          const float m = mult[(long)k * inner + (l0 + j) % inner];
          const float2 v = S[k * TP + j];
          S[k * TP + j] = make_float2(v.x * m, v.y * m);
        }
      }
      __syncthreads();
      radix_stages<true>(S, N, TJ, TP, tw, 1.0f, scale);
    }
  }
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int j, k;
    if (contig) { j = e / N; k = e - j * N; } else { k = e / TJ; j = e - k * TJ; }
    if (j < nl) {
      const long a = line_addr(l0 + j, k, N, inner);
      const float2 v = S[k * TP + j];
      out_re[a] = v.x;
      out_im[a] = v.y;
    }
  }
}

static size_t radix_line_smem(int N, int tj) {
  return ((size_t)N / 2 + (size_t)N * (tj + 1)) * sizeof(float2);
}

static int launch_tile(const float* in_re, const float* in_im, float* out_re, float* out_im,
                       const float* mult, long nlines, int N, long inner, int mode, float scale,
                       cudaStream_t stream) {
  // lines per block: the widest TJ <= 32 whose tile fits 96 KB (two blocks
  // per SM), else one line, up to the block's limit
  int tj = 32;
  while (tj > 1 && radix_line_smem(N, tj) > 96 * 1024) tj /= 2;
  const size_t smem = radix_line_smem(N, tj);
  if (smem > kMaxBlockSmem) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      radix_lines_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long blocks = (nlines + tj - 1) / tj;
  radix_lines_kernel<<<(unsigned)blocks, kRadixLineThreads, smem, stream>>>(
      in_re, in_im, out_re, out_im, mult, nlines, N, inner, tj, mode, scale);
  return (int)cudaGetLastError();
}

// ---- the register paths (every axis a power of two up to 256) ----

// One register pass over lines of length N with the spectrum bit-reversed
// (reg_lines with BR, fft_plane.cuh)
template <int N, bool ROWS>
__global__ void __launch_bounds__(kRegThreads)
    radix_reg_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                     const float* __restrict__ mult, long nlines, long inner, int mode,
                     float scale, int row_pl) {
  extern __shared__ float2 smem[];
  float2* tw = smem;      // N (G > 1 only)
  float2* S = smem + N;   // the exchange: L lines of N slots
  if (RegPlan<N>::G > 1) fill_twiddles(tw, N);  // published by the transform's first barrier
  reg_lines<N, ROWS, kRegThreads, true>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode,
                                        scale, S, tw, row_pl, blockIdx.x);
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
  auto kernel = rows ? radix_reg_kernel<N, true> : radix_reg_kernel<N, false>;
  kernel<<<blocks, kRegThreads, smem, stream>>>(in_re, in_im, out_re, out_im, mult, nlines,
                                                inner, mode, scale, pl);
  return (int)cudaGetLastError();
}

// One pass along an axis of length N (lines at stride `inner`): the
// register pass up to 256, the tile pass above
static int axis_pass(int N, const float* in_re, const float* in_im, float* out_re,
                     float* out_im, const float* mult, long nlines, long inner, int mode,
                     float scale, cudaStream_t stream) {
#define LAGOMORPH_RADIX_CASE(n)                                                             \
  case n:                                                                                  \
    return launch_reg<n>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale, \
                         stream);
  switch (N) {
    LAGOMORPH_RADIX_CASE(2)
    LAGOMORPH_RADIX_CASE(4)
    LAGOMORPH_RADIX_CASE(8)
    LAGOMORPH_RADIX_CASE(16)
    LAGOMORPH_RADIX_CASE(32)
    LAGOMORPH_RADIX_CASE(64)
    LAGOMORPH_RADIX_CASE(128)
    LAGOMORPH_RADIX_CASE(256)
  }
#undef LAGOMORPH_RADIX_CASE
  return launch_tile(in_re, in_im, out_re, out_im, mult, nlines, N, inner, mode, scale, stream);
}

// K14 on whole planes (Y == Z == P): one (f, x) plane per block (plane_pass
// with BR, fft_plane.cuh)
template <int P, bool INV>
__global__ void __launch_bounds__(P * RegPlan<P>::G)
    radix_plane_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                       float scale) {
  extern __shared__ float2 smem[];
  fill_twiddles(smem, P);  // published by the first exchange's first barrier
  plane_pass<P, INV, true>(in_re, in_im, out_re, out_im, scale, (long)blockIdx.x * P * P,
                           smem + P, smem);
}

template <int P>
static int launch_plane(const float* in_re, const float* in_im, float* out_re, float* out_im,
                        long planes, bool inverse, float scale, cudaStream_t stream) {
  constexpr int threads = P * RegPlan<P>::G;
  const size_t smem = (size_t)(P + plane_slots(P)) * sizeof(float2);
  auto kernel = inverse ? radix_plane_kernel<P, true> : radix_plane_kernel<P, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)planes, threads, smem, stream>>>(in_re, in_im, out_re, out_im, scale);
  return (int)cudaGetLastError();
}

}  // namespace lagomorph

// K14.  re, im, out_re, out_im: (F, X, Y, Z) float32 (the output may not
// alias the input); inverse: 0 forward (z then y, bit-reversed out), 1
// inverse (y then z from bit-reversed order, times 1/(Y Z), natural out).
// Y, Z powers of two from 2 to 8192.
extern "C" int lagomorph_fluid_radix_zy(const float* re, const float* im, float* out_re,
                                        float* out_im, int F, int X, int Y, int Z,
                                        int inverse, void* stream_) {
  using namespace lagomorph;
  cudaStream_t stream = (cudaStream_t)stream_;
  const long FX = (long)F * X;
  const float scale = inverse ? 1.0f / (float)((long)Y * Z) : 1.0f;
  if (plane_axes(Y, Z)) {
    switch (Y) {
      case 64: return launch_plane<64>(re, im, out_re, out_im, FX, inverse, scale, stream);
      case 128: return launch_plane<128>(re, im, out_re, out_im, FX, inverse, scale, stream);
    }
  }
  // two line passes, the second in place on the output
  int err;
  if (!inverse) {
    err = axis_pass(Z, re, im, out_re, out_im, nullptr, FX * Y, 1, REG_FWD, 1.0f, stream);
    if (err) return err;
    return axis_pass(Y, out_re, out_im, out_re, out_im, nullptr, FX * Z, Z, REG_FWD, 1.0f,
                     stream);
  }
  err = axis_pass(Y, re, im, out_re, out_im, nullptr, FX * Z, Z, REG_INV, 1.0f, stream);
  if (err) return err;
  return axis_pass(Z, out_re, out_im, out_re, out_im, nullptr, FX * Y, 1, REG_INV, scale, stream);
}

// K15.  re, im, out_re, out_im: (F, X, Y, Z) float32 with bit-reversed y
// and z (K14's forward output); Mbr: (X, Y, Z), every axis bit-reversed.  X
// a power of two from 2 to 8192.
extern "C" int lagomorph_fluid_radix_x(const float* re, const float* im, const float* Mbr,
                                       float* out_re, float* out_im, int F, int X, int Y,
                                       int Z, void* stream) {
  using namespace lagomorph;
  const long YZ = (long)Y * Z;
  return axis_pass(X, re, im, out_re, out_im, Mbr, (long)F * YZ, YZ, REG_MUL, 1.0f / X,
                   (cudaStream_t)stream);
}
