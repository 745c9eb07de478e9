// K14 and K15: the radix-2 fluid solve for beta == 0 on packed pairs of
// real fields, spectra kept in bit-reversed order (no reordering pass):
//
//   K14 forward  `fluid_radix_zy`: radix-2 DIF stages along z, then along y,
//                of every (pair, x) plane; frequencies out in bit-reversed
//                z and y order;
//   K15          `fluid_radix_x`:  along x, DIF stages, times the
//                bit-reversed multiplier Mbr, DIT stages scaled by 1/X;
//   K14 inverse: DIT stages along y (1/Y), then along z (1/Z), back to
//                natural order.
//
// K14, K15, K14 give y1 + i*y2 = ifftn(Mn * fftn(x1 + i*x2)) with Mbr the
// natural-order multiplier Mn with every axis permuted into bit-reversed
// order.  Replaces the Pallas kernels of lagomorph_tpu/ops/pallas/
// fft_unit.py `_zy_fwd_kernel` / `_zy_inv_kernel` (via `_zy_call`,
// pallas_call at :232; K14) and `_x_mul_kernel` (via `_x_mul_call`,
// pallas_call at :256; K15), called by `fluid_flat_pallas`.  The butterfly
// algebra is theirs (fft_unit.py:38-43), for half-length s of an axis of
// length N, a pair (a at j, b at j + s), e = j mod s and
// W = exp(sign * i * pi * e / s):
//
//   DIF (s = N/2 .. 1):  a, b <- a + b, W * (a - b)
//   DIT (s = 1 .. N/2):  a, b <- a + W * b, a - W * b      (last stage * 1/N)
//
// Both are in place, so one buffer holds the lines.  The twiddles come from
// a table of N/2 entries in shared memory, exp(2 pi i t / N) at
// t = e * N / (2 s), computed in double.
//
// Design.  The TPU kernels keep (X-block, Y*Z) slabs in VMEM and reach the
// partners of each stage by lane and sublane rolls; their blockings and
// VMEM limit (fft_unit.py:211-268) are TPU geometry and are not carried
// over.  Here:
//   * K14 holds one whole (Y, Z) complex plane of one (pair, x) in shared
//     memory (128 KB at 128^2, of the block's 227 KB): one pass over device
//     memory for both axes, every stage between two block barriers, the
//     threads on consecutive elements (z stages) or consecutive lines (y
//     stages).  A plane too large for shared memory (the 256^2 of a 256^3
//     volume is 512 KB) takes the two axes as two line passes instead (z
//     then y forward, y then z inverse; the second in place).
//   * K15 and those line passes take TJ neighbouring lines per block (along
//     x at stride Y*Z: the TJ lines are TJ consecutive addresses, so the
//     loads coalesce, as K3's pass 3) into a tile [n][TJ + 1], the padding
//     keeping the tile's accesses free of bank conflicts.
//
// Bound on the H100 (128^3 b4: F = 6 pairs, 100.7 MB of packed complex
// field).  Each launch reads the field once and writes it once (K15 also
// reads the 8.4 MB multiplier): 0.060 ms (K14) and 0.063 ms (K15) at
// 3.35 TB/s.  The butterflies are 5 flops per element per stage: 14 stages
// (K14) or 14 plus the multiply (K15) over 12.6 M elements, ~0.9 GFLOP,
// 0.013 ms at 67 TFLOP/s.  So both are bound by bytes.
#include <math.h>

#include "fft_lines.cuh"

namespace lagomorph {

constexpr int kPlaneThreads = 1024;
constexpr int kRadixLineThreads = 256;

// the largest shared memory a block may opt into on the H100 (227 KB)
constexpr size_t kMaxBlockSmem = 232448;

enum RadixMode { RADIX_DIF = 0, RADIX_DIT = 1, RADIX_DIF_MUL_DIT = 2 };

__device__ __forceinline__ int ilog2(int n) { return 31 - __clz(n); }

// tw[t] = exp(2 pi i t / N) for t < N / 2
__device__ __forceinline__ void fill_half_twiddles(float2* tw, int N) {
  for (int t = threadIdx.x; t < N / 2; t += blockDim.x) {
    double sn, cs;
    sincospi(2.0 * (double)t / (double)N, &sn, &cs);
    tw[t] = make_float2((float)cs, (float)sn);
  }
}

// All radix-2 stages of `nlines` lines of length N (both powers of two) in
// shared memory, element n of line l at buf[l * ls + n * es]: DIF (natural
// in, bit-reversed out) or, with kDIT, DIT (bit-reversed in, natural out,
// the last stage scaled by `scale`).  sign = -1 forward, +1 inverse.  One
// butterfly per thread at a time, consecutive threads on consecutive lines
// when ls == 1 and on consecutive elements otherwise; every stage ends at a
// block barrier.
template <bool kDIT>
__device__ void radix_stages(float2* buf, int N, int nlines, int ls, int es,
                             const float2* __restrict__ tw, float sign, float scale) {
  const int lgN = ilog2(N);
  const int lgl = ilog2(nlines);
  const int half = N >> 1;
  const int total = half * nlines;
  const bool lines_fast = ls == 1;
  for (int st = 0; st < lgN; ++st) {
    const int lgs = kDIT ? st : lgN - 1 - st;
    const int s = 1 << lgs;
    const bool last = st == lgN - 1;
    for (int b = threadIdx.x; b < total; b += blockDim.x) {
      int line, q;
      if (lines_fast) {
        line = b & (nlines - 1);
        q = b >> lgl;
      } else {
        q = b & (half - 1);
        line = b >> (lgN - 1);
      }
      const int e = q & (s - 1);
      const int n = ((q >> lgs) << (lgs + 1)) + e;
      float2* p0 = buf + (long)line * ls + (long)n * es;
      float2* p1 = p0 + (long)s * es;
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

// K14 on whole planes: block b holds plane b (of the F*X planes of Y*Z
// values) of the real pair (in_re, in_im) in shared memory, runs the z and
// y stages and writes the plane to (out_re, out_im).
__global__ void __launch_bounds__(kPlaneThreads)
radix_zy_plane_kernel(const float* __restrict__ in_re, const float* __restrict__ in_im,
                      float* __restrict__ out_re, float* __restrict__ out_im, int Y, int Z,
                      int inverse) {
  extern __shared__ float2 smem[];
  float2* twZ = smem;        // Z / 2
  float2* twY = twZ + Z / 2;  // Y / 2
  float2* P = twY + Y / 2;   // Y * Z, [y][z]
  fill_half_twiddles(twZ, Z);
  fill_half_twiddles(twY, Y);
  const long YZ = (long)Y * Z;
  const long base = (long)blockIdx.x * YZ;
  for (long i = threadIdx.x; i < YZ; i += blockDim.x)
    P[i] = make_float2(in_re[base + i], in_im[base + i]);
  __syncthreads();
  if (!inverse) {
    radix_stages<false>(P, Z, Y, Z, 1, twZ, -1.0f, 1.0f);  // z: lines y, elements z
    radix_stages<false>(P, Y, Z, 1, Z, twY, -1.0f, 1.0f);  // y: lines z, elements y
  } else {
    radix_stages<true>(P, Y, Z, 1, Z, twY, 1.0f, 1.0f / Y);
    radix_stages<true>(P, Z, Y, Z, 1, twZ, 1.0f, 1.0f / Z);
  }
  for (long i = threadIdx.x; i < YZ; i += blockDim.x) {
    const float2 v = P[i];
    out_re[base + i] = v.x;
    out_im[base + i] = v.y;
  }
}

// One line pass: TJ lines per block (a power of two) of length N at stride
// `inner` in a volume viewed as (outer, N, inner), read from the real pair
// (in_re, in_im) and written to (out_re, out_im), which may be the same
// arrays (each block owns its lines).  Mode: DIF; DIT scaled by `scale`; or
// DIF, times `mult` (one (N, inner) slab, indexed like the bit-reversed
// lines), DIT scaled by `scale` (K15).
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
  if (mode == RADIX_DIT) {
    radix_stages<true>(S, N, TJ, 1, TP, tw, 1.0f, scale);
  } else {
    radix_stages<false>(S, N, TJ, 1, TP, tw, -1.0f, 1.0f);
    if (mode == RADIX_DIF_MUL_DIT) {
      for (int e = threadIdx.x; e < total; e += blockDim.x) {
        const int k = e / TJ, j = e - k * TJ;
        if (j < nl) {
          const float m = mult[(long)k * inner + (l0 + j) % inner];
          const float2 v = S[k * TP + j];
          S[k * TP + j] = make_float2(v.x * m, v.y * m);
        }
      }
      __syncthreads();
      radix_stages<true>(S, N, TJ, 1, TP, tw, 1.0f, scale);
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

static size_t plane_smem(int Y, int Z) {
  return ((size_t)Y / 2 + Z / 2 + (size_t)Y * Z) * sizeof(float2);
}

static size_t radix_line_smem(int N, int tj) {
  return ((size_t)N / 2 + (size_t)N * (tj + 1)) * sizeof(float2);
}

static int launch_lines(const float* in_re, const float* in_im, float* out_re, float* out_im,
                        const float* mult, long nlines, int N, long inner, int mode,
                        float scale, cudaStream_t stream) {
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

}  // namespace lagomorph

// K14.  re, im, out_re, out_im: (F, X, Y, Z) float32 (the output may not
// alias the input); inverse: 0 forward (DIF z then y, bit-reversed out), 1
// inverse (DIT y then z, 1/(Y Z), natural out).  Y, Z powers of two.
extern "C" int lagomorph_fluid_radix_zy(const float* re, const float* im, float* out_re,
                                        float* out_im, int F, int X, int Y, int Z,
                                        int inverse, void* stream_) {
  using namespace lagomorph;
  cudaStream_t stream = (cudaStream_t)stream_;
  const size_t smem = plane_smem(Y, Z);
  if (smem <= kMaxBlockSmem) {
    cudaError_t err = cudaFuncSetAttribute(
        radix_zy_plane_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    radix_zy_plane_kernel<<<(unsigned)((long)F * X), kPlaneThreads, smem, stream>>>(
        re, im, out_re, out_im, Y, Z, inverse);
    return (int)cudaGetLastError();
  }
  // two line passes, the second in place on the output
  const long FX = (long)F * X;
  int err;
  if (!inverse) {
    err = launch_lines(re, im, out_re, out_im, nullptr, FX * Y, Z, 1, RADIX_DIF, 1.0f, stream);
    if (err) return err;
    return launch_lines(out_re, out_im, out_re, out_im, nullptr, FX * Z, Y, Z, RADIX_DIF, 1.0f,
                        stream);
  }
  err = launch_lines(re, im, out_re, out_im, nullptr, FX * Z, Y, Z, RADIX_DIT, 1.0f / Y, stream);
  if (err) return err;
  return launch_lines(out_re, out_im, out_re, out_im, nullptr, FX * Y, Z, 1, RADIX_DIT,
                      1.0f / Z, stream);
}

// K15.  re, im, out_re, out_im: (F, X, Y, Z) float32 with bit-reversed y
// and z (K14's forward output); Mbr: (X, Y, Z), every axis bit-reversed.  X
// a power of two.
extern "C" int lagomorph_fluid_radix_x(const float* re, const float* im, const float* Mbr,
                                       float* out_re, float* out_im, int F, int X, int Y,
                                       int Z, void* stream) {
  using namespace lagomorph;
  const long YZ = (long)Y * Z;
  return launch_lines(re, im, out_re, out_im, Mbr, (long)F * YZ, X, YZ, RADIX_DIF_MUL_DIT,
                      1.0f / X, (cudaStream_t)stream);
}
