// Register-resident line FFTs for a power-of-two length N (1 .. 256), used
// by the register passes of K3 and K16 (fft_plane.cuh).
//
// A group of G threads holds one line, R = N / G elements each (G <= R),
// and the transform is one four-step split of N = R * G:
//
//   X[k1 + R k2] = sum_g w_G^(g k2) * [ w_N^(g k1) * sum_r x[g + G r] w_R^(r k1) ]
//
// Thread g holds x[g + G r] for r < R ("distribution 1"), takes the length-R
// DFT over r in registers, multiplies by w_N^(g k1), and writes its R values
// to shared memory; after one barrier thread h reads, for each of its R / G
// frequencies k1 = h + G s, the G values of that k1 and takes a length-G DFT
// in registers, which leaves X[(h + G s) + R k2] in its register
// v[s G + k2] ("distribution 2").  The inverse runs the same steps backwards
// (distribution 2 in, distribution 1 out, conjugate twiddles), so a forward
// transform, a product in the frequency domain and an inverse need no
// reordering in between.  So each transform is one exchange through shared
// memory between two barriers, against log2(N) barrier-separated stages of
// a radix-2 tile.  The DFTs in registers are radix-2 decimation in
// frequency with their twiddles as constants (at most 16 points, so the
// angles are multiples of 2 pi / 16), the outputs put back in natural
// order by register renaming; the twiddles between the two steps come from
// the table tw[t] = exp(2 pi i t / N) in shared memory (fill_twiddles,
// fft_lines.cuh, computed in double).
//
// Where a line's values sit in shared memory is the caller's: a `Slots`
// type maps the exchange index p = k1 * G + g of one line to a float2&
// (`at(p)`), so that the thread layout of a pass can keep its accesses free
// of bank conflicts.
#pragma once

#include <cuda_runtime.h>

namespace lagomorph {

__host__ __device__ constexpr int ilog2(int n) { return n <= 1 ? 0 : 1 + ilog2(n / 2); }

// the low BITS bits of i reversed (a template, so that every level inlines
// and a constant i folds: register arrays indexed by it stay in registers)
template <int BITS>
__device__ __forceinline__ int bitrev(int i) {
  if constexpr (BITS == 0) {
    return 0;
  } else {
    return ((i & 1) << (BITS - 1)) | bitrev<BITS - 1>(i >> 1);
  }
}

// The split of one line of length N over G threads of R elements each:
// one thread up to 16 points, then 4 x 8 (N = 32), 8 x 8, 8 x 16, 16 x 16.
__host__ __device__ constexpr int reg_group(int N) {
  return N <= 16 ? 1 : N == 32 ? 4 : N <= 128 ? 8 : 16;
}
template <int N>
struct RegPlan {
  static_assert(N >= 1 && N <= 256 && (N & (N - 1)) == 0, "N: a power of two up to 256");
  static constexpr int G = reg_group(N);
  static constexpr int R = N / G;
};

// Every rounding of the transforms is spelled out (__fadd_rn, __fmul_rn,
// __fmaf_rn), so that the compiler fuses no product into a sum on its own:
// which product of a sum it would fuse depends on the code around it, and
// the kernels that share these transforms (K3, K16) then round alike.
__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y));
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y));
}
// a * v, one rounding
__device__ __forceinline__ float2 cscale(float2 a, float v) {
  return make_float2(__fmul_rn(a.x, v), __fmul_rn(a.y, v));
}
// a * w (INV) or a * conj(w) (forward): one product rounded, the other fused
template <bool INV>
__device__ __forceinline__ float2 cmul_tw(float2 a, float2 w) {
  const float s = INV ? w.y : -w.y;
  return make_float2(__fmaf_rn(a.x, w.x, -__fmul_rn(a.y, s)),
                     __fmaf_rn(a.x, s, __fmul_rn(a.y, w.x)));
}

// cos(2 pi m / 16) for 0 <= m <= 4
__device__ __forceinline__ float cos16(int m) {
  return m == 0 ? 1.0f : m == 1 ? 0.923879533f : m == 2 ? 0.707106781f
                                : m == 3 ? 0.382683432f : 0.0f;
}

// v * exp(-+2 pi i e / 16) for 0 <= e < 8 (minus forward, plus INV); e is
// a constant once the caller's loops are unrolled, so the branches fold
template <bool INV>
__device__ __forceinline__ float2 rot16(float2 v, int e) {
  if (e == 0) return v;
  if (e == 4) return INV ? make_float2(-v.y, v.x) : make_float2(v.y, -v.x);
  const float c = e < 4 ? cos16(e) : -cos16(8 - e);
  const float s = e < 4 ? cos16(4 - e) : cos16(e - 4);  // sin(2 pi e / 16) >= 0
  return cmul_tw<INV>(v, make_float2(c, s));
}

// In-place DFT of R <= 16 points in registers, natural order in and out:
// a[k] = sum_n a[n] exp(-+2 pi i n k / R).  Radix-2 decimation in
// frequency, then the bit-reversal permutation (constant indices: register
// renaming, no moves once unrolled).
template <int R, bool INV>
__device__ __forceinline__ void dft_reg(float2 (&a)[R]) {
  static_assert(R >= 1 && R <= 16 && (R & (R - 1)) == 0, "R: a power of two up to 16");
  constexpr int LOG = ilog2(R);
#pragma unroll
  for (int st = 0; st < LOG; ++st) {
    const int half = R >> (st + 1);
#pragma unroll
    for (int b = 0; b < R / 2; ++b) {
      const int q = b % half;
      const int i0 = (b / half) * 2 * half + q;
      const float2 u = a[i0], w = a[i0 + half];
      a[i0] = cadd(u, w);
      a[i0 + half] = rot16<INV>(csub(u, w), q * (8 / half));
    }
  }
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int r = bitrev<LOG>(i);
    if (r > i) {
      const float2 t = a[i];
      a[i] = a[r];
      a[r] = t;
    }
  }
}

// Element index of register e in distribution 1 (x[g + G e]) and in
// distribution 2 (X[(g + G s) + R k2], e = s G + k2) of thread g.
template <int N>
__device__ __forceinline__ int dist1_index(int g, int e) {
  return g + RegPlan<N>::G * e;
}
template <int N>
__device__ __forceinline__ int dist2_index(int g, int e) {
  constexpr int G = RegPlan<N>::G, R = RegPlan<N>::R;
  return g + G * (e / G) + R * (e % G);
}

// Forward transform of one line: v in distribution 1 -> distribution 2.
// With G > 1 every thread of the block calls it (it holds two barriers:
// the first orders this exchange after the previous one's reads and
// publishes the twiddle table, which is read only after it).
template <int N, class Slots>
__device__ __forceinline__ void fft_fwd_reg(float2 (&v)[RegPlan<N>::R], int g,
                                            const Slots& sl, const float2* tw) {
  constexpr int G = RegPlan<N>::G, R = RegPlan<N>::R;
  dft_reg<R, false>(v);
  if constexpr (G > 1) {
    __syncthreads();
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1)
      sl.at(k1 * G + g) = k1 == 0 ? v[0] : cmul_tw<false>(v[k1], tw[g * k1]);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < R / G; ++s) {
      float2 w[G];
#pragma unroll
      for (int q = 0; q < G; ++q) w[q] = sl.at((g + G * s) * G + q);
      dft_reg<G, false>(w);
#pragma unroll
      for (int q = 0; q < G; ++q) v[s * G + q] = w[q];
    }
  }
}

// Inverse transform of one line (unnormalised): v in distribution 2 ->
// distribution 1, the steps of fft_fwd_reg in reverse with conjugate
// twiddles.  Same barriers.
template <int N, class Slots>
__device__ __forceinline__ void fft_inv_reg(float2 (&v)[RegPlan<N>::R], int g,
                                            const Slots& sl, const float2* tw) {
  constexpr int G = RegPlan<N>::G, R = RegPlan<N>::R;
  if constexpr (G > 1) {
#pragma unroll
    for (int s = 0; s < R / G; ++s) {
      float2 w[G];
#pragma unroll
      for (int q = 0; q < G; ++q) w[q] = v[s * G + q];
      dft_reg<G, true>(w);
#pragma unroll
      for (int q = 0; q < G; ++q) v[s * G + q] = w[q];
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < R / G; ++s) {
      const int k1 = g + G * s;
#pragma unroll
      for (int q = 0; q < G; ++q)
        sl.at(k1 * G + q) = q == 0 ? v[s * G] : cmul_tw<true>(v[s * G + q], tw[q * k1]);
    }
    __syncthreads();
#pragma unroll
    for (int k1 = 0; k1 < R; ++k1) v[k1] = sl.at(k1 * G + g);
  }
  dft_reg<R, true>(v);
}

}  // namespace lagomorph
