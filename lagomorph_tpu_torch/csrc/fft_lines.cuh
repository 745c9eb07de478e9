// Line transforms in shared memory, shared by K3 (fft_unit.cu), the 2D
// whole-shoot kernels K8/K9 (shoot2d.cu) and the whole-volume solve K16
// (fft_whole.cu).
//
// A block holds TJ lines of one axis in a shared-memory tile laid out
// [n][line] with row pitch TP = TJ + 1 (the padding keeps the transposing
// loads and stores free of bank conflicts).  An axis whose length is a
// power of two is transformed by a radix-2 Stockham FFT (log2 N stages,
// ping-pong between two tiles, results in natural order); any other length
// by the direct sum over n of x[n] * exp(-+2 pi i k n / N).  The twiddles
// come from a length-N table in shared memory, tw[t] = exp(2 pi i t / N),
// indexed by (k * n) mod N (direct) or p * s (radix-2), which fits any N.
// The warp's 32 lanes take 32 lines at one frequency (or one butterfly), so
// the twiddle read is a broadcast; a direct-sum thread sums kR frequencies
// at once to reuse each x[n] it reads from shared memory.
#pragma once

#include <cuda_runtime.h>

namespace lagomorph {

constexpr int kR = 4;  // frequencies per thread per sweep

// tw[t] = exp(2 pi i t / N) for t < N, computed in double
__device__ __forceinline__ void fill_twiddles(float2* tw, int N) {
  for (int t = threadIdx.x; t < N; t += blockDim.x) {
    double sn, cs;
    sincospi(2.0 * (double)t / (double)N, &sn, &cs);
    tw[t] = make_float2((float)cs, (float)sn);
  }
}

// element n of line l in a volume viewed as (outer, N, inner)
__device__ __forceinline__ long line_addr(long l, int n, int N, long inner) {
  const long o = l / inner;
  const long i = l - o * inner;
  return (o * N + n) * inner + i;
}

// O[k][j] = sum_n S[n][j] * exp(sign * 2 pi i k n / N), for the block's TJ
// lines; sign = -1 forward, +1 inverse.  Tiles have row pitch TP = TJ + 1
// (the padding keeps the transposing loads and stores free of bank
// conflicts).
__device__ __forceinline__ void dft_tile(const float2* __restrict__ S,
                                         float2* __restrict__ O,
                                         const float2* __restrict__ tw, int N,
                                         int TJ, float sign) {
  const int TP = TJ + 1;
  const int KS = blockDim.x / TJ;
  const int j = threadIdx.x % TJ;
  const int k0 = threadIdx.x / TJ;
  for (int kb = k0; kb < N; kb += KS * kR) {
    int kk[kR], ix[kR];
    float ar[kR], ai[kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = kb + r * KS;
      kk[r] = k < N ? k : 0;  // a masked frequency sums k = 0 and is dropped
      ix[r] = 0;
      ar[r] = 0.0f;
      ai[r] = 0.0f;
    }
    for (int n = 0; n < N; ++n) {
      const float2 x = S[n * TP + j];
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        const float2 w = tw[ix[r]];
        const float ws = sign * w.y;
        ar[r] = fmaf(x.x, w.x, fmaf(-x.y, ws, ar[r]));
        ai[r] = fmaf(x.y, w.x, fmaf(x.x, ws, ai[r]));
        ix[r] += kk[r];
        if (ix[r] >= N) ix[r] -= N;
      }
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int k = kb + r * KS;
      if (k < N) O[k * TP + j] = make_float2(ar[r], ai[r]);
    }
  }
}

// Radix-2 Stockham FFT of the TJ lines in `x` (N a power of two), using `y`
// as the other buffer of each stage; returns the buffer holding the result.
// Stage with half-length m and stride s: for p < m, q < s,
//   y[q + s*2p]     = a + b
//   y[q + s*(2p+1)] = (a - b) * exp(sign * 2 pi i p s / N)
// with a = x[q + s*p], b = x[q + s*(p + m)].
__device__ __forceinline__ float2* fft_tile(float2* x, float2* y,
                                            const float2* __restrict__ tw,
                                            int N, int TJ, float sign) {
  const int TP = TJ + 1;
  const int KS = blockDim.x / TJ;
  const int j = threadIdx.x % TJ;
  const int b0 = threadIdx.x / TJ;
  const int half = N >> 1;
  for (int s = 1, lg = 0; s < N; s <<= 1, ++lg) {
    const int m = half >> lg;  // half-length of this stage
    for (int b = b0; b < half; b += KS) {
      const int p = b >> lg;
      const int q = b & (s - 1);
      const float2 a = x[(q + s * p) * TP + j];
      const float2 c = x[(q + s * (p + m)) * TP + j];
      const float2 w = tw[p * s];
      const float ws = sign * w.y;
      const float dr = a.x - c.x, di = a.y - c.y;
      y[(q + 2 * s * p) * TP + j] = make_float2(a.x + c.x, a.y + c.y);
      y[(q + s * (2 * p + 1)) * TP + j] =
          make_float2(dr * w.x - di * ws, di * w.x + dr * ws);
    }
    __syncthreads();
    float2* t = x;
    x = y;
    y = t;
  }
  return x;
}

// One transform of the tile in `in`: radix-2 for a power-of-two N, else
// direct sums into `other`.  Returns the buffer holding the result; ends
// with the block synchronised.
__device__ __forceinline__ float2* transform_tile(float2* in, float2* other,
                                                  const float2* __restrict__ tw,
                                                  int N, int TJ, float sign) {
  if ((N & (N - 1)) == 0) return fft_tile(in, other, tw, N, TJ, sign);
  dft_tile(in, other, tw, N, TJ, sign);
  __syncthreads();
  return other;
}

enum InMode { IN_SPLIT = 0, IN_COMPLEX = 1 };
enum OutMode { OUT_SPLIT = 0, OUT_COMPLEX = 1 };

// One tile of a line pass: the lines l0 .. l0 + TJ - 1 (of nlines) of
// length N at stride `inner` (a volume viewed as (outer, N, inner)), read
// from the real pair (in_re, in_im) or the complex buffer cbuf, transformed
// in the tiles S and O (N rows of pitch TJ + 1 each) with the table tw of
// this N, and written, times `scale`, to the real pair (out_re, out_im) or
// back to cbuf (each tile owns its lines, so in place is safe).  With
// `mult` (one (N, inner) slab): forward transform, times mult, inverse
// transform; otherwise one transform of direction `sign`.  The caller
// synchronises the block before the next tile reuses S and O.
__device__ __forceinline__ void line_tile(const float* __restrict__ in_re,
                                          const float* __restrict__ in_im,
                                          float2* cbuf, float* out_re, float* out_im,
                                          const float* __restrict__ mult, int in_mode,
                                          int out_mode, long nlines, int N, long inner,
                                          int TJ, float sign, float scale, long l0,
                                          const float2* __restrict__ tw, float2* S,
                                          float2* O) {
  const int TP = TJ + 1;  // tile row pitch
  const int nl = nlines - l0 < TJ ? (int)(nlines - l0) : TJ;
  const bool contig = inner == 1;  // lines are contiguous rows (z axis)
  const int total = N * TJ;

  // load: consecutive threads on consecutive addresses
  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int j, n;
    if (contig) { j = e / N; n = e - j * N; } else { n = e / TJ; j = e - n * TJ; }
    float2 val = make_float2(0.0f, 0.0f);
    if (j < nl) {
      const long a = line_addr(l0 + j, n, N, inner);
      val = in_mode == IN_SPLIT ? make_float2(in_re[a], in_im[a]) : cbuf[a];
    }
    S[n * TP + j] = val;
  }
  __syncthreads();

  float2* res;
  if (mult != nullptr) {
    float2* F = transform_tile(S, O, tw, N, TJ, -1.0f);
    for (int e = threadIdx.x; e < total; e += blockDim.x) {
      const int k = e / TJ, j = e - k * TJ;
      if (j < nl) {
        const long l = l0 + j;
        const float m = mult[(long)k * inner + (l % inner)];
        const float2 v = F[k * TP + j];
        F[k * TP + j] = make_float2(v.x * m, v.y * m);
      }
    }
    __syncthreads();
    res = transform_tile(F, F == S ? O : S, tw, N, TJ, 1.0f);
  } else {
    res = transform_tile(S, O, tw, N, TJ, sign);
  }

  for (int e = threadIdx.x; e < total; e += blockDim.x) {
    int j, k;
    if (contig) { j = e / N; k = e - j * N; } else { k = e / TJ; j = e - k * TJ; }
    if (j < nl) {
      const long a = line_addr(l0 + j, k, N, inner);
      const float2 v = res[k * TP + j];
      if (out_mode == OUT_SPLIT) {
        out_re[a] = v.x * scale;
        out_im[a] = v.y * scale;
      } else {
        cbuf[a] = make_float2(v.x * scale, v.y * scale);
      }
    }
  }
}

// shared memory of one block of a line pass: the twiddle table and two
// tiles
static inline size_t line_smem_bytes(int N, int tj) {
  return (2L * N * (tj + 1) + N) * sizeof(float2);
}

// lines per block: the widest TJ whose tiles and table fit in 96 KB, so two
// blocks share an SM
static inline int line_pick_tj(int N) {
  for (int tj = 32; tj > 1; tj /= 2)
    if (line_smem_bytes(N, tj) <= 96 * 1024) return tj;
  return 1;
}

}  // namespace lagomorph
