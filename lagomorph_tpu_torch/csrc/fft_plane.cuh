// The register passes of the fluid solve on packed pairs, shared by K3
// (fft_unit.cu: one launch per pass), K16 (fft_whole.cu: the same passes
// as the phases of one cooperative launch, between grid-wide barriers) and
// K14/K15 (fft_radix.cu: the same passes with bit-reversed spectra, BR
// below).  All run the same arithmetic in the same order, so on these
// paths K16 and the radix pipeline are bit-identical to K3.
//
// * reg_pass: one line of length N (a power of two up to 256) at stride
//   `inner`, held by G threads in registers (fft_reg.cuh), one transform or
//   a forward transform, a product by the multiplier and the inverse;
//   reg_lines maps a group of THREADS / G lines onto a block's threads.
// * plane_pass: one (y, z) plane of P x P (P in 64, 128) held by a block of
//   P * G threads in registers, z then y forward, or y then z inverse.
//
// With BR (the radix-2 solve K14/K15, fft_radix.cu) the spectrum side of a
// pass is in bit-reversed order: a forward transform stores frequency k at
// position bitrev(k), an inverse reads it from there, and the multiplier
// is read at the bit-reversed frequency (dist2_bitrev, fft_reg.cuh).  The
// arithmetic is the same, only addresses and shared-memory slots move, so
// K14, K15, K14 round as K3's passes do.
//
// Every pass reads all of its lines or its plane into registers before its
// first barrier and writes only them after its last, so it may run in place,
// and a block may run several in turn on one shared-memory buffer: the first
// barrier of each exchange orders its slot writes after the previous pass's
// reads.  A pass past the last line (`live` false) still takes every
// barrier.  The twiddle tables are the caller's (fill_twiddles,
// fft_lines.cuh), published by the first exchange's first barrier.
#pragma once

#include "fft_reg.cuh"

namespace lagomorph {

constexpr int kRegThreads = 256;  // block size of the line passes
enum RegMode { REG_FWD = 0, REG_INV = 1, REG_MUL = 2 };

// threadIdx.x, read anew at each call.  A pass run in a loop (K16's
// grid-stride phases) then computes its thread's indices and slot
// addresses in each iteration: the compiler cannot hoist them out of the
// loop, where they would hold registers through every phase of the kernel
// (at P = 128 they spilled).
__device__ __forceinline__ int thread_index() {
#ifdef __CUDA_ARCH__
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
#else
  return threadIdx.x;
#endif
}

// Exchange slots of a strided pass: lane j of a warp is line j, slot p of
// every line of the block at one row p * L + j, so a warp's accesses are
// neighbouring float2s.
struct LineSlots {
  float2* S;
  int L, j;
  __device__ __forceinline__ float2& at(int p) const { return S[p * L + j]; }
};

// Exchange slots of a contiguous (z) pass: the G threads of a line are
// neighbouring lanes; line j's slots in a row of pitch row_pitch(N), slot p
// at p + p / 16.  With G = 8 the 8 lanes of a line touch 8 distinct bank
// pairs in both directions of the exchange (p = k1 G + g over g, and over
// h at stride G), and a pitch of 4 mod 16 float2s spreads a warp's 4 lines
// over the other pairs.
struct RowSlots {
  float2* S;
  int PL, j;
  __device__ __forceinline__ float2& at(int p) const { return S[j * PL + p + (p >> 4)]; }
};

__host__ __device__ constexpr int row_pitch(int N) {
  return N + N / 16 + (20 - (N + N / 16) % 16) % 16;
}

// float2 slots of the exchange of THREADS threads on lines of length N (none
// with one thread a line)
__host__ __device__ constexpr int reg_slots(int N, bool rows, int threads) {
  return reg_group(N) == 1 ? 0 : threads / reg_group(N) * (rows ? row_pitch(N) : N);
}

// the lengths of the register passes, and the square planes of the plane pass
inline bool reg_axis(int n) { return n >= 1 && n <= 256 && (n & (n - 1)) == 0; }
inline bool plane_axes(int Y, int Z) { return Y == Z && (Y == 64 || Y == 128); }

// One line of length N at stride `inner` (a field viewed as (outer, N,
// inner)), held by thread g of its G.  REG_FWD: forward transform
// (distribution 1 in, 2 out); REG_INV: inverse (2 in, 1 out); REG_MUL:
// forward, times `mult` (one (N, inner) slab), inverse.  Reads the pair
// (in_re, in_im), writes (out_re, out_im) times `scale`; the two may be the
// same arrays.  ROWS: the lines are contiguous (inner == 1), and the G
// threads of a line are neighbouring lanes; otherwise each lane of a warp
// takes one line.  BR: the spectrum (REG_FWD's output, REG_INV's input,
// the index of `mult`) in bit-reversed order.
template <int N, bool ROWS, bool BR, class Slots>
__device__ __forceinline__ void reg_pass(const float* in_re, const float* in_im, float* out_re,
                                         float* out_im, const float* __restrict__ mult,
                                         long nlines, long inner, int mode, float scale,
                                         const Slots& sl, const float2* tw, int g, long l) {
  constexpr int R = RegPlan<N>::R;
  const bool live = l < nlines;
  const long stride = ROWS ? 1 : inner;  // a constant for rows: offsets in the instruction
  const long o = ROWS ? l : l / inner;
  const long i = ROWS ? 0 : l - o * inner;
  const long base = o * N * stride + i;  // element n of line l at base + n * stride
  // BR rows (z lines, G > 1): a thread's R spectrum positions are
  // neighbours (dist2_bitrev), so element by element a warp's lanes would
  // touch one word in each of up to 32 sectors.  The spectrum moves through
  // the line's exchange slots instead, and device memory sees the lanes on
  // neighbouring words, as in K3's passes.
  constexpr bool kStage = ROWS && BR && RegPlan<N>::G > 1;
  float2 v[R];
  if (kStage && mode == REG_INV) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int p = dist1_index<N>(g, e);
      sl.at(p) = live ? make_float2(in_re[base + p], in_im[base + p]) : make_float2(0.0f, 0.0f);
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = sl.at(dist2_bitrev<N>(g, e));
  } else {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const int n = mode == REG_INV ? dist2_at<N, BR>(g, e) : dist1_index<N>(g, e);
      const long a = base + n * stride;
      v[e] = live ? make_float2(in_re[a], in_im[a]) : make_float2(0.0f, 0.0f);
    }
  }
  bool natural = true;  // v in distribution 1
  if (mode == REG_INV) {
    fft_inv_reg<N>(v, g, sl, tw);
  } else {
    fft_fwd_reg<N>(v, g, sl, tw);
    natural = false;
    if (mode == REG_MUL) {
#pragma unroll
      for (int e = 0; e < R; ++e) {
        const float m = live ? mult[dist2_at<N, BR>(g, e) * stride + i] : 0.0f;
        v[e] = cscale(v[e], m);
      }
      fft_inv_reg<N>(v, g, sl, tw);
      natural = true;
    }
  }
  if (kStage && !natural) {
    __syncthreads();  // the transform's reads of the slots are done
#pragma unroll
    for (int e = 0; e < R; ++e) sl.at(dist2_bitrev<N>(g, e)) = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = sl.at(dist1_index<N>(g, e));
    natural = true;  // now at the positions of distribution 1
  }
  if (!live) return;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const int k = natural ? dist1_index<N>(g, e) : dist2_at<N, BR>(g, e);
    const long a = base + k * stride;
    out_re[a] = __fmul_rn(v[e].x, scale);
    out_im[a] = __fmul_rn(v[e].y, scale);
  }
}

// Group `group` of L = THREADS / G lines, one reg_pass per line, on a block
// of THREADS threads; S holds the exchange (reg_slots), row_pl its row
// pitch when ROWS.
template <int N, bool ROWS, int THREADS, bool BR = false>
__device__ __forceinline__ void reg_lines(const float* in_re, const float* in_im, float* out_re,
                                          float* out_im, const float* __restrict__ mult,
                                          long nlines, long inner, int mode, float scale,
                                          float2* S, const float2* tw, int row_pl, long group) {
  constexpr int G = RegPlan<N>::G, L = THREADS / G;
  const int t = thread_index();
  const int g = ROWS ? t % G : t / L;
  const int j = ROWS ? t / G : t % L;
  const long l = group * L + j;
  if (ROWS)
    reg_pass<N, ROWS, BR>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale,
                          RowSlots{S, row_pl, j}, tw, g, l);
  else
    reg_pass<N, ROWS, BR>(in_re, in_im, out_re, out_im, mult, nlines, inner, mode, scale,
                          LineSlots{S, L, j}, tw, g, l);
}

// float2 slots of a plane pass: the row exchanges and the transpose (pitch
// P + 8) take turns in one buffer
__host__ __device__ constexpr int plane_slots(int P) {
  return P * row_pitch(P) > P * (P + 8) ? P * row_pitch(P) : P * (P + 8);
}

// Slot of z-position z in a row of the transpose.  Natural order: z.  BR: a
// row thread's R frequencies sit at R bitrev(g) + c, so for one register
// the G lanes of a row would write slots R apart, on one bank pair (an
// 8-way conflict at P = 128); z ^ (z / R) moves each R-run's slots by its
// run index (z / R < G <= R, so the slot stays in the run), which puts the
// G writes on G distinct bank pairs and keeps the columns' reads, 16
// neighbouring z of a half-warp, a permutation of 16 neighbouring slots.
template <int P, bool BR>
__device__ __forceinline__ int plane_slot(int z) {
  if constexpr (BR) {
    return z ^ (z / RegPlan<P>::R);
  } else {
    return z;
  }
}

// One (f, x) plane of P x P at offset `plane`, on a block of P * G
// threads.  INV false: z forward then y forward, read from (in_re, in_im)
// and written to (out_re, out_im).  INV: y inverse then z inverse, times
// `scale`.  P * G threads hold the plane, R = P / G elements each: first as
// rows (G neighbouring lanes a z-row, RowSlots), then, after a transpose
// through shared memory (pitch P + 8: a warp's 4 row segments fall on
// distinct bank pairs), as columns (one lane a y-column, LineSlots).  S
// holds plane_slots(P) float2, tw the length-P table.  BR: the spectrum in
// bit-reversed y and z order.  The y permutation is the column threads'
// row addresses (dist2_bitrev: lanes still run over z, so loads and stores
// stay coalesced); the z permutation is done at the transpose, where a row
// thread puts frequency k in the column of position bitrev(k), so column
// thread cz holds the frequency of position cz.
template <int P, bool INV, bool BR = false>
__device__ __forceinline__ void plane_pass(const float* in_re, const float* in_im, float* out_re,
                                           float* out_im, float scale, long plane, float2* S,
                                           const float2* tw) {
  constexpr int G = RegPlan<P>::G, R = RegPlan<P>::R, PT = P + 8;
  const int t = thread_index();
  const int ry = t / G, rg = t % G;  // rows: z-row ry, thread rg of its G
  const int cz = t % P, cg = t / P;  // columns: y-column cz, thread cg of its G
  const RowSlots rows{S, row_pitch(P), ry};
  const LineSlots cols{S, P, cz};
  float2 v[R];
  if (!INV) {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + ry * P + dist1_index<P>(rg, e);
      v[e] = make_float2(in_re[a], in_im[a]);
    }
    fft_fwd_reg<P>(v, rg, rows, tw);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) S[ry * PT + plane_slot<P, BR>(dist2_at<P, BR>(rg, e))] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = S[dist1_index<P>(cg, e) * PT + plane_slot<P, BR>(cz)];
    fft_fwd_reg<P>(v, cg, cols, tw);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + dist2_at<P, BR>(cg, e) * P + cz;
      out_re[a] = v[e].x;
      out_im[a] = v[e].y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + dist2_at<P, BR>(cg, e) * P + cz;
      v[e] = make_float2(in_re[a], in_im[a]);
    }
    fft_inv_reg<P>(v, cg, cols, tw);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) S[dist1_index<P>(cg, e) * PT + plane_slot<P, BR>(cz)] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = S[ry * PT + plane_slot<P, BR>(dist2_at<P, BR>(rg, e))];
    fft_inv_reg<P>(v, rg, rows, tw);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + ry * P + dist1_index<P>(rg, e);
      out_re[a] = __fmul_rn(v[e].x, scale);
      out_im[a] = __fmul_rn(v[e].y, scale);
    }
  }
}

}  // namespace lagomorph
