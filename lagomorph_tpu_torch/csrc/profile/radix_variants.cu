// Variants of K14's memory layouts, for profile_radix.py only (not part of
// the kernel library; built by that script).  Each computes K14 with the
// same arithmetic as csrc/fft_radix.cu and moves only where the spectrum
// sits on its way, so its output is bit-equal to K14's:
//
//   plain_slot_plane_kernel: the plane path (plane_pass with BR,
//     csrc/fft_plane.cuh) with the transpose's slots at plain z, not
//     plane_slot's swizzle: the G lanes of a row write slots R apart;
//   elementwise_row_kernel: the line path's z pass (reg_pass with BR on
//     rows) loading and storing the bit-reversed spectrum element by
//     element, not through the line's exchange slots.
#include "../fft_radix.cu"

namespace lagomorph_profile {
using namespace lagomorph;

template <int P, bool INV>
__global__ void __launch_bounds__(P * RegPlan<P>::G)
    plain_slot_plane_kernel(const float* in_re, const float* in_im, float* out_re,
                            float* out_im, float scale) {
  constexpr int G = RegPlan<P>::G, R = RegPlan<P>::R, PT = P + 8;
  extern __shared__ float2 smem[];
  const float2* tw = smem;
  float2* S = smem + P;
  fill_twiddles(smem, P);
  const long plane = (long)blockIdx.x * P * P;
  const int t = thread_index();
  const int ry = t / G, rg = t % G, cz = t % P, cg = t / P;
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
    for (int e = 0; e < R; ++e) S[ry * PT + dist2_bitrev<P>(rg, e)] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = S[dist1_index<P>(cg, e) * PT + cz];
    fft_fwd_reg<P>(v, cg, cols, tw);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + dist2_bitrev<P>(cg, e) * P + cz;
      out_re[a] = v[e].x;
      out_im[a] = v[e].y;
    }
  } else {
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + dist2_bitrev<P>(cg, e) * P + cz;
      v[e] = make_float2(in_re[a], in_im[a]);
    }
    fft_inv_reg<P>(v, cg, cols, tw);
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) S[dist1_index<P>(cg, e) * PT + cz] = v[e];
    __syncthreads();
#pragma unroll
    for (int e = 0; e < R; ++e) v[e] = S[ry * PT + dist2_bitrev<P>(rg, e)];
    fft_inv_reg<P>(v, rg, rows, tw);
#pragma unroll
    for (int e = 0; e < R; ++e) {
      const long a = plane + ry * P + dist1_index<P>(rg, e);
      out_re[a] = __fmul_rn(v[e].x, scale);
      out_im[a] = __fmul_rn(v[e].y, scale);
    }
  }
}

// z rows of length N (G > 1), forward (natural in, bit-reversed out) or
// inverse (bit-reversed in, natural out, times scale), element by element
template <int N>
__global__ void __launch_bounds__(kRegThreads)
    elementwise_row_kernel(const float* in_re, const float* in_im, float* out_re, float* out_im,
                           long nlines, int inverse, float scale) {
  constexpr int G = RegPlan<N>::G, R = RegPlan<N>::R, L = kRegThreads / G;
  extern __shared__ float2 smem[];
  const float2* tw = smem;
  fill_twiddles(smem, N);
  const int t = thread_index(), g = t % G, j = t / G;
  const long l = (long)blockIdx.x * L + j;
  const bool live = l < nlines;
  const RowSlots sl{smem + N, row_pitch(N), j};
  float2 v[R];
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const long a = l * N + (inverse ? dist2_bitrev<N>(g, e) : dist1_index<N>(g, e));
    v[e] = live ? make_float2(in_re[a], in_im[a]) : make_float2(0.0f, 0.0f);
  }
  if (inverse)
    fft_inv_reg<N>(v, g, sl, tw);
  else
    fft_fwd_reg<N>(v, g, sl, tw);
  if (!live) return;
#pragma unroll
  for (int e = 0; e < R; ++e) {
    const long a = l * N + (inverse ? dist1_index<N>(g, e) : dist2_bitrev<N>(g, e));
    out_re[a] = __fmul_rn(v[e].x, scale);
    out_im[a] = __fmul_rn(v[e].y, scale);
  }
}

template <int P>
static int launch_plain_plane(const float* re, const float* im, float* out_re, float* out_im,
                              long planes, bool inverse, float scale, cudaStream_t stream) {
  const size_t smem = (size_t)(P + plane_slots(P)) * sizeof(float2);
  auto kernel = inverse ? plain_slot_plane_kernel<P, true> : plain_slot_plane_kernel<P, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)planes, P * RegPlan<P>::G, smem, stream>>>(re, im, out_re, out_im, scale);
  return (int)cudaGetLastError();
}

template <int N>
static int launch_elementwise_rows(const float* re, const float* im, float* out_re,
                                   float* out_im, long nlines, int inverse, float scale,
                                   cudaStream_t stream) {
  constexpr int L = kRegThreads / RegPlan<N>::G;
  const size_t smem = (N + (size_t)L * row_pitch(N)) * sizeof(float2);
  elementwise_row_kernel<N><<<(unsigned)((nlines + L - 1) / L), kRegThreads, smem, stream>>>(
      re, im, out_re, out_im, nlines, inverse, scale);
  return (int)cudaGetLastError();
}

static int elementwise_rows(int Z, const float* re, const float* im, float* out_re,
                            float* out_im, long nlines, int inverse, float scale,
                            cudaStream_t stream) {
  auto launch = Z == 64    ? launch_elementwise_rows<64>
                : Z == 128 ? launch_elementwise_rows<128>
                : Z == 256 ? launch_elementwise_rows<256>
                           : nullptr;
  if (launch == nullptr) return (int)cudaErrorInvalidValue;
  return launch(re, im, out_re, out_im, nlines, inverse, scale, stream);
}

}  // namespace lagomorph_profile

// K14 (lagomorph_fluid_radix_zy's arguments) with its variant layout: the
// plain transpose slots where Y == Z in {64, 128}, else element-wise z rows
// (Z in {64, 128, 256}) around the library's y pass.
extern "C" int prof_radix_zy_variant(const float* re, const float* im, float* out_re,
                                     float* out_im, int F, int X, int Y, int Z, int inverse,
                                     void* stream_) {
  using namespace lagomorph_profile;
  cudaStream_t stream = (cudaStream_t)stream_;
  const long FX = (long)F * X;
  const float scale = inverse ? 1.0f / (float)((long)Y * Z) : 1.0f;
  if (plane_axes(Y, Z)) {
    auto launch = Y == 64 ? launch_plain_plane<64> : launch_plain_plane<128>;
    return launch(re, im, out_re, out_im, FX, inverse, scale, stream);
  }
  int err;
  if (!inverse) {
    err = elementwise_rows(Z, re, im, out_re, out_im, FX * Y, 0, 1.0f, stream);
    if (err) return err;
    return axis_pass(Y, out_re, out_im, out_re, out_im, nullptr, FX * Z, Z, REG_FWD, 1.0f,
                     stream);
  }
  err = axis_pass(Y, re, im, out_re, out_im, nullptr, FX * Z, Z, REG_INV, 1.0f, stream);
  if (err) return err;
  return elementwise_rows(Z, out_re, out_im, out_re, out_im, FX * Y, 1, scale, stream);
}
