// K1 and K2: the two stencil steps of one EPDiff substep, forward, each
// with the unit-regime flag of its warp displacement.
//
// K1, Ad* (the momentum transport):
//   mw_a(p)  = sum_o w_o(phiinv(p)) * m0_a(clamp(p + o))        (unit warp)
//   out_c(p) = sum_a (D_a phiinv_c(p) + delta_ca) * mw_a(p)      (Jacobian)
//   flag     = all components of phiinv in [-1, 1)
// i.e. jacobian_times_vectorfield(phiinv, sample_displacement_unit(m0,
// phiinv), displacement=True), without transpose.  Replaces
// lagomorph_tpu/ops/pallas/epdiff_unit.py `_adstar_fwd_kernel[_mw]`
// (whole-Y, `_adstar_fwd_wholey`), `_adstar_fwd_kernel_yb[_mw]` /
// `_adstar_yb_fwd_body` (y-blocked, `_adstar_fwd_yb`), and the padded-
// resident lagomorph_tpu/ops/pallas/padres.py `_adstar_fwd_kernel_pr[_mw]`
// (`_adstar_fwd_pr`), whose in-kernel flag (padres.py:211-227) is K1's flag.
//
// K2, compose (the update of the inverse deformation):
//   d(p)     = s * v(p)                                           (float32)
//   out_c(p) = d_c(p) + sum_o w_o(d(p)) * phiinv_c(clamp(p + o))
//   flag     = all components of d in [-1, 1)
// Replaces epdiff_unit.py `_compose_fwd_kernel[_yb]` / `_compose_yb_fwd_body`
// (`_compose_fwd_dispatch`) and padres.py `_compose_fwd_kernel_pr`
// (`_compose_fwd_pr`, `_store_padded`).
//
// Not carried over: padres.py keeps phiinv in a padded (N,3,X+16,(Y+4)*Z)
// layout through the whole shooting loop.  That layout exists only for the
// TPU's (8,128) DMA alignment (padres.py:1-12, 58-59); here taps clamp in the
// kernel and the carry stays (N,3,X,Y,Z).  The TPU carries the flag as a
// running min from one sequential grid step to the next; Hopper's blocks run
// in no order, so the flag is an int32 in device memory that the wrapper
// sets to 1 and any warp that sees an out-of-range component clears with
// atomicAnd.
//
// Bound on the H100: memory.  K1 reads phiinv and m0 and writes out (three
// 100.7 MB fields at 128^3 b4, m0 read with batch stride 0 when its batch is
// 1); K2 reads phiinv and v and writes out (three fields).  The 27 taps and
// the 6 difference neighbours come from L1/L2.  Design: one thread per voxel,
// z fastest across the warp; weights and tap offsets computed once per voxel
// and reused for all three channels; the flag costs one ballot per warp and
// at most one atomic per warp.  When autograd needs it, K1 also writes the
// warped momentum mw (the `_mw` variants' residual, epdiff_unit.py:214,
// padres.py:249), which K6 reads instead of re-enumerating the warp; the
// forward-only path passes no mw buffer and moves no extra bytes.
//
// K6, Ad* backward (cotangent g of out; math at epdiff_unit.py:459-497):
//   d_mw  = (J + I)^T g                               (pointwise)
//   d_m0  = warp transpose of d_mw at weights(phiinv)  (gather form)
//   d_phi = weight-gradient path (image m0, cotangent d_mw)
//           + sum_a D_a^T (g * mw_a)                   (divergence path)
// Replaces epdiff_unit.py `_adstar_bwd_fused_dispatch` (kernels
// `_adstar_bwd_kernel`, `_adstar_bwd_kernel_yb`, body `_adstar_yb_bwd_body`)
// and padres.py `_adstar_bwd_pr` (`_adstar_bwd_kernel_pr`).  Two passes: the
// first computes d_mw, writes it to a scratch field, and finishes d_phi (it
// needs d_mw only at its own voxel); the second is the gather transpose of
// d_mw (warp_unit.cu), which needs d_mw at 27 neighbours.  Recomputing d_mw
// at every neighbour instead would save the scratch round trip (2 x 100.7 MB
// at 128^3 b4) at 27x the Jacobian work; the two-pass form is the simple
// one.  A batch-1 m0 gets d_m0 summed over N in the gather, no atomics.
//
// K7, compose backward (cotangent g of out = s v + phi(x + s v); math at
// epdiff_unit.py:711-725, padres.py:518-551):
//   d_phi = warp transpose of g at weights(s v)
//   d_v   = s g + s * (weight-gradient path, image phi, cotangent g)
// Replaces epdiff_unit.py `_compose_bwd_fused_dispatch` (`_compose_bwd_kernel`,
// `_compose_bwd_kernel_yb`, body `_compose_yb_bwd_body`) and padres.py
// `_compose_bwd_pr` (`_compose_bwd_kernel_pr`).  s v is formed in each pass
// with the forward's rounding (__fmul_rn), never stored.
//
// Bound on the H100 (128^3 b4, 100.7 MB per 3-channel field): K6 must move
// 6 fields (read phi, m0, g, mw; write d_phi, d_m0), ~180 us at 3.35 TB/s;
// its two passes move 11 (the scratch d_mw and a second read of phi).  K7
// must move 5 (read phi, v, g; write d_phi, d_v), ~150 us; its passes move
// 7.  The transpose and weight-gradient passes are K5's (warp_unit.cu:
// bricks staged in shared memory with a halo, the 8 live taps); K6's first
// pass stays one thread per voxel.
#include "stencil.cuh"

namespace lagomorph {

__device__ __forceinline__ void clear_flag_if(bool bad, int* flag) {
  const unsigned any = __ballot_sync(0xffffffffu, bad);
  if (any && (threadIdx.x & 31) == 0) atomicAnd(flag, 0);
}

__global__ void ad_star_fwd_kernel(const float* __restrict__ phiinv,
                                   const float* __restrict__ m0,
                                   float* __restrict__ out,
                                   float* __restrict__ mw_out, int* flag, int N,
                                   int Nm, int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));
    const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);

    const float* ph = phiinv + (long)n * 3 * V;
    const float d0 = ph[p], d1 = ph[V + p], d2 = ph[2 * V + p];
    bad = !(in_unit(d0) && in_unit(d1) && in_unit(d2));

    AxisWeights W[3] = {axis_weights(d0), axis_weights(d1), axis_weights(d2)};
    Taps T;
    make_taps(T, W, ix, iy, iz, Y, Z);
    const float* mb = m0 + (Nm == 1 ? 0L : (long)n * 3 * V);
    float mw[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) mw[a] = warp_sum(T, mb + (long)a * V);
    if (mw_out != nullptr) {
      float* w = mw_out + (long)n * 3 * V + p;
#pragma unroll
      for (int a = 0; a < 3; ++a) w[(long)a * V] = mw[a];
    }

    // out_c = sum_a (g_ca [+1 if a == c]) * mw_a, accumulated over a in order
    const AxisIdx* ax[3] = {&ix, &iy, &iz};
    const int stride[3] = {Y * Z, Z, 1};
    float* o = out + (long)n * 3 * V + p;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float g = diff_central(ph + (long)c * V, p, *ax[a], stride[a]);
        if (a == c) g = __fadd_rn(g, 1.0f);
        const float term = __fmul_rn(g, mw[a]);
        acc = a == 0 ? term : __fadd_rn(acc, term);
      }
      o[(long)c * V] = acc;
    }
  }
  clear_flag_if(bad, flag);
}

__global__ void compose_fwd_kernel(const float* __restrict__ phiinv,
                                   const float* __restrict__ v, float s,
                                   float* __restrict__ out, int* flag, int N,
                                   int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  bool bad = false;
  if (idx < (long)N * V) {
    const int n = (int)(idx / V);
    const long p = idx - (long)n * V;
    const int z = (int)(p % Z);
    const int y = (int)((p / Z) % Y);
    const int x = (int)(p / ((long)Y * Z));

    const float* vb = v + (long)n * 3 * V + p;
    const float d0 = __fmul_rn(s, vb[0]);
    const float d1 = __fmul_rn(s, vb[V]);
    const float d2 = __fmul_rn(s, vb[2 * V]);
    bad = !(in_unit(d0) && in_unit(d1) && in_unit(d2));

    AxisWeights W[3] = {axis_weights(d0), axis_weights(d1), axis_weights(d2)};
    Taps T;
    make_taps(T, W, axis_idx(x, X), axis_idx(y, Y), axis_idx(z, Z), Y, Z);
    const float* ph = phiinv + (long)n * 3 * V;
    float* o = out + (long)n * 3 * V + p;
    o[0] = __fadd_rn(d0, warp_sum(T, ph));
    o[V] = __fadd_rn(d1, warp_sum(T, ph + V));
    o[2 * V] = __fadd_rn(d2, warp_sum(T, ph + 2 * V));
  }
  clear_flag_if(bad, flag);
}

// K6, first pass: d_mw (to scratch) and d_phi; one thread per (n, p)
__global__ void ad_star_bwd_kernel(const float* __restrict__ phiinv,
                                   const float* __restrict__ m0,
                                   const float* __restrict__ g,
                                   const float* __restrict__ mw,
                                   float* __restrict__ d_mw,
                                   float* __restrict__ d_phi, int N, int Nm,
                                   int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));
  const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);
  const AxisIdx* ax[3] = {&ix, &iy, &iz};
  const int pos[3] = {x, y, z};
  const int len[3] = {X, Y, Z};
  const int stride[3] = {Y * Z, Z, 1};

  const float* ph = phiinv + (long)n * 3 * V;
  const float* gn = g + (long)n * 3 * V;
  const float* mwn = mw + (long)n * 3 * V;
  float gc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) gc[c] = __ldg(gn + (long)c * V + p);

  // d_mw_a = sum_c (D_a phi_c + delta_ca) g_c, accumulated over c in order
  float dmw[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float acc = 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      float j = diff_central(ph + (long)c * V, p, *ax[a], stride[a]);
      if (a == c) j = __fadd_rn(j, 1.0f);
      const float term = __fmul_rn(j, gc[c]);
      acc = c == 0 ? term : __fadd_rn(acc, term);
    }
    dmw[a] = acc;
    d_mw[(long)n * 3 * V + (long)a * V + p] = acc;
  }

  // weight-gradient path: image m0, cotangent d_mw, displacement phi
  AxisWeights W[3], dW[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = __ldg(ph + (long)a * V + p);
    W[a] = axis_weights(d);
    dW[a] = axis_dweights(d);
  }
  const float* mb = m0 + (Nm == 1 ? 0L : (long)n * 3 * V);
  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int ox = 0; ox < 3; ++ox) {
    const float wx = weight_at(W[0], ox - 1), dwx = weight_at(dW[0], ox - 1);
#pragma unroll
    for (int oy = 0; oy < 3; ++oy) {
      const float wy = weight_at(W[1], oy - 1), dwy = weight_at(dW[1], oy - 1);
      const float a_xy = __fmul_rn(dwx, wy);
      const float b_xy = __fmul_rn(wx, dwy);
      const float c_xy = __fmul_rn(wx, wy);
#pragma unroll
      for (int oz = 0; oz < 3; ++oz) {
        const float wz = weight_at(W[2], oz - 1), dwz = weight_at(dW[2], oz - 1);
        const long off = ((long)ix.i[ox] * Y + iy.i[oy]) * Z + iz.i[oz];
        float t = __fmul_rn(dmw[0], __ldg(mb + off));
        t = __fadd_rn(t, __fmul_rn(dmw[1], __ldg(mb + V + off)));
        t = __fadd_rn(t, __fmul_rn(dmw[2], __ldg(mb + 2 * V + off)));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(a_xy, wz), t));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(b_xy, wz), t));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(c_xy, dwz), t));
      }
    }
  }

  // divergence path: d_phi_c += sum_a D_a^T (mw_a * g_c), over a in order
  float* o = d_phi + (long)n * 3 * V + p;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    float div = 0.0f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const long lo = p + (long)(ax[a]->i[0] - pos[a]) * stride[a];
      const long hi = p + (long)(ax[a]->i[2] - pos[a]) * stride[a];
      const float* w = mwn + (long)a * V;
      const float* q = gn + (long)c * V;
      const float qm = __fmul_rn(__ldg(w + lo), __ldg(q + lo));
      const float q0 = __fmul_rn(__ldg(w + p), gc[c]);
      const float qp = __fmul_rn(__ldg(w + hi), __ldg(q + hi));
      const float term = diff_central_adjoint(qm, q0, qp, pos[a], len[a]);
      div = a == 0 ? term : __fadd_rn(div, term);
    }
    o[(long)c * V] = __fadd_rn(acc[c], div);
  }
}

}  // namespace lagomorph

static inline unsigned grid_for(long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

extern "C" int lagomorph_ad_star_fwd(const float* phiinv, const float* m0,
                                     float* out, float* mw, int* flag, int N,
                                     int Nm, int X, int Y, int Z, void* stream) {
  const int threads = 256;
  lagomorph::ad_star_fwd_kernel<<<grid_for((long)N * X * Y * Z, threads),
                                  threads, 0, (cudaStream_t)stream>>>(
      phiinv, m0, out, mw, flag, N, Nm, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" int lagomorph_ad_star_bwd(const float* phiinv, const float* m0,
                                     const float* g, const float* mw,
                                     float* d_mw, float* d_phiinv, float* d_m0,
                                     int N, int Nm, int X, int Y, int Z,
                                     void* stream) {
  const int threads = 256;
  const cudaStream_t st = (cudaStream_t)stream;
  lagomorph::ad_star_bwd_kernel<<<grid_for((long)N * X * Y * Z, threads),
                                  threads, 0, st>>>(phiinv, m0, g, mw, d_mw,
                                                    d_phiinv, N, Nm, X, Y, Z);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return (int)lagomorph::launch_warp_transpose(phiinv, 1.0f, d_mw, d_m0, N, Nm,
                                               3, X, Y, Z, st);
}

extern "C" int lagomorph_compose_bwd(const float* phiinv, const float* v,
                                     float s, const float* g, float* d_phiinv,
                                     float* d_v, int N, int X, int Y, int Z,
                                     void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = lagomorph::launch_warp_transpose(v, s, g, d_phiinv, N,
                                                           N, 3, X, Y, Z, st);
  if (err != cudaSuccess) return (int)err;
  return (int)lagomorph::launch_warp_dd(phiinv, v, s, g, d_v, N, N, 3, X, Y, Z,
                                        true, st);
}

extern "C" int lagomorph_compose_fwd(const float* phiinv, const float* v,
                                     float s, float* out, int* flag, int N,
                                     int X, int Y, int Z, void* stream) {
  const int threads = 256;
  lagomorph::compose_fwd_kernel<<<grid_for((long)N * X * Y * Z, threads),
                                  threads, 0, (cudaStream_t)stream>>>(
      phiinv, v, s, out, flag, N, X, Y, Z);
  return (int)cudaGetLastError();
}
