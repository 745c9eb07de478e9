// K4: unit-regime warp, forward.
//
//   out[n,c](p) = sum_{o in {-1,0,1}^3} w_o(d[n](p)) * I[n or 0, c](clamp(p + o))
//
// Replaces the Pallas kernels lagomorph_tpu/ops/pallas/warp_unit.py
// `_fwd_kernel` (whole-Y, via `_warp_unit_fwd_pallas`) and `_fwd_kernel_yb`
// (y-blocked, via `_warp_unit_fwd_yb`), forward of
// `sample_displacement_unit_pallas`.  The TPU kernels pad x by 8 rows and
// end-pad odd shapes for DMA alignment (warp_unit.py:1070-1137); here the
// clamp happens in the kernel, so one kernel covers every shape.
//
// Bound on the H100: memory.  Per voxel it reads the 3 displacement
// components once and writes C outputs; the 27 taps of I hit L1/L2 (each
// I value is read by the 27 voxels around it).  At 128^3 b4 (one 100.7 MB
// displacement field, a 8.4 MB batch-1 image) that is ~0.14 GB of device
// traffic.  Design: one thread per output voxel, z fastest across the warp
// so displacement loads and stores coalesce; the 27 weights and offsets are
// computed once per voxel and reused for every channel; a batch-1 image is
// read with batch stride 0, never broadcast in memory.
//
// K5: unit-regime warp, backward (cotangent g of out):
//   dI[v]     = sum_{(u,o): clamp(u+o) = v} w_o(d(u)) * g(u)          (transpose)
//   d_disp[a] = sum_o dw_a(o_a) prod_{b!=a} w_b(o_b) sum_c g_c I_c[tap_o]
// Replaces warp_unit.py `_warp_unit_bwd_pallas` (kernels `_bwd_dI_kernel`,
// `_bwd_dD_kernel`) and `_warp_unit_bwd_yb` (`_bwd_dI_kernel_yb`,
// `_bwd_dD_kernel_yb`), dispatched by `_sdu_bwd`.  The TPU kernels form the
// transpose as per-axis rolls of the weighted cotangent with clamp folds;
// Hopper's blocks cannot share rolled slabs, and a scatter would need float
// atomics (nondeterministic sums).  So the transpose is in gather form: one
// thread per dI voxel reads the 27 source voxels u = v - o (the clamp folds
// at the edges, stencil.cuh `transposed_tap`), recomputes the weight of the one
// tap that lands on v from d(u), and sums in a fixed order.  A batch-1 image
// (the atlas) gets dI summed over the N subjects inside the thread: no
// atomics, no extra pass.  The weight-gradient pass is one thread per voxel
// of d_disp, reusing the forward's taps.
//
// Bound on the H100: at 128^3 b4 with the atlas (C = 1) the passes move
// ~252 MB (read d, g, I; write dI, d_disp): ~75 us at 3.35 TB/s.  The gather
// re-reads each d and g value 27 times from L1/L2 and recomputes 81 axis
// weights per output voxel, so it spends operations, not bytes, on being
// scatter-free.
#include "stencil.cuh"

namespace lagomorph {

__global__ void warp_unit_fwd_kernel(const float* __restrict__ I,
                                     const float* __restrict__ disp,
                                     float* __restrict__ out, int N, int NI,
                                     int C, int X, int Y, int Z) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));

  const float* d = disp + (long)n * 3 * V + p;
  AxisWeights W[3];
  W[0] = axis_weights(d[0]);
  W[1] = axis_weights(d[V]);
  W[2] = axis_weights(d[2 * V]);
  Taps T;
  make_taps(T, W, axis_idx(x, X), axis_idx(y, Y), axis_idx(z, Z), Y, Z);

  const float* Ib = I + (NI == 1 ? 0L : (long)n * C * V);
  float* o = out + (long)n * C * V + p;
  for (int c = 0; c < C; ++c) o[(long)c * V] = warp_sum(T, Ib + (long)c * V);
}

// the gather-form transpose (see stencil.cuh launch_warp_transpose); one
// thread per (nI, v), channels in chunks of 4 accumulators.  Offsets within
// one field are 32-bit (a field of up to 2^31 voxels); the x-slot loop is
// not unrolled, which keeps the kernel's registers well below the 255 a
// fully unrolled 27-tap loop took.
__global__ void warp_transpose_kernel(const float* __restrict__ disp, float s,
                                      const float* __restrict__ cot,
                                      float* __restrict__ out, int N, int NI,
                                      int C, int X, int Y, int Z) {
  const int V = X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)NI * V) return;
  const int nI = (int)(idx / V);
  const int v = (int)(idx - (long)nI * V);
  const int z = v % Z;
  const int y = (v / Z) % Y;
  const int x = v / (Y * Z);
  const int n0 = NI == 1 ? 0 : nI;
  const int n1 = NI == 1 ? N : nI + 1;

  for (int c0 = 0; c0 < C; c0 += 4) {
    const int nc = C - c0 < 4 ? C - c0 : 4;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = n0; n < n1; ++n) {
      const float* dx = disp + (long)n * 3 * V;
      const float* dy = dx + V;
      const float* dz = dy + V;
      const float* gn = cot + ((long)n * C + c0) * V;
#pragma unroll 1
      for (int kx = 0; kx < 3; ++kx) {
        int ux, ox;
        transposed_tap(x, X, kx, ux, ox);
#pragma unroll
        for (int ky = 0; ky < 3; ++ky) {
          int uy, oy;
          transposed_tap(y, Y, ky, uy, oy);
          const int row = (ux * Y + uy) * Z;
#pragma unroll
          for (int kz = 0; kz < 3; ++kz) {
            int uz, oz;
            transposed_tap(z, Z, kz, uz, oz);
            const int u = row + uz;
            const float wx = weight_at(axis_weights(__fmul_rn(s, __ldg(dx + u))), ox);
            const float wy = weight_at(axis_weights(__fmul_rn(s, __ldg(dy + u))), oy);
            const float wz = weight_at(axis_weights(__fmul_rn(s, __ldg(dz + u))), oz);
            const float w = __fmul_rn(__fmul_rn(wx, wy), wz);
#pragma unroll
            for (int c = 0; c < 4; ++c)
              if (c < nc) acc[c] = __fadd_rn(acc[c], __fmul_rn(w, __ldg(gn + (long)c * V + u)));
          }
        }
      }
    }
    float* o = out + ((long)nI * C + c0) * V + v;
    for (int c = 0; c < nc; ++c) o[(long)c * V] = acc[c];
  }
}

// the weight-gradient pass (see stencil.cuh launch_warp_dd); one thread per
// (n, p)
__global__ void warp_dd_kernel(const float* __restrict__ I,
                               const float* __restrict__ disp, float s,
                               const float* __restrict__ cot,
                               float* __restrict__ out, int N, int NI, int C,
                               int X, int Y, int Z, bool compose) {
  const long V = (long)X * Y * Z;
  const long idx = (long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long)N * V) return;
  const int n = (int)(idx / V);
  const long p = idx - (long)n * V;
  const int z = (int)(p % Z);
  const int y = (int)((p / Z) % Y);
  const int x = (int)(p / ((long)Y * Z));

  const float* d = disp + (long)n * 3 * V + p;
  const float dv[3] = {__fmul_rn(s, d[0]), __fmul_rn(s, d[V]), __fmul_rn(s, d[2 * V])};
  AxisWeights W[3], dW[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    W[a] = axis_weights(dv[a]);
    dW[a] = axis_dweights(dv[a]);
  }
  const AxisIdx ix = axis_idx(x, X), iy = axis_idx(y, Y), iz = axis_idx(z, Z);
  const float* Ib = I + (NI == 1 ? 0L : (long)n * C * V);
  const float* g = cot + (long)n * C * V + p;

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
        float gI = __fmul_rn(__ldg(g), __ldg(Ib + off));
        for (int c = 1; c < C; ++c)
          gI = __fadd_rn(gI, __fmul_rn(__ldg(g + (long)c * V), __ldg(Ib + (long)c * V + off)));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(__fmul_rn(a_xy, wz), gI));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(__fmul_rn(b_xy, wz), gI));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(__fmul_rn(c_xy, dwz), gI));
      }
    }
  }
  float* o = out + (long)n * 3 * V + p;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    o[(long)a * V] = compose ? __fadd_rn(__fmul_rn(s, __ldg(g + (long)a * V)), __fmul_rn(s, acc[a]))
                             : acc[a];
}

static inline unsigned blocks_for(long total, int threads) {
  return (unsigned)((total + threads - 1) / threads);
}

cudaError_t launch_warp_transpose(const float* disp, float s, const float* cot,
                                  float* out, int N, int NI, int C, int X, int Y,
                                  int Z, cudaStream_t stream) {
  const int threads = 256;
  warp_transpose_kernel<<<blocks_for((long)NI * X * Y * Z, threads), threads, 0,
                          stream>>>(disp, s, cot, out, N, NI, C, X, Y, Z);
  return cudaGetLastError();
}

cudaError_t launch_warp_dd(const float* I, const float* disp, float s,
                           const float* cot, float* out, int N, int NI, int C,
                           int X, int Y, int Z, bool compose, cudaStream_t stream) {
  const int threads = 256;
  warp_dd_kernel<<<blocks_for((long)N * X * Y * Z, threads), threads, 0, stream>>>(
      I, disp, s, cot, out, N, NI, C, X, Y, Z, compose);
  return cudaGetLastError();
}

}  // namespace lagomorph

extern "C" int lagomorph_warp_unit_bwd(const float* I, const float* disp,
                                       const float* g, float* dI, float* d_disp,
                                       int N, int NI, int C, int X, int Y, int Z,
                                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = lagomorph::launch_warp_transpose(disp, 1.0f, g, dI, N, NI, C,
                                                     X, Y, Z, st);
  if (err != cudaSuccess) return (int)err;
  return (int)lagomorph::launch_warp_dd(I, disp, 1.0f, g, d_disp, N, NI, C, X, Y,
                                        Z, false, st);
}

extern "C" int lagomorph_warp_unit_fwd(const float* I, const float* disp,
                                       float* out, int N, int NI, int C, int X,
                                       int Y, int Z, void* stream) {
  const long total = (long)N * X * Y * Z;
  const int threads = 256;
  const long blocks = (total + threads - 1) / threads;
  lagomorph::warp_unit_fwd_kernel<<<(unsigned)blocks, threads, 0,
                                    (cudaStream_t)stream>>>(I, disp, out, N, NI,
                                                            C, X, Y, Z);
  return (int)cudaGetLastError();
}

extern "C" const char* lagomorph_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
