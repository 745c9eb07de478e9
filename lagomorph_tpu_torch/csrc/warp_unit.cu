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

}  // namespace lagomorph

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
