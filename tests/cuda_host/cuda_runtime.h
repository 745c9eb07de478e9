// Host stand-in for the CUDA runtime, so that the per-thread stencil
// kernels of lagomorph_tpu_torch/csrc (warp_unit.cu, epdiff_unit.cu)
// compile with g++ and run on the CPU (tests/test_torch_host_kernels.py).
//
// A launch `k<<<grid, block, ...>>>(args);` is rewritten by the test as
// `emu_launch(grid, block, [&] { k(args); });`, which runs every thread of
// the grid in turn: block by block, warp by warp, lanes 1..31 and then lane
// 0, so that __ballot_sync at lane 0 returns the vote of the whole warp
// (the kernels read a ballot only at lane 0).  Rounding intrinsics are the
// plain float operations, which round the same way on the host.
#pragma once

#include <cmath>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__

struct emu_dim3 {
  unsigned x, y, z;
};
inline emu_dim3 threadIdx, blockIdx, blockDim, gridDim;

typedef int cudaError_t;
typedef struct CUstream_st* cudaStream_t;
#define cudaSuccess 0

inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "no error (host emulation)"; }

inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
template <class T>
inline T __ldg(const T* p) { return *p; }

inline unsigned emu_vote = 0;

inline unsigned __ballot_sync(unsigned, bool pred) {
  if ((threadIdx.x & 31u) != 0) {
    emu_vote |= pred ? 1u : 0u;
    return pred ? 1u : 0u;
  }
  const unsigned all = emu_vote | (pred ? 1u : 0u);
  emu_vote = 0;
  return all;
}

inline int atomicAnd(int* p, int v) {
  const int old = *p;
  *p &= v;
  return old;
}

template <class Thread>
inline void emu_launch(long grid, long block, Thread thread) {
  blockDim.x = (unsigned)block;
  gridDim.x = (unsigned)grid;
  for (long b = 0; b < grid; ++b) {
    blockIdx.x = (unsigned)b;
    for (long w = 0; w < block; w += 32) {
      for (long lane = 1; lane <= 32; ++lane) {
        const long t = w + (lane % 32);
        if (t >= block) continue;
        threadIdx.x = (unsigned)t;
        thread();
      }
    }
  }
}
