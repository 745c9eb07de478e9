// The cooperative launch of a persistent kernel, shared by K8/K9
// (shoot2d.cu) and K16 (fft_whole.cu): as many blocks of `threads` as the
// card holds at once (occupancy x SMs), so that every block is resident and
// cooperative_groups::this_grid().sync() may separate the kernel's phases.
#pragma once

#include <cuda_runtime.h>

namespace lagomorph {

static inline int launch_cooperative(const void* kernel, int threads, size_t smem,
                                     void** args, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev, sms, per_sm;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorLaunchOutOfResources;
  err = cudaLaunchCooperativeKernel(kernel, dim3(per_sm * sms), dim3(threads), args, smem,
                                    stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace lagomorph
