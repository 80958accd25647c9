// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by gi_gs_tpu_torch/ops/cuda_kernels.py).
#pragma once

#include <cuda_runtime.h>

#define GIGS_API extern "C" __attribute__((visibility("default")))

// Every launcher returns the launch's cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and a later
// synchronize would not report it.
#define GIGS_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

// What the compiler and the occupancy calculator give a kernel at a launch
// shape: out = [registers per thread, static shared bytes, dynamic shared
// bytes, threads per block, resident blocks per SM, local (spill) bytes per
// thread]. Launches nothing.
template <typename Kernel>
inline int gigs_kernel_resources(Kernel kernel, int threads, size_t dyn_smem,
                                 int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads,
                                                      dyn_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(dyn_smem);
  out[3] = threads;
  out[4] = blocks;
  out[5] = static_cast<int>(a.localSizeBytes);
  return 0;
}
