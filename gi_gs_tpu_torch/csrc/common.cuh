// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by gi_gs_tpu_torch/ops/cuda_kernels.py).
#pragma once

#include <cuda_runtime.h>

#define GIGS_API extern "C" __attribute__((visibility("default")))

// Every launcher returns the launch's cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and a later
// synchronize would not report it.
#define GIGS_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())

// Makes `device` the calling thread's current device. cudaGetDevice only
// reads the runtime's per-thread state; cudaSetDevice runs only when the
// device changes, not on every launch.
inline cudaError_t gigs_use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

// Runs `set()` (a cudaFuncSetAttribute call on the current device, say)
// once per device and remembers that it succeeded; `done` is the caller's
// own bit set.
template <typename Set>
inline cudaError_t gigs_once_per_device(int device,
                                        unsigned long long& done, Set set) {
  const unsigned long long bit = device < 64 ? 1ull << device : 0ull;
  if (bit != 0 && (__atomic_load_n(&done, __ATOMIC_ACQUIRE) & bit)) {
    return cudaSuccess;
  }
  const cudaError_t err = set();
  if (err == cudaSuccess) __atomic_fetch_or(&done, bit, __ATOMIC_RELEASE);
  return err;
}

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
