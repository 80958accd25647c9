// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by gi_gs_tpu_torch/ops/cuda_kernels.py).
#pragma once

#include <cuda_runtime.h>

#define GIGS_API extern "C" __attribute__((visibility("default")))

// Every launcher returns the launch's cudaGetLastError(): a refused launch
// (too many threads, too much shared memory) never runs, and a later
// synchronize would not report it.
#define GIGS_RETURN_LAUNCH_STATUS() return static_cast<int>(cudaGetLastError())
