// Shared helpers of the port's CUDA kernels (plain C interface, loaded
// with ctypes by gi_gs_tpu_torch/ops/cuda_kernels.py).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// Lets `kernel` take up to the card's opt-in maximum of dynamic shared
// memory on `device`: a function attribute set once per device (`done` is
// the caller's own bit set), not on every launch.
template <typename Kernel>
inline cudaError_t gigs_opt_in_smem(int device, unsigned long long& done,
                                    Kernel kernel) {
  return gigs_once_per_device(device, done, [device, kernel] {
    int bytes = 0;
    cudaError_t err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return err;
  });
}

// ---------------------------------------------------------------------------
// Bulk copies into shared memory and the mbarrier ring they fill
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t gigs_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises each barrier of a CTA, then the whole CTA syncs.
__device__ __forceinline__ void gigs_mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(
                   gigs_smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void gigs_mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void gigs_mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(
                   gigs_smem_addr(bar))
               : "memory");
}

// The producer's arrival: the phase then also waits for `bytes` of copies.
__device__ __forceinline__ void gigs_mbar_arrive_expect_tx(uint64_t* bar,
                                                           uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   gigs_smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed. A
// phase that is still open after ~2^32 cycles (seconds; a wrong byte
// count) traps: the launch fails instead of holding the card.
__device__ __forceinline__ void gigs_mbar_wait(uint64_t* bar,
                                               uint32_t parity) {
  const uint32_t addr = gigs_smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 32)) {
      __trap();
    }
  }
}

// One bulk copy of `bytes` (a multiple of 16) from global to shared memory
// (both 16-byte aligned); its bytes complete on `bar`.
__device__ __forceinline__ void gigs_bulk_load(void* dst, const void* src,
                                               uint32_t bytes,
                                               uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(gigs_smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(gigs_smem_addr(bar))
      : "memory");
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
