// Per-Gaussian sums of the compositing backward's per-instance gradient
// rows, as differences of an f32 prefix sum.
//
// Replaces: no Pallas kernel. JAX leaves this reduction to XLA
//   (gi_gs_tpu/ops/rasterize/composite.py:315 reduce_sorted_instance_grads:
//   a gather through inv_perm, an f32 cumsum, segment differences). Run as
//   PyTorch ops on the card (composite._reduce_sorted_instance_grads_plain,
//   the plain version, which CPU tensors keep), that chain was about ten
//   launches: the gather, a transposed copy, a cumsum along [21, cap] that
//   PyTorch runs as one block per row (21 of 132 SMs, ~11 ms at the garden
//   shapes), a cat, two gathers and a subtraction, ~7 GB of traffic.
// Computes: out[c * n + g] = P_c(hi_g) - P_c(lo_g), lo_g = clamp(offsets[g],
//   0, cap), hi_g = clamp(offsets[g + 1], 0, cap), P_c(0) = 0 and P_c(b) the
//   inclusive f32 prefix sum of x_c[0 .. b - 1], x_c[i] = rows[inv_perm[i] *
//   21 + c]: bit for bit what the plain version computes on the card. Its
//   rounding is part of the result: a Gaussian with no gradient gets the
//   residue of two prefix sums, which Adam's eps of 1e-15 turns into a
//   full-lr step. Exact segment sums, which leave such Gaussians still,
//   changed the parameters' change over three garden steps by 13-19%, so
//   the kernel keeps the chain's arithmetic and takes its cost away.
// The chain's scan (PyTorch's tensor_kernel_scan_innermost_dim at 21 rows:
//   2^x x-threads, x = clamp((9 + ceil(log2 cap) - 5) / 2, 4, 9), so
//   chunks of 2^(x + 1) elements, 1024 for every cap above 8,192; the
//   running total added to a chunk's first element, then a Sklansky scan
//   of the chunk; composite._scan_log_chunk) gives every element
//   k of chunk j with top bit p (2^p <= k < 2^(p+1)) the value loc(k) +
//   L_p, where loc(k) is the Sklansky scan of the sub-block [2^p, 2^(p+1))
//   alone and L_p the chunk's value at 2^p - 1; L_0 = x[0] + carry, L_p =
//   loc(2^p - 1) + L_(p-1), and the next chunk's carry is L_(x+1). Only the
//   L chain depends on the chunks before. Three launches:
//   scan:  one CTA per chunk gathers its rows (cp.async, 4-byte
//          granules: rows are 84 bytes; none past the last bound,
//          offsets[n], which no difference reads) into shared memory, runs the
//          Sklansky levels on all 21 columns with the sub-block that holds
//          element 0 left out, and writes loc [21, cap] and the chunk's
//          tops x[0], loc(2^p - 1) [21, x + 2, chunks].
//   carry: one warp per column walks the chunks in order, x + 2 dependent
//          adds a chunk, and writes L_0 .. L_x [21, x + 1, chunks].
//   diff:  one thread per Gaussian reads loc and L at its two bounds in
//          each column and writes the differences into [21, n], the layout
//          whose .t() the autograd chain reads.
// Bound on the H100: bytes. The function reads each row up to the last
//   bound once (84 B, gathered) with its inv_perm (8 B), offsets, and writes
//   [21, n]: ~0.97 GB at the garden shapes (6.1-6.5 M rows, n 4,194,304),
//   0.29 ms at 3.35 TB/s. The kernels also write loc and read it back at
//   the bounds (~2 x 0.5 GB), and the carry walks ~7,200 chunks x 11
//   dependent adds on 21 warps. Deterministic: no atomics.
#include "common.cuh"

#include <cuda_pipeline.h>
#include <stdint.h>

namespace {

constexpr int kD = 21;          // gradient row width (TABLE_DIM)
constexpr int kScanThreads = 1024;
constexpr int kDiffThreads = 256;

// kLogChunk: log2 of the chain's chunk, 10 from cap 8,193 on (a chunk of
// 2^kLogChunk elements, with kLogChunk + 1 tops x[0], loc(2^p - 1)).
template <int kLogChunk>
constexpr size_t scan_smem() {
  return (size_t{1} << kLogChunk) * (kD * sizeof(float) + sizeof(int));
}

template <int kLogChunk>
__global__ void __launch_bounds__(kScanThreads) reduce_scan_kernel(
    const float* __restrict__ rows, const long long* __restrict__ inv_perm,
    const int* __restrict__ offsets, int n, int cap, int chunks,
    float* __restrict__ loc, float* __restrict__ tops) {
  constexpr int kChunk = 1 << kLogChunk, kTops = kLogChunk + 1;
  extern __shared__ float s_x[];                          // [kChunk][kD]
  int* s_src = reinterpret_cast<int*>(s_x + kChunk * kD);
  const int tid = threadIdx.x;
  const int j = blockIdx.x;
  const long long base = static_cast<long long>(j) * kChunk;
  // Elements at or past the last bound, min(offsets[n], cap), reach no
  // difference: they are neither gathered nor written (a scan value
  // depends on the elements up to its own only).
  const int limit = min(max(offsets[n], 0), cap);
  const int len = static_cast<int>(
      max(0ll, min(static_cast<long long>(kChunk), limit - base)));
  if (len == 0) return;   // nor does the carry walk this chunk
  for (int k = tid; k < kChunk; k += kScanThreads)
    s_src[k] = k < len ? static_cast<int>(inv_perm[base + k]) : -1;
  __syncthreads();
  // the chain's padding past cap is 0; so is what is left out past limit
  for (int e = tid; e < kChunk * kD; e += kScanThreads) {
    const int k = e / kD;
    const int src = s_src[k];
    if (src >= 0) {
      __pipeline_memcpy_async(
          s_x + e, rows + static_cast<long long>(src) * kD + (e - k * kD),
          sizeof(float));
    } else {
      s_x[e] = 0.f;
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  // Sklansky level m: the right half of each 2^(m+1) block adds its left
  // half's last element, as the chain does, except in the block at 0.
  for (int m = 0; m < kLogChunk; ++m) {
    const int half = 1 << m;
    for (int e = tid; e < kD * (kChunk / 2); e += kScanThreads) {
      const int c = e >> (kLogChunk - 1);
      const int t = e & (kChunk / 2 - 1);
      if ((t >> m) == 0) continue;
      const int a = ((t >> m) << (m + 1)) | half;
      const int ti = a + (t & (half - 1));
      s_x[ti * kD + c] = s_x[ti * kD + c] + s_x[(a - 1) * kD + c];
    }
    __syncthreads();
  }
  for (int e = tid; e < kD * kChunk; e += kScanThreads) {
    const int c = e >> kLogChunk, k = e & (kChunk - 1);
    if (k < len)
      loc[static_cast<long long>(c) * cap + base + k] = s_x[k * kD + c];
  }
  if (tid < kD * kTops) {
    const int c = tid / kTops, p = tid - c * kTops;
    tops[(static_cast<long long>(c) * kTops + p) * chunks + j] =
        s_x[((1 << p) - 1) * kD + c];
  }
}

// One chunk of the carry walk, on every lane: lane i keeps chunk i's L.
template <int kLogChunk>
__device__ __forceinline__ void carry_step(const float (&t)[kLogChunk + 1],
                                           int i, int lane, float& carry,
                                           float (&mine)[kLogChunk]) {
  float l = __shfl_sync(0xffffffffu, t[0], i) + carry;
  if (lane == i) mine[0] = l;
#pragma unroll
  for (int p = 1; p <= kLogChunk; ++p) {
    l = __shfl_sync(0xffffffffu, t[p], i) + l;
    if (p < kLogChunk && lane == i) mine[p] = l;
  }
  carry = l;
}

template <int kLogChunk>
__global__ void __launch_bounds__(32) reduce_carry_kernel(
    const float* __restrict__ tops, const int* __restrict__ offsets, int n,
    int cap, int chunks, float* __restrict__ lefts) {
  constexpr int kChunk = 1 << kLogChunk, kTops = kLogChunk + 1;
  const int lane = threadIdx.x;
  const float* top = tops + static_cast<long long>(blockIdx.x) * kTops * chunks;
  float* left = lefts + static_cast<long long>(blockIdx.x) * kLogChunk * chunks;
  // the chunks up to the one that holds the last bound's element
  const int limit = min(max(offsets[n], 0), cap);
  const int used = (limit + kChunk - 1) >> kLogChunk;
  float t[kTops], next[kTops];
#pragma unroll
  for (int p = 0; p < kTops; ++p)
    t[p] = lane < used ? top[static_cast<long long>(p) * chunks + lane] : 0.f;
  float carry = 0.f;   // the chain's init
  for (int j0 = 0; j0 < used; j0 += 32) {
    // the next 32 chunks' tops load while this batch walks
    const int jn = j0 + 32 + lane;
#pragma unroll
    for (int p = 0; p < kTops; ++p)
      next[p] = jn < used ? top[static_cast<long long>(p) * chunks + jn] : 0.f;
    float mine[kLogChunk] = {};
    const int count = min(32, used - j0);
    if (count == 32) {   // no branch inside: the shuffles go out ahead
#pragma unroll
      for (int i = 0; i < 32; ++i)
        carry_step<kLogChunk>(t, i, lane, carry, mine);
    } else {
      for (int i = 0; i < count; ++i)
        carry_step<kLogChunk>(t, i, lane, carry, mine);
    }
    if (lane < count) {
#pragma unroll
      for (int p = 0; p < kLogChunk; ++p)
        left[static_cast<long long>(p) * chunks + j0 + lane] = mine[p];
    }
#pragma unroll
    for (int p = 0; p < kTops; ++p) t[p] = next[p];
  }
}

// P(b): 0 at b = 0, else the chain's inclusive scan at b - 1.
__device__ __forceinline__ float prefix(const float* __restrict__ loc,
                                        const float* __restrict__ left,
                                        int log_chunk, int chunks, int b) {
  if (b == 0) return 0.f;
  const int k = b - 1, j = k >> log_chunk, r = k & ((1 << log_chunk) - 1);
  if (r == 0) return left[j];
  return loc[k] + left[static_cast<long long>(31 - __clz(r)) * chunks + j];
}

__global__ void __launch_bounds__(kDiffThreads) reduce_diff_kernel(
    const int* __restrict__ offsets, int n, int cap, int log_chunk,
    int chunks, const float* __restrict__ loc,
    const float* __restrict__ lefts, float* __restrict__ out) {
  const int g = blockIdx.x * kDiffThreads + threadIdx.x;
  if (g >= n) return;
  const int lo = min(max(offsets[g], 0), cap);
  const int hi = min(max(offsets[g + 1], 0), cap);
#pragma unroll
  for (int c = 0; c < kD; ++c) {
    const float* lc = loc + static_cast<long long>(c) * cap;
    const float* left = lefts + static_cast<long long>(c) * log_chunk * chunks;
    out[static_cast<long long>(c) * n + g] =
        prefix(lc, left, log_chunk, chunks, hi) -
        prefix(lc, left, log_chunk, chunks, lo);
  }
}

template <int kLogChunk>
cudaError_t reduce_scan_and_carry(int device, const void* rows,
                                  const void* inv_perm, const void* offsets,
                                  int n, int cap, int chunks, void* loc,
                                  void* tops, void* lefts, cudaStream_t s) {
  static unsigned long long smem_set = 0;
  const auto scan = reduce_scan_kernel<kLogChunk>;
  cudaError_t err = gigs_opt_in_smem(device, smem_set, scan);
  if (err != cudaSuccess) return err;
  scan<<<chunks, kScanThreads, scan_smem<kLogChunk>(), s>>>(
      static_cast<const float*>(rows), static_cast<const long long*>(inv_perm),
      static_cast<const int*>(offsets), n, cap, chunks,
      static_cast<float*>(loc), static_cast<float*>(tops));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  reduce_carry_kernel<kLogChunk><<<kD, 32, 0, s>>>(
      static_cast<const float*>(tops), static_cast<const int*>(offsets), n,
      cap, chunks, static_cast<float*>(lefts));
  return cudaGetLastError();
}

}  // namespace

// log_chunk (5..10) is the chain's chunk at this cap; loc [21, cap], tops
// [21, log_chunk + 1, chunks] and lefts [21, log_chunk, chunks] (chunks =
// ceil(cap / 2^log_chunk)) are the caller's scratch; out is [21, n].
GIGS_API int gigs_reduce_instance_grads(int device, const void* rows,
                                        const void* inv_perm,
                                        const void* offsets, int n, int cap,
                                        int log_chunk, void* loc, void* tops,
                                        void* lefts, void* out, void* stream) {
  cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (log_chunk < 5 || log_chunk > 10)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const int chunks = static_cast<int>(
      (static_cast<long long>(cap) + (1 << log_chunk) - 1) >> log_chunk);
  if (chunks > 0) {
    switch (log_chunk) {
#define GIGS_SCAN_CASE(L)                                               \
  case L:                                                               \
    err = reduce_scan_and_carry<L>(device, rows, inv_perm, offsets, n, cap, \
                                   chunks, loc, tops, lefts, s);          \
    break;
      GIGS_SCAN_CASE(5) GIGS_SCAN_CASE(6) GIGS_SCAN_CASE(7)
      GIGS_SCAN_CASE(8) GIGS_SCAN_CASE(9) GIGS_SCAN_CASE(10)
#undef GIGS_SCAN_CASE
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n > 0) {
    const int blocks = (n + kDiffThreads - 1) / kDiffThreads;
    reduce_diff_kernel<<<blocks, kDiffThreads, 0, s>>>(
        static_cast<const int*>(offsets), n, cap, log_chunk, chunks,
        static_cast<const float*>(loc), static_cast<const float*>(lefts),
        static_cast<float*>(out));
  }
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM of the scan kernel
// at the chunk of every cap from 8,193 on, the one that moves the bytes
// (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_reduce_instance_grads_resources(int device, int* out) {
  static unsigned long long smem_set = 0;
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess)
    err = gigs_opt_in_smem(device, smem_set, reduce_scan_kernel<10>);
  if (err != cudaSuccess) return static_cast<int>(err);
  return gigs_kernel_resources(reduce_scan_kernel<10>, kScanThreads,
                               scan_smem<10>(), out);
}
