// Instance expansion with the exact per-tile alpha cull.
//
// Replaces: gi_gs_tpu/ops/rasterize/pallas_expand.py:expand_pallas
//   (_expand_kernel) and its pack_rows (_pack_rows_kernel) step: this
//   kernel reads the per-Gaussian columns directly, so no row table is
//   packed. Semantics are those of the XLA oracle
//   gi_gs_tpu/ops/rasterize/binning.py:_expand_xla (exact f32 cull, not
//   the bf16-slacked CULL_SLACK cull of the Pallas kernel).
//
// Bound on the H100: bytes. Each instance slot reads a few per-Gaussian
//   scalars and writes 12 bytes; the arithmetic (a 19-step binary search
//   and ~60 flops of cull) is far under the f32 rate.
// Design: one thread per instance slot j in [0, cap). The owning Gaussian
//   is found by binary search over the exclusive-scan offsets (cached in
//   L2), so neighbouring threads read neighbouring offsets and mostly the
//   same Gaussian's columns. Built with -fmad=false so the cull rounds as
//   the plain version does.
#include "common.cuh"

#include <math.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// -0.5 * (cxx dx dx + cyy dy dy) - cxy dx dy, in the oracle's order.
__device__ __forceinline__ float conic_power(float cxx, float cxy, float cyy,
                                             float dx, float dy) {
  return -0.5f * (cxx * dx * dx + cyy * dy * dy) - cxy * dx * dy;
}

__global__ void __launch_bounds__(256) expand_kernel(
    const int* __restrict__ offsets, int n,
    const int* __restrict__ rmin_x, const int* __restrict__ rmin_y,
    const int* __restrict__ rmax_x, const int* __restrict__ counts,
    const float* __restrict__ depth, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ cxx,
    const float* __restrict__ cxy, const float* __restrict__ cyy,
    const float* __restrict__ opacity, int cap, int tx_tiles, int num_tiles,
    int tile_w, int tile_h, float alpha_min, int* __restrict__ tile_out,
    float* __restrict__ depth_out, int* __restrict__ gid_out) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cap) return;
  const int total = offsets[n];

  // g = the last Gaussian whose segment starts at or before j
  // (offsets is strictly increasing with offsets[0] = 0).
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (offsets[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int g = lo;
  const bool in_range = j < total;

  const int local = j - offsets[g];
  const int rx0 = rmin_x[g];
  const int rmax = counts[g] > 0 ? rmax_x[g] : rx0;
  const int rw = rmax - rx0;
  const int rw_safe = rw > 1 ? rw : 1;
  const int dy = local / rw_safe;          // local >= 0: trunc == floor
  const int dx = local - dy * rw_safe;
  const int tx = rx0 + dx;
  const int ty = rmin_y[g] + dy;
  const int tile = ty * tx_tiles + tx;

  // Exact tile cull: max of the concave log-alpha over the tile's pixel
  // box, on one of the four faces (closed form each) or 0 inside.
  const float mx = px[g], my = py[g];
  const float a = cxx[g], b = cxy[g], c = cyy[g];
  const float op = opacity[g];
  const float x0 = static_cast<float>(tx * tile_w);
  const float y0 = static_cast<float>(ty * tile_h);
  const float a0 = mx - ((x0 + static_cast<float>(tile_w)) - 1.0f);
  const float a1 = mx - x0;
  const float b0 = my - ((y0 + static_cast<float>(tile_h)) - 1.0f);
  const float b1 = my - y0;
  const float as = fabsf(a) > 1e-12f ? a : 1e-12f;
  const float cs = fabsf(c) > 1e-12f ? c : 1e-12f;

  const float fx0 = conic_power(a, b, c, a0, clipf(-b * a0 / cs, b0, b1));
  const float fx1 = conic_power(a, b, c, a1, clipf(-b * a1 / cs, b0, b1));
  const float fy0 = conic_power(a, b, c, clipf(-b * b0 / as, a0, a1), b0);
  const float fy1 = conic_power(a, b, c, clipf(-b * b1 / as, a0, a1), b1);
  float fmax = fmaxf(fmaxf(fx0, fx1), fmaxf(fy0, fy1));
  const bool inside = (a0 <= 0.f) && (0.f <= a1) && (b0 <= 0.f) && (0.f <= b1);
  if (inside) fmax = 0.f;
  const bool psd = (a > 0.f) && (c > 0.f) && (a * c - b * b > 0.f);
  const bool keep = !psd || (op * expf(fmax) >= alpha_min);

  tile_out[j] = (in_range && keep && rw >= 1) ? tile : num_tiles;
  depth_out[j] = in_range ? depth[g] : INFINITY;
  gid_out[j] = g;
}

}  // namespace

GIGS_API const char* gigs_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

GIGS_API int gigs_expand(
    int device, const void* offsets, int n, const void* rmin_x,
    const void* rmin_y, const void* rmax_x, const void* counts,
    const void* depth, const void* px, const void* py, const void* cxx,
    const void* cxy, const void* cyy, const void* opacity, int cap,
    int tx_tiles, int num_tiles, int tile_w, int tile_h, float alpha_min,
    void* tile_out, void* depth_out, void* gid_out, void* stream) {
  cudaSetDevice(device);
  const int threads = 256;
  const int blocks = (cap + threads - 1) / threads;
  expand_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(offsets), n, static_cast<const int*>(rmin_x),
      static_cast<const int*>(rmin_y), static_cast<const int*>(rmax_x),
      static_cast<const int*>(counts), static_cast<const float*>(depth),
      static_cast<const float*>(px), static_cast<const float*>(py),
      static_cast<const float*>(cxx), static_cast<const float*>(cxy),
      static_cast<const float*>(cyy), static_cast<const float*>(opacity), cap,
      tx_tiles, num_tiles, tile_w, tile_h, alpha_min,
      static_cast<int*>(tile_out), static_cast<float*>(depth_out),
      static_cast<int*>(gid_out));
  GIGS_RETURN_LAUNCH_STATUS();
}
