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
//   scalars and writes 12 bytes; the ~60 flops of cull per slot are far
//   under the f32 rate.
// Design: one thread per instance slot j in [0, cap), kB slots per CTA.
//   Every Gaussian owns at least one slot (binning._offsets clamps counts
//   to >= 1, so offsets is strictly increasing), so a CTA's slots
//   [j0, j0 + kB) belong to at most kB consecutive Gaussians g0 .. g0 +
//   kB - 1. One search per CTA, not one per slot: warp 0 finds g0 with a
//   32-ary search over offsets (a coalesced load and a ballot per round,
//   4 rounds for 2^19 Gaussians); the CTA then loads offsets[g0 .. g0 +
//   kB] and the columns of the Gaussians it spans into shared memory, once
//   each, and every slot finds its Gaussian there by an 8-step binary
//   search. Slots past offsets[n] belong to g = n - 1 and take tile =
//   num_tiles, depth = inf; they and the slots of a Gaussian with no tile
//   (count 0) skip the cull, whose result they do not use. Built with
//   -fmad=false so the cull rounds as the plain version does.
#include "common.cuh"

#include <limits.h>
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

constexpr int kB = 256;  // slots per CTA

__global__ void __launch_bounds__(kB) expand_kernel(
    const int* __restrict__ offsets, int n,
    const int* __restrict__ rmin_x, const int* __restrict__ rmin_y,
    const int* __restrict__ rmax_x, const int* __restrict__ counts,
    const float* __restrict__ depth, const float* __restrict__ px,
    const float* __restrict__ py, const float* __restrict__ cxx,
    const float* __restrict__ cxy, const float* __restrict__ cyy,
    const float* __restrict__ opacity, int cap, int tx_tiles, int num_tiles,
    int tile_w, int tile_h, float alpha_min, int* __restrict__ tile_out,
    float* __restrict__ depth_out, int* __restrict__ gid_out) {
  __shared__ int s_off[kB + 1];  // offsets[g0 + i] (INT_MAX past offsets[n])
  __shared__ int s_rx0[kB], s_ry0[kB], s_rmax[kB];
  __shared__ float s_depth[kB], s_px[kB], s_py[kB], s_cxx[kB], s_cxy[kB],
      s_cyy[kB], s_op[kB];
  __shared__ int s_g0;
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * kB;

  // g0 = the last Gaussian whose segment starts at or before j0. The
  // candidates [lo, hi] always hold it, and offsets[lo] <= j0; offsets[g]
  // >= g, so g0 <= j0.
  if (t < 32) {
    int lo = 0, hi = min(n - 1, j0);
    while (lo < hi) {
      const int step = (hi - lo + 32) >> 5;  // ceil((hi - lo + 1) / 32)
      const int pt = lo + t * step;
      const unsigned le =
          __ballot_sync(0xffffffffu, pt <= hi && offsets[pt] <= j0);
      lo += (31 - __clz(le)) * step;         // lane 0 is always set
      hi = min(hi, lo + step - 1);
    }
    if (t == 0) s_g0 = lo;
  }
  __syncthreads();
  const int g0 = s_g0;
  const int last = min(n - 1 - g0, kB - 1);  // a slot's largest window index
  for (int i = t; i <= kB; i += kB)
    s_off[i] = g0 + i <= n ? offsets[g0 + i] : INT_MAX;
  __syncthreads();

  // The columns of the Gaussians whose segment starts in this CTA's slots.
  const int j_last = min(j0 + kB, cap) - 1;
  if (t <= last && s_off[t] <= j_last) {
    const int g = g0 + t;
    const int rx0 = rmin_x[g];
    s_rx0[t] = rx0;
    s_ry0[t] = rmin_y[g];
    s_rmax[t] = counts[g] > 0 ? rmax_x[g] : rx0;
    s_depth[t] = depth[g];
    s_px[t] = px[g];
    s_py[t] = py[g];
    s_cxx[t] = cxx[g];
    s_cxy[t] = cxy[g];
    s_cyy[t] = cyy[g];
    s_op[t] = opacity[g];
  }
  // This slot's Gaussian g0 + i: the last window entry starting at or
  // before j (the tail past offsets[n] stops at g = n - 1).
  const int j = j0 + t;
  int lo = 0, hi = last;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (s_off[mid] <= j) lo = mid; else hi = mid - 1;
  }
  const int i = lo;
  __syncthreads();
  if (j >= cap) return;
  // offsets[g + 1] is the next segment's start, or offsets[n] for g = n - 1
  const bool in_range = j < s_off[i + 1];

  const int rx0 = s_rx0[i];
  const int rw = s_rmax[i] - rx0;
  gid_out[j] = g0 + i;
  if (!in_range || rw < 1) {  // a dummy slot: no tile, whatever the cull
    tile_out[j] = num_tiles;
    depth_out[j] = in_range ? s_depth[i] : INFINITY;
    return;
  }
  const int local = j - s_off[i];
  const int dy = local / rw;               // local >= 0: trunc == floor
  const int dx = local - dy * rw;
  const int tx = rx0 + dx;
  const int ty = s_ry0[i] + dy;
  const int tile = ty * tx_tiles + tx;

  // Exact tile cull: max of the concave log-alpha over the tile's pixel
  // box, on one of the four faces (closed form each) or 0 inside.
  const float mx = s_px[i], my = s_py[i];
  const float a = s_cxx[i], b = s_cxy[i], c = s_cyy[i];
  const float op = s_op[i];
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

  tile_out[j] = keep ? tile : num_tiles;
  depth_out[j] = s_depth[i];
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
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (cap + kB - 1) / kB;
  expand_kernel<<<blocks, kB, 0, static_cast<cudaStream_t>(stream)>>>(
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

// Registers, shared memory and resident blocks per SM (gigs_kernel_resources
// in common.cuh).
GIGS_API int gigs_expand_resources(int device, int* out) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return gigs_kernel_resources(expand_kernel, kB, 0, out);
}
