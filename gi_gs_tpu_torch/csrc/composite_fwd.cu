// Tile compositing forward: front-to-back blending of the 16-channel
// G-buffer plus the final transmittance.
//
// Replaces: gi_gs_tpu/ops/rasterize/pallas_composite.py:composite_fwd_pallas
//   (_fwd_kernel), both variants: peak=False (gigs_composite_fwd) and
//   peak=True (gigs_composite_fwd_peak), which also writes the
//   argmax-weight ("peak") depth and view position of each pixel.
//   Semantics of the jnp oracle
//   gi_gs_tpu/ops/rasterize/composite.py:_fwd_impl: alpha = min(0.99,
//   op * exp(power)); an instance passes if power <= 0 and alpha >= 1/255;
//   a pass whose tentative transmittance falls below 1e-4 does not
//   contribute and ends the pixel (forward.cu:423-633).
//
// Bound on the H100: operations. Every (instance, pixel) pair of a tile
//   costs the conic power, one exp and, when it contributes, 16
//   multiply-adds; the bytes (gathered 84-byte rows, the [T, 17, P]
//   output) are small beside that.
// Design: one block per tile, one thread per pixel (tile_h * tile_w <=
//   1024). The tile's sorted instances are gathered by id into shared
//   memory in batches of 256 rows, so each row is read from global memory
//   once per tile and broadcast to every pixel; no [cap, 128] instance
//   table is materialised. Each thread runs the sequential renderCUDA
//   recurrence (equivalent to the oracle's chunked cumulative product,
//   whose inclusive transmittance is non-increasing within a chunk), and
//   a block-wide vote (__syncthreads_count) ends the tile once every pixel
//   is saturated.
// Peak (forward.cu:577-583): the walk keeps the largest weight w = alpha*T
//   seen so far and the [depth, pos_view xyz] (row columns 17:21) of the
//   first contributing instance that raised it strictly; an instance that
//   only ties an earlier maximum does not replace it. The Pallas body gets
//   the same selection with a first-max-in-chunk argmax; the sequential
//   walk gets it from the strict compare. The row is already in shared
//   memory, so the variant keeps five more values (the maximum and the
//   four peak columns) and adds no loads. The kernel is
//   a template on kPeak: the peak=False instantiation carries none of it,
//   so serving and training run the walk alone.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBatch = 256;
constexpr int kRow = 21;   // means2d 2 | conic 3 | opacity | color 3 | aux 12
constexpr int kCh = 16;    // color 3 | ones | normal 3 | albedo 3 | rough |
                           // metal | depth | pos 3

template <bool kPeak>
__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    int n_max, int grid_x, int tile_w, int tile_h, float alpha_clamp,
    float alpha_min, float t_min, float* __restrict__ accum,
    float* __restrict__ final_t, float* __restrict__ peak) {
  __shared__ float rows[kBatch][kRow];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int trow = t / grid_x;
  const int tcol = t - trow * grid_x;
  const int ly = p / tile_w;
  const int lx = p - ly * tile_w;
  const float pxf = static_cast<float>(tcol * tile_w + lx);
  const float pyf = static_cast<float>(trow * tile_h + ly);
  const int start = tile_start[t];
  const int count = min(tile_count[t], n_max);

  float T = 1.0f;
  bool done = false;
  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
  float max_w = 0.0f;
  float pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int base = 0; base < count; base += kBatch) {
    const int nb = min(kBatch, count - base);
    __syncthreads();  // the previous batch is fully consumed
    for (int e = p; e < nb * kRow; e += P) {
      const int r = e / kRow;
      const int c = e - r * kRow;
      rows[r][c] = table[static_cast<size_t>(ids[start + base + r]) * kRow + c];
    }
    __syncthreads();
    if (!done) {
      for (int k = 0; k < nb; ++k) {
        const float* row = rows[k];
        const float dx = row[0] - pxf;
        const float dy = row[1] - pyf;
        const float power =
            -0.5f * (row[2] * dx * dx + row[4] * dy * dy) - row[3] * dx * dy;
        if (power > 0.0f) continue;
        const float alpha = fminf(alpha_clamp, row[5] * expf(power));
        if (alpha < alpha_min) continue;
        const float test_t = T * (1.0f - alpha);
        if (test_t < t_min) {
          done = true;
          break;
        }
        const float w = alpha * T;
        acc[0] += row[6] * w;
        acc[1] += row[7] * w;
        acc[2] += row[8] * w;
        acc[3] += w;
#pragma unroll
        for (int c = 4; c < kCh; ++c) acc[c] += row[c + 5] * w;
        if constexpr (kPeak) {
          if (w > max_w) {
            max_w = w;
#pragma unroll
            for (int c = 0; c < 4; ++c) pk[c] = row[17 + c];
          }
        }
        T = test_t;
      }
    }
    if (__syncthreads_count(done) == P) break;
  }

  float* out = accum + static_cast<size_t>(t) * kCh * P + p;
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[static_cast<size_t>(c) * P] = acc[c];
  final_t[static_cast<size_t>(t) * P + p] = T;
  if constexpr (kPeak) {
    float* pout = peak + static_cast<size_t>(t) * 4 * P + p;
#pragma unroll
    for (int c = 0; c < 4; ++c) pout[static_cast<size_t>(c) * P] = pk[c];
  }
}

}  // namespace

GIGS_API int gigs_composite_fwd(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, int num_tiles, int n_max, int grid_x, int tile_w,
    int tile_h, float alpha_clamp, float alpha_min, float t_min, void* accum,
    void* final_t, void* stream) {
  cudaSetDevice(device);
  composite_fwd_kernel<false><<<num_tiles, tile_w * tile_h, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      n_max, grid_x, tile_w, tile_h, alpha_clamp, alpha_min, t_min,
      static_cast<float*>(accum), static_cast<float*>(final_t), nullptr);
  GIGS_RETURN_LAUNCH_STATUS();
}

// As gigs_composite_fwd, plus peak [T, 4, P]: depth and pos_view xyz of
// each pixel's argmax-weight instance (0 where nothing contributed).
GIGS_API int gigs_composite_fwd_peak(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, int num_tiles, int n_max, int grid_x, int tile_w,
    int tile_h, float alpha_clamp, float alpha_min, float t_min, void* accum,
    void* final_t, void* peak, void* stream) {
  cudaSetDevice(device);
  composite_fwd_kernel<true><<<num_tiles, tile_w * tile_h, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      n_max, grid_x, tile_w, tile_h, alpha_clamp, alpha_min, t_min,
      static_cast<float*>(accum), static_cast<float*>(final_t),
      static_cast<float*>(peak));
  GIGS_RETURN_LAUNCH_STATUS();
}
