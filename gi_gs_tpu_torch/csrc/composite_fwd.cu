// Tile compositing forward: front-to-back blending of the 16-channel
// G-buffer plus the final transmittance.
//
// Replaces: gi_gs_tpu/ops/rasterize/pallas_composite.py:composite_fwd_pallas
//   (_fwd_kernel) with peak=False. Semantics of the jnp oracle
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
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBatch = 256;
constexpr int kRow = 21;   // means2d 2 | conic 3 | opacity | color 3 | aux 12
constexpr int kCh = 16;    // color 3 | ones | normal 3 | albedo 3 | rough |
                           // metal | depth | pos 3

__global__ void __launch_bounds__(1024) composite_fwd_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    int n_max, int grid_x, int tile_w, int tile_h, float alpha_clamp,
    float alpha_min, float t_min, float* __restrict__ accum,
    float* __restrict__ final_t) {
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
        T = test_t;
      }
    }
    if (__syncthreads_count(done) == P) break;
  }

  float* out = accum + static_cast<size_t>(t) * kCh * P + p;
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[static_cast<size_t>(c) * P] = acc[c];
  final_t[static_cast<size_t>(t) * P + p] = T;
}

}  // namespace

GIGS_API int gigs_composite_fwd(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, int num_tiles, int n_max, int grid_x, int tile_w,
    int tile_h, float alpha_clamp, float alpha_min, float t_min, void* accum,
    void* final_t, void* stream) {
  cudaSetDevice(device);
  composite_fwd_kernel<<<num_tiles, tile_w * tile_h, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      n_max, grid_x, tile_w, tile_h, alpha_clamp, alpha_min, t_min,
      static_cast<float*>(accum), static_cast<float*>(final_t));
  GIGS_RETURN_LAUNCH_STATUS();
}
