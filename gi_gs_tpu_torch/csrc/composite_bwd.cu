// Tile compositing backward: per-sorted-instance gradient rows of the
// 16-channel G-buffer blend and its final transmittance.
//
// Replaces: gi_gs_tpu/ops/rasterize/pallas_composite.py:composite_bwd_pallas
//   (_bwd_kernel). Semantics of the jnp oracle
//   gi_gs_tpu/ops/rasterize/composite.py:_composite_bwd, with the CUDA
//   reference's quirks (backward.cu:404-630): only colour and opacity
//   couple into d(alpha); no gating by the 0.99 alpha clamp; the normal
//   cotangent is zeroed on the 1-px border of the true image; final_T is a
//   differentiable output.
//
// Per (instance, pixel) pair the walk replays the forward front to back
// (the forward's done flag, early termination and n_max cut) and uses the
// collapsed single-prefix form of the Pallas kernel:
//   d_alpha = T gF - (gA - S) / (1 - a) - g_t T_final / (1 - a),
// with gF = sum_ch F_ch g_ch over the 4 coupled channels, gA =
// sum_ch g_ch accum_ch, and S the running inclusive prefix of w gF. The
// per-pixel state is T, done and S; no back-to-front division.
//
// Bound on the H100: every evaluated pair recomputes the conic power and
//   one exp (~13 flops), and a contributing pair adds ~40 flops of
//   gradient terms and its share of a 21-value warp reduction; the bytes
//   are the 84-byte rows gathered by id, the [T, 16, P] cotangents, the
//   forward's [T, 5, P] planes and the [cap, 21] output. On an 800x800
//   view of 300k Gaussians (chip_smoke.py) the two give about the same
//   least time, the bytes slightly more; the kernel runs far above both,
//   held by the sequential per-pixel walk and the block barriers of each
//   32-instance batch.
// Design: one block per tile, one thread per pixel (tile_h * tile_w <= 1024,
//   a multiple of 32), as in composite_fwd.cu. The tile's sorted instances
//   are gathered by id into shared memory in batches of 32 rows (no
//   [cap, 128] instance table). For each instance, a warp whose lanes all
//   skip it (the common case: a median splat covers ~3 px) writes a zero
//   partial row; otherwise it sums its lanes' 21 values with a butterfly
//   shuffle and lane 0 writes the warp's partial row into dynamic shared
//   memory ([warps][32][21] floats, 84 KB at 32 warps, opted in with
//   cudaFuncSetAttribute). At the end of each batch the block sums the
//   partial rows in warp order and writes the instance's gradient row, so
//   the result is deterministic (no atomics). Registers: the 4 coupled
//   cotangents, gA and g_t T_final stay in registers; the 12 feature-only
//   cotangents are read from global memory (L1) only by a lane whose pair
//   contributes, which keeps the thread under the 64 registers that 1024
//   threads per block allow. A block-wide vote ends the tile once every
//   pixel is saturated; rows not reached stay 0 (the wrapper zero-fills
//   the output). No per-tile array is sized by cap_tile.
#include "common.cuh"

#include <math.h>

namespace {

constexpr int kBatch = 32;
constexpr int kRow = 21;   // means2d 2 | conic 3 | opacity | color 3 | aux 12
constexpr int kCh = 16;    // color 3 | ones | normal 3 | albedo 3 | rough |
                           // metal | depth | pos 3
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__global__ void __launch_bounds__(1024) composite_bwd_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ accum4, const float* __restrict__ final_t,
    const float* __restrict__ g_acc, const float* __restrict__ g_t,
    int n_max, int grid_x, int tile_w, int tile_h, int img_h, int img_w,
    float alpha_clamp, float alpha_min, float t_min,
    float* __restrict__ grads) {
  __shared__ float rows[kBatch][kRow];
  extern __shared__ float partial[];  // [warps][kBatch][kRow]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int P = blockDim.x;
  const int warp = p >> 5;
  const int lane = p & 31;
  const int n_warps = P >> 5;
  const int trow = t / grid_x;
  const int tcol = t - trow * grid_x;
  const int ly = p / tile_w;
  const int lx = p - ly * tile_w;
  const int ix = tcol * tile_w + lx;
  const int iy = trow * tile_h + ly;
  const float pxf = static_cast<float>(ix);
  const float pyf = static_cast<float>(iy);
  const int start = tile_start[t];
  const int count = min(tile_count[t], n_max);

  // Per-pixel cotangents and forward outputs.
  const size_t tp = static_cast<size_t>(t) * P + p;
  const float* g = g_acc + static_cast<size_t>(t) * kCh * P + p;
  const float* acc = accum4 + static_cast<size_t>(t) * 4 * P + p;
  const float g0 = g[0], g1 = g[P], g2 = g[2 * P], g3 = g[3 * P];
  const float gA = g0 * acc[0] + g1 * acc[P] + g2 * acc[2 * P] + g3 * acc[3 * P];
  const float gtT = g_t[tp] * final_t[tp];
  // Normal cotangent zeroed on the 1-px true-image border (and beyond).
  const float inside =
      (ix > 0 && ix < img_w - 1 && iy > 0 && iy < img_h - 1) ? 1.0f : 0.0f;

  float T = 1.0f;
  float S = 0.0f;
  bool done = false;

  for (int base = 0; base < count; base += kBatch) {
    const int nb = min(kBatch, count - base);
    __syncthreads();  // the previous batch's rows are consumed
    for (int e = p; e < nb * kRow; e += P) {
      const int r = e / kRow;
      const int c = e - r * kRow;
      rows[r][c] = table[static_cast<size_t>(ids[start + base + r]) * kRow + c];
    }
    __syncthreads();
    for (int k = 0; k < nb; ++k) {
      const float* row = rows[k];
      bool contrib = false;
      float dx = 0.0f, dy = 0.0f, G = 0.0f, w = 0.0f, d_alpha = 0.0f;
      if (!done) {
        dx = row[0] - pxf;
        dy = row[1] - pyf;
        const float power =
            -0.5f * (row[2] * dx * dx + row[4] * dy * dy) - row[3] * dx * dy;
        if (power <= 0.0f) {
          G = expf(power);
          const float alpha = fminf(alpha_clamp, row[5] * G);
          if (alpha >= alpha_min) {
            const float test_t = T * (1.0f - alpha);
            if (test_t < t_min) {
              done = true;
            } else {
              contrib = true;
              w = alpha * T;
              const float gF = row[6] * g0 + row[7] * g1 + row[8] * g2 + g3;
              S += w * gF;
              const float recip = 1.0f / (1.0f - alpha);
              d_alpha = T * gF - recip * (gA - S) - gtT * recip;
              T = test_t;
            }
          }
        }
      }
      float* out = partial + (warp * kBatch + k) * kRow;
      if (__ballot_sync(kFull, contrib) == 0u) {
        if (lane < kRow) out[lane] = 0.0f;
        continue;
      }
      // CUDA quirk: d(alpha)/dG = opacity, ignoring the 0.99 clamp.
      const float h = row[5] * d_alpha * G;  // dL/dG * G
      const float cxx = row[2], cxy = row[3], cyy = row[4];
      float s;
      s = warp_sum(h * -(cxx * dx + cxy * dy));
      if (lane == 0) out[0] = s;
      s = warp_sum(h * -(cyy * dy + cxy * dx));
      if (lane == 0) out[1] = s;
      s = warp_sum(h * (-0.5f * dx * dx));
      if (lane == 0) out[2] = s;
      s = warp_sum(h * (-dx * dy));
      if (lane == 0) out[3] = s;
      s = warp_sum(h * (-0.5f * dy * dy));
      if (lane == 0) out[4] = s;
      s = warp_sum(G * d_alpha);
      if (lane == 0) out[5] = s;
      s = warp_sum(w * g0);
      if (lane == 0) out[6] = s;
      s = warp_sum(w * g1);
      if (lane == 0) out[7] = s;
      s = warp_sum(w * g2);
      if (lane == 0) out[8] = s;
#pragma unroll
      for (int ch = 4; ch < kCh; ++ch) {
        float gv = contrib ? g[static_cast<size_t>(ch) * P] : 0.0f;
        if (ch < 7) gv *= inside;
        s = warp_sum(w * gv);
        if (lane == 0) out[ch + 5] = s;
      }
    }
    __syncthreads();
    // Sum the warps' partial rows in warp order.
    for (int e = p; e < nb * kRow; e += P) {
      const int r = e / kRow;
      const int c = e - r * kRow;
      float s = 0.0f;
      for (int wi = 0; wi < n_warps; ++wi) s += partial[(wi * kBatch + r) * kRow + c];
      grads[static_cast<size_t>(start + base + r) * kRow + c] = s;
    }
    if (__syncthreads_count(done) == P) break;
  }
}

}  // namespace

GIGS_API int gigs_composite_bwd(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, const void* accum4, const void* final_t,
    const void* g_acc, const void* g_t, int num_tiles, int n_max, int grid_x,
    int tile_w, int tile_h, int img_h, int img_w, float alpha_clamp,
    float alpha_min, float t_min, void* grads, void* stream) {
  cudaSetDevice(device);
  const int threads = tile_w * tile_h;
  const size_t smem =
      static_cast<size_t>(threads / 32) * kBatch * kRow * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      composite_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  composite_bwd_kernel<<<num_tiles, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int*>(ids),
      static_cast<const int*>(tile_start), static_cast<const int*>(tile_count),
      static_cast<const float*>(accum4), static_cast<const float*>(final_t),
      static_cast<const float*>(g_acc), static_cast<const float*>(g_t), n_max,
      grid_x, tile_w, tile_h, img_h, img_w, alpha_clamp, alpha_min, t_min,
      static_cast<float*>(grads));
  GIGS_RETURN_LAUNCH_STATUS();
}
