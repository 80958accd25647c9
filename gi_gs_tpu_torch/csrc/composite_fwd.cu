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
//   contribute and ends the pixel (forward.cu:423-633). tile_base (the
//   Pallas kernel's meta[1]): the launch's tiles are the image's tiles
//   tile_base, tile_base + 1, ... (one shard's range in tile-sharded
//   training); only the pixel coordinates take the image tile.
//
// Bound on the H100: operations. Every (instance, pixel) pair the walk
//   evaluates after the sub-tile cull below costs the conic power, one exp
//   and, when it contributes, 16 multiply-adds (chip_smoke.py counts 13
//   flops a pair); the bytes (gathered 84-byte rows, the [T, 17, P]
//   output) are a little less. Most pairs are still rejects: a median
//   splat covers a few pixels of a 256-pixel sub-tile.
// Design (composite_walk.cuh): each 16x64 tile is four 16x16 sub-tile
//   CTAs of 256 threads, one pixel each, so several CTAs are resident per
//   SM and a barrier stalls 256 threads, not 1024. Each CTA gathers its
//   tile's sorted rows by id into shared memory in batches of 256 with
//   cp.async (the next batch in flight), drops the rows whose
//   opacity-aware extent misses its rectangle (an exact cull: a dropped
//   pair is one the walk would have skipped), and walks the survivors in
//   order; a warp skips, as a whole, a surviving row whose extent misses
//   its two pixel rows. Each thread runs the sequential renderCUDA
//   recurrence (equivalent to the oracle's chunked cumulative product,
//   whose inclusive transmittance is non-increasing within a chunk). The
//   walk leaves a row only by `continue`, so a warp's lanes reconverge at
//   every row: with the one-block-per-tile kernel's `break` at the done
//   flag, lanes that reject ran ahead of lanes that blend and the warp
//   stayed split until the batch's barrier, which made the sub-tile walk
//   several times slower than the kernel it replaces
//   (tools/composite_variants.py, fwd_break_on_done). A CTA ends once its
//   own 256 pixels are saturated. Per pixel the sequence of evaluated
//   instances and the
//   arithmetic are those of the one-block-per-tile kernel before it, so
//   the outputs are bit for bit the same, except that a NaN power fails
//   the test, as in the plain version and the backward. No cluster: the forward's
//   sub-tiles share nothing, and the four gathers of a row hit L2 (the
//   sub-tiles of a tile are adjacent block indices).
// Peak (forward.cu:577-583): the walk keeps the largest weight w = alpha*T
//   seen so far and the [depth, pos_view xyz] (row columns 17:21) of the
//   first contributing instance that raised it strictly; an instance that
//   only ties an earlier maximum does not replace it. The Pallas body gets
//   the same selection with a first-max-in-chunk argmax; the sequential
//   walk gets it from the strict compare. The kernel is a template on
//   kPeak: the peak=False instantiation carries none of it.
// Resources on the H100 (ptxas; the occupancy calculator, printed by
//   chip_smoke.py): 64 registers per thread in both variants (8 and 16
//   bytes of local spill), 46,208 bytes of static shared memory, 256
//   threads, 4 resident blocks per SM.
#include "common.cuh"
#include "composite_walk.cuh"

using namespace gigs_walk;

namespace {

constexpr int kBatch = 256;

template <bool kPeak>
__global__ void __launch_bounds__(kSubPixels) composite_fwd_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    int tile_base, int n_max, int grid_x, int tile_w, int tile_h,
    float alpha_clamp, float alpha_min, float t_min, float* __restrict__ accum,
    float* __restrict__ final_t, float* __restrict__ peak) {
  __shared__ float rows[2][kBatch][kRow];
  __shared__ int list[kBatch];
  __shared__ float2 ybox[kBatch];
  __shared__ int scratch[32];
  const Layout L = subtile_layout(tile_w, tile_h);
  const SubTile s = locate(L, grid_x, tile_w, tile_h, tile_base);
  const float2 wrows = warp_rows(L, s);
  const int P = tile_w * tile_h;
  const float pxf = static_cast<float>(s.x0 + s.lx);
  const float pyf = static_cast<float>(s.y0 + s.ly);
  const int start = tile_start[s.tile];
  const int count = min(tile_count[s.tile], n_max);

  float T = 1.0f;
  bool done = !s.active;
  float acc[kCh];
#pragma unroll
  for (int c = 0; c < kCh; ++c) acc[c] = 0.0f;
  float max_w = 0.0f;
  float pk[4] = {0.0f, 0.0f, 0.0f, 0.0f};

  if (count > 0) {
    gather_rows_async(rows[0], table, ids, start, min(kBatch, count));
  }
  __pipeline_commit();
  for (int base = 0, buf = 0; base < count; base += kBatch, buf ^= 1) {
    const int nb = min(kBatch, count - base);
    const int next = base + kBatch;
    // rows[buf ^ 1] was last read in the previous batch, which the vote
    // at its end closed
    if (next < count)
      gather_rows_async(rows[buf ^ 1], table, ids, start + next,
                        min(kBatch, count - next));
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    const float(*rb)[kRow] = rows[buf];
    const int n_keep =
        compact(rb, nb, s, alpha_min, list, ybox, nullptr, scratch);
    // Every early-out of a row is a `continue` and the loop's one exit is
    // its condition, so a warp's lanes reconverge at every row (a `break`
    // on the done flag left the warp split until the batch's barrier); a
    // row whose extent misses the warp's image rows is skipped by the
    // whole warp.
    for (int j = 0; j < n_keep; ++j) {
      const float2 yb = ybox[j];
      if (done || yb.y < wrows.x || yb.x > wrows.y) continue;
      const float* row = rb[list[j]];
      const float dx = row[0] - pxf;
      const float dy = row[1] - pyf;
      const float power =
          -0.5f * (row[2] * dx * dx + row[4] * dy * dy) - row[3] * dx * dy;
      if (!(power <= 0.0f)) continue;   // a NaN power fails, as in the plain
      const float alpha = fminf(alpha_clamp, row[5] * expf(power));
      if (alpha < alpha_min) continue;
      const float test_t = T * (1.0f - alpha);
      if (test_t < t_min) {
        done = true;
        continue;
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
    if (__syncthreads_count(done) == static_cast<int>(blockDim.x)) break;
  }
  __pipeline_wait_prior(0);   // no copy in flight when the CTA exits
  if (!s.active) return;

  float* out = accum + static_cast<size_t>(s.tile) * kCh * P + s.p;
#pragma unroll
  for (int c = 0; c < kCh; ++c) out[static_cast<size_t>(c) * P] = acc[c];
  final_t[static_cast<size_t>(s.tile) * P + s.p] = T;
  if constexpr (kPeak) {
    float* pout = peak + static_cast<size_t>(s.tile) * 4 * P + s.p;
#pragma unroll
    for (int c = 0; c < 4; ++c) pout[static_cast<size_t>(c) * P] = pk[c];
  }
}

template <bool kPeak>
int launch(const void* table, const void* ids, const void* tile_start,
           const void* tile_count, int num_tiles, int tile_base, int n_max,
           int grid_x, int tile_w, int tile_h, float alpha_clamp,
           float alpha_min, float t_min, void* accum, void* final_t,
           void* peak, void* stream) {
  const Layout L = subtile_layout(tile_w, tile_h);
  composite_fwd_kernel<kPeak>
      <<<num_tiles * L.nx * L.ny, subtile_threads(L), 0,
         static_cast<cudaStream_t>(stream)>>>(
          static_cast<const float*>(table), static_cast<const int*>(ids),
          static_cast<const int*>(tile_start),
          static_cast<const int*>(tile_count), tile_base, n_max, grid_x,
          tile_w, tile_h, alpha_clamp, alpha_min, t_min,
          static_cast<float*>(accum),
          static_cast<float*>(final_t), static_cast<float*>(peak));
  GIGS_RETURN_LAUNCH_STATUS();
}

}  // namespace

// Composites the num_tiles tiles tile_base, tile_base + 1, ... of the
// image (grid_x tiles a row): accum [num_tiles, 16, P] and final_t
// [num_tiles, P]; tile_start and tile_count hold num_tiles entries.
GIGS_API int gigs_composite_fwd(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, int num_tiles, int tile_base, int n_max,
    int grid_x, int tile_w, int tile_h, float alpha_clamp, float alpha_min,
    float t_min, void* accum, void* final_t, void* stream) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<false>(table, ids, tile_start, tile_count, num_tiles,
                       tile_base, n_max, grid_x, tile_w, tile_h, alpha_clamp,
                       alpha_min, t_min, accum, final_t, nullptr, stream);
}

// As gigs_composite_fwd over the whole image (tile_base 0: the argmax
// render is single-device only), plus peak [T, 4, P]: depth and pos_view
// xyz of each pixel's argmax-weight instance (0 where nothing
// contributed).
GIGS_API int gigs_composite_fwd_peak(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, int num_tiles, int n_max, int grid_x, int tile_w,
    int tile_h, float alpha_clamp, float alpha_min, float t_min, void* accum,
    void* final_t, void* peak, void* stream) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return launch<true>(table, ids, tile_start, tile_count, num_tiles, 0,
                      n_max, grid_x, tile_w, tile_h, alpha_clamp, alpha_min,
                      t_min, accum, final_t, peak, stream);
}

// Registers, shared memory and resident blocks per SM of either variant at
// a tile shape (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_composite_fwd_resources(int device, int peak, int tile_w,
                                          int tile_h, int* out) {
  const cudaError_t err = gigs_use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = subtile_threads(subtile_layout(tile_w, tile_h));
  return peak ? gigs_kernel_resources(composite_fwd_kernel<true>, threads, 0,
                                      out)
              : gigs_kernel_resources(composite_fwd_kernel<false>, threads, 0,
                                      out);
}
