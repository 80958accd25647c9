// The sub-tile walk shared by composite_fwd.cu and composite_bwd.cu.
//
// A tile of tile_h x tile_w pixels (at most 1024) is split into sub-tiles
// of at most 256 pixels, one CTA each, one thread per pixel: a tile of 256
// pixels or fewer is one sub-tile; otherwise sub-tiles are 16x16, or as
// wide as a tile narrower than 16 columns (as high as a tile lower than 16
// rows) and 256 pixels long the other way, ragged at the tile's right and
// bottom edges (16x64 -> four 16x16; never more than 8). The
// rectangles come from the tile grid, so padded columns past the image are
// composited as the plain version composites them. Python's twin of the
// rule is composite.subtile_layout. Block b is sub-tile b % n_sub of the
// launch's tile b / n_sub, which is tile tile_base + b / n_sub of the
// image: a launch may composite a contiguous range of the image's tiles
// (tile-sharded compositing), with tile_start, tile_count and the outputs
// indexed by the range's own tiles.
//
// Each CTA walks its tile's sorted instances (cut to n_max in the tile's
// order first) in batches gathered by id into shared memory with cp.async
// (4-byte granules: rows are 84 bytes), the next batch in flight while the
// current one is culled and walked. The cull (subtile_keep, one thread per
// row) drops a row only if no pixel of the CTA's rectangle can pass
// `power <= 0 and min(clamp, op * exp(power)) >= alpha_min` in the
// kernels' f32 arithmetic; compact() keeps the survivors in their order.
// A dropped pair is one the per-pixel walk would have skipped without
// touching any state, so each pixel sees the same sequence as without the
// cull.
#pragma once

#include <cuda_pipeline.h>
#include <math.h>

namespace gigs_walk {

constexpr int kRow = 21;        // means2d 2 | conic 3 | opacity | color 3 |
                                // aux 12
constexpr int kCh = 16;         // color 3 | ones | normal 3 | albedo 3 |
                                // rough | metal | depth | pos 3
constexpr int kSubPixels = 256;
constexpr int kSubW = 16;
constexpr unsigned kFull = 0xffffffffu;

// Cull slack; composite._subtile_keep_plain states the derivation.
constexpr double kOpSlack = 1e-6;
constexpr double kTauAbs = 1e-5;
constexpr double kTauRel = 1e-3;
constexpr double kKappa = 64.0 / 16777216.0;   // 64 f32 half-ulps of 1
constexpr double kPx = 0.5;

struct Layout {
  int sw, sh, nx, ny;
};

__host__ __device__ inline Layout subtile_layout(int tile_w, int tile_h) {
  if (tile_w * tile_h <= kSubPixels) return {tile_w, tile_h, 1, 1};
  int sw = kSubW;
  if (tile_w < kSubW) {
    sw = tile_w;
  } else if (tile_h < kSubW) {
    sw = tile_w < kSubPixels / tile_h ? tile_w : kSubPixels / tile_h;
  }
  const int sh = tile_h < kSubPixels / sw ? tile_h : kSubPixels / sw;
  return {sw, sh, (tile_w + sw - 1) / sw, (tile_h + sh - 1) / sh};
}

// Threads of one sub-tile CTA: its pixels, rounded up to whole warps.
__host__ __device__ inline int subtile_threads(const Layout& L) {
  return (L.sw * L.sh + 31) / 32 * 32;
}

struct SubTile {
  int tile;      // the launch's tile (row of tile_start, tile_count, outputs)
  int x0, y0;    // image pixel of the sub-tile's top-left pixel
  int w, h;      // the sub-tile's extent (ragged at the tile's edges)
  int lx, ly;    // this thread's pixel in the sub-tile
  int p;         // this thread's pixel index in the tile
  bool active;   // false for the threads past a ragged or partial sub-tile
};

__device__ inline SubTile locate(const Layout& L, int grid_x, int tile_w,
                                 int tile_h, int tile_base) {
  const int n_sub = L.nx * L.ny;
  SubTile s;
  s.tile = blockIdx.x / n_sub;
  const int sub = blockIdx.x - s.tile * n_sub;
  const int sy = sub / L.nx;
  const int sx = sub - sy * L.nx;
  const int image_tile = tile_base + s.tile;
  const int trow = image_tile / grid_x;
  const int tcol = image_tile - trow * grid_x;
  const int tx0 = sx * L.sw;
  const int ty0 = sy * L.sh;
  s.w = min(L.sw, tile_w - tx0);
  s.h = min(L.sh, tile_h - ty0);
  s.x0 = tcol * tile_w + tx0;
  s.y0 = trow * tile_h + ty0;
  s.ly = threadIdx.x / L.sw;
  s.lx = threadIdx.x - s.ly * L.sw;
  s.active = s.ly < s.h && s.lx < s.w;
  s.p = (ty0 + s.ly) * tile_w + tx0 + s.lx;
  return s;
}

// False only if no pixel of the sub-tile can pass the alpha test of `row`:
// the opacity-aware ellipse d^T C d <= tau, tau = 2 ln(op / alpha_min)
// (ln in f32: its error is far below kTauAbs), widened for the f32
// evaluation of power, exp and op * G by kTauAbs, kTauRel and 1 / (1 -
// kKappa * kappa) (kappa = ac / det, the conic's conditioning), and its
// bounding box by kPx. The box test is squared (no sqrt, no division):
// the sub-tile is left of the box iff u = x0 - kPx - mx > 0 and u^2 (det
// - kKappa ac) > tau c. In float64, where a, c, b^2 and ac are exact.
// Never culls a row with a conic that is not positive definite or too
// ill-conditioned (det - kKappa ac <= det / 2), or with a non-finite
// value (every comparison with NaN is false). For a kept row, rows
// [ylo, yhi] (rounded outward to f32) hold every image row where it can
// pass: the box's y extent, or all rows where it has none.
__device__ inline bool subtile_keep(const float* row, const SubTile& s,
                                    float alpha_min, float& ylo,
                                    float& yhi) {
  ylo = -INFINITY;
  yhi = INFINITY;
  const float op = row[5];
  if (static_cast<double>(op) * (1.0 + kOpSlack) <
      static_cast<double>(alpha_min))
    return false;
  const double a = row[2], b = row[3], c = row[4];
  const double det = a * c - b * b;
  const double dk = det - kKappa * (a * c);
  if (!(a > 0.0 && dk > 0.5 * det)) return true;
  const double tau =
      (2.0 * static_cast<double>(logf(op / alpha_min)) + kTauAbs) *
      (1.0 + kTauRel);
  const double tx = tau * c, ty = tau * a;
  const double mx = row[0], my = row[1];
  const double left = s.x0 - kPx - mx, right = mx - kPx - (s.x0 + s.w - 1);
  const double top = s.y0 - kPx - my, bottom = my - kPx - (s.y0 + s.h - 1);
  if ((left > 0.0 && left * left * dk > tx) ||
      (right > 0.0 && right * right * dk > tx) ||
      (top > 0.0 && top * top * dk > ty) ||
      (bottom > 0.0 && bottom * bottom * dk > ty))
    return false;
  const double hy = sqrt(ty / dk) + kPx;
  if (hy == hy) {   // not NaN
    ylo = __double2float_rd(my - hy);
    yhi = __double2float_ru(my + hy);
  }
  return true;
}

// Start copying rows ids[first .. first + nb) of the table into dst.
__device__ inline void gather_rows_async(float (*dst)[kRow],
                                         const float* __restrict__ table,
                                         const int* __restrict__ ids,
                                         int first, int nb) {
  for (int e = threadIdx.x; e < nb * kRow; e += blockDim.x) {
    const int r = e / kRow;
    const int c = e - r * kRow;
    __pipeline_memcpy_async(
        &dst[r][c], table + static_cast<size_t>(ids[first + r]) * kRow + c,
        sizeof(float));
  }
}

// The indices k < nb of `rows` that subtile_keep keeps, in increasing
// order, into list[0 .. n), with their row extents in ybox[0 .. n);
// returns n. With jmap, also jmap[k] = the position of k in list, or -1.
// Every thread of the block calls it (blockDim.x a multiple of 32); it
// ends with a block barrier.
__device__ inline int compact(const float (*rows)[kRow], int nb,
                              const SubTile& s, float alpha_min, int* list,
                              float2* ybox, int* jmap, int* scratch) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int total = 0;
  for (int r0 = 0; r0 < nb; r0 += blockDim.x) {
    const int k = r0 + threadIdx.x;
    float ylo = 0.0f, yhi = 0.0f;
    const bool keep =
        k < nb && subtile_keep(rows[k], s, alpha_min, ylo, yhi);
    const unsigned bal = __ballot_sync(kFull, keep);
    if (lane == 0) scratch[warp] = __popc(bal);
    __syncthreads();
    int off = total, round = 0;
    for (int w = 0; w < n_warps; ++w) {
      if (w == warp) off += round;
      round += scratch[w];
    }
    const int j = off + __popc(bal & ((1u << lane) - 1u));
    if (keep) {
      list[j] = k;
      ybox[j] = make_float2(ylo, yhi);
    }
    if (jmap != nullptr && k < nb) jmap[k] = keep ? j : -1;
    total += round;
    __syncthreads();
  }
  return total;
}

// The image rows [lo, hi] a warp's pixels lie on (its lanes are whole
// sub-tile rows of width sw, or part of one).
__device__ inline float2 warp_rows(const Layout& L, const SubTile& s) {
  const int first = (threadIdx.x & ~31) / L.sw;
  const int last = ((threadIdx.x | 31)) / L.sw;
  return make_float2(static_cast<float>(s.y0 + first),
                     static_cast<float>(s.y0 + last));
}

}  // namespace gigs_walk
