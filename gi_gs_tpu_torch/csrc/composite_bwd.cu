// Tile compositing backward: per-sorted-instance gradient rows of the
// 16-channel G-buffer blend and its final transmittance.
//
// Replaces: gi_gs_tpu/ops/rasterize/pallas_composite.py:composite_bwd_pallas
//   (_bwd_kernel). Semantics of the jnp oracle
//   gi_gs_tpu/ops/rasterize/composite.py:_composite_bwd, with the CUDA
//   reference's quirks (backward.cu:404-630): only colour and opacity
//   couple into d(alpha); no gating by the 0.99 alpha clamp; the normal
//   cotangent is zeroed on the 1-px border of the true image; final_T is a
//   differentiable output. tile_base (the Pallas kernel's meta[1]): the
//   launch's tiles are the image's tiles tile_base, tile_base + 1, ...
//   (one shard's range in tile-sharded training); the pixel coordinates
//   and the border test take the image tile.
//
// Per (instance, pixel) pair the walk replays the forward front to back
// (the forward's done flag, early termination and n_max cut) and uses the
// collapsed single-prefix form of the Pallas kernel:
//   d_alpha = T gF - (gA - S) / (1 - a) - g_t T_final / (1 - a),
// with gF = sum_ch F_ch g_ch over the 4 coupled channels, gA =
// sum_ch g_ch accum_ch, and S the running inclusive prefix of w gF. The
// per-pixel state is T, done and S; no back-to-front division.
//
// Bound on the H100: operations. Every pair the walk evaluates after the
//   sub-tile cull recomputes the conic power and one exp (~13 flops;
//   chip_smoke.py counts the plain cull's pairs), and a contributing pair
//   adds ~50
//   flops of gradient terms and its share of the 21-value reduction; the
//   bytes (84-byte rows gathered by id, the [T, 16, P] cotangents, the
//   forward's [T, 5, P] planes, the [cap, 21] output) take less time at
//   3.35 TB/s than those flops at 67 TFLOP/s (chip_smoke.py computes both).
// Design (composite_walk.cuh): each 16x64 tile is four 16x16 sub-tile
//   CTAs of 256 threads, one pixel each, launched as a thread-block
//   cluster of four (the sub-tile count of the tile shape). Each CTA
//   gathers the tile's rows in batches of 64 with cp.async (the next batch
//   in flight), culls the rows whose opacity-aware extent misses its
//   rectangle, and walks the survivors in order (a warp skips a row whose
//   extent misses its two pixel rows); the per-pixel cotangents, gA and
//   g_t T_final sit in registers, so the walk reads no global
//   memory. For each surviving row, a warp where some lane contributes
//   (__ballot_sync) reduces its 21 values (padded to 32) with one
//   transpose-reduce by recursive halving: 31 shuffle-adds leave column c
//   of the warp's sum in lane c, which writes it to shared memory. At the
//   end of a batch each CTA sums its 8 warps' rows in warp order (skipping
//   warps that did not contribute), then, after a cluster barrier, CTA q
//   of the cluster sums the four CTAs' rows of its quarter of the batch in
//   rank order through distributed shared memory and writes them. No
//   atomics: two launches on one input give bit-identical rows. A CTA
//   whose pixels are all saturated stops gathering and walking but keeps
//   joining the cluster barriers with zero rows until every CTA of the
//   tile is saturated or the tile's rows are exhausted; rows not reached
//   stay 0 (the wrapper zero-fills the output). No per-tile array is
//   sized by cap_tile.
//   Batch size by measurement (tools/composite_variants.py): 64 rows; 32
//   and 128 were slower (the 128 batch doubles the per-warp partials to 86
//   KB and leaves one CTA per SM). A path that stores a lone contributing
//   lane's row without the shuffles was no faster (bwd_lone_lane), so the
//   reduction is not what holds the kernel now.
// Resources on the H100 (ptxas; the occupancy calculator, printed by
//   chip_smoke.py): 80 registers per thread, 66,184 bytes of dynamic
//   shared memory, 256 threads, 3 resident blocks per SM, 92 clusters of 4
//   on the card at once.
#include "common.cuh"
#include "composite_walk.cuh"

#include <cooperative_groups.h>

using namespace gigs_walk;
namespace cg = cooperative_groups;

namespace {

constexpr int kBatch = 64;
constexpr int kWarps = kSubPixels / 32;

struct Smem {
  float rows[2][kBatch][kRow];      // gathered rows, double-buffered
  float cpart[2][kBatch][kRow];     // the CTA's rows, read by the cluster
  float wpart[kWarps][kBatch][kRow];  // per warp, per surviving row
  unsigned char wflag[kWarps][kBatch];  // the warp contributed to the row
  int list[kBatch];                 // surviving rows, in order
  float2 ybox[kBatch];              // their image-row extents
  int jmap[kBatch];                 // row -> its place in list, or -1
  int scratch[32];
  int saturated[2];                 // every pixel of the CTA is done
};

// One halving step: lanes with bit kHalf set keep columns [kHalf, 2 kHalf)
// of their v[0 .. 2 kHalf), the others [0, kHalf), each adding the
// partner lane's copy; the kept columns move to v[0 .. kHalf).
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[32], int lane) {
  const bool up = (lane & kHalf) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = up ? v[i] : v[i + kHalf];
    const float keep = up ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, kHalf);
  }
}

// Sums column c of the 32 lanes' v[0..31] into lane c (recursive halving:
// 16 + 8 + 4 + 2 + 1 shuffle-adds, in a fixed order).
__device__ __forceinline__ float transpose_reduce(float (&v)[32], int lane) {
  halve<16>(v, lane);
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0];
}

__global__ void __launch_bounds__(kSubPixels) composite_bwd_kernel(
    const float* __restrict__ table, const int* __restrict__ ids,
    const int* __restrict__ tile_start, const int* __restrict__ tile_count,
    const float* __restrict__ accum4, const float* __restrict__ final_t,
    const float* __restrict__ g_acc, const float* __restrict__ g_t,
    int tile_base, int n_max, int grid_x, int tile_w, int tile_h, int img_h,
    int img_w, float alpha_clamp, float alpha_min, float t_min,
    float* __restrict__ grads) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_sub = static_cast<int>(cluster.num_blocks());
  const Layout L = subtile_layout(tile_w, tile_h);
  const SubTile s = locate(L, grid_x, tile_w, tile_h, tile_base);
  const float2 wrows = warp_rows(L, s);
  const int P = tile_w * tile_h;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int ix = s.x0 + s.lx;
  const int iy = s.y0 + s.ly;
  const float pxf = static_cast<float>(ix);
  const float pyf = static_cast<float>(iy);
  const int start = tile_start[s.tile];
  const int count = min(tile_count[s.tile], n_max);
  const int n_batches = (count + kBatch - 1) / kBatch;

  // Per-pixel cotangents and forward outputs, in registers.
  float g[kCh];
  float gA = 0.0f, gtT = 0.0f;
#pragma unroll
  for (int c = 0; c < kCh; ++c) g[c] = 0.0f;
  if (s.active) {
    const size_t tp = static_cast<size_t>(s.tile) * P + s.p;
    const float* gp = g_acc + static_cast<size_t>(s.tile) * kCh * P + s.p;
    const float* acc = accum4 + static_cast<size_t>(s.tile) * 4 * P + s.p;
#pragma unroll
    for (int c = 0; c < kCh; ++c) g[c] = gp[static_cast<size_t>(c) * P];
    gA = g[0] * acc[0] + g[1] * acc[P] + g[2] * acc[2 * P] + g[3] * acc[3 * P];
    gtT = g_t[tp] * final_t[tp];
    // Normal cotangent zeroed on the 1-px true-image border (and beyond).
    const float inside =
        (ix > 0 && ix < img_w - 1 && iy > 0 && iy < img_h - 1) ? 1.0f : 0.0f;
#pragma unroll
    for (int c = 4; c < 7; ++c) g[c] *= inside;
  }

  float T = 1.0f;
  float S = 0.0f;
  bool done = !s.active;
  bool saturated = false;   // block-uniform: every pixel of the CTA done

  if (count > 0)
    gather_rows_async(sm.rows[0], table, ids, start, min(kBatch, count));
  __pipeline_commit();
  for (int bi = 0; bi < n_batches; ++bi) {
    const int par = bi & 1;
    const int base = bi * kBatch;
    const int nb = min(kBatch, count - base);
    // rows[par ^ 1] was last read in the previous batch, closed by its
    // cluster barrier
    if (!saturated && bi + 1 < n_batches)
      gather_rows_async(sm.rows[par ^ 1], table, ids, start + base + kBatch,
                        min(kBatch, count - base - kBatch));
    __pipeline_commit();
    __pipeline_wait_prior(1);
    __syncthreads();
    float(*part)[kRow] = sm.cpart[par];
    if (!saturated) {
      const float(*rb)[kRow] = sm.rows[par];
      const int n_keep = compact(rb, nb, s, alpha_min, sm.list, sm.ybox,
                                 sm.jmap, sm.scratch);
      for (int j = 0; j < n_keep; ++j) {
        const float2 yb = sm.ybox[j];
        if (yb.y < wrows.x || yb.x > wrows.y) {
          // no pixel of the warp can pass the row
          if (lane == 0) sm.wflag[warp][j] = 0;
          continue;
        }
        const float* row = rb[sm.list[j]];
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
                const float gF =
                    row[6] * g[0] + row[7] * g[1] + row[8] * g[2] + g[3];
                S += w * gF;
                const float recip = 1.0f / (1.0f - alpha);
                d_alpha = T * gF - recip * (gA - S) - gtT * recip;
                T = test_t;
              }
            }
          }
        }
        if (__ballot_sync(kFull, contrib) == 0u) {
          if (__all_sync(kFull, done)) {
            // the warp is saturated: no later row of the batch reaches it
            for (int jj = j + lane; jj < n_keep; jj += 32)
              sm.wflag[warp][jj] = 0;
            break;
          }
          if (lane == 0) sm.wflag[warp][j] = 0;
          continue;
        }
        float v[32];
#pragma unroll
        for (int c = 0; c < 32; ++c) v[c] = 0.0f;
        if (contrib) {
          // CUDA quirk: d(alpha)/dG = opacity, ignoring the 0.99 clamp.
          const float h = row[5] * d_alpha * G;  // dL/dG * G
          const float cxx = row[2], cxy = row[3], cyy = row[4];
          v[0] = h * -(cxx * dx + cxy * dy);
          v[1] = h * -(cyy * dy + cxy * dx);
          v[2] = h * (-0.5f * dx * dx);
          v[3] = h * (-dx * dy);
          v[4] = h * (-0.5f * dy * dy);
          v[5] = G * d_alpha;
          v[6] = w * g[0];
          v[7] = w * g[1];
          v[8] = w * g[2];
#pragma unroll
          for (int c = 4; c < kCh; ++c) v[c + 5] = w * g[c];
        }
        const float col = transpose_reduce(v, lane);
        if (lane < kRow) sm.wpart[warp][j][lane] = col;
        if (lane == 0) sm.wflag[warp][j] = 1;
      }
      __syncthreads();
      // The CTA's rows: its warps' rows summed in warp order.
      for (int e = threadIdx.x; e < nb * kRow; e += blockDim.x) {
        const int r = e / kRow;
        const int c = e - r * kRow;
        const int j = sm.jmap[r];
        float sum = 0.0f;
        if (j >= 0) {
          for (int wi = 0; wi < static_cast<int>(blockDim.x >> 5); ++wi)
            if (sm.wflag[wi][j]) sum += sm.wpart[wi][j][c];
        }
        part[r][c] = sum;
      }
    } else {
      for (int e = threadIdx.x; e < nb * kRow; e += blockDim.x)
        part[e / kRow][e % kRow] = 0.0f;
    }
    saturated = __syncthreads_and(done) != 0;
    if (threadIdx.x == 0) sm.saturated[par] = saturated;
    cluster.sync();
    // This CTA's share of the batch: the cluster's rows summed in rank
    // order.
    const int per = (nb + n_sub - 1) / n_sub;
    const int r0 = rank * per;
    const int r1 = min(nb, r0 + per);
    for (int e = threadIdx.x; e < (r1 - r0) * kRow; e += blockDim.x) {
      const int r = r0 + e / kRow;
      const int c = e - (r - r0) * kRow;
      float sum = 0.0f;
      for (int q = 0; q < n_sub; ++q)
        sum += cluster.map_shared_rank(&sm.cpart[par][0][0], q)[r * kRow + c];
      grads[static_cast<size_t>(start + base + r) * kRow + c] = sum;
    }
    bool tile_done = true;
    for (int q = 0; q < n_sub; ++q)
      tile_done = tile_done && *cluster.map_shared_rank(&sm.saturated[par], q);
    if (tile_done) break;
  }
  __pipeline_wait_prior(0);   // no copy in flight when the CTA exits
  cluster.sync();             // no CTA leaves while another reads it
}

// Lets composite_bwd_kernel take sizeof(Smem) of dynamic shared memory on
// `device`: a driver call, made once per device, not on every launch.
cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_once_per_device(device, done, [] {
    return cudaFuncSetAttribute(composite_bwd_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(sizeof(Smem)));
  });
}

cudaLaunchAttribute cluster_attr(int n_sub) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = n_sub;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

}  // namespace

// The rows of the instances of the num_tiles tiles tile_base, tile_base +
// 1, ... of the image (the forward's range); the other rows of grads are
// left as they are (the wrapper zero-fills them).
GIGS_API int gigs_composite_bwd(
    int device, const void* table, const void* ids, const void* tile_start,
    const void* tile_count, const void* accum4, const void* final_t,
    const void* g_acc, const void* g_t, int num_tiles, int tile_base,
    int n_max, int grid_x, int tile_w, int tile_h, int img_h, int img_w,
    float alpha_clamp, float alpha_min, float t_min, void* grads,
    void* stream) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  const Layout L = subtile_layout(tile_w, tile_h);
  const int n_sub = L.nx * L.ny;
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = cluster_attr(n_sub);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(num_tiles * n_sub);
  cfg.blockDim = dim3(subtile_threads(L));
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, composite_bwd_kernel, static_cast<const float*>(table),
      static_cast<const int*>(ids), static_cast<const int*>(tile_start),
      static_cast<const int*>(tile_count), static_cast<const float*>(accum4),
      static_cast<const float*>(final_t), static_cast<const float*>(g_acc),
      static_cast<const float*>(g_t), tile_base, n_max, grid_x, tile_w,
      tile_h, img_h, img_w, alpha_clamp, alpha_min, t_min,
      static_cast<float*>(grads));
  if (err != cudaSuccess) return static_cast<int>(err);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM at a tile shape
// (gigs_kernel_resources), plus the cluster size and the clusters the card
// holds at once (cudaOccupancyMaxActiveClusters).
GIGS_API int gigs_composite_bwd_resources(int device, int tile_w, int tile_h,
                                          int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  const Layout L = subtile_layout(tile_w, tile_h);
  const int n_sub = L.nx * L.ny;
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rc = gigs_kernel_resources(composite_bwd_kernel,
                                       subtile_threads(L), sizeof(Smem), out);
  if (rc != 0) return rc;
  cudaLaunchAttribute attr = cluster_attr(n_sub);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_sub * 1024);
  cfg.blockDim = dim3(subtile_threads(L));
  cfg.dynamicSmemBytes = sizeof(Smem);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, composite_bwd_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[6] = n_sub;
  out[7] = clusters;
  return 0;
}
