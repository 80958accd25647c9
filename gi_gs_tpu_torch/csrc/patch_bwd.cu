// Transpose of the GGX prefilter's locally connected halo filter:
//   pad_bar[f, c, Y, X] = sum_{dy, dx} g[f, c, Y - dy, X - dx] * W[f, dy * P + dx, Y - dy, X - dx]
// over the offsets whose source texel (Y - dy, X - dx) lies in [0, R)^2.
//
// Replaces: gi_gs_tpu/ops/pallas_patch.py:patch_apply_bwd (_bwd_kernel,
//   pallas_patch.py:61-80), the scatter form
//   pad_bar[f, c, y + dy, x + dx] += g[f, c, y, x] * W[f, p, y, x].
//   W [6, P^2, R, R] is the static weight table of cubemap._patch_tables,
//   g [6, 3, R, R] the cotangent of the filtered level, pad_bar
//   [6, 3, R + 2h, R + 2h] the cotangent of the halo-padded faces
//   (P = 2h + 1).
//
// Bound on the H100: bytes. W is read once (6 P^2 R^2 floats: 354 MB at
//   R = 256, P = 15; 661 MB at R = 128, P = 41; 319 MB at R = 64, P = 57)
//   against 6 flops per weight.
// Summation order: for each output texel, the offsets in order
//   p = dy * P + dx = 0 .. P^2 - 1 (dy outer, dx inner), each product
//   g * W added to one running f32 sum, as `_patch_bwd_plain` adds them.
// Design: the gather form. One thread owns one padded output texel
//   (f, Y, X) and its three channels, so nothing is atomic and the result
//   is deterministic and bit-equal to the plain version.
//   - A CTA owns one padded output row Y of a face, 32 columns per
//     consumer warp (all E = R + P - 1 columns at R <= 256: one CTA per
//     row), and one producer warp.
//   - Output row Y gathers, for each dy, source row y = Y - dy of the P
//     planes (dy, dx) and of g. So W is read as whole rows: each W row is
//     read by exactly one CTA, as one contiguous bulk copy (256 B to 1 KB),
//     and no DRAM line it touches is shared with a CTA that may reach it
//     much later.
//   - A ring of kStages stages with full / empty mbarriers; a stage is
//     one dy: the ndx W rows and the 3 g rows, each the segment [s0, s1)
//     of its row that the CTA's columns reach. The producer warp's lanes
//     issue a stage's copies in parallel.
//   - Staged rows are G >= P - 1 floats apart, and the gaps are zeroed
//     once: a lane whose source column X - dx falls outside the face reads
//     0 from both W and g and adds 0 * 0 = +0, which leaves a running sum
//     that starts at +0 (and so is never -0) unchanged. So every lane runs
//     the same offset loop, with no bounds and no selects, and the offset
//     range is cut per CTA to the rows and columns that reach the face.
//   - Per weight: one shared load of W, three of g (immediate offsets),
//     3 FMUL and 3 FADD (-fmad=false), one pointer add; 32-bit indices.
#include "common.cuh"

namespace {

constexpr int kMaxWarpsX = 16;                     // CTA columns <= 512
constexpr int kMaxThreads = 32 * (kMaxWarpsX + 1);
constexpr int kStages = 2;
constexpr int kMaxSmem = 232448;                   // the H100's opt-in limit
constexpr int kTailPad = 32;   // floats past the ring a lane beyond E reads

// The launch shape of one level (R, P), in floats where not said.
struct Shape {
  int nwx;     // consumer warps of a CTA: 32 columns each
  int tx;      // columns of a CTA
  int chunks;  // CTAs across a padded row
  int G;       // zero gap before each staged row: P - 1 rounded up to 4
  int S;       // staged row stride: the longest segment plus the gap
  int stage;   // floats per stage: G + (P + 3) S
  int smem;    // bytes: the ring, the tail pad, the barriers
};

Shape shape_of(int R, int P) {
  Shape c;
  const int E = R + P - 1;
  c.nwx = min((E + 31) / 32, kMaxWarpsX);
  c.tx = 32 * c.nwx;
  c.chunks = (E + c.tx - 1) / c.tx;
  c.G = (P - 1 + 3) & ~3;
  c.S = min(R, (c.tx + P + 2 + 3) & ~3) + c.G;
  c.stage = c.G + (P + 3) * c.S;
  c.smem = (kStages * c.stage + kTailPad) * 4 + 2 * kStages * 8;
  return c;
}

__global__ void __launch_bounds__(kMaxThreads) patch_bwd_kernel(
    const float* __restrict__ W, const float* __restrict__ g,
    float* __restrict__ out, int R, int P, int tx, int G, int S,
    int stage) {
  extern __shared__ __align__(128) float ring[];
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * stage +
                                               kTailPad);
  uint64_t* empty = full + kStages;

  const int f = blockIdx.z;
  const int Y = blockIdx.y;
  const int X0 = blockIdx.x * tx;
  const int nwx = tx / 32;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Offsets whose source texel can lie in the face for this row and these
  // columns; the row segment [s0, s0 + L) every staged row holds.
  const int dy0 = max(0, Y - R + 1), dy1 = min(P - 1, Y);
  const int dx0 = max(0, X0 - R + 1), dx1 = min(P - 1, X0 + tx - 1);
  const int ndx = dx1 - dx0 + 1;
  const int s0 = max(0, X0 - (P - 1)) & ~3;
  const int L = min(R, X0 + tx) - s0;

  // Zero each stage's leading gap and every staged row's tail (no copy
  // writes there), one warp per gap.
  const int rows = P + 3;
  for (int q = warp; q < kStages * (rows + 1); q += nwx + 1) {
    float* st = ring + (q / (rows + 1)) * stage;
    const int k = q % (rows + 1);
    const int lo = k == 0 ? 0 : G + (k - 1) * S + L;
    const int hi = k == 0 ? G : G + k * S;
    for (int i = lo + lane; i < hi; i += 32) st[i] = 0.0f;
  }
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      gigs_mbar_init(&full[s], 1);
      gigs_mbar_init(&empty[s], nwx);
    }
    gigs_mbar_fence_init();
  }
  __syncthreads();

  if (warp == nwx) {
    // Producer: stage `it` holds dy = dy0 + it; its lanes copy the rows.
    const int RR = R * R;
    const float* wf = W + static_cast<size_t>(f) * P * P * RR + s0;
    const float* gf = g + static_cast<size_t>(f) * 3 * RR + s0;
    const uint32_t bytes = 4 * L;
    int it = 0;
    for (int dy = dy0; dy <= dy1; ++dy, ++it) {
      const int s = it % kStages;
      if (it >= kStages) gigs_mbar_wait(&empty[s], (it / kStages - 1) & 1);
      if (lane == 0) gigs_mbar_arrive_expect_tx(&full[s], (ndx + 3) * bytes);
      __syncwarp();
      const int y = Y - dy;
      float* dst = ring + s * stage + G;
      for (int q = lane; q < ndx + 3; q += 32) {
        if (q < ndx)
          gigs_bulk_load(dst + q * S,
                         wf + static_cast<size_t>(dy * P + dx0 + q) * RR +
                             y * R,
                         bytes, &full[s]);
        else
          gigs_bulk_load(dst + (P + q - ndx) * S,
                         gf + static_cast<size_t>(q - ndx) * RR + y * R,
                         bytes, &full[s]);
      }
    }
    return;
  }

  // Consumers: lane X of the row. W row k (dx = dx0 + k) holds source
  // column X - dx at G + k S + X - dx - s0, g channel c at G + (P + c) S +
  // X - dx - s0.
  const int X = X0 + 32 * warp + lane;
  const int col0 = G + X - dx0 - s0;
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f;
  int it = 0;
  for (int dy = dy0; dy <= dy1; ++dy, ++it) {
    const int s = it % kStages;
    gigs_mbar_wait(&full[s], (it / kStages) & 1);
    const float* wp = ring + s * stage + col0;
    const float* gp = wp + P * S;
#pragma unroll 8
    for (int k = 0; k < ndx; ++k) {
      const float wv = wp[k * (S - 1)];
      a0 += gp[-k] * wv;
      a1 += gp[S - k] * wv;
      a2 += gp[2 * S - k] * wv;
    }
    __syncwarp();
    if (lane == 0) gigs_mbar_arrive(&empty[s]);
  }

  const int E = R + P - 1;
  if (X < E) {
    float* o = out + (3 * f * E + Y) * E + X;
    o[0] = a0;
    o[E * E] = a1;
    o[2 * E * E] = a2;
  }
}

cudaError_t opt_in_smem(int device) {
  static unsigned long long done = 0;
  return gigs_opt_in_smem(device, done, patch_bwd_kernel);
}

}  // namespace

// R must be a multiple of 4 (rows are copied in 16-byte units), W and g
// 16-byte aligned. The ring holds kStages stages of P + 3 staged rows: a
// level whose ring passes the card's shared memory is refused.
GIGS_API int gigs_patch_bwd(int device, const void* W, const void* g,
                            void* out, int R, int P, int h, void* stream) {
  (void)h;  // P = 2h + 1
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape c = shape_of(R, P);
  if (R % 4 != 0 || c.smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(c.chunks, R + P - 1, 6);
  patch_bwd_kernel<<<grid, 32 * (c.nwx + 1), c.smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(W), static_cast<const float*>(g),
      static_cast<float*>(out), R, P, c.tx, c.G, c.S, c.stage);
  GIGS_RETURN_LAUNCH_STATUS();
}

// Registers, shared memory and resident blocks per SM at a level's launch
// shape (gigs_kernel_resources in common.cuh).
GIGS_API int gigs_patch_bwd_resources(int device, int R, int P, int* out) {
  cudaError_t err = gigs_use_device(device);
  if (err == cudaSuccess) err = opt_in_smem(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape c = shape_of(R, P);
  return gigs_kernel_resources(patch_bwd_kernel, 32 * (c.nwx + 1), c.smem,
                               out);
}
